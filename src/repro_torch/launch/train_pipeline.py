"""End-to-end training driver: train a small model for a few hundred steps
through the SPMD pipeline (stage and tensor parallel, the vocab-parallel
cross entropy, AdamW), checkpointed, under TrainSupervisor, with a fault
injected halfway.

    PYTHONPATH=src python -m repro_torch.launch.train_pipeline \
        [--steps 200] [--arch qwen1.5-0.5b] [--ranks 8] \
        [--backend gloo|nccl] [--device cpu] [--ckpt DIR]

The twin of ``examples/train_pipeline.py``: the same smoke config, plan (S
= 2 x T = 2, M = 2) on a (data 2, model 4) mesh of 8 ranks, shape (seq 32,
batch 8), data (seed 0), AdamW settings (lr 1e-3, 20 warmup steps), a
checkpoint every 50 steps and at step 0, the fault at ``--steps // 2``, and
the same output lines, ending with ``OK`` once the last ten steps' loss is
below the first ten's.  The launcher starts the ranks itself
(``launch.mesh.run_world``; ``--ranks`` a multiple of 4, the mesh (ranks /
4, 4)); every rank runs the supervisor's loop, so the fault and each
restore happen at the same step everywhere; a checkpoint holds the global
trees, gathered from every rank and written by rank 0, and each rank
restores its shards from it.  ``--device`` defaults to CUDA and raises
without it, ``--backend`` as in ``launch.train``; the checkpoints go to
``--ckpt`` or a fresh temporary directory, removed at the end.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import PipelinePlan
from repro_torch.launch.mesh import run_world
from repro_torch.launch.train import (add_world_args, check_world,
                                      cpu_threads, global_state, local_state,
                                      make_batch, setup)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.fault_tolerance import TrainSupervisor
from repro_torch.tree import tree_map

PLAN = PipelinePlan(stages=2, tensor=2, replica=1, microbatches=2)


def _run(rank: int, ranks: int, device, args) -> dict:
    plan = PLAN if ranks > 1 else PipelinePlan(microbatches=2)
    cfg, step_fn, structs, params, opt, data = setup(args, ranks, device,
                                                     plan)
    sup = TrainSupervisor(ckpt_dir=args.ckpt, ckpt_every=50)
    losses = []

    def one_step(state, step):
        p, o = state
        p, o, m = step_fn(p, o, make_batch(cfg, structs, data, step,
                                           args.batch, args.seq, device))
        losses.append(float(m["loss"]))
        if rank == 0 and step % 25 == 0:
            print(f"step {step:4d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.2f}", flush=True)
        return (p, o)

    def save(state, step):
        g = global_state(*state, structs)
        if rank == 0:
            ckpt.save(args.ckpt, g, step=step)
        if ranks > 1:
            dist.barrier()                 # written before anyone restores

    def restore():
        like = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                              device=device),
                        (structs["params"], structs["opt"]))
        (p, o), step, _ = ckpt.restore(args.ckpt, like)
        if rank == 0:
            print(f"  >> restored from checkpoint at step {step}",
                  flush=True)
        return local_state(p, o, structs), step

    save((params, opt), 0)
    t0 = time.time()
    state, step = sup.run(n_steps=args.steps, step_fn=one_step,
                          state=(params, opt), save_fn=save,
                          restore_fn=restore,
                          inject_fault_at=args.steps // 2)
    state = global_state(*state, structs)
    return {"state": state, "step": step, "losses": losses,
            "restarts": sup.restarts, "seconds": time.time() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory (default: a temporary one)")
    add_world_args(ap)
    ap.set_defaults(ranks=8)
    args = ap.parse_args(argv)
    backend = check_world(args)
    args.full, args.seq, args.batch, args.warmup, args.seed = \
        False, 32, 8, 20, 0
    own_dir = not args.ckpt
    args.ckpt = args.ckpt or tempfile.mkdtemp(prefix="flexpipe_train_ckpt_")
    try:
        if args.ranks == 1:
            res = _run(0, 1, resolve_device(args.device), args)
        else:
            res = run_world(_run, args.ranks, (args,), backend=backend,
                            device=args.device, timeout_s=24 * 3600.0,
                            threads=cpu_threads(args))[0]
    finally:
        if own_dir:
            shutil.rmtree(args.ckpt, ignore_errors=True)
    losses = res["losses"]
    print(f"\ntrained {res['step']} steps in {res['seconds']:.1f}s "
          f"({res['restarts']} restart after injected fault)")
    print(f"loss: first10={sum(losses[:10])/10:.3f} "
          f"last10={sum(losses[-10:])/10:.3f}")
    assert sum(losses[-10:]) < sum(losses[:10]), "loss must decrease"
    print("OK")
    return res


if __name__ == "__main__":
    main()
