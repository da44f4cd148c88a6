"""End-to-end training driver: train a small model for a few hundred steps
through the one-rank pipeline step (GPipe microbatches, the seq-chunked
cross entropy, AdamW), checkpointed, under TrainSupervisor, with a fault
injected halfway.

    PYTHONPATH=src python -m repro_torch.launch.train_pipeline \
        [--steps 200] [--arch qwen1.5-0.5b] [--device cpu] [--ckpt DIR]

The twin of ``examples/train_pipeline.py``: the same smoke config, shape
(seq 32, batch 8), data (seed 0), AdamW settings (lr 1e-3, 20 warmup
steps), a checkpoint every 50 steps and at step 0, the fault at
``--steps // 2``, and the same output lines, ending with ``OK`` once the
last ten steps' loss is below the first ten's.  The plan is one rank (S =
T = R = 1) with M = 2 microbatches; the reference's S = 2 x T = 2 mesh
needs collectives (ROADMAP.md, section 1).  ``--device`` defaults to CUDA
and raises without it; the checkpoints go to ``--ckpt`` or a fresh
temporary directory, removed at the end.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import PipelinePlan, ShapeConfig, get_arch
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.transformer import init_model
from repro_torch.parallel.pipeline import build_train_step, stack_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.fault_tolerance import TrainSupervisor
from repro_torch.training.optimizer import AdamWConfig, init_opt_state


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without it)")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory (default: a temporary one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch).smoke_config
    plan = PipelinePlan(microbatches=2)
    shape = ShapeConfig("train", seq_len=32, global_batch=8, kind="train")
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=8, seed=0))
    gen = torch.Generator(device=device.type).manual_seed(0)
    params = stack_params(cfg, plan, init_model(cfg, gen, torch.float32,
                                                device))
    opt = init_opt_state(params)
    step_fn, _ = build_train_step(cfg, plan, None, shape,
                                  AdamWConfig(lr=1e-3, warmup_steps=20,
                                              total_steps=args.steps),
                                  param_dtype=torch.float32)

    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="flexpipe_train_ckpt_")
    sup = TrainSupervisor(ckpt_dir=ckpt_dir, ckpt_every=50)
    losses = []

    def one_step(state, step):
        p, o = state
        b = data.batch(step)
        p, o, m = step_fn(p, o, {k: torch.from_numpy(b[k]).to(device)
                                 for k in ("tokens", "labels")})
        losses.append(float(m["loss"]))
        if step % 25 == 0:
            print(f"step {step:4d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.2f}")
        return (p, o)

    def save(state, step):
        ckpt.save(ckpt_dir, state, step=step)

    def restore():
        (p, o), step, _ = ckpt.restore(ckpt_dir, (params, opt))
        print(f"  >> restored from checkpoint at step {step}")
        return (p, o), step

    try:
        save((params, opt), 0)
        t0 = time.time()
        state, step = sup.run(n_steps=args.steps, step_fn=one_step,
                              state=(params, opt), save_fn=save,
                              restore_fn=restore,
                              inject_fault_at=args.steps // 2)
        dt = time.time() - t0
    finally:
        if not args.ckpt:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"\ntrained {step} steps in {dt:.1f}s "
          f"({sup.restarts} restart after injected fault)")
    print(f"loss: first10={sum(losses[:10])/10:.3f} "
          f"last10={sum(losses[-10:])/10:.3f}")
    assert sum(losses[-10:]) < sum(losses[:10]), "loss must decrease"
    print("OK")
    return {"state": state, "step": step, "losses": losses,
            "restarts": sup.restarts}


if __name__ == "__main__":
    main()
