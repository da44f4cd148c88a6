"""Training launcher: pipeline training of an arch, with checkpoints, at
one rank or over a world of ranks that it starts itself.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 50 [--ranks 8] [--backend gloo|nccl] [--device cpu] \
        [--full] [--ckpt DIR]

The twin of ``repro/launch/train.py``: the same flags (``--arch``,
``--steps``, ``--smoke``, ``--ckpt``, ``--seq``, ``--batch``), the same
AdamW settings (lr 1e-3, 10 warmup steps, a cosine over ``--steps``), zero
frames or memory for the encoder and cross-attention archs, a checkpoint of
(params, optimizer state) every 25 steps when ``--ckpt`` is given, and the
same output lines.

``--ranks N`` (a multiple of 4) runs the reference's plan on its local
mesh, (data N / 4, model 4): S = 1 for an encoder-decoder arch, else
min(2, patterns); T = 2; R fills the model axis; M = 1.  The launcher
spawns the N rank processes (``launch.mesh.run_world``), each holding its
shards; rank 0 prints, and the checkpoint holds the global trees, gathered
from every rank.  ``--ranks 1`` (the default) is one rank, S = T = R = 1.

Added: ``--device``, which defaults to CUDA (each rank on ``cuda:(rank %
device_count)``) and raises without it; ``--backend``, which defaults to
nccl on CUDA (one device per rank: it raises where ranks would share one)
and gloo on the CPU, and which must be ``gloo`` to share a card; and
``--full`` for the arch's full config instead of its smoke config.
Weights are the port's own random init from seed 0.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import PipelinePlan, ShapeConfig, get_arch
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.mesh import make_local_mesh, run_world
from repro_torch.models.transformer import init_model
from repro_torch.parallel.pipeline import build_train_step, stack_params
from repro_torch.parallel.sharding import shard, unshard
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            init_opt_state)


def reference_plan(cfg, ranks: int) -> PipelinePlan:
    """The reference launcher's plan for its (2, 4) mesh; one rank's for
    ``ranks == 1``."""
    if ranks == 1:
        return PipelinePlan(microbatches=1)
    S = 1 if cfg.encoder_layers else min(2, cfg.n_patterns)
    return PipelinePlan(stages=S, tensor=2, replica=max(4 // (S * 2), 1),
                        microbatches=1)


def global_state(params, opt, structs):
    """(params, opt) gathered from every rank (collective), or as they are
    at one rank."""
    mesh = structs["mesh"]
    if mesh is None:
        return params, opt
    specs = structs["pspecs"]
    return unshard(params, specs, mesh), OptState(
        opt.step.clone(), unshard(opt.m, specs, mesh),
        unshard(opt.v, specs, mesh))


def local_state(params, opt, structs):
    """This rank's shards of global (params, opt)."""
    mesh = structs["mesh"]
    if mesh is None:
        return params, opt
    specs = structs["pspecs"]
    return shard(params, specs, mesh), OptState(
        opt.step.clone(), shard(opt.m, specs, mesh),
        shard(opt.v, specs, mesh))


def setup(args, ranks: int, device, plan=None):
    """Config, plan, the step (over a mesh of ``ranks``), this rank's
    params and optimizer state, and the data."""
    spec = get_arch(args.arch)
    cfg = spec.config if args.full else spec.smoke_config
    plan = plan or reference_plan(cfg, ranks)
    base = make_local_mesh(ranks // 4, 4, device) if ranks > 1 else None
    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    step_fn, structs = build_train_step(
        cfg, plan, base, shape,
        AdamWConfig(lr=1e-3, warmup_steps=args.warmup,
                    total_steps=args.steps), param_dtype=torch.float32)
    gen = torch.Generator(device=device.type).manual_seed(0)
    params = stack_params(cfg, plan, init_model(cfg, gen, torch.float32,
                                                device))
    if structs["mesh"] is not None:
        params = shard(params, structs["pspecs"], structs["mesh"])
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch, seed=args.seed))
    return cfg, step_fn, structs, params, init_opt_state(params), data


def make_batch(cfg, structs, data, step: int, batch: int, seq: int, device):
    """Step ``step``'s batch at this rank."""
    b = data.batch(step)
    out = {k: torch.from_numpy(b[k]).to(device) for k in ("tokens",
                                                          "labels")}
    if cfg.encoder_layers:
        out["frames"] = torch.zeros((batch, seq, cfg.d_model), device=device)
    if cfg.n_memory_tokens and not cfg.encoder_layers:
        out["memory"] = torch.zeros((batch, cfg.n_memory_tokens,
                                     cfg.d_model), device=device)
    mesh = structs["mesh"]
    return shard(out, structs["bspecs"], mesh) if mesh is not None else out


def _train(rank: int, ranks: int, device, args) -> None:
    cfg, step_fn, structs, params, opt, data = setup(args, ranks, device)
    for step in range(args.steps):
        params, opt, m = step_fn(params, opt, make_batch(
            cfg, structs, data, step, args.batch, args.seq, device))
        if rank == 0 and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step:4d} loss {float(m['loss']):.4f}", flush=True)
        if args.ckpt and step and step % 25 == 0:
            state = global_state(params, opt, structs)
            if rank == 0:
                ckpt.save(args.ckpt, state, step=step)
    if rank == 0:
        print("done", flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config (default: its smoke config)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    add_world_args(ap)
    args = ap.parse_args(argv)
    args.warmup, args.seed = 10, 0
    return args


def add_world_args(ap) -> None:
    ap.add_argument("--ranks", type=int, default=1,
                    help="rank processes to start: 1, or a multiple of 4 "
                         "for a (ranks / 4, 4) mesh")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on CUDA (a device per rank), gloo "
                         "on the CPU; gloo to share a card")
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without it); 'cpu' runs the "
                         "kernels' plain versions")


def cpu_threads(args):
    """Torch threads for each rank of a CPU world: the cores shared out (a
    world of ranks each on every core runs many times slower); None on
    CUDA."""
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    return max(1, (os.cpu_count() or 1) // args.ranks) if cpu else None


def check_world(args) -> str:
    """The backend for ``--ranks``; raises on a rank count that fills no
    mesh."""
    if args.ranks != 1 and (args.ranks < 4 or args.ranks % 4):
        raise SystemExit(f"--ranks {args.ranks}: 1, or a multiple of 4")
    if args.device is None:
        resolve_device(None)               # raises without CUDA
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    return args.backend or ("gloo" if cpu else "nccl")


def main(argv=None) -> None:
    args = parse(argv)
    backend = check_world(args)
    if args.ranks == 1:
        _train(0, 1, resolve_device(args.device), args)
    else:
        run_world(_train, args.ranks, (args,), backend=backend,
                  device=args.device, timeout_s=24 * 3600.0,
                  threads=cpu_threads(args))


if __name__ == "__main__":
    main()
