"""Training launcher: pipeline training of an arch at one rank, with
checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 50 [--device cpu] [--full] [--ckpt DIR]

The twin of ``repro/launch/train.py``: the same flags (``--arch``,
``--steps``, ``--smoke``, ``--ckpt``, ``--seq``, ``--batch``), the same
AdamW settings (lr 1e-3, 10 warmup steps, a cosine over ``--steps``), zero
frames or memory for the encoder and cross-attention archs, a checkpoint of
(params, optimizer state) every 25 steps when ``--ckpt`` is given, and the
same output lines.  Added: ``--device``, which defaults to CUDA and raises
without it, and ``--full`` for the arch's full config instead of its smoke
config.  The plan is one rank (S = T = R = 1, M = 1: the reference's
S x T x R mesh needs collectives, ROADMAP.md section 1); weights are the
port's own random init from seed 0.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import PipelinePlan, ShapeConfig, get_arch
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.transformer import init_model
from repro_torch.parallel.pipeline import build_train_step, stack_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamWConfig, init_opt_state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config (default: its smoke config)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without it); 'cpu' runs the "
                         "kernels' plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.config if args.full else spec.smoke_config
    plan = PipelinePlan(microbatches=1)
    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch))
    gen = torch.Generator(device=device.type).manual_seed(0)
    params = stack_params(cfg, plan, init_model(cfg, gen, torch.float32,
                                                device))
    opt = init_opt_state(params)
    step_fn, _ = build_train_step(cfg, plan, None, shape,
                                  AdamWConfig(lr=1e-3, warmup_steps=10,
                                              total_steps=args.steps),
                                  param_dtype=torch.float32)
    for step in range(args.steps):
        b = data.batch(step)
        batch = {k: torch.from_numpy(b[k]).to(device)
                 for k in ("tokens", "labels")}
        if cfg.encoder_layers:
            batch["frames"] = torch.zeros((args.batch, args.seq,
                                           cfg.d_model), device=device)
        if cfg.n_memory_tokens and not cfg.encoder_layers:
            batch["memory"] = torch.zeros(
                (args.batch, cfg.n_memory_tokens, cfg.d_model),
                device=device)
        params, opt, m = step_fn(params, opt, batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(m['loss']):.4f}")
        if args.ckpt and step and step % 25 == 0:
            ckpt.save(args.ckpt, (params, opt), step=step)
    print("done")


if __name__ == "__main__":
    main()
