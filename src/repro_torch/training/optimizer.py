"""AdamW with f32 moments, global-norm clipping, a warmup-cosine schedule.

Ports ``repro/training/optimizer.py`` with the same names, signatures and
arithmetic in the same order.  The optimizer state is a tree congruent with
the params (``OptState``: an int32 step counter tensor and f32 moments).
Where the JAX package donates params and moments and returns new ones,
``adamw_update`` writes them in place under ``torch.no_grad()`` and returns
the same tensors, in one pass over the leaves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map

f32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    m: Any                   # f32 tree like params
    v: Any                   # f32 tree like params


def init_opt_state(params) -> OptState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                           device=p.device), params)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=zeros, v=tree_map(torch.clone, zeros))


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or an int tensor): linear
    warmup, then a cosine down to ``min_lr_frac``; an f32 tensor."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, params, grads, state: OptState,
                 extra_norm_sq: torch.Tensor | None = None):
    """One AdamW step.  Returns (params, new_state, metrics); params and the
    moments are updated in place.

    ``extra_norm_sq``: the squared global grad norm where the caller has
    it (the train step sums it over its leaves); the grads' own norm if
    None."""
    step = state.step + 1
    if extra_norm_sq is None:
        gnorm = global_norm(grads)
    else:
        gnorm = torch.sqrt(extra_norm_sq)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(f32)
    b2c = 1 - cfg.b2 ** step.to(f32)

    flat_p, _ = tree_flatten(params)
    flat_g = tree_leaves(grads)
    flat_m = tree_leaves(state.m)
    flat_v = tree_leaves(state.v)
    with torch.no_grad():
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            g = g.float() * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
            mhat = m / b1c
            vhat = v / b2c
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
                + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, OptState(step, state.m, state.v), \
        {"grad_norm": gnorm, "lr": lr}
