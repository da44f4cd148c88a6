"""Gradient compression: top-k sparsification with error feedback.

Ports ``topk_compress``, ``topk_decompress`` and ``ErrorFeedback`` of
``repro/training/compression.py``.  Its int8 all-reduce,
``compressed_psum``, needs a collective and waits for the multi-rank slice
(ROADMAP.md, section 1).
"""
from __future__ import annotations

import math

import torch

from repro_torch.tree import tree_map


def topk_compress(g: torch.Tensor, frac: float = 0.01):
    """Top-k sparsification by magnitude: (values, flat indices, shape)."""
    flat = g.reshape(-1).float()
    k = max(int(flat.numel() * frac), 1)
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx, tuple(g.shape)


def topk_decompress(vals, idx, shape):
    flat = torch.zeros(math.prod(shape), dtype=torch.float32,
                       device=vals.device)
    flat[idx] = vals
    return flat.reshape(shape)


class ErrorFeedback:
    """Residual accumulator for biased compressors (host-side trainer)."""

    def __init__(self):
        self.residual = None

    def apply(self, grads, compress_fn):
        if self.residual is None:
            self.residual = tree_map(torch.zeros_like, grads)
        corrected = tree_map(lambda g, r: g + r, grads, self.residual)
        compressed = tree_map(compress_fn, corrected)
        self.residual = tree_map(lambda c, g: g - c, compressed, corrected)
        return compressed
