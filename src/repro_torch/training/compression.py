"""Gradient compression for the cross-pod all-reduce, and top-k
sparsification with error feedback.

Ports ``repro/training/compression.py``.  ``compressed_psum`` is an int8
quantized all-reduce over a mesh axis (``parallel.comm``): a scale shared
by every rank of the axis (a pmax of |g|), values rounded to [-127, 127]
in an int32 carrier (so the sum cannot overflow), one psum, then
dequantized: a quarter of f32's value bytes on the wire, for one scalar
pmax per leaf.
"""
from __future__ import annotations

import math

import torch

from repro_torch.parallel import comm
from repro_torch.tree import tree_map


def compressed_psum(g: torch.Tensor, axis: str) -> torch.Tensor:
    """int8-quantized psum over ``axis`` (int32 carrier, shared scale)."""
    gf = g.float()
    scale = torch.clamp(comm.pmax(torch.max(torch.abs(gf)), axis), min=1e-20)
    q = torch.clamp(torch.round(gf / scale * 127.0), -127, 127).to(
        torch.int32)
    total = comm.psum(q, axis)
    return (total.float() * (scale / 127.0)).to(g.dtype)


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
