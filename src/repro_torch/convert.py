"""Weight and cache bridge between numpy trees and torch tensors.

The JAX package keeps params and caches as nested dicts and lists of arrays
(``repro.models.transformer.init_model``): ``embed (V, d)``, ``lm_head (d, V)``
when the head is untied, ``final_norm.scale``, and per block
``ln1/ln2.scale`` plus, for attention, ``mixer.wq (d, H, hd)``,
``mixer.wk/wv (d, Kh, hd)``, ``mixer.wo (H, hd, d)``, ``mixer.bq/bk/bv`` and
``mlp.w_gate/w_up (d, ff)``, ``mlp.w_down (ff, d)`` or, for an MoE MLP,
``mlp.router (d, E)``, stacked experts ``mlp.w_gate/w_up (E, d, fe)``,
``mlp.w_down (E, fe, d)`` and the ``mlp.shared`` gated MLP; an MLA
``mixer`` (``wq_down``, ``wq_up``, ``wkv_down``, ``wk_up``, ``wv_up``,
``wo``, ``q_norm``, ``kv_norm``); a Mamba-1
``mixer`` (``repro.models.ssm.init_mamba``: ``w_x``, ``w_z``, ``conv_w``,
``conv_b``, ``x_proj``, ``dt_proj``, ``dt_bias``, ``A_log``, ``D``,
``out_proj``); or, for RWKV-6, the ``mixer`` tree of
``repro.models.ssm.init_rwkv`` (nested ``tm.{w,k,v,r,g}``).  A cross
attention ``mixer`` holds the attention leaves and a scalar ``gate``; a
block with ``extra_cross`` adds ``cross`` (the same leaves) and
``ln_cross.scale``; a plain gelu MLP is ``mlp.w1 (d, ff)``, ``mlp.w2 (ff,
d)``.  An encoder-decoder model adds ``encoder.blocks`` (attention blocks)
and ``encoder.final_norm.scale``, and learned positions ``pos_embed
(65536, d)``.  Caches are per-layer lists of ``{"mixer": {"k", "v"}}``
with dense ``(B, Kh, Smax, hd)`` rows (``(B, Kh, M, hd)`` memory rows for
a cross mixer, and a ``"cross": {"k", "v"}`` pair beside ``"mixer"`` for
``extra_cross``), MLA rows ``{"mixer": {"latent" (B, Smax, r), "k_rope"
(B, Smax, rd)}}``, or paged ``(n_blocks, Kh, block_size, hd)`` pools,
Mamba state ``{"mixer": {"conv", "ssm"}}`` or RWKV state ``{"mixer":
{"sx_tm", "sx_cm", "wkv"}}``.  This module keeps that layout unchanged and only swaps the leaf type, so it takes numpy
(after ``np.asarray`` on the JAX side) and never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _leaf_to_torch(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    src_bf16 = a.dtype.name == "bfloat16"
    if src_bf16:
        # numpy has no native bfloat16; widening to float32 is exact
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a))          # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    elif src_bf16:
        t = t.to(torch.bfloat16)
    return t.to(device)


def tree_from_numpy(tree, device, dtype=None):
    """Nested dicts/lists of numpy arrays -> same nesting of tensors.

    ``device=None`` means CUDA and raises without it (the package's device
    rule).  ``dtype`` recasts floating leaves; ``None`` keeps each leaf's own
    type."""
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        if t is None:
            return None
        return _leaf_to_torch(t, device, dtype)

    return conv(tree)


def tree_to_numpy(tree):
    """Tensors -> numpy arrays, same nesting.  bfloat16 leaves widen to
    float32 (exact), since numpy has no bfloat16."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    if tree is None:
        return None
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(tree: dict, device, dtype=torch.float32) -> dict:
    """JAX-layout param tree (numpy leaves) -> torch params on ``device``."""
    return tree_from_numpy(tree, device, dtype)


def cache_from_numpy(caches: list, device, dtype=None) -> list:
    """Dense, paged or recurrent (Mamba, RWKV) per-layer caches (numpy
    leaves) -> torch tensors."""
    return tree_from_numpy(caches, device, dtype)


def cache_to_numpy(caches: list) -> list:
    """Dense, paged or recurrent per-layer caches -> numpy leaves."""
    return tree_to_numpy(caches)


def torch_dtype(name) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` / a torch dtype -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _TORCH_DTYPES[str(name)]
