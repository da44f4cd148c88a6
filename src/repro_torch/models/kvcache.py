"""KV cache construction and sizing, the paged block allocator and stage
regrouping.

Ports the attention-, MLA-, cross-attention-, Mamba- and RWKV-layer parts
of ``repro/models/kvcache.py``.  Two layouts:

* **dense**: per-layer ``(batch, Kh, max_seq, hd)`` rows, or ``min(max_seq,
  sliding_window)`` rows for a windowed (local) layer, a ring addressed by
  position modulo its length; an MLA layer its per-token latent and
  shared rotary key, ``{"latent": (batch, max_seq, kv_lora_rank),
  "k_rope": (batch, max_seq, rope_head_dim)}``; a recurrent layer holds its state instead,
  whatever ``max_seq`` is: Mamba ``{"conv": (batch, d_conv - 1, d_inner),
  "ssm": (batch, d_inner, d_state)}``, RWKV ``{"sx_tm": (batch, d),
  "sx_cm": (batch, d), "wkv": (batch, H, hd, hd)}``; a cross-attention
  layer holds its memory's K/V, ``(batch, Kh, n_memory_tokens, hd)``, and
  an ``extra_cross`` sub-block a second ``"cross"`` pair beside
  ``"mixer"``, whose length is ``max_seq`` in an encoder-decoder model
  (the encoder's output tracks the sequence) and ``n_memory_tokens``
  otherwise;
* **paged** (attention only): per-layer block pools
  ``(n_blocks, Kh, block_size, hd)`` plus per-slot block tables (host
  side) mapping logical token blocks to physical ones.  Tables are shared across layers, so refactoring stays a
  zero-copy re-view of the per-layer list.

Physical block 0 is the **null block**: unallocated table entries point at
it, so bucket padding and idle slots write into a block no masked read sees.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (MIXER_ATTN, MIXER_CROSS, MIXER_MAMBA,
                                      MIXER_MLA, MIXER_RWKV, ModelConfig)
from repro_torch.models.ssm import mamba_dims, rwkv_dims

_DENSE_MIXERS = (MIXER_ATTN, MIXER_MLA, MIXER_CROSS, MIXER_MAMBA,
                 MIXER_RWKV)


def _check_ported(cfg: ModelConfig, layers, mixers) -> None:
    for i in layers:
        if cfg.layer_kind(i).mixer not in mixers:
            raise NotImplementedError(
                f"{cfg.name}: caches for layer {i} ({cfg.layer_kind(i)}) are "
                "not ported to repro_torch yet; see ROADMAP.md, section 1")


def layer_shapes(cfg: ModelConfig, i: int, batch: int, max_seq: int,
                 tensor_shards: int = 1) -> dict:
    """Leaf shapes of layer ``i``'s dense cache, ``{"mixer": {...}}`` and,
    for an ``extra_cross`` layer, ``"cross"`` (local shapes under
    ``tensor_shards``-way tensor parallelism)."""
    kind = cfg.layer_kind(i)
    kh = max(cfg.n_kv_heads // tensor_shards, 1)
    hd = cfg.resolved_head_dim
    if kind.mixer == MIXER_MAMBA:
        di, _, N, dc = mamba_dims(cfg)
        di //= tensor_shards
        out = {"mixer": {"conv": (batch, dc - 1, di), "ssm": (batch, di, N)}}
    elif kind.mixer == MIXER_MLA:
        m = cfg.mla
        out = {"mixer": {"latent": (batch, max_seq, m.kv_lora_rank),
                         "k_rope": (batch, max_seq, m.rope_head_dim)}}
    elif kind.mixer == MIXER_RWKV:
        H, hs = rwkv_dims(cfg)
        out = {"mixer": {"sx_tm": (batch, cfg.d_model),
                         "sx_cm": (batch, cfg.d_model),
                         "wkv": (batch, H // tensor_shards, hs, hs)}}
    else:
        seq = max_seq
        if kind.mixer == MIXER_CROSS:
            seq = cfg.n_memory_tokens
        elif cfg.sliding_window and not cfg.is_global_layer(i):
            seq = min(max_seq, cfg.sliding_window)        # the ring
        shape = (batch, kh, seq, hd)
        out = {"mixer": {"k": shape, "v": shape}}
    if kind.extra_cross:
        mem = max_seq if cfg.encoder_layers else (cfg.n_memory_tokens
                                                  or max_seq)
        out["cross"] = {"k": (batch, kh, mem, hd), "v": (batch, kh, mem, hd)}
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None,
               layers: Optional[range] = None,
               tensor_shards: int = 1) -> list:
    """Zero dense caches for ``layers`` (default: all), at one rank's local
    shapes under ``tensor_shards``-way tensor parallelism."""
    device = resolve_device(device)
    layers = layers if layers is not None else range(cfg.n_layers)
    _check_ported(cfg, layers, _DENSE_MIXERS)
    return [{part: {name: torch.zeros(shape, dtype=dtype, device=device)
                    for name, shape in leaves.items()}
             for part, leaves in layer_shapes(cfg, i, batch, max_seq,
                                              tensor_shards).items()}
            for i in layers]


def cache_bytes(tree) -> int:
    """Bytes of every tensor in nested dicts and lists."""
    if isinstance(tree, dict):
        return sum(cache_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(cache_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


NULL_BLOCK = 0          # physical block 0: trash target for masked writes


def can_page(cfg: ModelConfig) -> bool:
    """Paging covers unwindowed full self-attention only: a recurrent
    (Mamba, RWKV) layer's state has no token axis to page, a
    cross-attention memory is one fixed block, and MLA's latent rows have
    no paged layout (as in the reference)."""
    mixers = {k.mixer for k in cfg.pattern}
    return (mixers == {MIXER_ATTN}
            and not any(k.extra_cross for k in cfg.pattern)
            and cfg.sliding_window == 0
            and cfg.encoder_layers == 0)


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device=None,
                     layers: Optional[range] = None) -> list:
    """Zero block pools for ``layers`` (default: all)."""
    device = resolve_device(device)
    layers = layers if layers is not None else range(cfg.n_layers)
    _check_ported(cfg, layers, (MIXER_ATTN,))
    shape = (n_blocks, cfg.n_kv_heads, block_size, cfg.resolved_head_dim)
    return [{"mixer": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)}}
            for _ in layers]


def block_bytes(cfg: ModelConfig, block_size: int, dtype=torch.bfloat16,
                tensor_shards: int = 1) -> int:
    """Bytes one physical block costs across ALL layers (the sizing unit of
    a pool)."""
    kh = max(cfg.n_kv_heads // tensor_shards, 1)
    return (cfg.n_layers * 2 * kh * block_size * cfg.resolved_head_dim
            * dtype.itemsize)


def dense_slot_bytes(cfg: ModelConfig, max_seq: int, dtype=torch.bfloat16,
                     tensor_shards: int = 1) -> int:
    """Bytes one dense batch slot reserves across all layers (the
    ``max_seq``-proportional cost paging removes)."""
    _check_ported(cfg, range(cfg.n_layers), _DENSE_MIXERS)
    return sum(math.prod(shape) * dtype.itemsize
               for i in range(cfg.n_layers)
               for leaves in layer_shapes(cfg, i, 1, max_seq,
                                          tensor_shards).values()
               for shape in leaves.values())


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Physical blocks needed to hold ``n_tokens``."""
    return -(-max(n_tokens, 0) // block_size)


class BlockAllocator:
    """Host-side LIFO free list over physical cache blocks.

    A fresh allocator hands out ascending ids and reuses the most recently
    freed first, so paged runs are reproducible.  Block 0 (``NULL_BLOCK``)
    is never handed out.  ``alloc(n)`` is all-or-nothing: it returns
    ``None`` and changes nothing when fewer than ``n`` blocks are free."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError("need at least one usable block + the null")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free = list(range(n_blocks - 1, 0, -1))   # pop() yields 1, 2, …
        self._used: set[int] = set()

    @property
    def n_usable(self) -> int:
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._used)

    def occupancy(self) -> float:
        """Fraction of usable blocks currently allocated."""
        return self.n_used / max(self.n_usable, 1)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._used.update(out)
        return out

    def free(self, ids) -> None:
        for b in ids:
            if b not in self._used:
                raise ValueError(f"double free / foreign block {b}")
            self._used.discard(b)
            self._free.append(b)


def fragmentation(live_tokens: int, n_used_blocks: int,
                  block_size: int) -> float:
    """Allocated-but-dead token slots in tail blocks, as a fraction of
    allocated capacity (0 when nothing is allocated)."""
    cap = n_used_blocks * block_size
    if cap <= 0:
        return 0.0
    return max(cap - live_tokens, 0) / cap


def group_by_stage(per_layer: list, boundaries: list[int]) -> list[list]:
    """Split a per-layer list into per-stage lists at ``boundaries`` (stage
    start indices).  Zero-copy: only the Python list is re-sliced."""
    ends = list(boundaries[1:]) + [len(per_layer)]
    return [per_layer[b:e] for b, e in zip(boundaries, ends)]


def regroup(per_stage: list[list], new_boundaries: list[int]) -> list[list]:
    """Re-split stage-grouped caches at new boundaries.  Zero-copy: the new
    per-stage lists hold the same per-layer tensors."""
    return group_by_stage([c for stage in per_stage for c in stage],
                          new_boundaries)


def migration_plan(old_boundaries: list[int], new_boundaries: list[int],
                   n_layers: int) -> list[tuple[int, int, int]]:
    """Layers whose owning stage changes, as (layer, old_stage, new_stage):
    the layers a refactor between stage groupings must transfer."""
    def owner(boundaries, layer):
        s = 0
        for i, b in enumerate(boundaries):
            if layer >= b:
                s = i
        return s
    moves = []
    for layer in range(n_layers):
        o, n = owner(old_boundaries, layer), owner(new_boundaries, layer)
        if o != n:
            moves.append((layer, o, n))
    return moves
