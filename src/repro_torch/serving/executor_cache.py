"""Executor cache: the engine's hot-path programs, keyed for refactoring.

Ports ``repro/serving/executor_cache.py``.  In JAX each program is a jitted
function and refactoring between already-seen stage configurations must not
retrace.  PyTorch runs eagerly, so a program here is a small object that
closes over its layer ranges and runs them in a Python loop; what it still
has to be is *warm* (its kernels built and loaded, its first launch done)
before a refactor may report a cache hit.  Every fused program runs the
same flat loop over the layers, so swapping one for another changes no code
that executes: the table keeps the reference's accounting (programs keyed by
``boundaries``, ``builds``, hits and misses) until a per-configuration CUDA
graph gives each entry work of its own.  Until then a refactor is
bookkeeping, and stream identity across one proves only that slot and cache
state survive it.

* ``fused_decode(boundaries)``: one tick for a whole stage configuration:
  embed, every stage, lm_head and an argmax on the device, so only the B
  sampled ids (int32) reach the host.
* ``stage_prefill(lo, hi, ...)``: the prompt pass over layers [lo, hi),
  keyed by range so configurations that cut the model at the same points
  share it.  It writes the prompt's rows in place into the slot's row of
  the live cache (a view of it), or through the slot's block table.  A
  recurrent (Mamba, RWKV) layer reads its cache as the initial state (and
  Mamba's conv as its history), so its slot row is zeroed first: a reused
  slot holds the last request's state, and idle-slot decode ticks write
  garbage there.  A cross-attention layer writes the request's ``memory``
  K/V into the slot's rows; given no memory it reads them, so they are
  zeroed first, as the reference reads its zeroed batch-1 cache.
  Attention rows past the
  prompt are left as the last request left them (the reference prefills
  into a zeroed cache): decode reads ``min(pos + 1, Smax)`` rows, so no
  stale row is read before decode has overwritten it, in a ring or not.
* ``chunk_prefill(lo, hi, ...)``: one prefill chunk over layers [lo, hi):
  ``chunk_len`` tokens written at a run-time offset ``pos0`` that attend
  over cache rows [0, ``kv_extent``), the whole prompt's pow2 bucket, so
  every chunk reduces over the extent a whole-prompt prefill would.  One
  program per ``(lo, hi, first, last, sample, chunk_len, kv_extent)``, as
  the reference keys its jitted chunk programs.
* ``stage_decode(lo, hi)``: the per-stage decode tick (unfused fallback).

JAX donates cache buffers and returns new ones; here programs write into
the preallocated cache tensors and return the same list.  ``builds`` counts
programs built by this cache (JAX's ``trace_count``): a warmed
``refactor()`` must leave it unchanged.  Capturing ticks as CUDA graphs is
left to a performance-focused change.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (MIXER_ATTN, MIXER_CROSS, MIXER_MAMBA,
                                      MIXER_MLA, MIXER_RWKV, ModelConfig)
from repro_torch.models.model import embed_tokens, lm_head
from repro_torch.models.transformer import BlockCtx, apply_block


def stage_ranges(cfg: ModelConfig, boundaries) -> list[tuple[int, int]]:
    b = tuple(boundaries)
    return list(zip(b, b[1:] + (cfg.n_layers,)))


def _slot_view(layer_cache: dict, slot: int) -> dict:
    """Batch row ``slot`` of one layer's dense cache, as views."""
    return {part: {n: t[slot:slot + 1] for n, t in leaves.items()}
            for part, leaves in layer_cache.items()}


def _argmax_ids(cfg, head_params, x) -> torch.Tensor:
    logits = lm_head(cfg, head_params, x)[:, -1, :]
    return torch.argmax(logits, dim=-1).to(torch.int32)


class FusedDecodeProgram:
    """One decode tick for one stage configuration."""

    def __init__(self, cfg: ModelConfig, boundaries: tuple[int, ...],
                 blocks: list, head_params: dict, paged_kernel: bool):
        self.cfg = cfg
        self.boundaries = boundaries
        self.ranges = stage_ranges(cfg, boundaries)
        self.warm = False            # flips after the first executed tick
        self._blocks = blocks
        self._head = head_params
        self._paged_kernel = paged_kernel

    def step(self, caches: list, tok: torch.Tensor, pos: torch.Tensor,
             block_tables: torch.Tensor | None = None):
        """tok: (B, 1); pos: (B,) write positions.  Caches are written in
        place; returns (next ids (B,) int32 on the device, caches)."""
        cfg = self.cfg
        x = embed_tokens(cfg, self._head, tok, pos0=pos)
        for lo, hi in self.ranges:
            for li in range(lo, hi):
                ctx = BlockCtx(pos0=pos, cache=caches[li],
                               is_global=cfg.is_global_layer(li),
                               block_table=block_tables,
                               paged_kernel=self._paged_kernel)
                x, _, _ = apply_block(cfg, cfg.layer_kind(li),
                                      self._blocks[li], x, ctx)
        nxt = _argmax_ids(cfg, self._head, x)
        self.warm = True
        return nxt, caches


class StagePrefillProgram:
    """Prompt pass over layers [lo, hi) writing rows straight into a slot."""

    def __init__(self, cfg: ModelConfig, lo: int, hi: int, first: bool,
                 last: bool, paged: bool):
        self.cfg, self.lo, self.hi = cfg, lo, hi
        self.first, self.last, self.paged = first, last, paged

    def __call__(self, blocks, head_params, inp, caches, slot, true_len: int,
                 memory=None):
        """inp: (1, Sp) tokens (first stage) or activations; ``slot``: the
        batch row (dense) or the slot's (1, max_blocks) table row (paged);
        ``memory``: the request's (1, M, d) cross-attention memory or None.
        Returns (first sampled id (1,) on the last stage, else activations,
        caches)."""
        cfg = self.cfg
        x = embed_tokens(cfg, head_params, inp) if self.first else inp
        for i, bp in enumerate(blocks):
            li = self.lo + i
            if self.paged:
                cache, bt = caches[i], slot
            else:
                cache, bt = _slot_view(caches[i], slot), None
                kind = cfg.layer_kind(li)
                stale = []
                if kind.mixer in (MIXER_MAMBA, MIXER_RWKV) or (
                        kind.mixer == MIXER_CROSS and memory is None):
                    stale.append("mixer")
                if kind.extra_cross and memory is None:
                    stale.append("cross")
                for part in stale:
                    for t in cache[part].values():
                        t.zero_()
            ctx = BlockCtx(pos0=0, cache=cache, memory=memory,
                           is_global=cfg.is_global_layer(li), block_table=bt)
            x, _, _ = apply_block(cfg, cfg.layer_kind(li), bp, x, ctx)
        if self.last:
            return _argmax_ids(cfg, head_params,
                               x[:, true_len - 1:true_len]), caches
        return x, caches


class ChunkPrefillProgram:
    """One prefill chunk over layers [lo, hi), written in place into the
    slot's rows (a view of them, dense) or through its table (paged)."""

    def __init__(self, cfg: ModelConfig, lo: int, hi: int, first: bool,
                 sample: bool, kv_extent: int, paged: bool):
        self.cfg, self.lo, self.hi = cfg, lo, hi
        self.first, self.sample = first, sample
        self.kv_extent, self.paged = kv_extent, paged

    def __call__(self, blocks, head_params, inp, caches, slot, pos0: int,
                 last_ix: int):
        """inp: (1, chunk_len) tokens (first stage) or activations; ``slot``:
        the batch row (dense) or the slot's (1, max_blocks) table row
        (paged); ``pos0``: the chunk's first position; ``last_ix``: the
        prompt's final row within the chunk.  Returns (the first sampled id
        (1,) when ``sample``, else activations, caches)."""
        cfg = self.cfg
        x = embed_tokens(cfg, head_params, inp, pos0=pos0) \
            if self.first else inp
        for i, bp in enumerate(blocks):
            li = self.lo + i
            if self.paged:
                cache, bt = caches[i], slot
            else:
                cache, bt = _slot_view(caches[i], slot), None
            ctx = BlockCtx(pos0=pos0, cache=cache,
                           is_global=cfg.is_global_layer(li), block_table=bt,
                           kv_extent=self.kv_extent)
            x, _, _ = apply_block(cfg, cfg.layer_kind(li), bp, x, ctx)
        if self.sample:
            return _argmax_ids(cfg, head_params,
                               x[:, last_ix:last_ix + 1]), caches
        return x, caches


class StageDecodeProgram:
    """Per-stage decode over layers [lo, hi) (the unfused fallback)."""

    def __init__(self, cfg: ModelConfig, lo: int, hi: int):
        self.cfg, self.lo, self.hi = cfg, lo, hi

    def __call__(self, blocks, x, caches, pos):
        cfg = self.cfg
        for i, bp in enumerate(blocks):
            li = self.lo + i
            ctx = BlockCtx(pos0=pos, cache=caches[i],
                           is_global=cfg.is_global_layer(li))
            x, _, _ = apply_block(cfg, cfg.layer_kind(li), bp, x, ctx)
        return x, caches


class ExecutorCache:
    """Per-engine table of programs with hit/miss/build accounting."""

    def __init__(self, cfg: ModelConfig, params: dict, *, max_seq: int,
                 cache_dtype=torch.float32, prefill_buckets: bool = True,
                 paged: bool = False, paged_kernel: bool = False):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.paged = paged
        self.paged_kernel = paged_kernel
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self._local: dict = {}
        self.head_params = {k: params[k] for k in
                            ("embed", "final_norm", "lm_head", "pos_embed")
                            if k in params}
        mixers = {cfg.layer_kind(i).mixer for i in range(cfg.n_layers)}
        # padding a prompt to a bucket is only safe where padded rows are
        # masked downstream: position-masked attention and MLA caches, and
        # cross attention, whose rows do not see each other
        self.can_bucket = (prefill_buckets and not cfg.sliding_window
                           and mixers <= {MIXER_ATTN, MIXER_MLA,
                                          MIXER_CROSS})
        # a chunk attends over the cache rows of the chunks before it, so
        # those rows must hold exact copies of the fresh activations: f32
        # caches and plain attention only (MLA, cross and recurrent caches
        # have no chunk resume path)
        self.can_chunk = (self.can_bucket and mixers == {MIXER_ATTN}
                          and cache_dtype == torch.float32
                          and not any(cfg.layer_kind(i).extra_cross
                                      for i in range(cfg.n_layers)))

    def prefill_bucket(self, n: int) -> int:
        """Pad a prompt length to a power-of-two bucket (>= 16)."""
        if not self.can_bucket:
            return n
        b = 16
        while b < n:
            b *= 2
        return min(b, self.max_seq)

    def chunk_bucket(self, n: int, chunk: int) -> int:
        """Pow2 bucket (>= 16) for a chunk's token count, capped at the chunk
        size (a prompt's final, partial chunk pads to the next pow2)."""
        b = 16
        while b < n:
            b *= 2
        return min(b, chunk)

    def _lookup(self, key, make):
        hit = key in self._local
        if hit:
            self.hits += 1
        else:
            self.misses += 1
            self.builds += 1
            self._local[key] = make()
        return self._local[key], hit

    def fused_decode(self, boundaries) -> tuple[FusedDecodeProgram, bool]:
        boundaries = tuple(int(b) for b in boundaries)
        return self._lookup(("fused", boundaries), lambda: FusedDecodeProgram(
            self.cfg, boundaries, self.params["blocks"], self.head_params,
            self.paged_kernel))

    def stage_prefill(self, lo: int, hi: int, *, first: bool, last: bool):
        return self._lookup(("prefill", lo, hi, first, last),
                            lambda: StagePrefillProgram(self.cfg, lo, hi,
                                                        first, last,
                                                        self.paged))

    def chunk_prefill(self, lo: int, hi: int, *, first: bool, last: bool,
                      sample: bool, chunk_len: int, kv_extent: int):
        """``sample`` only matters on the last stage, so it is masked off
        elsewhere and earlier stages share programs across chunks."""
        sample = bool(sample and last)
        key = ("chunk", lo, hi, first, last, sample, chunk_len, kv_extent)
        return self._lookup(key, lambda: ChunkPrefillProgram(
            self.cfg, lo, hi, first, sample, kv_extent, self.paged))

    def stage_decode(self, lo: int, hi: int):
        return self._lookup(("decode", lo, hi),
                            lambda: StageDecodeProgram(self.cfg, lo, hi))

    def is_warm(self, boundaries) -> bool:
        """Is this configuration's fused program built AND run once?
        (No hit/miss accounting.)"""
        prog = self._local.get(("fused", tuple(int(b) for b in boundaries)))
        return bool(prog is not None and prog.warm)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "builds": self.builds}
