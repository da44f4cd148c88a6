"""Block composition for the serving path: pre-norm self attention, gated
cross attention, multi-head latent attention (MLA) or Mamba-1 mixers, an optional cross-attention sub-block
(``extra_cross``, whisper's decoder), then a dense or MoE MLP; and RWKV-6
blocks, which own their two residuals and have no separate MLP.  An
encoder (whisper's) is a stack of non-causal attention blocks with its own
final norm; learned positions (``rope_theta == 0``) are a ``pos_embed``
table.

Ports all of ``repro/models/transformer.py``.  The JAX package stacks same-kind blocks and runs them with ``lax.scan``
(``stack_blocks``, ``scan_threshold``); PyTorch runs eagerly, so the port
loops over layers in Python and keeps one param dict per block.
``scan_runs`` stays, as the partition of a layer range into same-kind runs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (MIXER_ATTN, MIXER_CROSS, MIXER_MAMBA,
                                      MIXER_MLA, MIXER_RWKV, MLP_DENSE,
                                      MLP_MOE, LayerKind, ModelConfig)
from repro_torch.models import layers as L
from repro_torch.models import ssm


@dataclass
class BlockCtx:
    pos0: Any = 0                      # int, or (B,) positions for decode
    cache: Any = None                  # per-layer cache dict or None
    memory: Any = None                 # (B, M, d) cross-attention memory
    is_global: bool = True
    causal: bool = True
    tp_axis: Optional[str] = None
    sp_axis: Optional[str] = None
    block_table: Any = None            # paged KV: (B, max_blocks) ids
    paged_kernel: bool = False         # block-walk kernel vs gather decode
    kv_extent: int = 0                 # chunked prefill: attend over cache
                                       # rows [0, kv_extent) (0 = off)


_PORTED_KINDS = ((MIXER_ATTN, MLP_DENSE), (MIXER_ATTN, MLP_MOE),
                 (MIXER_MLA, MLP_DENSE), (MIXER_MLA, MLP_MOE),
                 (MIXER_MAMBA, MLP_DENSE), (MIXER_MAMBA, MLP_MOE),
                 (MIXER_CROSS, MLP_DENSE), (MIXER_RWKV, "rwkv_cm"))


def _check_kind(cfg: ModelConfig, kind: LayerKind) -> None:
    if (kind.mixer, kind.mlp) not in _PORTED_KINDS or \
            (kind.extra_cross and kind.mixer == MIXER_RWKV):
        raise NotImplementedError(
            f"{cfg.name}: layer kind {kind} is not ported to repro_torch "
            "yet (attention, MLA, cross attention or Mamba with a dense or "
            "MoE MLP, and RWKV-6, only); see ROADMAP.md, section 1")


def _attention_spec(cfg: ModelConfig, gated: bool = False) -> dict:
    """Self or cross attention's projections; a cross layer's ``gate`` is
    a zero scalar, as the reference initialises it."""
    d = cfg.d_model
    H, Kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = 1.0 / math.sqrt(d)
    spec = {"wq": ((d, H, hd), s), "wk": ((d, Kh, hd), s),
            "wv": ((d, Kh, hd), s),
            "wo": ((H, hd, d), s / math.sqrt(2 * cfg.n_layers))}
    if cfg.qkv_bias:
        spec.update(bq=((H, hd), "zeros"), bk=((Kh, hd), "zeros"),
                    bv=((Kh, hd), "zeros"))
    if gated:
        spec["gate"] = ((), "zeros")
    return spec


# ---------------------------------------------------------------------------
# Param shapes and init
# ---------------------------------------------------------------------------

def block_spec(cfg: ModelConfig, kind: LayerKind) -> dict:
    """Param tree of one block as (shape, init) leaves; init is a normal
    std, "ones"/"zeros", ("full", value), or "log_arange" (log(1..n) along
    the last axis).  Scales follow repro/models/layers.py and
    repro/models/ssm.py."""
    _check_kind(cfg, kind)
    d = cfg.d_model
    if kind.mixer == MIXER_RWKV:
        return {"ln1": {"scale": ((d,), "ones")}, "mixer": ssm.rwkv_spec(cfg),
                "ln2": {"scale": ((d,), "ones")}}
    if kind.mixer == MIXER_MAMBA:
        mixer = ssm.mamba_spec(cfg)
    elif kind.mixer == MIXER_MLA:
        mixer = L.mla_spec(cfg)
    else:
        mixer = _attention_spec(cfg, gated=kind.mixer == MIXER_CROSS)
    if kind.mlp == MLP_MOE:
        mlp = L.moe_spec(cfg)
    else:
        ff = cfg.d_ff
        s = 1.0 / math.sqrt(d)
        sf = 1.0 / math.sqrt(ff) / math.sqrt(2 * cfg.n_layers)
        mlp = ({"w1": ((d, ff), s), "w2": ((ff, d), sf)}
               if cfg.mlp_act == "gelu" else
               {"w_gate": ((d, ff), s), "w_up": ((d, ff), s),
                "w_down": ((ff, d), sf)})
    spec = {"ln1": {"scale": ((d,), "ones")}, "mixer": mixer}
    if kind.extra_cross:
        spec["cross"] = _attention_spec(cfg, gated=True)
        spec["ln_cross"] = {"scale": ((d,), "ones")}
    spec.update(ln2={"scale": ((d,), "ones")}, mlp=mlp)
    return spec


# the JAX package's learned position table: rows for every position
MAX_POSITIONS = 65_536


def model_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    s = 1.0 / math.sqrt(d)
    spec = {"embed": ((cfg.vocab_size, d), s),
            "final_norm": {"scale": ((d,), "ones")},
            "blocks": [block_spec(cfg, cfg.layer_kind(i))
                       for i in range(cfg.n_layers)]}
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, cfg.vocab_size), s)
    if cfg.encoder_layers:
        kind = LayerKind(mixer=MIXER_ATTN, mlp=MLP_DENSE)
        spec["encoder"] = {
            "blocks": [block_spec(cfg, kind)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": {"scale": ((d,), "ones")}}
    if cfg.rope_theta == 0:                       # learned positions
        spec["pos_embed"] = ((MAX_POSITIONS, d), 0.02)
    return spec


def _materialize(spec, generator, dtype, device):
    if isinstance(spec, dict):
        return {k: _materialize(v, generator, dtype, device)
                for k, v in spec.items()}
    if isinstance(spec, list):
        return [_materialize(v, generator, dtype, device) for v in spec]
    shape, init = spec
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if isinstance(init, tuple):                        # ("full", value)
        return torch.full(shape, init[1], dtype=dtype, device=device)
    if init == "log_arange":
        a = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(shape).to(dtype).contiguous()
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * init).to(device=device, dtype=dtype)


def init_block(cfg: ModelConfig, kind: LayerKind, generator: torch.Generator,
               dtype=torch.float32, device=None) -> dict:
    return _materialize(block_spec(cfg, kind), generator, dtype,
                        resolve_device(device))


def init_model(cfg: ModelConfig, generator: torch.Generator,
               dtype=torch.float32, device=None) -> dict:
    """Random params with the JAX package's layout and scales, drawn from
    ``generator``.  The numbers differ from ``repro``'s (another generator);
    tests carry JAX-made params across with ``convert.params_from_numpy``."""
    return _materialize(model_spec(cfg), generator, dtype,
                        resolve_device(device))


def spec_numel(spec) -> int:
    """Elements of a (shape, init) param tree (no allocation)."""
    if isinstance(spec, dict):
        return sum(spec_numel(v) for v in spec.values())
    if isinstance(spec, list):
        return sum(spec_numel(v) for v in spec)
    return math.prod(spec[0])


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the param shapes (no allocation);
    ``active_only`` counts each MoE layer's top-k routed experts instead of
    all of them, as the reference does."""
    total = spec_numel(model_spec(cfg))
    if active_only and cfg.moe is not None:
        n_moe = sum(1 for i in range(cfg.n_layers)
                    if cfg.layer_kind(i).mlp == MLP_MOE)
        per_expert = 3 * cfg.d_model * cfg.moe.d_expert
        total -= n_moe * (cfg.moe.n_experts - cfg.moe.top_k) * per_expert
    return total


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def apply_block(cfg: ModelConfig, kind: LayerKind, params: dict,
                x: torch.Tensor, ctx: BlockCtx):
    """Returns (x, new_cache, aux); the cache is updated in place."""
    _check_kind(cfg, kind)
    cache = ctx.cache or {}
    if kind.mixer == MIXER_RWKV:
        x, mc, aux = ssm.apply_rwkv(cfg, params["mixer"], x,
                                    cache=cache.get("mixer"),
                                    tp_axis=ctx.tp_axis, ln1=params["ln1"],
                                    ln2=params["ln2"])
        return x, ({"mixer": mc} if mc is not None else None), aux
    h = L.rms_norm(params["ln1"], x, cfg.rms_eps)
    if kind.mixer == MIXER_MAMBA:
        y, mc, aux = ssm.apply_mamba(cfg, params["mixer"], h,
                                     cache=cache.get("mixer"),
                                     tp_axis=ctx.tp_axis)
    elif kind.mixer == MIXER_MLA:
        y, mc, aux = L.apply_mla(cfg, params["mixer"], h, pos0=ctx.pos0,
                                 cache=cache.get("mixer"),
                                 tp_axis=ctx.tp_axis)
    elif kind.mixer == MIXER_CROSS:
        y, mc, aux = L.apply_cross_attention(
            cfg, params["mixer"], h, memory=ctx.memory,
            cache=cache.get("mixer"), tp_axis=ctx.tp_axis)
    else:
        y, mc, aux = L.apply_attention(
            cfg, params["mixer"], h, pos0=ctx.pos0, cache=cache.get("mixer"),
            is_global=ctx.is_global, causal=ctx.causal, tp_axis=ctx.tp_axis,
            sp_axis=ctx.sp_axis if ctx.is_global else None,
            block_table=ctx.block_table, paged_kernel=ctx.paged_kernel,
            kv_extent=ctx.kv_extent)
    x = x + y
    new = {"mixer": mc} if mc is not None else {}
    if kind.extra_cross:
        h = L.rms_norm(params["ln_cross"], x, cfg.rms_eps)
        y, cc, _ = L.apply_cross_attention(
            cfg, params["cross"], h, memory=ctx.memory,
            cache=cache.get("cross"), tp_axis=ctx.tp_axis)
        x = x + y
        if cc is not None:
            new["cross"] = cc
    h = L.rms_norm(params["ln2"], x, cfg.rms_eps)
    mlp = L.apply_moe if kind.mlp == MLP_MOE else L.apply_mlp
    y, _, a = mlp(cfg, params["mlp"], h, tp_axis=ctx.tp_axis)
    x = x + y
    return x, (new or None), aux + a


def scan_runs(cfg: ModelConfig, lo: int, hi: int) -> list[tuple[int, int]]:
    """Partition layers [lo, hi) into maximal runs of identical layer kind
    and global/local flavor."""
    runs: list[tuple[int, int]] = []
    start = lo
    prev = None
    for li in range(lo, hi):
        sig = (cfg.layer_kind(li), cfg.is_global_layer(li))
        if prev is not None and sig != prev:
            runs.append((start, li))
            start = li
        prev = sig
    if hi > lo:
        runs.append((start, hi))
    return runs
