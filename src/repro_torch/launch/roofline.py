"""Analytic cost model on an explicit card's roofline.

Ports ``repro/launch/roofline.py`` with the same counts, term by term:
``layer_fwd`` and ``layer_param_bytes``, the FLOPs and HBM bytes of one
layer's forward over a batch of ``tok`` tokens at attention context
``ctx`` on one device under ``T``-way tensor parallelism; and the
whole-step model, ``step_costs`` (per-device FLOPs, HBM, link and host
bytes of one train, prefill or decode step of a pipeline plan, its roofline
terms, bubble and lower bound) and ``hbm_footprint`` (persistent device
memory).  The controller plane's graph (``core/graph.py``), the admission
cost model's prior (``CostModel.from_roofline``), ``launch/dryrun.py`` and
``launch/hillclimb.py`` read it.

What the reference fixes is explicit here: the hardware, a frozen ``Chip``
(``H100_SXM`` by default: its peak for the element size, HBM, NVLink as
the on-node link where the reference has ICI, and the host link where it
has DCN), the bytes per element, which come from the dtype (4 for the
port's f32 paths), and the mesh (``pod`` x ``data`` x ``model`` devices;
the reference's model axis is always 16).  Passing the reference's
constants as a ``Chip`` with ``bytes_per_el=2`` reproduces its numbers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.configs.base import (MIXER_ATTN, MIXER_CROSS, MIXER_MAMBA,
                                      MIXER_MLA, MIXER_RWKV, MLP_MOE,
                                      ModelConfig, PipelinePlan, ShapeConfig)
from repro_torch.models.kvcache import layer_shapes
from repro_torch.models.layers import moe_capacity
from repro_torch.models.ssm import mamba_dims, rwkv_dims
from repro_torch.models.transformer import (block_spec, count_params,
                                            spec_numel)


@dataclass(frozen=True)
class Chip:
    """Peak rates and sizes of one accelerator."""
    hbm_bw: float              # device memory, bytes/s
    flops_f32: float           # f32 FLOP/s (outside the tensor cores)
    flops_bf16: float          # dense bf16 tensor-core FLOP/s
    link_bw: float             # card-to-card link, bytes/s per direction
    host_bw: float             # host-to-card link, bytes/s per direction
    hbm_bytes: float           # device memory capacity, bytes
    name: str = "chip"         # names hbm_footprint's fits_<name> key

    def peak_flops(self, bytes_per_el: int) -> float:
        """Peak FLOP/s for elements of ``bytes_per_el`` bytes."""
        if bytes_per_el == 4:
            return self.flops_f32
        if bytes_per_el == 2:
            return self.flops_bf16
        raise ValueError(f"no peak rate for {bytes_per_el}-byte elements")


# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: HBM3 at
# 3.35 TB/s, 67 TFLOP/s f32, 989 TFLOP/s bf16, NVLink 4 at 450 GB/s per
# direction, PCIe Gen5 x16 at about 64 GB/s, 80 GB of HBM3
H100_SXM = Chip(hbm_bw=3.35e12, flops_f32=67e12, flops_bf16=989e12,
                link_bw=450e9, host_bw=64e9, hbm_bytes=80e9,
                name="h100_sxm_80gb")


@dataclass
class Costs:
    flops: float = 0.0          # per device
    hbm_bytes: float = 0.0      # per device
    link_bytes: float = 0.0     # per device: collectives inside a pod
    host_bytes: float = 0.0     # per device: collectives across pods

    def add(self, other: "Costs") -> None:
        self.flops += other.flops
        self.hbm_bytes += other.hbm_bytes
        self.link_bytes += other.link_bytes
        self.host_bytes += other.host_bytes


def _ring_ar(bytes_: float, n: int) -> float:
    """Per-device wire bytes of a ring all-reduce over n devices."""
    return 2 * (n - 1) / n * bytes_ if n > 1 else 0.0


def _ring_ag(bytes_full: float, n: int) -> float:
    """Per-device wire bytes of an all-gather producing bytes_full."""
    return (n - 1) / n * bytes_full if n > 1 else 0.0


def layer_fwd(cfg: ModelConfig, j: int, tok: int, ctx: int, T: int,
              decode: bool, *, bytes_per_el: int = 4) -> Costs:
    """One layer's forward cost on ONE device (T-way tensor parallel)."""
    c = Costs()
    d = cfg.d_model
    kind = cfg.layer_kind(j)
    hd = cfg.resolved_head_dim
    Hl = cfg.n_heads // T if cfg.n_heads % T == 0 else cfg.n_heads
    Khl = cfg.n_kv_heads // T if cfg.n_kv_heads % T == 0 else cfg.n_kv_heads

    if kind.mixer == MIXER_ATTN or kind.mixer == MIXER_CROSS:
        # q/k/v/o projections
        c.flops += 2 * tok * d * (Hl + 2 * Khl + Hl) * hd
        attn_ctx = ctx
        if (cfg.sliding_window and not cfg.is_global_layer(j)
                and kind.mixer == MIXER_ATTN):
            attn_ctx = min(ctx, cfg.sliding_window)
        if kind.mixer == MIXER_CROSS:
            attn_ctx = cfg.n_memory_tokens or ctx
        # scores + weighted sum (causal halves prefill ctx on average)
        causal_frac = 0.5 if (not decode and kind.mixer == MIXER_ATTN) else 1.0
        c.flops += 2 * 2 * tok * Hl * hd * attn_ctx * causal_frac
        if decode:
            # per decode step each of `tok` requests reads its full k+v cache
            c.hbm_bytes += 2 * Khl * attn_ctx * hd * bytes_per_el * tok
    elif kind.mixer == MIXER_MLA:
        m = cfg.mla
        Hl = cfg.n_heads // T
        c.flops += 2 * tok * d * m.q_lora_rank                     # q down
        c.flops += 2 * tok * m.q_lora_rank * Hl * (m.nope_head_dim
                                                   + m.rope_head_dim)
        c.flops += 2 * tok * d * (m.kv_lora_rank + m.rope_head_dim)  # kv down
        if decode:
            # absorbed: q_lat = q @ Wk_up ; scores vs latent; o_lat @ Wv_up
            c.flops += 2 * tok * Hl * m.nope_head_dim * m.kv_lora_rank
            c.flops += 2 * 2 * tok * Hl * ctx * (m.kv_lora_rank
                                                 + m.rope_head_dim)
            c.flops += 2 * tok * Hl * m.kv_lora_rank * m.v_head_dim
            c.hbm_bytes += ctx * (m.kv_lora_rank + m.rope_head_dim) \
                * bytes_per_el * tok
        else:
            # materialized k/v up-projections + flash attention
            c.flops += 2 * tok * m.kv_lora_rank * Hl * (m.nope_head_dim
                                                        + m.v_head_dim)
            c.flops += 2 * 2 * tok * Hl * (m.nope_head_dim
                                           + m.rope_head_dim) * ctx * 0.5
        c.flops += 2 * tok * Hl * m.v_head_dim * d                 # out proj
    elif kind.mixer == MIXER_MAMBA:
        di, dtr, N, dc = mamba_dims(cfg)
        dil = di // T
        c.flops += 2 * tok * d * 2 * dil                           # w_x, w_z
        c.flops += 2 * tok * dil * dc                              # conv
        c.flops += 2 * tok * dil * (dtr + 2 * N)                   # x_proj
        c.flops += 2 * tok * dtr * dil                             # dt_proj
        c.flops += tok * dil * N * 6                               # scan math
        c.flops += 2 * tok * dil * d                               # out proj
    elif kind.mixer == MIXER_RWKV:
        H, hs = rwkv_dims(cfg)
        dl = d // T
        c.flops += 2 * tok * d * dl * 4                            # r,k,v,g
        c.flops += 2 * tok * d * (cfg.ssm.decay_lora + 5 * cfg.ssm.mix_lora) * 2
        c.flops += tok * (dl * hs) * 4                             # wkv recurrence
        c.flops += 2 * tok * dl * d                                # out proj
        # channel mix
        ffl = cfg.d_ff // T
        c.flops += 2 * tok * d * ffl + 2 * tok * ffl * d + 2 * tok * d * d
    if kind.extra_cross:
        Hl = cfg.n_heads // T if cfg.n_heads % T == 0 else cfg.n_heads
        mem = ctx
        c.flops += 2 * tok * d * 2 * Hl * hd                       # q, o
        c.flops += 2 * 2 * tok * Hl * hd * mem
        if decode:
            c.hbm_bytes += 2 * Khl * mem * hd * bytes_per_el * tok

    # MLP
    if kind.mixer != MIXER_RWKV:
        if kind.mlp == MLP_MOE:
            mo = cfg.moe
            E_loc = max(mo.n_experts // T, 1)
            cap_tok = tok * mo.top_k / (1 if T == 1 else T) \
                * mo.capacity_factor
            # dispatch/combine einsums + expert FFN on capacity tokens
            c.flops += 2 * tok * E_loc * moe_capacity(cfg, tok) * 2
            c.flops += 3 * 2 * cap_tok * cfg.d_model * mo.d_expert
            if mo.n_shared:
                fs = mo.n_shared * mo.d_expert // (
                    T if (mo.n_shared * mo.d_expert) % T == 0 else 1)
                c.flops += 3 * 2 * tok * cfg.d_model * fs
            c.flops += 2 * tok * cfg.d_model * mo.n_experts       # router
        else:
            ffl = cfg.d_ff // T if cfg.d_ff % T == 0 else cfg.d_ff
            n_mat = 2 if cfg.mlp_act == "gelu" else 3
            c.flops += n_mat * 2 * tok * cfg.d_model * ffl
    return c


def layer_param_bytes(cfg: ModelConfig, j: int, T: int, *,
                      bytes_per_el: int = 4) -> float:
    """Per-device parameter bytes of layer j under T-way TP, from the port's
    param shapes (``transformer.block_spec``; no allocation)."""
    return spec_numel(block_spec(cfg, cfg.layer_kind(j))) * bytes_per_el / T


# ---------------------------------------------------------------------------
# Whole-step roofline
# ---------------------------------------------------------------------------

def _local_batch(shape: ShapeConfig, plan: PipelinePlan, dp: int) -> int:
    """Requests per device: replicated under SP or a batch below dp."""
    if plan.seq_parallel_kv or shape.global_batch < dp:
        return shape.global_batch
    return shape.global_batch // dp


def step_costs(cfg: ModelConfig, shape: ShapeConfig, plan: PipelinePlan,
               pod: int = 1, data: int = 16, model: int = 16, *,
               chip: Chip = H100_SXM, bytes_per_el: int = 4) -> dict:
    """Per-device costs and roofline terms of one step (train or serve) of
    ``plan`` on ``pod`` x ``data`` x ``model`` devices of ``chip``."""
    S, T, R, M = plan.stages, plan.tensor, plan.replica, plan.microbatches
    train = shape.kind == "train"
    decode = shape.is_decode
    Bm = max(_local_batch(shape, plan, pod * data * R) // M, 1)
    Sq = 1 if decode else shape.seq_len
    ctx = shape.seq_len
    tok = Bm * Sq
    n_ticks = M + S - 1
    pps = cfg.n_patterns // S
    d = cfg.d_model
    kw = dict(bytes_per_el=bytes_per_el)

    c = Costs()
    kv_scale = 0.5 if plan.kv_dtype == "fp8" else 1.0
    # per-tick stage compute
    stage = Costs()
    for _ in range(pps):
        for j in range(cfg.pattern_size):
            lc = layer_fwd(cfg, j, tok, ctx, T, decode, **kw)
            lc.hbm_bytes *= kv_scale          # decode hbm = cache reads
            if plan.seq_parallel_kv and cfg.layer_kind(j).mixer == MIXER_ATTN \
                    and cfg.is_global_layer(j):
                lc.hbm_bytes /= data          # cache sharded over data (SP)
            stage.add(lc)
    # whisper's encoder (S = 1): once per tick on the current microbatch
    if cfg.encoder_layers and not decode:
        for _ in range(cfg.encoder_layers):
            stage.add(layer_fwd(cfg, 0, tok, Sq, T, False, **kw))

    # train: the backward is 2x the forward's products; tick remat
    # recomputes the forward once more
    fwd_mult = (4.0 if plan.remat else 3.0) if train else 1.0
    c.flops += stage.flops * n_ticks * fwd_mult
    c.hbm_bytes += stage.hbm_bytes * n_ticks * (2.0 if train else 1.0)

    # param HBM traffic: stage params re-read per tick (and backward passes)
    params_all = sum(layer_param_bytes(cfg, j, T, **kw)
                     for j in range(cfg.pattern_size)) * pps
    c.hbm_bytes += params_all * n_ticks * fwd_mult
    # activation HBM traffic: ~4 moves of the activations per layer boundary
    act_bytes = tok * d * bytes_per_el
    c.hbm_bytes += act_bytes * 4 * pps * cfg.pattern_size * n_ticks \
        * fwd_mult

    # embed and head
    Vloc = cfg.vocab_size // (S * T)
    c.flops += 2 * tok * d * Vloc * n_ticks * fwd_mult
    c.hbm_bytes += Vloc * d * bytes_per_el * n_ticks

    # collectives, per device
    if S > 1:
        c.link_bytes += act_bytes * n_ticks              # ppermute per tick
        c.link_bytes += _ring_ar(act_bytes, S) * n_ticks       # emit psum
        c.link_bytes += _ring_ar(act_bytes, S * T) * n_ticks   # embed psum
    if T > 1:                           # two TP psums per layer per tick
        c.link_bytes += _ring_ar(act_bytes, T) * 2 * pps \
            * cfg.pattern_size * n_ticks * fwd_mult
    if plan.seq_parallel_kv:            # the SP decode combine
        n_global = sum(1 for _ in range(pps) for j in range(cfg.pattern_size)
                       if cfg.layer_kind(j).mixer == MIXER_ATTN
                       and cfg.is_global_layer(j))
        c.link_bytes += _ring_ar(tok * cfg.n_heads // max(T, 1)
                                 * cfg.resolved_head_dim * 4, data) \
            * n_global * n_ticks
    if train:
        # fsdp: a per-layer all-gather per tick (forward and the backward's
        # re-gather) and one reduce-scatter a step; else a grad all-reduce
        if plan.fsdp:
            g_scale = 0.5 if plan.fsdp_fp8_gather else 1.0
            c.link_bytes += _ring_ag(params_all, data) * n_ticks * 2 \
                * g_scale
            c.link_bytes += _ring_ar(params_all * 2, data) / 2
        else:
            c.link_bytes += _ring_ar(params_all * 2, data)
        if pod > 1:
            c.host_bytes += _ring_ar(params_all, pod)   # cross-pod grads
        c.link_bytes += _ring_ar(Vloc * d * bytes_per_el, data)

    # roofline terms, seconds
    compute_t = c.flops / chip.peak_flops(bytes_per_el)
    memory_t = c.hbm_bytes / chip.hbm_bw
    coll_t = c.link_bytes / chip.link_bw + c.host_bytes / chip.host_bw
    bubble = (S - 1) / n_ticks

    # model FLOPs: the step's useful work, per device
    n_active = count_params(cfg, active_only=True)
    global_tokens = shape.global_batch * Sq
    model_flops = (6 if train else 2) * n_active * global_tokens \
        / (pod * data * model)

    dom = max((compute_t, "compute"), (memory_t, "memory"),
              (coll_t, "collective"))
    return {
        "flops": c.flops, "hbm_bytes": c.hbm_bytes,
        "link_bytes": c.link_bytes, "host_bytes": c.host_bytes,
        "compute_s": compute_t, "memory_s": memory_t, "collective_s": coll_t,
        "dominant": dom[1], "bubble_fraction": bubble,
        "model_flops": model_flops,
        "useful_ratio": model_flops / max(c.flops, 1.0),
        "step_time_lower_bound_s": max(compute_t, memory_t, coll_t)
        / (1.0 if train else max(1e-9, 1 - bubble)),
    }


def hbm_footprint(cfg: ModelConfig, shape: ShapeConfig, plan: PipelinePlan,
                  pod: int = 1, data: int = 16, *, chip: Chip = H100_SXM,
                  bytes_per_el: int = 4) -> dict:
    """Persistent device memory per device, analytic: params, AdamW's f32
    moments and grads (train), the activations carried across ticks, and
    the KV cache, sized from ``kvcache.layer_shapes`` (nothing is
    allocated).  ``fits_<chip.name>``: the total under ``chip.hbm_bytes``."""
    S, T, R, M = plan.stages, plan.tensor, plan.replica, plan.microbatches
    train = shape.kind == "train"
    fsdp = data if plan.fsdp else 1
    n_params = count_params(cfg)
    pbytes = n_params * bytes_per_el / (S * T) / fsdp
    opt = 2 * n_params * 4 / (S * T) / fsdp if train else 0.0
    grads = pbytes if train else 0.0
    dp = pod * data * R
    Bm = max(_local_batch(shape, plan, dp) // M, 1)
    Sq = 1 if shape.is_decode else shape.seq_len
    act = Bm * Sq * cfg.d_model * bytes_per_el \
        * ((M + S - 1) if train else 4)
    cache = 0.0
    if not train:
        per_req = sum(math.prod(s) for i in range(cfg.n_layers)
                      for leaves in layer_shapes(cfg, i, 1,
                                                 shape.seq_len).values()
                      for s in leaves.values()) * bytes_per_el
        if plan.kv_dtype == "fp8":
            per_req /= 2
        total = per_req * shape.global_batch
        cache = total / (S * (T if cfg.n_kv_heads % T == 0 else 1)) / \
            (data if (plan.seq_parallel_kv or shape.global_batch >= dp)
             else 1) / R
    total_b = pbytes + opt + grads + act + cache
    gb = 1024 ** 3
    return {"params_gb": pbytes / gb, "opt_gb": opt / gb,
            "grads_gb": grads / gb, "act_gb": act / gb,
            "cache_gb": cache / gb, "total_gb": total_b / gb,
            f"fits_{chip.name}": total_b < chip.hbm_bytes}
