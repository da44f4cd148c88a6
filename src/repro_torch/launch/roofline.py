"""Per-layer analytic cost model on an explicit card's roofline.

Ports ``layer_fwd`` and ``layer_param_bytes`` of ``repro/launch/roofline.py``
with the same counts: the FLOPs and HBM bytes of one layer's forward over a
batch of ``tok`` tokens at attention context ``ctx`` on one device under
``T``-way tensor parallelism.  The controller plane's graph
(``core/graph.py``) and the admission cost model's prior
(``CostModel.from_roofline``) read it.

Two things the reference fixes are explicit here: the hardware, a frozen
``Chip`` (``H100_SXM`` by default), and the bytes per element, which come
from the serving dtype (4 for the port's f32 serving path).  Passing another
``Chip`` and ``bytes_per_el`` reproduces any other set of constants.

The whole-step model (``step_costs``,
``hbm_footprint``) waits for the multi-device work (ROADMAP.md, section 1).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import (MIXER_ATTN, MIXER_CROSS, MIXER_MAMBA,
                                      MIXER_MLA, MIXER_RWKV, MLP_MOE,
                                      ModelConfig)
from repro_torch.models.layers import moe_capacity
from repro_torch.models.ssm import mamba_dims, rwkv_dims
from repro_torch.models.transformer import block_spec, spec_numel


@dataclass(frozen=True)
class Chip:
    """Peak rates and sizes of one accelerator."""
    hbm_bw: float              # device memory, bytes/s
    flops_f32: float           # f32 FLOP/s (outside the tensor cores)
    flops_bf16: float          # dense bf16 tensor-core FLOP/s
    link_bw: float             # card-to-card link, bytes/s per direction
    host_bw: float             # host-to-card link, bytes/s per direction
    hbm_bytes: float           # device memory capacity, bytes

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
                link_bw=450e9, host_bw=64e9, hbm_bytes=80e9)


@dataclass
class Costs:
    flops: float = 0.0          # per device
    hbm_bytes: float = 0.0      # per device


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
