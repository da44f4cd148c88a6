"""Recurrent mixers: Mamba-1 (Jamba's) and RWKV-6 (Finch) time mix and
channel mix.

Mamba-1 ports ``mamba_dims``, the param layout (``w_x``, ``w_z``,
``conv_w``, ``conv_b``, ``x_proj``, ``dt_proj``, ``dt_bias``, ``A_log``,
``D``, ``out_proj``), ``_mamba_core`` and ``apply_mamba`` of
``repro/models/ssm.py``, with the cache ``{"conv": (B, d_conv - 1,
d_inner), "ssm": (B, d_inner, d_state)}``.  The causal depthwise conv reads
the cached history first; the selective scan runs step by step in f32 in
torch ops (the JAX package scans it in jnp; no Pallas kernel exists for
it), from the cached state when one is given.  Like RWKV, one function
serves prefill and decode, and the cache is overwritten in place with the
final conv history and state.

RWKV-6 ports the RWKV half of ``repro/models/ssm.py`` with the same param
layout (``maa_x``, ``tm.{w,k,v,r,g}.{maa,A,B}``, ``w0``, ``wA``, ``wB``,
``u``, ``Wr/Wk/Wv/Wg/Wo``, ``ln_x``, ``maa_k``, ``maa_r``, ``Wk_cm``,
``Wv_cm``, ``Wr_cm``) and cache layout ``{"sx_tm": (B, d), "sx_cm": (B,
d), "wkv": (B, H, hd, hd)}``.  One function serves sequence mode
(prefill, forward) and step mode (decode, S == 1): both read the cache,
when given, as the initial state.

Where the JAX package scans the recurrence in jnp (``_wkv_scan``), the port
runs every WKV step through ``kernels.rwkv6_wkv.wkv6``: its plain version on
the CPU, the CUDA kernel on the card.  Caches are written in place (JAX
returns new ones): the kernel overwrites the state it reads, so an f32 WKV
cache with f32 activations is updated with no copy; otherwise the new
state, like the token-shift rows, is copied in after the layer, cast as the
JAX code casts it (to the activations' dtype, then to the cache's).

Tensor parallelism (``tp_axis``, a mesh axis name; ``parallel.comm``)
splits the inner (Mamba) or channel (RWKV) dimension: each rank reads its
widths from its param shards, and the projections that mix the whole
dimension psum their partial sums over the axis (Mamba's ``x_proj`` and
``out_proj``; RWKV's ``Wo`` and ``Wv_cm``).  RWKV's WKV runs on the rank's
H/T local heads.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_wkv import wkv6
from repro_torch.models.layers import rms_norm
from repro_torch.parallel import comm

_MIX_NAMES = ("w", "k", "v", "r", "g")


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------

def mamba_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, dt_rank, d_state, d_conv)."""
    s = cfg.ssm
    return (s.expand * cfg.d_model, s.dt_rank or math.ceil(cfg.d_model / 16),
            s.d_state, s.d_conv)


def mamba_spec(cfg: ModelConfig) -> dict:
    """Param tree of one Mamba-1 mixer as (shape, init) leaves, with the
    scales of ``repro.models.ssm.init_mamba`` (see transformer.block_spec):
    ``A_log`` is log(1..d_state) on every channel, ``dt_bias`` the inverse
    softplus of 0.01."""
    d = cfg.d_model
    di, dtr, N, dc = mamba_dims(cfg)
    s = 1.0 / math.sqrt(d)
    return {
        "w_x": ((d, di), s), "w_z": ((d, di), s),
        "conv_w": ((dc, di), 1.0 / math.sqrt(dc)),
        "conv_b": ((di,), "zeros"),
        "x_proj": ((di, dtr + 2 * N), 1.0 / math.sqrt(di)),
        "dt_proj": ((dtr, di), 1.0 / math.sqrt(dtr)),
        "dt_bias": ((di,), ("full", math.log(math.expm1(0.01)))),
        "A_log": ((di, N), "log_arange"),
        "D": ((di,), "ones"),
        "out_proj": ((di, d), s / math.sqrt(2 * cfg.n_layers)),
    }


def _mamba_core(params: dict, xc: torch.Tensor, z: torch.Tensor,
                h0: Optional[torch.Tensor], tp_axis=None):
    """Selective scan over xc (B, S, di), the conv'd input, from state
    ``h0`` (B, di, N) or zeros.  Returns (y (B, S, di), final state)."""
    B, S, di = xc.shape
    N = params["A_log"].shape[1]
    dtr = params["dt_proj"].shape[0]
    xdbl = torch.matmul(xc, params["x_proj"])
    if tp_axis:
        xdbl = comm.psum(xdbl, tp_axis)     # di is split: partial sums
    dt, Bc, Cc = torch.split(xdbl, [dtr, N, N], dim=-1)
    dt = F.softplus(torch.matmul(dt, params["dt_proj"])
                    + params["dt_bias"]).float()                 # (B, S, di)
    A = -torch.exp(params["A_log"].float())                      # (di, N)
    dA = torch.exp(dt[..., None] * A)                            # (B,S,di,N)
    dBx = (dt * xc.float())[..., None] * Bc.float()[:, :, None, :]
    Cc = Cc.float()[..., None]                                   # (B,S,N,1)
    h = (h0.float() if h0 is not None
         else torch.zeros((B, di, N), dtype=torch.float32, device=xc.device))
    ys = []
    for t in range(S):
        h = torch.addcmul(dBx[:, t], dA[:, t], h)               # dA h + dBx
        ys.append(torch.bmm(h, Cc[:, t]))                        # (B, di, 1)
    y = torch.cat(ys, dim=2).transpose(1, 2)                     # (B, S, di)
    y = y + params["D"].float() * xc.float()
    y = y * F.silu(z.float())
    return y.to(xc.dtype), h.to(xc.dtype)


def apply_mamba(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                cache: Optional[dict] = None, tp_axis=None):
    """Mamba-1 mixer (the block owns the norm and residual).  ``cache``:
    None, or the layer's ``{"conv", "ssm"}``, read as the history and
    initial state and overwritten with the final ones.  Returns
    (y, cache, aux)."""
    S = x.shape[1]
    dc = params["conv_w"].shape[0]
    x_in = torch.matmul(x, params["w_x"])
    z = torch.matmul(x, params["w_z"])
    # causal depthwise conv over time: xc[t] = sum_k w[k] * xin_ext[t + k]
    if cache is not None:
        xin_ext = torch.cat([cache["conv"].to(x_in.dtype), x_in], dim=1)
    else:
        xin_ext = F.pad(x_in, (0, 0, dc - 1, 0))
    xc = sum(xin_ext[:, k:k + S, :] * params["conv_w"][k] for k in range(dc))
    xc = F.silu(xc + params["conv_b"])
    y, hT = _mamba_core(params, xc, z,
                        cache["ssm"] if cache is not None else None, tp_axis)
    out = torch.matmul(y, params["out_proj"])
    if tp_axis:
        out = comm.psum(out, tp_axis)
    if cache is not None:
        if dc > 1:
            cache["conv"].copy_(xin_ext[:, -(dc - 1):, :])
        cache["ssm"].copy_(hT)
    return out, cache, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

def rwkv_dims(cfg: ModelConfig) -> tuple[int, int]:
    """(heads, head size) of the WKV state."""
    return cfg.d_model // cfg.ssm.head_size, cfg.ssm.head_size


def rwkv_spec(cfg: ModelConfig) -> dict:
    """Param tree of one RWKV-6 mixer as (shape, init) leaves, with the
    scales of ``repro.models.ssm.init_rwkv`` (see transformer.block_spec)."""
    d, ff = cfg.d_model, cfg.d_ff
    s = cfg.ssm
    sc = 1.0 / math.sqrt(d)
    return {
        "maa_x": ((d,), "zeros"),
        "tm": {n: {"maa": ((d,), "zeros"), "A": ((d, s.mix_lora), sc),
                   "B": ((s.mix_lora, d), "zeros")} for n in _MIX_NAMES},
        "w0": ((d,), ("full", -6.0)),      # decay bias: slow decay at init
        "wA": ((d, s.decay_lora), sc),
        "wB": ((s.decay_lora, d), "zeros"),
        "u": ((d,), 0.1),
        "Wr": ((d, d), sc), "Wk": ((d, d), sc), "Wv": ((d, d), sc),
        "Wg": ((d, d), sc),
        "Wo": ((d, d), sc / math.sqrt(2 * cfg.n_layers)),
        "ln_x": ((d,), "ones"),
        "maa_k": ((d,), "zeros"), "maa_r": ((d,), "zeros"),
        "Wk_cm": ((d, ff), sc), "Wv_cm": ((ff, d), 1.0 / math.sqrt(ff)),
        "Wr_cm": ((d, d), sc),
    }


def _ddlerp(p: dict, x, sx, xxx):
    """Data-dependent lerp: x + (sx - x) * (maa + tanh(xxx @ A) @ B)."""
    mix = p["maa"] + torch.matmul(torch.tanh(torch.matmul(xxx, p["A"])),
                                  p["B"])
    return x + (sx - x) * mix


def _shifted(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x shifted one step right in time, ``prev`` (B, d) (or zero) first."""
    B, _, d = x.shape
    first = (prev[:, None, :].to(x.dtype) if prev is not None
             else torch.zeros((B, 1, d), dtype=x.dtype, device=x.device))
    return torch.cat([first, x[:, :-1, :]], dim=1)


def apply_rwkv(cfg: ModelConfig, params: dict, x_res: torch.Tensor, *,
               cache: Optional[dict] = None, tp_axis=None, ln1=None,
               ln2=None):
    """Full RWKV-6 layer: ln1 + time mix + residual, then ln2 + channel mix
    + residual (the layer owns both residuals).  ``cache``: None, or the
    layer's state dict, read as the initial state and overwritten with the
    final one.  Returns (x, cache, aux)."""
    B, S, _ = x_res.shape
    hd = cfg.ssm.head_size
    x = rms_norm(ln1, x_res, cfg.rms_eps)
    # ---- time mix --------------------------------------------------------
    sx = _shifted(x, cache["sx_tm"] if cache is not None else None)
    sx_tm_last = x[:, -1, :]
    xxx = x + (sx - x) * params["maa_x"]
    tm = params["tm"]
    xw, xk, xv, xr, xg = (_ddlerp(tm[n], x, sx, xxx) for n in _MIX_NAMES)

    dh = params["Wr"].shape[1]                 # the local width under TP
    H = dh // hd
    r = torch.matmul(xr, params["Wr"]).reshape(B, S, H, hd)
    k = torch.matmul(xk, params["Wk"]).reshape(B, S, H, hd)
    v = torch.matmul(xv, params["Wv"]).reshape(B, S, H, hd)
    g = F.silu(torch.matmul(xg, params["Wg"]))
    w = torch.exp(-torch.exp((params["w0"] + torch.matmul(
        torch.tanh(torch.matmul(xw, params["wA"])), params["wB"])).float()))
    w = w.reshape(B, S, H, hd)
    u = params["u"].reshape(H, hd).float().contiguous()
    # an f32 contiguous cache is its own st0, and the kernel updates it
    st0 = cache["wkv"].float().contiguous() if cache is not None else None
    y, sT = wkv6(r.float().contiguous(), k.float().contiguous(),
                 v.float().contiguous(), w.contiguous(), u, st0)
    y = y.reshape(B, S, dh).to(x.dtype)
    # group norm per head: population variance, eps 1e-5 as in the reference
    yf = y.reshape(B, S, H, hd).float()
    yf = (yf - yf.mean(-1, keepdim=True)) * torch.rsqrt(
        yf.var(-1, keepdim=True, correction=0) + 1e-5)
    y = (yf.reshape(B, S, dh) * params["ln_x"].float()).to(x.dtype)
    y = y * g
    tm_out = torch.matmul(y, params["Wo"])
    x_res = x_res + (comm.psum(tm_out, tp_axis) if tp_axis else tm_out)

    # ---- channel mix -----------------------------------------------------
    x = rms_norm(ln2, x_res, cfg.rms_eps)
    sx2 = _shifted(x, cache["sx_cm"] if cache is not None else None)
    sx_cm_last = x[:, -1, :]
    xk2 = x + (sx2 - x) * params["maa_k"]
    xr2 = x + (sx2 - x) * params["maa_r"]
    kk = torch.square(F.relu(torch.matmul(xk2, params["Wk_cm"])))
    kv = torch.matmul(kk, params["Wv_cm"])
    if tp_axis:
        kv = comm.psum(kv, tp_axis)
    out = x_res + torch.sigmoid(torch.matmul(xr2, params["Wr_cm"])) * kv

    if cache is not None:
        cache["sx_tm"].copy_(sx_tm_last)
        cache["sx_cm"].copy_(sx_cm_last)
        if not (sT is cache["wkv"] and x.dtype == torch.float32):
            cache["wkv"].copy_(sT.to(x.dtype))
    return out, cache, torch.zeros((), dtype=torch.float32, device=x.device)
