"""RWKV-6 WKV recurrence, from a zero or a given initial state.

Ports ``repro/kernels/rwkv6_wkv.py`` (``wkv6``, a Pallas TPU kernel).  The
CUDA kernel is in ``csrc/rwkv6_wkv.cu``; its header says what bounds it on
an H100 and how the design answers it.  ``_geometry`` computes its launch
geometry, which the C launcher checks.

``wkv6`` keeps the Pallas signature and layout and adds ``state0``: r, k,
v, w ``(B, S, H, hd)``; u ``(H, hd)``; per (b, h), from the state S
(``state0``, or zero)::

    y_t = r_t . (S + diag(u) k_t (x) v_t),    S <- diag(w_t) S + k_t (x) v_t

It returns y ``(B, S, H, hd)`` in r's dtype and the final state
``(B, H, hd, hd)`` in f32: ``state0`` itself, overwritten in place (a cache
is updated with no second state allocated), or a new tensor when there is
no ``state0``.  Without ``state0`` it equals the Pallas kernel; with it,
the reference ``repro.kernels.ref.wkv6_ref(..., state0=)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)      # instantiated in the .cu
# A call of at most this many steps (a decode tick) gives each lane 16 state
# rows instead of 4: a quarter of the threads, so a batch-8 tick's CTAs fit
# in one wave, and its time is the state's bytes.  hd = 16 keeps 4 rows (16
# would leave a CTA of 16 threads).
FEW_STEPS = 4
_UNIT, _STAGES, _MAX_THREADS = 4, 3, 256   # kUnit, kStages, kMaxThreads


class Geometry(NamedTuple):
    rows: int            # state rows per lane (R)
    lanes: int           # lanes per state column (G = hd / R)
    cols: int            # state columns per CTA (JC)
    threads: int         # per CTA (G x JC)
    tile: int            # steps per time tile (TT)
    ctas_per_head: int   # hd / JC
    smem: int            # dynamic shared memory per CTA, bytes


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _geometry(hd: int, dtype: torch.dtype, S: int) -> Geometry:
    """The kernel's launch geometry for a call of S steps: ``Geo`` and
    ``smem_layout`` in csrc/rwkv6_wkv.cu, which refuses a shared-memory
    size other than its own."""
    R = 16 if S <= FEW_STEPS and hd >= 32 else 4
    G = hd // R
    JC = min(hd, _MAX_THREADS // G)
    TT = 32 if hd <= 64 else 16
    tts = min(TT, S)
    stages = min(_STAGES, -(-S // TT))
    stage = _round_up(tts * (3 * hd + JC) * dtype.itemsize, 16)
    ps = _round_up(tts * JC, 32) + JC % 32
    smem = stages * stage + 2 * (hd // _UNIT) * ps * 4
    return Geometry(R, G, JC, G * JC, TT, hd // JC, smem)


def wkv6_plain(r, k, v, w, u, state0=None):
    """The sequential recurrence written out, in f32.  Leaves ``state0``
    as it is and returns the final state as a new tensor."""
    B, S, H, hd = r.shape
    st = (state0.float() if state0 is not None
          else torch.zeros((B, H, hd, hd), dtype=torch.float32,
                           device=r.device))
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]                     # (1, H, hd, 1)
    ys = []
    for t in range(S):
        a = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # (B, H, hd, hd)
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], st + uf * a))
        st = wf[:, t, :, :, None] * st + a
    y = torch.stack(ys, dim=1) if ys else torch.empty_like(rf)
    return y.to(r.dtype), st


def wkv6(r, k, v, w, u, state0=None):
    """r, k, v, w: (B, S, H, hd); u: (H, hd); state0: None or (B, H, hd,
    hd) f32, overwritten with the final state.  Returns (y (B, S, H, hd) in
    r's dtype, final state)."""
    B, S, H, hd = r.shape
    st_shape = (B, H, hd, hd)
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or tuple(u.shape) != (H, hd) \
            or (state0 is not None and tuple(state0.shape) != st_shape):
        raise ValueError(
            f"wkv6: bad shapes r{tuple(r.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} w{tuple(w.shape)} u{tuple(u.shape)} "
            f"state0{None if state0 is None else tuple(state0.shape)}")
    if r.device.type == "cpu":
        y, st = wkv6_plain(r, k, v, w, u, state0)
        return y, (st if state0 is None else state0.copy_(st))
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for {r.device}")
    for t in (k, v, w):
        if t.device != r.device or t.dtype != r.dtype:
            raise ValueError("wkv6: r, k, v and w must share one device and "
                             f"dtype, got {t.device}/{t.dtype} vs "
                             f"{r.device}/{r.dtype}")
    if r.dtype not in _DTYPES:
        raise TypeError(f"wkv6 kernel takes float32 or bfloat16, got "
                        f"{r.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel is built for hd in {HEAD_DIMS}, got "
                         f"{hd}")
    for t in (u, state0):
        if t is not None and (t.dtype != torch.float32
                              or t.device != r.device):
            raise TypeError("wkv6: u and state0 must be float32 on r's "
                            f"device, got {t.dtype} on {t.device}")
    if not all(t.is_contiguous() for t in (r, k, v, w, u, state0)
               if t is not None):
        raise ValueError("wkv6: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("wkv6: r, k, v and w must be 16-byte aligned (the "
                         "kernel copies them by cp.async)")
    y = torch.empty_like(r)
    st = (state0 if state0 is not None else
          torch.zeros(st_shape, dtype=torch.float32, device=r.device))
    geo = _geometry(hd, r.dtype, S)
    lib = build.library("rwkv6_wkv")
    err = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        st.data_ptr(), y.data_ptr(), B, S, H, hd, geo.rows, _DTYPES[r.dtype],
        geo.smem, torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "wkv6")
    build.launches["wkv6"] += 1
    return y, st
