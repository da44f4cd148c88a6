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

Under autograd on CUDA the call goes through ``WKV6Fn``, whose backward is
``csrc/rwkv6_wkv_bwd.cu`` (f32; the Pallas package has no backward kernel,
JAX differentiates its scan).  Its plain version is ``wkv6_bwd_plain``,
autograd through ``wkv6_plain``.  The kernel splits each head's state
columns over a cluster of CTAs and sums the row gradients (dr, dk, dw)
over the cluster in rank order: ``wkv6_bwd_partials_plain`` and
``wkv6_bwd_groups_plain`` are the plain versions of that split, and
``_bwd_geometry`` its geometry, which the launcher checks.
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


def wkv6_bwd_plain(r, k, v, w, u, state0, dy, dstate=None):
    """The backward's plain version: (dr, dk, dv, dw, du, dstate0) of
    ``wkv6_plain`` for the incoming ``dy`` and final-state gradient
    ``dstate`` (None: zero), by autograd; dstate0 is None without
    ``state0``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (r, k, v, w, u)]
        s0 = (state0.detach().requires_grad_(True) if state0 is not None
              else None)
        y, st = wkv6_plain(*ins, s0)
        outs, grads = [y], [dy]
        if dstate is not None:
            outs.append(st)
            grads.append(dstate)
        g = torch.autograd.grad(outs, ins + ([s0] if s0 is not None else []),
                                grads, allow_unused=True)
    g = [torch.zeros_like(t) if d is None else d for d, t in zip(g, ins)] \
        + ([g[5]] if s0 is not None else [None])
    return tuple(g)


class BwdGeometry(NamedTuple):
    cluster: int         # CTAs per (b, h), each owning ``cols`` columns
    cols: int            # state columns per CTA (JC)
    threads: int         # per CTA: 8 columns of a row a lane
    chunk: int           # steps per chunk (TC)
    smem: int            # dynamic shared memory per CTA, bytes


def _bwd_geometry(hd: int) -> BwdGeometry:
    """The backward kernel's geometry (csrc/rwkv6_wkv_bwd.cu, ``Geo``),
    which the launcher refuses to differ: 32 state columns a CTA (hd 16:
    16), hd / 32 CTAs a cluster, 8 columns a thread, chunks of 16 steps
    (two sub-chunks of 8 in registers).  Shared memory: one region that
    holds pass 1's 3-stage ring (a chunk's k and w rows and its columns of
    v a stage) or, in pass 2, 2 stages of a chunk's r, k, w rows and its
    columns of v and dy and 2 buffers of the row partials the cluster's
    ranks push for this rank's rows (per rank dr, dk and dw, 16 steps each,
    and v . dy); then dv's warp partials, each thread's chunk-start state
    (2 stages), u, sum_i r u k per step and du's per-thread sums."""
    jc, tc, e = min(32, hd), 16, 8
    nt = hd * jc // e
    c = hd // jc
    region = max(3 * tc * (2 * hd + jc),
                 2 * tc * (3 * hd + 2 * jc) + 2 * c * (3 * tc * jc + tc))
    floats = region + tc * (nt // 32) * jc + 2 * nt * e + hd + tc + nt
    return BwdGeometry(c, jc, nt, tc, 4 * floats)


def _wkv_states(r, k, v, w, state0):
    """The state before each step, (S + 1, B, H, hd, hd) f32, from state0
    (or zero): entry t is the state step t reads, entry S the final one."""
    B, S, H, hd = r.shape
    st = (state0.float() if state0 is not None
          else torch.zeros((B, H, hd, hd), dtype=torch.float32,
                           device=r.device))
    out = [st]
    for t in range(S):
        st = w[:, t].float()[..., None] * st \
            + k[:, t].float()[..., None] * v[:, t].float()[..., None, :]
        out.append(st)
    return torch.stack(out)


def wkv6_bwd_partials_plain(r, k, v, w, u, state0, dy, dstate=None,
                            groups=1):
    """The backward kernel's split, written out in f32: the state's columns
    in ``groups`` equal groups (the cluster's CTAs), each walked back over
    its columns alone.  Returns (dr, dk, dw partials, each (groups, B, S,
    H, hd): the row sums over the group's columns, without the u terms;
    v . dy over the group's columns (groups, B, S, H); dv (B, S, H, hd),
    each column complete in its group; dstate0 (B, H, hd, hd))."""
    B, S, H, hd = r.shape
    if groups < 1 or hd % groups:
        raise ValueError(f"wkv6: {groups} groups do not cut {hd} columns "
                         "evenly")
    cw = hd // groups
    states = _wkv_states(r, k, v, w, state0)
    rf, kf, vf, wf, dyf = (x.float() for x in (r, k, v, w, dy))
    rku = (rf * u.float()[None, None] * kf).sum(-1)       # (B, S, H)
    pr, pk, pw, pvd = [], [], [], []
    dv = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    for c in range(groups):
        cols = slice(c * cw, (c + 1) * cw)
        ds = (dstate.float()[..., cols] if dstate is not None else
              torch.zeros((B, H, hd, cw), dtype=torch.float32,
                          device=r.device))
        gr, gk, gw = (torch.empty((B, S, H, hd), dtype=torch.float32,
                                  device=r.device) for _ in range(3))
        for t in range(S - 1, -1, -1):
            sp = states[t][..., cols]                  # (B, H, hd, cw)
            yy, vv = dyf[:, t, :, cols], vf[:, t, :, cols]
            gr[:, t] = (sp * yy[:, :, None, :]).sum(-1)
            gw[:, t] = (ds * sp).sum(-1)
            gk[:, t] = (ds * vv[:, :, None, :]).sum(-1)
            dv[:, t, :, cols] = (ds * kf[:, t, :, :, None]).sum(-2) \
                + yy * rku[:, t, :, None]
            ds = wf[:, t, :, :, None] * ds \
                + rf[:, t, :, :, None] * yy[:, :, None, :]
        ds0[..., cols] = ds
        pr.append(gr)
        pk.append(gk)
        pw.append(gw)
        pvd.append((vf[..., cols] * dyf[..., cols]).sum(-1))
    return (torch.stack(pr), torch.stack(pk), torch.stack(pw),
            torch.stack(pvd), dv, ds0)


def wkv6_bwd_groups_plain(r, k, v, w, u, state0, dy, dstate=None, groups=1):
    """The backward through ``wkv6_bwd_partials_plain``: each row gradient
    and v . dy summed over the groups in rank order, then the u terms, as
    the kernel's reduction does.  Returns (dr, dk, dv, dw, du, dstate0),
    dstate0 None without ``state0``, as ``wkv6_bwd_plain``."""
    pr, pk, pw, pvd, dv, ds0 = wkv6_bwd_partials_plain(
        r, k, v, w, u, state0, dy, dstate, groups)
    dr, dk, dw, vdy = pr[0], pk[0], pw[0], pvd[0]
    for c in range(1, groups):                 # rank order, as the kernel
        dr, dk, dw, vdy = dr + pr[c], dk + pk[c], dw + pw[c], vdy + pvd[c]
    uf, rf, kf = u.float()[None, None], r.float(), k.float()
    dr = dr + uf * kf * vdy[..., None]
    dk = dk + rf * uf * vdy[..., None]
    du = (rf * kf * vdy[..., None]).sum(dim=(0, 1))
    return dr, dk, dv, dw, du, (ds0 if state0 is not None else None)


def _launch_forward(r, k, v, w, u, st):
    """The forward kernel on validated CUDA inputs; ``st`` (B, H, hd, hd)
    f32 holds the initial state and is overwritten with the final one."""
    B, S, H, hd = r.shape
    y = torch.empty_like(r)
    geo = _geometry(hd, r.dtype, S)
    lib = build.library("rwkv6_wkv")
    err = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        st.data_ptr(), y.data_ptr(), B, S, H, hd, geo.rows, _DTYPES[r.dtype],
        geo.smem, torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "wkv6")
    build.launches["wkv6"] += 1
    return y, st


def _launch_backward(r, k, v, w, u, state0, dy, dstate):
    """The backward kernel (csrc/rwkv6_wkv_bwd.cu) on f32 CUDA inputs:
    (dr, dk, dv, dw, du, dstate0); ``state0`` and ``dstate`` may be None
    (zero)."""
    B, S, H, hd = r.shape
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
    du = torch.empty_like(u)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if S == 0:
        for t in (dr, dk, dv, dw, du):
            t.zero_()
        return dr, dk, dv, dw, du, (ds0.copy_(dstate) if dstate is not None
                                    else ds0.zero_())
    # the kernel copies rows and reads states in 16-byte pieces
    state0, dy, dstate = (t if t is None or t.data_ptr() % 16 == 0
                          else t.clone() for t in (state0, dy, dstate))
    geo = _bwd_geometry(hd)
    # du's per-(b, h) sums, then the state at each chunk's start
    scratch = torch.empty(B * H * hd + B * H * -(-S // geo.chunk) * hd * hd,
                          dtype=torch.float32, device=r.device)
    lib = build.library("rwkv6_wkv_bwd")
    err = lib.wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state0.data_ptr() if state0 is not None else None, dy.data_ptr(),
        dstate.data_ptr() if dstate is not None else None, dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        ds0.data_ptr(), scratch.data_ptr(), B, S, H, hd, geo.cluster,
        geo.chunk, geo.smem, torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "wkv6_bwd")
    build.launches["wkv6_bwd"] += 1
    return dr, dk, dv, dw, du, ds0


class WKV6Fn(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel.  The
    kernel writes the final state into a copy of ``state0`` (or a zero
    state), so ``state0``, which the backward reads, is left as it is."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        ctx.set_materialize_grads(False)
        B, S, H, hd = r.shape
        st = (state0.clone() if state0 is not None else
              torch.zeros((B, H, hd, hd), dtype=torch.float32,
                          device=r.device))
        y, st = _launch_forward(r, k, v, w, u, st)
        ctx.save_for_backward(r, k, v, w, u, state0)
        return y, st

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        dr, dk, dv, dw, du, ds0 = _launch_backward(
            r, k, v, w, u, s0, dy.contiguous(),
            dstate.contiguous() if dstate is not None else None)
        return dr, dk, dv, dw, du, (ds0 if s0 is not None else None)


def wkv6(r, k, v, w, u, state0=None):
    """r, k, v, w: (B, S, H, hd); u: (H, hd); state0: None or (B, H, hd,
    hd) f32, overwritten with the final state.  Returns (y (B, S, H, hd) in
    r's dtype, final state).

    Where autograd records the call (grad mode on, an input requiring
    grad), ``state0`` is left as it is and the final state is a new tensor,
    so no tensor autograd keeps is overwritten; on CUDA the call then goes
    through ``WKV6Fn`` (f32 only)."""
    B, S, H, hd = r.shape
    st_shape = (B, H, hd, hd)
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or tuple(u.shape) != (H, hd) \
            or (state0 is not None and tuple(state0.shape) != st_shape):
        raise ValueError(
            f"wkv6: bad shapes r{tuple(r.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} w{tuple(w.shape)} u{tuple(u.shape)} "
            f"state0{None if state0 is None else tuple(state0.shape)}")
    grad = build.needs_grad(r, k, v, w, u, state0)
    how = build.route(r, "wkv6")
    if how == "plain":
        y, st = wkv6_plain(r, k, v, w, u, state0)
        return y, (st if state0 is None or grad else state0.copy_(st))
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
    if grad and r.dtype != torch.float32:
        raise NotImplementedError(
            "wkv6: the backward kernel takes float32 only, and no caller "
            "needs more: the RWKV layer widens r, k and v to float32 before "
            "the WKV call at any param dtype (ROADMAP.md, section 2)")
    if how == "meta":
        y, st = build.meta_outputs(
            lambda: (r.new_empty(r.shape),
                     torch.empty(st_shape, dtype=torch.float32,
                                 device="meta")), r, k, v, w, u, state0)
        return y, (st if state0 is None or grad else state0)
    if any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("wkv6: r, k, v and w must be 16-byte aligned (the "
                         "kernel copies them by cp.async)")
    if grad:
        return WKV6Fn.apply(r, k, v, w, u, state0)
    st = (state0 if state0 is not None else
          torch.zeros(st_shape, dtype=torch.float32, device=r.device))
    return _launch_forward(r, k, v, w, u, st)
