"""Flash attention for prefill: causal, optional sliding window, GQA.

Ports ``repro/kernels/flash_attention.py`` (``flash_attention``, a Pallas TPU
kernel).  The CUDA kernel is in ``csrc/flash_attention.cu``; its header says
what bounds it on an H100 and how the design answers it.

The wrapper keeps the Pallas signature: q ``(B, Sq, H, hd)``, k/v ``(B, Skv,
Kh, hd/hdv)``, out ``(B, Sq, H, hdv)``.  ``q_offset`` is the absolute
position of q row 0 within the kv span; ``None`` means END-aligned,
``Skv - Sq``.  Keys at or past ``Skv`` are masked; ``window`` applies only
when ``causal``.  Unlike the Pallas kernel, the CUDA kernel takes
``q_offset``, ``Sq`` and ``Skv`` at run time.

At (hd, hdv) in ``SPAN_PAIRS`` the kernel splits the key range into fixed
spans of ``SPAN`` absolute key positions.  One CTA per work item, a (span,
tile of ``TILE_Q`` query rows, b*h) that some row of the tile sees, longest
items first, writes its rows' partial softmax states (log2 domain) into an
f32 scratch tensor the wrapper allocates, or, for a row whose keys all lie
in one span, the row's output; a second kernel merges each other row's
spans in span order.  ``span_plan``, ``flash_partials_plain`` and
``flash_combine_plain`` are the plain versions of that plan and of both
passes, and ``_geometry`` the launch geometry that the C launcher checks.

Where autograd records a call on CUDA tensors (grad mode on, an input
requiring grad), the wrapper goes through ``FlashAttentionFn``, whose
backward is ``csrc/flash_attention_bwd.cu`` (f32; the Pallas package has
no backward kernel, JAX differentiates its jnp path).  Its plain version is
``flash_attention_bwd_plain``, autograd through ``flash_attention_plain``.
The backward's main kernel runs one CTA per (key tile, b, kv head) and
writes dQ as one f32 partial per key tile, which a combine sums in
key-tile order: ``bwd_plan``, ``flash_bwd_partials_plain`` and
``flash_bwd_combine_plain`` are the plain versions of that split, and
``_bwd_geometry`` the tiles and shared memory its launcher checks.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (hd, hdv) pairs instantiated in the .cu: every shape a caller in the JAX
# package passes (hd 256 is gemma3's; (192, 128) is MLA prefill's)
HEAD_DIM_PAIRS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128),
                  (256, 256))
# the (hd, hdv) the span kernel takes; the others run in one pass
SPAN_PAIRS = ((128, 128), (192, 128), (256, 256))
SPAN = 128                         # absolute key positions per span (kSpan)
TILE_Q = 64                        # query rows per CTA (kBQ)
LOG2E = 1.4426950408889634


class Geometry(NamedTuple):
    tile: int            # kv positions per ring tile
    span: int            # key positions per span (0: one pass, no spans)
    smem: int            # dynamic shared memory per CTA, bytes


def _geometry(hd: int, hdv: int, dtype: torch.dtype) -> Geometry:
    """The kernels' launch geometry (csrc/flash_attention.cu: kTileKeys and
    smem_bytes, or span_tile and span_smem for the span kernel), which the
    launcher refuses to differ: Q's tile and a 2-stage K/V ring, rows padded
    by 16 bytes (f32) or 8 elements (bf16), and in the span kernel P and the
    pair's row maxima and sums in f32; its ring tiles hold 64 keys, or 32
    for f32 rows wider than 128."""
    es = dtype.itemsize
    if (hd, hdv) not in SPAN_PAIRS:
        return Geometry(64, 0, _ring_smem(hd, hdv, es, 64))
    bk = 32 if es == 4 and hd > 128 else 64
    return Geometry(bk, SPAN, _ring_smem(hd, hdv, es, bk)
                    + 4 * (4 * 16 * (bk + 8) + 4 * 2 * 2 * 16))


def _ring_smem(hd, hdv, es, bk):
    """Q's tile and a 2-stage ring of bk-key K and V tiles, in bytes."""
    pad = 4 if es == 4 else 8
    return es * (TILE_Q * (hd + pad) + 2 * bk * (hd + pad + hdv + pad))


def n_spans(Skv: int) -> int:
    """The span kernel's grid width for ``Skv`` keys."""
    return max(1, -(-int(Skv) // SPAN))


def _visible(qp: int, Skv: int, causal: bool, window: int):
    """The first and last key a query at absolute position qp may see."""
    lo, hi = 0, Skv - 1
    if causal:
        hi = min(hi, qp)
        if window:
            lo = max(0, qp - window + 1)
    return lo, hi


def span_plan(Sq: int, Skv: int, *, causal=True, window=0, q_offset=None):
    """The span kernel's split of the key range: the span count; per
    query row the spans it reads, as ``range(first, end)`` (they depend only
    on the row's absolute position, Skv and the window); and the live CTAs
    as (query tile, span) pairs: those where some row of the tile sees a
    key of the span."""
    q_offset = (Skv - Sq) if q_offset is None else int(q_offset)
    ns = n_spans(Skv)
    rows = []
    for i in range(Sq):
        lo, hi = _visible(q_offset + i, Skv, causal, window)
        rows.append(range(lo // SPAN, hi // SPAN + 1) if hi >= lo
                    else range(0))
    ctas = []
    for qt in range(-(-Sq // TILE_Q)):
        q0, last = qt * TILE_Q, min((qt + 1) * TILE_Q, Sq) - 1
        kv_lo, kv_hi = 0, Skv
        if causal:
            kv_hi = min(Skv, q_offset + last + 1)
            if window:
                kv_lo = max(0, q_offset + q0 - window + 1)
        ctas += [(qt, s) for s in range(ns)
                 if max(kv_lo, s * SPAN) < min(kv_hi, (s + 1) * SPAN)]
    return ns, rows, ctas


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: int,
                   q_offset: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query row may attend to."""
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
        if window:
            mask &= k_pos > q_pos - window
    return mask


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None,
                          q_offset=None):
    """Masked softmax with the score matrix materialized, in f32."""
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    G = H // Kh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q_offset = (Skv - Sq) if q_offset is None else int(q_offset)
    qf = q.float().reshape(B, Sq, Kh, G, hd) * scale
    s = torch.einsum("bqhgk,bjhk->bhgqj", qf, k.float())
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqj,bjhk->bhgqk", p, v.float()) \
        / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hdv).to(q.dtype)


def flash_partials_plain(q, k, v, *, causal=True, window=0, scale=None,
                         q_offset=None):
    """The span pass: per (b, h, query row, span) the softmax state over the
    keys of that span the row may see, in the kernel's log2 domain: ``m``
    the max of q.k * scale * log2(e), ``l`` the sum of 2^(x - m), ``acc``
    the 2^(x - m)-weighted V sum, in f32.  A span the row cannot see holds
    (-1e30, 0, 0).  Shapes (B, H, Sq, n_spans) and (..., hdv)."""
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    G = H // Kh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q_offset = (Skv - Sq) if q_offset is None else int(q_offset)
    ns = n_spans(Skv)
    pad = ns * SPAN - Skv
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    x = torch.einsum("bqhgk,bjhk->bhgqj", q.float().reshape(B, Sq, Kh, G, hd),
                     kf) * (scale * LOG2E)
    mask = attention_mask(Sq, ns * SPAN, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    mask &= (torch.arange(ns * SPAN, device=q.device) < Skv)[None, :]
    x = torch.where(mask, x, torch.full_like(x, NEG_INF))
    x = x.reshape(B, Kh, G, Sq, ns, SPAN)
    m = x.amax(dim=-1)
    p = torch.where(mask.reshape(Sq, ns, SPAN),
                    torch.exp2(x - m[..., None]), torch.zeros_like(x))
    acc = torch.einsum("bhgqsj,bsjhk->bhgqsk", p,
                       vf.reshape(B, ns, SPAN, Kh, hdv))
    return (m.reshape(B, H, Sq, ns), p.sum(dim=-1).reshape(B, H, Sq, ns),
            acc.reshape(B, H, Sq, ns, hdv))


def flash_combine_plain(m, l, acc, *, Skv: int, causal=True, window=0,
                        q_offset=None, dtype=torch.float32):
    """The combine pass: each row's spans (``span_plan``) merged in span
    order; spans the row does not read may hold anything.  Returns (B, Sq,
    H, hdv) in ``dtype``."""
    B, H, Sq, ns = m.shape
    _, rows, _ = span_plan(Sq, Skv, causal=causal, window=window,
                           q_offset=q_offset)
    live = torch.zeros((Sq, ns), dtype=torch.bool, device=m.device)
    for i, r in enumerate(rows):
        live[i, r.start:r.stop] = True
    mx = torch.full((B, H, Sq), NEG_INF, device=m.device)
    for s in range(ns):
        mx = torch.where(live[:, s], torch.maximum(mx, m[..., s]), mx)
    L = torch.zeros((B, H, Sq), device=m.device)
    O = torch.zeros(acc.shape[:3] + acc.shape[4:], device=m.device)
    for s in range(ns):                        # span order, as the kernel
        c = torch.exp2(m[..., s] - mx)
        L = torch.where(live[:, s], L + l[..., s] * c, L)
        O = torch.where(live[:, s, None], O + acc[..., s, :] * c[..., None],
                        O)
    o = O * (1.0 / torch.clamp(L, min=1e-30))[..., None]
    return o.permute(0, 2, 1, 3).to(dtype)


def flash_attention_bwd_plain(q, k, v, dout, *, causal=True, window=0,
                              scale=None, q_offset=None):
    """The backward's plain version: (dq, dk, dv) of
    ``flash_attention_plain`` for the incoming ``dout``, by autograd."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = flash_attention_plain(qq, kk, vv, causal=causal, window=window,
                                  scale=scale, q_offset=q_offset)
        return torch.autograd.grad(o, (qq, kk, vv), dout)


# the backward's LSE and D rows are padded to a multiple of this
# (kStatsRows in csrc/flash_attention_bwd.cu)
BWD_STATS_ROWS = 64
BWD_WARPS = 8


class BwdGeometry(NamedTuple):
    keys: int            # keys per CTA of the main kernel (BK)
    rows: int            # query rows per tile (BQ)
    smem: int            # dynamic shared memory of dkdv_kernel, bytes
    row_smem: int        # of the row pass, bytes


def _bwd_geometry(hd: int, hdv: int) -> BwdGeometry:
    """The backward kernels' geometry (csrc/flash_attention_bwd.cu,
    ``Geo``), which the launcher refuses to differ: BQ query rows a tile,
    64 up to hd 64 and 32 above; BK keys a CTA, 64, or 32 at hd 256.  The
    main kernel holds K and V, a 2-stage ring of Q, dO, LSE and D, P^T and
    dS^T (rows padded to BQ + 8) and dS (rows padded to BK + 8); the row
    pass holds Q, a 2-stage ring of K and its warps' row maxima and sums.
    Q and K rows are padded to hd + 4 floats, V and dO rows to hdv + 4."""
    bk = 32 if hd > 192 else 64
    bq = 32 if hd > 64 or hdv > 64 else 64
    qs, vs = hd + 4, hdv + 4
    main = (bk * (qs + vs) + 2 * bq * (qs + vs) + 4 * bq
            + 2 * bk * (bq + 8) + bq * (bk + 8))
    row = bq * qs + 2 * bk * qs + 2 * BWD_WARPS * 16
    return BwdGeometry(bk, bq, 4 * main, 4 * row)


def bwd_plan(Sq: int, Skv: int, hd: int, hdv: int, *, causal=True,
             window=0, q_offset=None):
    """The backward's split: the key-tile count; per query row the key
    tiles whose dQ partials the combine adds, as ``range(first, end)``; and
    per key tile, in launch order, the query tiles its CTA visits (for each
    of the group's heads)."""
    geo = _bwd_geometry(hd, hdv)
    bk, bq = geo.keys, geo.rows
    q_offset = (Skv - Sq) if q_offset is None else int(q_offset)
    nkt = -(-Skv // bk)
    rows = []
    for i in range(Sq):
        lo, hi = _visible(q_offset + i, Skv, causal, window)
        rows.append(range(lo // bk, hi // bk + 1) if hi >= lo else range(0))
    ctas = []
    for kt in range(nkt):
        k0 = kt * bk
        rlo, rhi = 0, Sq
        if causal:
            rlo = max(0, k0 - q_offset)
            if window:
                rhi = min(Sq, k0 + bk - 1 + window - q_offset)
        ctas.append((kt, list(range(rlo // bq, (rhi - 1) // bq + 1))
                     if rhi > rlo else []))
    return nkt, rows, ctas


def flash_bwd_partials_plain(q, k, v, dout, *, causal=True, window=0,
                             scale=None, q_offset=None):
    """The backward's main pass, written out in f32: dS = P (dP - D) with P
    the softmax over the keys a row sees and D = dout . o; dV = P^T dout
    and dK = scale dS^T Q summed over the group's heads; and per key tile
    of ``_bwd_geometry``'s keys, dQ's partial dS[:, tile] K[tile] (without
    the scale).  Returns (partials (B, H, n key tiles, Sq, hd), dk, dv)."""
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    G = H // Kh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q_offset = (Skv - Sq) if q_offset is None else int(q_offset)
    bk = _bwd_geometry(hd, hdv).keys
    nkt = -(-Skv // bk)
    qf = q.float().reshape(B, Sq, Kh, G, hd)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(B, Sq, Kh, G, hdv)
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.einsum("bqhgd,bjhd->bhgqj", qf, kf) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                    torch.zeros_like(s))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhgqj,bjhc->bhgqc", p, vf)
    d = (dof.permute(0, 2, 3, 1, 4) * o).sum(dim=-1)
    dp = torch.einsum("bqhgc,bjhc->bhgqj", dof, vf)
    ds = p * (dp - d[..., None])
    dv = torch.einsum("bhgqj,bqhgc->bjhc", p, dof)
    dk = torch.einsum("bhgqj,bqhgd->bjhd", ds, qf) * scale
    pad = nkt * bk - Skv
    dsp = torch.nn.functional.pad(ds, (0, pad)).reshape(B, Kh, G, Sq, nkt,
                                                         bk)
    kp = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, pad)).reshape(
        B, nkt, bk, Kh, hd)
    part = torch.einsum("bhgqtj,btjhd->bhgtqd", dsp, kp)
    return part.reshape(B, H, nkt, Sq, hd), dk, dv


def flash_bwd_combine_plain(part, *, Skv: int, hdv: int, causal=True,
                            window=0, scale=None, q_offset=None):
    """The backward's combine: each row's dQ partials over the key tiles it
    sees (``bwd_plan``), added in key-tile order, times the scale; tiles
    the row does not see may hold anything.  Returns dq (B, Sq, H, hd)."""
    B, H, nkt, Sq, hd = part.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    _, rows, _ = bwd_plan(Sq, Skv, hd, hdv, causal=causal, window=window,
                          q_offset=q_offset)
    live = torch.zeros((Sq, nkt), dtype=torch.bool, device=part.device)
    for i, r in enumerate(rows):
        live[i, r.start:r.stop] = True
    dq = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=part.device)
    for kt in range(nkt):                    # key-tile order, as the kernel
        dq = torch.where(live[:, kt, None], dq + part[:, :, kt], dq)
    return (dq * scale).permute(0, 2, 1, 3)


def _launch_forward(q, k, v, causal, window, scale, q_offset):
    """The forward kernel on validated CUDA inputs."""
    B, Sq, H, hd = q.shape
    Skv, Kh, hdv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((B, Sq, H, hdv), dtype=q.dtype, device=q.device)
    if Sq == 0:
        return out
    geo = _geometry(hd, hdv, q.dtype)
    # the span pass's partials: (m, l, acc[hdv]) per (b, h, row, span);
    # rows with one span never touch theirs
    scratch = (torch.empty(B * H * Sq * n_spans(Skv) * (hdv + 2),
                           dtype=torch.float32, device=q.device)
               if geo.span else None)
    lib = build.library("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, B, Sq, Skv, H,
        Kh, hd, hdv, q_offset, int(causal), int(window), scale,
        _DTYPES[q.dtype], geo.span, geo.smem,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    build.launches["flash_attention"] += 1
    return out


def _launch_backward(q, k, v, o, dout, causal, window, scale, q_offset):
    """The backward kernels (csrc/flash_attention_bwd.cu: the row pass,
    the main kernel and dQ's combine) on f32 CUDA inputs: (dq, dk, dv)."""
    B, Sq, H, hd = q.shape
    Skv, Kh, hdv = k.shape[1], k.shape[2], v.shape[-1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if Sq == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # the kernels copy every input row in 16-byte pieces
    q, k, v, o, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                        for t in (q, k, v, o, dout))
    geo = _bwd_geometry(hd, hdv)
    sqp = -(-Sq // BWD_STATS_ROWS) * BWD_STATS_ROWS
    # each row's log-sum-exp and D = dout . o, then dQ's key-tile partials
    scratch = torch.empty(2 * B * H * sqp
                          + B * H * -(-Skv // geo.keys) * Sq * hd,
                          dtype=torch.float32, device=q.device)
    lib = build.library("flash_attention_bwd")
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        scratch.data_ptr(), B, Sq, Skv, H, Kh, hd, hdv, q_offset,
        int(causal), int(window), scale, geo.keys, geo.rows, geo.smem,
        geo.row_smem, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_bwd")
    build.launches["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernels.  It
    saves q, k, v and the output; the backward recomputes each row's
    log-sum-exp from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        o = _launch_forward(q, k, v, causal, window, scale, q_offset)
        ctx.save_for_backward(q, k, v, o)
        ctx.args = (causal, window, scale, q_offset)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = _launch_backward(q, k, v, o, dout.contiguous(),
                                      *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int | None = None):
    """q: (B, Sq, H, hd); k/v: (B, Skv, Kh, hd/hdv). Returns (B, Sq, H, hdv).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    through ``FlashAttentionFn`` where autograd records the call (f32
    only)."""
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    how = build.route(q, "flash attention")
    if how == "plain":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset)
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash attention: q, k and v must share one "
                             "device and dtype")
        if not t.is_contiguous():
            raise ValueError("flash attention: inputs must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if (hd, hdv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"flash attention kernel is built for (hd, hdv) in "
                         f"{HEAD_DIM_PAIRS}, got hd={hd}, hdv={hdv}")
    if H % Kh:
        raise ValueError(f"flash attention: H={H} not a multiple of Kh={Kh}")
    grad = build.needs_grad(q, k, v)
    if grad and q.dtype != torch.float32:
        raise NotImplementedError(
            "flash attention: the backward kernel takes float32 only; "
            "bf16 training is a later item (ROADMAP.md, section 2)")
    if how == "meta":
        return build.meta_outputs(lambda: q.new_empty((B, Sq, H, hdv)),
                                  q, k, v)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash attention: the kernel copies k and v rows in "
                         "16-byte pieces; both must start on a 16-byte "
                         "boundary")
    if (hd, hdv) in SPAN_PAIRS and q.data_ptr() % 16:
        raise ValueError(f"flash attention: at (hd, hdv) = ({hd}, {hdv}) "
                         "the kernel copies q rows in 16-byte pieces too; "
                         "q must start on a 16-byte boundary")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q_offset = (Skv - Sq) if q_offset is None else int(q_offset)
    if grad:
        return FlashAttentionFn.apply(q, k, v, causal, window, scale,
                                      q_offset)
    return _launch_forward(q, k, v, causal, window, scale, q_offset)
