"""Flash-decode: one query token per slot against a dense or paged KV cache.

Ports ``repro/kernels/decode_attention.py`` (``decode_attention`` and
``paged_decode_attention``, Pallas TPU kernels).  The CUDA kernels are in
``csrc/decode_attention.cu``; its header says what bounds them on an H100
and how the design answers it.

Both functions keep the Pallas signatures and semantics: q ``(B, H, hd)``;
dense caches ``(B, Kh, Smax, hd/hdv)``; pools ``(n_blocks, Kh, block_size,
hd/hdv)`` with ``block_tables (B, M)`` int32 (0 = the null block);
``cache_len`` a scalar or ``(B,)``; f32 online softmax with a finite
``-1e30`` mask; out ``(B, H, hdv)`` in q's dtype.  Positions at or past
``cache_len`` contribute exactly zero, whatever those rows hold.  As the
Pallas kernels widen every block to f32 on read, the cache may be narrower
than the query: q f32 or bf16, the cache f32, bf16 or ``float8_e4m3fn`` (a
plain cast with no scale, as ``PipelinePlan(kv_dtype="fp8")`` writes it).

The kernel splits the logical positions into fixed chunks of ``CHUNK``
(split-KV), writes one partial softmax state per live chunk into an f32
scratch tensor that the wrapper allocates, and merges the live chunks in
chunk order (at hd 256 the CTAs that finish last merge them, in the same
kernel).  ``chunk_plan``, ``decode_partials_plain`` and
``decode_combine_plain`` are the plain versions of that plan, of the chunk
pass and of the combine pass.  At hd 256 each chunk is split further across
a cluster of ``CLUSTER`` CTAs, one fixed slice of ``SLICE`` positions each,
merged in slice order into the chunk's partial: ``cluster_plan``,
``decode_partials_plain(..., width=SLICE)`` and ``decode_cluster_merge_plain``
are its plain versions, and ``_geometry`` the launch geometry that the C
launcher checks.

Decode is never differentiated: on CUDA tensors both wrappers raise where
autograd would record the call (``build.refuse_grad``), since the kernel
has no backward and its output would carry no gradient.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}      # q and the output
# the cache's element types (rt::kDtype* in csrc/common.cuh)
CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1,
                torch.float8_e4m3fn: 2}
HEAD_DIMS = (16, 32, 64, 128, 256)  # instantiated (hd == hdv) in the .cu
MAX_GROUP = 8                      # H / Kh held in registers by the kernel
CHUNK = 128                        # positions per chunk (kChunk, .cu)
WIDE_HD = 256                      # head size split across a cluster
CLUSTER = 4                        # CTAs per chunk at WIDE_HD (kCluster)
SLICE = CHUNK // CLUSTER           # positions per CTA at WIDE_HD (kSlice)
_WARPS = 4                         # kWarps


class Geometry(NamedTuple):
    cluster: int         # CTAs per chunk
    slice: int           # positions per CTA
    smem: int            # dynamic shared memory per CTA, bytes
    max_chunks: int      # chunks per slot the kernel takes (0: any)


def _group_slots(G: int) -> int:
    """Query rows per kv head the kernel is instantiated for (KG)."""
    return next(kg for kg in (1, 2, 4, MAX_GROUP) if G <= kg)


def _geometry(hd: int, dtype: torch.dtype, G: int) -> Geometry:
    """The kernels' launch geometry for a cache of ``dtype``: one CTA per
    chunk below WIDE_HD; at WIDE_HD a cluster of CLUSTER CTAs per chunk with
    ``wide_smem`` bytes of dynamic shared memory (csrc/decode_attention.cu),
    which the launcher refuses to differ."""
    if hd != WIDE_HD:
        return Geometry(1, CHUNK, 0, 0)
    es, kg = dtype.itemsize, _group_slots(G)
    staging = 2 * SLICE * hd * es                          # K, then V rows
    smem = 16 + staging + 4 * (kg * hd + _WARPS * kg * SLICE + kg * SLICE
                               + kg * hd + 2 * kg)
    # the folded combine keeps each chunk's m and l in the staging memory
    return Geometry(CLUSTER, SLICE, smem, staging // (2 * 4 * kg))


def _lengths(cache_len, B: int, device) -> torch.Tensor:
    if isinstance(cache_len, int):
        # filled on the device: a Python int copied there would wait for
        # the stream (cross decode passes cache_len = M in every layer)
        return torch.full((B,), cache_len, dtype=torch.int32, device=device)
    cl = torch.as_tensor(cache_len, device=device)
    return cl.reshape(-1).to(torch.int32).expand(B).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def decode_attention_plain(q, k_cache, v_cache, cache_len, *, scale=None):
    """Masked softmax over the whole cache, in f32, materialized."""
    B, H, hd = q.shape
    Kh, Smax = k_cache.shape[1], k_cache.shape[2]
    hdv = v_cache.shape[-1]
    G = H // Kh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    cl = _lengths(cache_len, B, q.device)
    qf = (q.float() * scale).reshape(B, Kh, G, hd)
    s = torch.einsum("bhgk,bhjk->bhgj", qf, k_cache.float())
    mask = (torch.arange(Smax, device=q.device)[None, :]
            < cl[:, None])[:, None, None, :]                  # (B,1,1,Smax)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    # dead rows may hold anything (NaN included): zero them so 0 * x is 0
    vf = torch.where(mask[:, :, 0, :, None], v_cache.float(),
                     torch.zeros((), device=q.device))
    o = torch.einsum("bhgj,bhjk->bhgk", p, vf) / torch.clamp(l, min=1e-30)
    return o.reshape(B, H, hdv).to(q.dtype)


def n_chunks(cap: int) -> int:
    """The split kernel's grid width for ``cap`` rows per slot."""
    return max(1, -(-int(cap) // CHUNK))


def chunk_plan(cache_len, cap: int):
    """The kernel's split of a cache of ``cap`` rows per slot (Smax dense,
    M * block_size paged): the grid's chunk count, and each slot's live
    chunks as logical ``(start, end)`` positions.  The live chunks depend on
    ``cache_len`` alone, not on ``cap`` or the block size."""
    live = []
    for n in torch.as_tensor(cache_len).reshape(-1).tolist():
        n = min(int(n), int(cap))
        live.append([(s, min(s + CHUNK, n)) for s in range(0, max(n, 0),
                                                            CHUNK)])
    return n_chunks(cap), live


def cluster_plan(cache_len, cap: int):
    """The hd-256 kernel's split of each live chunk across its cluster:
    per slot, per live chunk, the live slices as logical ``(start, end)``
    positions, CTA rank r taking ``[c0 + r * SLICE, c0 + (r + 1) * SLICE)``.
    A slice at or past cache_len is dead (its CTA only merges)."""
    _, live = chunk_plan(cache_len, cap)
    return [[[(s, min(s + SLICE, e)) for s in range(c0, e, SLICE)]
             for c0, e in chunks] for chunks in live]


def decode_partials_plain(q, k_cache, v_cache, cache_len, *, scale=None,
                          width=CHUNK):
    """The chunk pass: per (slot, kv head, chunk, query row) the softmax
    state ``m`` (max score), ``l`` (sum of exp) and ``acc`` (exp-weighted V
    sum) over that chunk's live rows, in f32.  Dead chunks hold
    (-1e30, 0, 0).  Shapes (B, Kh, n_chunks, G) and (..., hdv).  With
    ``width=SLICE`` the same over the cluster's slices: (B, Kh, n_chunks *
    CLUSTER, G), slice r of chunk c at index c * CLUSTER + r."""
    B, H, hd = q.shape
    Kh, Smax = k_cache.shape[1], k_cache.shape[2]
    hdv = v_cache.shape[-1]
    G = H // Kh
    C = n_chunks(Smax)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    cl = _lengths(cache_len, B, q.device)
    qf = (q.float() * scale).reshape(B, Kh, G, hd)
    pos = torch.arange(C * CHUNK, device=q.device)
    live = (pos[None, :] < torch.clamp(cl, max=Smax)[:, None])    # (B, P)
    pad = C * CHUNK - Smax
    kf = torch.nn.functional.pad(k_cache.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, pad))
    mask = live[:, None, None, :]                                  # (B,1,1,P)
    vf = torch.where(mask[:, :, 0, :, None], vf,
                     torch.zeros((), device=q.device))
    s = torch.einsum("bhgk,bhjk->bhgj", qf, kf)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    n = C * CHUNK // width
    s = s.reshape(B, Kh, G, n, width)
    m = s.amax(dim=-1)                                      # (B, Kh, G, n)
    p = torch.where(mask.reshape(B, 1, 1, n, width),
                    torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgcj,bhcjk->bhgck", p,
                       vf.reshape(B, Kh, n, width, hdv))
    return m.transpose(2, 3), l.transpose(2, 3), acc.transpose(2, 3)


def _merge_plain(m, l, acc, live):
    """Merge states along dim 2 where ``live`` (B, n) holds, in index
    order: the max over live states, then the rescaled sums.  States not
    live may hold anything: they are selected out, never multiplied."""
    B, Kh, n, G = m.shape
    mx = torch.full((B, Kh, G), NEG_INF, device=m.device)
    for s in range(n):
        on = live[:, s, None, None]
        mx = torch.where(on, torch.maximum(mx, m[:, :, s]), mx)
    L = torch.zeros((B, Kh, G), device=m.device)
    O = torch.zeros((B, Kh, G, acc.shape[-1]), device=m.device)
    for s in range(n):
        on = live[:, s, None, None]
        c = torch.exp(m[:, :, s] - mx)
        L = torch.where(on, L + l[:, :, s] * c, L)
        O = torch.where(on[..., None], O + acc[:, :, s] * c[..., None], O)
    return mx, L, O


def decode_cluster_merge_plain(m, l, acc, cache_len, *, cap: int):
    """The cluster's merge at hd 256: each chunk's live slices (those
    starting below min(cache_len, cap)) in rank order, into the chunk's
    partial (m, l, acc), as ``decode_partials_plain`` gives it; a dead chunk
    holds (-1e30, 0, 0).  Takes the (B, Kh, n_chunks * CLUSTER, G) slice
    states."""
    B, Kh, n, G = m.shape
    C = n // CLUSTER
    cl = torch.clamp(_lengths(cache_len, B, m.device), max=cap)
    starts = torch.arange(n, device=m.device) * SLICE
    live = (starts[None, :] < cl[:, None]).reshape(B, C, CLUSTER)
    parts = [_merge_plain(*(x[:, :, c * CLUSTER:(c + 1) * CLUSTER]
                            for x in (m, l, acc)), live[:, c])
             for c in range(C)]
    return tuple(torch.stack([p[i] for p in parts], dim=2) for i in range(3))


def decode_combine_plain(m, l, acc, cache_len, *, cap: int, dtype):
    """The combine pass: merge each slot's live chunks (those below
    ceil(min(cache_len, cap) / CHUNK)) in chunk order; chunks past them are
    never read.  Returns (B, H, hdv) in ``dtype``."""
    B, Kh, C, G = m.shape
    hdv = acc.shape[-1]
    cl = torch.clamp(_lengths(cache_len, B, m.device), max=cap)
    n_live = torch.div(cl + CHUNK - 1, CHUNK, rounding_mode="floor")
    live = torch.arange(C, device=m.device)[None, :] < n_live[:, None]
    _, L, O = _merge_plain(m, l, acc, live)    # chunk order, as the kernel
    o = O / torch.clamp(L, min=1e-30)[..., None]
    return o.reshape(B, Kh * G, hdv).to(dtype)


def gather_pages(pool, block_tables):
    """Logical ``(B, Kh, M * bs, hd)`` view of each slot's blocks."""
    B, M = block_tables.shape
    g = pool[block_tables.long()]                             # (B,M,Kh,bs,hd)
    return g.movedim(2, 1).reshape(B, pool.shape[1], M * pool.shape[2],
                                   pool.shape[3])


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, cache_len,
                                 *, scale=None):
    """Gather the logical view, then the dense plain version: for equal live
    rows it gives the dense layout's bits."""
    return decode_attention_plain(q, gather_pages(k_pool, block_tables),
                                  gather_pages(v_pool, block_tables),
                                  cache_len, scale=scale)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check(q, caches, hd, hdv, H, Kh):
    """What the kernel takes, on CUDA and on meta alike: one device,
    contiguous inputs, the (q, cache) dtype pair, the head size and the
    group."""
    cdt = caches[0].dtype
    for t in (q, *caches):
        if t.device != q.device:
            raise ValueError("decode attention: q, k and v must share one "
                             f"device, got {t.device} vs {q.device}")
        if not t.is_contiguous():
            raise ValueError("decode attention: inputs must be contiguous")
    for t in caches:
        if t.dtype != cdt:
            raise ValueError("decode attention: k and v must share one "
                             f"dtype, got {t.dtype} vs {cdt}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode attention kernel takes a float32 or "
                        f"bfloat16 query, got {q.dtype}")
    if cdt not in CACHE_DTYPES:
        raise TypeError(f"decode attention kernel takes a float32, bfloat16 "
                        f"or float8_e4m3fn cache, got {cdt}")
    if hd != hdv or hd not in HEAD_DIMS:
        raise ValueError(f"decode attention kernel is built for hd == hdv "
                         f"in {HEAD_DIMS}, got hd={hd}, hdv={hdv}")
    if H % Kh or H // Kh > MAX_GROUP:
        raise ValueError(f"decode attention kernel needs H % Kh == 0 and "
                         f"H / Kh <= {MAX_GROUP}, got H={H}, Kh={Kh}")


def _check_aligned(caches):
    if any(t.data_ptr() % 16 for t in caches):
        raise ValueError("decode attention: the kernel reads cache rows as "
                         "16-byte vectors; k and v must start on a 16-byte "
                         "boundary")


def _check_chunks(geo: Geometry, cap: int):
    if geo.max_chunks and n_chunks(cap) > geo.max_chunks:
        raise ValueError(f"decode attention kernel at hd {WIDE_HD} takes at "
                         f"most {geo.max_chunks * CHUNK} positions per slot "
                         f"here, got {cap}")


def _scratch(B, H, Kh, cap, hdv, device):
    """The chunk pass's partials: (m, l, acc[hdv]) in f32 per (slot, kv
    head, chunk, query row)."""
    return torch.empty(B * H * n_chunks(cap) * (hdv + 2), dtype=torch.float32,
                       device=device)


_TICKETS: dict = {}


def _tickets(geo: Geometry, n: int, device):
    """The hd-256 kernel's counters, one per (slot, kv head, cluster rank),
    zeroed once per device and left at zero by every launch (None below
    hd 256)."""
    if geo.cluster == 1:
        return None
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _TICKETS[device] = torch.zeros(max(n, 64), dtype=torch.int32,
                                           device=device)
    return t


def _ptr(t):
    return None if t is None else t.data_ptr()


def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None):
    """q: (B, H, hd); caches: (B, Kh, Smax, hd/hdv); cache_len: scalar or
    (B,).  Returns (B, H, hdv)."""
    B, H, hd = q.shape
    Kh, Smax = k_cache.shape[1], k_cache.shape[2]
    hdv = v_cache.shape[-1]
    if k_cache.shape[:3] != v_cache.shape[:3] or k_cache.shape[0] != B \
            or k_cache.shape[3] != hd:
        raise ValueError(f"decode attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    how = build.route(q, "decode attention")
    if how == "plain":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      scale=scale)
    build.refuse_grad("decode_attention", q, k_cache, v_cache)
    _check(q, (k_cache, v_cache), hd, hdv, H, Kh)
    if how == "meta":
        return q.new_empty((B, H, hdv))
    _check_aligned((k_cache, v_cache))
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    cl = _lengths(cache_len, B, q.device)
    out = torch.empty((B, H, hdv), dtype=q.dtype, device=q.device)
    scratch = _scratch(B, H, Kh, Smax, hdv, q.device)
    geo = _geometry(hd, k_cache.dtype, H // Kh)
    _check_chunks(geo, Smax)
    tickets = _tickets(geo, B * Kh * geo.cluster, q.device)
    lib = build.library("decode_attention")
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cl.data_ptr(),
        scratch.data_ptr(), _ptr(tickets), out.data_ptr(), B, H, Kh, Smax,
        hd, hdv, scale,
        _DTYPES[q.dtype], CACHE_DTYPES[k_cache.dtype], geo.cluster, geo.smem,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attention")
    build.launches["decode_attention"] += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, cache_len, *,
                           scale=None):
    """Flash-decode over a paged KV cache.

    q: (B, H, hd); pools: (n_blocks, Kh, block_size, hd/hdv); block_tables:
    (B, M) int32 physical ids (0 = null / unallocated); cache_len: scalar or
    (B,) live token counts.  Returns (B, H, hdv)."""
    B, H, hd = q.shape
    Kh, bs = k_pool.shape[1], k_pool.shape[2]
    hdv = v_pool.shape[-1]
    M = block_tables.shape[1]
    if k_pool.shape[:3] != v_pool.shape[:3] or k_pool.shape[3] != hd \
            or block_tables.shape[0] != B:
        raise ValueError(f"paged decode attention: bad shapes "
                         f"q{tuple(q.shape)} k{tuple(k_pool.shape)} "
                         f"v{tuple(v_pool.shape)} "
                         f"tables{tuple(block_tables.shape)}")
    how = build.route(q, "paged decode attention")
    if how == "plain":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            cache_len, scale=scale)
    build.refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    _check(q, (k_pool, v_pool), hd, hdv, H, Kh)
    if block_tables.dtype != torch.int32 or not block_tables.is_contiguous() \
            or block_tables.device != q.device:
        raise ValueError("paged decode attention: block_tables must be a "
                         "contiguous int32 tensor on q's device")
    if how == "meta":
        return q.new_empty((B, H, hdv))
    _check_aligned((k_pool, v_pool))
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    cl = _lengths(cache_len, B, q.device)
    out = torch.empty((B, H, hdv), dtype=q.dtype, device=q.device)
    scratch = _scratch(B, H, Kh, M * bs, hdv, q.device)
    geo = _geometry(hd, k_pool.dtype, H // Kh)
    _check_chunks(geo, M * bs)
    tickets = _tickets(geo, B * Kh * geo.cluster, q.device)
    lib = build.library("decode_attention")
    err = lib.paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), cl.data_ptr(), scratch.data_ptr(),
        _ptr(tickets), out.data_ptr(), B, H, Kh, bs, M, hd, hdv, scale,
        _DTYPES[q.dtype], CACHE_DTYPES[k_pool.dtype], geo.cluster, geo.smem,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention")
    build.launches["paged_decode_attention"] += 1
    return out
