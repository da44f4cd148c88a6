"""The span and cluster kernels' splits, on the CPU: flash's key spans (at
(128, 128), (192, 128) and (256, 256)) and decode's cluster slices (hd
256) as pure-Python plans, and the plain mirrors of each split's partials
and combine held against the plain versions and the Pallas kernels in
interpret mode at 3e-5.  The CUDA kernels that run these plans are tested
in test_torch_cuda.py."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_attention import (
    decode_attention as pl_decode, paged_decode_attention as pl_paged)
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels.decode_attention import (
    CHUNK, CLUSTER, SLICE, chunk_plan, cluster_plan, decode_attention_plain,
    decode_cluster_merge_plain, decode_combine_plain, decode_partials_plain,
    gather_pages, paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (
    SPAN, TILE_Q, flash_attention_plain, flash_combine_plain,
    flash_partials_plain, span_plan)

torch.set_num_threads(2)

ATOL = RTOL = 3e-5
HD = 256
# cache lengths at the cluster slices' and the chunks' edges
SLICE_LENS = [1, SLICE - 1, SLICE, SLICE + 1, CHUNK - 1, CHUNK, CHUNK + 1]


def _close(a, b, err_msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=err_msg)


def _rows_off(a, b):
    """For a failure's message: each (query row, head) of two (B, S, H, hd)
    outputs whose error passes the tolerance, with its largest error, and
    the process's torch settings that could change CPU numerics."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    off = np.abs(a - b) > ATOL + RTOL * np.abs(b)
    err = np.abs(a - b).max(axis=-1)
    rows = [f"(b={i}, row={r}, head={h}): {err[i, r, h]:.3e}"
            for i, r, h in zip(*np.nonzero(off.any(axis=-1)))]
    return (f"{len(rows)} (row, head) pairs off: " + "; ".join(rows[:16])
            + f" | threads={torch.get_num_threads()} "
            f"matmul={torch.get_float32_matmul_precision()} "
            f"capability={torch.backends.cpu.get_cpu_capability()}")


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# flash: spans of absolute key positions
# ---------------------------------------------------------------------------

def _brute_rows(Sq, Skv, causal, window, q_offset):
    """Per row, the spans holding a key it may see, from the mask."""
    mask = fk.attention_mask(Sq, Skv, causal=causal, window=window,
                             q_offset=q_offset, device="cpu")
    return [sorted({int(j) // SPAN for j in torch.nonzero(r).flatten()})
            for r in mask]


@pytest.mark.parametrize("Sq,Skv,window,q_offset", [
    (571, 571, 512, 0), (571, 571, 0, 0),           # gemma3-1b's prefill
    (1, 1, 0, 0), (SPAN, SPAN, 0, 0), (SPAN + 1, SPAN + 1, 0, 0),
    (65, 300, 40, 200), (16, 571, 512, 555),        # a chunk of a prompt
    (100, 100, 8, 0), (3, 40, 0, 37),
])
def test_span_plan_rows_and_ctas(Sq, Skv, window, q_offset):
    """Each row reads exactly the spans holding a key it sees, as one
    contiguous range, and every (tile, span) pair holding such a row's
    span is a live CTA; no live CTA has a tile whose rows all miss it."""
    ns, rows, ctas = span_plan(Sq, Skv, causal=True, window=window,
                               q_offset=q_offset)
    assert ns == max(1, math.ceil(Skv / SPAN))
    brute = _brute_rows(Sq, Skv, True, window, q_offset)
    assert [list(r) for r in rows] == brute
    need = {(i // TILE_Q, s) for i, r in enumerate(rows) for s in r}
    assert need <= set(ctas)
    for qt, s in ctas:          # the tile's key bounds reach the span
        rs = range(qt * TILE_Q, min((qt + 1) * TILE_Q, Sq))
        lo = max(0, q_offset + rs[0] - window + 1) if window else 0
        hi = min(Skv, q_offset + rs[-1] + 1)
        assert max(lo, s * SPAN) < min(hi, (s + 1) * SPAN)


def test_span_plan_does_not_depend_on_the_chunking():
    """A prompt's rows read the same spans in one call and chunk by chunk
    (Sq = chunk, q_offset = c0): span boundaries are absolute positions."""
    Sp = 571
    for window in (0, 512, 8):
        _, whole, _ = span_plan(Sp, Sp, causal=True, window=window,
                                q_offset=0)
        for chunk in (16, 64, 128):
            got = []
            for c0 in range(0, Sp, chunk):
                n = min(chunk, Sp - c0)
                got += span_plan(n, Sp, causal=True, window=window,
                                 q_offset=c0)[1]
            assert got == whole


def test_span_plan_counts_gemma3_prefill():
    """gemma3-1b's 571-token prefill: 5 spans, 9 query tiles, 25 live CTAs
    per head causal (100 on its 4 heads, against 36 one-pass CTAs)."""
    ns, _, ctas = span_plan(571, 571, causal=True, window=0, q_offset=0)
    assert (ns, len(ctas)) == (5, 25)
    assert len({qt for qt, _ in ctas}) == 9


@pytest.mark.parametrize("S,window,q_offset,Skv", [
    (40, 8, None, 40), (40, 0, None, 40),
    (130, 8, None, 130), (130, 0, None, 130),
    (64, 0, 66, 130), (17, 8, 113, 130),            # chunks across a span
])
def test_flash_span_mirror_vs_plain_and_pallas(S, window, q_offset, Skv):
    """The span pass merged in span order equals the one-pass plain
    version and the Pallas kernel (interpret mode) at hd 256, H=4, Kh=1."""
    rng = np.random.default_rng(S + window + Skv)
    q, k, v = (_randn(rng, 1, S, 4, HD), _randn(rng, 1, Skv, 1, HD),
               _randn(rng, 1, Skv, 1, HD))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    m, l, acc = flash_partials_plain(tq, tk, tv, **kw)
    assert m.shape == (1, 4, S, math.ceil(Skv / SPAN))
    out = flash_combine_plain(m, l, acc, Skv=Skv, **kw)
    plain = flash_attention_plain(tq, tk, tv, **kw)
    _close(out, plain, _rows_off(out, plain))
    pallas = pl_flash(*map(jnp.asarray, (q, k, v)), window=window,
                      q_offset=q_offset, block_q=64, block_k=64)
    _close(out, np.asarray(pallas))


@pytest.mark.parametrize("hd,hdv", [(128, 128), (192, 128)])
@pytest.mark.parametrize("S,window,q_offset,Skv,H,Kh", [
    (130, 0, None, 130, 16, 16), (130, 8, None, 130, 32, 8),
    (64, 0, 66, 130, 16, 16),                       # a chunk across a span
    (17, 8, 113, 130, 32, 8),                       # off the tile, windowed
])
def test_flash_span_mirror_narrow_heads(hd, hdv, S, window, q_offset, Skv,
                                        H, Kh):
    """The span pass merged in span order at (128, 128) and (192, 128),
    with deepseek-moe-16b's heads (16 on 16) and jamba-v0.1-52b's (32 on
    8): equal to the one-pass plain version and the Pallas kernel
    (interpret mode)."""
    rng = np.random.default_rng(hd + S + window + H)
    q, k, v = (_randn(rng, 1, S, H, hd), _randn(rng, 1, Skv, Kh, hd),
               _randn(rng, 1, Skv, Kh, hdv))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    m, l, acc = flash_partials_plain(tq, tk, tv, **kw)
    assert acc.shape == (1, H, S, math.ceil(Skv / SPAN), hdv)
    out = flash_combine_plain(m, l, acc, Skv=Skv, **kw)
    _close(out, flash_attention_plain(tq, tk, tv, **kw))
    pallas = pl_flash(*map(jnp.asarray, (q, k, v)), window=window,
                      q_offset=q_offset, block_q=64, block_k=64)
    _close(out, np.asarray(pallas))


@pytest.mark.parametrize("hd,hdv", [(128, 128), (192, 128), (256, 256)])
@pytest.mark.parametrize("window", [0, 40])
def test_flash_partials_chunked_equal_whole(hd, hdv, window):
    """Each row's partials over the spans it reads are the same chunk by
    chunk (Sq = chunk, q_offset = c0) as in one call, and so is a row read
    from one span: the plan depends on absolute positions only."""
    rng = np.random.default_rng(hd + window)
    Sp, H, Kh = 300, 4, 2
    q, k, v = (torch.from_numpy(_randn(rng, 1, Sp, H, hd)),
               torch.from_numpy(_randn(rng, 1, Sp, Kh, hd)),
               torch.from_numpy(_randn(rng, 1, Sp, Kh, hdv)))
    kw = dict(causal=True, window=window)
    m, l, acc = flash_partials_plain(q, k, v, q_offset=0, **kw)
    _, rows, _ = span_plan(Sp, Sp, q_offset=0, **kw)
    for chunk in (16, 64, 128):
        for c0 in range(0, Sp, chunk):
            n = min(chunk, Sp - c0)
            cm, cl, cacc = flash_partials_plain(
                q[:, c0:c0 + n].contiguous(), k, v, q_offset=c0, **kw)
            for i in range(n):
                r = rows[c0 + i]
                sl = slice(r.start, r.stop)
                assert torch.equal(cm[:, :, i, sl], m[:, :, c0 + i, sl])
                assert torch.equal(cl[:, :, i, sl], l[:, :, c0 + i, sl])
                assert torch.equal(cacc[:, :, i, sl],
                                   acc[:, :, c0 + i, sl])
            assert span_plan(n, Sp, q_offset=c0, **kw)[1] == \
                rows[c0:c0 + n]


def test_flash_unread_spans_change_nothing():
    """The combine reads only a row's own spans: garbage (NaN, inf) in the
    others leaves the output's bits as they were."""
    rng = np.random.default_rng(3)
    S = 300
    q, k, v = (torch.from_numpy(_randn(rng, 1, S, 4, HD)),
               torch.from_numpy(_randn(rng, 1, S, 1, HD)),
               torch.from_numpy(_randn(rng, 1, S, 1, HD)))
    kw = dict(causal=True, window=40, q_offset=0)
    m, l, acc = flash_partials_plain(q, k, v, **kw)
    clean = flash_combine_plain(m, l, acc, Skv=S, **kw)
    _, rows, _ = span_plan(S, S, **kw)
    for i, r in enumerate(rows):
        dead = [s for s in range(m.shape[-1]) if s not in r]
        m[:, :, i, dead] = float("nan")
        l[:, :, i, dead] = float("inf")
        acc[:, :, i, dead] = float("nan")
    assert torch.equal(flash_combine_plain(m, l, acc, Skv=S, **kw), clean)


def test_flash_geometry():
    """The launch geometry the C launcher checks: 128-key spans and the
    shared-memory sums of csrc/flash_attention.cu's header at (128, 128),
    (192, 128) and (256, 256); one pass with 64-key tiles below."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert fk._geometry(256, 256, f32) == (32, SPAN, 210_944)
    # bf16 (256, 256): the span plan on wgmma (flash_wgspan_kernel), 1,024
    # to align the tiles, Q's 64 rows and a whole span's K and V, unpadded
    assert fk._geometry(256, 256, bf16) == (64, SPAN, 164_864)
    assert fk._geometry(192, 128, f32) == (32, SPAN, 145_408)
    assert fk._geometry(64, 64, f32) == (64, 0, 4 * (64 * 68 + 128 * 136))
    # bf16 one pass (flash_wgmma_kernel): 1,024 to align the tiles, Q's 64
    # rows and a 3-stage ring of 64-key K and V tiles, unpadded bf16
    assert fk._geometry(64, 64, bf16) == (64, 0, 1024 + 2 * (64 * 64
                                                             + 3 * 64 * 128))
    assert fk._geometry(32, 32, bf16) == (64, 0, 1024 + 2 * (64 * 32
                                                             + 3 * 64 * 64))
    assert fk._geometry(16, 16, bf16) == (64, 0, 1024 + 2 * (64 * 16
                                                             + 3 * 64 * 32))
    assert max(fk._geometry(a, b, t).smem for a, b in fk.HEAD_DIM_PAIRS
               for t in (f32, bf16)) <= 227 * 1024
    assert [fk.n_spans(s) for s in (0, 1, SPAN, SPAN + 1, 571)] == \
        [1, 1, 1, 2, 5]


@pytest.mark.parametrize("hd,hdv,dtype,want", [
    # Q 33,792 + ring 135,168 + P 18,432 + maxima and sums 1,024
    (128, 128, torch.float32, (64, SPAN, 188_416)),
    # bf16 runs in one pass (flash_wgmma_kernel): 1,024 to align the
    # tiles, Q 16,384 and a 3-stage ring of 98,304, no spans
    (128, 128, torch.bfloat16, (64, 0, 115_712)),
    # Q 50,176 + ring (32-key tiles) 83,968 + P 10,240 + 1,024: 64-key f32
    # tiles would need 237,568 B
    (192, 128, torch.float32, (32, SPAN, 145_408)),
    # bf16 runs in one pass (flash_wgmma_kernel): 1,024 to align the
    # tiles, Q 24,576 and a 2-stage ring of 81,920, no spans
    (192, 128, torch.bfloat16, (64, 0, 107_520)),
    (256, 256, torch.float32, (32, SPAN, 210_944)),
    # bf16 runs the span plan on wgmma (flash_wgspan_kernel): 1,024 to
    # align the tiles, Q 32,768 and a span's K and V, 131,072
    (256, 256, torch.bfloat16, (64, SPAN, 164_864)),
])
def test_flash_span_geometry(hd, hdv, dtype, want):
    """The span kernels' ring tile, span and shared memory at each pair
    they take (and at bf16 (128, 128) and (192, 128), which the one-pass
    kernel takes): the sums in csrc/flash_attention.cu's header, within the
    232,448 B a CTA may have."""
    geo = fk._geometry(hd, hdv, dtype)
    assert geo == want
    assert geo.smem <= 227 * 1024
    assert (hd, hdv) in fk.SPAN_PAIRS
    assert fk.is_span(hd, hdv, dtype) == (geo.span == SPAN)


# ---------------------------------------------------------------------------
# decode: each 128-position chunk split across a cluster of CTAs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [64, 512, 1024, 1040])
def test_cluster_plan_slices(cap):
    """Each live chunk holds its live slices of SLICE positions, starting at
    c0 + r * SLICE, at most CLUSTER of them, ragged only at cache_len; they
    tile the chunk plan exactly."""
    lens = SLICE_LENS + [0, 2 * CHUNK + 33, cap, cap + 7]
    plan = cluster_plan(torch.tensor(lens), cap)
    _, chunks = chunk_plan(torch.tensor(lens), cap)
    for n, slot, cs in zip(lens, plan, chunks):
        assert len(slot) == len(cs)
        for slices, (c0, c1) in zip(slot, cs):
            assert 1 <= len(slices) <= CLUSTER
            assert slices[0][0] == c0 and slices[-1][1] == c1
            for r, (s0, s1) in enumerate(slices):
                assert s0 == c0 + r * SLICE and s0 < s1 <= s0 + SLICE
                assert s1 - s0 == SLICE or s1 == min(n, cap)
    assert plan[0] == [[(0, 1)]]
    if cap > CHUNK:
        assert plan[SLICE_LENS.index(CHUNK + 1)] == [
            [(r * SLICE, (r + 1) * SLICE) for r in range(CLUSTER)],
            [(CHUNK, CHUNK + 1)]]


@pytest.mark.parametrize("Smax,lens", [
    (CHUNK + SLICE, SLICE_LENS),
    (512, [512, 0, 257, 511, 95, 300, 1, 64]),
])
def test_cluster_merge_equals_chunk_partials(Smax, lens):
    """The slices' states merged in rank order are the chunk pass's
    partials (m, l, acc) for every live chunk, dead chunks included."""
    rng = np.random.default_rng(Smax)
    B = len(lens)
    q = torch.from_numpy(_randn(rng, B, 4, HD))
    kc, vc = (torch.from_numpy(_randn(rng, B, 1, Smax, HD)) for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32)
    sm, sl, sacc = decode_partials_plain(q, kc, vc, cl, width=SLICE)
    C = -(-Smax // CHUNK)
    assert sm.shape == (B, 1, C * CLUSTER, 4)
    m, l, acc = decode_cluster_merge_plain(sm, sl, sacc, cl, cap=Smax)
    cm, clv, cacc = decode_partials_plain(q, kc, vc, cl)
    n_live = [len(c) for c in chunk_plan(cl, Smax)[1]]
    for b in range(B):
        live = slice(0, n_live[b])
        _close(m[b, :, live], cm[b, :, live])
        _close(l[b, :, live], clv[b, :, live])
        _close(acc[b, :, live], cacc[b, :, live])
        assert bool((m[b, :, n_live[b]:] == dk.NEG_INF).all())
        assert not bool(l[b, :, n_live[b]:].any())


@pytest.mark.parametrize("Smax,lens", [
    (CHUNK + SLICE, SLICE_LENS),
    (CHUNK + SLICE, [CHUNK + SLICE] * 2 + [0, 2]),
    (512, [512, 255, 384, 511, 1, 127, 128, 129]),  # the ring's lengths
])
def test_cluster_split_vs_plain_and_pallas(Smax, lens):
    """Slices merged in rank order, then chunks in chunk order, equal the
    whole-cache plain version and the Pallas decode kernel (interpret
    mode) at hd 256, G = 4."""
    rng = np.random.default_rng(len(lens) + Smax)
    B = len(lens)
    q = _randn(rng, B, 4, HD)
    kc, vc = _randn(rng, B, 1, Smax, HD), _randn(rng, B, 1, Smax, HD)
    cl = np.asarray(lens, np.int32)
    tq, tk, tv, tc = map(torch.from_numpy, (q, kc, vc, cl))
    parts = decode_partials_plain(tq, tk, tv, tc, width=SLICE)
    merged = decode_cluster_merge_plain(*parts, tc, cap=Smax)
    out = decode_combine_plain(*merged, tc, cap=Smax, dtype=tq.dtype)
    _close(out, decode_attention_plain(tq, tk, tv, tc))
    pallas = pl_decode(*map(jnp.asarray, (q, kc, vc, cl)), block_k=32,
                       interpret=True)
    _close(out, np.asarray(pallas))
    assert not bool(out[torch.from_numpy(cl == 0)].any())


def test_cluster_split_paged_vs_pallas():
    """The paged layout goes through the same split: the gathered view's
    slices and chunks equal the Pallas paged kernel at hd 256."""
    rng = np.random.default_rng(17)
    lens, bs, M = [SLICE + 1, CHUNK + 1, 1, 5 * SLICE - 3], 16, 12
    B = len(lens)
    n_blocks = 1 + B * M
    tables = np.zeros((B, M), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks))
    i = 0
    for b, n in enumerate(lens):
        nb = -(-n // bs)
        tables[b, :nb] = perm[i:i + nb]
        i += nb
    q = _randn(rng, B, 4, HD)
    kp, vp = _randn(rng, n_blocks, 1, bs, HD), _randn(rng, n_blocks, 1, bs, HD)
    cl = np.asarray(lens, np.int32)
    tq, tkp, tvp, tt, tc = map(torch.from_numpy, (q, kp, vp, tables, cl))
    kg, vg = gather_pages(tkp, tt), gather_pages(tvp, tt)
    parts = decode_partials_plain(tq, kg, vg, tc, width=SLICE)
    merged = decode_cluster_merge_plain(*parts, tc, cap=M * bs)
    out = decode_combine_plain(*merged, tc, cap=M * bs, dtype=tq.dtype)
    _close(out, paged_decode_attention_plain(tq, tkp, tvp, tt, tc))
    pallas = pl_paged(*map(jnp.asarray, (q, kp, vp, tables, cl)),
                      interpret=True)
    _close(out, np.asarray(pallas))


def test_decode_geometry():
    """The cluster geometry the C launcher checks: wide_smem's sums of
    csrc/decode_attention.cu's header, and the chunks per slot the folded
    combine can hold; one CTA per chunk below hd 256, with the mma core's
    K and V tiles (mma_smem) at G >= 3 and the lane core's (lane_smem: at
    f32 hd 128 CHUNK rows, V into K's after S) at G <= 2."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert dk._geometry(128, f32, 4) == (1, CHUNK, 65_536, 0)
    assert dk._geometry(128, f32, 2) == (1, CHUNK, 65_536, 0)
    assert dk._geometry(64, bf16, 1) == (1, CHUNK, 32_768, 0)
    assert dk._geometry(256, f32, 4) == (CLUSTER, SLICE, 76_336, 2048)
    assert dk._geometry(256, f32, 3) == dk._geometry(256, f32, 4)
    assert dk._geometry(256, bf16, 8) == (CLUSTER, SLICE, 54_352, 512)
    assert max(dk._geometry(256, t, g).smem for t in (f32, bf16)
               for g in range(1, 9)) <= 227 * 1024
    dk._check_chunks(dk._geometry(256, bf16, 8), 512 * CHUNK)
    with pytest.raises(ValueError, match="at most"):
        dk._check_chunks(dk._geometry(256, bf16, 8), 512 * CHUNK + 1)
    dk._check_chunks(dk._geometry(64, bf16, 8), 10 ** 7)
