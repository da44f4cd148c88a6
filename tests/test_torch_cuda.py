"""repro_torch on the card: each CUDA kernel against its plain version, and
the engine's streams across the kernel paths.  Every test here needs a CUDA
device and nvcc and skips without them.  The file imports no JAX, so it
runs on a GPU machine without one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from controller_parity import CASES, run_port
from repro_torch.configs.base import get_arch
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (
    CHUNK, TILE, decode_attention, decode_attention_plain, decode_mma_plain,
    gather_pages, paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (HEAD_DIM_PAIRS,
                                                 flash_attention,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain,
                                                 flash_wgmma_plain)
from repro_torch.kernels.rwkv6_wkv import (_bwd_geometry, _geometry, wkv6,
                                           wkv6_bwd_plain, wkv6_plain)
from repro_torch.models.transformer import init_model
from repro_torch.serving.engine import (EngineConfig, FlexPipeEngine,
                                        KVCacheConfig, PrefillConfig)
from repro_torch.serving.faults import (PREEMPT_STAGE, FaultEvent,
                                        FaultInjector, StageHealthMonitor)
from repro_torch.serving.workload import Request

torch.set_num_threads(2)

TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=5e-3, rtol=5e-3)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# wkv6, times the plain output's mean |y|: f32 as tests/test_kernels.py's
# wkv tolerance; bf16 one ulp (2^-7) of the largest |y|, which stays under
# about 6 mean |y| for these inputs (kernel and plain round y apart)
WKV_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(rng, shape, dt, dev):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dev, DTYPES[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Kh,hd,Smax", [(8, 16, 16, 64, 1024),
                                            (3, 8, 2, 16, 100),
                                            (2, 4, 1, 128, 300)])
def test_cuda_decode_kernels(cuda_dev, dt, B, H, Kh, hd, Smax):
    rng = np.random.default_rng(1)
    q = _rand(rng, (B, H, hd), dt, cuda_dev)
    kc = _rand(rng, (B, Kh, Smax, hd), dt, cuda_dev)
    vc = _rand(rng, (B, Kh, Smax, hd), dt, cuda_dev)
    lens = rng.integers(0, Smax + 1, B).astype(np.int32)
    cl = torch.from_numpy(lens).to(cuda_dev)
    torch.testing.assert_close(decode_attention(q, kc, vc, cl).float(),
                               decode_attention_plain(q, kc, vc, cl).float(),
                               **TOL[dt])
    # pools: each slot's live blocks at shuffled ids, null entries elsewhere
    bs = 16
    M = -(-Smax // bs)
    n_blocks = 1 + B * M
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((B, M), np.int32)
    i = 0
    for b in range(B):
        n = -(-int(lens[b]) // bs)
        tables[b, :n] = perm[i:i + n]
        i += n
    args = (q, _rand(rng, (n_blocks, Kh, bs, hd), dt, cuda_dev),
            _rand(rng, (n_blocks, Kh, bs, hd), dt, cuda_dev),
            torch.from_numpy(tables).to(cuda_dev), cl)
    torch.testing.assert_close(paged_decode_attention(*args).float(),
                               paged_decode_attention_plain(*args).float(),
                               **TOL[dt])


# the caches the decode kernels take beside q's dtype
CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float8_e4m3fn": torch.float8_e4m3fn}


@pytest.mark.cuda
@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cdt", list(CACHE_DTYPES))
@pytest.mark.parametrize("B,H,Kh,hd,Smax", [(8, 16, 16, 64, 1024),
                                            (3, 8, 2, 16, 100),
                                            (4, 64, 8, 128, 520),
                                            (3, 4, 1, 256, 300)])
def test_cuda_decode_dtype_pairs(cuda_dev, qdt, cdt, B, H, Kh, hd, Smax):
    """Every (q, cache) pair of {f32, bf16} x {f32, bf16, fp8}: the dense
    and paged kernels against their plain versions (which widen the cache
    to f32 as the kernels do, so an f32 query holds at 3e-5 whatever the
    cache) and, below hd 256, the tile cores' mirror, paged == the gather
    path == the dense kernel bit for bit, the same bits again, and dead rows
    holding NaN adding nothing; lengths at the chunk and tile edges, G 1, 4
    and 8, hd 16 to 256."""
    rng = np.random.default_rng(hd + H)
    q = _rand(rng, (B, H, hd), qdt, cuda_dev)
    lens = np.array(([0, 1, TILE + 1, CHUNK, CHUNK + 1, TILE, Smax,
                      2 * TILE - 1] * 2)[:B], np.int32)
    cl = torch.from_numpy(np.minimum(lens, Smax)).to(cuda_dev)
    cd = CACHE_DTYPES[cdt]
    kc = _rand(rng, (B, Kh, Smax, hd), "float32", cuda_dev).to(cd)
    vc = _rand(rng, (B, Kh, Smax, hd), "float32", cuda_dev).to(cd)
    kp, vp, bt = _pools(rng, cl.tolist(), Kh, hd, 16, -(-Smax // 16),
                        "float32", cuda_dev)
    _hold_decode(q, kc, vc, cl, kp.to(cd), vp.to(cd), bt, qdt)


@pytest.mark.cuda
def test_cuda_decode_refuses_other_dtypes(cuda_dev):
    """An fp8 query, and k and v in two dtypes, are refused."""
    q = torch.zeros((1, 2, 64), device=cuda_dev)
    kc = torch.zeros((1, 2, 8, 64), device=cuda_dev)
    with pytest.raises(TypeError):
        decode_attention(q.to(torch.float8_e4m3fn), kc, kc, 4)
    with pytest.raises(ValueError):
        decode_attention(q, kc, kc.to(torch.bfloat16), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,H,Kh,hd,causal,window,q_offset", [
    (512, 512, 16, 16, 64, True, 0, None),
    (40, 300, 8, 4, 128, True, 0, 100),
    (96, 96, 4, 1, 32, True, 32, None),
    (33, 190, 2, 2, 16, False, 0, None),
])
def test_cuda_flash_kernel(cuda_dev, dt, Sq, Skv, H, Kh, hd, causal, window,
                           q_offset):
    rng = np.random.default_rng(2)
    q = _rand(rng, (1, Sq, H, hd), dt, cuda_dev)
    k = _rand(rng, (1, Skv, Kh, hd), dt, cuda_dev)
    v = _rand(rng, (1, Skv, Kh, hd), dt, cuda_dev)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    torch.testing.assert_close(flash_attention(q, k, v, **kw).float(),
                               flash_attention_plain(q, k, v, **kw).float(),
                               **TOL[dt])


def _over_bf16_ulp(got, want):
    """Elements of ``got`` beyond one bf16 ulp of ``want`` or 5e-3."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                     - 7)
    return int(((got - want).abs() > ulp.clamp_min(5e-3)).sum())


# the head dims the bf16 kernels on wgmma take (flash_wgmma_kernel; at
# 256 the span design flash_wgspan_kernel); hdv is hd's, or 128 at MLA's
# hd 192
WGMMA_HDS = [16, 32, 64, 128, 192, 256]


def _hdv(hd):
    return 128 if hd == 192 else hd


@pytest.mark.cuda
@pytest.mark.parametrize("hd", WGMMA_HDS)
@pytest.mark.parametrize("B,Sq,Skv,H,Kh,causal,window,q_offset", [
    (1, 512, 512, 16, 16, True, 0, None),
    (2, 130, 130, 4, 4, True, 40, None),
    (1, 70, 200, 8, 2, True, 0, 100),
    (1, 17, 90, 4, 1, False, 0, 0),
    (1, 100, 40, 4, 4, True, 0, -70),
])
def test_cuda_flash_wgmma(cuda_dev, hd, B, Sq, Skv, H, Kh, causal, window,
                          q_offset):
    """The bf16 kernels on wgmma (flash_wgmma_kernel; at (256, 256)
    flash_wgspan_kernel, the span plan's items) within one bf16 ulp or
    5e-3 of the plain version and of their design's mirror
    (flash_wgmma_plain), at Sq and Skv off its tiles, windows, q_offset,
    GQA and rows that see no key, at every pair ((192, 128): three-block
    rows of Q and K, a 2-stage ring with V a tile behind K; (256, 256):
    four-block rows, O in two m64n128 halves, partials merged by the
    combine); two calls give the same bits."""
    rng = np.random.default_rng(hd + Sq + Skv)
    q = _rand(rng, (B, Sq, H, hd), "bfloat16", cuda_dev)
    k = _rand(rng, (B, Skv, Kh, hd), "bfloat16", cuda_dev)
    v = _rand(rng, (B, Skv, Kh, _hdv(hd)), "bfloat16", cuda_dev)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_attention(q, k, v, **kw)
    assert _over_bf16_ulp(got, flash_attention_plain(q, k, v, **kw)) == 0
    assert _over_bf16_ulp(got, flash_wgmma_plain(q, k, v, **kw)) == 0
    assert torch.equal(got, flash_attention(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", WGMMA_HDS)
@pytest.mark.parametrize("window", [0, 100])
def test_cuda_flash_wgmma_chunked(cuda_dev, hd, window):
    """flash_wgmma_kernel (at (256, 256) flash_wgspan_kernel) chunk by
    chunk (16, 64, 128 rows at q_offset c0) equals one call bit for bit:
    its tiles (and spans) are absolute."""
    rng = np.random.default_rng(hd + window)
    Sp, H, Kh = 300, 8, 2
    q = _rand(rng, (1, Sp, H, hd), "bfloat16", cuda_dev)
    k = _rand(rng, (1, Sp, Kh, hd), "bfloat16", cuda_dev)
    v = _rand(rng, (1, Sp, Kh, _hdv(hd)), "bfloat16", cuda_dev)
    whole = flash_attention(q, k, v, q_offset=0, window=window)
    for chunk in (16, 64, 128):
        parts = [flash_attention(q[:, c0:c0 + chunk].contiguous(), k, v,
                                 q_offset=c0, window=window)
                 for c0 in range(0, Sp, chunk)]
        assert torch.equal(torch.cat(parts, 1), whole), chunk


@pytest.mark.cuda
@pytest.mark.parametrize("hd", WGMMA_HDS)
def test_cuda_flash_wgmma_registers_and_occupancy(cuda_dev, hd):
    """flash_wgmma_kernel at each pair (flash_wgspan_kernel at (256,
    256)): no spills in its build log, and the CTAs an SM holds with the
    attributes its launcher sets at least its launch bounds' minimum (3 up
    to hd 64; 2 at (128, 128) and, with its 2-stage ring, at (192, 128); 1
    at (256, 256), whose span of K and V and O of 128 registers a thread
    fill an SM)."""
    lib = build.library("flash_attention")
    kernel = "flash_wgspan_kernel" if hd == 256 else "flash_wgmma_kernel"
    name = f"{kernel}ILi{hd}ELi{_hdv(hd)}E"
    found = {k: r for k, r in build.ptxas_report("flash_attention").items()
             if name in k}
    assert found, f"{name} not in the build log"
    for r in found.values():
        assert not r.get("spill_stores") and not r.get("spill_loads"), r
    assert lib.flash_wgmma_occupancy(hd, _hdv(hd)) >= (
        3 if hd <= 64 else 1 if hd == 256 else 2)


def _hold_decode(q, kc, vc, cl, kp, vp, bt, qdt):
    """Dense and paged decode against their plain versions and, below hd
    256, against the tile cores' mirror (``decode_mma_plain``, the order of
    sums of the lane core at G <= 2 and the mma core above); the paged
    kernel == the gather path == the dense kernel on a cache holding the
    same live rows (and NaN in every dead row: dead rows add exactly 0),
    bit for bit; and a second call of each gives the same bits."""
    dense = decode_attention(q, kc, vc, cl)
    assert dense.dtype == q.dtype
    plain = decode_attention_plain(q, kc, vc, cl).float()
    torch.testing.assert_close(dense.float(), plain, **TOL[qdt])
    if q.shape[-1] < 256:
        torch.testing.assert_close(
            dense.float(), decode_mma_plain(q, kc, vc, cl).float(),
            **TOL[qdt])
    paged = paged_decode_attention(q, kp, vp, bt, cl)
    torch.testing.assert_close(
        paged.float(), paged_decode_attention_plain(q, kp, vp, bt, cl).float(),
        **TOL[qdt])
    kg, vg = gather_pages(kp, bt), gather_pages(vp, bt)
    Smax = kc.shape[2]
    kd = torch.full_like(kc, float("nan"))
    vd = torch.full_like(vc, float("nan"))
    for b, n in enumerate(cl.tolist()):
        n = min(n, Smax)
        kd[b, :, :n] = kg[b, :, :n]
        vd[b, :, :n] = vg[b, :, :n]
    gather = decode_attention(q, kg, vg, cl)
    nan_dead = decode_attention(q, kd, vd, cl)
    assert torch.equal(paged, gather) and torch.equal(paged, nan_dead)
    assert torch.equal(paged_decode_attention(q, kp, vp, bt, cl), paged)
    assert torch.equal(decode_attention(q, kc, vc, cl), dense)
    assert bool(torch.isfinite(dense.float()).all())
    return dense, paged


def _pools(rng, lens, Kh, hd, bs, M, dt, dev):
    """Pools with each slot's live blocks at shuffled ids, one dead block
    after them, and null (0) entries elsewhere."""
    B = len(lens)
    n_blocks = 1 + B * M
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((B, M), np.int32)
    i = 0
    for b in range(B):
        n = min(-(-int(lens[b]) // bs) + 1, M)
        tables[b, :n] = perm[i:i + n]
        i += n
    return (_rand(rng, (n_blocks, Kh, bs, hd), dt, dev),
            _rand(rng, (n_blocks, Kh, bs, hd), dt, dev),
            torch.from_numpy(tables).to(dev))


# cache lengths that straddle the decode kernels' chunk boundaries
BOUNDARY_LENS = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 1, 320]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 2])
def test_cuda_decode_chunk_boundaries(cuda_dev, dt, hd, G):
    """Lengths {0, 1, C-1, C, C+1, 2C+1, Smax} at G 1 and 2 (below hd 256
    the lane core), dense and paged, against the plain versions and, below
    hd 256, the lane core's mirror; paged == gather path == dense bit for
    bit with NaN in the dead rows, and the same bits again."""
    rng = np.random.default_rng(hd + G)
    B, Kh, Smax, bs = len(BOUNDARY_LENS), 4, 320, 16
    q = _rand(rng, (B, Kh * G, hd), dt, cuda_dev)
    kc = _rand(rng, (B, Kh, Smax, hd), dt, cuda_dev)
    vc = _rand(rng, (B, Kh, Smax, hd), dt, cuda_dev)
    cl = torch.tensor(BOUNDARY_LENS, dtype=torch.int32, device=cuda_dev)
    kp, vp, bt = _pools(rng, BOUNDARY_LENS, Kh, hd, bs, Smax // bs, dt,
                        cuda_dev)
    _hold_decode(q, kc, vc, cl, kp, vp, bt, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 2])
def test_cuda_decode_many_chunks(cuda_dev, dt, hd, G):
    """Caches of 40 chunks and of 39 chunks and 5 rows at G 1 and 2, more
    live chunks than the folded combine takes at once, dense and paged,
    held as at the chunk edges."""
    rng = np.random.default_rng(40 * hd + G)
    lens = [40 * CHUNK, 39 * CHUNK + 5]
    B, Kh, Smax, bs = len(lens), 2, 40 * CHUNK, 16
    q = _rand(rng, (B, Kh * G, hd), dt, cuda_dev)
    kc = _rand(rng, (B, Kh, Smax, hd), dt, cuda_dev)
    vc = _rand(rng, (B, Kh, Smax, hd), dt, cuda_dev)
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda_dev)
    kp, vp, bt = _pools(rng, lens, Kh, hd, bs, Smax // bs, dt, cuda_dev)
    _hold_decode(q, kc, vc, cl, kp, vp, bt, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cdt", list(CACHE_DTYPES))
@pytest.mark.parametrize("G", [1, 4, 8, 2])
def test_cuda_decode_paths_bit_identical(cuda_dev, dt, cdt, G):
    """The paged kernel, the gather path (the dense kernel on the gathered
    view, Smax = M * bs) and the dense kernel on a cache of another Smax
    holding the same live rows (NaN in its dead ones) give the same bits,
    and so does a second call; each against the plain version and the mma
    core's mirror, over every (q, cache) pair, lengths at the tile and
    chunk edges."""
    rng = np.random.default_rng(7 + G)
    lens = [1024, 1, 17, CHUNK, 600, 333, 1000, 0, TILE - 1, TILE,
            TILE + 1, 3 * TILE + 1]
    B, Kh, hd, bs, M = len(lens), 4, 64, 16, 65
    H = Kh * G
    cd = CACHE_DTYPES[cdt]
    q = _rand(rng, (B, H, hd), dt, cuda_dev)
    kp, vp, bt = _pools(rng, lens, Kh, hd, bs, M, "float32", cuda_dev)
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda_dev)
    Smax = 1024                      # another width than M * bs = 1040
    kd = _rand(rng, (B, Kh, Smax, hd), "float32", cuda_dev).to(cd)
    vd = _rand(rng, (B, Kh, Smax, hd), "float32", cuda_dev).to(cd)
    _hold_decode(q, kd, vd, cl, kp.to(cd), vp.to(cd), bt, dt)


# Sq off the 64-row tile, with and without q_offset, a window, GQA 2 and 8
FLASH_EDGE_CASES = [  # (Sq, Skv, H, Kh, window, q_offset)
    (1, 1, 4, 4, 0, None), (1, 200, 4, 4, 0, None), (63, 63, 4, 4, 0, None),
    (65, 65, 4, 4, 0, None), (200, 200, 4, 4, 0, None),
    (63, 300, 4, 4, 0, 100), (65, 300, 4, 2, 0, 0), (200, 330, 4, 4, 0, 130),
    (200, 200, 4, 4, 64, None), (65, 300, 4, 4, 40, 200),
    (200, 200, 4, 2, 0, None), (65, 200, 16, 2, 0, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_cuda_flash_tile_edges(cuda_dev, dt, hd):
    rng = np.random.default_rng(hd + 1)
    for Sq, Skv, H, Kh, window, q_offset in FLASH_EDGE_CASES:
        q = _rand(rng, (1, Sq, H, hd), dt, cuda_dev)
        k = _rand(rng, (1, Skv, Kh, hd), dt, cuda_dev)
        v = _rand(rng, (1, Skv, Kh, hd), dt, cuda_dev)
        kw = dict(causal=True, window=window, q_offset=q_offset)
        out = flash_attention(q, k, v, **kw)
        torch.testing.assert_close(
            out.float(), flash_attention_plain(q, k, v, **kw).float(),
            **TOL[dt], msg=lambda m: f"Sq={Sq} Skv={Skv} H={H} Kh={Kh} "
                                     f"window={window} q_offset={q_offset}: "
                                     f"{m}")
        assert torch.equal(flash_attention(q, k, v, **kw), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,hdv,Sq,Skv,H,Kh,window,q_offset", [
    (256, 256, 571, 571, 4, 1, 512, None),    # gemma3-1b, a local layer
    (256, 256, 571, 571, 4, 1, 0, None),      # a global layer
    (256, 256, 65, 300, 8, 2, 40, 200),       # off the tile, GQA 4
    (256, 256, 100, 100, 4, 1, 8, None),      # a window inside a tile
    (192, 128, 512, 512, 16, 16, 0, None),    # MLA prefill
    (192, 128, 63, 200, 4, 2, 0, 137),
])
def test_cuda_flash_wide_heads(cuda_dev, dt, hd, hdv, Sq, Skv, H, Kh, window,
                               q_offset):
    """The head sizes whose tiles differ: hd = hdv = 256 (key tiles of 32 in
    f32, the warp pair splitting the output columns; at bf16
    flash_wgspan_kernel, also within one bf16 ulp of its mirror) and (192,
    128) (at bf16 flash_wgmma_kernel, three-block Q and K rows)."""
    rng = np.random.default_rng(hd + Sq)
    q = _rand(rng, (1, Sq, H, hd), dt, cuda_dev)
    k = _rand(rng, (1, Skv, Kh, hd), dt, cuda_dev)
    v = _rand(rng, (1, Skv, Kh, hdv), dt, cuda_dev)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out = flash_attention(q, k, v, **kw)
    assert out.shape == (1, Sq, H, hdv)
    torch.testing.assert_close(out.float(),
                               flash_attention_plain(q, k, v, **kw).float(),
                               **TOL[dt])
    if dt == "bfloat16":
        assert _over_bf16_ulp(out, flash_attention_plain(q, k, v, **kw)) == 0
        assert _over_bf16_ulp(out, flash_wgmma_plain(q, k, v, **kw)) == 0
    assert torch.equal(flash_attention(q, k, v, **kw), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("Sp", [512, 571])
def test_cuda_flash_chunk_composition_hd256(cuda_dev, dt, window, chunk, Sp):
    """Chunk-by-chunk calls give one call's bits at hd 256 too (f32: the
    span kernel; bf16: flash_wgspan_kernel), with and without a window, at
    a bucket and at gemma3-1b's longest prompt (571, off the 128-key spans
    and the 64-row tiles)."""
    rng = np.random.default_rng(window + chunk + Sp)
    q = _rand(rng, (1, Sp, 4, 256), dt, cuda_dev)
    k = _rand(rng, (1, Sp, 1, 256), dt, cuda_dev)
    v = _rand(rng, (1, Sp, 1, 256), dt, cuda_dev)
    whole = flash_attention(q, k, v, causal=True, window=window, q_offset=0)
    parts = [flash_attention(q[:, c0:c0 + chunk].contiguous(), k, v,
                             causal=True, window=window, q_offset=c0)
             for c0 in range(0, Sp, chunk)]
    assert torch.equal(torch.cat(parts, 1), whole)


# (Sq, Skv, H, Kh, window, q_offset) across the 128-key spans' edges and
# off the 64-row query tiles
FLASH_SPAN_CASES = [
    (127, 127, 4, 1, 0, None), (128, 128, 4, 1, 0, None),
    (129, 129, 4, 1, 0, None), (65, 257, 4, 1, 0, 192),
    (63, 256, 4, 1, 0, 193), (129, 384, 8, 2, 100, 255),
    (1, 129, 4, 1, 0, None), (200, 200, 4, 1, 128, None),
    (300, 300, 4, 1, 129, None), (64, 640, 4, 4, 0, 300),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cuda_flash_span_edges_hd256(cuda_dev, dt):
    """The hd-256 span kernels (f32 flash_span_kernel, bf16
    flash_wgspan_kernel) across span edges (a window one key past a span,
    rows whose spans start mid-span), off the query tile, and with GQA 1, 4
    and 8: against the plain version (and at bf16 within one bf16 ulp of it
    and of the mirror), and the same bits again."""
    rng = np.random.default_rng(128)
    for Sq, Skv, H, Kh, window, q_offset in FLASH_SPAN_CASES:
        q = _rand(rng, (1, Sq, H, 256), dt, cuda_dev)
        k = _rand(rng, (1, Skv, Kh, 256), dt, cuda_dev)
        v = _rand(rng, (1, Skv, Kh, 256), dt, cuda_dev)
        kw = dict(causal=True, window=window, q_offset=q_offset)
        out = flash_attention(q, k, v, **kw)
        torch.testing.assert_close(
            out.float(), flash_attention_plain(q, k, v, **kw).float(),
            **TOL[dt], msg=lambda m: f"Sq={Sq} Skv={Skv} H={H} Kh={Kh} "
                                     f"window={window} q_offset={q_offset}: "
                                     f"{m}")
        if dt == "bfloat16":
            assert _over_bf16_ulp(out, flash_attention_plain(q, k, v,
                                                             **kw)) == 0
            assert _over_bf16_ulp(out, flash_wgmma_plain(q, k, v, **kw)) == 0
        assert torch.equal(flash_attention(q, k, v, **kw), out)


# (Sq, Skv, H, Kh, window, q_offset) for the span kernel at (128, 128) and
# (192, 128): the model shapes, GQA 4, a window inside a span and one key
# past it, chunks across span edges and off the 64-row tile; rows that see
# no key (a window past the last key; q_offset < 0, END-aligned Sq > Skv),
# whole tiles of them too; and more query tiles (257) than a CTA has
# threads, which the item search takes in two steps
FLASH_SPAN_NARROW_CASES = [
    (512, 512, 16, 16, 0, None), (571, 571, 32, 8, 0, None),
    (128, 512, 16, 16, 0, 384), (65, 257, 8, 2, 0, 192),
    (129, 384, 8, 2, 100, 255), (200, 200, 4, 1, 129, None),
    (1, 129, 4, 1, 0, None), (64, 640, 4, 4, 0, 300),
    (130, 160, 4, 1, 32, 100), (300, 140, 4, 2, 0, None),
    (16400, 200, 1, 1, 0, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,hdv", [(128, 128), (192, 128)])
def test_cuda_flash_span_kernel_narrow(cuda_dev, dt, hd, hdv):
    """The span kernel at (128, 128) and (192, 128) across span edges, with
    windows, q_offset, GQA and Sq off the query tile: against the plain
    version, and the same bits again (at bf16 both pairs run the one-pass
    flash_wgmma_kernel, held here at the same cases)."""
    rng = np.random.default_rng(hd + hdv)
    for Sq, Skv, H, Kh, window, q_offset in FLASH_SPAN_NARROW_CASES:
        q = _rand(rng, (1, Sq, H, hd), dt, cuda_dev)
        k = _rand(rng, (1, Skv, Kh, hd), dt, cuda_dev)
        v = _rand(rng, (1, Skv, Kh, hdv), dt, cuda_dev)
        kw = dict(causal=True, window=window, q_offset=q_offset)
        out = flash_attention(q, k, v, **kw)
        torch.testing.assert_close(
            out.float(), flash_attention_plain(q, k, v, **kw).float(),
            **TOL[dt], msg=lambda m: f"Sq={Sq} Skv={Skv} H={H} Kh={Kh} "
                                     f"window={window} q_offset={q_offset}: "
                                     f"{m}")
        assert torch.equal(flash_attention(q, k, v, **kw), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,hdv", [(128, 128), (192, 128)])
@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("Sp,H,Kh,window", [(512, 16, 16, 0),
                                            (571, 32, 8, 0),
                                            (300, 4, 1, 128)])
def test_cuda_flash_chunk_composition_narrow(cuda_dev, dt, hd, hdv, chunk,
                                             Sp, H, Kh, window):
    """Chunk-by-chunk calls give one call's bits in the span kernel at
    (128, 128) and (192, 128) (flash_wgmma_kernel at bf16):
    deepseek-moe-16b's bucket, jamba-v0.1-52b's heads at a prompt off the
    spans and tiles, and a window."""
    rng = np.random.default_rng(hd + chunk + Sp)
    q = _rand(rng, (1, Sp, H, hd), dt, cuda_dev)
    k = _rand(rng, (1, Sp, Kh, hd), dt, cuda_dev)
    v = _rand(rng, (1, Sp, Kh, hdv), dt, cuda_dev)
    whole = flash_attention(q, k, v, causal=True, window=window, q_offset=0)
    parts = [flash_attention(q[:, c0:c0 + chunk].contiguous(), k, v,
                             causal=True, window=window, q_offset=c0)
             for c0 in range(0, Sp, chunk)]
    assert torch.equal(torch.cat(parts, 1), whole)


# cache lengths at the hd-256 cluster's slice edges and the chunks' edges
SLICE_EDGE_LENS = [1, 31, 32, 33, 127, 128, 129, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_cuda_decode_slice_edges_hd256(cuda_dev, dt, G):
    """hd 256 with cache_len at the cluster slices' edges (1, 31, 32, 33,
    127, 128, 129, Smax): dense and paged against the plain versions, paged
    == gather == dense bit for bit, and the same bits again on a second
    call (the folded combine's counters start each call at zero)."""
    rng = np.random.default_rng(31 + G)
    lens, bs, Smax = SLICE_EDGE_LENS, 16, 512
    B, Kh = len(lens), 1
    q = _rand(rng, (B, Kh * G, 256), dt, cuda_dev)
    kc = _rand(rng, (B, Kh, Smax, 256), dt, cuda_dev)
    vc = _rand(rng, (B, Kh, Smax, 256), dt, cuda_dev)
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda_dev)
    dense = decode_attention(q, kc, vc, cl)
    torch.testing.assert_close(dense.float(), decode_attention_plain(
        q, kc, vc, cl).float(), **TOL[dt])
    kp, vp, bt = _pools(rng, lens, Kh, 256, bs, Smax // bs + 1, dt, cuda_dev)
    paged = paged_decode_attention(q, kp, vp, bt, cl)
    torch.testing.assert_close(paged.float(), paged_decode_attention_plain(
        q, kp, vp, bt, cl).float(), **TOL[dt])
    kg, vg = gather_pages(kp, bt), gather_pages(vp, bt)
    for b, n in enumerate(lens):
        kc[b, :, :n] = kg[b, :, :n]
        vc[b, :, :n] = vg[b, :, :n]
    assert torch.equal(decode_attention(q, kg, vg, cl), paged)
    assert torch.equal(decode_attention(q, kc, vc, cl), paged)
    for _ in range(2):
        assert torch.equal(paged_decode_attention(q, kp, vp, bt, cl), paged)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cuda_decode_hd256_calls_in_turn(cuda_dev, dt):
    """Calls of other shapes and lengths in between (empty slots, one slot,
    a cache of 40 chunks) leave a call's bits as they were, and an empty
    slot's output is zero."""
    rng = np.random.default_rng(5)
    q = _rand(rng, (8, 4, 256), dt, cuda_dev)
    kc = _rand(rng, (8, 1, 1024, 256), dt, cuda_dev)
    vc = _rand(rng, (8, 1, 1024, 256), dt, cuda_dev)
    cl = torch.tensor([1024, 0, 17, 512, 600, 0, 1000, 64], dtype=torch.int32,
                      device=cuda_dev)
    first = decode_attention(q, kc, vc, cl)
    assert not bool(first[cl == 0].any())
    long_k = _rand(rng, (2, 2, 40 * CHUNK, 256), dt, cuda_dev)
    long_q = _rand(rng, (2, 8, 256), dt, cuda_dev)
    long_cl = torch.tensor([40 * CHUNK, 39 * CHUNK + 5], dtype=torch.int32,
                           device=cuda_dev)
    for _ in range(3):
        decode_attention(q[:1], kc[:1], vc[:1], cl[:1])
        decode_attention(q, kc, vc, torch.zeros_like(cl))
        out = decode_attention(long_q, long_k, long_k, long_cl)
        assert torch.equal(decode_attention(q, kc, vc, cl), first)
    torch.testing.assert_close(out.float(), decode_attention_plain(
        long_q, long_k, long_k, long_cl).float(), **TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cuda_decode_paths_bit_identical_hd256(cuda_dev, dt):
    """gemma3's decode shape (hd 256, G = 4, one kv head): paged kernel ==
    gather path == dense kernel bit for bit, and each against the plain
    version, at ring and global lengths."""
    rng = np.random.default_rng(256)
    lens = [1, 127, 128, 129, 512, 300, 1024, 0]
    B, Kh, G, hd, bs, M = len(lens), 1, 4, 256, 16, 64
    q = _rand(rng, (B, Kh * G, hd), dt, cuda_dev)
    kp, vp, bt = _pools(rng, lens, Kh, hd, bs, M, dt, cuda_dev)
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda_dev)
    paged = paged_decode_attention(q, kp, vp, bt, cl)
    gather = decode_attention(q, gather_pages(kp, bt), gather_pages(vp, bt),
                              cl)
    assert torch.equal(paged, gather)
    assert torch.equal(paged_decode_attention(q, kp, vp, bt, cl), paged)
    torch.testing.assert_close(
        paged.float(), paged_decode_attention_plain(q, kp, vp, bt, cl).float(),
        **TOL[dt])
    ring = _rand(rng, (B, Kh, 512, hd), dt, cuda_dev)
    ring_cl = torch.clamp(cl, max=512)          # a wrapped ring reads it all
    torch.testing.assert_close(
        decode_attention(q, ring, ring, ring_cl).float(),
        decode_attention_plain(q, ring, ring, ring_cl).float(), **TOL[dt])


@pytest.mark.cuda
def test_cuda_gemma3_engine(cuda_dev):
    """gemma3's smoke config on the card: ring caches wrap and roll, slots
    are reused, and a refactored run gives the unrefactored run's streams,
    through the flash and decode kernels."""
    cfg = get_arch("gemma3-1b").smoke_config
    params = init_model(cfg, torch.Generator().manual_seed(0),
                        device=cuda_dev)
    streams = []
    for moves in ({}, {3: [0, 4, 7, 10], 12: [0, 7]}):
        eng = FlexPipeEngine(cfg, params, [0, 7],
                             EngineConfig(max_batch=2, max_seq=32,
                                          warm_profiles=(2, 4)))
        reqs = [Request(rid=i, arrival=0.0, prompt_len=n, max_new_tokens=9)
                for i, n in enumerate((20, 11, 5, 8, 11, 5))]
        for r in reqs:
            eng.submit(r, now=0.0)
        build.reset_launches()
        for t in range(40):
            if t in moves:
                ev = eng.refactor(moves[t])
                assert ev["compile_cache_hit"] and ev["new_traces"] == 0
            eng.step(t * 0.05)
        assert all(r.output is not None and len(r.output) == 9 for r in reqs)
        assert build.launches["decode_attention"] > 0
        assert build.launches["flash_attention"] == 13 * len(reqs)
        streams.append([r.output for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.cuda
def test_cuda_engine_paths_agree(cuda_dev):
    """Smoke size on the card: dense, paged-gather and paged-kernel engines
    give the same greedy streams across a refactor, through the kernels."""
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    params = init_model(cfg, torch.Generator().manual_seed(0),
                        device=cuda_dev)
    streams = []
    for kv in (KVCacheConfig(), KVCacheConfig(paged=True, block_size=8),
               KVCacheConfig(paged=True, block_size=8, paged_kernel=True)):
        eng = FlexPipeEngine(cfg, params, [0, 2],
                             EngineConfig(max_batch=4, max_seq=64, kv=kv,
                                          warm_profiles=(4,)))
        reqs = [Request(rid=i, arrival=0.0, prompt_len=5 + 7 * i,
                        max_new_tokens=12) for i in range(6)]
        for r in reqs:
            eng.submit(r, now=0.0)
        build.reset_launches()
        for t in range(60):
            if t == 5:
                eng.refactor([0, 1, 2, 3])
            eng.step(t * 0.05)
        assert all(r.output is not None and len(r.output) == 12
                   for r in reqs)
        want = ("paged_decode_attention" if kv.paged_kernel
                else "decode_attention")
        assert build.launches[want] > 0 and build.launches["flash_attention"]
        streams.append([r.output for r in reqs])
    assert streams[0] == streams[1] == streams[2]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sp", [128, 512])
@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_cuda_flash_chunk_composition_exact(cuda_dev, dt, Sp, chunk):
    """Chunked prefill's invariant: a prompt's rows computed chunk by chunk
    (Sq = chunk, q_offset = c0, Skv = Sp) equal one whole call bit for bit;
    chunk 16 sits off the kernel's 64-row tile."""
    rng = np.random.default_rng(Sp + chunk)
    q = _rand(rng, (1, Sp, 16, 64), dt, cuda_dev)
    k = _rand(rng, (1, Sp, 16, 64), dt, cuda_dev)
    v = _rand(rng, (1, Sp, 16, 64), dt, cuda_dev)
    whole = flash_attention(q, k, v, causal=True, q_offset=0)
    parts = [flash_attention(q[:, c0:c0 + chunk].contiguous(), k, v,
                             causal=True, q_offset=c0)
             for c0 in range(0, Sp, chunk)]
    assert torch.equal(torch.cat(parts, 1), whole)


def _smoke_engine(dev, **kw):
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    params = init_model(cfg, torch.Generator().manual_seed(0), device=dev)
    return FlexPipeEngine(cfg, params, [0, 2], EngineConfig(
        max_batch=4, max_seq=64, **kw), device=dev)


@pytest.mark.cuda
def test_cuda_chunked_engine_dense_equals_paged_kernel(cuda_dev):
    """Chunked prefill on the card: dense and paged-kernel engines give the
    same streams, every chunk through the flash kernel (24 x chunks)."""
    streams = []
    for kv in (KVCacheConfig(),
               KVCacheConfig(paged=True, block_size=8, paged_kernel=True)):
        eng = _smoke_engine(cuda_dev, kv=kv, prefill=PrefillConfig(chunk=16))
        reqs = [Request(rid=i, arrival=0.0, prompt_len=(48, 9, 33)[i % 3],
                        max_new_tokens=10) for i in range(4)]
        build.reset_launches()
        eng.run(reqs)
        n = eng.stats.counters["prefill_chunks"]
        assert n >= 6
        assert build.launches["flash_attention"] == eng.cfg.n_layers * n
        streams.append([r.output for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.cuda
def test_cuda_emergency_recovery_covered_slots_exact(cuda_dev):
    """A stage preempted three ticks after a snapshot: the snapshot restores
    the committed rows and the replay rebuilds the rest by decode, as they
    were made, so the streams equal a fault-free run's; the refactor onto
    the surviving stage is warm."""
    def run(fault):
        eng = _smoke_engine(cuda_dev, warm_profiles=(1, 2),
                            snapshot_interval=4)
        reqs = [Request(rid=i, arrival=0.0, prompt_len=12 + i,
                        max_new_tokens=20) for i in range(3)]
        if fault:
            eng.attach_faults(injector=FaultInjector.scripted(
                [FaultEvent(t=0.525, kind=PREEMPT_STAGE, stage=1)]),
                monitor=StageHealthMonitor())
        eng.run(reqs, time_per_tick=0.05)
        return [r.output for r in reqs], eng

    clean, _ = run(False)
    got, eng = run(True)
    rec = eng.recovery_events[0]
    assert rec["compile_cache_hit"] and rec["new_traces"] == 0
    assert 0 < rec["replayed_ticks"] <= 4
    assert all(v >= plen for v, _, plen in rec["replay_spans"].values())
    assert got == clean


def _wkv_inputs(rng, B, S, H, hd, dt, dev, with_state=True):
    r, k, v = (_rand(rng, (B, S, H, hd), dt, dev) * 0.5 for _ in range(3))
    w = torch.sigmoid(_rand(rng, (B, S, H, hd), "float32", dev)) * 0.5 + 0.45
    u = _rand(rng, (H, hd), "float32", dev) * 0.1
    st0 = (_rand(rng, (B, H, hd, hd), "float32", dev) if with_state
           else None)
    return r, k, v, w.to(DTYPES[dt]), u, st0


def _tile(hd):
    return _geometry(hd, torch.float32, 1 << 20).tile


# B=1, H=32 at the time tile's edges (TT - 1, TT, TT + 1 steps) and at
# 600 steps, for the two head sizes the serving shapes do not reach
WKV_TILE_EDGES = [(1, S, 32, hd, True) for hd in (16, 128)
                  for S in (1, _tile(hd) - 1, _tile(hd), _tile(hd) + 1, 600)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,hd,with_state", [
    (1, 512, 32, 64, False), (1, 300, 4, 64, True), (8, 1, 32, 64, True),
    (3, 40, 4, 16, True), (2, 17, 2, 16, False),
] + WKV_TILE_EDGES)
def test_cuda_wkv6_kernel(cuda_dev, dt, B, S, H, hd, with_state):
    """The kernel against its plain version on the same card, tolerance
    relative to the plain output's mean |y| (y grows with the state)."""
    rng = np.random.default_rng(3)
    r, k, v, w, u, st0 = _wkv_inputs(rng, B, S, H, hd, dt, cuda_dev,
                                     with_state)
    first = st0.clone() if with_state else None
    y_ref, st_ref = wkv6_plain(r, k, v, w, u, st0)
    y, st = wkv6(r, k, v, w, u, st0)
    assert y.dtype == r.dtype and st.dtype == torch.float32
    assert st0 is None or st is st0           # the state updated in place
    torch.testing.assert_close(
        y.float(), y_ref.float(), rtol=0,
        atol=WKV_TOL[dt] * float(y_ref.float().abs().mean()))
    # the state is f32 in both dtypes, from the same rounded inputs
    torch.testing.assert_close(
        st, st_ref, rtol=0,
        atol=WKV_TOL["float32"] * float(st_ref.abs().mean()))
    y2, st2 = wkv6(r, k, v, w, u, first)  # run to run: the same bits
    assert torch.equal(st2, st) and torch.equal(y2, y)


# (S, cut points): a split inside a time tile, a split at a multiple of it
# (8 TT), a prefill followed by single-step decode calls, and 8 chained
# single steps against one 8-step call
WKV_SPLITS = [(512, [200]), (512, [8 * _tile(64)]),
              (512, list(range(505, 512))), (8, list(range(1, 8)))]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,cuts", WKV_SPLITS)
def test_cuda_wkv6_composition_exact(cuda_dev, dt, S, cuts):
    """A sequence cut into chained calls, each resuming from the state the
    last one left, gives the bits of one whole call: y and the state."""
    rng = np.random.default_rng(4)
    r, k, v, w, u, st0 = _wkv_inputs(rng, 1, S, 32, 64, dt, cuda_dev)
    y_whole, st_whole = wkv6(r, k, v, w, u, st0.clone())
    st, ys = st0, []
    for a, b in zip([0] + cuts, cuts + [S]):
        y, st = wkv6(*(x[:, a:b].contiguous() for x in (r, k, v, w)), u, st)
        ys.append(y)
    assert torch.equal(torch.cat(ys, 1), y_whole)
    assert torch.equal(st, st_whole)


@pytest.mark.cuda
def test_cuda_rwkv_engine_paths_agree(cuda_dev):
    """Smoke-size rwkv6 on the card: run() and a refactored fused engine,
    more requests than slots, give the same greedy streams through wkv6."""
    cfg = get_arch("rwkv6-1.6b").smoke_config
    params = init_model(cfg, torch.Generator().manual_seed(0),
                        device=cuda_dev)
    streams = []
    for refactor in (False, True):
        eng = FlexPipeEngine(cfg, params, [0, 2],
                             EngineConfig(max_batch=2, max_seq=64,
                                          warm_profiles=(4,)))
        reqs = [Request(rid=i, arrival=0.0, prompt_len=5 + 7 * i,
                        max_new_tokens=8) for i in range(5)]
        build.reset_launches()
        if refactor:
            for r in reqs:
                eng.submit(r, now=0.0)
            for t in range(80):
                if t == 5:
                    assert eng.refactor([0, 1, 2, 3])["compile_cache_hit"]
                eng.step(t * 0.05)
        else:
            eng.run(reqs)
        assert all(r.output is not None and len(r.output) == 8 for r in reqs)
        assert build.launches["wkv6"] > 0
        streams.append([r.output for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["qwen dense", "qwen paged kernel",
                                  "rwkv6 dense"],
                         ids=["dense", "paged-kernel", "rwkv6"])
def test_cuda_controller_run(cuda_dev, case):
    """Smoke-size models under FlexPipeController on the quickstart's
    setup, on the card: the control steps and refactors equal the CPU
    run's, every refactor is warm, and the streams equal a run on the card
    with no controller."""
    cfg = get_arch(CASES[case][0]).smoke_config
    cpu = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = init_model(cfg, torch.Generator().manual_seed(0), device=cuda_dev)
    want, _ = run_port(case, cpu, "cpu")
    got, _ = run_port(case, card, cuda_dev)
    base, _ = run_port(case, card, cuda_dev, controller=False)
    assert got["steps"] == want["steps"] and got["events"] == want["events"]
    assert len(got["events"]) >= 1 and base["events"] == []
    assert all(ev["compile_cache_hit"] and ev["new_traces"] == 0
               for ev in got["events"])
    assert got["bucketed"] == (case != "rwkv6 dense")
    if got["bucketed"]:
        assert got["builds_after_warmup"] == 0
    assert got["completed"] == got["n"] == 81
    assert got["streams"] == base["streams"]
    kernels = {"qwen dense": ("flash_attention", "decode_attention"),
               "qwen paged kernel": ("flash_attention",
                                     "paged_decode_attention"),
               "rwkv6 dense": ("wkv6",)}[case]
    assert all(got["launches"].get(k, 0) > 0 for k in kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cdt", list(CACHE_DTYPES))
@pytest.mark.parametrize("H,Kh", [(16, 16), (32, 8)],
                         ids=["deepseek-moe", "jamba"])
def test_cuda_hd128_decode_at_model_heads(cuda_dev, dt, cdt, H, Kh):
    """Decode at hd 128 with deepseek-moe-16b's 16 heads and
    jamba-v0.1-52b's 32 on 8 kv heads (G = 4, the mma core), at batch 8
    and 1024 rows (8 chunks), block 16, over every (q, cache) pair: dense
    and paged kernels against their plain versions and the mma core's
    mirror, the paged kernel == gather path == dense kernel bit for bit on
    equal live rows (NaN in the dead ones), and the same bits again;
    lengths at the tile and chunk edges."""
    rng = np.random.default_rng(H)
    B, hd, Smax, bs = 10, 128, 1024, 16
    lens = np.array([1024, 1, 17, 512, 600, 333, 1000, 64, TILE + 1,
                     3 * TILE - 1], np.int32)
    lens = np.minimum(lens, Smax - bs)
    cd = CACHE_DTYPES[cdt]
    q = _rand(rng, (B, H, hd), dt, cuda_dev)
    kc = _rand(rng, (B, Kh, Smax, hd), "float32", cuda_dev).to(cd)
    vc = _rand(rng, (B, Kh, Smax, hd), "float32", cuda_dev).to(cd)
    cl = torch.from_numpy(lens).to(cuda_dev)
    kp, vp, bt = _pools(rng, lens, Kh, hd, bs, Smax // bs, "float32",
                        cuda_dev)
    _hold_decode(q, kc, vc, cl, kp.to(cd), vp.to(cd), bt, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,Kh", [(512, 16, 16), (571, 32, 8)],
                         ids=["deepseek-moe", "jamba"])
def test_cuda_hd128_flash_at_model_heads(cuda_dev, dt, S, H, Kh):
    """Causal flash at hd 128 with each model's heads: a bucketed
    deepseek-moe-16b prompt and an exact-length jamba-v0.1-52b one (off the
    64-row tile), against the plain version."""
    rng = np.random.default_rng(S)
    q = _rand(rng, (1, S, H, 128), dt, cuda_dev)
    k = _rand(rng, (1, S, Kh, 128), dt, cuda_dev)
    v = _rand(rng, (1, S, Kh, 128), dt, cuda_dev)
    kw = dict(causal=True, window=0, q_offset=0)
    torch.testing.assert_close(flash_attention(q, k, v, **kw).float(),
                               flash_attention_plain(q, k, v, **kw).float(),
                               **TOL[dt])


def _moe_streams(arch, cf, kv, device, params):
    cfg = get_arch(arch).smoke_config
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    half = cfg.n_layers // 2
    eng = FlexPipeEngine(cfg, params, [0, half],
                         EngineConfig(max_batch=4, max_seq=128, kv=kv,
                                      warm_profiles=(4,)), device=device)
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(6):
        r = Request(rid=i, arrival=0.0, prompt_len=int(rng.integers(40, 62)),
                    max_new_tokens=8)
        r.prompt_tokens = rng.integers(0, cfg.vocab_size, r.prompt_len)
        reqs.append(r)
    for r in reqs:
        eng.submit(r, now=0.0)
    build.reset_launches()
    for t in range(200):
        if t == 5:
            q = [0] + [half * j // 2 for j in (1, 2, 3)]
            assert eng.refactor(q)["compile_cache_hit"]
        eng.step(t * 0.05)
        if not eng.queue and all(s.done for s in eng.slots):
            break
    assert all(r.output is not None and len(r.output) == 8 for r in reqs)
    return [r.output for r in reqs], dict(build.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,cf,paged", [
    ("deepseek-moe-16b", 4.0, False), ("deepseek-moe-16b", 4.0, True),
    ("deepseek-moe-16b", 0.5, False), ("deepseek-moe-16b", 0.5, True),
    ("jamba-v0.1-52b", 4.0, False), ("jamba-v0.1-52b", 0.5, False)])
def test_cuda_moe_and_mamba_engines_equal_cpu(cuda_dev, arch, cf, paged):
    """The two models' smoke configs on the card, refactored mid-stream
    (dense, or paged through the paged kernel) give the CPU run's streams,
    at the smoke's capacity factor and at 0.5, where drops and the idle
    slots' rows decide routing."""
    cfg = get_arch(arch).smoke_config
    cpu = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree_from_numpy(tree_to_numpy(cpu), cuda_dev)
    kv = (KVCacheConfig(paged=True, block_size=8, paged_kernel=True)
          if paged else KVCacheConfig())
    want, _ = _moe_streams(arch, cf, kv, "cpu", cpu)
    got, launches = _moe_streams(arch, cf, kv, cuda_dev, card)
    assert got == want
    dec = "paged_decode_attention" if paged else "decode_attention"
    assert launches.get(dec, 0) > 0 and launches.get("flash_attention", 0) > 0


# the shapes cross attention and whisper's encoder give the flash kernel:
# vision's cross prefill (32 heads on 8, hd 128, 1601 memory keys: 13
# spans, every row reading every one) at buckets and lengths off the query
# tile, whisper's encoder (6 heads of 64 over 1500 frames) and its decoder's
# cross prefill at the 1024 bucket
CROSS_FLASH_CASES = [  # (B, Sq, Skv, H, Kh, hd)
    (1, 1, 1601, 32, 8, 128), (1, 24, 1601, 32, 8, 128),
    (1, 63, 1601, 32, 8, 128), (1, 64, 1601, 32, 8, 128),
    (1, 65, 1601, 32, 8, 128), (1, 600, 1601, 32, 8, 128),
    (1, 1024, 1601, 32, 8, 128),
    (1, 1500, 1500, 6, 6, 64), (2, 1500, 1500, 6, 6, 64),
    (1, 1024, 1500, 6, 6, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Kh,hd", CROSS_FLASH_CASES)
def test_cuda_flash_non_causal_served_shapes(cuda_dev, dt, B, Sq, Skv, H, Kh,
                                             hd):
    """Non-causal flash at the cross and encoder shapes against the plain
    version; ``q_offset`` None (END-aligned) and 0 give the same bits, as no
    mask depends on it, and so does a second call."""
    rng = np.random.default_rng(Sq + Skv + hd)
    q = _rand(rng, (B, Sq, H, hd), dt, cuda_dev)
    k = _rand(rng, (B, Skv, Kh, hd), dt, cuda_dev)
    v = _rand(rng, (B, Skv, Kh, hd), dt, cuda_dev)
    out = flash_attention(q, k, v, causal=False, q_offset=0)
    torch.testing.assert_close(
        out.float(), flash_attention_plain(q, k, v, causal=False,
                                           q_offset=0).float(), **TOL[dt])
    assert torch.equal(flash_attention(q, k, v, causal=False), out)
    assert torch.equal(flash_attention(q, k, v, causal=False, q_offset=0),
                       out)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,H,Kh,Skv", [(128, 32, 8, 1601), (64, 6, 6, 1500)],
                         ids=["vision", "whisper"])
def test_cuda_flash_padded_bucket_rows(cuda_dev, dt, hd, H, Kh, Skv):
    """A 600-token prompt padded to the 1024 bucket: its 600 real rows of a
    non-causal call equal the unpadded call's bit for bit (rows do not see
    each other), and the plain version's."""
    rng = np.random.default_rng(hd)
    q = _rand(rng, (1, 1024, H, hd), dt, cuda_dev)
    k = _rand(rng, (1, Skv, Kh, hd), dt, cuda_dev)
    v = _rand(rng, (1, Skv, Kh, hd), dt, cuda_dev)
    padded = flash_attention(q, k, v, causal=False, q_offset=0)[:, :600]
    real = flash_attention(q[:, :600].contiguous(), k, v, causal=False,
                           q_offset=0)
    assert torch.equal(padded, real)
    torch.testing.assert_close(
        real.float(), flash_attention_plain(q[:, :600], k, v, causal=False,
                                            q_offset=0).float(), **TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cdt", list(CACHE_DTYPES))
@pytest.mark.parametrize("H,Kh,hd,M", [(32, 8, 128, 1601), (6, 6, 64, 1500)],
                         ids=["vision", "whisper"])
def test_cuda_cross_decode_over_memory_rows(cuda_dev, dt, cdt, H, Kh, hd,
                                            M):
    """Cross decode: every slot reads all M memory rows (cache_len = M, a
    scalar or per slot) of a cache M rows long, against the plain version
    and the tile cores' mirror (vision's G = 4 runs the mma core, whisper's
    G = 1 the lane core; 1601 rows end one key into a tile), over every
    (q, cache) pair; the same bits again, and
    from a cache 16 rows longer whose rows past M hold NaN."""
    rng = np.random.default_rng(M)
    B = 8
    cd = CACHE_DTYPES[cdt]
    q = _rand(rng, (B, H, hd), dt, cuda_dev)
    kc = _rand(rng, (B, Kh, M, hd), "float32", cuda_dev).to(cd)
    vc = _rand(rng, (B, Kh, M, hd), "float32", cuda_dev).to(cd)
    out = decode_attention(q, kc, vc, M)
    torch.testing.assert_close(out.float(),
                               decode_attention_plain(q, kc, vc, M).float(),
                               **TOL[dt])
    torch.testing.assert_close(out.float(),
                               decode_mma_plain(q, kc, vc, M).float(),
                               **TOL[dt])
    cl = torch.full((B,), M, dtype=torch.int32, device=cuda_dev)
    assert torch.equal(decode_attention(q, kc, vc, cl), out)
    pad = (0, 0, 0, 16)
    kn = torch.nn.functional.pad(kc.float(), pad, value=float("nan")).to(cd)
    vn = torch.nn.functional.pad(vc.float(), pad, value=float("nan")).to(cd)
    assert torch.equal(decode_attention(q, kn, vn, cl), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cdt", list(CACHE_DTYPES))
@pytest.mark.parametrize("G", [3, 5, 8])
def test_cuda_decode_g8_at_chunk_edges(cuda_dev, dt, cdt, G):
    """qwen1.5-110b's 64 heads on 8 (G = 8, the kernel's MAX_GROUP), and G
    3 and 5 on the same 8 kv heads (the mma core's rows past G unused), at
    hd 128 over every (q, cache) pair, lengths at the tile and chunk edges:
    dense and paged kernels against their plain versions and the mma
    core's mirror, paged kernel == gather path == dense kernel bit for bit
    on equal live rows (NaN in the dead ones), and the same bits again."""
    rng = np.random.default_rng(64 + G)
    lens = np.array([0, 1, TILE - 1, TILE, TILE + 1, CHUNK - 1, CHUNK,
                     CHUNK + 1, 2 * CHUNK + 1, 1008, 600], np.int32)
    B, Kh, hd, Smax, bs = len(lens), 8, 128, 1024, 16
    H = Kh * G
    cd = CACHE_DTYPES[cdt]
    q = _rand(rng, (B, H, hd), dt, cuda_dev)
    kc = _rand(rng, (B, Kh, Smax, hd), "float32", cuda_dev).to(cd)
    vc = _rand(rng, (B, Kh, Smax, hd), "float32", cuda_dev).to(cd)
    cl = torch.from_numpy(lens).to(cuda_dev)
    kp, vp, bt = _pools(rng, lens, Kh, hd, bs, Smax // bs, "float32",
                        cuda_dev)
    _hold_decode(q, kc, vc, cl, kp.to(cd), vp.to(cd), bt, dt)


def _cross_streams(arch, params, device, max_seq=64):
    """Six requests with seeded memories (none for request 4) through a
    smoke engine refactored mid-stream; per-request streams and launches."""
    from repro_torch.launch.serve import attach_memories
    cfg = get_arch(arch).smoke_config
    eng = FlexPipeEngine(cfg, params, [0, 1],
                         EngineConfig(max_batch=4, max_seq=max_seq,
                                      warm_profiles=(1, 2)), device=device)
    rng = np.random.default_rng(8)
    reqs = []
    for i in range(6):
        r = Request(rid=i, arrival=0.0, prompt_len=int(rng.integers(3, 31)),
                    max_new_tokens=8)
        r.prompt_tokens = rng.integers(0, cfg.vocab_size, r.prompt_len)
        reqs.append(r)
    attach_memories(cfg, params, reqs, max_seq, rng)
    del reqs[4].memory
    for r in reqs:
        eng.submit(r, now=0.0)
    build.reset_launches()
    for t in range(100):
        if t == 3:
            assert eng.refactor([0])["compile_cache_hit"]
        eng.step(t * 0.05)
        if not eng.queue and all(s.done for s in eng.slots):
            break
    assert all(r.output is not None and len(r.output) == 8 for r in reqs)
    return [r.output for r in reqs], dict(build.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_cuda_cross_engines_equal_cpu(cuda_dev, arch):
    """The cross-attention smoke configs on the card, with every cross
    gate set nonzero and a refactor mid-stream, give the CPU run's streams
    through the flash and decode kernels (cross prefill non-causal, cross
    decode over the memory rows; whisper's memories from its encoder)."""
    cfg = get_arch(arch).smoke_config
    cpu = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    gates = np.random.default_rng(1)

    def set_gates(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if k == "gate":
                    v.fill_(float(gates.choice([-1.0, 1.0])
                                  * gates.uniform(0.5, 1.5)))
                else:
                    set_gates(v)
        elif isinstance(t, list):
            for v in t:
                set_gates(v)
    set_gates(cpu)
    card = tree_from_numpy(tree_to_numpy(cpu), cuda_dev)
    want, _ = _cross_streams(arch, cpu, "cpu")
    got, launches = _cross_streams(arch, card, cuda_dev)
    assert got == want
    assert launches.get("decode_attention", 0) > 0
    assert launches.get("flash_attention", 0) > 0
    assert launches.get("paged_decode_attention", 0) == 0


def _mla_cfg():
    """deepseek-v2-236b's smoke config with its MLA heads widened to the
    real model's (nope 128, rope 64, v 128): prefill runs the flash kernel
    at (192, 128), the served pair (the smoke's (24, 16) is not built)."""
    from repro_torch.configs.base import MLAConfig
    cfg = get_arch("deepseek-v2-236b").smoke_config
    return dataclasses.replace(cfg, mla=MLAConfig(
        kv_lora_rank=32, q_lora_rank=48, rope_head_dim=64,
        nope_head_dim=128, v_head_dim=128))


def _mla_streams(device, params):
    cfg = _mla_cfg()
    eng = FlexPipeEngine(cfg, params, [0, 2],
                         EngineConfig(max_batch=4, max_seq=128,
                                      warm_profiles=(4,)), device=device)
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(6):
        r = Request(rid=i, arrival=0.0, prompt_len=int(rng.integers(30, 62)),
                    max_new_tokens=8)
        r.prompt_tokens = rng.integers(0, cfg.vocab_size, r.prompt_len)
        reqs.append(r)
    for r in reqs:
        eng.submit(r, now=0.0)
    build.reset_launches()
    for t in range(200):
        if t == 5:
            assert eng.refactor([0, 1, 2, 3])["compile_cache_hit"]
        eng.step(t * 0.05)
        if not eng.queue and all(s.done for s in eng.slots):
            break
    assert all(r.output is not None and len(r.output) == 8 for r in reqs)
    return [r.output for r in reqs], dict(build.launches)


@pytest.mark.cuda
def test_cuda_mla_engine_equals_cpu(cuda_dev):
    """An MLA engine on the card (the smoke config at the real head dims),
    refactored mid-stream, gives the CPU run's streams; every prefill runs
    the flash kernel once per layer (4 layers) and decode, in the absorbed
    form, launches no attention kernel."""
    cfg = _mla_cfg()
    cpu = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree_from_numpy(tree_to_numpy(cpu), cuda_dev)
    want, _ = _mla_streams("cpu", cpu)
    got, launches = _mla_streams(cuda_dev, card)
    assert got == want
    assert launches.get("flash_attention", 0) == cfg.n_layers * 6
    assert launches.get("decode_attention", 0) == 0
    assert launches.get("paged_decode_attention", 0) == 0


# ---------------------------------------------------------------------------
# the backward kernels (training)
# ---------------------------------------------------------------------------

# the flash backward against autograd through the plain version, f32: the
# kernel sums over up to a few hundred rows or keys in another order
BWD_TOL = dict(atol=1e-4, rtol=1e-4)


def _grads_equal_plain(got, ref, tol):
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,hdv", HEAD_DIM_PAIRS)
@pytest.mark.parametrize("causal,window,G,Sq,Skv,q_offset", [
    (True, 0, 1, 100, 100, None),        # Sq off the 64-row tile
    (True, 0, 4, 77, 130, None),         # GQA, end-aligned rows
    (True, 24, 1, 129, 129, None),       # a window
    (False, 0, 4, 65, 33, None),         # full attention, Skv < Sq
    (True, 0, 2, 50, 200, 17),           # an explicit q_offset
    (True, 16, 2, 31, 300, 250),         # window, rows past the keys' end
])
def test_cuda_flash_backward(cuda_dev, hd, hdv, causal, window, G, Sq, Skv,
                             q_offset):
    """dQ, dK and dV of the kernel (through FlashAttentionFn) against
    autograd through the plain version on the card; a second backward
    gives the same bits."""
    rng = np.random.default_rng(7)
    B, Kh = 2, 2
    H = Kh * G
    q = _rand(rng, (B, Sq, H, hd), "float32", cuda_dev)
    k = _rand(rng, (B, Skv, Kh, hd), "float32", cuda_dev)
    v = _rand(rng, (B, Skv, Kh, hdv), "float32", cuda_dev)
    dout = _rand(rng, (B, Sq, H, hdv), "float32", cuda_dev)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = build.launches["flash_attention_bwd"]
    got = torch.autograd.grad(flash_attention(*ins, **kw), ins, dout)
    assert build.launches["flash_attention_bwd"] == before + 1
    _grads_equal_plain(got, flash_attention_bwd_plain(q, k, v, dout, **kw),
                       BWD_TOL)
    again = torch.autograd.grad(flash_attention(*ins, **kw), ins, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_wkv6_backward_refuses_bf16(cuda_dev):
    """wkv6's backward kernel takes f32 only, and under autograd the
    wrapper refuses bf16 r, k and v: no caller needs more, since the RWKV
    layer widens r, k and v to f32 before the WKV call even at bf16 params
    (models/ssm.py), as the reference's does."""
    rng = np.random.default_rng(3)
    r, k, v, w, u, _ = _wkv_inputs(rng, 1, 8, 2, 64, "bfloat16", cuda_dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wkv6(r.requires_grad_(True), k, v, w, u, None)


def _bf16_flash_inputs(rng, B, Sq, Skv, H, Kh, hd, hdv, dev):
    q = _rand(rng, (B, Sq, H, hd), "bfloat16", dev)
    k = _rand(rng, (B, Skv, Kh, hd), "bfloat16", dev)
    v = _rand(rng, (B, Skv, Kh, hdv), "bfloat16", dev)
    return q, k, v, _rand(rng, (B, Sq, H, hdv), "bfloat16", dev)


def _ulp_bf16(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _within_ulp(got, want):
    """Elementwise |got - want| <= one bf16 ulp of want or TOL's atol."""
    err = (got.float() - want.float()).abs()
    tol = torch.clamp(_ulp_bf16(want.float()), min=TOL["bfloat16"]["atol"])
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("hd,hdv", HEAD_DIM_PAIRS)
@pytest.mark.parametrize("causal,window,G,Sq,Skv,q_offset", [
    (True, 0, 1, 100, 100, None),
    (True, 0, 4, 77, 130, None),
    (True, 24, 1, 129, 129, None),
    (False, 0, 4, 65, 33, None),
    (True, 16, 2, 31, 300, 250),
    (True, 0, 1, 65, 65, None),          # one row past the 64-row tile
    (True, 40, 4, 190, 190, None),       # window, GQA 4, off the tiles
    (True, 0, 4, 33, 97, 40),            # q_offset, GQA 4
    (True, 0, 2, 50, 200, 17),           # an explicit q_offset
    (True, 0, 1, 30, 63, -10),           # rows before every key
])
def test_cuda_flash_backward_bf16_near_f32_rounded(cuda_dev, hd, hdv,
                                                   causal, window, G, Sq,
                                                   Skv, q_offset):
    """The bf16 backward within one bf16 ulp (or TOL's atol) of the f32
    backward kernel on the widened inputs (q, k, v, the forward's bf16
    output and dO), each gradient rounded to bf16: the bf16 design's
    m16n8k16 products sum in another order than 3xTF32, so the two may
    round to neighbours; a second call gives the same bits; and under
    autograd it goes through FlashAttentionFn with bf16 gradients."""
    from repro_torch.kernels import flash_attention as FA
    rng = np.random.default_rng(11)
    B, Kh = 2, 2
    q, k, v, do = _bf16_flash_inputs(rng, B, Sq, Skv, Kh * G, Kh, hd, hdv,
                                     cuda_dev)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    with torch.no_grad():
        o = flash_attention(q, k, v, **kw)
    args = (causal, window, hd ** -0.5,
            (Skv - Sq) if q_offset is None else q_offset)
    got = FA._launch_backward(q, k, v, o, do, *args)
    wide = FA._launch_backward(*(t.float() for t in (q, k, v, o, do)), *args)
    for g, w in zip(got, wide):
        assert g.dtype == torch.bfloat16
        _within_ulp(g, w.to(torch.bfloat16))
    again = FA._launch_backward(q, k, v, o, do, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = build.launches["flash_attention_bwd"]
    auto = torch.autograd.grad(flash_attention(*ins, **kw), ins, do)
    assert build.launches["flash_attention_bwd"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, auto))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,hdv", HEAD_DIM_PAIRS)
def test_cuda_flash_backward_bf16_equals_plain(cuda_dev, hd, hdv):
    """The bf16 backward kernel against its plain version (f32 math on the
    widened inputs, D from the forward's bf16 output as the kernel's,
    rounded once) on the same inputs, within one bf16 ulp or TOL's atol,
    element by element: the two sum in other orders."""
    from repro_torch.kernels import flash_attention as FA
    rng = np.random.default_rng(12)
    q, k, v, do = _bf16_flash_inputs(rng, 2, 200, 330, 8, 2, hd, hdv,
                                     cuda_dev)
    kw = dict(causal=True, window=64, q_offset=130)
    with torch.no_grad():
        o = flash_attention(q, k, v, **kw)
    got = FA._launch_backward(q, k, v, o, do, True, 64, hd ** -0.5, 130)
    ref = flash_attention_bwd_plain(q, k, v, do, o=o, **kw)
    for g, r in zip(got, ref):
        _within_ulp(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv,H,Kh,window,q_offset", [
    (512, 512, 16, 16, 0, None),         # the (128, 128) template at B 1
    (130, 130, 8, 2, 40, None),          # GQA 4, a window, off the tiles
    (70, 200, 8, 2, 0, 100),             # q_offset, Sq and Skv off tiles
])
def test_cuda_flash_wgmma_backward_bf16(cuda_dev, Sq, Skv, H, Kh, window,
                                        q_offset):
    """At bf16 (128, 128) the forward is flash_wgmma_kernel and the
    backward reads its o (D = dout . o): through FlashAttentionFn, each
    gradient bf16 and within one bf16 ulp or TOL's atol of
    flash_attention_bwd_plain on the same o; one backward launch; a second
    backward gives the same bits."""
    rng = np.random.default_rng(30)
    q, k, v, do = _bf16_flash_inputs(rng, 1, Sq, Skv, H, Kh, 128, 128,
                                     cuda_dev)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention(*ins, **kw)
    assert _over_bf16_ulp(o, flash_wgmma_plain(q, k, v, **kw)) == 0
    before = build.launches["flash_attention_bwd"]
    got = torch.autograd.grad(o, ins, do, retain_graph=True)
    assert build.launches["flash_attention_bwd"] == before + 1
    ref = flash_attention_bwd_plain(q, k, v, do, o=o.detach(), **kw)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        _within_ulp(g, r)
    again = torch.autograd.grad(o, ins, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("edge", ["one", "below", "at", "above", "long"])
def test_cuda_wkv6_backward(cuda_dev, hd, edge):
    """dr, dk, dv, dw, du and dstate0 of the kernel (through WKV6Fn), with
    a state0 and a final-state gradient, against autograd through the plain
    version, at S across the backward's chunk edges; a second backward
    gives the same bits; state0 is left as it was."""
    tc = _bwd_geometry(hd).chunk
    S = {"one": 1, "below": tc - 1 or 1, "at": tc, "above": tc + 1,
         "long": 131}[edge]
    rng = np.random.default_rng(8)
    B, H = 2, 2
    r, k, v, w, u, st0 = _wkv_inputs(rng, B, S, H, hd, "float32", cuda_dev)
    dy = _rand(rng, (B, S, H, hd), "float32", cuda_dev)
    dst = _rand(rng, (B, H, hd, hd), "float32", cuda_dev)
    keep = st0.clone()
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, st0)]
    y, st = wkv6(*ins)
    assert torch.equal(ins[5].detach(), keep)
    got = torch.autograd.grad((y, st), ins, (dy, dst))
    ref = wkv6_bwd_plain(r, k, v, w, u, st0, dy, dst)
    for g, rf in zip(got, ref):
        torch.testing.assert_close(
            g, rf, rtol=0, atol=WKV_TOL["float32"] * float(rf.abs().max()))
    y2, st2 = wkv6(*ins)
    again = torch.autograd.grad((y2, st2), ins, (dy, dst))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_wkv6_backward_without_state(cuda_dev):
    """The training call: no state0, only y's gradient."""
    rng = np.random.default_rng(9)
    r, k, v, w, u, _ = _wkv_inputs(rng, 2, 70, 4, 64, "float32", cuda_dev,
                                   with_state=False)
    dy = _rand(rng, (2, 70, 4, 64), "float32", cuda_dev)
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    y, _ = wkv6(*ins)
    got = torch.autograd.grad(y, ins, dy)
    ref = wkv6_bwd_plain(r, k, v, w, u, None, dy)
    for g, rf in zip(got, ref[:5]):
        torch.testing.assert_close(
            g, rf, rtol=0, atol=WKV_TOL["float32"] * float(rf.abs().max()))


# the redesigned backward kernels at their own edges: flash's key tiles of
# 64 (32 at hd 256) and query tiles of 64 or 32, whose dQ partials the
# combine sums; wkv6's chunks of 16 steps (two sub-chunks of 8 in
# registers) on clusters of hd / 32 CTAs
@pytest.mark.cuda
@pytest.mark.parametrize("hd,hdv", [(64, 64), (128, 128), (256, 256)])
@pytest.mark.parametrize("causal,window,G,Sq,Skv,q_offset", [
    (True, 0, 1, 63, 63, None), (True, 0, 1, 64, 64, None),
    (True, 0, 1, 65, 65, None), (True, 0, 1, 127, 127, None),
    (True, 0, 1, 128, 128, None), (True, 0, 1, 129, 129, None),
    (True, 0, 1, 257, 257, None),
    (True, 64, 2, 200, 257, None),       # a window across the key tiles
    (True, 0, 8, 40, 129, None),         # G = 8
    (True, 32, 1, 60, 100, -20),         # q_offset < 0: rows see no key
    (True, 16, 2, 31, 128, 200),         # windowed rows past every key
])
def test_cuda_flash_backward_tile_edges(cuda_dev, hd, hdv, causal, window, G,
                                        Sq, Skv, q_offset):
    """dQ, dK and dV of the kernel against autograd through the plain
    version across the key and query tiles' edges; a second backward gives
    the same bits."""
    rng = np.random.default_rng(Skv + G)
    B, Kh = 1, 2
    H = Kh * G
    q = _rand(rng, (B, Sq, H, hd), "float32", cuda_dev)
    k = _rand(rng, (B, Skv, Kh, hd), "float32", cuda_dev)
    v = _rand(rng, (B, Skv, Kh, hdv), "float32", cuda_dev)
    dout = _rand(rng, (B, Sq, H, hdv), "float32", cuda_dev)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*ins, **kw), ins, dout)
    _grads_equal_plain(got, flash_attention_bwd_plain(q, k, v, dout, **kw),
                       BWD_TOL)
    again = torch.autograd.grad(flash_attention(*ins, **kw), ins, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("S", [8, 9, 15, 16, 17, 40])
@pytest.mark.parametrize("with_state", [False, True])
def test_cuda_wkv6_backward_chunk_edges(cuda_dev, hd, S, with_state):
    """The six gradients of the kernel (through WKV6Fn) against autograd
    through the plain version at the chunk's and sub-chunk's edges, on
    every cluster size (hd / 32 CTAs; one at hd 16 and 32), with a state0
    and a final-state gradient or with neither; a second backward gives the
    same bits."""
    rng = np.random.default_rng(S + hd)
    B, H = 2, 3
    r, k, v, w, u, st0 = _wkv_inputs(rng, B, S, H, hd, "float32", cuda_dev,
                                     with_state=with_state)
    dy = _rand(rng, (B, S, H, hd), "float32", cuda_dev)
    dst = (_rand(rng, (B, H, hd, hd), "float32", cuda_dev) if with_state
           else None)
    leaves = (r, k, v, w, u) + ((st0,) if with_state else ())
    ins = [t.clone().requires_grad_(True) for t in leaves]

    def grads():
        y, st = wkv6(*ins)
        if with_state:
            return torch.autograd.grad((y, st), ins, (dy, dst))
        return torch.autograd.grad(y, ins, dy)
    got = grads()
    ref = wkv6_bwd_plain(r, k, v, w, u, st0 if with_state else None, dy, dst)
    for g, rf in zip(got, ref):
        torch.testing.assert_close(
            g, rf, rtol=0, atol=WKV_TOL["float32"] * float(rf.abs().max()))
    assert all(torch.equal(a, b) for a, b in zip(got, grads()))


@pytest.mark.cuda
def test_cuda_decode_refuses_grad(cuda_dev):
    q = torch.zeros((2, 4, 64), device=cuda_dev, requires_grad=True)
    kc = torch.zeros((2, 4, 32, 64), device=cuda_dev)
    with pytest.raises(RuntimeError, match="decode_attention"):
        decode_attention(q, kc, kc, 5)
    with torch.no_grad():
        decode_attention(q, kc, kc, 5)


@pytest.mark.cuda
def test_cuda_two_ranks_share_one_card(cuda_dev, tmp_path):
    """A gloo world of two ranks on cuda:0 (tests/torch_dist.py), qwen's
    smoke config at S = 2: a train step and a prefill and decode step
    against the same steps at one rank on the card (loss 1e-5 relative,
    grad norm 2x the one rank's, the reference's psum-transpose count;
    logits 1e-4), through the flash, flash backward and decode kernels, the
    stage rotation staged through host memory; NCCL refuses the two ranks
    on one device."""
    from torch_dist import run_cases

    from repro_torch.configs.base import PipelinePlan, ShapeConfig
    from repro_torch.launch.mesh import init_rank
    from repro_torch.parallel.pipeline import (build_decode_step,
                                               build_prefill_step,
                                               build_train_step, stack_params)
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    if torch.cuda.device_count() == 1:
        with pytest.raises(ValueError, match="NCCL refuses"):
            init_rank(0, 2, "nccl", f"file://{tmp_path}/never")
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    params = tree_to_numpy(init_model(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    plan = dict(stages=2, microbatches=2)
    got_t, got_s = run_cases([
        {"kind": "train", "arch": "qwen1.5-0.5b", "plan": plan,
         "mesh": (1, 2), "params": params, "return_params": False,
         "batches": [{"tokens": tokens, "labels": tokens}], "opt": {}},
        {"kind": "serve", "arch": "qwen1.5-0.5b", "plan": plan,
         "mesh": (1, 2), "params": params, "tokens": tokens, "max_seq": 16}],
        nranks=2, device=None)
    one = PipelinePlan(microbatches=2)
    p = stack_params(cfg, one, tree_from_numpy(params, cuda_dev))
    t = torch.from_numpy(tokens).to(cuda_dev)
    step, _ = build_train_step(cfg, one, None, ShapeConfig("t", 16, 8,
                                                           "train"),
                               AdamWConfig(), param_dtype=torch.float32)
    _, _, m = step(p, init_opt_state(p), {"tokens": t, "labels": t})
    tm = got_t["metrics"][0]
    np.testing.assert_allclose(tm["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"] / float(m["grad_norm"]), 2.0,
                               rtol=1e-4)
    assert got_t["launches"]["flash_attention"] > 0
    assert got_t["launches"]["flash_attention_bwd"] > 0
    assert got_t["comm"]["bytes_staged"] > 0
    p = stack_params(cfg, one, tree_from_numpy(params, cuda_dev))
    f32 = torch.float32
    pre, _ = build_prefill_step(cfg, one, None, ShapeConfig("p", 16, 8,
                                                            "prefill"),
                                param_dtype=f32, cache_dtype=f32)
    dec, _ = build_decode_step(cfg, one, None, ShapeConfig("d", 16, 8,
                                                           "decode"),
                               param_dtype=f32, cache_dtype=f32)
    last, caches = pre(p, {"tokens": t[:, :-1]})
    logits, _ = dec(p, caches, t[:, -1:], 15)
    np.testing.assert_allclose(got_s["prefill"], last.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_s["decode"][0], logits.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    assert got_s["prefill_counts"]["launches"]["flash_attention"] > 0
    assert got_s["decode0_counts"]["launches"]["decode_attention"] > 0
