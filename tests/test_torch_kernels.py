"""repro_torch kernels: plain PyTorch versions held against the JAX oracles
and the Pallas kernels (interpret mode), wrapper dispatch, build.py's
error without nvcc.  The CUDA kernels themselves are tested in
test_torch_cuda.py, which imports no JAX so it also runs on a GPU machine."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.decode_attention import (
    decode_attention as pl_decode, paged_decode_attention as pl_paged)
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (
    CHUNK, chunk_plan, decode_attention, decode_attention_plain,
    decode_combine_plain, decode_partials_plain, gather_pages,
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rwkv6_wkv import wkv6

torch.set_num_threads(2)

TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rand(rng, shape, dt="float32"):
    """Same values for both frameworks: f32 numpy, rounded once to dt."""
    x = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(TORCH_DT[dt])
    return t, jnp.asarray(t.float().numpy()).astype(dt)


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Kh,hd,causal,window", [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 64, 256, 8, 8, 32, True, 0),
    (2, 96, 96, 4, 1, 64, True, 32),      # GQA + sliding window
    (1, 33, 190, 2, 2, 16, False, 0),     # ragged, non-causal
    (1, 1, 128, 4, 2, 64, True, 0),       # single query row
])
def test_flash_plain_vs_ref_and_pallas(dt, B, Sq, Skv, H, Kh, hd, causal,
                                       window):
    rng = np.random.default_rng(Sq * 7 + Skv)
    q, qj = _rand(rng, (B, Sq, H, hd), dt)
    k, kj = _rand(rng, (B, Skv, Kh, hd), dt)
    v, vj = _rand(rng, (B, Skv, Kh, hd), dt)
    out = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == q.dtype and out.shape == (B, Sq, H, hd)
    expect = ref.attention_ref(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(expect), **TOL[dt])
    pallas = pl_flash(qj, kj, vj, causal=causal, window=window, block_q=32,
                      block_k=64, interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dt])


@pytest.mark.parametrize("c0,L", [(0, 32), (32, 32), (96, 32), (64, 17)])
def test_flash_q_offset_matches_full_rows(c0, L):
    rng = np.random.default_rng(c0 + L)
    q, qj = _rand(rng, (1, 128, 4, 32))
    k, kj = _rand(rng, (1, 128, 2, 32))
    v, vj = _rand(rng, (1, 128, 2, 32))
    full = flash_attention_plain(q, k, v, causal=True)
    chunk = flash_attention_plain(q[:, c0:c0 + L], k, v, causal=True,
                                  q_offset=c0)
    np.testing.assert_allclose(_np(chunk), _np(full)[:, c0:c0 + L],
                               atol=3e-5, rtol=3e-5)
    pallas = pl_flash(qj[:, c0:c0 + L], kj, vj, causal=True, q_offset=c0,
                      block_q=32, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(chunk), _np(pallas), atol=3e-5, rtol=3e-5)


def test_flash_fully_masked_rows_are_zero():
    """A causal query before every key (q_offset < 0 past the span) sees no
    key: the Pallas kernels return 0 there, and so does the plain version."""
    rng = np.random.default_rng(3)
    q, _ = _rand(rng, (1, 4, 2, 16))
    k, _ = _rand(rng, (1, 8, 2, 16))
    out = flash_attention_plain(q, k, k, causal=True, q_offset=-4)
    assert torch.equal(out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# decode attention (dense and paged)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Kh,hd,Smax,lens", [
    (2, 4, 2, 64, 300, [293, 17]),
    (1, 8, 8, 32, 512, [505]),
    (4, 4, 1, 128, 64, [64, 1, 33, 0]),   # full, one row, ragged, empty
    (2, 4, 2, 16, 100, [100, 37]),        # Smax not a multiple of a tile
])
def test_decode_plain_vs_ref_and_pallas(dt, B, H, Kh, hd, Smax, lens):
    rng = np.random.default_rng(Smax + B)
    q, qj = _rand(rng, (B, H, hd), dt)
    kc, kj = _rand(rng, (B, Kh, Smax, hd), dt)
    vc, vj = _rand(rng, (B, Kh, Smax, hd), dt)
    cl = np.asarray(lens, np.int32)
    out = decode_attention_plain(q, kc, vc, torch.from_numpy(cl))
    assert out.dtype == q.dtype and out.shape == (B, H, hd)
    pallas = pl_decode(qj, kj, vj, jnp.asarray(cl), block_k=64,
                       interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dt])
    live = cl > 0                 # the jnp oracle is NaN on an empty cache
    expect = ref.decode_attention_ref(qj, kj, vj, jnp.asarray(cl))
    np.testing.assert_allclose(_np(out)[live], _np(expect)[live], **TOL[dt])


def test_decode_dead_rows_contribute_zero():
    """Rows at or past cache_len may hold anything, NaN included."""
    rng = np.random.default_rng(5)
    q, _ = _rand(rng, (2, 4, 16))
    kc, _ = _rand(rng, (2, 2, 40, 16))
    vc, _ = _rand(rng, (2, 2, 40, 16))
    cl = torch.tensor([13, 40], dtype=torch.int32)
    clean = decode_attention_plain(q, kc, vc, cl)
    kc[0, :, 13:] = float("nan")
    vc[0, :, 13:] = float("inf")
    assert torch.equal(decode_attention_plain(q, kc, vc, cl), clean)


def _paged_setup(rng, B, Kh, hd, bs, M, lens):
    """Pools with each slot's live blocks at random physical ids; dead and
    unallocated table entries point at the null block 0."""
    n_blocks = 1 + B * M
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((B, M), np.int32)
    kp = rng.standard_normal((n_blocks, Kh, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, Kh, bs, hd)).astype(np.float32)
    idx = 0
    for b in range(B):
        for j in range(-(-int(lens[b]) // bs)):
            tables[b, j] = perm[idx]
            idx += 1
    return kp, vp, tables


@pytest.mark.parametrize("B,H,Kh,hd,bs,M,lens", [
    (3, 4, 2, 16, 16, 6, [5, 96, 33]),
    (2, 4, 4, 32, 8, 4, [1, 32]),         # MHA, full tail block
    (1, 8, 2, 16, 32, 3, [70]),           # GQA 4, partial tail
    (2, 4, 4, 16, 16, 4, [0, 20]),        # an empty slot: all-null table
])
def test_paged_plain_vs_pallas_and_dense(B, H, Kh, hd, bs, M, lens):
    rng = np.random.default_rng(B * 10 + M)
    kp, vp, tables = _paged_setup(rng, B, Kh, hd, bs, M, lens)
    q, qj = _rand(rng, (B, H, hd))
    cl = np.asarray(lens, np.int32)
    kt, vt, bt = (torch.from_numpy(kp), torch.from_numpy(vp),
                  torch.from_numpy(tables))
    out = paged_decode_attention_plain(q, kt, vt, bt, torch.from_numpy(cl))
    pallas = pl_paged(qj, jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(tables), jnp.asarray(cl), interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=3e-5, rtol=3e-5)
    # the gathered logical view through the dense version: same bits
    dense = decode_attention_plain(q, gather_pages(kt, bt),
                                   gather_pages(vt, bt), torch.from_numpy(cl))
    assert torch.equal(out, dense)


def test_gather_pages_layout():
    rng = np.random.default_rng(9)
    kp, _, tables = _paged_setup(rng, 2, 2, 8, 4, 3, [9, 4])
    g = gather_pages(torch.from_numpy(kp), torch.from_numpy(tables))
    assert g.shape == (2, 2, 12, 8)
    # logical row 5 of slot 0 is row 1 of its second block
    np.testing.assert_array_equal(g[0, :, 5].numpy(), kp[tables[0, 1], :, 1])


# ---------------------------------------------------------------------------
# the split-KV plan: fixed chunks merged in chunk order
# ---------------------------------------------------------------------------

BOUNDARY_LENS = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 1, 300]


@pytest.mark.parametrize("B,H,Kh,hd,Smax,lens", [
    (7, 4, 2, 16, 300, BOUNDARY_LENS),
    (3, 8, 1, 64, 1024, [1024, 513, 640]),   # G = 8, whole chunks
    (2, 4, 4, 32, 100, [100, 37]),           # Smax under one chunk
])
def test_chunked_plain_equals_whole_softmax(B, H, Kh, hd, Smax, lens):
    """The masked softmax cut at the fixed chunk boundaries and merged in
    chunk order (the kernel's plan) equals the whole-cache plain version."""
    rng = np.random.default_rng(Smax + hd)
    q, _ = _rand(rng, (B, H, hd))
    kc, _ = _rand(rng, (B, Kh, Smax, hd))
    vc, _ = _rand(rng, (B, Kh, Smax, hd))
    cl = torch.tensor(lens, dtype=torch.int32)
    m, l, acc = decode_partials_plain(q, kc, vc, cl)
    assert m.shape == (B, Kh, -(-Smax // CHUNK), H // Kh)
    out = decode_combine_plain(m, l, acc, cl, cap=Smax, dtype=q.dtype)
    np.testing.assert_allclose(_np(out), _np(decode_attention_plain(q, kc, vc,
                                                                    cl)),
                               atol=1e-6, rtol=1e-6)


def test_chunks_past_cache_len_change_nothing():
    """The combine never reads a chunk at or past ceil(cache_len / CHUNK):
    garbage there (NaN, inf) leaves the output's bits as they were."""
    rng = np.random.default_rng(4)
    B, H, Kh, hd, Smax = 7, 4, 2, 16, 300
    q, _ = _rand(rng, (B, H, hd))
    kc, _ = _rand(rng, (B, Kh, Smax, hd))
    vc, _ = _rand(rng, (B, Kh, Smax, hd))
    cl = torch.tensor(BOUNDARY_LENS, dtype=torch.int32)
    m, l, acc = decode_partials_plain(q, kc, vc, cl)
    clean = decode_combine_plain(m, l, acc, cl, cap=Smax, dtype=q.dtype)
    _, live = chunk_plan(cl, Smax)
    for b, chunks in enumerate(live):
        m[b, :, len(chunks):] = float("nan")
        l[b, :, len(chunks):] = float("inf")
        acc[b, :, len(chunks):] = float("nan")
    assert torch.equal(decode_combine_plain(m, l, acc, cl, cap=Smax,
                                            dtype=q.dtype), clean)
    # and rows past cache_len never reach a live chunk's partials
    kc2, vc2 = kc.clone(), vc.clone()
    for b, n in enumerate(BOUNDARY_LENS):
        kc2[b, :, n:] = float("nan")
        vc2[b, :, n:] = float("inf")
    m2, l2, acc2 = decode_partials_plain(q, kc2, vc2, cl)
    assert torch.equal(decode_combine_plain(m2, l2, acc2, cl, cap=Smax,
                                            dtype=q.dtype), clean)


@pytest.mark.parametrize("bs,M", [(16, 64), (32, 32), (16, 65)])
def test_chunk_plan_dense_equals_gathered_paged_view(bs, M):
    """The live chunks are logical positions: a dense Smax=1024 cache and
    the gathered view of a paged cache (Smax = M * bs) split alike."""
    lens = [1024, 1, 17, 512, 600, 333, 1000, 64]
    rng = np.random.default_rng(bs + M)
    kp, _, tables = _paged_setup(rng, len(lens), 2, 8, bs, M, lens)
    view = gather_pages(torch.from_numpy(kp), torch.from_numpy(tables))
    cl = torch.tensor(lens, dtype=torch.int32)
    n_dense, live_dense = chunk_plan(cl, 1024)
    n_view, live_view = chunk_plan(cl, view.shape[2])
    assert live_view == live_dense
    assert n_view == n_dense or view.shape[2] != 1024
    assert [c[-1][1] if c else 0 for c in live_dense] == lens
    assert all(s % CHUNK == 0 for c in live_dense for s, _ in c)


@pytest.mark.parametrize("lens", [BOUNDARY_LENS[:4], BOUNDARY_LENS[3:]])
def test_cpu_decode_wrappers_at_chunk_boundaries(lens):
    """On the CPU both decode wrappers are their plain versions, at lengths
    that straddle the chunk boundaries, and count no launch."""
    build.reset_launches()
    rng = np.random.default_rng(len(lens))
    B = len(lens)
    q, _ = _rand(rng, (B, 4, 16))
    kc, _ = _rand(rng, (B, 2, 320, 16))
    cl = torch.tensor(lens, dtype=torch.int32)
    assert torch.equal(decode_attention(q, kc, kc, cl),
                       decode_attention_plain(q, kc, kc, cl))
    kp, vp, tables = _paged_setup(rng, B, 2, 16, 16, 20, lens)
    args = (q, torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(tables), cl)
    assert torch.equal(paged_decode_attention(*args),
                       paged_decode_attention_plain(*args))
    assert sum(build.launches.values()) == 0


# ---------------------------------------------------------------------------
# wrappers and build.py
# ---------------------------------------------------------------------------

def test_cpu_wrappers_use_plain_versions_and_count_nothing():
    build.reset_launches()
    rng = np.random.default_rng(11)
    q, _ = _rand(rng, (2, 4, 16))
    kc, _ = _rand(rng, (2, 2, 24, 16))
    cl = torch.tensor([24, 7], dtype=torch.int32)
    assert torch.equal(decode_attention(q, kc, kc, cl),
                       decode_attention_plain(q, kc, kc, cl))
    kp, vp, tables = _paged_setup(rng, 2, 2, 16, 8, 3, [24, 7])
    args = (q, torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(tables), cl)
    assert torch.equal(paged_decode_attention(*args),
                       paged_decode_attention_plain(*args))
    qf, _ = _rand(rng, (1, 12, 4, 16))
    kf, _ = _rand(rng, (1, 20, 2, 16))
    assert torch.equal(flash_attention(qf, kf, kf, q_offset=3),
                       flash_attention_plain(qf, kf, kf, q_offset=3))
    assert sum(build.launches.values()) == 0


def test_wrappers_reject_other_devices():
    """A device with no route (neither the CPU, CUDA nor meta) raises; a
    meta tensor takes the shape-only route (the dry run) and launches
    nothing."""
    with pytest.raises(ValueError, match="no kernel"):
        build.route(SimpleNamespace(device=torch.device("xpu")),
                    "decode attention")
    build.reset_launches()
    q = torch.zeros((1, 2, 16), device="meta")
    out = decode_attention(q, torch.zeros((1, 2, 8, 16), device="meta"),
                           torch.zeros((1, 2, 8, 16), device="meta"), 4)
    assert out.device.type == "meta" and out.shape == (1, 2, 16)
    qf = torch.zeros((1, 5, 2, 16), device="meta", requires_grad=True)
    o = flash_attention(qf, qf.detach(), qf.detach())
    assert o.shape == (1, 5, 2, 16)
    (g,) = torch.autograd.grad(o.sum(), qf)
    assert g.shape == qf.shape and g.device.type == "meta"
    assert sum(build.launches.values()) == 0


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


F8 = torch.float8_e4m3fn
BF = torch.bfloat16
_META_REFUSED = {
    "decode fp8 query": lambda: decode_attention(
        _meta(1, 2, 16, dtype=F8), _meta(1, 2, 8, 16, dtype=F8),
        _meta(1, 2, 8, 16, dtype=F8), 4),
    "decode f16 cache": lambda: decode_attention(
        _meta(1, 2, 16), _meta(1, 2, 8, 16, dtype=torch.float16),
        _meta(1, 2, 8, 16, dtype=torch.float16), 4),
    "decode k and v dtypes differ": lambda: decode_attention(
        _meta(1, 2, 16), _meta(1, 2, 8, 16, dtype=F8),
        _meta(1, 2, 8, 16, dtype=BF), 4),
    "decode G 16": lambda: decode_attention(
        _meta(1, 16, 16), _meta(1, 1, 8, 16), _meta(1, 1, 8, 16), 4),
    "decode hd 48": lambda: decode_attention(
        _meta(1, 2, 48), _meta(1, 2, 8, 48), _meta(1, 2, 8, 48), 4),
    "decode hd != hdv": lambda: decode_attention(
        _meta(1, 2, 64), _meta(1, 2, 8, 64), _meta(1, 2, 8, 32), 4),
    "decode under autograd": lambda: decode_attention(
        _meta(1, 2, 16, grad=True), _meta(1, 2, 8, 16),
        _meta(1, 2, 8, 16), 4),
    "decode non-contiguous cache": lambda: decode_attention(
        _meta(1, 2, 16), _meta(1, 8, 2, 16).transpose(1, 2),
        _meta(1, 8, 2, 16).transpose(1, 2), 4),
    "paged fp8 query": lambda: paged_decode_attention(
        _meta(1, 2, 16, dtype=F8), _meta(3, 2, 8, 16, dtype=F8),
        _meta(3, 2, 8, 16, dtype=F8), _meta(1, 2, dtype=torch.int32), 4),
    "paged G 16": lambda: paged_decode_attention(
        _meta(1, 16, 16), _meta(3, 1, 8, 16), _meta(3, 1, 8, 16),
        _meta(1, 2, dtype=torch.int32), 4),
    "paged int64 tables": lambda: paged_decode_attention(
        _meta(1, 2, 16), _meta(3, 2, 8, 16), _meta(3, 2, 8, 16),
        _meta(1, 2, dtype=torch.int64), 4),
    "flash (48, 48)": lambda: flash_attention(
        _meta(1, 4, 2, 48), _meta(1, 4, 2, 48), _meta(1, 4, 2, 48)),
    "flash f16": lambda: flash_attention(
        *(_meta(1, 4, 2, 16, dtype=torch.float16) for _ in range(3))),
    "flash q and k dtypes differ": lambda: flash_attention(
        _meta(1, 4, 2, 16), _meta(1, 4, 2, 16, dtype=BF),
        _meta(1, 4, 2, 16, dtype=BF)),
    "flash H % Kh": lambda: flash_attention(
        _meta(1, 4, 3, 16), _meta(1, 4, 2, 16), _meta(1, 4, 2, 16)),
    "wkv6 hd 48": lambda: wkv6(*(_meta(1, 4, 2, 48) for _ in range(4)),
                               _meta(2, 48)),
    "wkv6 bf16 u": lambda: wkv6(*(_meta(1, 4, 2, 16) for _ in range(4)),
                                _meta(2, 16, dtype=BF)),
    "wkv6 bf16 under autograd": lambda: wkv6(
        _meta(1, 4, 2, 16, dtype=BF, grad=True),
        *(_meta(1, 4, 2, 16, dtype=BF) for _ in range(3)), _meta(2, 16)),
}


@pytest.mark.parametrize("case", sorted(_META_REFUSED))
def test_meta_route_refuses_what_the_card_refuses(case):
    """The meta route (the dry run's) runs the checks the CUDA route runs
    before its launch, all but the 16-byte alignment of the data: a call the
    kernel does not take raises on meta as it would on the card, so a dry
    run cannot record a step the card refuses as runnable."""
    build.reset_launches()
    with pytest.raises((ValueError, TypeError, RuntimeError,
                        NotImplementedError)):
        _META_REFUSED[case]()
    assert sum(build.launches.values()) == 0


@pytest.mark.parametrize("hd,hdv", [(16, 16), (192, 128)])
def test_meta_route_takes_flash_bf16_under_autograd(hd, hdv):
    """The flash backward kernel takes bf16, so the meta route records a
    bf16 call under autograd (the dry run's bf16 train cells): bf16
    outputs, and bf16 meta gradients of the inputs' shapes."""
    build.reset_launches()
    q = _meta(1, 4, 4, hd, dtype=BF, grad=True)
    k = _meta(1, 6, 2, hd, dtype=BF, grad=True)
    v = _meta(1, 6, 2, hdv, dtype=BF, grad=True)
    o = flash_attention(q, k, v)
    assert o.dtype == BF and o.shape == (1, 4, 4, hdv)
    grads = torch.autograd.grad(o.sum(), (q, k, v))
    for g, t in zip(grads, (q, k, v)):
        assert g.device.type == "meta" and g.dtype == BF
        assert g.shape == t.shape
    assert sum(build.launches.values()) == 0


@pytest.mark.parametrize("q_dt", [torch.float32, BF])
@pytest.mark.parametrize("c_dt", [torch.float32, BF, F8])
def test_meta_route_takes_every_cache_pair(q_dt, c_dt):
    """Every (q, cache) pair the kernel takes passes the meta route's
    checks, dense and paged, at G 8 and hd 256: the output is q's dtype."""
    q = _meta(2, 16, 256, dtype=q_dt)
    kc = _meta(2, 2, 256, 256, dtype=c_dt)
    pool = _meta(5, 2, 64, 256, dtype=c_dt)
    tables = _meta(2, 4, dtype=torch.int32)
    for out in (decode_attention(q, kc, kc, 9),
                paged_decode_attention(q, pool, pool, tables, 9)):
        assert out.device.type == "meta" and out.dtype == q_dt
        assert out.shape == (2, 16, 256)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "CUDA_HOME_DEFAULT", str(tmp_path / "none"))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_all()
    assert not (tmp_path / "kernels").exists()


def test_library_names_hash_their_sources():
    p = build._lib_path("decode_attention")
    assert p.parent == build.BUILD_DIR and p.suffix == ".so"
    assert p != build._lib_path("flash_attention")
    assert p == build._lib_path("decode_attention")

