"""The tile cores' order of sums on the CPU (``decode_mma_plain``): each
warp's 32-key tile's softmax state, the live tiles of a chunk merged in
tile order, then the chunk combine.  Held against the whole-cache plain
version and the Pallas decode kernel in interpret mode at G 1 and 2 (the
lane core, ``decode_lane_kernel``) and 3 to 8 (the mma core's KG 4 and 8
instantiations), hd 16 to 128, every (q, cache) dtype pair, lengths at the
tile and chunk edges and 0; dead rows holding NaN; paged (through
``gather_pages``) equal to dense bit for bit; and the launch geometry the C
launcher checks.  The kernels themselves are held against this mirror in
test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pl_decode
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels.decode_attention import (
    CHUNK, TILE, decode_attention, decode_attention_plain, decode_mma_plain,
    gather_pages, paged_decode_attention_plain)

torch.set_num_threads(2)

NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
             "float8_e4m3fn": ml_dtypes.float8_e4m3fn}
# lengths at the tile and chunk edges, and an empty slot
EDGE_LENS = [0, 1, TILE - 1, TILE, TILE + 1, CHUNK - 1, CHUNK, CHUNK + 1,
             2 * CHUNK + TILE + 1, 300]


def _pair(rng, shape, dt):
    """The same values as a torch tensor and a jax array of ``dt`` (fp8
    crosses as uint8 bits)."""
    x = rng.standard_normal(shape).astype(np.float32).astype(NP_DTYPES[dt])
    if dt == "float8_e4m3fn":
        t = torch.from_numpy(x.view(np.uint8)).view(torch.float8_e4m3fn)
    elif dt == "bfloat16":
        t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    return t, jnp.asarray(x)


def _hold(got, want, qdt):
    """f32: 3e-5; bf16: within 5e-3, or one bf16 ulp apart (the two round
    f32 results that differ by ~1e-6 apart)."""
    g, w = (x.float() if torch.is_tensor(x) else
            torch.from_numpy(np.array(x, np.float32)) for x in (got, want))
    assert bool(torch.isfinite(g).all())
    if qdt == "float32":
        torch.testing.assert_close(g, w, atol=3e-5, rtol=3e-5)
        return
    near = (g.to(torch.bfloat16).view(torch.int16).int()
            - w.to(torch.bfloat16).view(torch.int16).int()).abs() <= 1
    assert bool(((g - w).abs() <= 5e-3).logical_or(near).all()), \
        float((g - w).abs().max())


@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cdt", list(NP_DTYPES))
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [4, 8, 1, 2])
def test_mma_mirror_vs_plain_and_pallas(qdt, cdt, hd, G):
    """The tile order against the whole-cache plain version and the Pallas
    kernel (interpret mode) at the tile and chunk edges."""
    rng = np.random.default_rng(hd * 10 + G)
    B, Kh, Smax = len(EDGE_LENS), 2, 300
    H = Kh * G
    q, qj = _pair(rng, (B, H, hd), qdt)
    kc, kj = _pair(rng, (B, Kh, Smax, hd), cdt)
    vc, vj = _pair(rng, (B, Kh, Smax, hd), cdt)
    cl = np.asarray(EDGE_LENS, np.int32)
    tcl = torch.from_numpy(cl)
    out = decode_mma_plain(q, kc, vc, tcl)
    assert out.dtype == q.dtype and out.shape == (B, H, hd)
    _hold(out, decode_attention_plain(q, kc, vc, tcl), qdt)
    pallas = pl_decode(qj, kj, vj, jnp.asarray(cl), block_k=64,
                       interpret=True)
    _hold(out, np.asarray(pallas.astype(jnp.float32)), qdt)
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # an empty slot


@pytest.mark.parametrize("G", [3, 4, 5, 8, 1, 2])
def test_mma_mirror_dead_rows_hold_nan(G):
    """Rows at or past cache_len may hold anything, NaN included: the tile
    order never reads them (the kernel zero-fills their tile rows)."""
    rng = np.random.default_rng(G)
    B, Kh, Smax, hd = len(EDGE_LENS), 2, 300, 32
    q, _ = _pair(rng, (B, Kh * G, hd), "float32")
    kc, _ = _pair(rng, (B, Kh, Smax, hd), "float32")
    vc, _ = _pair(rng, (B, Kh, Smax, hd), "float32")
    cl = torch.tensor(EDGE_LENS, dtype=torch.int32)
    clean = decode_mma_plain(q, kc, vc, cl)
    for b, n in enumerate(EDGE_LENS):
        kc[b, :, n:] = float("nan")
        vc[b, :, n:] = float("nan")
    assert torch.equal(decode_mma_plain(q, kc, vc, cl), clean)


@pytest.mark.parametrize("cdt", list(NP_DTYPES))
@pytest.mark.parametrize("bs,M", [(16, 20), (32, 10), (16, 19)])
def test_mma_mirror_paged_equals_dense(cdt, bs, M):
    """A paged cache through gather_pages (Smax = M * bs) and a dense cache
    of another width holding the same live rows give the same bits: the
    tiles and chunks are logical positions."""
    rng = np.random.default_rng(bs + M)
    lens = [min(n, M * bs) for n in EDGE_LENS]
    B, Kh, G, hd = len(lens), 2, 8, 64
    n_blocks = 1 + B * M
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((B, M), np.int32)
    i = 0
    for b, n in enumerate(lens):
        nb = -(-n // bs)
        tables[b, :nb] = perm[i:i + nb]
        i += nb
    kp, _ = _pair(rng, (n_blocks, Kh, bs, hd), cdt)
    vp, _ = _pair(rng, (n_blocks, Kh, bs, hd), cdt)
    q, _ = _pair(rng, (B, Kh * G, hd), "float32")
    bt, cl = torch.from_numpy(tables), torch.tensor(lens, dtype=torch.int32)
    kg, vg = gather_pages(kp, bt), gather_pages(vp, bt)
    paged = decode_mma_plain(q, kg, vg, cl)
    Smax = 400                               # another width than M * bs
    kd = torch.zeros((B, Kh, Smax, hd), dtype=kp.dtype)
    vd = torch.zeros((B, Kh, Smax, hd), dtype=vp.dtype)
    for b, n in enumerate(lens):
        kd[b, :, :n] = kg[b, :, :n]
        vd[b, :, :n] = vg[b, :, :n]
    assert torch.equal(decode_mma_plain(q, kd, vd, cl), paged)
    _hold(paged, paged_decode_attention_plain(q, kp, vp, bt, cl), "float32")


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 8])
def test_mma_core_geometry(hd, G):
    """Which core a call runs and the dynamic shared memory the C launcher
    checks: below hd 256 at G >= 3 (KG 4 and 8) the mma core, each warp's
    two 16-row slots (K's rows, then V's): CHUNK rows of hd x the cache's
    bytes, 64 KiB at f32 hd 128, three CTAs an SM with its static 6,468
    bytes and the 1 KiB a CTA reserves; G 1 and 2 the lane core, each
    warp's TILE rows of K and of V (2 x CHUNK rows, or CHUNK where those
    would pass 32 KiB), three CTAs an SM or more; hd 256 the cluster core.
    Every core folds the combine in, on tickets."""
    for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
        geo = dk._geometry(hd, dt, G)
        mma = dk.uses_mma(hd, G)
        assert mma == (hd < 256 and G >= 3)
        assert dk.core(hd, G) == ("decode_cluster_kernel" if hd == 256 else
                                  "decode_mma_kernel" if mma else
                                  "decode_lane_kernel")
        assert dk._tickets(8, "cpu").numel() >= 8
        if hd == 256:
            assert geo.cluster == dk.CLUSTER
            continue
        rows = CHUNK * hd * dt.itemsize
        want = rows if mma or 2 * rows > 32_768 else 2 * rows
        assert geo == (1, CHUNK, want, 0)
        assert 3 * (geo.smem + 6_468 + 1024) <= 228 * 1024
    assert dk._geometry(128, torch.float32, 8).smem == 65_536
    assert dk._geometry(128, torch.bfloat16, 4).smem == 32_768


def test_cpu_wrapper_at_g8_is_the_plain_version():
    """On the CPU the wrapper is the whole-cache plain version at G >= 3
    too (the kernel's order of sums is the mirror's, held on the card)."""
    rng = np.random.default_rng(2)
    q, _ = _pair(rng, (4, 16, 64), "float32")
    kc, _ = _pair(rng, (4, 2, 200, 64), "bfloat16")
    vc, _ = _pair(rng, (4, 2, 200, 64), "bfloat16")
    cl = torch.tensor([0, 33, 129, 200], dtype=torch.int32)
    out = decode_attention(q, kc, vc, cl)
    assert torch.equal(out, decode_attention_plain(q, kc, vc, cl))
    _hold(out, decode_mma_plain(q, kc, vc, cl), "float32")
