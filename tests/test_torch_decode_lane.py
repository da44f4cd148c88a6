"""The lane decode core (``decode_lane_kernel``, hd <= 128 at G = H / Kh
<= 2) on the CPU: its launch geometry (each warp's 32 rows of K and of V in
shared memory, or V in K's rows where both would pass 32 KiB), and its
order of sums, ``decode_mma_plain`` (each warp's 32-key tile's softmax
state, the tiles merged in tile order, then the chunk combine), at
qwen1.5-0.5b's decode shape against the whole-cache plain version over
every (q, cache) pair; dead rows holding NaN; paged equal to dense bit for
bit; and the CPU wrapper at G 1 and 2 being the plain version.  The mirror
is held against the Pallas kernel in interpret mode at G 1 and 2 in
test_torch_decode_mma.py, and the kernel against the mirror on the card in
test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels.decode_attention import (
    CHUNK, TILE, decode_attention, decode_attention_plain, decode_mma_plain,
    gather_pages, paged_decode_attention, paged_decode_attention_plain)
from test_torch_decode_mma import EDGE_LENS, _hold

torch.set_num_threads(2)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8_e4m3fn": torch.float8_e4m3fn}
# qwen1.5-0.5b's ragged decode lengths in chip_smoke.py (B 8, Smax 1024)
QWEN_LENS = [1024, 1, 17, 512, 600, 333, 1000, 64]


def _rand(rng, shape, dt):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(DTYPES[dt])


def _pools(rng, lens, Kh, hd, bs, M, dt):
    """Pools holding each slot's live blocks at shuffled ids (null entries
    elsewhere), and their tables."""
    B = len(lens)
    n_blocks = 1 + B * M
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((B, M), np.int32)
    i = 0
    for b, n in enumerate(lens):
        nb = -(-n // bs)
        tables[b, :nb] = perm[i:i + nb]
        i += nb
    return (_rand(rng, (n_blocks, Kh, bs, hd), dt),
            _rand(rng, (n_blocks, Kh, bs, hd), dt), torch.from_numpy(tables))


@pytest.mark.parametrize("hd,dt,smem", [
    (64, torch.bfloat16, 32_768), (64, torch.float32, 32_768),
    (64, torch.float8_e4m3fn, 16_384), (128, torch.bfloat16, 32_768),
    (128, torch.float32, 65_536), (128, torch.float8_e4m3fn, 32_768),
    (16, torch.float32, 16_384), (32, torch.bfloat16, 16_384)])
@pytest.mark.parametrize("G", [1, 2])
def test_lane_core_geometry(hd, dt, smem, G):
    """The lane core's dynamic shared memory (lane_smem in the .cu): each
    warp's TILE rows of K and of V, 2 x CHUNK rows of hd x the cache's
    bytes, up to 32 KiB (six CTAs an SM); past that (f32 at hd 64 and 128,
    bf16 at hd 128) CHUNK rows, V staged into K's once S has read them.
    One CTA per chunk, any chunk count (the fold walks the chunks in
    groups), and a ticket per (slot, kv head), zeroed."""
    assert dk.core(hd, G) == "decode_lane_kernel"
    assert not dk.uses_mma(hd, G)
    geo = dk._geometry(hd, dt, G)
    assert geo == (1, CHUNK, smem, 0)
    assert TILE * 4 == CHUNK
    t = dk._tickets(8 * 16 * geo.cluster, "cpu")
    assert t.dtype == torch.int32 and t.numel() >= 8 * 16
    assert not bool(t.any())


@pytest.mark.parametrize("hd,G,want", [(64, 1, 1), (64, 4, 1), (128, 8, 1),
                                       (256, 1, 4), (256, 8, 4)])
def test_tickets_per_core(hd, G, want):
    """Every core folds the combine in on tickets: the lane and mma cores
    one per (slot, kv head), the cluster core one per (slot, kv head,
    cluster rank); the wrapper sizes them by the geometry's cluster."""
    geo = dk._geometry(hd, torch.float32, G)
    assert geo.cluster == want
    t = dk._tickets(8 * 2 * geo.cluster, "cpu")
    assert t.numel() >= 8 * 2 * want and not bool(t.any())


@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cdt", list(DTYPES))
def test_lane_mirror_at_qwen_shape(qdt, cdt):
    """qwen1.5-0.5b's decode call (hd 64, G = 1, its ragged lengths over
    Smax 1024; 2 of its 16 kv heads) through the lane core's order of sums
    against the whole-cache plain version: 3e-5 for an f32 query, one bf16
    ulp or 5e-3 for a bf16 one, over every cache."""
    rng = np.random.default_rng(34)
    B, H, Kh, hd, Smax = 8, 2, 2, 64, 1024
    q = _rand(rng, (B, H, hd), qdt)
    kc, vc = _rand(rng, (B, Kh, Smax, hd), cdt), _rand(rng, (B, Kh, Smax,
                                                              hd), cdt)
    cl = torch.tensor(QWEN_LENS, dtype=torch.int32)
    out = decode_mma_plain(q, kc, vc, cl)
    assert out.dtype == q.dtype and out.shape == (B, H, hd)
    _hold(out, decode_attention_plain(q, kc, vc, cl), qdt)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_lane_mirror_dead_rows_hold_nan(G, hd):
    """Rows at or past cache_len may hold anything, NaN included: the lane
    core neither stages nor reads them, and its mirror gives the same bits
    whatever they hold."""
    rng = np.random.default_rng(G + hd)
    B, Kh, Smax = len(EDGE_LENS), 3, 300
    q = _rand(rng, (B, Kh * G, hd), "bfloat16")
    kc = _rand(rng, (B, Kh, Smax, hd), "bfloat16")
    vc = _rand(rng, (B, Kh, Smax, hd), "bfloat16")
    cl = torch.tensor(EDGE_LENS, dtype=torch.int32)
    clean = decode_mma_plain(q, kc, vc, cl)
    for b, n in enumerate(EDGE_LENS):
        kc[b, :, n:] = float("nan")
        vc[b, :, n:] = float("nan")
    assert torch.equal(decode_mma_plain(q, kc, vc, cl), clean)
    assert torch.equal(clean[0], torch.zeros_like(clean[0]))  # empty slot


@pytest.mark.parametrize("cdt", list(DTYPES))
@pytest.mark.parametrize("bs,M", [(16, 20), (32, 10), (16, 19)])
@pytest.mark.parametrize("G", [1, 2])
def test_lane_mirror_paged_equals_dense(cdt, bs, M, G):
    """At G 1 and 2, a paged cache through gather_pages and a dense cache of
    another width holding the same live rows give the same bits: tiles and
    chunks are logical positions, whatever the block size."""
    rng = np.random.default_rng(bs + M + G)
    lens = [min(n, M * bs) for n in EDGE_LENS]
    B, Kh, hd = len(lens), 2, 64
    kp, vp, bt = _pools(rng, lens, Kh, hd, bs, M, cdt)
    q = _rand(rng, (B, Kh * G, hd), "float32")
    cl = torch.tensor(lens, dtype=torch.int32)
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


@pytest.mark.parametrize("G", [1, 2])
def test_cpu_wrappers_at_g1_and_g2_are_the_plain_versions(G):
    """On the CPU the wrappers are the plain versions at G 1 and 2 too; the
    lane core's order of sums (the mirror) holds against them."""
    rng = np.random.default_rng(5 + G)
    lens = [0, 33, 129, 200]
    B, Kh, hd, bs, M = len(lens), 2, 32, 16, 13
    q = _rand(rng, (B, Kh * G, hd), "bfloat16")
    kc = _rand(rng, (B, Kh, 200, hd), "float8_e4m3fn")
    vc = _rand(rng, (B, Kh, 200, hd), "float8_e4m3fn")
    cl = torch.tensor(lens, dtype=torch.int32)
    out = decode_attention(q, kc, vc, cl)
    assert torch.equal(out, decode_attention_plain(q, kc, vc, cl))
    _hold(out, decode_mma_plain(q, kc, vc, cl), "bfloat16")
    kp, vp, bt = _pools(rng, lens, Kh, hd, bs, M, "float8_e4m3fn")
    paged = paged_decode_attention(q, kp, vp, bt, cl)
    assert torch.equal(paged, paged_decode_attention_plain(q, kp, vp, bt,
                                                           cl))
