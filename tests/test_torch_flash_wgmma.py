"""The bf16 flash kernels' design on the CPU: their plain mirror
(``flash_wgmma_plain``: 64-key absolute tiles, the log2-domain online
softmax, P.V as bf16 hi plus bf16 lo products summed in f32; at (256, 256)
the same walk per 128-key span of ``span_plan``, merged by
``flash_combine_plain``) held within one bf16 ulp or 5e-3 of
``flash_attention_plain`` and of the Pallas kernel in interpret mode, on
seeded bf16 inputs at (16, 16), (32, 32), (64, 64), (128, 128), (192, 128)
and (256, 256); its chunked calls bit-identical to one call; and the launch
geometry (``_geometry``) the C launcher checks.  The CUDA kernels that run
these designs (``flash_wgmma_kernel``, and ``flash_wgspan_kernel`` at
(256, 256)) are held to the same mirror in test_torch_cuda.py and
chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as pl_flash
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels.flash_attention import (
    SPAN, TILE_K, TILE_Q, WG_ALIGN, WG_STAGES, flash_attention_plain,
    flash_combine_plain, flash_partials_plain, flash_wgmma_plain, span_plan,
    wg_span_smem, wg_stages)

torch.set_num_threads(2)

BF16_TOL = 5e-3
# the one-pass pairs (flash_wgmma_kernel), then the span pair
# (flash_wgspan_kernel)
PAIRS = [(16, 16), (32, 32), (64, 64), (128, 128), (192, 128)]
ALL_PAIRS = PAIRS + [(256, 256)]


def _bf16(rng, *shape):
    """Seeded normal draws rounded to bf16, as numpy f32 and torch bf16."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16)
    return t.float().numpy(), t


def _ulp(x):
    """One bf16 ulp at each |x| (normal range)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _within_ulp(got, want, what):
    """Every element of ``got`` within one bf16 ulp of ``want`` or
    BF16_TOL (a flip of the final rounding, which two summation orders
    cannot rule out, may exceed 5e-3 at |out| >= 1)."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    over = d > torch.clamp(_ulp(want), min=BF16_TOL)
    assert not bool(over.any()), (
        f"{what}: {int(over.sum())} of {got.numel()} elements beyond one bf16 "
        f"ulp or {BF16_TOL}; max |d| {float(d.max()):.3e}")


@pytest.mark.parametrize("hd,hdv", ALL_PAIRS)
@pytest.mark.parametrize("Sq,Skv,H,Kh,causal,window,q_offset", [
    (130, 130, 4, 4, True, 0, None),       # causal, end-aligned, off tile
    (130, 130, 4, 4, True, 40, None),      # windowed
    (70, 150, 4, 4, False, 0, None),       # full (non-causal)
    (70, 200, 4, 4, True, 0, 100),         # q_offset, Sq and Skv off tile
    (65, 65, 8, 2, True, 8, None),         # GQA 4, a window
])
def test_flash_wgmma_mirror_vs_plain_and_pallas(hd, hdv, Sq, Skv, H, Kh,
                                                causal, window, q_offset):
    rng = np.random.default_rng(hd + Sq + Skv + window + H)
    (nq, q), (nk, k), (nv, v) = (_bf16(rng, 1, Sq, H, hd),
                                 _bf16(rng, 1, Skv, Kh, hd),
                                 _bf16(rng, 1, Skv, Kh, hdv))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = flash_wgmma_plain(q, k, v, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == (1, Sq, H, hdv)
    _within_ulp(out, flash_attention_plain(q, k, v, **kw),
                "mirror vs flash_attention_plain")
    pallas = pl_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (nq, nk, nv)),
                      block_q=64, block_k=64, **kw)
    _within_ulp(out, torch.from_numpy(np.asarray(pallas, np.float32)),
                "mirror vs the Pallas kernel (interpret mode)")


@pytest.mark.parametrize("hd,hdv", ALL_PAIRS)
@pytest.mark.parametrize("window", [0, 40])
def test_flash_wgmma_mirror_chunked_equal_whole(hd, hdv, window):
    """A prompt's rows computed chunk by chunk (Sq = chunk, q_offset = c0,
    Skv = the whole prompt) equal one call bit for bit: the tiles (and at
    (256, 256) the spans) are absolute, and the extra tiles a chunk walks
    add exact zeros at an exact scale of 1."""
    rng = np.random.default_rng(hd + window)
    Sp, H, Kh = 200, 4, 2
    _, q = _bf16(rng, 1, Sp, H, hd)
    _, k = _bf16(rng, 1, Sp, Kh, hd)
    _, v = _bf16(rng, 1, Sp, Kh, hdv)
    kw = dict(causal=True, window=window)
    whole = flash_wgmma_plain(q, k, v, q_offset=0, **kw)
    for chunk in (16, 64, 128):
        parts = [flash_wgmma_plain(q[:, c0:c0 + chunk].contiguous(), k, v,
                                   q_offset=c0, **kw)
                 for c0 in range(0, Sp, chunk)]
        assert torch.equal(torch.cat(parts, 1), whole), chunk


def test_flash_wgmma_mirror_rows_without_keys():
    """Rows that see no key (q_offset < 0) come out as exact zeros, as the
    kernel writes them (l = 0, O = 0)."""
    rng = np.random.default_rng(5)
    _, q = _bf16(rng, 1, 100, 4, 64)
    _, k = _bf16(rng, 1, 40, 4, 64)
    _, v = _bf16(rng, 1, 40, 4, 64)
    out = flash_wgmma_plain(q, k, v, q_offset=-70)
    assert torch.equal(out[:, :70], torch.zeros_like(out[:, :70]))
    _within_ulp(out, flash_attention_plain(q, k, v, q_offset=-70),
                "mirror vs flash_attention_plain")


@pytest.mark.parametrize("hd,hdv", PAIRS)
def test_flash_wgmma_geometry(hd, hdv):
    """wg_smem_bytes: the tiles' start rounded up to a 1024-byte swizzle
    boundary, Q's 64 rows and a wg_stages(hd)-deep ring of 64-key K and V
    tiles, all unpadded bf16 rows: at (64, 64) 58,368 B, so three CTAs
    share an SM's 228 KB (wg_min_ctas); at (128, 128) 115,712 B, so two
    fill it exactly, with each CTA's 1 KB reserve; at (192, 128) a 2-stage
    ring, 107,520 B, so two share it, where a 3-stage ring (148,480 B)
    would leave one."""
    geo = fk._geometry(hd, hdv, torch.bfloat16)
    assert geo.tile == TILE_K == 64 and geo.span == 0
    assert not fk.is_span(hd, hdv, torch.bfloat16)
    assert wg_stages(hd) == (2 if hd == 192 else WG_STAGES)
    assert geo.smem == WG_ALIGN + 2 * (TILE_Q * hd
                                       + wg_stages(hd) * TILE_K * (hd + hdv))
    ctas = 3 if hd <= 64 else 2
    assert ctas * (geo.smem + 1024) <= 228 * 1024
    if hd == 128:
        assert geo.smem == 115_712
        assert 2 * (geo.smem + 1024) == 228 * 1024
    if hd == 192:
        assert geo.smem == 107_520
        three = WG_ALIGN + 2 * (TILE_Q * hd + 3 * TILE_K * (hd + hdv))
        assert three == 148_480 and 2 * (three + 1024) > 228 * 1024


def test_flash_wgmma_refuses_nonpositive_scale():
    """The bf16 kernels take each row's max on the unscaled scores, which
    only a positive scale keeps: the wrapper's checks (run on meta tensors
    as for the card) refuse any other at bf16 and every pair (the span pair
    (256, 256) too, since flash_wgspan_kernel), and take it at f32."""
    def meta(dt, hd, Kh=2, hdv=None):
        return (torch.empty((1, 8, 4, hd), dtype=dt, device="meta"),
                torch.empty((1, 8, Kh, hd), dtype=dt, device="meta"),
                torch.empty((1, 8, Kh, hdv or hd), dtype=dt, device="meta"))
    for hd, hdv in ALL_PAIRS:
        with pytest.raises(ValueError, match="scale > 0"):
            fk.flash_attention(*meta(torch.bfloat16, hd, hdv=hdv),
                               scale=-0.125)
        assert fk.flash_attention(*meta(torch.bfloat16, hd,
                                        hdv=hdv)).shape == (1, 8, 4, hdv)
        assert fk.flash_attention(*meta(torch.float32, hd, hdv=hdv),
                                  scale=-0.125).shape == (1, 8, 4, hdv)


def test_flash_wgspan_geometry():
    """bf16 (256, 256) runs the span plan on wgmma: 64-key tiles, 128-key
    spans, and wgspan_smem_bytes: the tiles' start rounded up to a
    1024-byte swizzle boundary, Q's 64 rows (32,768 B) and both tiles of a
    span's K and V (131,072 B), 164,864 B, one CTA an SM (two would need
    331,776 B with their reserves); f32 keeps the span kernel's
    geometry."""
    geo = fk._geometry(256, 256, torch.bfloat16)
    assert fk.is_span(256, 256, torch.bfloat16)
    assert geo == (TILE_K, SPAN, wg_span_smem(256, 256)) == (64, 128,
                                                             164_864)
    assert geo.smem == WG_ALIGN + 2 * (TILE_Q * 256 + SPAN * 512)
    assert geo.smem <= 227 * 1024 < 2 * (geo.smem + 1024)
    assert SPAN // TILE_K == 2          # the kernel's four commit groups
    assert fk._geometry(256, 256, torch.float32) == (32, SPAN, 210_944)


@pytest.mark.parametrize("Sq,Skv,window,q_offset,want", [
    (571, 571, 0, None, 25),            # gemma3-1b's global layer
    (571, 571, 512, None, 25),          # its local layer (window 512)
    (128, 571, 0, 443, 9),              # a 128-row chunk at the end
    (1, 571, 512, None, 5),             # one row over a window
    (200, 200, 40, None, 5),            # a narrow window
])
def test_flash_wgspan_items(Sq, Skv, window, q_offset, want):
    """The CTAs flash_wgspan_kernel launches per b*h: one per (query
    tile, span) of span_plan (count_items in the launcher), each walking
    one or two 64-key tiles of its span; gemma3-1b's 571-token prompt
    gives 25 per head at both of its layer kinds, 100 CTAs on its 4
    heads, fewer than the card's 132 SMs."""
    _, _, ctas = span_plan(Sq, Skv, window=window, q_offset=q_offset)
    assert len(ctas) == want
    qo = Skv - Sq if q_offset is None else q_offset
    for qt, s in ctas:
        q0, last = qt * TILE_Q, min((qt + 1) * TILE_Q, Sq) - 1
        lo = max(0, qo + q0 - window + 1) if window else 0
        hi = min(Skv, qo + last + 1)
        a, e = max(lo, s * SPAN), min(hi, (s + 1) * SPAN)
        assert a < e
        assert 1 <= len(range(a // TILE_K * TILE_K, e, TILE_K)) \
            <= SPAN // TILE_K


@pytest.mark.parametrize("window", [0, 40])
def test_flash_wgspan_mirror_vs_span_partials(window):
    """At (256, 256) the mirror's split is the span plan's: its output
    lies within one bf16 ulp or 5e-3 of the f32 span design's plain passes
    (flash_partials_plain merged by flash_combine_plain) on the same bf16
    inputs, GQA 4 on 1, as gemma3-1b's heads."""
    rng = np.random.default_rng(11 + window)
    _, q = _bf16(rng, 1, 200, 4, 256)
    _, k = _bf16(rng, 1, 200, 1, 256)
    _, v = _bf16(rng, 1, 200, 1, 256)
    kw = dict(causal=True, window=window, q_offset=0)
    m, l, acc = flash_partials_plain(q, k, v, **kw)
    ref = flash_combine_plain(m, l, acc, Skv=200, dtype=torch.bfloat16, **kw)
    _within_ulp(flash_wgmma_plain(q, k, v, **kw), ref,
                "mirror vs the span passes")
