"""The bf16 one-pass flash kernel's design on the CPU: its plain mirror
(``flash_wgmma_plain``: 64-key absolute tiles, the log2-domain online
softmax, P.V as bf16 hi plus bf16 lo products summed in f32) held within
one bf16 ulp or 5e-3 of ``flash_attention_plain`` and of the Pallas kernel
in interpret mode, on seeded bf16 inputs at (16, 16), (32, 32), (64, 64),
(128, 128) and (192, 128); its chunked calls bit-identical to one call; and
the launch
geometry (``_geometry``) the C launcher checks.  The CUDA kernel that runs this
design (``flash_wgmma_kernel``) is held to the same mirror in
test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as pl_flash
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels.flash_attention import (
    TILE_K, TILE_Q, WG_ALIGN, WG_STAGES, flash_attention_plain,
    flash_wgmma_plain, wg_stages)

torch.set_num_threads(2)

BF16_TOL = 5e-3
PAIRS = [(16, 16), (32, 32), (64, 64), (128, 128), (192, 128)]


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


@pytest.mark.parametrize("hd,hdv", PAIRS)
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


@pytest.mark.parametrize("hd,hdv", PAIRS)
@pytest.mark.parametrize("window", [0, 40])
def test_flash_wgmma_mirror_chunked_equal_whole(hd, hdv, window):
    """A prompt's rows computed chunk by chunk (Sq = chunk, q_offset = c0,
    Skv = the whole prompt) equal one call bit for bit: the tiles are
    absolute, and the extra tiles a chunk walks add exact zeros at an exact
    scale of 1."""
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
    """The kernel takes each row's max on the unscaled scores, which only a
    positive scale keeps: the wrapper's checks (run on meta tensors as for
    the card) refuse any other at bf16, hd <= 128 and (192, 128), and take
    it at f32 and at the bf16 span pair (256, 256)."""
    def meta(dt, hd, Kh=2, hdv=None):
        return (torch.empty((1, 8, 4, hd), dtype=dt, device="meta"),
                torch.empty((1, 8, Kh, hd), dtype=dt, device="meta"),
                torch.empty((1, 8, Kh, hdv or hd), dtype=dt, device="meta"))
    for hd, hdv in PAIRS:
        with pytest.raises(ValueError, match="scale > 0"):
            fk.flash_attention(*meta(torch.bfloat16, hd, hdv=hdv),
                               scale=-0.125)
        assert fk.flash_attention(*meta(torch.bfloat16, hd,
                                        hdv=hdv)).shape == (1, 8, 4, hdv)
        assert fk.flash_attention(*meta(torch.float32, hd, hdv=hdv),
                                  scale=-0.125).shape == (1, 8, 4, hdv)
    assert fk.flash_attention(*meta(torch.bfloat16, 256),
                              scale=-0.125).shape == (1, 8, 4, 256)
