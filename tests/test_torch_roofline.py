"""repro_torch's per-layer roofline (launch/roofline.py) and cache sizing
against the JAX package: the FLOP and byte counts equal the reference's
exactly, and with the reference's own constants passed in, the controller's
graph and the admission cost model's prior equal the reference's.  Mirrors
the device-independent part of tests/test_roofline.py (analytic FLOPs
against a counted probe of one layer)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import get_arch as jax_arch
from repro.core.graph import build_graph as jax_build_graph
from repro.launch import roofline as R
from repro.models import kvcache as JK
from repro.serving.admission import CostModel as JaxCostModel
from repro_torch.configs.base import MIXER_MLA, LayerKind, get_arch
from repro_torch.core.graph import build_graph
from repro_torch.core.partitioner import partition
from repro_torch.launch.roofline import (H100_SXM, Chip, layer_fwd,
                                         layer_param_bytes)
from repro_torch.models import kvcache as K
from repro_torch.models.transformer import (MAX_POSITIONS, BlockCtx,
                                            apply_block, block_spec,
                                            init_block, spec_numel)
from repro_torch.serving.admission import CostModel

torch.set_num_threads(2)

ARCHS = ("qwen1.5-0.5b", "rwkv6-1.6b", "gemma3-1b", "qwen1.5-110b",
         "llama-3.2-vision-11b", "whisper-tiny", "deepseek-v2-236b")
SIZES = ("config", "smoke_config")
# the reference's constants as a Chip: its one peak serves both dtypes
REF_CHIP = Chip(hbm_bw=R.HBM_BW, flops_f32=R.PEAK_FLOPS,
                flops_bf16=R.PEAK_FLOPS, link_bw=R.ICI_BW, host_bw=R.DCN_BW,
                hbm_bytes=16 * 1024**3)
REL = 1e-12


def _cfgs(arch, size):
    return getattr(get_arch(arch), size), getattr(jax_arch(arch), size)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_fwd_counts_equal_reference(arch, size):
    cfg, jcfg = _cfgs(arch, size)
    for tok in (1, 8, 4096):
        for ctx in (1, 256, 4096):
            for T in (1, 2, 4):
                for decode in (False, True):
                    mine = layer_fwd(cfg, 0, tok, ctx, T, decode,
                                     bytes_per_el=R.BYTES)
                    ref = R.layer_fwd(jcfg, 0, tok, ctx, T, decode)
                    key = (tok, ctx, T, decode)
                    assert mine.flops == ref.flops, key
                    assert mine.hbm_bytes == ref.hbm_bytes, key
    # f32 serving moves twice the cache bytes of bf16, at equal FLOPs
    a = layer_fwd(cfg, 0, 8, 256, 1, True)
    b = layer_fwd(cfg, 0, 8, 256, 1, True, bytes_per_el=2)
    assert a.flops == b.flops and a.hbm_bytes == 2 * b.hbm_bytes


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_param_bytes_equal_reference(arch, size):
    cfg, jcfg = _cfgs(arch, size)
    for T in (1, 2):
        assert layer_param_bytes(cfg, 0, T, bytes_per_el=R.BYTES) == \
            R.layer_param_bytes(jcfg, 0, T)
    assert layer_param_bytes(cfg, 0, 1) == \
        2 * layer_param_bytes(cfg, 0, 1, bytes_per_el=2)
    total = sum(layer_param_bytes(cfg, j, 1, bytes_per_el=1)
                for j in range(cfg.n_layers))
    head = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    # whisper: the encoder's blocks and final norm, and learned positions
    extra = 0
    if cfg.encoder_layers:
        extra += (cfg.encoder_layers * spec_numel(block_spec(cfg, LayerKind()))
                  + cfg.d_model)
    if cfg.rope_theta == 0:
        extra += MAX_POSITIONS * cfg.d_model
    assert total + head + cfg.d_model + extra == cfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_build_graph_with_reference_constants_equals_reference(arch):
    cfg, jcfg = _cfgs(arch, "config")
    mine = build_graph(cfg, chip=REF_CHIP, bytes_per_el=R.BYTES)
    ref = jax_build_graph(jcfg)
    assert len(mine) == len(ref) == 2 * cfg.n_layers
    for a, b in zip(mine, ref):
        assert (a.index, a.layer, a.name, a.pattern_boundary) == \
            (b.index, b.layer, b.name, b.pattern_boundary)
        for f in ("t_c", "s_p", "s_a"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=REL), f


def test_build_graph_times_on_the_h100_by_default():
    cfg = get_arch("qwen1.5-0.5b").config
    node = build_graph(cfg)[0]
    full = layer_fwd(cfg, 0, 4096, 4096, 1, False)
    pbytes = layer_param_bytes(cfg, 0, 1)
    assert node.t_c == pytest.approx(
        0.6 * full.flops / H100_SXM.flops_f32 + 0.6 * pbytes / H100_SXM.hbm_bw,
        rel=REL)
    assert node.s_a == 4096 * cfg.d_model * 4


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_from_roofline_with_reference_constants_equals_reference(arch, size):
    cfg, jcfg = _cfgs(arch, size)
    for batch, ctx, tensor in ((1, 256, 1), (8, 256, 1), (4, 1024, 2)):
        mine = CostModel.from_roofline(cfg, batch=batch, ctx=ctx,
                                       tensor=tensor, chip=REF_CHIP,
                                       bytes_per_el=R.BYTES)
        ref = JaxCostModel.from_roofline(jcfg, batch=batch, ctx=ctx,
                                         tensor=tensor)
        for f in ("overhead_s", "prefill_s_per_token", "decode_s_per_token"):
            assert getattr(mine, f) == pytest.approx(getattr(ref, f),
                                                     rel=REL), f
        assert mine.auto is ref.auto is False


def test_from_roofline_h100_prior():
    """The card's prior for full-width qwen1.5-0.5b in f32: the same
    formula at the H100's f32 peak and HBM rate."""
    cfg = get_arch("qwen1.5-0.5b").config
    cm = CostModel.from_roofline(cfg, batch=8, ctx=256)
    dec = sum(max(c.flops / 67e12, c.hbm_bytes / 3.35e12) for c in
              (layer_fwd(cfg, j, 8, 256, 1, True)
               for j in range(cfg.n_layers)))
    head = 2 * 8 * cfg.d_model * cfg.vocab_size / 67e12
    assert cm.decode_s_per_token == pytest.approx((dec + head) / 8, rel=REL)
    assert 1e-5 < cm.decode_s_per_token < 1e-4
    assert cm.estimate(24, 8) == pytest.approx(
        24 * cm.prefill_s_per_token + 8 * cm.decode_s_per_token)


def test_chip_h100_figures():
    assert (H100_SXM.hbm_bw, H100_SXM.flops_f32, H100_SXM.flops_bf16) == \
        (3.35e12, 67e12, 989e12)
    assert (H100_SXM.link_bw, H100_SXM.host_bw, H100_SXM.hbm_bytes) == \
        (450e9, 64e9, 80e9)
    assert H100_SXM.peak_flops(4) == 67e12
    assert H100_SXM.peak_flops(2) == 989e12
    with pytest.raises(ValueError, match="1-byte"):
        H100_SXM.peak_flops(1)


def test_partition_defaults_are_the_h100s():
    nodes = build_graph(get_arch("qwen1.5-0.5b").config)
    for k in (2, 4):
        assert partition(nodes, k) == partition(
            nodes, k, bandwidth=450e9, mem_cap=80e9)
    # two stages cannot fit under a cap below half the parameters
    half = sum(n.s_p for n in nodes) / 2
    with pytest.raises(ValueError, match="infeasible"):
        partition(nodes, 2, mem_cap=half * 0.9)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_flops_match_counted_probe(arch):
    """Analytic layer FLOPs against torch's FLOP counter on one smoke
    layer's forward, in the band of tests/test_roofline.py's XLA probe.
    The plain attention computes every score (the analytic count halves
    them for causal prefill), so the probe is held against the un-halved
    count, as the reference's probe is; MLA's the same way, at its
    (nope + rope) width."""
    cfg = get_arch(arch).smoke_config
    kind = cfg.layer_kind(0)
    params = init_block(cfg, kind, torch.Generator().manual_seed(0),
                        device="cpu")
    B, S = 4, 64
    x = torch.zeros(B, S, cfg.d_model)
    # whisper's cross sub-block reads a memory as long as the sequence,
    # the context the analytic count gives it
    memory = torch.zeros(B, S, cfg.d_model) if kind.extra_cross else None
    with FlopCounterMode(display=False) as fc:
        apply_block(cfg, kind, params, x, BlockCtx(pos0=0, memory=memory))
    ana = layer_fwd(cfg, 0, B * S, S, T=1, decode=False).flops
    if kind.mixer == "attn":
        ana += 2 * 2 * (B * S) * cfg.n_heads * cfg.resolved_head_dim * S * 0.5
    if kind.mixer == MIXER_MLA:
        m = cfg.mla
        ana += 2 * 2 * (B * S) * cfg.n_heads * (m.nope_head_dim
                                                + m.rope_head_dim) * S * 0.5
    ratio = fc.get_total_flops() / ana
    assert 0.7 < ratio < 1.45, (arch, fc.get_total_flops(), ana)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_sizing_equals_reference(arch, size):
    cfg, jcfg = _cfgs(arch, size)
    for max_seq in (96, 1024):
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            for T in (1, 2):
                assert K.dense_slot_bytes(cfg, max_seq, dt, T) == \
                    JK.dense_slot_bytes(jcfg, max_seq, jdt, T)
            if K.can_page(cfg):
                for bs in (8, 16):
                    assert K.block_bytes(cfg, bs, dt) == \
                        JK.block_bytes(jcfg, bs, jdt)
            caches = K.init_cache(cfg, 2, max_seq, dt, device="meta")
            ref = JK.cache_bytes(JK.init_cache(jcfg, 2, max_seq, jdt,
                                               materialize=False))
            assert K.cache_bytes(caches) == ref
            assert K.cache_bytes(caches) == \
                2 * K.dense_slot_bytes(cfg, max_seq, dt)
    if K.can_page(cfg):
        pools = K.init_paged_cache(cfg, 9, 16, torch.float32, device="meta")
        assert K.cache_bytes(pools) == 9 * K.block_bytes(cfg, 16,
                                                          torch.float32)
