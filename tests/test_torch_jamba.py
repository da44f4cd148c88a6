"""repro_torch on jamba-v0.1-52b (Mamba-1 and attention at 7:1, MoE on
every other layer) held against the JAX package on the same converted
params: ``apply_mamba`` (prefill with and without a cache, a chain of
decode steps against one prefill), every layer kind of the Jamba block,
cache sizing, logits, decode against forward, greedy streams and engine
streams (exact-length prefill, slot reuse, refactors).  The reference's
fault replay is wrong for Mamba state; the port refuses it (ROADMAP.md,
section 3).  The MoE layer is held in test_torch_moe.py."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_arch as jax_arch
from repro.models import kvcache as JK
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models.transformer import BlockCtx as JaxCtx
from repro.models.transformer import apply_block as jax_apply_block
from repro.models.transformer import count_params as jax_count_params
from repro.models.transformer import init_model as jax_init_model
from repro.serving import engine as JE
from repro.serving import faults as JF
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs.base import MIXER_MAMBA, get_arch, shrink
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.models import kvcache as K
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.transformer import BlockCtx, apply_block, count_params
from repro_torch.serving import engine as TE
from repro_torch.serving.faults import (PREEMPT_STAGE, FaultEvent,
                                        FaultInjector, FaultPolicy,
                                        StageHealthMonitor)
from repro_torch.serving.workload import Request

torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"
JCFG = jax_arch(ARCH).smoke_config
CFG = get_arch(ARCH).smoke_config
# jitted: the reference's init, forward and greedy loop run op by op
# otherwise, which takes several times as long on the CPU
JPARAMS = jax.jit(jax_init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                    JCFG)
PARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), "cpu")
TOL = dict(atol=1e-5, rtol=1e-5)
MAMBA, ATTN = 0, 4                        # layers of the Jamba block


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(tol or TOL))


def _x(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


# ---------------------------------------------------------------------------
# sizes
# ---------------------------------------------------------------------------

def test_jamba_sizes_and_the_depth_cut():
    """The full config, and the one-block (8-layer) cut that fits one
    80 GB card in f32 at every published width."""
    full = get_arch(ARCH).config
    assert count_params(full) == jax_count_params(jax_arch(ARCH).config)
    assert count_params(full, active_only=True) == jax_count_params(
        jax_arch(ARCH).config, active_only=True)
    cut = shrink(full, n_layers=8)
    assert count_params(cut) == 13_295_235_072
    assert ssm.mamba_dims(full) == (8192, 256, 16, 4)
    assert [k.mixer for k in full.pattern].count(MIXER_MAMBA) == 7
    assert not K.can_page(full)


@pytest.mark.parametrize("size", ["config", "smoke_config"])
def test_cache_sizing_equals_reference(size):
    cfg, jcfg = getattr(get_arch(ARCH), size), getattr(jax_arch(ARCH), size)
    for max_seq in (96, 1024):
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            for T in (1, 2):
                assert K.dense_slot_bytes(cfg, max_seq, dt, T) == \
                    JK.dense_slot_bytes(jcfg, max_seq, jdt, T)
            mine = K.init_cache(cfg, 2, max_seq, dt, device="meta")
            ref = JK.init_cache(jcfg, 2, max_seq, jdt, materialize=False)
            assert [{n: tuple(t.shape) for n, t in c["mixer"].items()}
                    for c in mine] == \
                [{n: tuple(t.shape) for n, t in c["mixer"].items()}
                 for c in ref]
    with pytest.raises(NotImplementedError, match="not ported"):
        K.init_paged_cache(cfg, 9, 16, device="meta")


# ---------------------------------------------------------------------------
# apply_mamba
# ---------------------------------------------------------------------------

def _mamba_cache(B):
    di, _, N, dc = ssm.mamba_dims(CFG)
    return ({"conv": torch.zeros(B, dc - 1, di), "ssm": torch.zeros(B, di, N)},
            {"conv": jnp.zeros((B, dc - 1, di)), "ssm": jnp.zeros((B, di, N))})


@pytest.mark.parametrize("S", [1, 2, 13])
def test_mamba_prefill_matches_jax(S):
    p = PARAMS["blocks"][MAMBA]["mixer"]
    jp = JPARAMS["blocks"][MAMBA]["mixer"]
    x, jx = _x(S, (2, S, CFG.d_model))
    y, none, _ = ssm.apply_mamba(CFG, p, x)
    jy, _, _ = JS.apply_mamba(JCFG, jp, jx)
    assert none is None
    _close(y, jy)
    cache, jcache = _mamba_cache(2)
    y, cache, _ = ssm.apply_mamba(CFG, p, x, cache=cache)
    jy, jcache, _ = JS.apply_mamba(JCFG, jp, jx, cache=jcache)
    _close(y, jy)
    _close(cache["conv"], jcache["conv"])
    _close(cache["ssm"], jcache["ssm"])


@pytest.mark.parametrize("split", [0, 5])
def test_mamba_decode_chain_equals_one_prefill(split):
    """A prefill of ``split`` tokens then single-token steps against one
    prefill of all 11 (the reference's): outputs, conv history and state."""
    p = PARAMS["blocks"][MAMBA]["mixer"]
    jp = JPARAMS["blocks"][MAMBA]["mixer"]
    S = 11
    x, jx = _x(7, (2, S, CFG.d_model))
    cache, jcache = _mamba_cache(2)
    jy, jcache, _ = JS.apply_mamba(JCFG, jp, jx, cache=jcache)
    ys = []
    if split:
        y, cache, _ = ssm.apply_mamba(CFG, p, x[:, :split], cache=cache)
        ys.append(y)
    for t in range(split, S):
        y, cache, _ = ssm.apply_mamba(CFG, p, x[:, t:t + 1], cache=cache)
        ys.append(y)
    _close(torch.cat(ys, 1), jy)
    _close(cache["conv"], jcache["conv"])
    _close(cache["ssm"], jcache["ssm"])


@pytest.mark.parametrize("j", range(8))
def test_every_block_kind_matches_jax(j):
    """Each layer of the Jamba block (Mamba or attention, dense or MoE MLP)
    prefilling into a zeroed cache, then one decode step."""
    caches = K.init_cache(CFG, 2, 16, torch.float32, device="cpu",
                          layers=range(j, j + 1))
    jc = JK.init_cache(JCFG, 2, 16, jnp.float32, layers=range(j, j + 1))
    kind = CFG.layer_kind(j)
    x, jx = _x(j, (2, 9, CFG.d_model))
    y, _, a = apply_block(CFG, kind, PARAMS["blocks"][j], x,
                          BlockCtx(pos0=0, cache=caches[0]))
    jy, jnew, ja = jax_apply_block(JCFG, JCFG.layer_kind(j),
                                   JPARAMS["blocks"][j], jx,
                                   JaxCtx(pos0=0, cache=jc[0]))
    _close(y, jy)
    _close(a, ja)
    x, jx = _x(j + 10, (2, 1, CFG.d_model))
    y, _, _ = apply_block(CFG, kind, PARAMS["blocks"][j], x,
                          BlockCtx(pos0=9, cache=caches[0]))
    jy, jnew, _ = jax_apply_block(JCFG, JCFG.layer_kind(j),
                                  JPARAMS["blocks"][j], jx,
                                  JaxCtx(pos0=9, cache=jnew))
    _close(y, jy)
    for n, t in caches[0]["mixer"].items():
        _close(t, jnew["mixer"][n])


def test_cache_bridge_round_trip():
    jc = JK.init_cache(JCFG, 2, 16, jnp.float32)
    jc = jax.tree.map(lambda a: a + 1.5, jc)
    mine = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    assert set(mine[MAMBA]["mixer"]) == {"conv", "ssm"}
    assert float(mine[MAMBA]["mixer"]["ssm"].mean()) == 1.5


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_logits_match_jax():
    toks = np.random.default_rng(3).integers(0, CFG.vocab_size, (2, 24))
    lg, _, aux = M.forward(CFG, PARAMS, {"tokens": torch.from_numpy(toks)})
    jlg, _, jaux = jax.jit(JM.forward, static_argnums=0)(
        JCFG, JPARAMS, {"tokens": jnp.asarray(toks)})
    _close(lg, jlg, atol=1e-4, rtol=1e-4)
    _close(aux, jaux, atol=1e-4, rtol=1e-4)


def test_decode_matches_forward():
    """tests/test_arch_smoke.py's check, through Mamba state and the
    attention layer's cache."""
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, CFG.vocab_size, (2, 16)))
    logits, _, _ = M.forward(CFG, PARAMS, {"tokens": toks})
    _, cache = M.prefill(CFG, PARAMS, {"tokens": toks[:, :-1]}, max_seq=32,
                         cache_dtype=torch.float32)
    step, _ = M.decode_step(CFG, PARAMS, toks[:, -1:], cache, 15)
    ref = logits[:, -1, :]
    assert float((step - ref).abs().max() / (ref.abs().max() + 1e-9)) < 1e-4


def test_greedy_generate_streams_match_jax():
    toks = np.random.default_rng(4).integers(0, CFG.vocab_size, (2, 12))
    got, _ = M.greedy_generate(CFG, PARAMS, {"tokens": torch.from_numpy(toks)},
                               4, 32)
    ref, _ = jax.jit(JM.greedy_generate, static_argnums=(0, 3, 4))(
        JCFG, JPARAMS, {"tokens": jnp.asarray(toks)}, 4, 32)
    assert got.tolist() == np.asarray(ref).tolist()


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

TOKENS = 10


def _reqs(R_):
    """Four requests on two slots (two reused), two prompt lengths: the
    reference compiles one exact-length prefill per length and stage."""
    rng = np.random.default_rng(6)
    out = []
    for i, n in enumerate((9, 14, 14, 9)):
        r = R_(rid=i, arrival=0.0, prompt_len=n, max_new_tokens=TOKENS)
        r.prompt_tokens = rng.integers(0, CFG.vocab_size, n)
        out.append(r)
    return out


def _streams(eng, R_, refactors=None):
    reqs = _reqs(R_)
    for r in reqs:
        eng.submit(r, now=0.0)
    owner, hist, t = {}, {}, 0
    while eng.queue or any(not s.done for s in eng.slots):
        if refactors and t in refactors:
            ev = eng.refactor(refactors[t])
            assert ev["inflight"] > 0
            assert ev["compile_cache_hit"] and ev["new_traces"] == 0, ev
        eng.step(t * 0.05)
        for i, s in enumerate(eng.slots):
            if s.request is not None:
                owner[i] = s.request.rid
            if i in owner and s.generated:
                hist[owner[i]] = list(s.generated)
        t += 1
    assert sorted(hist) == [r.rid for r in reqs]
    return hist, reqs


def _at(cfg, cf):
    """``cfg`` at MoE capacity factor ``cf``."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _engine(boundaries, cf=None, **kw):
    ecfg = dict(max_batch=2, max_seq=32, warm_profiles=(2, 4))
    ecfg.update(kw)
    cfg = CFG if cf is None else _at(CFG, cf)
    return TE.FlexPipeEngine(cfg, PARAMS, boundaries, TE.EngineConfig(**ecfg),
                             device="cpu")


@pytest.fixture(scope="module", params=[4.0, 0.5])
def jax_streams(request):
    """The reference's streams at the smoke's capacity factor 4.0 and at
    0.5, where prefill drops assignments and the idle slot's row competes
    for capacity; (cf, streams)."""
    cf = request.param
    eng = JE.FlexPipeEngine(_at(JCFG, cf), JPARAMS, [0, 4],
                            JE.EngineConfig(max_batch=2, max_seq=32))
    assert not eng.executors.can_bucket
    return cf, _streams(eng, JaxRequest)[0]


@pytest.mark.parametrize("start,refactors", [
    ([0, 4], None),
    ([0, 4], {3: [0, 2, 4, 6], 12: [0, 4]}),           # split and back
    ([0, 2, 4, 6], {2: [0, 4]}),                       # merge
])
def test_engine_streams_match_jax(jax_streams, start, refactors):
    cf, ref = jax_streams
    streams, _ = _streams(_engine(start, cf), Request, refactors)
    assert streams == ref
    assert all(len(s) == TOKENS for s in streams.values())


def test_engine_streams_equal_forward():
    """Each stream is a whole-sequence forward's argmax, token by token:
    Mamba state carried across prefill, ticks and slot reuse."""
    streams, reqs = _streams(_engine([0, 4]), Request)
    for r in reqs:
        toks = np.concatenate([r.prompt_tokens, streams[r.rid][:-1]])
        logits, _, _ = M.forward(CFG, PARAMS,
                                 {"tokens": torch.from_numpy(toks)[None]})
        assert logits[0, r.prompt_len - 1:].argmax(-1).tolist() == \
            streams[r.rid]


def test_engine_paths_of_a_hybrid_config():
    """Exact-length prefill from a zeroed slot state, no paging, chunked
    prefill warns and falls back, as in the reference; each layer keeps its
    own kind of cache."""
    eng = _engine([0, 4])
    assert not eng.executors.can_bucket and not eng.executors.can_chunk
    assert eng.executors.prefill_bucket(9) == 9
    assert set(eng.caches[MAMBA]["mixer"]) == {"conv", "ssm"}
    assert tuple(eng.caches[ATTN]["mixer"]["k"].shape) == (2, 2, 32, 16)
    with pytest.raises(ValueError, match="attention-only"):
        _engine([0, 4], kv=TE.KVCacheConfig(paged=True, block_size=8))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng2 = _engine([0, 4], prefill=TE.PrefillConfig(chunk=16))
    assert eng2._chunk == 0
    assert any("cannot chunk" in str(w.message) for w in caught)


# ---------------------------------------------------------------------------
# the fault path: wrong in the reference for Mamba state, refused here
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [0, 1])
def test_mamba_fault_replay_diverges_in_reference_and_port_refuses(stage):
    def run(fault):
        eng = JE.FlexPipeEngine(JCFG, JPARAMS, [0, 4], JE.EngineConfig(
            max_batch=4, max_seq=64, warm_profiles=(1, 2) if fault else (),
            snapshot_interval=4))
        for i in range(3):
            eng.submit(JaxRequest(rid=i, arrival=0.0, prompt_len=12,
                                  max_new_tokens=20))
        eng._admit(0.0)
        if fault:
            eng.attach_faults(injector=JF.FaultInjector.scripted(
                [JF.FaultEvent(t=1.1, kind=JF.PREEMPT_STAGE, stage=stage)]),
                monitor=JF.StageHealthMonitor())
        for t in range(13):
            eng.fault_step((t + 1) * 0.1)
            eng.decode_step((t + 1) * 0.1)
        return [list(s.generated) for s in eng.slots][:3]

    clean, faulty = run(False), run(True)
    assert [a[:11] for a in clean] == [b[:11] for b in faulty]
    assert all(a[11:] != b[11:] for a, b in zip(clean, faulty))  # the quirk

    eng = _engine([0, 4], snapshot_interval=4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, section 3"):
        eng.attach_faults(injector=FaultInjector.scripted(
            [FaultEvent(t=1.1, kind=PREEMPT_STAGE, stage=stage)]))
    with pytest.raises(NotImplementedError, match="Mamba"):
        eng.attach_faults(monitor=StageHealthMonitor())
    with pytest.raises(NotImplementedError, match="Mamba"):
        eng._on_stage_failure([stage], 0.0)
    eng.attach_faults(policy=FaultPolicy(timeout_s=30.0))   # request-level
    reqs = [Request(rid=0, arrival=0.0, prompt_len=10, max_new_tokens=5)]
    assert eng.run(reqs).completed == 1
