"""repro_torch's multi-head latent attention (MLA) and deepseek-v2-236b held
against the JAX package on the same converted params: the config, param
counts, the cache layout, ``apply_mla`` (prefill through flash, decode in
the absorbed form at one scalar position, and per-slot decode, each row
against the reference's layer run on that row alone), logits, greedy
streams, and the engine's streams against the reference's per-request
loop (``prefill`` then ``decode_step``), since the reference's engine
cannot decode MLA (ROADMAP.md, section 3).  The engine buckets MLA
prompts, does not chunk or page them, and keeps the Eq. 10 fault path:
after a lost stage every stream equals the run with no fault."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_arch as jax_arch
from repro.models import kvcache as JK
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.transformer import count_params as jax_count_params
from repro.models.transformer import init_model as jax_init_model
from repro_torch.configs.base import MIXER_MLA, get_arch
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.models import kvcache as K
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.transformer import count_params
from repro_torch.serving import engine as TE
from repro_torch.serving.faults import (PREEMPT_STAGE, FaultEvent,
                                        FaultInjector, StageHealthMonitor)
from repro_torch.serving.workload import Request

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
CFG, JCFG = get_arch(ARCH).smoke_config, jax_arch(ARCH).smoke_config
TOL = dict(atol=1e-5, rtol=1e-5)
_PARAMS: dict = {}


def _params():
    """The reference's init (seed 0), jitted, and its conversion."""
    if not _PARAMS:
        jp = jax.jit(jax_init_model, static_argnums=1)(
            jax.random.PRNGKey(0), JCFG)
        _PARAMS["p"] = (params_from_numpy(jax.tree.map(np.asarray, jp),
                                          "cpu"), jp)
    return _PARAMS["p"]


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(tol or TOL))


def _mixer(layer=1):
    params, jparams = _params()
    return params["blocks"][layer]["mixer"], jparams["blocks"][layer]["mixer"]


def _x(seed, B, S):
    return np.random.default_rng(seed).standard_normal(
        (B, S, CFG.d_model)).astype(np.float32)


def _cache(seed, B, Smax):
    """Random latent and k_rope rows (rows a decode must not read hold
    numbers too, so a wrong mask shows)."""
    rng = np.random.default_rng(seed)
    m = CFG.mla
    return {"latent": rng.standard_normal(
                (B, Smax, m.kv_lora_rank)).astype(np.float32),
            "k_rope": rng.standard_normal(
                (B, Smax, m.rope_head_dim)).astype(np.float32)}


# ---------------------------------------------------------------------------
# config, params, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["config", "smoke_config"])
def test_config_matches_reference(size):
    mine = dataclasses.asdict(getattr(get_arch(ARCH), size))
    ref = dataclasses.asdict(getattr(jax_arch(ARCH), size))
    assert mine == ref
    assert mine["mla"] is not None and mine["pattern"][0]["mixer"] == \
        MIXER_MLA


@pytest.mark.parametrize("size", ["config", "smoke_config"])
@pytest.mark.parametrize("active_only", [False, True])
def test_count_params_equal_reference(size, active_only):
    cfg, jcfg = getattr(get_arch(ARCH), size), getattr(jax_arch(ARCH), size)
    n = count_params(cfg, active_only=active_only)
    assert n == jax_count_params(jcfg, active_only=active_only)
    if size == "config" and not active_only:
        assert n == 239_375_569_920


def test_param_tree_matches_reference():
    params, jparams = _params()
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == sum(1 for _ in _walk(params))
    for path, leaf in flat:
        t = params
        for k in path:
            t = t[k.key if hasattr(k, "key") else k.idx]
        assert tuple(t.shape) == tuple(leaf.shape), path


def _walk(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _walk(v)
    else:
        yield tree


def test_cache_layout_matches_reference():
    for i in range(CFG.n_layers):
        mine = K.layer_shapes(CFG, i, 3, 40)
        ref = JK.layer_cache_struct(JCFG, i, 3, 40)
        assert {p: {n: tuple(s) for n, s in leaves.items()}
                for p, leaves in mine.items()} == \
            {p: {n: tuple(s.shape) for n, s in leaves.items()}
             for p, leaves in ref.items()}
    caches = K.init_cache(CFG, 2, 16, torch.float32, device="cpu")
    assert set(caches[0]["mixer"]) == {"latent", "k_rope"}
    assert not K.can_page(CFG)
    assert K.dense_slot_bytes(CFG, 64, torch.float32) == \
        CFG.n_layers * 64 * (CFG.mla.kv_lora_rank
                             + CFG.mla.rope_head_dim) * 4


# ---------------------------------------------------------------------------
# apply_mla
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 9, 37])
@pytest.mark.parametrize("with_cache", [False, True])
def test_apply_mla_prefill_matches_jax(S, with_cache):
    """A prompt through the flash path; with a cache, rows [0, S) written
    and the rest left as they were."""
    p, jp = _mixer()
    x = _x(S, 2, S)
    cache = jcache = None
    if with_cache:
        c = _cache(1, 2, 48)
        cache, jcache = cache_from_numpy(c, "cpu"), jax.tree.map(jnp.asarray,
                                                                 c)
    y, cache, _ = L.apply_mla(CFG, p, torch.from_numpy(x), pos0=0,
                              cache=cache)
    jy, jcache, _ = JL.apply_mla(JCFG, jp, jnp.asarray(x), pos0=0,
                                 cache=jcache)
    _close(y, jy)
    if with_cache:
        for name in ("latent", "k_rope"):
            _close(cache[name], jcache[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 13, 47])
def test_apply_mla_decode_matches_jax(pos, dtype):
    """One token at a scalar position through the absorbed decode over the
    latent cache (rows past ``pos`` hold numbers and must be masked)."""
    p, jp = _mixer()
    x = _x(100 + pos, 3, 1)
    c = _cache(pos, 3, 48)
    tdt = getattr(torch, dtype)
    cache = cache_from_numpy(c, "cpu", tdt)
    jcache = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), c)
    y, cache, _ = L.apply_mla(CFG, p, torch.from_numpy(x), pos0=pos,
                              cache=cache)
    jy, jcache, _ = JL.apply_mla(JCFG, jp, jnp.asarray(x), pos0=pos,
                                 cache=jcache)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    _close(y, jy, **tol)
    for name in ("latent", "k_rope"):
        assert cache[name].dtype == tdt
        _close(cache[name].float(), np.asarray(jcache[name], np.float32),
               **tol)


@pytest.mark.parametrize("positions", [(2, 9, 15), (47, 0, 30)])
def test_apply_mla_per_slot_decode_equals_reference_rows(positions):
    """A B = 3 batch at three positions (a (B,) tensor, as the engine's
    decode tick passes) equals, row by row, the reference's layer run on
    that row alone at its scalar position: the output and every cache
    row."""
    p, jp = _mixer(2)
    x = _x(7, 3, 1)
    c = _cache(8, 3, 48)
    cache = cache_from_numpy(c, "cpu")
    y, cache, _ = L.apply_mla(CFG, p, torch.from_numpy(x),
                              pos0=torch.tensor(positions), cache=cache)
    for b, pos in enumerate(positions):
        row = jax.tree.map(lambda a: jnp.asarray(a[b:b + 1]), c)
        jy, jc, _ = JL.apply_mla(JCFG, jp, jnp.asarray(x[b:b + 1]),
                                 pos0=pos, cache=row)
        _close(y[b:b + 1], jy)
        for name in ("latent", "k_rope"):
            _close(cache[name][b:b + 1], jc[name])


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def test_forward_logits_match_jax():
    params, jparams = _params()
    toks = np.random.default_rng(3).integers(0, CFG.vocab_size, (2, 24))
    lg, _, aux = M.forward(CFG, params, {"tokens": torch.from_numpy(toks)})
    jlg, _, jaux = jax.jit(JM.forward, static_argnums=0)(
        JCFG, jparams, {"tokens": jnp.asarray(toks)})
    _close(lg, jlg, atol=1e-4, rtol=1e-4)
    _close(aux, jaux, atol=1e-4, rtol=1e-4)


def test_decode_matches_forward():
    """A prefill of all but the last token, then one absorbed decode step,
    against the whole forward (flash over the materialized K/V)."""
    params, _ = _params()
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, CFG.vocab_size, (2, 16)))
    logits, _, _ = M.forward(CFG, params, {"tokens": toks})
    _, cache = M.prefill(CFG, params, {"tokens": toks[:, :-1]}, max_seq=32,
                         cache_dtype=torch.float32)
    step, _ = M.decode_step(CFG, params, toks[:, -1:], cache, 15)
    ref = logits[:, -1, :]
    assert float((step - ref).abs().max() / (ref.abs().max() + 1e-9)) < 1e-4


@pytest.mark.parametrize("seed,shape,steps", [(0, (2, 7), 5),
                                              (4, (2, 12), 6)])
def test_greedy_generate_streams_match_jax(seed, shape, steps):
    params, jparams = _params()
    toks = np.random.default_rng(seed).integers(0, CFG.vocab_size, shape)
    got, _ = M.greedy_generate(CFG, params, {"tokens": torch.from_numpy(toks)},
                               steps, 32)
    ref, _ = jax.jit(JM.greedy_generate, static_argnums=(0, 3, 4))(
        JCFG, jparams, {"tokens": jnp.asarray(toks)}, steps, 32)
    assert got.tolist() == np.asarray(ref).tolist()
    if seed == 0:
        assert got.tolist() == [[32, 59, 363, 394, 387],
                                [352, 325, 360, 265, 458]]


# ---------------------------------------------------------------------------
# the engine against the reference's per-request loop
# ---------------------------------------------------------------------------

N_REQ, TOKENS, MAX_SEQ = 6, 8, 128
_JAX_STREAMS: dict = {}


def _requests(staggered):
    """Six requests with 30-61-token prompts; staggered, one arrives every
    two ticks, so slots are reused while others decode."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(N_REQ):
        r = Request(rid=i, arrival=0.1 * i if staggered else 0.0,
                    prompt_len=int(rng.integers(30, 62)),
                    max_new_tokens=TOKENS)
        r.prompt_tokens = rng.integers(0, CFG.vocab_size, r.prompt_len)
        out.append(r)
    return out


def _jax_streams():
    """Each request alone through the reference: ``prefill`` at its exact
    length into an f32 cache, then ``decode_step`` at scalar positions."""
    if not _JAX_STREAMS:
        _, jparams = _params()
        prefill = jax.jit(JM.prefill, static_argnums=(0, 3, 4))
        step = jax.jit(JM.decode_step, static_argnums=0)
        for r in _requests(False):
            last, cache = prefill(JCFG, jparams,
                                  {"tokens": jnp.asarray(r.prompt_tokens)[None]},
                                  MAX_SEQ, jnp.float32)
            tok = jnp.argmax(last, axis=-1)[:, None]
            out = []
            for j in range(TOKENS):
                out.append(int(tok[0, 0]))
                logits, cache = step(JCFG, jparams, tok, cache,
                                     jnp.int32(r.prompt_len + j))
                tok = jnp.argmax(logits, axis=-1)[:, None]
            _JAX_STREAMS[r.rid] = out
    return _JAX_STREAMS


def _serve(*, staggered=False, refactors=None, fault_tick=None,
           max_batch=4, chunk=0, **ecfg_kw):
    params, _ = _params()
    ecfg = TE.EngineConfig(
        max_batch=max_batch, max_seq=MAX_SEQ, warm_profiles=(1, 2, 4),
        snapshot_interval=4 if fault_tick is not None else 0,
        prefill=TE.PrefillConfig(chunk=chunk), **ecfg_kw)
    eng = TE.FlexPipeEngine(CFG, params, [0, 2], ecfg, device="cpu")
    if fault_tick is not None:
        eng.attach_faults(injector=FaultInjector.scripted(
            [FaultEvent(t=fault_tick * 0.05, kind=PREEMPT_STAGE, stage=1)]),
            monitor=StageHealthMonitor())
    reqs = _requests(staggered)
    pending = list(reqs)
    t = 0
    while pending or eng.queue or any(not s.done for s in eng.slots):
        now = t * 0.05
        while pending and pending[0].arrival <= now + 1e-9:
            eng.submit(pending.pop(0), now=now)
        if refactors and t in refactors:
            ev = eng.refactor(refactors[t])
            assert ev["compile_cache_hit"] and ev["new_traces"] == 0, ev
        eng.step(now)
        t += 1
        assert t < 500
    assert all(len(r.output) == TOKENS for r in reqs)
    return {r.rid: list(r.output) for r in reqs}, eng


MOVES = {2: [0, 1, 2, 3], 5: [0, 2], 8: [0]}
RUNS = {  # label: engine options
    "together": {},
    "together refactored": dict(refactors=MOVES),
    "staggered, slots reused": dict(staggered=True, max_batch=3),
    "staggered refactored": dict(staggered=True, max_batch=3,
                                 refactors=MOVES),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_engine_streams_match_jax_per_request_loop(run):
    got, eng = _serve(**RUNS[run])
    assert got == _jax_streams()
    if "refactors" in RUNS[run]:
        assert len(eng.refactor_events) == len(MOVES)


def test_engine_buckets_and_neither_chunks_nor_pages():
    """Bucketed prefill is on (the latent rows past a prompt are masked
    by position); chunked prefill falls back to whole prompts with a
    warning, as in the reference; the paged layout refuses MLA."""
    params, _ = _params()
    eng = TE.FlexPipeEngine(CFG, params, [0, 2],
                            TE.EngineConfig(max_batch=2, max_seq=64),
                            device="cpu")
    assert eng.executors.can_bucket and not eng.executors.can_chunk
    assert eng.executors.prefill_bucket(37) == 64
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got, eng = _serve(chunk=16)
    assert any("cannot chunk" in str(x.message) for x in w)
    assert eng._chunk == 0
    assert got == _jax_streams()
    with pytest.raises(ValueError, match="paged KV"):
        TE.FlexPipeEngine(CFG, params, [0, 2], TE.EngineConfig(
            max_batch=2, max_seq=64, kv=TE.KVCacheConfig(paged=True,
                                                         block_size=8)),
            device="cpu")


@pytest.mark.parametrize("fault_tick,covered", [(6, True), (7, False)])
def test_fault_replay_equals_run_without_fault(fault_tick, covered):
    """Stage 1 lost mid-decode (tick 6: every live slot covered by the
    snapshot, two ticks replayed) or right after two admissions (tick 7:
    the new slots uncovered, their whole history replayed): every stream
    equals the run with no fault, so MLA keeps the fault path."""
    assert TE._fault_path_refusal(CFG) is None
    want, _ = _serve()
    got, eng = _serve(fault_tick=fault_tick)
    assert got == want
    rec = eng.recovery_events[0]
    assert rec["kind"] == "emergency_refactor" and rec["new_traces"] == 0
    spans = rec["replay_spans"].values()
    assert all((v > 0) == covered for v, _, _ in spans)
    assert rec["replayed_ticks"] == (2 if covered else
                                     max(pos for _, pos, _ in spans))
