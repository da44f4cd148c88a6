"""repro_torch RWKV-6: the WKV recurrence's plain version against the Pallas
kernel (interpret mode) and the JAX oracle, the layer, the model and the
serving engine held against the JAX package on the same converted params.
The CUDA kernel itself is tested in test_torch_cuda.py."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_arch as jax_arch
from repro.kernels import ref
from repro.kernels.rwkv6_wkv import wkv6 as pl_wkv6
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.kvcache import init_cache as jax_init_cache
from repro.models.transformer import init_model as jax_init_model
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import FlexPipeEngine as JaxEngine
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs.base import get_arch
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,
                                 params_from_numpy, tree_to_numpy)
from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_wkv import (FEW_STEPS, HEAD_DIMS, _geometry,
                                           wkv6, wkv6_plain)
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import BlockCtx, apply_block, init_model
from repro_torch.serving.engine import (EngineConfig, FlexPipeEngine,
                                        KVCacheConfig)
from repro_torch.serving.executor_cache import FusedDecodeProgram
from repro_torch.serving.workload import Request

torch.set_num_threads(2)

JCFG = jax_arch("rwkv6-1.6b").smoke_config
CFG = get_arch("rwkv6-1.6b").smoke_config
JPARAMS = jax_init_model(jax.random.PRNGKey(0), JCFG)
NP_PARAMS = jax.tree.map(np.asarray, JPARAMS)
PARAMS = params_from_numpy(NP_PARAMS, "cpu")
WKV_TOL = dict(atol=1e-4, rtol=1e-4)       # tests/test_kernels.py's wkv tol
TOL = dict(atol=1e-5, rtol=1e-5)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(tol or TOL))


def _wkv_inputs(seed, B, S, H, hd):
    """r, k, v, w, u and a state in test_kernels.py's ranges (w in
    (0.45, 0.95)), as numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = (0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((B, S, H, hd)))))
    u = rng.standard_normal((H, hd)).astype(np.float32) * 0.1
    st = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, st


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# ---------------------------------------------------------------------------
# the WKV recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("S", [1, 7, 40])
@pytest.mark.parametrize("hd", [16, 64])
def test_wkv6_plain_vs_pallas_and_ref(B, S, hd):
    r, k, v, w, u, _ = _wkv_inputs(S * 10 + hd + B, B, S, 2, hd)
    y, st = wkv6_plain(*_t(r, k, v, w, u))
    assert y.dtype == torch.float32 and y.shape == (B, S, 2, hd)
    assert st.dtype == torch.float32 and st.shape == (B, 2, hd, hd)
    yp, stp = pl_wkv6(*map(jnp.asarray, (r, k, v, w, u)), block_t=32)
    ye, ste = ref.wkv6_ref(*map(jnp.asarray, (r, k, v, w, u)))
    for want_y, want_st in ((yp, stp), (ye, ste)):
        _close(y, want_y, **WKV_TOL)
        _close(st, want_st, **WKV_TOL)


@pytest.mark.parametrize("B,S,hd", [(1, 1, 64), (3, 7, 16), (2, 40, 64)])
def test_wkv6_plain_from_state0_vs_ref(B, S, hd):
    r, k, v, w, u, st0 = _wkv_inputs(B + S + hd, B, S, 2, hd)
    y, st = wkv6_plain(*_t(r, k, v, w, u), torch.from_numpy(st0))
    ye, ste = ref.wkv6_ref(*map(jnp.asarray, (r, k, v, w, u)),
                           state0=jnp.asarray(st0))
    _close(y, ye, **WKV_TOL)
    _close(st, ste, **WKV_TOL)


@pytest.mark.parametrize("s1", [1, 5, 23])
def test_wkv6_chunk_composition(s1):
    """WKV over [0, S) == WKV over [0, s1), then [s1, S) from its state."""
    r, k, v, w, u, _ = _t(*_wkv_inputs(s1, 2, 30, 2, 16))
    y, st = wkv6(r, k, v, w, u)
    y1, st1 = wkv6(r[:, :s1], k[:, :s1], v[:, :s1], w[:, :s1], u)
    y2, st2 = wkv6(r[:, s1:], k[:, s1:], v[:, s1:], w[:, s1:], u, st1)
    _close(torch.cat([y1, y2], 1), y, **WKV_TOL)
    _close(st2, st, **WKV_TOL)


def test_wkv6_wrapper_dispatch():
    r, k, v, w, u, st0 = _t(*_wkv_inputs(0, 2, 3, 2, 16))
    first = st0.clone()
    y_ref, st_ref = wkv6_plain(r.bfloat16(), k, v, w, u, st0)
    assert torch.equal(st0, first)            # the plain version is pure
    y, st = wkv6(r.bfloat16(), k, v, w, u, st0)
    assert y.dtype == torch.bfloat16          # y in r's dtype, state f32
    assert st.dtype == torch.float32
    assert torch.equal(y, y_ref) and torch.equal(st, st_ref)
    # in place: the final state lands in state0 itself
    assert st is st0 and not torch.equal(st0, first)
    y0, st_new = wkv6(r.bfloat16(), k, v, w, u)
    assert st_new is not st0 and torch.equal(
        st_new, wkv6_plain(r.bfloat16(), k, v, w, u)[1])
    with pytest.raises(ValueError, match="bad shapes"):
        wkv6(r, k, v, w, u[:1])
    # a device with no route raises; meta is the dry run's shape-only route
    with pytest.raises(ValueError, match="no kernel"):
        build.route(SimpleNamespace(device=torch.device("xpu")), "wkv6")
    build.reset_launches()
    mr, mk, mv, mw, mu, ms0 = (x.to("meta") for x in (r, k, v, w, u, st0))
    my, mst = wkv6(mr, mk, mv, mw, mu)
    assert my.device.type == "meta" and my.shape == r.shape
    assert mst.shape == st0.shape and mst.dtype == torch.float32
    assert wkv6(mr, mk, mv, mw, mu, ms0)[1] is ms0
    assert sum(build.launches.values()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_wkv6_launch_geometry(hd, dtype):
    """The CUDA kernel's launch geometry, from the wrapper's pure-Python
    copy: whole warps, legal CTAs and a ring that fits, at every length."""
    tt = _geometry(hd, dtype, 1 << 20).tile
    for S in (0, 1, FEW_STEPS, FEW_STEPS + 1, tt - 1, tt, tt + 1, 3 * tt,
              512, 600, 1 << 20):
        g = _geometry(hd, dtype, S)
        assert g.tile == tt
        assert g.rows % 4 == 0 and g.rows * g.lanes == hd
        assert hd % g.lanes == 0 and 32 % g.lanes == 0
        assert g.threads == g.lanes * g.cols and g.threads % 32 == 0
        assert g.threads <= 1024 and g.cols * g.ctas_per_head == hd
        assert 0 <= g.smem <= 227 * 1024, (S, g)
        assert g.rows == (16 if S <= FEW_STEPS and hd >= 32 else 4)
    if hd == 64:               # rwkv6-1.6b's prefill: B=1, H=32
        g = _geometry(hd, dtype, 512)
        assert 32 * g.ctas_per_head * g.threads // 32 >= 1024


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _x(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def _rand_cache(seed, B, dtype):
    """A non-zero state for every cache leaf, in both frameworks."""
    rng = np.random.default_rng(seed)
    jc = jax_init_cache(JCFG, B, 16, dtype, layers=range(1))
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32) * 0.5, dtype), jc)
    return cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu"), jc


@pytest.mark.parametrize("mode", ["no cache", "zero cache", "state cache",
                                  "step"])
def test_apply_rwkv_matches_jax(mode):
    bp, jbp = PARAMS["blocks"][1], NP_PARAMS["blocks"][1]
    B, S = 2, (1 if mode == "step" else 9)
    x, xj = _x(3, (B, S, CFG.d_model))
    if mode == "no cache":
        cache = jcache = None
    elif mode == "zero cache":
        cache = init_cache(CFG, B, 16, torch.float32, device="cpu",
                           layers=range(1))[0]
        jcache = jax_init_cache(JCFG, B, 16, jnp.float32, layers=range(1))[0]
    else:
        (cache,), (jcache,) = _rand_cache(4, B, jnp.float32)
    out, new, _ = ssm.apply_rwkv(
        CFG, bp["mixer"], x, cache=None if cache is None else cache["mixer"],
        ln1=bp["ln1"], ln2=bp["ln2"])
    outj, newj, _ = JS.apply_rwkv(
        JCFG, jbp["mixer"], xj,
        cache=None if jcache is None else jcache["mixer"], ln1=jbp["ln1"],
        ln2=jbp["ln2"])
    _close(out, outj)
    assert (new is None) == (newj is None)
    if new is not None:
        assert new is cache["mixer"]               # written in place
        for n in ("sx_tm", "sx_cm", "wkv"):
            _close(new[n], newj[n])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rwkv_block_casts_state_like_jax(dtype):
    """apply_block stores the new state in the cache's dtype, as JAX's
    cast_like does (a bf16 cache holds the f32 state rounded once)."""
    B = 3
    (cache,), (jcache,) = _rand_cache(5, B, dtype)
    x, xj = _x(6, (B, 1, CFG.d_model))
    y, nc, _ = apply_block(CFG, CFG.layer_kind(0), PARAMS["blocks"][0], x,
                           BlockCtx(cache=cache))
    yj, ncj, _ = JT.apply_block(JCFG, JCFG.layer_kind(0), JPARAMS["blocks"][0],
                                xj, JT.BlockCtx(cache=jcache))
    _close(y, yj)
    assert nc["mixer"]["wkv"].dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                                        else torch.float32)
    for n in ("sx_tm", "sx_cm", "wkv"):
        _close(cache_to_numpy([nc])[0]["mixer"][n],
               np.asarray(ncj["mixer"][n], np.float32))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_model_layout_and_scales():
    """Same tree as the JAX init, untied head included, with its scales."""
    tree = tree_to_numpy(init_model(CFG, torch.Generator().manual_seed(0),
                                     device="cpu"))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, NP_PARAMS)
    assert tree["lm_head"].shape == (CFG.d_model, CFG.vocab_size)
    blk = tree["blocks"][0]["mixer"]
    assert (blk["w0"] == -6.0).all() and (blk["tm"]["w"]["B"] == 0).all()
    assert (blk["ln_x"] == 1).all() and abs(blk["u"].std() / 0.1 - 1) < 0.2


def test_forward_logits_match_jax():
    toks = np.random.default_rng(8).integers(0, CFG.vocab_size, (2, 13))
    logits, _, _ = M.forward(CFG, PARAMS, {"tokens": torch.from_numpy(toks)})
    lj, _, _ = JM.forward(JCFG, JPARAMS, {"tokens": jnp.asarray(toks)})
    assert logits.shape == (2, 13, CFG.vocab_size)
    _close(logits, lj, atol=1e-4, rtol=1e-4)


def test_greedy_generate_streams_match_jax():
    toks = np.random.default_rng(9).integers(0, CFG.vocab_size, (3, 10))
    out, cache = M.greedy_generate(CFG, PARAMS,
                                   {"tokens": torch.from_numpy(toks)},
                                   steps=8, max_seq=32)
    oj, _ = JM.greedy_generate(JCFG, JPARAMS, {"tokens": jnp.asarray(toks)},
                               steps=8, max_seq=32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(oj))
    assert cache[0]["mixer"]["wkv"].dtype == torch.bfloat16   # as in JAX


def test_decode_matches_forward():
    """Mirrors tests/test_arch_smoke.py::test_smoke_decode_matches_forward."""
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, CFG.vocab_size, (2, 16)))
    logits, _, _ = M.forward(CFG, PARAMS, {"tokens": toks})
    _, cache = M.prefill(CFG, PARAMS, {"tokens": toks[:, :-1]}, max_seq=32,
                         cache_dtype=torch.float32)
    step, _ = M.decode_step(CFG, PARAMS, toks[:, -1:], cache, 15)
    ref_ = logits[:, -1, :]
    rel = float((step - ref_).abs().max() / (ref_.abs().max() + 1e-9))
    assert rel < 1e-4


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _reqs(R, n=6, tokens=6):
    """More requests than slots, three prompt lengths (each a JAX trace)."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        r = R(rid=i, arrival=0.0, prompt_len=(6, 11, 17)[i % 3],
              max_new_tokens=tokens)
        r.prompt_tokens = rng.integers(0, CFG.vocab_size, r.prompt_len)
        out.append(r)
    return out


def _streams(eng, R, refactors=None):
    """Every request's greedy stream, through step(); refactors at ticks."""
    reqs = _reqs(R)
    for r in reqs:
        eng.submit(r, now=0.0)
    owner, hist, t = {}, {}, 0
    while eng.queue or any(not s.done for s in eng.slots):
        if refactors and t in refactors:
            ev = eng.refactor(refactors[t])
            assert ev["inflight"] > 0
        eng.step(t * 0.05)
        for i, s in enumerate(eng.slots):
            if s.request is not None:
                owner[i] = s.request.rid
            if i in owner and s.generated:
                hist[owner[i]] = list(s.generated)
        t += 1
    assert sorted(hist) == [r.rid for r in reqs]
    return hist, reqs


def _engine(boundaries, **kw):
    ecfg = dict(max_batch=2, max_seq=64)
    ecfg.update(kw)
    return FlexPipeEngine(CFG, PARAMS, boundaries, EngineConfig(**ecfg),
                          device="cpu")


@pytest.fixture(scope="module")
def jax_streams():
    eng = JaxEngine(JCFG, JPARAMS, [0, 2],
                    JaxEngineConfig(max_batch=2, max_seq=64))
    assert not eng.executors.can_bucket
    return _streams(eng, JaxRequest)[0]


@pytest.mark.parametrize("start,refactors", [
    ([0, 2], None),
    ([0, 2], {2: [0, 1, 2, 3]}),                          # split
    ([0, 1, 2, 3], {3: [0, 2], 9: [0, 1, 2, 3]}),         # merge and back
])
def test_engine_streams_match_jax_across_refactors(jax_streams, start,
                                                   refactors):
    """Six requests on two slots, so slots are reused: a reused slot must
    start its prompt from zero state, not the last request's."""
    streams, _ = _streams(_engine(start), Request, refactors)
    assert streams == jax_streams
    assert all(len(s) == 6 for s in streams.values())


def test_engine_streams_equal_forward():
    """Each stream is the argmax of a whole-sequence forward, token by
    token, whichever slot served the request and whatever it held."""
    streams, reqs = _streams(_engine([0, 2]), Request)
    for r in reqs[2:4]:
        toks = np.concatenate([r.prompt_tokens, streams[r.rid][:-1]])
        logits, _, _ = M.forward(CFG, PARAMS,
                                 {"tokens": torch.from_numpy(toks)[None]})
        want = logits[0, r.prompt_len - 1:].argmax(-1).tolist()
        assert want == streams[r.rid]


def test_engine_fused_matches_unfused():
    a, _ = _streams(_engine([0, 2]), Request)
    b, _ = _streams(_engine([0, 2], fused_decode=False), Request,
                    {2: [0, 1, 2, 3]})
    assert a == b


def test_paged_rwkv_raises():
    with pytest.raises(ValueError, match="attention-only"):
        _engine([0, 2], kv=KVCacheConfig(paged=True, block_size=8))


def test_rwkv_refactor_accounting(monkeypatch):
    """Warmed refactors build nothing; a cold one builds one program and
    warms it on a one-row-per-slot scratch state that shares nothing with
    the live state, which it leaves untouched."""
    eng = _engine([0, 2], warm_profiles=(2, 4))
    for r in _reqs(Request)[:2]:
        eng.submit(r, now=0.0)
    eng._admit(0.0)
    eng.decode_step(0.0)
    for target in ([0, 1, 2, 3], [0, 2]):
        ev = eng.refactor(target)
        assert ev["compile_cache_hit"] is True and ev["new_traces"] == 0
    live = {id(t): t for c in eng.caches for t in c["mixer"].values()}
    before = [t.clone() for t in live.values()]
    seen = []
    step = FusedDecodeProgram.step

    def spy(self, caches, *a, **kw):
        seen.append({id(t) for c in caches for t in c["mixer"].values()})
        return step(self, caches, *a, **kw)

    monkeypatch.setattr(FusedDecodeProgram, "step", spy)
    ev = eng.refactor([0, 2, 3])
    assert ev["compile_cache_hit"] is False and ev["new_traces"] == 1
    assert len(seen) == 1 and len(seen[0]) == 3     # one shared layer state
    assert not seen[0] & set(live)
    assert all(torch.equal(a, b) for a, b in zip(before, live.values()))
    assert eng.decode_step(0.1) == 2
