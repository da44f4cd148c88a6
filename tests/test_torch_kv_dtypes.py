"""Decode over a cache in another dtype than the query, on the CPU: the
plain decode versions over every (q, cache) pair of {f32, bf16} x {f32,
bf16, float8_e4m3fn} against the Pallas kernels in interpret mode, the
engine with a bf16 cache under f32 params against the JAX engine, and
one-rank ``build_decode_step`` at ``kv_dtype="fp8"`` (and at its default
bf16 cache under f32 params) against the reference's step.  The kernels
over the same pairs are held in test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from jax_compile import compiled, host_mesh, np_params
from repro.configs.base import PipelinePlan as JaxPlan
from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.base import get_arch as jax_arch
from repro.kernels.decode_attention import (
    decode_attention as pl_decode, paged_decode_attention as pl_paged)
from repro.models.transformer import init_model as jax_init_model
from repro.parallel import pipeline as JP
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import FlexPipeEngine as JaxEngine
from repro.serving.engine import KVCacheConfig as JaxKV
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs.base import PipelinePlan, ShapeConfig, get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_plain, gather_pages,
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.parallel.pipeline import (build_decode_step,
                                           build_prefill_step, stack_params)
from repro_torch.serving.engine import (EngineConfig, FlexPipeEngine,
                                        KVCacheConfig)
from repro_torch.serving.workload import Request

torch.set_num_threads(2)

# the caches' numpy dtypes; fp8 crosses to torch as uint8 bits
NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
             "float8_e4m3fn": ml_dtypes.float8_e4m3fn}
# both sides widen q, k and v to f32 and do the math there: an f32 query
# holds at the f32 attention tolerance whatever the cache; a bf16 output
# is rounded on each side apart from f32 results that differ by ~1e-6, so
# the two may be one bf16 step apart, at most 2^-7 of the value
TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=1e-5, rtol=2 ** -7)}


def _pair(rng, shape, dt):
    """The same values as a torch tensor and a jax array of ``dt``."""
    x = rng.standard_normal(shape).astype(np.float32).astype(NP_DTYPES[dt])
    if dt == "float8_e4m3fn":
        t = torch.from_numpy(x.view(np.uint8)).view(torch.float8_e4m3fn)
    elif dt == "bfloat16":
        t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    return t, jnp.asarray(x)


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cdt", list(NP_DTYPES))
@pytest.mark.parametrize("B,H,Kh,hd,Smax,lens", [
    (2, 4, 2, 64, 300, [293, 17]),
    (4, 8, 1, 16, 100, [100, 1, 37, 0]),    # G 8, an empty slot
])
def test_plain_decode_over_dtype_pairs_vs_pallas(qdt, cdt, B, H, Kh, hd,
                                                 Smax, lens):
    rng = np.random.default_rng(Smax + hd)
    q, qj = _pair(rng, (B, H, hd), qdt)
    kc, kj = _pair(rng, (B, Kh, Smax, hd), cdt)
    vc, vj = _pair(rng, (B, Kh, Smax, hd), cdt)
    cl = np.asarray(lens, np.int32)
    out = decode_attention(q, kc, vc, torch.from_numpy(cl))
    assert out.dtype == q.dtype and out.shape == (B, H, hd)
    assert torch.equal(out, decode_attention_plain(q, kc, vc,
                                                   torch.from_numpy(cl)))
    pallas = pl_decode(qj, kj, vj, jnp.asarray(cl), block_k=64,
                       interpret=True)
    assert pallas.dtype == qj.dtype
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[qdt])


@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cdt", list(NP_DTYPES))
def test_plain_paged_decode_over_dtype_pairs_vs_pallas(qdt, cdt):
    B, H, Kh, hd, bs, M, lens = 3, 8, 2, 32, 16, 6, [5, 96, 33]
    rng = np.random.default_rng(7)
    n_blocks = 1 + B * M
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((B, M), np.int32)
    i = 0
    for b, n in enumerate(lens):
        nb = -(-n // bs)
        tables[b, :nb] = perm[i:i + nb]
        i += nb
    kp, kpj = _pair(rng, (n_blocks, Kh, bs, hd), cdt)
    vp, vpj = _pair(rng, (n_blocks, Kh, bs, hd), cdt)
    q, qj = _pair(rng, (B, H, hd), qdt)
    cl = np.asarray(lens, np.int32)
    bt = torch.from_numpy(tables)
    out = paged_decode_attention(q, kp, vp, bt, torch.from_numpy(cl))
    assert torch.equal(out, paged_decode_attention_plain(
        q, kp, vp, bt, torch.from_numpy(cl)))
    pallas = pl_paged(qj, kpj, vpj, jnp.asarray(tables), jnp.asarray(cl),
                      interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[qdt])
    # the gathered logical view through the dense version: the same bits
    assert torch.equal(out, decode_attention_plain(
        q, gather_pages(kp, bt), gather_pages(vp, bt), torch.from_numpy(cl)))


# ---------------------------------------------------------------------------
# the engine with a bf16 cache under f32 params
# ---------------------------------------------------------------------------

JCFG = jax_arch("qwen1.5-0.5b").smoke_config
CFG = get_arch("qwen1.5-0.5b").smoke_config


def _streams(eng, R):
    """Five requests on four slots (a slot is reused), stepped to the end
    with a refactor at tick 4: each request's greedy stream."""
    for i in range(5):
        assert eng.submit(R(rid=i, arrival=0.0, prompt_len=10 + 3 * i,
                            max_new_tokens=8), now=0.0).accepted
    hist, now = {}, 0.0
    for t in range(200):
        if t == 4:
            eng.refactor([0, 1, 2, 3])
        eng.step(now)
        for s in eng.slots:
            if s.request is not None and s.generated:
                hist[s.request.rid] = list(s.generated)
        now += 0.05
        if not len(eng.queue) and all(s.done for s in eng.slots):
            break
    assert eng.stats.completed == 5
    return hist


@pytest.mark.parametrize("paged", [False, True])
def test_engine_bf16_cache_under_f32_params_equals_reference(paged):
    """Greedy streams of the port's engine with ``cache_dtype="bfloat16"``
    and f32 params equal the JAX engine's on the same requests, dense and
    paged, across a refactor and a reused slot."""
    jparams = jax_init_model(jax.random.PRNGKey(0), JCFG)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    kv = dict(paged=paged, block_size=8)
    jeng = JaxEngine(JCFG, jparams, [0, 2], JaxEngineConfig(
        max_batch=4, max_seq=64, cache_dtype="bfloat16", kv=JaxKV(**kv)))
    eng = FlexPipeEngine(CFG, params, [0, 2], EngineConfig(
        max_batch=4, max_seq=64, cache_dtype="bfloat16",
        kv=KVCacheConfig(**kv)), device="cpu")
    caches = [leaf for layer in eng.caches for part in layer.values()
              for leaf in (part.values() if isinstance(part, dict)
                           else [part])]
    assert caches and all(c.dtype == torch.bfloat16 for c in caches)
    mine = _streams(eng, Request)
    assert mine == _streams(jeng, JaxRequest)
    assert sorted(mine) == list(range(5))
    assert all(len(v) >= 7 for v in mine.values())


# ---------------------------------------------------------------------------
# one-rank pipeline decode over fp8 and bf16 caches
# ---------------------------------------------------------------------------

# Both packages cast the same f32 k and v rows into the cache, but those
# rows differ by f32 rounding before the cast, so an element that close to
# a rounding boundary lands a step away in one package: a step is up to
# 2^-3 relative in e4m3, 2^-7 in bf16 (more steps for an element near zero,
# whose f32 rounding is large beside it).  Such flips are rare (at most
# 1e-3 of the cache's elements here), and the flips in bf16 moved a decode
# logit by up to 1.8e-4 on qwen's smoke config; a flip in e4m3 costs up to
# 16x one in bf16.  Where nothing flips the logits agree to 3e-6.
FLIP_TOL = {"fp8": 1e-2, "bf16": 1e-3}
STEP = {"fp8": 2.0 ** -3, "bf16": 2.0 ** -7}


@pytest.mark.parametrize("kv", ["fp8", "bf16"])
def test_one_rank_decode_step_over_narrow_cache_equals_reference(kv):
    """qwen's smoke config, f32 params, B 4: a 10-token prefill and three
    decode steps through one-rank ``build_prefill_step`` and
    ``build_decode_step`` with the plan's default cache (``kv_dtype="fp8"``
    writes float8_e4m3fn; the default writes bf16), against the
    reference's steps on a (1, 1) mesh: the caches hold that dtype and the
    reference's values but for rare flips by a rounding step, the argmax of every
    step's logits is equal and the logits agree within ``FLIP_TOL``."""
    B, S0, n_dec, max_seq = 4, 10, 3, 32
    kv_dtype = "fp8" if kv == "fp8" else "bf16"
    want_dtype = torch.float8_e4m3fn if kv == "fp8" else torch.bfloat16
    params = np_params(CFG, seed=3)
    tokens = np.random.default_rng(11).integers(
        0, CFG.vocab_size, (B, S0 + n_dec)).astype(np.int32)

    plan = PipelinePlan(kv_dtype=kv_dtype)
    pre, _ = build_prefill_step(CFG, plan, None,
                                ShapeConfig("p", max_seq, B, "prefill"),
                                param_dtype=torch.float32)
    dec, _ = build_decode_step(CFG, plan, None,
                               ShapeConfig("d", max_seq, B, "decode"),
                               param_dtype=torch.float32)
    p = stack_params(CFG, plan, params_from_numpy(params, "cpu"))
    last, caches = pre(p, {"tokens": torch.from_numpy(tokens[:, :S0])})
    leaves = [leaf for layer in caches.values() for part in layer.values()
              for leaf in part.values()]
    assert all(leaf.dtype == want_dtype for leaf in leaves)
    prefilled = {(j, part, name): leaf.float().numpy()  # decode writes
                 for j, layer in caches.items()
                 for part, lv in layer.items() for name, leaf in lv.items()}
    mine = [last.numpy()]
    for i in range(n_dec):
        tok = torch.from_numpy(tokens[:, S0 + i:S0 + i + 1])
        logits, caches = dec(p, caches, tok, S0 + i)
        mine.append(logits.numpy())

    jplan = JaxPlan(kv_dtype=kv_dtype)
    mesh = host_mesh((1, 1))
    f32 = jnp.float32
    jpre, _ = JP.build_prefill_step(JCFG, jplan, mesh,
                                    JaxShape("p", max_seq, B, "prefill"),
                                    param_dtype=f32)
    jdec, _ = JP.build_decode_step(JCFG, jplan, mesh,
                                   JaxShape("d", max_seq, B, "decode"),
                                   param_dtype=f32)
    stacked = JP.stack_params(JCFG, jplan, jax.tree.map(jnp.asarray, params))
    batch = {"tokens": jnp.asarray(tokens[:, :S0])}
    jlast, jcaches = compiled(jpre, stacked, batch)(stacked, batch)
    ref = [np.asarray(jlast)]
    for (j, part, name), a in prefilled.items():
        b = np.asarray(jcaches[str(j)][part][name]).astype(np.float32)
        assert (a != b).mean() <= 1e-3, (j, name)
        np.testing.assert_allclose(a, b, rtol=STEP[kv], atol=1e-5)
    step = None
    for i in range(n_dec):
        args = (stacked, jcaches, jnp.asarray(tokens[:, S0 + i:S0 + i + 1]),
                jnp.asarray(S0 + i, jnp.int32))
        step = step or compiled(jdec, *args)
        jlogits, jcaches = step(*args)
        ref.append(np.asarray(jlogits))
    for got, want in zip(mine, ref):
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, atol=FLIP_TOL[kv], rtol=0)
