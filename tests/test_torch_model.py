"""repro_torch model: weight/cache bridge, layers, forward logits and greedy
streams held against the JAX package on the same converted params."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_arch as jax_arch
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.kvcache import init_cache as jax_init_cache
from repro.models.kvcache import init_paged_cache as jax_init_paged
from repro.models.transformer import count_params as jax_count_params
from repro.models.transformer import init_model as jax_init_model
from repro_torch import resolve_device
from repro_torch.configs.base import get_arch
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,
                                 params_from_numpy, tree_to_numpy)
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.kvcache import init_cache, init_paged_cache
from repro_torch.models.transformer import count_params, init_model

torch.set_num_threads(2)

JCFG = jax_arch("qwen1.5-0.5b").smoke_config
CFG = get_arch("qwen1.5-0.5b").smoke_config
JPARAMS = jax_init_model(jax.random.PRNGKey(0), JCFG)
NP_PARAMS = jax.tree.map(np.asarray, JPARAMS)
PARAMS = params_from_numpy(NP_PARAMS, "cpu")
TOL = dict(atol=1e-5, rtol=1e-5)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# configs, init and the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,which", [
    pytest.param("qwen1.5-0.5b", "config", id="config"),
    pytest.param("qwen1.5-0.5b", "smoke_config", id="smoke_config"),
    pytest.param("rwkv6-1.6b", "config", id="rwkv6-config"),
    pytest.param("rwkv6-1.6b", "smoke_config", id="rwkv6-smoke_config"),
    pytest.param("gemma3-1b", "config", id="gemma3-1b-config"),
    pytest.param("gemma3-1b", "smoke_config", id="gemma3-1b-smoke_config"),
    pytest.param("gemma3-12b", "config", id="gemma3-12b-config"),
    pytest.param("gemma3-12b", "smoke_config", id="gemma3-12b-smoke_config"),
    pytest.param("deepseek-moe-16b", "config", id="deepseek-moe-16b-config"),
    pytest.param("deepseek-moe-16b", "smoke_config",
                 id="deepseek-moe-16b-smoke_config"),
    pytest.param("jamba-v0.1-52b", "config", id="jamba-v0.1-52b-config"),
    pytest.param("jamba-v0.1-52b", "smoke_config",
                 id="jamba-v0.1-52b-smoke_config"),
] + [pytest.param(arch, which, id=f"{arch}-{which.replace('_', '-')}")
     for arch in ("qwen1.5-110b", "llama-3.2-vision-11b", "whisper-tiny")
     for which in ("config", "smoke_config")])
def test_configs_match_the_reference(arch, which):
    mine = getattr(get_arch(arch), which)
    theirs = getattr(jax_arch(arch), which)
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab_size", "resolved_head_dim",
              "qkv_bias", "rope_theta", "rms_eps", "tie_embeddings",
              "sliding_window", "global_every", "mlp_act", "source",
              "encoder_layers", "n_memory_tokens"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert [(k.mixer, k.mlp, k.extra_cross) for k in mine.pattern] == \
        [(k.mixer, k.mlp, k.extra_cross) for k in theirs.pattern]
    assert [mine.is_global_layer(i) for i in range(mine.n_layers)] == \
        [theirs.is_global_layer(i) for i in range(theirs.n_layers)]
    if theirs.ssm is not None:
        for f in ("head_size", "decay_lora", "mix_lora", "d_state", "d_conv",
                  "expand", "dt_rank"):
            assert getattr(mine.ssm, f) == getattr(theirs.ssm, f), f
    else:
        assert mine.ssm is None
    if theirs.moe is not None:
        for f in ("n_experts", "top_k", "d_expert", "n_shared",
                  "capacity_factor", "router_jitter"):
            assert getattr(mine.moe, f) == getattr(theirs.moe, f), f
    else:
        assert mine.moe is None
    assert count_params(mine) == jax_count_params(theirs)
    assert count_params(mine, active_only=True) == \
        jax_count_params(theirs, active_only=True)
    assert mine.param_count() == count_params(mine)


def test_init_model_layout_and_scales():
    g = torch.Generator().manual_seed(0)
    mine = tree_to_numpy(init_model(CFG, g, device="cpu"))
    shapes = jax.tree.map(np.shape, NP_PARAMS)
    assert jax.tree.map(np.shape, mine) == shapes
    assert (mine["blocks"][0]["ln1"]["scale"] == 1).all()
    assert (mine["blocks"][0]["mixer"]["bq"] == 0).all()
    # scales follow the JAX init: embed ~ N(0, 1/d)
    assert abs(mine["embed"].std() * np.sqrt(CFG.d_model) - 1) < 0.05
    again = tree_to_numpy(init_model(CFG, torch.Generator().manual_seed(0),
                                     device="cpu"))
    assert np.array_equal(again["embed"], mine["embed"])


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_cache(CFG, 1, 8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_numpy(NP_PARAMS, None)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cache_from_numpy([{"mixer": {"k": np.zeros(2)}}], None)
    assert resolve_device("cpu").type == "cpu"


def test_params_round_trip():
    back = tree_to_numpy(PARAMS)
    flat_a, tree_a = jax.tree.flatten(NP_PARAMS)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    assert all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b))
    assert PARAMS["blocks"][1]["mixer"]["wq"].shape == (64, 4, 16)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("paged", [False, True])
def test_cache_round_trip(dtype, paged):
    rng = np.random.default_rng(0)
    jc = (jax_init_paged(JCFG, 5, 8, dtype) if paged
          else jax_init_cache(JCFG, 2, 16, dtype))
    jc = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), dtype), jc)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    want = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    assert tc[0]["mixer"]["k"].dtype == want
    ref = (init_paged_cache(CFG, 5, 8, want, device="cpu") if paged
           else init_cache(CFG, 2, 16, want, device="cpu"))
    assert tc[0]["mixer"]["k"].shape == ref[0]["mixer"]["k"].shape
    back = cache_to_numpy(tc)
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a, np.float32), b)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _x(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def test_rms_norm():
    x, xj = _x(0, (2, 5, 64))
    p = PARAMS["blocks"][0]["ln1"]
    _close(L.rms_norm(p, x, 1e-6), JL.rms_norm(NP_PARAMS["blocks"][0]["ln1"],
                                               xj, 1e-6))


@pytest.mark.parametrize("ragged", [False, True])
def test_apply_rope(ragged):
    x, xj = _x(1, (2, 6, 4, 16))
    if ragged:
        pos = np.array([[3, 4, 5, 6, 7, 8], [40, 41, 42, 43, 44, 45]])
    else:
        pos = np.arange(6) + 11
    _close(L.apply_rope(x, torch.from_numpy(pos), 1e6),
           JL.apply_rope(xj, jnp.asarray(pos), 1e6))


def test_apply_mlp():
    x, xj = _x(2, (2, 5, 64))
    y, _, _ = L.apply_mlp(CFG, PARAMS["blocks"][0]["mlp"], x)
    yj, _, _ = JL.apply_mlp(JCFG, NP_PARAMS["blocks"][0]["mlp"], xj)
    _close(y, yj)


def test_apply_attention_prefill_and_ragged_decode():
    """Prefill writes the cache; a ragged decode (pos0 vector) writes one
    row per slot and attends over [0, pos0] — both equal the JAX layer."""
    p, pj = PARAMS["blocks"][0]["mixer"], NP_PARAMS["blocks"][0]["mixer"]
    B, S, Smax = 2, 9, 32
    x, xj = _x(3, (B, S, 64))
    cache = init_cache(CFG, B, Smax, torch.float32, device="cpu")[0]["mixer"]
    jcache = jax_init_cache(JCFG, B, Smax, jnp.float32)[0]["mixer"]
    y, cache, _ = L.apply_attention(CFG, p, x, pos0=0, cache=cache)
    yj, jcache, _ = JL.apply_attention(JCFG, pj, xj, pos0=0, cache=jcache)
    _close(y, yj)
    _close(cache["k"], jcache["k"])
    # no cache: plain causal prefill
    y0, none, _ = L.apply_attention(CFG, p, x, pos0=0)
    assert none is None
    _close(y0, yj)
    xd, xdj = _x(4, (B, 1, 64))
    pos = np.array([S, 4], np.int64)
    y, cache, _ = L.apply_attention(CFG, p, xd, pos0=torch.from_numpy(pos),
                                    cache=cache)
    yj, jcache, _ = JL.apply_attention(JCFG, pj, xdj,
                                       pos0=jnp.asarray(pos, jnp.int32),
                                       cache=jcache)
    _close(y, yj)
    _close(cache["v"], jcache["v"])


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_paged_attention_matches_jax(paged_kernel):
    """Batch-1 prefill scatter through a block table, then a paged decode
    (gather path or block-walk kernel path), against the JAX layer."""
    p, pj = PARAMS["blocks"][1]["mixer"], NP_PARAMS["blocks"][1]["mixer"]
    bs, n_blocks, M = 8, 7, 4
    tables = np.array([[3, 5, 0, 0], [6, 1, 2, 0]], np.int32)
    pools = init_paged_cache(CFG, n_blocks, bs, torch.float32,
                             device="cpu")[0]["mixer"]
    jpools = jax_init_paged(JCFG, n_blocks, bs, jnp.float32)[0]["mixer"]
    x, xj = _x(5, (1, 16, 64))          # bucket 16 over 11 live rows
    for b, S in ((0, 11), (1, 16)):
        bt = torch.from_numpy(tables[b:b + 1])
        y, pools, _ = L.apply_attention(CFG, p, x, pos0=0, cache=pools,
                                        block_table=bt)
        yj, jpools, _ = JL.apply_attention(JCFG, pj, xj, pos0=0, cache=jpools,
                                           block_table=jnp.asarray(
                                               tables[b:b + 1]))
        _close(y, yj)
    xd, xdj = _x(6, (2, 1, 64))
    pos = np.array([11, 16], np.int64)
    y, pools, _ = L.apply_attention(
        CFG, p, xd, pos0=torch.from_numpy(pos), cache=pools,
        block_table=torch.from_numpy(tables), paged_kernel=paged_kernel)
    yj, jpools, _ = JL.apply_attention(
        JCFG, pj, xdj, pos0=jnp.asarray(pos, jnp.int32), cache=jpools,
        block_table=jnp.asarray(tables), paged_kernel=paged_kernel)
    _close(y, yj)
    for blk in (1, 2, 3, 5, 6):        # live blocks; the null block differs
        _close(pools["k"][blk], jpools["k"][blk])


def test_unported_branches_raise():
    """The tensor- and sequence-parallel branches, once refused, are ported:
    with no mesh bound (one rank) each is the plain path, as JAX's psum
    over a size-1 axis is the identity; the sequence-parallel decode equals
    the plain decode.  kv_extent without a cache to read is a plain
    prefill, as in the reference.  (Over several ranks:
    tests/test_torch_parallel_*.py.)"""
    x, _ = _x(7, (1, 4, 64))
    p = PARAMS["blocks"][0]["mixer"]
    want = L.apply_attention(CFG, p, x, pos0=0)[0]
    for kw in (dict(tp_axis="tensor"), dict(sp_axis="data"),
               dict(kv_extent=16)):
        torch.testing.assert_close(
            L.apply_attention(CFG, p, x, pos0=0, **kw)[0], want)
    caches = []
    for kw in ({}, dict(sp_axis="data")):
        c = {n: torch.zeros(1, CFG.n_kv_heads, 8, CFG.resolved_head_dim)
             for n in ("k", "v")}
        L.apply_attention(CFG, p, x, pos0=0, cache=c)
        y, c, _ = L.apply_attention(CFG, p, x[:, :1], pos0=4, cache=c, **kw)
        caches.append((y, c))
    torch.testing.assert_close(caches[1][0], caches[0][0], atol=3e-5,
                               rtol=3e-5)
    for n in ("k", "v"):
        assert torch.equal(caches[1][1][n], caches[0][1][n])


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

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
    assert out.shape == (3, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(oj))
    assert cache[0]["mixer"]["k"].dtype == torch.bfloat16   # as in JAX


# ---------------------------------------------------------------------------
# qwen1.5-110b: 64 heads on 8 (G = 8), QKV bias, untied head
# ---------------------------------------------------------------------------

Q110 = "qwen1.5-110b"
Q_CFG, Q_JCFG = get_arch(Q110).smoke_config, jax_arch(Q110).smoke_config
_Q: dict = {}


def _q_params():
    if not _Q:
        jp = jax.jit(jax_init_model, static_argnums=1)(
            jax.random.PRNGKey(0), Q_JCFG)
        _Q["params"] = (params_from_numpy(jax.tree.map(np.asarray, jp),
                                          "cpu"), jp)
    return _Q["params"]


def test_qwen110b_widths():
    cfg = get_arch(Q110).config
    assert (cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.qkv_bias, cfg.tie_embeddings) == (8, 128, True, False)
    assert Q_CFG.n_heads // Q_CFG.n_kv_heads == 4
    assert count_params(cfg) == jax_count_params(jax_arch(Q110).config)


def test_qwen110b_logits_and_greedy_match_jax():
    params, jparams = _q_params()
    toks = np.random.default_rng(11).integers(0, Q_CFG.vocab_size, (2, 13))
    lg, _, _ = M.forward(Q_CFG, params, {"tokens": torch.from_numpy(toks)})
    jlg, _, _ = jax.jit(JM.forward, static_argnums=0)(
        Q_JCFG, jparams, {"tokens": jnp.asarray(toks)})
    _close(lg, jlg, atol=1e-4, rtol=1e-4)
    got, _ = M.greedy_generate(Q_CFG, params,
                               {"tokens": torch.from_numpy(toks)}, 8, 32)
    ref, _ = jax.jit(JM.greedy_generate, static_argnums=(0, 3, 4))(
        Q_JCFG, jparams, {"tokens": jnp.asarray(toks)}, 8, 32)
    assert got.tolist() == np.asarray(ref).tolist()


def _q_serve(pkg, *, paged=False, paged_kernel=False, refactors=None):
    """Six requests (5-40-token prompts) on four slots, stepped until each
    has ended; per-rid streams.  Only the port's engine refactors."""
    from repro.serving import engine as JE
    from repro.serving.workload import Request as JaxRequest
    from repro_torch.serving import engine as TE
    from repro_torch.serving.workload import Request
    params, jparams = _q_params()
    mod, R_ = (TE, Request) if pkg == "torch" else (JE, JaxRequest)
    ecfg = mod.EngineConfig(
        max_batch=4, max_seq=64,
        warm_profiles=(1, 2, 4) if pkg == "torch" else (),
        kv=mod.KVCacheConfig(paged=paged, block_size=8,
                             paged_kernel=paged_kernel))
    eng = (mod.FlexPipeEngine(Q_CFG, params, [0, 2], ecfg, device="cpu")
           if pkg == "torch" else
           mod.FlexPipeEngine(Q_JCFG, jparams, [0, 2], ecfg))
    rng = np.random.default_rng(12)
    for i in range(6):
        r = R_(rid=i, arrival=0.0, prompt_len=int(rng.integers(5, 41)),
               max_new_tokens=8)
        r.prompt_tokens = rng.integers(0, Q_CFG.vocab_size, r.prompt_len)
        eng.submit(r, now=0.0)
    owner, hist, t = {}, {}, 0
    while eng.queue or any(not s.done for s in eng.slots):
        if refactors and t in refactors:
            ev = eng.refactor(refactors[t])
            assert ev["compile_cache_hit"] and ev["new_traces"] == 0, ev
        eng.step(t * 0.05)
        for i, s in enumerate(eng.slots):
            if s.request is not None:
                owner[i] = s.request.rid
            if i in owner and s.generated:
                hist[owner[i]] = list(s.generated)
        t += 1
    assert sorted(hist) == list(range(6))
    return hist


@pytest.mark.parametrize("run", ["dense refactored", "paged gather",
                                 "paged kernel refactored"])
def test_qwen110b_engine_streams_match_jax(run):
    if "jax" not in _Q:
        _Q["jax"] = _q_serve("jax")
    moves = {3: [0, 1, 2, 3], 9: [0, 2]} if "refactored" in run else None
    got = _q_serve("torch", paged="paged" in run,
                   paged_kernel="kernel" in run, refactors=moves)
    assert got == _Q["jax"]
