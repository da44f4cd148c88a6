"""repro_torch's mixture of experts held against the JAX package on the same
converted params: ``apply_moe`` (routing, capacity drops, shared experts,
the aux loss) on deepseek-moe-16b's and jamba-v0.1-52b's smoke configs,
deepseek-moe-16b's logits, decode and greedy streams, and its engine
streams against ``repro.serving.engine.FlexPipeEngine`` (dense, paged
gather and kernel paths, chunked prefill, refactors, slot reuse, Eq. 10
fault replay), at the smoke's capacity factor 4.0 and at 0.5, where drops
and the idle slots' rows decide routing.  The reference's chunked prefill
is not whole-prompt prefill once capacity drops (ROADMAP.md, section 3):
pinned in both packages at the real capacity factor 1.25.  The reference's
engine cannot decode MLA (deepseek-v2-236b); the port's serves it
(tests/test_torch_mla.py holds MLA itself)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_arch as jax_arch
from repro.launch import roofline as R
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.transformer import init_model as jax_init_model
from repro.serving import engine as JE
from repro.serving import faults as JF
from repro.serving.admission import CostModel as JaxCostModel
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs.base import MLP_MOE, get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.launch.roofline import layer_fwd, layer_param_bytes
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.transformer import count_params
from repro_torch.serving import engine as TE
from repro_torch.serving.admission import CostModel
from repro_torch.serving.faults import (PREEMPT_STAGE, FaultEvent,
                                        FaultInjector, StageHealthMonitor)
from repro_torch.serving.workload import Request

torch.set_num_threads(2)

DS, JB = "deepseek-moe-16b", "jamba-v0.1-52b"
TOL = dict(atol=1e-5, rtol=1e-5)
_PARAMS: dict = {}


def _cfgs(arch, cf=None):
    """(port, reference) smoke configs, at capacity factor ``cf``."""
    cfg, jcfg = get_arch(arch).smoke_config, jax_arch(arch).smoke_config
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cf))
    return cfg, jcfg


def _params(arch):
    """The reference's init (seed 0) and its conversion; the capacity
    factor changes no param."""
    if arch not in _PARAMS:
        # jitted, as the reference's forward and greedy loop below: op by
        # op they take several times as long on the CPU
        jp = jax.jit(jax_init_model, static_argnums=1)(
            jax.random.PRNGKey(0), _cfgs(arch)[1])
        _PARAMS[arch] = (params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu"), jp)
    return _PARAMS[arch]


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(tol or TOL))


def _moe_layer(cfg):
    return next(i for i in range(cfg.n_layers)
                if cfg.layer_kind(i).mlp == MLP_MOE)


def _jax_route(jcfg, router, xt):
    """The reference's routing, as ``repro.models.layers.apply_moe`` writes
    it: top-k ids and the kept mask."""
    mo = jcfg.moe
    T, E, K = xt.shape[0], mo.n_experts, mo.top_k
    logits = jnp.einsum("td,de->te", xt, router)
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    onehot = jax.nn.one_hot(topi, E, dtype=jnp.float32)
    flat = onehot.reshape(T * K, E)
    pos = ((jnp.cumsum(flat, axis=0) - flat).reshape(T, K, E)
           * onehot).sum(-1)
    cap = max(int(np.ceil(T * K / E * mo.capacity_factor)), 4)
    return np.asarray(topi), np.asarray(pos < cap), cap


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 8, 37])
@pytest.mark.parametrize("cf", [4.0, 0.5])
@pytest.mark.parametrize("arch", [DS, JB])
def test_apply_moe_matches_jax(arch, cf, T):
    """Shared experts on (deepseek) and off (jamba); at cf 0.5 assignments
    are dropped, and the same ones in both packages."""
    cfg, jcfg = _cfgs(arch, cf)
    params, jparams = _params(arch)
    li = _moe_layer(cfg)
    p, jp = params["blocks"][li]["mlp"], jparams["blocks"][li]["mlp"]
    assert ("shared" in p) == (arch == DS)
    x = np.random.default_rng(T).standard_normal(
        (1, T, cfg.d_model)).astype(np.float32)
    y, _, aux = L.apply_moe(cfg, p, torch.from_numpy(x))
    jy, _, jaux = JL.apply_moe(jcfg, jp, jnp.asarray(x))
    _close(y, jy)
    _close(aux, jaux)
    _, topi, _, keep, cap, _ = L.moe_route(cfg, p["router"],
                                           torch.from_numpy(x[0]))
    jtopi, jkeep, jcap = _jax_route(jcfg, jp["router"], jnp.asarray(x[0]))
    assert cap == jcap
    np.testing.assert_array_equal(topi.numpy(), jtopi)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    if cf == 0.5 and T == 37:
        assert not keep.all()                 # drops happen here


def test_moe_capacity_formula():
    cfg, _ = _cfgs(DS)
    # max(ceil(T K / E cf), 4): E 8, K 2, cf 4.0
    assert [L.moe_capacity(cfg, T) for T in (1, 2, 4, 5, 64)] == \
        [4, 4, 4, 5, 64]
    full = get_arch(DS).config
    assert L.moe_capacity(full, 8) == 4           # a decode tick at batch 8
    assert L.moe_capacity(full, 1024) == 120      # a 1024-token bucket


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_deepseek_moe_16b_sizes():
    cfg = get_arch(DS).config
    assert count_params(cfg) == 16_879_568_896
    assert count_params(cfg) == jax_count(DS, "config")
    assert count_params(cfg, active_only=True) == \
        jax_count(DS, "config", active_only=True)


def jax_count(arch, size, active_only=False):
    from repro.models.transformer import count_params as jc
    return jc(getattr(jax_arch(arch), size), active_only=active_only)


def test_forward_logits_match_jax():
    cfg, jcfg = _cfgs(DS)
    params, jparams = _params(DS)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))
    lg, _, aux = M.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    jlg, _, jaux = jax.jit(JM.forward, static_argnums=0)(
        jcfg, jparams, {"tokens": jnp.asarray(toks)})
    _close(lg, jlg, atol=1e-4, rtol=1e-4)
    _close(aux, jaux, atol=1e-4, rtol=1e-4)


def test_decode_matches_forward():
    """tests/test_arch_smoke.py's check: a prefill of all but the last
    token, then one decode step, against the whole forward."""
    cfg, _ = _cfgs(DS)
    params, _ = _params(DS)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)))
    logits, _, _ = M.forward(cfg, params, {"tokens": toks})
    _, cache = M.prefill(cfg, params, {"tokens": toks[:, :-1]}, max_seq=32,
                         cache_dtype=torch.float32)
    step, _ = M.decode_step(cfg, params, toks[:, -1:], cache, 15)
    ref = logits[:, -1, :]
    assert float((step - ref).abs().max() / (ref.abs().max() + 1e-9)) < 1e-4


def test_greedy_generate_streams_match_jax():
    cfg, jcfg = _cfgs(DS)
    params, jparams = _params(DS)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))
    got, _ = M.greedy_generate(cfg, params, {"tokens": torch.from_numpy(toks)},
                               6, 32)
    ref, _ = jax.jit(JM.greedy_generate, static_argnums=(0, 3, 4))(
        jcfg, jparams, {"tokens": jnp.asarray(toks)}, 6, 32)
    assert got.tolist() == np.asarray(ref).tolist()


@pytest.mark.parametrize("arch", [DS, JB])
def test_roofline_equals_reference(arch):
    """layer_fwd for every layer of the pattern (attention or Mamba, dense
    or MoE MLP) and layer_param_bytes equal the reference's; the admission
    prior builds from them."""
    for size in ("config", "smoke_config"):
        cfg = getattr(get_arch(arch), size)
        jcfg = getattr(jax_arch(arch), size)
        for j in range(cfg.pattern_size):
            for tok, ctx, T, decode in ((1, 256, 1, True), (8, 1024, 1, True),
                                        (600, 600, 1, False),
                                        (8, 256, 2, True)):
                mine = layer_fwd(cfg, j, tok, ctx, T, decode,
                                 bytes_per_el=R.BYTES)
                ref = R.layer_fwd(jcfg, j, tok, ctx, T, decode)
                assert (mine.flops, mine.hbm_bytes) == \
                    (ref.flops, ref.hbm_bytes), (size, j, tok, T)
            if size == "smoke_config":
                assert layer_param_bytes(cfg, j, 1, bytes_per_el=R.BYTES) \
                    == R.layer_param_bytes(jcfg, j, 1)
    cfg, jcfg = get_arch(arch).smoke_config, jax_arch(arch).smoke_config
    cm = CostModel.from_roofline(cfg, batch=8, ctx=256)
    assert 0 < cm.prefill_s_per_token and 0 < cm.decode_s_per_token
    ref = JaxCostModel.from_roofline(jcfg, batch=8, ctx=256)
    assert ref.decode_s_per_token > 0


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

N_REQ, TOKENS = 6, 8


def _reqs(R_, vocab):
    """Six requests with 40-61-token prompts: four slots, so two slots are
    reused, and every prompt takes four 16-token chunks or fewer."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(N_REQ):
        r = R_(rid=i, arrival=0.0, prompt_len=int(rng.integers(40, 62)),
               max_new_tokens=TOKENS)
        r.prompt_tokens = rng.integers(0, vocab, r.prompt_len)
        out.append(r)
    return out


def _serve(pkg, cf, *, chunk=0, paged=False, paged_kernel=False,
           refactors=None, fault_tick=None):
    """Submit the six requests at 0 and step until each has ended; per-rid
    streams.  ``fault_tick``: stage 1 is lost then (snapshots every 4).
    Only the port's engines refactor, so only they warm other partitions."""
    cfg, jcfg = _cfgs(DS, cf)
    params, jparams = _params(DS)
    mod, R_ = (TE, Request) if pkg == "torch" else (JE, JaxRequest)
    ecfg = mod.EngineConfig(
        max_batch=4, max_seq=128,
        warm_profiles=(1, 2, 4) if pkg == "torch" else (),
        snapshot_interval=4 if fault_tick is not None else 0,
        kv=mod.KVCacheConfig(paged=paged, block_size=8,
                             paged_kernel=paged_kernel),
        prefill=mod.PrefillConfig(chunk=chunk))
    eng = (mod.FlexPipeEngine(cfg, params, [0, 2], ecfg, device="cpu")
           if pkg == "torch" else
           mod.FlexPipeEngine(jcfg, jparams, [0, 2], ecfg))
    if fault_tick is not None:
        F_ = (FaultInjector, FaultEvent, StageHealthMonitor) \
            if pkg == "torch" else (JF.FaultInjector, JF.FaultEvent,
                                    JF.StageHealthMonitor)
        eng.attach_faults(injector=F_[0].scripted(
            [F_[1](t=fault_tick * 0.05, kind=PREEMPT_STAGE, stage=1)]),
            monitor=F_[2]())
    reqs = _reqs(R_, cfg.vocab_size)
    for r in reqs:
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
    assert sorted(hist) == list(range(N_REQ))
    assert all(len(h) == TOKENS for h in hist.values())
    if fault_tick is not None:
        assert len(eng.recovery_events) == 1
    return hist


_JAX: dict = {}


def _jax(cf, run):
    """The reference's streams, once per module: whole-prompt, chunk 16,
    and with stage 1 lost at tick 8."""
    if (cf, run) not in _JAX:
        kw = {"whole": {}, "chunk": dict(chunk=16),
              "fault": dict(fault_tick=8)}[run]
        _JAX[cf, run] = _serve("jax", cf, **kw)
    return _JAX[cf, run]


MOVES = {3: [0, 1, 2, 3], 9: [0, 2]}
RUNS = {  # label: (reference run, port engine options)
    "dense": ("whole", {}),
    "dense refactored": ("whole", dict(refactors=MOVES)),
    "paged gather": ("whole", dict(paged=True)),
    "paged kernel refactored": ("whole", dict(paged=True, paged_kernel=True,
                                              refactors=MOVES)),
    "chunk16": ("chunk", dict(chunk=16)),
    "chunk16 paged kernel refactored": ("chunk", dict(
        chunk=16, paged=True, paged_kernel=True, refactors=MOVES)),
    "fault replay": ("fault", dict(fault_tick=8)),
}


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_engine_streams_match_jax(cf, run):
    ref_run, kw = RUNS[run]
    assert _serve("torch", cf, **kw) == _jax(cf, ref_run)


def test_chunked_differs_from_whole_prompt_at_real_capacity():
    """ROADMAP.md, section 3: the capacity depends on the tokens in the
    call, so at the real capacity factor (1.25) chunked streams differ from
    whole-prompt streams, in the reference and in the port alike; at the
    smoke's 4.0 nothing is dropped and they agree."""
    cf = 1.25
    whole, chunk = _serve("jax", cf), _serve("jax", cf, chunk=16)
    assert sum(whole[r] != chunk[r] for r in whole) >= 2
    assert _serve("torch", cf) == whole
    assert _serve("torch", cf, chunk=16) == chunk
    assert _jax(4.0, "whole") == _jax(4.0, "chunk")


def test_moe_models_keep_the_fault_path():
    cfg, _ = _cfgs(DS)
    assert TE._fault_path_refusal(cfg) is None


def test_mla_engine_decode_raises_in_reference_and_port_serves_it():
    """ROADMAP.md, section 3: the reference's MLA decode writes its cache
    at ``(0, pos0, 0)``, and the engine's per-slot ``(B,)`` positions are
    no scalar start index, so its first decode tick raises.  The port's
    engine serves the same request, writing and masking each slot at its
    own position, and its stream equals the reference's per-request loop
    (``prefill``, then ``decode_step`` at scalar positions)."""
    from repro.models.transformer import init_model as jinit
    jcfg = jax_arch("deepseek-v2-236b").smoke_config
    jparams = jax.jit(jinit, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    eng = JE.FlexPipeEngine(jcfg, jparams, [0, 1],
                            JE.EngineConfig(max_batch=2, max_seq=16))
    eng.submit(JaxRequest(rid=0, arrival=0.0, prompt_len=3,
                          max_new_tokens=2))
    with pytest.raises(TypeError, match="must be scalars"):
        eng.step(0.0)
    cfg = get_arch("deepseek-v2-236b").smoke_config
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    eng = TE.FlexPipeEngine(cfg, params, [0, 1],
                            TE.EngineConfig(max_batch=2, max_seq=16),
                            device="cpu")
    req = Request(rid=0, arrival=0.0, prompt_len=3, max_new_tokens=2)
    assert eng.run([req]).completed == 1
    prompt = jnp.arange(3)[None] % jcfg.vocab_size   # the engine's default
    last, cache = JM.prefill(jcfg, jparams, {"tokens": prompt}, 16,
                             jnp.float32)
    want = [int(jnp.argmax(last[0]))]
    logits, _ = JM.decode_step(jcfg, jparams, jnp.asarray([[want[0]]]),
                               cache, 3)
    want.append(int(jnp.argmax(logits[0])))
    assert req.output == want
