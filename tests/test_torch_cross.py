"""repro_torch's cross attention and llama-3.2-vision-11b held against the
JAX package on the same converted params: ``apply_cross_attention`` (one
query row through the decode path, longer inputs through flash; K/V from a
memory or from the cache; f32 and bf16), the vision smoke config's cache
layout, logits, greedy streams, decode from the cross caches, and engine
streams against ``repro.serving.engine.FlexPipeEngine`` on requests that
carry a ``memory`` (bucketed prefill, slot reuse, a request without
memory, a live refactor, a bounded admission queue).  The reference
initialises every cross ``gate`` to 0, where a cross layer changes nothing,
so every gate here is set from a seed to |tanh(gate)| >= 0.46.  The
reference's fault replay is wrong for cross caches; the port refuses it
(ROADMAP.md, section 3)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax_compile import with_gates

from repro.configs.base import get_arch as jax_arch
from repro.models import kvcache as JK
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.transformer import init_model as jax_init_model
from repro.serving import admission as JA
from repro.serving import engine as JE
from repro.serving import faults as JF
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs.base import MIXER_CROSS, get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import kvcache as K
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving import admission as TA
from repro_torch.serving import engine as TE
from repro_torch.serving.faults import (PREEMPT_STAGE, FaultEvent,
                                        FaultInjector, StageHealthMonitor)
from repro_torch.serving.workload import Request

torch.set_num_threads(2)

ARCH = "llama-3.2-vision-11b"
JCFG = jax_arch(ARCH).smoke_config
CFG = get_arch(ARCH).smoke_config
CROSS = next(i for i in range(CFG.n_layers)
             if CFG.layer_kind(i).mixer == MIXER_CROSS)
MEM = CFG.n_memory_tokens
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


NP_PARAMS = with_gates(jax.tree.map(np.asarray, jax.jit(
    jax_init_model, static_argnums=1)(jax.random.PRNGKey(0), JCFG)), 1)
JPARAMS = jax.tree.map(jnp.asarray, NP_PARAMS)
PARAMS = params_from_numpy(NP_PARAMS, "cpu")


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _close(a, b, **tol):
    np.testing.assert_allclose(_np(a), _np(b), **(tol or TOL["float32"]))


def _rand(seed, shape, dt="float32"):
    """The same values for both packages, rounded once to ``dt``."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(TORCH_DT[dt])
    return t, jnp.asarray(t.float().numpy()).astype(dt)


def test_gates_are_set():
    gates = [float(b["mixer"]["gate"]) for b in NP_PARAMS["blocks"]
             if "gate" in b["mixer"]]
    assert len(gates) == 1 and all(abs(np.tanh(g)) >= 0.46 for g in gates)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 5, 8])
@pytest.mark.parametrize("source", ["memory", "memory and cache", "cache"])
def test_cross_attention_matches_jax(source, S, dt):
    """S = 1 takes the decode path (cache_len = M) in both packages, S > 1
    non-causal flash; the cache the layer writes equals the reference's
    returned cache."""
    pj = NP_PARAMS["blocks"][CROSS]["mixer"]
    p = params_from_numpy(pj, "cpu", TORCH_DT[dt])
    pjj = jax.tree.map(lambda a: jnp.asarray(a).astype(dt), pj)
    x, xj = _rand(S, (2, S, CFG.d_model), dt)
    mem, memj = _rand(10 + S, (2, MEM, CFG.d_model), dt)
    cache = jcache = None
    if source != "memory":
        cache = K.init_cache(CFG, 2, 32, TORCH_DT[dt], device="cpu",
                             layers=range(CROSS, CROSS + 1))[0]["mixer"]
        jcache = JK.init_cache(JCFG, 2, 32, jnp.dtype(dt),
                               layers=range(CROSS, CROSS + 1))[0]["mixer"]
    if source == "cache":              # filled by an earlier call
        _, cache, _ = L.apply_cross_attention(CFG, p, x, memory=mem,
                                              cache=cache)
        _, jcache, _ = JL.apply_cross_attention(JCFG, pjj, xj, memory=memj,
                                                cache=jcache)
        mem = memj = None
    y, c, _ = L.apply_cross_attention(CFG, p, x, memory=mem, cache=cache)
    yj, cj, _ = JL.apply_cross_attention(JCFG, pjj, xj, memory=memj,
                                         cache=jcache)
    assert y.dtype == TORCH_DT[dt] and y.shape == (2, S, CFG.d_model)
    _close(y, yj, **TOL[dt])
    if cache is not None:
        assert c is cache
        for n in ("k", "v"):
            _close(c[n], cj[n], **TOL[dt])
    # the gate scales the output: tanh(0) = 0 silences the layer
    p0 = dict(p, gate=torch.zeros((), dtype=TORCH_DT[dt]))
    y0, _, _ = L.apply_cross_attention(CFG, p0, x, memory=mem, cache=cache)
    assert not y0.any()


def test_cache_layout_matches_jax():
    for size in ("config", "smoke_config"):
        cfg, jcfg = getattr(get_arch(ARCH), size), getattr(jax_arch(ARCH),
                                                           size)
        for max_seq in (16, 1024):
            mine = K.init_cache(cfg, 2, max_seq, torch.float32,
                                device="meta")
            theirs = JK.init_cache(jcfg, 2, max_seq, jnp.float32,
                                   materialize=False)
            assert [{p: {n: tuple(t.shape) for n, t in leaves.items()}
                     for p, leaves in c.items()} for c in mine] == \
                [{p: {n: tuple(t.shape) for n, t in leaves.items()}
                  for p, leaves in c.items()} for c in theirs]
            assert K.dense_slot_bytes(cfg, max_seq, torch.float32) == \
                JK.dense_slot_bytes(jcfg, max_seq, jnp.float32)
        assert not K.can_page(cfg) and not JK.can_page(jcfg)
    full = K.init_cache(get_arch(ARCH).config, 8, 1024, torch.float32,
                        device="meta")
    assert full[4]["mixer"]["k"].shape == (8, 8, 1601, 128)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _batch(seed, B, S):
    toks = np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S))
    mem = np.random.default_rng(seed + 1).standard_normal(
        (B, MEM, CFG.d_model)).astype(np.float32)
    return ({"tokens": torch.from_numpy(toks), "memory": torch.from_numpy(mem)},
            {"tokens": jnp.asarray(toks), "memory": jnp.asarray(mem)})


def test_forward_logits_match_jax():
    b, bj = _batch(3, 2, 13)
    lg, _, _ = M.forward(CFG, PARAMS, b)
    jlg, _, _ = jax.jit(JM.forward, static_argnums=0)(JCFG, JPARAMS, bj)
    _close(lg, jlg, atol=1e-4, rtol=1e-4)
    # the memory reaches the logits
    other, _, _ = M.forward(CFG, PARAMS, dict(b, memory=b["memory"] * 2))
    assert (other - lg).abs().max() > 1e-3


def test_greedy_generate_streams_match_jax():
    b, bj = _batch(4, 3, 10)
    got, cache = M.greedy_generate(CFG, PARAMS, b, 8, 32)
    ref, _ = jax.jit(JM.greedy_generate, static_argnums=(0, 3, 4))(
        JCFG, JPARAMS, bj, 8, 32)
    assert got.tolist() == np.asarray(ref).tolist()
    assert cache[CROSS]["mixer"]["k"].shape == (3, 2, MEM, 16)


@pytest.mark.parametrize("memory_again", [False, True])
def test_decode_matches_forward(memory_again):
    """A prefill of all but the last token, then one decode step that reads
    the cross caches (the engine's way) or projects the memory again (the
    reference's greedy loop), against the whole forward."""
    b, _ = _batch(5, 2, 16)
    logits, _, _ = M.forward(CFG, PARAMS, b)
    _, cache = M.prefill(CFG, PARAMS, {"tokens": b["tokens"][:, :-1],
                                       "memory": b["memory"]},
                         max_seq=32, cache_dtype=torch.float32)
    step, _ = M.decode_step(CFG, PARAMS, b["tokens"][:, -1:], cache, 15,
                            b["memory"] if memory_again else None)
    _close(step, logits[:, -1], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

N_REQ, TOKENS, NO_MEMORY = 6, 8, 5
START = TE.balanced_boundaries(CFG.n_layers, 2)
MOVES = {3: TE.balanced_boundaries(CFG.n_layers, 4), 9: START}


def _reqs(R_, as_tensor):
    """Six requests, 3-30-token prompts (buckets 16 and 32); four slots, so
    two are reused; request 5 has no memory and reuses a slot whose last
    request had one.  The port's get memories as tensors or numpy arrays
    (``as_tensor``), the reference's as numpy arrays."""
    rng = np.random.default_rng(6)
    out = []
    for i in range(N_REQ):
        r = R_(rid=i, arrival=0.0, prompt_len=int(rng.integers(3, 31)),
               max_new_tokens=TOKENS)
        r.prompt_tokens = rng.integers(0, CFG.vocab_size, r.prompt_len)
        m = rng.standard_normal((1, MEM, CFG.d_model)).astype(np.float32)
        if i != NO_MEMORY:
            r.memory = torch.from_numpy(m) if as_tensor and i % 2 else m
        out.append(r)
    return out


def serve_pair(pkg, cfg, params, jparams, reqs, *, refactors=None,
               admission=None, max_seq=64, warm=(1, 2, 4)):
    """Submit ``reqs`` at 0 and step until each has ended or was turned
    away; per-rid streams and the rids turned away.  Only the port's
    engine refactors, so only it warms other partitions."""
    torch_side = pkg == "torch"
    mod = TE if torch_side else JE
    adm = None
    if admission:
        adm = (TA if torch_side else JA).AdmissionConfig(
            max_queue_depth=admission)
    ecfg = mod.EngineConfig(max_batch=4, max_seq=max_seq,
                            warm_profiles=warm if torch_side else (),
                            admission=adm)
    start = TE.balanced_boundaries(cfg.n_layers, 2)
    eng = (mod.FlexPipeEngine(cfg, params, start, ecfg, device="cpu")
           if torch_side else
           mod.FlexPipeEngine(cfg, jparams, start, ecfg))
    assert eng.executors.can_bucket
    turned = [r.rid for r in reqs if not eng.submit(r, now=0.0)]
    owner, hist, t = {}, {}, 0
    while len(eng.queue) or any(not s.done for s in eng.slots):
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
    return hist, turned


_JAX: dict = {}
RUNS = {"whole": {}, "refactored": dict(refactors=MOVES),
        "admission depth 3": dict(admission=3)}


def _serve(pkg, run, as_tensor=False):
    reqs = _reqs(Request if pkg == "torch" else JaxRequest, as_tensor)
    if pkg == "jax" and run == "refactored":
        run = "whole"                       # the reference never refactors
    key = (pkg, run)
    if pkg == "jax" and key in _JAX:
        return _JAX[key]
    cfg = CFG if pkg == "torch" else JCFG
    out = serve_pair(pkg, cfg, PARAMS, JPARAMS, reqs, **RUNS[run]), reqs
    if pkg == "jax":
        _JAX[key] = out
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_engine_streams_match_jax(run):
    (got, turned), reqs = _serve("torch", run, as_tensor=True)
    (ref, jturned), _ = _serve("jax", run)
    assert got == ref and turned == jturned
    if run == "admission depth 3":
        assert turned and len(got) == N_REQ - len(turned)
    else:
        assert sorted(got) == list(range(N_REQ))
        assert all(len(h) == TOKENS for h in got.values())
    # each memory moved once and stayed on its request
    for r in reqs:
        if r.rid != NO_MEMORY and r.rid not in turned:
            assert torch.is_tensor(r.memory) and r.memory.dtype == \
                torch.float32


def test_engine_decode_equals_forward():
    """The port's engine streams against its own whole-sequence forward
    over prompt and output (zeros for the request without memory: its
    cross caches were zeroed), wherever the forward's top-2 margin exceeds
    1e-3."""
    (got, _), reqs = _serve("torch", "whole")
    checked = 0
    for r in reqs:
        mem = torch.as_tensor(getattr(r, "memory",
                                      np.zeros((1, MEM, CFG.d_model),
                                               np.float32)))
        seq = np.concatenate([r.prompt_tokens, got[r.rid][:-1]])
        lg, _, _ = M.forward(CFG, PARAMS, {
            "tokens": torch.from_numpy(seq)[None], "memory": mem})
        lg = lg[0, len(r.prompt_tokens) - 1:]
        top2 = torch.topk(lg, 2, dim=-1).values
        for j, tok in enumerate(got[r.rid]):
            if top2[j, 0] - top2[j, 1] > 1e-3:
                assert int(lg[j].argmax()) == tok, (r.rid, j)
                checked += 1
    assert checked >= N_REQ * TOKENS - 4


def test_memory_of_another_length_is_refused():
    eng = TE.FlexPipeEngine(CFG, PARAMS, START,
                            TE.EngineConfig(max_batch=2, max_seq=32),
                            device="cpu")
    r = Request(rid=0, arrival=0.0, prompt_len=5, max_new_tokens=2)
    r.memory = np.zeros((1, MEM + 1, CFG.d_model), np.float32)
    eng.submit(r, now=0.0)
    with pytest.raises(ValueError, match="memory of shape"):
        eng.step(0.0)


def fault_streams(jcfg, jparams, boundaries, memory):
    """The reference's streams of three requests with and without the loss
    of stage 1 (snapshots every 4 ticks) at tick 11."""
    def run(fault):
        eng = JE.FlexPipeEngine(jcfg, jparams, boundaries, JE.EngineConfig(
            max_batch=4, max_seq=64, warm_profiles=(1, 2) if fault else (),
            snapshot_interval=4))
        for i in range(3):
            r = JaxRequest(rid=i, arrival=0.0, prompt_len=12 + i,
                           max_new_tokens=20)
            r.memory = memory(i)
            eng.submit(r)
        eng._admit(0.0)
        if fault:
            eng.attach_faults(injector=JF.FaultInjector.scripted(
                [JF.FaultEvent(t=1.1, kind=JF.PREEMPT_STAGE, stage=1)]),
                monitor=JF.StageHealthMonitor())
        for t in range(16):
            eng.fault_step((t + 1) * 0.1)
            eng.decode_step((t + 1) * 0.1)
        return [list(s.generated) for s in eng.slots][:3]
    return run(False), run(True)


def assert_port_refuses_faults(cfg, params, boundaries):
    eng = TE.FlexPipeEngine(cfg, params, boundaries,
                            TE.EngineConfig(max_batch=2, max_seq=64,
                                            snapshot_interval=4),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, section 3"):
        eng.attach_faults(injector=FaultInjector.scripted(
            [FaultEvent(t=1.1, kind=PREEMPT_STAGE, stage=1)]))
    with pytest.raises(NotImplementedError, match="cross-attention"):
        eng.attach_faults(monitor=StageHealthMonitor())
    with pytest.raises(NotImplementedError, match="cross-attention"):
        eng._on_stage_failure([1], 0.0)


def test_cross_fault_replay_diverges_in_reference_and_port_refuses():
    """After a lost stage the reference's merge_with_mask keeps the zeroed
    live cross leaf (its M = 8 rows are fewer than the live length) and
    its replay rebuilds self-attention rows only, so the lost cross layer
    reads zeros: streams agree before the fault and differ after it."""
    rng = np.random.default_rng(7)
    mems = [rng.standard_normal((1, MEM, CFG.d_model)).astype(np.float32)
            for _ in range(3)]
    clean, faulty = fault_streams(JCFG, JPARAMS, START, lambda i: mems[i])
    assert [a[:11] for a in clean] == [b[:11] for b in faulty]
    assert any(a != b for a, b in zip(clean, faulty))       # the quirk
    assert_port_refuses_faults(CFG, PARAMS, START)


def test_serve_launcher_runs_vision(capsys):
    """On the CPU only when asked: without --device it needs CUDA.  Each
    request gets seeded image tokens."""
    argv = ["--arch", ARCH, "--rate", "10", "--cv", "4", "--duration", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(argv)
    serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    n = int(out.split("serving ")[1].split()[0])
    line = next(x for x in out.splitlines() if x.startswith("completed="))
    assert line.startswith(f"completed={n} ")
