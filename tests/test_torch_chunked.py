"""repro_torch chunked prefill against the JAX package (mirrors
tests/test_prefill_chunked.py): greedy streams equal the JAX engine's
chunked and whole-prompt streams, dense, paged and paged-kernel, across a
refactor landed mid-prefill and across an Eq. 10 fault replay; the chunk
attention equals the reference's layer; round-robin scheduling, decode
during a long prefill, TTFT at the final chunk, priority victims, config
validation and the typed submission API."""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_arch as jax_arch
from repro.models import layers as JL
from repro.models.kvcache import init_cache as jax_init_cache
from repro.models.kvcache import init_paged_cache as jax_init_paged
from repro.models.transformer import init_model as jax_init_model
from repro.serving import engine as JE
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models.kvcache import init_cache, init_paged_cache
from repro_torch.serving import engine as TE
from repro_torch.serving.admission import (PRIO_BATCH, PRIO_INTERACTIVE,
                                           AdmissionConfig, CostModel)
from repro_torch.serving.workload import Request

torch.set_num_threads(2)

JCFG = jax_arch("qwen1.5-0.5b").smoke_config
CFG = get_arch("qwen1.5-0.5b").smoke_config
JPARAMS = jax_init_model(jax.random.PRNGKey(0), JCFG)
PARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), "cpu")


def _engine(pkg="torch", *, chunk=0, paged=False, paged_kernel=False,
            max_batch=4, max_seq=64, block_size=8, snapshot_interval=0,
            budget=0, admission=None, n_blocks=0, boundaries=(0, 2)):
    mod = TE if pkg == "torch" else JE
    ecfg = mod.EngineConfig(
        max_batch=max_batch, max_seq=max_seq,
        kv=mod.KVCacheConfig(paged=paged, block_size=block_size,
                             paged_kernel=paged_kernel, n_blocks=n_blocks),
        prefill=mod.PrefillConfig(chunk=chunk, budget=budget),
        snapshot_interval=snapshot_interval, admission=admission)
    if pkg == "torch":
        return mod.FlexPipeEngine(CFG, PARAMS, list(boundaries), ecfg,
                                  device="cpu")
    return mod.FlexPipeEngine(JCFG, JPARAMS, list(boundaries), ecfg)


def _run(pkg, chunk, *, paged=False, paged_kernel=False, steps=200,
         refactor_at=None, fail_at=None, prompts=(48, 9, 33), n_req=4,
         max_new=10):
    """tests/test_prefill_chunked.py's loop: per-rid streams and engine."""
    eng = _engine(pkg, chunk=chunk, paged=paged, paged_kernel=paged_kernel,
                  snapshot_interval=4 if fail_at is not None else 0)
    R = Request if pkg == "torch" else JaxRequest
    reqs = [R(rid=i, arrival=0.0, prompt_len=prompts[i % len(prompts)],
              max_new_tokens=max_new) for i in range(n_req)]
    for r in reqs:
        assert eng.submit(r, now=0.0).accepted
    hist, now = {}, 0.0
    for t in range(steps):
        if refactor_at is not None and t == refactor_at:
            eng.refactor([0, 1, 3])
        if fail_at is not None and t == fail_at:
            eng._dead.add(0)            # stage 0 dies mid-flight
        eng.step(now)
        for s in eng.slots:
            if s.request is not None and s.generated:
                hist[s.request.rid] = list(s.generated)
        now += 0.05
        if not len(eng.queue) and all(s.done for s in eng.slots):
            break
    assert eng.stats.completed == n_req
    return hist, eng


def _as_port_report(r):
    return TE.TickReport(**r.__dict__)


@pytest.fixture(scope="module")
def jax_whole():
    return _run("jax", 0)[0]


@pytest.fixture(scope="module")
def jax_chunked():
    hist, eng = _run("jax", 16)
    return hist, eng.stats.counters["prefill_chunks"]


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("paged,paged_kernel", [(False, False), (True, False),
                                                (True, True)],
                         ids=["dense", "paged", "paged_kernel"])
def test_chunked_matches_whole(jax_whole, jax_chunked, paged, paged_kernel):
    hist, eng = _run("torch", 16, paged=paged, paged_kernel=paged_kernel)
    assert hist == jax_whole
    assert hist == jax_chunked[0]
    assert eng.stats.counters["prefill_chunks"] == jax_chunked[1] >= 6
    if paged:
        assert eng.block_stats()["used_blocks"] == 0


def test_whole_prompt_matches_jax(jax_whole):
    hist, eng = _run("torch", 0)
    assert hist == jax_whole
    assert "prefill_chunks" not in eng.stats.counters


@pytest.mark.parametrize("refactor_at", [1, 2])
@pytest.mark.parametrize("paged", [False, True])
def test_chunked_parity_across_refactor(jax_whole, refactor_at, paged):
    # the refactor lands while the 48-token prompt is mid-prefill
    hist, eng = _run("torch", 16, paged=paged, refactor_at=refactor_at)
    assert hist == jax_whole
    assert eng.refactor_events[0]["inflight"] >= 1


@pytest.fixture(scope="module")
def jax_fault_record():
    _, eng = _run("jax", 16, fail_at=1)
    return eng.recovery_events[0]


@pytest.mark.parametrize("fail_at", [1, 6])
@pytest.mark.parametrize("paged", [False, True])
def test_chunked_parity_across_fault_replay(jax_whole, jax_fault_record,
                                            fail_at, paged):
    # a stage death at tick 1 catches slots mid-prefill; the Eq. 10 restore
    # and delta replay must rebuild half-written caches exactly
    hist, eng = _run("torch", 16, paged=paged, fail_at=fail_at)
    assert eng.stats.counters.get("emergency_refactors", 0) >= 1
    assert hist == jax_whole
    if fail_at == 1 and not paged:
        rec = eng.recovery_events[0]
        for k in ("stages_lost", "layers_lost", "replayed_ticks",
                  "compile_cache_hit", "was_warm"):
            assert rec[k] == jax_fault_record[k], k


@pytest.mark.parametrize("paged", [False, True])
def test_chunk_attention_matches_reference_layer(paged):
    """A 40-token prompt in chunks of 16 through apply_attention with
    kv_extent=64 (its bucket), the same weights and inputs in both
    packages: outputs at 1e-5 and the same cache rows."""
    rng = np.random.default_rng(3)
    p = PARAMS["blocks"][0]["mixer"]
    jp = JPARAMS["blocks"][0]["mixer"]
    S, ext, bs = 40, 64, 8
    x = rng.standard_normal((1, ext, CFG.d_model)).astype(np.float32)
    if paged:
        tables = np.zeros((1, 8), np.int32)
        tables[0, :6] = [5, 2, 7, 1, 4, 3]            # shuffled blocks
        tc = init_paged_cache(CFG, 9, bs, torch.float32, "cpu",
                              range(1))[0]["mixer"]
        jc = jax_init_paged(JCFG, 9, bs, jnp.float32, range(1))[0]["mixer"]
        kw = dict(block_table=torch.from_numpy(tables))
        jkw = dict(block_table=jnp.asarray(tables))
    else:
        tc = init_cache(CFG, 1, 64, torch.float32, "cpu", range(1))[0]["mixer"]
        jc = jax_init_cache(JCFG, 1, 64, jnp.float32, range(1))[0]["mixer"]
        kw, jkw = {}, {}
    for c0 in range(0, S, 16):
        xs = x[:, c0:c0 + 16]
        y, tc, _ = L.apply_attention(CFG, p, torch.from_numpy(xs), pos0=c0,
                                     cache=tc, kv_extent=ext, **kw)
        jy, jc, _ = JL.apply_attention(JCFG, jp, jnp.asarray(xs), pos0=c0,
                                       cache=jc, kv_extent=ext, **jkw)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-5, rtol=1e-5)


def test_chunk_rows_compose_to_whole_prompt():
    """Chunk by chunk over the cache gives the whole-prompt prefill's
    attention rows (the CPU path; the card holds the kernel bit for bit)."""
    rng = np.random.default_rng(4)
    p = PARAMS["blocks"][1]["mixer"]
    x = torch.from_numpy(rng.standard_normal((1, 64, CFG.d_model))
                         .astype(np.float32))
    whole, _, _ = L.apply_attention(CFG, p, x, pos0=0)
    cache = init_cache(CFG, 1, 64, torch.float32, "cpu", range(1))[0]["mixer"]
    parts = []
    for c0 in range(0, 64, 16):
        y, cache, _ = L.apply_attention(CFG, p, x[:, c0:c0 + 16], pos0=c0,
                                        cache=cache, kv_extent=64)
        parts.append(y)
    torch.testing.assert_close(torch.cat(parts, 1), whole, atol=1e-6,
                               rtol=1e-6)


def test_chunk_fallback_warns_on_unchunkable_arch():
    ecfg = TE.EngineConfig(max_batch=2, max_seq=64, cache_dtype="bfloat16",
                           prefill=TE.PrefillConfig(chunk=16))
    with pytest.warns(UserWarning, match="falling back to whole-prompt"):
        eng = TE.FlexPipeEngine(CFG, PARAMS, [0, 2], ecfg, device="cpu")
    assert eng._chunk == 0 and not eng.executors.can_chunk
    rcfg = get_arch("rwkv6-1.6b").smoke_config
    from repro_torch.models.transformer import init_model
    rp = init_model(rcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.warns(UserWarning, match="falling back to whole-prompt"):
        eng = TE.FlexPipeEngine(rcfg, rp, [0, 2], TE.EngineConfig(
            max_batch=2, max_seq=64, prefill=TE.PrefillConfig(chunk=16)),
            device="cpu")
    assert eng._chunk == 0
    reqs = [Request(rid=0, arrival=0.0, prompt_len=20, max_new_tokens=3)]
    assert eng.run(reqs).completed == 1


def test_chunk_bucket_and_program_keys():
    eng = _engine(chunk=32)
    x = eng.executors
    assert [x.chunk_bucket(n, 32) for n in (1, 16, 17, 32, 40)] == \
        [16, 16, 32, 32, 32]
    a, hit_a = x.chunk_prefill(0, 2, first=True, last=False, sample=True,
                               chunk_len=32, kv_extent=64)
    b, hit_b = x.chunk_prefill(0, 2, first=True, last=False, sample=False,
                               chunk_len=32, kv_extent=64)
    assert a is b and not hit_a and hit_b       # sample masked off-last
    builds = x.builds
    x.chunk_prefill(2, 4, first=False, last=True, sample=True, chunk_len=32,
                    kv_extent=64)
    assert x.builds == builds + 1


# ------------------------------------------------------------- scheduling

def test_chunk_round_robin_fairness():
    """Two equal long prompts interleave chunk for chunk: neither cursor
    ever runs more than one chunk ahead."""
    eng = _engine(chunk=16, budget=16)          # one chunk per tick in all
    for i in range(2):
        assert eng.submit(Request(rid=i, arrival=0.0, prompt_len=48,
                                  max_new_tokens=4), now=0.0).accepted
    gaps = []
    for t in range(40):
        eng.step(0.05 * t)
        cursors = [s.pos for s in eng.slots
                   if s.request is not None and not s.generated]
        if len(cursors) == 2:
            gaps.append(abs(cursors[0] - cursors[1]))
        if all(s.done for s in eng.slots) and not len(eng.queue):
            break
    assert gaps and max(gaps) <= 16
    assert eng.stats.completed == 2


def _long_prefill_trace(pkg):
    eng = _engine(pkg, chunk=16)
    R = Request if pkg == "torch" else JaxRequest
    assert eng.submit(R(rid=0, arrival=0.0, prompt_len=9,
                        max_new_tokens=30), now=0.0).accepted
    eng.step(0.0)                       # rid 0 through prefill into decode
    long_req = R(rid=1, arrival=0.0, prompt_len=48, max_new_tokens=4)
    assert eng.submit(long_req, now=0.0).accepted
    reps = []
    for t in range(20):
        reps.append(eng.step(0.05 * (t + 1)))
        if long_req.first_token >= 0:
            break
    return reps, list(eng.slots[0].generated)


def test_decode_progresses_during_long_prefill():
    """A decoding slot keeps emitting while another slot's long prompt is
    still prefilling; the tick reports and tokens equal the reference's."""
    reps, gen = _long_prefill_trace("torch")
    during = [r for r in reps if r.prefilling]
    assert len(during) >= 2 and sum(r.decoded for r in during) > 0
    jreps, jgen = _long_prefill_trace("jax")
    assert reps == [_as_port_report(r) for r in jreps]
    assert gen == jgen


def test_ttft_at_final_chunk():
    eng = _engine(chunk=16)
    req = Request(rid=0, arrival=0.0, prompt_len=48, max_new_tokens=4)
    assert eng.submit(req, now=0.0).accepted
    ticks_to_first = None
    for t in range(10):
        eng.step(float(t))
        if req.first_token >= 0:
            ticks_to_first = t
            break
    assert ticks_to_first == 2           # chunks at ticks 0, 1; token at 2
    assert req.first_token == 2.0


# ----------------------------------------------------- preemption victim

def test_pick_victim_prefers_lowest_priority():
    eng = _engine(paged=True, max_batch=2, n_blocks=16)
    hi = Request(rid=0, arrival=0.0, prompt_len=12, max_new_tokens=10,
                 priority=PRIO_INTERACTIVE)
    lo = Request(rid=1, arrival=0.0, prompt_len=12, max_new_tokens=10,
                 priority=PRIO_BATCH)
    assert eng.submit(hi, now=0.0).accepted
    assert eng.submit(lo, now=0.0).accepted
    eng.step(0.0)
    live = {eng.slots[i].request.rid for i in range(2)
            if not eng.slots[i].done}
    assert live == {0, 1}
    assert eng.slots[eng._pick_victim()].request.rid == 1


def test_preemption_evicts_batch_class_first():
    """Pool exhaustion mid-decode preempts the batch request; the
    interactive one streams on and finishes first; both complete with the
    reference's streams."""
    eng = _engine(paged=True, max_batch=2, n_blocks=5)
    hi = Request(rid=0, arrival=0.0, prompt_len=12, max_new_tokens=10,
                 priority=PRIO_INTERACTIVE)
    lo = Request(rid=1, arrival=0.0, prompt_len=12, max_new_tokens=10,
                 priority=PRIO_BATCH)
    for r in (hi, lo):
        assert eng.submit(r, now=0.0).accepted
    for t in range(200):
        eng.step(0.05 * t)
        if not len(eng.queue) and all(s.done for s in eng.slots):
            break
    assert eng.stats.completed == 2
    assert eng.stats.counters.get("paged_preemptions", 0) >= 1
    assert hi.finish < lo.finish
    dense = _engine(max_batch=2)
    a = Request(rid=0, arrival=0.0, prompt_len=12, max_new_tokens=10)
    b = Request(rid=1, arrival=0.0, prompt_len=12, max_new_tokens=10)
    dense.run([a, b])
    assert (hi.output, lo.output) == (a.output, b.output)


# ----------------------------------------------------- config & submit API

def test_chunk_validation():
    with pytest.raises(ValueError, match="power of two"):
        TE.EngineConfig(max_seq=96, prefill=TE.PrefillConfig(chunk=24))
    with pytest.raises(ValueError, match="power of two"):
        TE.EngineConfig(max_seq=64, prefill=TE.PrefillConfig(chunk=8))
    with pytest.raises(ValueError, match="multiple"):
        TE.EngineConfig(max_seq=100, prefill=TE.PrefillConfig(chunk=16))
    TE.EngineConfig(max_seq=96, prefill=TE.PrefillConfig(chunk=32))


def test_submit_result():
    eng = _engine(max_batch=2)
    res = eng.submit(Request(rid=0, arrival=0.0, prompt_len=8,
                             max_new_tokens=4), now=0.0)
    assert res.accepted and bool(res) and res.queue_depth == 1


def test_submit_result_rejection():
    eng = _engine(max_batch=1, admission=AdmissionConfig(max_queue_depth=1))
    r0 = eng.submit(Request(rid=0, arrival=0.0, prompt_len=8,
                            max_new_tokens=4), now=0.0)
    r1 = eng.submit(Request(rid=1, arrival=0.0, prompt_len=8,
                            max_new_tokens=4), now=0.0)
    assert r0.accepted
    assert not r1.accepted and not bool(r1)
    assert r1.reason == "queue_full"


def _tick_reports(pkg):
    eng = _engine(pkg, chunk=16)
    R = Request if pkg == "torch" else JaxRequest
    assert eng.submit(R(rid=0, arrival=0.0, prompt_len=33,
                        max_new_tokens=3), now=0.0).accepted
    reps = []
    for t in range(30):
        reps.append(eng.step(0.05 * t))
        if all(s.done for s in eng.slots):
            break
    return reps


def test_tick_report_fields():
    reps = _tick_reports("torch")
    rep = reps[0]
    assert rep.admitted == 1
    assert rep.prefill_tokens > 0        # the first chunk ran this tick
    assert rep.prefilling == 1           # 33 > 16: still mid-prefill
    assert rep.queue_depth == 0
    assert sum(r.completed for r in reps) == 1
    assert sum(r.decoded for r in reps) >= 2
    assert reps == [_as_port_report(r) for r in _tick_reports("jax")]


def test_cost_model_seeds_chunked_prefill_rate():
    cm = CostModel()
    cm.seed_from_tick(0.1, prefill_tokens_per_tick=16)
    assert cm.prefill_s_per_token == pytest.approx(0.1 / 16)
    assert CostModel.from_tick(0.1).prefill_s_per_token >= 0.0
    eng = _engine(chunk=16, budget=32, admission=AdmissionConfig())
    eng.run([], time_per_tick=0.1)
    assert eng.admission.cost.prefill_s_per_token == pytest.approx(0.1 / 32)


def test_no_warnings_on_chunkable_arch():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = _engine(chunk=16)
    assert eng._chunk == 16 and eng.executors.can_chunk
