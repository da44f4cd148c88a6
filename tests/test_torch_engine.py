"""repro_torch serving engine: live refactoring keeps greedy streams
bit-identical, paged equals dense (gather and block-walk paths, across a
refactor and a pool-exhaustion preemption), the block allocator, and the
executor cache's warm-refactor accounting — with every stream also held
against the JAX engine on the same converted params."""
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

import jax

from repro.configs.base import get_arch as jax_arch
from repro.models.transformer import init_model as jax_init_model
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import FlexPipeEngine as JaxEngine
from repro.serving.engine import KVCacheConfig as JaxKV
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models.kvcache import (BlockAllocator, blocks_for,
                                        fragmentation)
from repro_torch.serving.engine import (EngineConfig, FlexPipeEngine,
                                        KVCacheConfig, PrefillConfig,
                                        balanced_boundaries)
from repro_torch.serving.executor_cache import FusedDecodeProgram
from repro_torch.serving.workload import Request, synth_requests

torch.set_num_threads(2)

JCFG = jax_arch("qwen1.5-0.5b").smoke_config
CFG = get_arch("qwen1.5-0.5b").smoke_config
JPARAMS = jax_init_model(jax.random.PRNGKey(0), JCFG)
PARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), "cpu")


def _engine(boundaries, **kw):
    ecfg = dict(max_batch=4, max_seq=64)
    ecfg.update(kw)
    return FlexPipeEngine(CFG, PARAMS, boundaries, EngineConfig(**ecfg),
                          device="cpu")


def _reqs(R, n=3, prompt=12, tokens=8):
    return [R(rid=i, arrival=0.0, prompt_len=prompt + i,
              max_new_tokens=tokens) for i in range(n)]


def _drive(eng, R, refactors=None, steps=10):
    """tests/test_engine.py's loop: admit once, then decode, refactoring at
    the given ticks; returns the streams per slot."""
    for r in _reqs(R):
        eng.submit(r)
    eng._admit(0.0)
    hist = {}
    for t in range(steps):
        if refactors and t in refactors:
            eng.refactor(refactors[t])
        eng.decode_step(t * 0.1)
        for i, s in enumerate(eng.slots):
            if s.generated:
                hist[i] = list(s.generated)
    return hist


_JAX_STREAMS: dict = {}


def _jax_streams(boundaries, steps=10):
    key = (tuple(boundaries), steps)
    if key not in _JAX_STREAMS:
        eng = JaxEngine(JCFG, JPARAMS, boundaries,
                        JaxEngineConfig(max_batch=4, max_seq=64))
        _JAX_STREAMS[key] = _drive(eng, JaxRequest, steps=steps)
    return _JAX_STREAMS[key]


# ---------------------------------------------------------------------------
# inflight refactoring (mirrors tests/test_engine.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,refactors,steps", [
    ([0, 2], {3: [0, 1, 2, 3]}, 10),                          # split
    ([0, 1, 2, 3], {4: [0, 2]}, 10),                          # merge
    ([0, 2], {2: [0, 1, 2, 3], 5: [0, 3], 8: [0, 1, 2, 3]}, 12),  # repeated
    ([0, 2], {3: [0, 2, 3]}, 10),                             # unbalanced
])
def test_streams_identical_across_refactors(start, refactors, steps):
    plain = _drive(_engine(start), Request, steps=steps)
    eng = _engine(start)
    moved = _drive(eng, Request, refactors=refactors, steps=steps)
    assert moved == plain
    assert eng.refactor_events[0]["inflight"] == 3
    assert plain == _jax_streams(start, steps)


def test_all_requests_complete_with_outputs():
    eng = _engine([0, 2], max_batch=2)
    reqs = _reqs(Request, n=5, tokens=4)      # more requests than slots
    stats = eng.run(reqs, time_per_tick=0.05)
    assert stats.completed == 5
    assert all(r.finish >= 0 and len(r.output) == 4 for r in reqs)
    jeng = JaxEngine(JCFG, JPARAMS, [0, 2],
                     JaxEngineConfig(max_batch=2, max_seq=64))
    assert jeng.run(_reqs(JaxRequest, n=5, tokens=4)).completed == 5


def test_eos_ends_a_request_early():
    full = _reqs(Request, n=2, tokens=8)
    _engine([0, 2]).run(full)
    eos = full[0].output[2]
    cut = _reqs(Request, n=2, tokens=8)
    _engine([0, 2], eos_token=eos).run(cut)
    for a, b in zip(full, cut):
        n = a.output.index(eos) + 1 if eos in a.output else len(a.output)
        assert b.output == a.output[:n]
    assert len(cut[0].output) <= 3


def test_fused_matches_unfused():
    a = _drive(_engine([0, 2]), Request)
    b = _drive(_engine([0, 2], fused_decode=False), Request,
               refactors={3: [0, 1, 2, 3]})
    assert a == b


def test_synth_requests_match_the_reference():
    from repro.serving.workload import synth_requests as jax_synth
    a = synth_requests(np.random.default_rng(4), rate=5, cv=2, duration=3)
    b = jax_synth(np.random.default_rng(4), rate=5, cv=2, duration=3)
    assert [(r.arrival, r.prompt_len, r.max_new_tokens) for r in a] == \
        [(r.arrival, r.prompt_len, r.max_new_tokens) for r in b]


# ---------------------------------------------------------------------------
# executor cache (mirrors tests/test_executor_cache.py)
# ---------------------------------------------------------------------------

def test_warmed_refactor_builds_nothing():
    eng = _engine([0, 2], warm_profiles=(2, 4))
    for r in _reqs(Request):
        eng.submit(r)
    eng._admit(0.0)
    eng.decode_step(0.0)
    for target in ([0, 1, 2, 3], [0, 2]):
        ev = eng.refactor(target)
        assert ev["compile_cache_hit"] is True
        assert ev["new_traces"] == 0
    assert eng.decode_step(0.1) == 3
    assert eng.executors.stats()["builds"] == eng.executors.misses


def test_cold_refactor_reports_miss():
    eng = _engine([0, 2])               # initial program registered only
    ev = eng.refactor([0, 2, 3])
    assert ev["compile_cache_hit"] is False and ev["new_traces"] == 1
    ev2 = eng.refactor([0, 2])          # registered at init, never run
    assert ev2["compile_cache_hit"] is False and ev2["new_traces"] == 0
    assert eng.executors.is_warm([0, 2])
    ev3 = eng.refactor([0, 2, 3])       # built and run above
    assert ev3["compile_cache_hit"] is True


@pytest.mark.parametrize("paged", [False, True])
def test_cold_refactor_warms_on_small_scratch(monkeypatch, paged):
    """A cold refactor's throwaway tick must not allocate a second cache on
    the scale of the live one, and must leave the live cache untouched."""
    kv = KVCacheConfig(paged=paged, block_size=8)
    eng = _engine([0, 2], kv=kv)
    for r in _reqs(Request):
        eng.submit(r)
    eng._admit(0.0)
    eng.decode_step(0.0)

    def elems(caches):
        uniq = {id(t): t for c in caches for t in c["mixer"].values()}
        return sum(t.numel() for t in uniq.values())

    live = elems(eng.caches)
    before = [c["mixer"]["k"].clone() for c in eng.caches]
    seen = []
    step = FusedDecodeProgram.step

    def spy(self, caches, *a, **kw):
        seen.append(elems(caches))
        return step(self, caches, *a, **kw)

    monkeypatch.setattr(FusedDecodeProgram, "step", spy)
    ev = eng.refactor([0, 1, 2, 3])
    assert ev["new_traces"] == 1 and seen
    assert max(seen) * 100 <= live
    assert all(torch.equal(a, c["mixer"]["k"])
               for a, c in zip(before, eng.caches))


def test_refactor_is_zero_copy():
    eng = _engine([0, 2], warm_profiles=(4,))
    for r in _reqs(Request):
        eng.submit(r)
    eng._admit(0.0)
    eng.decode_step(0.0)
    before = [c["mixer"]["k"] for c in eng.caches]
    eng.refactor([0, 1, 2, 3])
    assert all(a is c["mixer"]["k"] for a, c in zip(before, eng.caches))
    assert [len(s) for s in eng.stage_caches] == [1, 1, 1, 1]


def test_boundaries_and_config():
    assert balanced_boundaries(4, 3) == [0, 2, 3]
    assert balanced_boundaries(26, 4) == [0, 7, 14, 20]
    e1, e2 = _engine([0, 2]), _engine([0, 2])
    assert e1.ecfg is not e2.ecfg
    ecfg = EngineConfig(max_seq=64, prefill=PrefillConfig(chunk=16),
                        snapshot_interval=4)
    assert ecfg.prefill.chunk == 16 and ecfg.snapshot_interval == 4
    with pytest.raises(ValueError, match="power of two"):
        EngineConfig(prefill=PrefillConfig(chunk=24))
    e1.attach_faults()                  # nothing armed: a no-op
    assert e1.faults is None and e1.health is None
    with pytest.raises(ValueError, match="params live on"):
        FlexPipeEngine(CFG, PARAMS, [0, 2], device="meta")


# ---------------------------------------------------------------------------
# block allocator (mirrors tests/test_paged.py:33-96)
# ---------------------------------------------------------------------------

def test_allocator_basic_and_lifo():
    a = BlockAllocator(n_blocks=8, block_size=4)
    assert a.n_usable == 7 and a.n_free == 7           # block 0 reserved
    ids = a.alloc(3)
    assert ids == [1, 2, 3]
    assert a.n_used == 3 and a.occupancy() == 3 / 7
    assert a.alloc(5) is None and a.n_used == 3        # all-or-nothing
    a.free(ids)
    assert a.alloc(3) == list(reversed(ids))           # LIFO reuse
    with pytest.raises(ValueError, match="double free"):
        a.free([7])


@settings(max_examples=50, deadline=None)
@given(st.lists(st.integers(min_value=-3, max_value=4), min_size=1,
                max_size=40))
def test_allocator_no_leaks(ops):
    a = BlockAllocator(n_blocks=12, block_size=4)
    held: list[list[int]] = []
    for op in ops:
        if op > 0:
            ids = a.alloc(op)
            if ids is not None:
                assert len(set(ids)) == op and 0 not in ids
                held.append(ids)
        elif op < 0 and held:
            a.free(held.pop(len(held) % len(held) - 1))
        assert a.n_used + a.n_free == a.n_usable
    for h in held:
        a.free(h)
    assert a.n_free == a.n_usable and a.n_used == 0


def test_blocks_for_and_fragmentation():
    assert [blocks_for(n, 8) for n in (0, 1, 8, 9)] == [0, 1, 1, 2]
    assert fragmentation(0, 0, 8) == 0.0
    assert fragmentation(9, 2, 8) == pytest.approx(7 / 16)


# ---------------------------------------------------------------------------
# paged vs dense (mirrors tests/test_paged.py:203-278)
# ---------------------------------------------------------------------------

def _run_paged(*, paged, steps=40, refactor_at=None, n_blocks=0,
               paged_kernel=False, jax_engine=False):
    kv = dict(paged=paged, block_size=8, n_blocks=n_blocks,
              paged_kernel=paged_kernel)
    if jax_engine:
        eng = JaxEngine(JCFG, JPARAMS, [0, 2], JaxEngineConfig(
            max_batch=4, max_seq=64, kv=JaxKV(**kv)))
        R = JaxRequest
    else:
        eng = _engine([0, 2], kv=KVCacheConfig(**kv))
        R = Request
    for r in [R(rid=i, arrival=0.0, prompt_len=5 + 3 * i, max_new_tokens=14)
              for i in range(4)]:
        eng.submit(r, now=0.0)
    now, hist = 0.0, {}
    for t in range(steps):
        eng._admit(now)
        if refactor_at is not None and t == refactor_at:
            eng.refactor([0, 1, 3])
        eng.decode_step(now)
        for s in eng.slots:
            if s.request is not None:
                hist[s.request.rid] = list(s.generated)
        now += 0.05
        if eng.stats.completed == 4 and not len(eng.queue):
            break
    return hist, eng


@pytest.fixture(scope="module")
def dense_streams():
    dense, _ = _run_paged(paged=False, steps=60)
    return dense


@pytest.mark.parametrize("paged_kernel,refactor_at", [
    (False, None), (True, None), (False, 7), (True, 7)])
def test_paged_matches_dense(dense_streams, paged_kernel, refactor_at):
    paged, eng = _run_paged(paged=True, paged_kernel=paged_kernel,
                            refactor_at=refactor_at)
    assert paged == dense_streams
    st_ = eng.block_stats()
    assert st_["used_blocks"] == 0 and st_["fragmentation"] == 0.0
    assert eng.stats.block_samples
    assert bool(eng.refactor_events) == (refactor_at is not None)


def test_paged_matches_jax_engine(dense_streams):
    jax_paged, _ = _run_paged(paged=True, jax_engine=True)
    assert jax_paged == dense_streams


def test_pool_exhaustion_preempts_and_recovers(dense_streams):
    paged, eng = _run_paged(paged=True, steps=400, n_blocks=9)
    assert eng.stats.counters.get("paged_preemptions", 0) > 0
    assert eng.stats.completed == 4
    assert paged == dense_streams
    assert eng.block_stats()["used_blocks"] == 0


def test_paged_requires_divisible_max_seq():
    with pytest.raises(ValueError, match="multiple of block_size"):
        _engine([0, 2], max_seq=65, kv=KVCacheConfig(paged=True,
                                                     block_size=8))
