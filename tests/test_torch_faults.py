"""repro_torch's fault path against the JAX package (mirrors
tests/test_faults.py): the same seeded fault schedule, the request policy
and health monitor, Eq. 10 merges equal to repro.core.refactoring's on the
same arrays, emergency recovery with streams, recovery records and builds
equal to the reference's, graceful straggler migration, request timeouts
and retries, and the fault metrics.  RWKV's fault path is refused: the
reference's streams differ after a lost stage (ROADMAP.md, section 3)."""
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

import jax
import jax.numpy as jnp

from repro.configs.base import get_arch as jax_arch
from repro.core import refactoring as JR
from repro.models.kvcache import init_cache as jax_init_cache
from repro.models.transformer import init_model as jax_init_model
from repro.serving import engine as JE
from repro.serving import faults as JF
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs.base import get_arch
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.core.refactoring import (CacheSnapshot, block_validity,
                                          merge_paged_with_mask,
                                          merge_with_mask, snapshot)
from repro_torch.models.transformer import init_model
from repro_torch.serving import engine as TE
from repro_torch.serving.faults import (COMM_TRANSIENT, OOM, PREEMPT_STAGE,
                                        SLOWDOWN, FaultEvent, FaultInjector,
                                        FaultPolicy, StageHealthMonitor)
from repro_torch.serving.metrics import ServingStats
from repro_torch.serving.workload import Request

torch.set_num_threads(2)

JCFG = jax_arch("qwen1.5-0.5b").smoke_config
CFG = get_arch("qwen1.5-0.5b").smoke_config
JPARAMS = jax_init_model(jax.random.PRNGKey(0), JCFG)
PARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), "cpu")


# ---------------------------------------------------------------------------
# FaultInjector / FaultPolicy / StageHealthMonitor
# ---------------------------------------------------------------------------
def _events(inj):
    return [(e.t, e.kind, e.stage, e.factor, e.duration) for e in inj.events]


class TestFaultInjector:
    @pytest.mark.parametrize("seed", [0, 7])
    def test_same_schedule_as_the_reference(self, seed):
        kw = dict(horizon=300.0, preempt_rate=0.02, oom_rate=0.01,
                  comm_rate=0.05, slowdown_rate=0.01)
        a = FaultInjector(seed=seed, **kw)
        assert _events(a) == _events(JF.FaultInjector(seed=seed, **kw))
        assert _events(a) == _events(FaultInjector(seed=seed, **kw))
        assert [(e.t, e.kind) for e in a.events] != \
            [(e.t, e.kind) for e in FaultInjector(seed=seed + 1, **kw).events]

    def test_poll_delivers_in_order_once(self):
        inj = FaultInjector.scripted([
            FaultEvent(t=2.0, kind=OOM, stage=1),
            FaultEvent(t=1.0, kind=PREEMPT_STAGE, stage=0),
            FaultEvent(t=5.0, kind=SLOWDOWN, stage=2),
        ])
        assert [e.t for e in inj.events] == [1.0, 2.0, 5.0]
        assert inj.poll(0.5) == []
        assert [e.kind for e in inj.poll(2.0)] == [PREEMPT_STAGE, OOM]
        assert inj.poll(2.0) == []
        assert inj.pending() == 1
        inj.reset()
        assert inj.pending() == 3

    def test_rates_scale_event_counts(self):
        lo = FaultInjector(seed=0, horizon=1000.0, preempt_rate=0.001)
        hi = FaultInjector(seed=0, horizon=1000.0, preempt_rate=0.1)
        assert len(hi.events) > len(lo.events)
        assert all(0 < e.t <= 1000.0 for e in hi.events)


class TestFaultPolicy:
    def test_backoff_is_capped_exponential(self):
        pol = FaultPolicy(backoff_base_s=0.5, backoff_cap_s=8.0)
        ref = JF.FaultPolicy(backoff_base_s=0.5, backoff_cap_s=8.0)
        assert [pol.backoff(a) for a in (1, 2, 3, 10, 100)] == \
            [0.5, 1.0, 2.0, 8.0, 8.0] == [ref.backoff(a)
                                          for a in (1, 2, 3, 10, 100)]

    def test_retry_and_degradation_schedule(self):
        pol = FaultPolicy(max_attempts=3, degrade_frac=0.25)
        assert pol.should_retry(1) and pol.should_retry(2)
        assert not pol.should_retry(3)
        assert pol.is_last_attempt(2) and not pol.is_last_attempt(1)
        assert pol.degraded_budget(40) == 10
        assert pol.degraded_budget(1) == 1


class TestStageHealthMonitor:
    def test_missed_heartbeat_marks_stage_dead(self):
        mon = StageHealthMonitor(heartbeat_timeout_s=0.5)
        mon.reset(3, now=0.0)
        mon.heartbeat(0, 1.0)
        mon.heartbeat(2, 1.0)
        assert mon.dead_stages(1.0) == [1]
        mon.forget(1)
        assert mon.dead_stages(1.0) == []

    def test_straggler_needs_patience(self):
        mon = StageHealthMonitor(straggler_factor=3.0, patience=3)
        ref = JF.StageHealthMonitor(straggler_factor=3.0, patience=3)
        mon.reset(2)
        ref.reset(2)
        ticks = [0.1] * 10 + [1.0, 1.0, 1.0, 0.1]
        got = [mon.observe_tick(t) for t in ticks]
        assert got == [ref.observe_tick(t) for t in ticks]
        assert got[-2:] == ["straggler", "ok"] and got.count("ok") == 13


# ---------------------------------------------------------------------------
# Eq. 10 under failure: the port's merges against the reference's
# ---------------------------------------------------------------------------
def _rand_caches(jcfg, rng, B=2, S=16):
    cache = jax_init_cache(jcfg, B, S, jnp.float32)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), x.dtype), cache)


def _port(jc):
    return cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")


def _assert_same(port_caches, jax_caches):
    flat = jax.tree_util.tree_leaves(jax_caches)
    mine = [t for c in port_caches for t in c["mixer"].values()]
    assert len(mine) == len(flat)
    for m, j in zip(mine, flat):
        np.testing.assert_array_equal(m.numpy(), np.asarray(j))


class TestEq10UnderFailure:
    def test_attention_rows_equal_reference_per_slot(self):
        rng = np.random.default_rng(0)
        snap_c, live_c = _rand_caches(JCFG, rng), _rand_caches(JCFG, rng)
        valid = np.array([3, 7], np.int64)
        want = JR.merge_with_mask(JR.CacheSnapshot(snap_c, valid), live_c,
                                  live_len=10)
        live = _port(live_c)
        got = merge_with_mask(CacheSnapshot(_port(snap_c), valid), live,
                              live_len=10)
        assert got is live                    # written in place
        _assert_same(got, want)

    def test_state_caches_live_wins(self):
        jcfg = jax_arch("rwkv6-1.6b").smoke_config
        rng = np.random.default_rng(1)
        snap_c, live_c = _rand_caches(jcfg, rng), _rand_caches(jcfg, rng)
        snap = CacheSnapshot(_port(snap_c), np.array([4, 4]))
        _assert_same(merge_with_mask(snap, _port(live_c), live_len=8),
                     JR.merge_with_mask(JR.CacheSnapshot(snap_c,
                                                         np.array([4, 4])),
                                        live_c, live_len=8))
        _assert_same(merge_with_mask(snap, _port(live_c), live_len=8),
                     live_c)

    def test_snapshot_into_twin_roundtrip(self):
        rng = np.random.default_rng(2)
        snap_c, live_c = _rand_caches(JCFG, rng), _rand_caches(JCFG, rng)
        twin = _port(live_c)                  # any buffers of that shape
        src = _port(snap_c)
        snap = snapshot(src, np.array([16, 16], np.int64), out=twin)
        assert snap.per_layer is twin
        _assert_same(twin, snap_c)
        merged = merge_with_mask(snap, _port(live_c), live_len=16)
        _assert_same(merged, snap_c)
        assert twin[0]["mixer"]["k"] is not src[0]["mixer"]["k"]

    @settings(max_examples=20, deadline=None)
    @given(v0=st.integers(min_value=0, max_value=16),
           v1=st.integers(min_value=0, max_value=16),
           live_len=st.integers(min_value=0, max_value=20))
    def test_merge_partitions_like_the_reference(self, v0, v1, live_len):
        rng = np.random.default_rng(v0 * 17 + v1)
        snap_c, live_c = _rand_caches(JCFG, rng), _rand_caches(JCFG, rng)
        valid = np.array([v0, v1], np.int64)
        want = JR.merge_with_mask(JR.CacheSnapshot(snap_c, valid), live_c,
                                  live_len=live_len)
        got = merge_with_mask(CacheSnapshot(_port(snap_c), valid),
                              _port(live_c), live_len=live_len)
        _assert_same(got, want)

    def test_scalar_horizon_like_the_reference(self):
        rng = np.random.default_rng(5)
        snap_c, live_c = _rand_caches(JCFG, rng), _rand_caches(JCFG, rng)
        want = JR.merge_with_mask(JR.CacheSnapshot(snap_c, 6), live_c,
                                  live_len=9)
        got = merge_with_mask(CacheSnapshot(_port(snap_c), 6), _port(live_c),
                              live_len=9)
        _assert_same(got, want)

    def test_paged_merge_and_block_validity_equal_reference(self):
        rng = np.random.default_rng(6)
        n_blocks, bs = 12, 4
        tables = np.zeros((3, 4), np.int32)
        tables[0, :3] = [5, 2, 9]
        tables[1, :2] = [1, 7]
        tables[2, :4] = [3, 4, 6, 8]
        valid = np.array([9, 0, 13], np.int64)
        bv = block_validity(tables, valid, bs, n_blocks)
        np.testing.assert_array_equal(
            bv, JR.block_validity(tables, valid, bs, n_blocks))
        shape = (n_blocks, JCFG.n_kv_heads, bs, JCFG.resolved_head_dim)

        def pools():
            return [{"mixer": {n: jnp.asarray(rng.normal(size=shape),
                                              jnp.float32)
                               for n in ("k", "v")}}
                    for _ in range(JCFG.n_layers)]
        snap_c, live_c = pools(), pools()
        want = JR.merge_paged_with_mask(JR.CacheSnapshot(snap_c, valid),
                                        live_c, bv)
        live = _port(live_c)
        got = merge_paged_with_mask(CacheSnapshot(_port(snap_c), valid),
                                    live, bv)
        assert got is live
        _assert_same(got, want)


# ---------------------------------------------------------------------------
# Engine: preemption mid-decode -> emergency refactor -> exact outputs
# ---------------------------------------------------------------------------
_JAX_RUNS: dict = {}


def _fault_run(pkg, fault_tick=None, *, steps=14, snapshot_interval=4,
               warm=(1, 2), n=3, tokens=20, admit_late=None, paged=False):
    """tests/test_faults.py's loop, for either package; the reference's
    runs are made once per argument set."""
    key = (fault_tick, steps, snapshot_interval, warm, n, tokens, admit_late,
           paged)
    if pkg == "jax" and key in _JAX_RUNS:
        return _JAX_RUNS[key]
    mod, R = (TE, Request) if pkg == "torch" else (JE, JaxRequest)
    ecfg = mod.EngineConfig(max_batch=4, max_seq=64, warm_profiles=warm,
                            snapshot_interval=snapshot_interval,
                            kv=mod.KVCacheConfig(paged=paged, block_size=8))
    eng = (mod.FlexPipeEngine(CFG, PARAMS, [0, 2], ecfg, device="cpu")
           if pkg == "torch" else
           mod.FlexPipeEngine(JCFG, JPARAMS, [0, 2], ecfg))
    inj = FaultInjector if pkg == "torch" else JF.FaultInjector
    ev = FaultEvent if pkg == "torch" else JF.FaultEvent
    mon = StageHealthMonitor if pkg == "torch" else JF.StageHealthMonitor
    for i in range(n):
        eng.submit(R(rid=i, arrival=0.0, prompt_len=12 + i,
                     max_new_tokens=tokens))
    eng._admit(0.0)
    if fault_tick is not None:
        eng.attach_faults(injector=inj.scripted(
            [ev(t=fault_tick * 0.1, kind=PREEMPT_STAGE, stage=1)]),
            monitor=mon())
    hist = {}
    for t in range(steps):
        now = (t + 1) * 0.1
        if admit_late is not None and t == admit_late:
            eng.submit(R(rid=90, arrival=now, prompt_len=9,
                         max_new_tokens=tokens))
            eng._admit(now)
        eng.fault_step(now)
        eng.decode_step(now)
        for i, s in enumerate(eng.slots):
            if s.generated:
                hist[i] = list(s.generated)
    out = (hist, eng)
    if pkg == "jax":
        _JAX_RUNS[key] = out
    return out


_REC_KEYS = ("kind", "reason", "stages_lost", "layers_lost", "was_warm",
             "replayed_ticks", "compile_cache_hit", "new_traces")


def _same_records(eng, jeng):
    assert len(eng.recovery_events) == len(jeng.recovery_events)
    for a, b in zip(eng.recovery_events, jeng.recovery_events):
        assert {k: a[k] for k in _REC_KEYS} == {k: b[k] for k in _REC_KEYS}
    assert eng.stats.counters == jeng.stats.counters


class TestEnginePreemption:
    @pytest.mark.parametrize("paged", [False, True])
    def test_recovery_bit_identical_and_warm(self, paged):
        a, _ = _fault_run("torch", None, paged=paged)
        b, eng = _fault_run("torch", 11, paged=paged)
        ja, _ = _fault_run("jax", None)
        jb, jeng = _fault_run("jax", 11, paged=paged)
        assert a == b == ja == jb
        rec = eng.recovery_events[0]
        assert rec["kind"] == "emergency_refactor"
        assert rec["stages_lost"] == [1]
        assert rec["was_warm"] and rec["compile_cache_hit"]
        assert rec["new_traces"] == 0
        assert 0 < rec["replayed_ticks"] <= 4
        _same_records(eng, jeng)

    def test_lost_stage_zeroed_in_place(self):
        _, eng = _fault_run("torch", None, steps=6)
        before = [c["mixer"]["k"] for c in eng.caches]
        eng._on_stage_failure([1], 0.7)
        assert all(a is c["mixer"]["k"] for a, c in zip(before, eng.caches))
        assert eng.boundaries == [0]
        _, eng = _fault_run("torch", None, steps=6, snapshot_interval=0)
        kept = eng.caches[0]["mixer"]["k"].clone()
        calls = []
        eng._replay = lambda valid: calls.append(valid) or 0
        eng._on_stage_failure([1], 0.7)
        assert all(not t.any() for c in eng.caches[2:]
                   for t in c["mixer"].values())
        assert torch.equal(eng.caches[0]["mixer"]["k"], kept)
        assert not calls[0].any()             # no snapshot: full replay

    def test_all_requests_complete_zero_lost_tokens(self):
        _, eng = _fault_run("torch", 7, steps=30, tokens=10)
        _, jeng = _fault_run("jax", 7, steps=30, tokens=10)
        assert all(s.done for s in eng.slots)
        assert eng.stats.completed == 3 == jeng.stats.completed
        assert not eng.failed_requests
        _same_records(eng, jeng)

    def test_uncovered_slot_replays_full_history(self):
        a, _ = _fault_run("torch", None, steps=16, admit_late=9)
        b, eng = _fault_run("torch", 11, steps=16, admit_late=9)
        jb, jeng = _fault_run("jax", 11, steps=16, admit_late=9)
        assert a == b == jb
        assert eng.recovery_events[0]["replayed_ticks"] >= 9
        _same_records(eng, jeng)

    def test_without_snapshots_recovery_still_exact(self):
        a, _ = _fault_run("torch", None, snapshot_interval=0)
        b, eng = _fault_run("torch", 11, snapshot_interval=0)
        jb, jeng = _fault_run("jax", 11, snapshot_interval=0)
        assert a == b == jb
        assert eng.recovery_events[0]["replayed_ticks"] >= 12
        assert eng._snap_caches is None
        _same_records(eng, jeng)

    def test_detection_via_missed_heartbeat(self):
        _, eng = _fault_run("torch", 5)
        assert not eng._dead
        assert eng.health.dead_stages(100.0) == [0]

    def test_snapshot_twin_allocated_once(self):
        _, eng = _fault_run("torch", None, steps=9)
        twin = eng._snap_caches
        assert eng._snapshot.per_layer is twin
        assert [c["mixer"]["k"].shape for c in twin] == \
            [c["mixer"]["k"].shape for c in eng.caches]
        np.testing.assert_array_equal(eng._snapshot.valid_len,
                                      [s.pos - 1 if not s.done else 0
                                       for s in eng.slots])

    def test_comm_and_oom_events(self):
        eng = TE.FlexPipeEngine(CFG, PARAMS, [0, 2], TE.EngineConfig(
            max_batch=2, max_seq=64, warm_profiles=(1, 2)), device="cpu")
        eng.attach_faults(injector=FaultInjector.scripted([
            FaultEvent(t=0.1, kind=COMM_TRANSIENT, stage=0),
            FaultEvent(t=0.2, kind=OOM, stage=3)]))
        reqs = [Request(rid=i, arrival=0.0, prompt_len=8, max_new_tokens=6)
                for i in range(2)]
        eng.run(reqs, time_per_tick=0.1)
        c = eng.stats.counters
        assert c["comm_errors"] == 1 and c["oom_events"] == 1
        assert c["emergency_refactors"] == 1 and eng.stats.completed == 2
        assert eng.stats.fault_log[0][1] == COMM_TRANSIENT


class TestStragglerMigration:
    def _run(self, pkg):
        mod, R = (TE, Request) if pkg == "torch" else (JE, JaxRequest)
        ecfg = mod.EngineConfig(max_batch=4, max_seq=64,
                                warm_profiles=(1, 2), snapshot_interval=4)
        if pkg == "torch":
            eng = mod.FlexPipeEngine(CFG, PARAMS, [0, 2], ecfg, device="cpu")
            F = (FaultInjector, FaultEvent, StageHealthMonitor)
        else:
            eng = mod.FlexPipeEngine(JCFG, JPARAMS, [0, 2], ecfg)
            F = (JF.FaultInjector, JF.FaultEvent, JF.StageHealthMonitor)
        for i in range(3):
            eng.submit(R(rid=i, arrival=0.0, prompt_len=12 + i,
                         max_new_tokens=10))
        eng._admit(0.0)
        eng.attach_faults(
            injector=F[0].scripted([F[1](t=0.45, kind=SLOWDOWN, stage=1,
                                         factor=50.0, duration=30.0)]),
            monitor=F[2](straggler_factor=3.0, patience=3))
        hist = {}
        for t in range(14):
            now = (t + 1) * 0.1
            eng.fault_step(now)
            eng.decode_step(now)
            eng.health_step(now, tick_wall_s=0.01)
            for i, s in enumerate(eng.slots):
                if s.generated:
                    hist[i] = list(s.generated)
        return hist, eng

    def test_graceful_migration_no_replay_bit_identical(self):
        a, _ = _fault_run("torch", None, tokens=10)
        hist, eng = self._run("torch")
        jhist, jeng = self._run("jax")
        assert a == hist == jhist
        migs = [r for r in eng.recovery_events
                if r["kind"] == "graceful_migration"]
        assert len(migs) == 1
        assert migs[0]["replayed_ticks"] == 0
        assert migs[0]["new_traces"] == 0
        assert eng.stats.counters["graceful_migrations"] == 1
        assert eng.boundaries == jeng.boundaries == [0]


class TestRequestFaultPolicy:
    def _engine(self, pol):
        eng = TE.FlexPipeEngine(CFG, PARAMS, [0, 2],
                                TE.EngineConfig(max_batch=2, max_seq=64),
                                device="cpu")
        eng.attach_faults(policy=pol)
        return eng

    def test_timeout_retries_with_backoff(self):
        pol = FaultPolicy(timeout_s=0.2, max_attempts=3, backoff_base_s=0.5,
                          degrade_last_attempt=False)
        eng = self._engine(pol)
        req = Request(rid=0, arrival=0.0, prompt_len=8, max_new_tokens=40)
        eng.submit(req)
        eng._admit(0.0)
        eng._apply_fault_policy(1.0)
        assert req.attempts == 1 and req in eng.queue
        assert req.retry_at == pytest.approx(1.5)
        eng._admit(1.2)
        assert req in eng.queue
        eng._admit(2.0)
        assert req not in eng.queue
        assert eng.stats.counters["retries"] == 1

    def test_last_attempt_degrades_budget(self):
        eng = self._engine(FaultPolicy(timeout_s=0.2, max_attempts=2,
                                       degrade_frac=0.5))
        req = Request(rid=0, arrival=0.0, prompt_len=8, max_new_tokens=40)
        eng.submit(req)
        eng._admit(0.0)
        eng._apply_fault_policy(1.0)
        assert req.degraded and req.max_new_tokens == 20
        assert eng.stats.counters["degraded"] == 1

    def test_exhausted_attempts_fail_with_reason(self):
        eng = self._engine(FaultPolicy(timeout_s=0.1, max_attempts=1))
        req = Request(rid=0, arrival=0.0, prompt_len=8, max_new_tokens=40)
        eng.submit(req)
        eng._admit(0.0)
        eng._apply_fault_policy(5.0)
        assert req.failed and "timeout" in req.fail_reason
        assert eng.failed_requests == [req]
        assert req not in eng.queue
        assert req.terminal_state == "failed"
        assert eng.stats.counters["request_failures"] == 1

    def test_run_completes_under_fault_policy(self):
        eng = self._engine(FaultPolicy(timeout_s=30.0))
        reqs = [Request(rid=i, arrival=0.0, prompt_len=8, max_new_tokens=4)
                for i in range(4)]
        assert eng.run(reqs, time_per_tick=0.05).completed == 4
        assert not eng.failed_requests
        assert all(len(r.output) == 4 for r in reqs)


# ---------------------------------------------------------------------------
# RWKV: the reference's replay is wrong for recurrent state; the port
# refuses the fault path
# ---------------------------------------------------------------------------
def test_rwkv_fault_replay_diverges_in_reference_and_port_refuses():
    jcfg = jax_arch("rwkv6-1.6b").smoke_config
    jparams = jax_init_model(jax.random.PRNGKey(0), jcfg)

    def run(fault):
        eng = JE.FlexPipeEngine(jcfg, jparams, [0, 2], JE.EngineConfig(
            max_batch=4, max_seq=64, warm_profiles=(1, 2),
            snapshot_interval=4))
        for i in range(3):
            eng.submit(JaxRequest(rid=i, arrival=0.0, prompt_len=12 + i,
                                  max_new_tokens=20))
        eng._admit(0.0)
        if fault:
            eng.attach_faults(injector=JF.FaultInjector.scripted(
                [JF.FaultEvent(t=1.1, kind=PREEMPT_STAGE, stage=1)]),
                monitor=JF.StageHealthMonitor())
        for t in range(14):
            eng.fault_step((t + 1) * 0.1)
            eng.decode_step((t + 1) * 0.1)
        return [list(s.generated) for s in eng.slots]

    clean, faulty = run(False), run(True)
    assert clean[:3] != faulty[:3]            # the quirk, as filed
    assert [a[:11] for a in clean[:3]] == [b[:11] for b in faulty[:3]]

    cfg = get_arch("rwkv6-1.6b").smoke_config
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = TE.FlexPipeEngine(cfg, params, [0, 2], TE.EngineConfig(
        max_batch=2, max_seq=64, snapshot_interval=4), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, section 3"):
        eng.attach_faults(injector=FaultInjector.scripted([]))
    with pytest.raises(NotImplementedError, match="recurrent"):
        eng.attach_faults(monitor=StageHealthMonitor())
    with pytest.raises(NotImplementedError, match="recurrent"):
        eng._on_stage_failure([1], 0.0)
    eng.attach_faults(policy=FaultPolicy(timeout_s=30.0))   # request-level
    reqs = [Request(rid=0, arrival=0.0, prompt_len=10, max_new_tokens=5)]
    assert eng.run(reqs).completed == 1


# ---------------------------------------------------------------------------
# Metrics: stall-episode sweep and availability accounting
# ---------------------------------------------------------------------------
def _stats_with_bursts(bursts, *, t_end=260.0):
    stats = ServingStats()
    samples = [(float(t), 1.0) for t in np.arange(0.0, t_end, 0.5)]
    for lo, hi in bursts:
        samples += [(float(t), 4.0) for t in np.arange(lo, hi, 0.25)]
    return stats, samples


class TestFaultMetrics:
    def test_stall_episode_sweep_finds_separated_bursts(self):
        from repro.serving.metrics import ServingStats as JaxStats
        stats, samples = _stats_with_bursts([(100.0, 106.0), (200.0, 203.0)])
        ref = JaxStats()
        for t, lat in samples:
            stats.record(t, lat, met_slo=True)
            ref.record(t, lat, met_slo=True)
        eps = stats.stall_episodes(window=1.0)
        assert eps == ref.stall_episodes(window=1.0)
        assert len(eps) == 2
        assert eps[0]["start"] == pytest.approx(100.0, abs=1.0)
        assert eps[0]["recovery_s"] >= 6.0
        assert eps[1]["start"] == pytest.approx(200.0, abs=1.0)
        assert stats.median_recovery(window=1.0) == \
            ref.median_recovery(window=1.0)

    def test_stall_episode_sweep_order_independent(self):
        stats, samples = _stats_with_bursts([(100.0, 106.0), (200.0, 203.0)])
        rng = np.random.default_rng(0)
        for i in rng.permutation(len(samples)):
            t, lat = samples[i]
            stats.record(t, lat, met_slo=True)
        sorted_stats, _ = _stats_with_bursts([])
        for t, lat in samples:
            sorted_stats.record(t, lat, met_slo=True)
        assert stats.stall_episodes(window=1.0) == \
            sorted_stats.stall_episodes(window=1.0)

    def test_availability_counts_stall_downtime(self):
        stats, samples = _stats_with_bursts([(100.0, 110.0)])
        for t, lat in samples:
            stats.record(t, lat, met_slo=True)
        down = sum(e["recovery_s"] for e in stats.stall_episodes())
        assert down > 0
        assert stats.availability(260.0) == pytest.approx(1.0 - down / 260.0)

    def test_fault_summary_aggregates(self):
        stats = ServingStats()
        stats.bump("preemptions")
        stats.bump("preemptions")
        stats.record_recovery(5.0, t=10.0, kind="emergency_refactor")
        stats.record_recovery(15.0, t=50.0, kind="cold_restart")
        s = stats.fault_summary(horizon=100.0)
        assert s["counters"]["preemptions"] == 2
        assert s["recoveries"] == 2
        assert s["median_recovery_s"] == pytest.approx(10.0)
        assert s["max_recovery_s"] == pytest.approx(15.0)
        assert s["availability"] == 1.0
        assert stats.fault_log[1] == (50.0, "cold_restart", "")
