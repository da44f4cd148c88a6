"""repro_torch's cluster simulator, cluster model and multi-phase traces
held against the JAX package's (both numpy only): mirrors of
tests/test_serving.py (TestWorkload, TestCluster, TestSimulator),
tests/test_faults.py::TestSimulatorFaults and
tests/test_admission.py::TestSimulatorOverload and
::TestControllerSaturation, and parity: the same seeds give the same
traces, the same GPU table, the same Table 2 profiles and the same
``ClusterSim.run`` outputs, for every policy."""
import copy
import dataclasses

import numpy as np
import pytest
from hypothesis_compat import given, settings, st

from repro.core.granularity import GranularityProfile as JaxProfile
from repro.core.refactoring import RefactoringController as JaxController
from repro.serving import cluster as JCl
from repro.serving import faults as JF
from repro.serving import simulator as JSim
from repro.serving import workload as JW
from repro_torch.core.granularity import GranularityProfile
from repro_torch.core.refactoring import RefactoringController
from repro_torch.serving.cluster import FragmentedCluster
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.simulator import (POLICIES, TABLE2, ClusterSim,
                                           table2_profile)
from repro_torch.serving.workload import (Phase, azure_like_trace,
                                          phased_trace, synth_requests)

REQ_FIELDS = ("rid", "arrival", "prompt_len", "max_new_tokens", "priority",
              "deadline_s")
LIFECYCLE = ("start", "first_token", "finish", "queue_wait", "rejected",
             "shed", "shed_reason", "fail_reason", "degraded", "attempts",
             "enqueued_at")


def _fields(reqs, names=REQ_FIELDS):
    return [tuple(getattr(r, f) for f in names) for r in reqs]


def _gpu_table(cl):
    return [(g.gid, g.server, g.mem, g.bg_mem, g.used_mem)
            for s in cl.servers for g in s.gpus]


# ---------------------------------------------------------------------------
# workload (tests/test_serving.py::TestWorkload)
# ---------------------------------------------------------------------------

class TestWorkload:
    @settings(max_examples=8, deadline=None)
    @given(cv=st.sampled_from([0.5, 1.0, 3.0]),
           rate=st.sampled_from([10.0, 50.0]))
    def test_rate_and_cv(self, cv, rate):
        reqs = synth_requests(np.random.default_rng(0), rate=rate, cv=cv,
                              duration=120.0)
        got_rate = len(reqs) / 120.0
        assert abs(got_rate - rate) / rate < 0.25
        ivs = np.diff([r.arrival for r in reqs])
        got_cv = ivs.std() / ivs.mean()
        assert abs(got_cv - cv) / cv < 0.3

    def test_phases_are_ordered(self):
        reqs = phased_trace(np.random.default_rng(1),
                            [Phase(10, 5, 1.0), Phase(10, 50, 4.0)])
        ts = [r.arrival for r in reqs]
        assert ts == sorted(ts)

    def test_deterministic_under_fixed_seed(self):
        def gen():
            return synth_requests(np.random.default_rng(7), rate=20.0,
                                  cv=2.0, duration=30.0,
                                  priority_mix=(0.2, 0.6, 0.2))
        a, b = gen(), gen()
        assert _fields(a) == _fields(b)

    def test_priority_mix_none_preserves_legacy_stream(self):
        a = synth_requests(np.random.default_rng(3), rate=20.0, cv=1.0,
                           duration=20.0)
        b = synth_requests(np.random.default_rng(3), rate=20.0, cv=1.0,
                           duration=20.0, priority_mix=None)
        assert [r.arrival for r in a] == [r.arrival for r in b]
        assert all(r.priority == 1 for r in a)

    def test_priority_mix_draws_all_classes(self):
        reqs = synth_requests(np.random.default_rng(5), rate=50.0, cv=1.0,
                              duration=30.0, priority_mix=(0.3, 0.4, 0.3))
        assert {r.priority for r in reqs} == {0, 1, 2}

    def test_duration_bound_and_length_clamps(self):
        t0 = 100.0
        reqs = synth_requests(np.random.default_rng(11), rate=40.0, cv=3.0,
                              duration=25.0, t0=t0, prompt_mean=16,
                              decode_mean=4)
        assert reqs
        assert all(t0 < r.arrival <= t0 + 25.0 for r in reqs)
        assert all(16 <= r.prompt_len <= 8192 for r in reqs)
        assert all(4 <= r.max_new_tokens <= 1024 for r in reqs)

    def test_phased_trace_unique_monotone_rids(self):
        reqs = phased_trace(np.random.default_rng(2),
                            [Phase(15, 10, 0.5), Phase(15, 40, 3.0),
                             Phase(15, 10, 1.0)])
        assert [r.rid for r in reqs] == list(range(len(reqs)))
        assert [r.arrival for r in reqs] == sorted(r.arrival for r in reqs)
        assert max(r.arrival for r in reqs) <= 45.0

    @pytest.mark.parametrize("seed", [0, 2, 9])
    def test_phased_trace_equals_reference(self, seed):
        phases = [(15, 10, 0.5), (15, 40, 3.0), (15, 10, 1.0)]
        kw = dict(deadline_s=4.0, priority_mix=(0.2, 0.6, 0.2))
        mine = phased_trace(np.random.default_rng(seed),
                            [Phase(*p) for p in phases], **kw)
        ref = JW.phased_trace(np.random.default_rng(seed),
                              [JW.Phase(*p) for p in phases], **kw)
        assert _fields(mine) == _fields(ref)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_azure_like_trace_equals_reference(self, seed):
        kw = dict(duration=900.0, base_rate=2.0, prompt_mean=64)
        mine = azure_like_trace(np.random.default_rng(seed), **kw)
        ref = JW.azure_like_trace(np.random.default_rng(seed), **kw)
        assert len(mine) > 100
        assert _fields(mine) == _fields(ref)
        assert [r.rid for r in mine] == list(range(len(mine)))


# ---------------------------------------------------------------------------
# cluster (tests/test_serving.py::TestCluster)
# ---------------------------------------------------------------------------

class TestCluster:
    def test_fragmentation_stats_match_paper(self):
        cl = FragmentedCluster.synth(np.random.default_rng(0),
                                     n_servers=430, n_gpus=468)
        assert 0.03 < cl.p_free_gpu() < 0.2           # paper: 0.087
        assert cl.p_colocated(4) < 0.02               # paper: 0.0002
        assert 1.5 < cl.subscription_rate() < 2.5     # paper: 2.16

    def test_allocate_release(self):
        cl = FragmentedCluster.synth(np.random.default_rng(0))
        gpus = cl.find_gpus(4, 5e9)
        assert gpus
        free_before = [g.free_mem for g in gpus]
        cl.allocate(gpus, 5e9)
        assert all(g.free_mem == f - 5e9 for g, f in zip(gpus, free_before))

    @pytest.mark.parametrize("kw", [dict(rng=np.random.default_rng(0)),
                                    dict(seed=5), dict(rng=3),
                                    dict(seed=1, n_servers=430, n_gpus=468)],
                             ids=["generator", "seed", "int", "large"])
    def test_synth_equals_reference(self, kw):
        ref_kw = copy.deepcopy(kw)
        mine, ref = FragmentedCluster.synth(**kw), JCl.FragmentedCluster.synth(
            **ref_kw)
        assert _gpu_table(mine) == _gpu_table(ref)
        assert [(s.sid, s.rack) for s in mine.servers] == \
            [(s.sid, s.rack) for s in ref.servers]
        for f in ("p_free_gpu", "subscription_rate", "mean_utilization"):
            assert getattr(mine, f)() == getattr(ref, f)()
        assert mine.p_colocated(2) == ref.p_colocated(2)

    def test_allocation_calls_equal_reference(self):
        """find, allocate, release (its churn draws) and preempt move the
        same GPUs the same way in both packages."""
        mine, ref = FragmentedCluster.synth(seed=4), \
            JCl.FragmentedCluster.synth(seed=4)
        for n, mem, same in ((4, 5e9, False), (2, 20e9, True),
                             (8, 10e9, False), (3, 30e9, True)):
            a, b = mine.find_gpus(n, mem, same), ref.find_gpus(n, mem, same)
            assert [g.gid for g in a] == [g.gid for g in b]
            mine.allocate(a, mem)
            ref.allocate(b, mem)
            mine.release(a[:1], mem)
            ref.release(b[:1], mem)
            mine.preempt(a[1:2], mem)
            ref.preempt(b[1:2], mem)
            assert _gpu_table(mine) == _gpu_table(ref)


# ---------------------------------------------------------------------------
# simulator (tests/test_serving.py::TestSimulator)
# ---------------------------------------------------------------------------

def _sim(pkg, name, reqs, *, fault_seed=None, duration=60.0, **kw):
    """One ClusterSim run over a deep copy of ``reqs`` (the reference's
    own request class for the reference), on the cluster of seed 1 with
    the simulator's rng seeded 2.  Returns (output, requests, sim)."""
    if pkg == "jax":
        reqs = [JW.Request(**{f.name: getattr(r, f.name)
                              for f in dataclasses.fields(JW.Request)})
                for r in reqs]
        sim_cls, policies, cluster = JSim.ClusterSim, JSim.POLICIES, \
            JCl.FragmentedCluster
        inj = JF.FaultInjector
    else:
        reqs = copy.deepcopy(reqs)
        sim_cls, policies, cluster = ClusterSim, POLICIES, FragmentedCluster
        inj = FaultInjector
    if fault_seed is not None:
        kw["fault_injector"] = inj(seed=fault_seed, horizon=duration,
                                   preempt_rate=1 / 20.0)
        kw.setdefault("peak_instances", 4)
    sim = sim_cls(copy.deepcopy(policies[name]),
                  cluster.synth(np.random.default_rng(1)),
                  np.random.default_rng(2), slo=4.0, **kw)
    return sim.run(reqs), reqs, sim


class TestSimulator:
    def _run(self, name, cv, seed=0, duration=240.0):
        reqs = synth_requests(np.random.default_rng(seed), rate=20.0, cv=cv,
                              duration=duration, deadline_s=4.0)
        out, _, _ = _sim("torch", name, reqs)
        return out, len(reqs)

    def test_no_request_lost(self):
        out, n = self._run("flexpipe", cv=2.0)
        assert out["completed"] == n

    def test_goodput_bounded_by_offered_load(self):
        out, n = self._run("alpaserve", cv=1.0)
        assert out["goodput"] <= n / 240.0 * 1.05

    def test_flexpipe_beats_static_under_burst(self):
        fp, _ = self._run("flexpipe", cv=6.0, duration=300.0)
        ap, _ = self._run("alpaserve", cv=6.0, duration=300.0)
        assert fp["latency"]["p99"] < ap["latency"]["p99"]
        assert fp["refactor_count"] > 0

    def test_table2_profile_trends(self):
        p4, p32 = table2_profile(4), table2_profile(32)
        assert p32.load_time < p4.load_time          # 8.7x faster load
        assert p32.comm_ms > p4.comm_ms              # more hops
        assert p32.batch > p4.batch                  # bigger batches

    @pytest.mark.parametrize("scale", [1.0, 0.5])
    def test_table2_profiles_equal_reference(self, scale):
        assert TABLE2 == JSim.TABLE2
        for S in range(1, 41):
            assert dataclasses.asdict(table2_profile(S, scale)) == \
                dataclasses.asdict(JSim.table2_profile(S, scale))

    def test_policies_equal_reference(self):
        assert list(POLICIES) == list(JSim.POLICIES)
        for name, pol in POLICIES.items():
            assert dataclasses.asdict(pol) == \
                dataclasses.asdict(JSim.POLICIES[name])

    @pytest.mark.parametrize("name", list(POLICIES))
    def test_run_equals_reference_on_a_phased_trace(self, name):
        """A calm, a bursty and a calm phase, with deadlines and priority
        classes: the outputs, the stats and every request's lifecycle are
        the reference's, number for number."""
        reqs = phased_trace(np.random.default_rng(3),
                            [Phase(20, 10, 0.5), Phase(20, 60, 4.0),
                             Phase(20, 10, 1.0)],
                            deadline_s=4.0, priority_mix=(0.2, 0.6, 0.2))
        out, mine, sim = _sim("torch", name, reqs)
        ref, theirs, jsim = _sim("jax", name, reqs)
        assert repr(out) == repr(ref)
        assert _fields(mine, REQ_FIELDS + LIFECYCLE) == \
            _fields(theirs, REQ_FIELDS + LIFECYCLE)
        assert repr(sim.stats) == repr(jsim.stats)
        assert _gpu_table(sim.cluster) == _gpu_table(jsim.cluster)
        assert out["completed"] > 0


# ---------------------------------------------------------------------------
# tests/test_faults.py::TestSimulatorFaults
# ---------------------------------------------------------------------------

def _fault_run(policy, fault_seed, pkg="torch"):
    reqs = synth_requests(np.random.default_rng(0), rate=20.0, cv=2.0,
                          duration=60.0, deadline_s=4.0)
    out, _, sim = _sim(pkg, policy, reqs, fault_seed=fault_seed)
    out["counters"] = dict(sim.stats.counters)
    out["recoveries"] = list(sim.stats.recovery_times)
    return out


class TestSimulatorFaults:
    def test_flexpipe_refactors_baseline_cold_restarts(self):
        flex = _fault_run("flexpipe", 7)
        cold = _fault_run("alpaserve", 7)
        assert flex["counters"]["preemptions"] >= 1
        assert flex["counters"]["emergency_refactors"] == \
            flex["counters"]["preemptions"]
        assert "cold_restarts" not in flex["counters"]
        assert cold["counters"]["cold_restarts"] == \
            cold["counters"]["preemptions"]
        assert np.median(flex["recoveries"]) < np.median(cold["recoveries"])

    def test_same_fault_seed_reproducible(self):
        assert repr(_fault_run("flexpipe", 3)) == \
            repr(_fault_run("flexpipe", 3))

    def test_cluster_synth_seed_contract(self):
        free = [[g.free_mem for s in FragmentedCluster.synth(seed=k).servers
                 for g in s.gpus] for k in (5, 5, 6)]
        assert free[0] == free[1] and free[0] != free[2]

    @pytest.mark.parametrize("policy", ["flexpipe", "alpaserve"])
    def test_fault_runs_equal_reference(self, policy):
        assert repr(_fault_run(policy, 7)) == \
            repr(_fault_run(policy, 7, pkg="jax"))


# ---------------------------------------------------------------------------
# tests/test_admission.py::TestSimulatorOverload
# ---------------------------------------------------------------------------

class TestSimulatorOverload:
    def _run(self, name, rate, duration=120.0, pkg="torch", **overrides):
        reqs = synth_requests(np.random.default_rng(0), rate=rate, cv=2.0,
                              duration=duration, deadline_s=4.0,
                              priority_mix=(0.2, 0.6, 0.2))
        pols = POLICIES if pkg == "torch" else JSim.POLICIES
        saved = copy.deepcopy(pols[name])
        try:
            for k, v in overrides.items():
                setattr(pols[name], k, v)
            out, reqs, _ = _sim(pkg, name, reqs)
        finally:
            pols[name] = saved
        return out, reqs

    def test_overload_policy_sheds_and_accounts(self):
        out, reqs = self._run("flexpipe-overload", rate=120.0,
                              admission_depth=64)
        assert out["rejected"] + out["shed"] > 0
        assert not out["accounting_violations"]
        acct = out["accounting"]
        assert acct["completed"] + acct["rejected"] + acct["shed"] \
            + acct["failed"] == len(reqs)

    def test_overload_policy_beats_static_baseline_goodput(self):
        hot, _ = self._run("flexpipe-overload", rate=120.0)
        cold, _ = self._run("alpaserve", rate=120.0)
        assert hot["goodput"] > cold["goodput"]

    def test_legacy_policies_unaffected(self):
        out, reqs = self._run("flexpipe", rate=20.0)
        assert out["rejected"] == 0 and out["shed"] == 0
        assert out["completed"] == len(reqs)

    @settings(max_examples=6, deadline=None)
    @given(rate=st.sampled_from([30.0, 90.0, 150.0]),
           depth=st.sampled_from([32, 128]),
           seed=st.integers(min_value=0, max_value=3))
    def test_accounting_invariant_property(self, rate, depth, seed):
        pol = copy.deepcopy(POLICIES["flexpipe-overload"])
        pol.admission_depth = depth
        reqs = synth_requests(np.random.default_rng(seed), rate=rate, cv=3.0,
                              duration=90.0, deadline_s=4.0,
                              priority_mix=(0.3, 0.4, 0.3))
        sim = ClusterSim(pol,
                         FragmentedCluster.synth(np.random.default_rng(1)),
                         np.random.default_rng(2), slo=4.0)
        out = sim.run(reqs)
        assert all(s != "ambiguous" for _, s in out["accounting_violations"])
        pending = sum(1 for _, s in out["accounting_violations"]
                      if s == "pending")
        assert sum(out["accounting"].values()) + pending == len(reqs)
        assert out["accounting"]["rejected"] == out["overload"]["rejected"]
        assert out["accounting"]["shed"] == out["overload"]["shed"]

    def test_overload_run_equals_reference(self):
        kw = dict(rate=120.0, duration=60.0, admission_depth=64)
        out, _ = self._run("flexpipe-overload", **kw)
        ref, _ = self._run("flexpipe-overload", pkg="jax", **kw)
        assert repr(out) == repr(ref)
        assert out["shed"] + out["rejected"] > 0


# ---------------------------------------------------------------------------
# tests/test_admission.py::TestControllerSaturation, against the reference
# ---------------------------------------------------------------------------

class TestControllerSaturation:
    def _controllers(self):
        """The port's and the reference's controller over the same two
        profiles, fed the same metronome arrivals (CV about 0)."""
        out = []
        for prof, ctl in ((GranularityProfile, RefactoringController),
                          (JaxProfile, JaxController)):
            c = ctl([prof(stages=4, batch=8, throughput=100, latency=0.4,
                          cv_opt=0.5),
                     prof(stages=16, batch=32, throughput=140, latency=0.9,
                          cv_opt=4.0)], cooldown_s=0.0, switch_margin=0.0)
            for k in range(40):
                c.record_arrival(k * 0.1)
            out.append(c)
        return out

    @staticmethod
    def _same(a, b):
        assert (a.target.stages, a.changed, a.reason) == \
            (b.target.stages, b.changed, b.reason)

    def test_saturation_steers_toward_deep_pipeline(self):
        ctl, jctl = self._controllers()
        calm = ctl.step(4.0, saturation=0.0)
        self._same(calm, jctl.step(4.0, saturation=0.0))
        assert calm.target.stages == 4
        hot = ctl.step(4.1, saturation=1.0)
        self._same(hot, jctl.step(4.1, saturation=1.0))
        assert hot.target.stages == 16
        assert "sat=1.00" in hot.reason

    def test_saturation_decision_reverts_when_calm(self):
        ctl, jctl = self._controllers()
        self._same(ctl.step(4.0, saturation=1.0),
                   jctl.step(4.0, saturation=1.0))
        back = ctl.step(4.1, saturation=0.0)
        self._same(back, jctl.step(4.1, saturation=0.0))
        assert back.target.stages == 4
