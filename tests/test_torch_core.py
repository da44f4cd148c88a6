"""repro_torch's controller plane against the JAX package's: partitioner
(Eq. 2), CV monitor, granularity selection (Eq. 4-5), allocation (Eq. 6-9),
scaling (Eq. 11-12), HRG, affinity (Eq. 13), the migration model and
Algorithm 1.  Mirrors tests/test_core.py, TestControllerSaturation of
tests/test_admission.py and the migration_plan cases of tests/test_engine.py,
then holds every piece against the reference on the same inputs."""
import math
import random
import statistics

import numpy as np
import pytest

from hypothesis_compat import given, settings, st

from repro.configs.base import get_arch as jax_arch
from repro.core import affinity as JAf
from repro.core import allocation as JAl
from repro.core import controller as JC
from repro.core import cv_monitor as JCV
from repro.core import granularity as JG
from repro.core import hrg as JH
from repro.core import partitioner as JP
from repro.core import refactoring as JR
from repro.core import scaling as JS
from repro.core.graph import build_graph as jax_build_graph
from repro.launch import roofline as R
from repro.models.kvcache import migration_plan as jax_migration_plan
from repro.models.kvcache import regroup as jax_regroup
from repro_torch.configs.base import get_arch
from repro_torch.core.affinity import AffinityScheduler, HostParamCache
from repro_torch.core.allocation import (GPU, StageReq, allocate,
                                         multiplexing_penalty)
from repro_torch.core.controller import ControllerConfig, FlexPipeController
from repro_torch.core.cv_monitor import CVMonitor, gamma_interarrivals
from repro_torch.core.granularity import (GranularityProfile,
                                          gg_s_total_latency, instances,
                                          optimal_stage_count, score, select)
from repro_torch.core.graph import (batch_aware_activation, build_graph,
                                    fit_alpha)
from repro_torch.core.hrg import HierarchicalResourceGraph
from repro_torch.core.partitioner import candidate_partitions, partition
from repro_torch.core.refactoring import (RefactoringController,
                                          plan_migration)
from repro_torch.core.scaling import (decide_scale_up, scaling_granularity,
                                      slo_feasible)
from repro_torch.launch.roofline import H100_SXM, Chip
from repro_torch.models.kvcache import migration_plan, regroup
from repro_torch.serving.engine import balanced_boundaries

CFG = get_arch("qwen1.5-0.5b").config
NODES = build_graph(CFG)
REF_CHIP = Chip(hbm_bw=R.HBM_BW, flops_f32=R.PEAK_FLOPS,
                flops_bf16=R.PEAK_FLOPS, link_bw=R.ICI_BW, host_bw=R.DCN_BW,
                hbm_bytes=16 * 1024**3)
REL = 1e-12
QS_PROFILES = ((2, 8, 90, 0.4, 0.5), (4, 16, 110, 0.6, 2.5))


# ---------------------------------------------------------------------------
# mirrors of tests/test_core.py
# ---------------------------------------------------------------------------

class TestPartitioner:
    def test_partition_covers_all_ops(self):
        for k in (2, 4, 8):
            p = partition(NODES, k)
            assert p.n_stages == k
            assert p.boundaries[0] == 0
            assert list(p.boundaries) == sorted(set(p.boundaries))

    def test_balanced_stages(self):
        p = partition(NODES, 4)
        cs = p.stage_compute
        assert max(cs) / max(min(cs), 1e-12) < 1.5, "stages must be balanced"

    def test_memory_cap_respected(self):
        cap = sum(n.s_p for n in NODES) / 3
        p = partition(NODES, 8, mem_cap=cap)
        assert max(p.stage_params) <= cap

    def test_infeasible_cap_raises(self):
        with pytest.raises(ValueError):
            partition(NODES, 2, mem_cap=1.0)

    @settings(max_examples=10, deadline=None)
    @given(k=st.sampled_from([2, 3, 4, 6, 8, 12]))
    def test_more_stages_smaller_max(self, k):
        p1 = partition(NODES, k)
        p2 = partition(NODES, k * 2)
        assert max(p2.stage_params) <= max(p1.stage_params) * 1.01

    def test_pattern_boundary_preference(self):
        p = partition(NODES, 4, lam=10.0, pattern_penalty=5.0)
        for b in p.boundaries:
            assert NODES[b].pattern_boundary

    def test_batch_aware_scaling_fit(self):
        base = 1e6
        samples = [(b, batch_aware_activation(base, b, 8, alpha=0.3))
                   for b in (8, 16, 32, 64)]
        assert abs(fit_alpha(samples, 8, base) - 0.3) < 1e-6

    def test_h100_cuts_of_full_qwen_are_balanced(self):
        """Every qwen layer costs the same, so the 2- and 4-stage cuts the
        controller computes are the balanced boundaries the engine uses."""
        for k in (2, 4, 8):
            assert partition(NODES, k).layer_boundaries(NODES) == \
                balanced_boundaries(CFG.n_layers, k)


class TestCVMonitor:
    @settings(max_examples=8, deadline=None)
    @given(cv=st.sampled_from([0.3, 1.0, 2.0, 4.0]))
    def test_recovers_target_cv(self, cv):
        rng = np.random.default_rng(42)
        m = CVMonitor()
        t = 0.0
        for iv in gamma_interarrivals(rng, rate=50.0, cv=cv, n=4000):
            t += iv
            m.record(t)
        est = m.estimate(t, window=t)
        assert abs(est.cv - cv) / cv < 0.35

    def test_velocity_sign(self):
        m = CVMonitor()
        t = 0.0
        for _ in range(100):
            t += 1.0
            m.record(t)
        for _ in range(200):
            t += 0.05
            m.record(t)
        assert m.velocity(t) > 0


class TestGranularity:
    PROFILES = [
        GranularityProfile(2, 64, 80, 0.3, 0.3),
        GranularityProfile(8, 256, 100, 0.6, 2.0),
        GranularityProfile(32, 1024, 120, 1.2, 5.0),
    ]

    def test_low_cv_picks_coarse(self):
        assert select(self.PROFILES, 0.2).stages == 2

    def test_high_cv_picks_fine(self):
        assert select(self.PROFILES, 6.0).stages == 32

    def test_instances_eq5(self):
        p = self.PROFILES[1]
        n = instances(p, total_capacity=1000.0, beta1=1.0, beta2=0.05)
        assert n == int(1000.0 / (100 / (1.0 + 0.05 * 8)))

    def test_optimal_stage_sqrt_law(self):
        assert optimal_stage_count(1.0) <= 4
        assert optimal_stage_count(9.0) >= 8
        assert optimal_stage_count(16.0) >= optimal_stage_count(9.0)


class TestAllocation:
    def _gpus(self, n=8, mem=80e9):
        return [GPU(gpu_id=i, server=i // 2, mem_capacity=mem)
                for i in range(n)]

    def test_same_model_never_colocated(self):
        stages = [StageReq("m0", i, 10e9, 100.0, 1.0) for i in range(4)]
        a = allocate(stages, self._gpus())
        assert len(set(a.placement.values())) == 4

    def test_memory_cap(self):
        stages = [StageReq("m0", 0, 70e9, 100.0, 1.0),
                  StageReq("m1", 0, 70e9, 100.0, 1.0)]
        a = allocate(stages, self._gpus(n=2))
        gpus = [a.placement[("m0", 0)], a.placement[("m1", 0)]]
        assert gpus[0] != gpus[1]

    def test_rejects_when_full(self):
        stages = [StageReq(f"m{i}", 0, 79e9, 100.0, 1.0) for i in range(3)]
        a = allocate(stages, self._gpus(n=2))
        assert len(a.rejected) == 1

    def test_penalty_quadratic_in_cv(self):
        assert multiplexing_penalty(4.0) / multiplexing_penalty(0.0) == \
            1 + 0.5 * 16


class TestScaling:
    def test_sigmoid_monotone(self):
        ms = [scaling_granularity(cv, 500.0) for cv in (0.1, 1.0, 4.0, 8.0)]
        assert ms == sorted(ms)
        assert ms[-1] > ms[0]

    def test_calm_system_coarse(self):
        assert scaling_granularity(0.1, 1.0) <= 4

    def test_slo_eq12(self):
        assert slo_feasible(deadline=2.0, init_time=0.5,
                            stage_throughputs=[100.0] * 4, queue_len=100,
                            required=5.0)
        assert not slo_feasible(deadline=0.4, init_time=0.5,
                                stage_throughputs=[100.0], queue_len=100,
                                required=5.0)


class TestHRGAffinity:
    def test_hrg_avoids_contended_path(self):
        hrg = HierarchicalResourceGraph()
        hrg.add_rack("r0")
        hrg.add_server("r0", "a")
        hrg.add_server("r0", "b")
        hrg.reserve("a", 30e9)
        assert hrg.least_contended(["a", "b"], now=0.0) == "b"

    def test_transfer_time_degrades_under_contention(self):
        hrg = HierarchicalResourceGraph()
        hrg.add_rack("r0")
        hrg.add_server("r0", "a")
        t0 = hrg.transfer_time("a", 10e9, now=0.0)
        hrg.reserve("a", 30e9)
        assert hrg.transfer_time("a", 10e9, now=0.0) > t0

    def test_affinity_prefers_recent_host(self):
        s = AffinityScheduler()
        s.record_placement("m", "warm", now=100.0)
        pick = s.select("m", {"warm": 1, "cold": 1}, now=110.0)
        assert pick == "warm"

    def test_host_cache_warm_vs_cold(self):
        c = HostParamCache()
        c.put("s0", "m", 0, 10e9, now=0.0)
        assert c.load_time("s0", "m", 0, 10e9) < \
            c.load_time("s1", "m", 0, 10e9)

    def test_host_cache_lru_eviction(self):
        c = HostParamCache(capacity_bytes=25e9)
        for i in range(4):
            c.put("s0", "m", i, 10e9, now=float(i))
        assert not c.has("s0", "m", 0)
        assert c.has("s0", "m", 3)


# ---------------------------------------------------------------------------
# mirrors of tests/test_admission.py::TestControllerSaturation
# ---------------------------------------------------------------------------

class TestControllerSaturation:
    def _profiles(self):
        return [GranularityProfile(stages=4, batch=8, throughput=100,
                                   latency=0.4, cv_opt=0.5),
                GranularityProfile(stages=16, batch=32, throughput=140,
                                   latency=0.9, cv_opt=4.0)]

    def test_saturation_steers_toward_deep_pipeline(self):
        ctl = RefactoringController(self._profiles(), cooldown_s=0.0,
                                    switch_margin=0.0)
        for k in range(40):                  # metronome arrivals: cv ~ 0
            ctl.record_arrival(k * 0.1)
        calm = ctl.step(4.0, saturation=0.0)
        assert calm.target.stages == 4
        hot = ctl.step(4.1, saturation=1.0)
        assert hot.target.stages == 16
        assert "sat=1.00" in hot.reason

    def test_saturation_decision_reverts_when_calm(self):
        ctl = RefactoringController(self._profiles(), cooldown_s=0.0,
                                    switch_margin=0.0)
        for k in range(40):
            ctl.record_arrival(k * 0.1)
        ctl.step(4.0, saturation=1.0)
        back = ctl.step(4.1, saturation=0.0)
        assert back.target.stages == 4

    def test_needs_a_profile(self):
        with pytest.raises(ValueError, match="profile"):
            RefactoringController([])


# ---------------------------------------------------------------------------
# migration (mirrors tests/test_engine.py's migration_plan cases)
# ---------------------------------------------------------------------------

def test_migration_plan_counts_moved_layers():
    moves = migration_plan([0, 2], [0, 1, 2, 3], 4)
    assert (1, 0, 1) in moves and (3, 1, 3) in moves
    assert migration_plan([0, 2], [0, 2], 4) == []


@pytest.mark.parametrize("old,new,n", [
    ([0, 2], [0, 1, 2, 3], 4), ([0, 12], [0, 6, 12, 18], 24),
    ([0, 6, 12, 18], [0, 12], 24), ([0, 3, 7], [0, 5], 10), ([0], [0], 3)])
def test_migration_and_regroup_equal_reference(old, new, n):
    assert migration_plan(old, new, n) == jax_migration_plan(old, new, n)
    per_layer = [{"layer": i} for i in range(n)]
    staged = [per_layer[b:e] for b, e in zip(old, old[1:] + [n])]
    mine = regroup(staged, new)
    assert mine == jax_regroup(staged, new)
    assert all(a is b for s in mine for a, b in
               zip(s, per_layer[new[mine.index(s)]:]))     # zero-copy
    kw = dict(cache_bytes_per_layer=2e6, param_bytes_per_layer=5e7)
    a = plan_migration(old, new, n, link_bw=50e9, **kw)
    b = JR.plan_migration(old, new, n, **kw)
    assert a.moved_layers == b.moved_layers
    for f in ("cache_bytes_moved", "param_bytes_moved", "transfer_s",
              "delta_sync_s"):
        assert getattr(a, f) == pytest.approx(getattr(b, f), rel=REL), f
    h = plan_migration(old, new, n, **kw)               # over NVLink
    assert h.transfer_s == pytest.approx(
        len(h.moved_layers) * (2e6 + 5e7) / H100_SXM.link_bw, rel=REL)


# ---------------------------------------------------------------------------
# differential: the same inputs through the port and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-1.6b"])
def test_partitions_equal_reference(arch):
    nodes = build_graph(get_arch(arch).config, chip=REF_CHIP,
                        bytes_per_el=R.BYTES)
    jnodes = jax_build_graph(jax_arch(arch).config)
    ref_kw = dict(bandwidth=50e9, mem_cap=16 * 1024**3)
    for k in (1, 2, 3, 4, 6, 8, 12, 16):
        for extra in ({}, {"lam": 10.0, "pattern_penalty": 5.0},
                      {"target_cycle": 1e-3},
                      {"mem_cap": sum(n.s_p for n in nodes) / 3}):
            kw = {**ref_kw, **extra}
            if k < 3 and "lam" not in extra and "target_cycle" not in extra \
                    and extra:
                for fn, ns in ((partition, nodes), (JP.partition, jnodes)):
                    with pytest.raises(ValueError, match="infeasible"):
                        fn(ns, k, **kw)
                continue
            a, b = partition(nodes, k, **kw), JP.partition(jnodes, k, **kw)
            assert a.boundaries == b.boundaries, (k, extra)
            assert a.cost == pytest.approx(b.cost, rel=1e-9, abs=1e-15)
            assert a.layer_boundaries(nodes) == b.layer_boundaries(jnodes)
            assert [a.stage_of(i) for i in range(len(nodes))] == \
                [b.stage_of(i) for i in range(len(jnodes))]
    got = candidate_partitions(nodes, [2, 4, 64], **ref_kw)
    want = JP.candidate_partitions(jnodes, [2, 4, 64], **ref_kw)
    assert sorted(got) == sorted(want) == [2, 4]
    assert all(got[k].boundaries == want[k].boundaries for k in got)


@pytest.mark.parametrize("cv", [0.0, 0.4, 1.0, 5.0])
def test_cv_monitor_equals_reference(cv):
    ivs = gamma_interarrivals(np.random.default_rng(7), 20.0, cv, 600)
    assert ivs == JCV.gamma_interarrivals(np.random.default_rng(7), 20.0,
                                          cv, 600)
    mine, ref = CVMonitor(), JCV.CVMonitor()
    t = 0.0
    for i, iv in enumerate(ivs):
        t += iv
        mine.record(t)
        ref.record(t)
        if i % 50 == 0:
            for w in (None, 1.0, 15.0):
                assert vars(mine.estimate(t, w)) == vars(ref.estimate(t, w))
            assert mine.rate(t) == ref.rate(t)
            assert mine.velocity(t) == ref.velocity(t)
    assert {w: vars(e) for w, e in mine.multi_window(t).items()} == \
        {w: vars(e) for w, e in ref.multi_window(t).items()}


def test_granularity_equals_reference():
    rng = np.random.default_rng(3)
    for _ in range(40):
        n = int(rng.integers(1, 5))
        rows = [(int(2 ** rng.integers(1, 6)), int(rng.integers(1, 64)),
                 float(rng.uniform(10, 200)), float(rng.uniform(0.1, 2)),
                 float(rng.uniform(0, 6))) for _ in range(n)]
        mine = [GranularityProfile(*r) for r in rows]
        ref = [JG.GranularityProfile(*r) for r in rows]
        for cv in (0.0, 0.7, 2.5, 8.0):
            for alpha, sigma in ((0.5, 1.0), (0.2, 3.0)):
                assert vars(select(mine, cv, alpha, sigma)) == \
                    vars(JG.select(ref, cv, alpha, sigma))
                kw = dict(t_max=150.0, l_min=0.2, alpha=alpha, sigma=sigma)
                assert score(mine[0], cv, **kw) == JG.score(ref[0], cv, **kw)
        assert instances(mine[0], 1000.0) == JG.instances(ref[0], 1000.0)
    for cv in (0.5, 3.0, 4.0, 9.0, 30.0):
        assert optimal_stage_count(cv) == JG.optimal_stage_count(cv)
        for S in (1, 4, 8):
            args = (S, 0.7, cv, 1.0, 40.0, 50.0)
            assert gg_s_total_latency(*args) == JG.gg_s_total_latency(*args)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocation_equals_reference(seed):
    rng = np.random.default_rng(seed)
    rows = [(f"m{int(rng.integers(0, 4))}", i, float(rng.uniform(5e9, 40e9)),
             float(rng.uniform(50, 150)), float(rng.uniform(0, 4)),
             int(rng.integers(0, 2))) for i in range(12)]
    gpus = [(i, i // 2, 80e9) for i in range(6)]
    a = allocate([StageReq(*r) for r in rows], [GPU(*g) for g in gpus],
                 rng=random.Random(seed))
    b = JAl.allocate([JAl.StageReq(*r) for r in rows],
                     [JAl.GPU(*g) for g in gpus], rng=random.Random(seed))
    assert a.placement == b.placement
    assert a.objective == b.objective
    assert [vars(s) for s in a.rejected] == [vars(s) for s in b.rejected]
    for cv in (0.0, 1.5):
        assert multiplexing_penalty(cv) == JAl.multiplexing_penalty(cv)


def test_scaling_equals_reference():
    for cv in (0.0, 0.5, 2.0, 6.0):
        for q in (0.0, 10.0, 500.0, 5000.0):
            assert scaling_granularity(cv, q) == JS.scaling_granularity(cv, q)
            kw = dict(cv=cv, queue_len=q, deadline=2.0,
                      init_time_per_stage=0.3, stage_throughput=100.0,
                      required_rate=5.0)
            assert vars(decide_scale_up(**kw)) == \
                vars(JS.decide_scale_up(**kw))


def _hrg_script(hrg_cls, aff_cls, cache_cls):
    """One sequence of HRG, affinity and host-cache operations; returns
    every pick, pressure and time it produced."""
    out = []
    hrg = hrg_cls()
    for r in range(2):
        hrg.add_rack(f"r{r}", net_bw=12.5e9 * (r + 1))
        for s in range(3):
            hrg.add_server(f"r{r}", f"s{r}{s}", pcie_bw=32e9 / (s + 1))
    names = sorted(hrg.servers)
    for t in range(12):
        srv = names[(5 * t) % len(names)]
        hrg.reserve(srv, 3e9 * (t % 4))
        hrg.mark_event(srv, float(t), 1e10)
        if t % 3 == 2:
            hrg.release(srv, 2e9)
        out.append((hrg.least_contended(names, float(t)),
                    hrg.path_pressure(srv, float(t)),
                    hrg.transfer_time(srv, 5e9, float(t))))
    aff = aff_cls()
    pool = {n: i % 3 for i, n in enumerate(names)}
    for t in range(8):
        model = f"m{t % 2}"
        pick = aff.select(model, pool, 10.0 * t)
        aff.record_placement(model, pick, 10.0 * t)
        out.append((pick, aff.score(model, pick, 10.0 * t + 5, 2)))
    cache = cache_cls(capacity_bytes=30e9)
    for i in range(6):
        cache.put(names[i % 2], "m", i, 8e9, now=float(i))
        out.append([cache.has(names[i % 2], "m", j) for j in range(6)])
        out.append(cache.load_time(names[0], "m", i, 8e9, host_bw=32e9))
    return out


def test_hrg_affinity_equal_reference():
    assert _hrg_script(HierarchicalResourceGraph, AffinityScheduler,
                       HostParamCache) == \
        _hrg_script(JH.HierarchicalResourceGraph, JAf.AffinityScheduler,
                    JAf.HostParamCache)


def test_host_link_defaults_are_the_h100s():
    """The host link that HRG servers and warm starts default to is the
    card's (PCIe Gen5 x16)."""
    hrg = HierarchicalResourceGraph()
    hrg.add_rack("r0")
    assert hrg.add_server("r0", "a").capacity == H100_SXM.host_bw == 64e9
    cache = HostParamCache()
    cache.put("a", "m", 0, 8e9, now=0.0)
    assert cache.load_time("a", "m", 0, 8e9) == 8e9 / H100_SXM.host_bw
    assert cache.load_time("b", "m", 0, 8e9) == 8e9 / 2e9


def _arrivals(seed=0):
    """The quickstart's arrival trace: calm, then a burst."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for iv in gamma_interarrivals(rng, 4.0, 0.4, 40):
        t += iv
        out.append(t)
    t = 4.0
    for iv in gamma_interarrivals(rng, 40.0, 5.0, 200):
        t += iv
        out.append(t)
    return sorted(out)


@pytest.mark.parametrize("kw", [{}, {"cooldown_s": 0.0, "switch_margin": 0.0},
                                {"alpha": 0.2, "sigma": 2.0,
                                 "saturation_gain": 0.5}])
def test_refactoring_controller_equals_reference(kw):
    """Algorithm 1 over a seeded arrival trace and a saturation ramp: the
    same decisions, reasons and history (score_s is a host clock)."""
    rows = QS_PROFILES + ((8, 32, 130, 0.9, 4.0),)
    mine = RefactoringController([GranularityProfile(*r) for r in rows],
                                 **kw)
    ref = JR.RefactoringController([JG.GranularityProfile(*r) for r in rows],
                                   **kw)
    arr = iter(_arrivals())
    nxt = next(arr)
    changed, scores = 0, []
    for tick in range(400):
        now = tick * 0.05
        while nxt is not None and nxt <= now:
            mine.record_arrival(nxt)
            ref.record_arrival(nxt)
            nxt = next(arr, None)
        if tick % 10:
            continue
        q, sat = float(tick % 7), max(0.0, math.sin(tick / 40.0))
        a, b = mine.step(now, q, sat), ref.step(now, q, sat)
        assert (vars(a.target), a.changed, a.reason) == \
            (vars(b.target), b.changed, b.reason), now
        assert math.isfinite(a.score_s) and a.score_s >= 0.0
        scores.append(a.score_s)
        changed += a.changed
    assert mine.history == ref.history
    assert changed == len(mine.history) >= 1
    # the paper's < 5 ms, on the median: score_s is a host interval, and one
    # step preempted in a loaded worker must not decide it
    assert statistics.median(scores) < 5e-3


def test_flexpipe_controller_equals_reference():
    """FlexPipeController on full-width qwen1.5-0.5b with the quickstart's
    profiles: its partitions are the balanced cuts, and each control step,
    scaling decision and placement equals the reference's."""
    cfg, jcfg = CFG, jax_arch("qwen1.5-0.5b").config
    mine = FlexPipeController(cfg, [GranularityProfile(*r)
                                    for r in QS_PROFILES])
    ref = JC.FlexPipeController(jcfg, [JG.GranularityProfile(*r)
                                       for r in QS_PROFILES])
    assert ControllerConfig().mem_cap == H100_SXM.hbm_bytes
    assert sorted(mine.partitions) == sorted(ref.partitions) == [2, 4, 8, 16]
    for k, p in mine.partitions.items():
        assert p.layer_boundaries(mine.nodes) == \
            ref.partitions[k].layer_boundaries(ref.nodes)
    for srv in ("a", "b"):
        for c in (mine, ref):
            if not c.hrg.racks:
                c.hrg.add_rack("r0")
            c.hrg.add_server("r0", srv, pcie_bw=32e9)
    migrations = 0
    arr = iter(_arrivals(1))
    nxt = next(arr)
    for tick in range(300):
        now = tick * 0.05
        while nxt is not None and nxt <= now:
            mine.on_request(nxt)
            ref.on_request(nxt)
            nxt = next(arr, None)
        if tick % 10:
            continue
        (a, ma), (b, mb) = (mine.control_step(now, tick % 5),
                            ref.control_step(now, tick % 5))
        assert (a.target.stages, a.changed, a.reason) == \
            (b.target.stages, b.changed, b.reason)
        assert (ma is None) == (mb is None)
        if ma is not None:
            migrations += 1
            assert ma.moved_layers == mb.moved_layers
            assert ma.cache_bytes_moved == mb.cache_bytes_moved
        s, t = mine.scale_decision(now, 100.0, 5.0), \
            ref.scale_decision(now, 100.0, 5.0)
        assert vars(s) == vars(t)
        servers = {"a": tick % 3, "b": 2}
        assert mine.place_instance("m", servers, now) == \
            ref.place_instance("m", servers, now)
    assert migrations >= 1
