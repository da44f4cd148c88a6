"""repro_torch's overload protection against the JAX package (mirrors
tests/test_admission.py): the cost model (its roofline prior is held in
test_torch_roofline.py), the bounded EDF admission queue, brownout, and the
engine under overload, whose per-request terminal states, queue waits, degraded
budgets and streams equal the reference engine's on the same trace."""
import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_arch as jax_arch
from repro.models.transformer import init_model as jax_init_model
from repro.serving import admission as JA
from repro.serving import engine as JE
from repro.serving.faults import FaultPolicy as JaxFaultPolicy
from repro.serving.workload import Request as JaxRequest
from repro.serving.workload import synth_requests as jax_synth
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.serving import engine as TE
from repro_torch.serving.admission import (ADMITTED, PRIO_BATCH,
                                           PRIO_INTERACTIVE, PRIO_STANDARD,
                                           REJECTED, AdmissionConfig,
                                           AdmissionQueue, BrownoutController,
                                           CostModel)
from repro_torch.serving.faults import FaultPolicy
from repro_torch.serving.workload import (Request, TERMINAL_STATES,
                                          audit_requests, synth_requests)

torch.set_num_threads(2)

JCFG = jax_arch("qwen1.5-0.5b").smoke_config
CFG = get_arch("qwen1.5-0.5b").smoke_config
JPARAMS = jax_init_model(jax.random.PRNGKey(0), JCFG)
PARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), "cpu")


def _req(rid=0, arrival=0.0, prompt=8, tokens=4, deadline=10.0, prio=1):
    return Request(rid=rid, arrival=arrival, prompt_len=prompt,
                   max_new_tokens=tokens, deadline_s=deadline, priority=prio)


class TestCostModel:
    def test_estimate_linear_in_tokens(self):
        cm = CostModel.from_tick(0.05)
        assert cm.estimate(10, 4) == pytest.approx(0.05 + 4 * 0.05)
        assert cm.estimate(10, 8) > cm.estimate(10, 4)
        ref = JA.CostModel.from_tick(0.05, prefill_tokens_per_tick=16)
        mine = CostModel.from_tick(0.05, prefill_tokens_per_tick=16)
        assert mine.estimate(100, 7) == ref.estimate(100, 7)

    def test_observe_ema_moves_toward_sample(self):
        cm = CostModel(decode_s_per_token=0.1, ema=0.5)
        cm.observe_decode(0.2)
        assert cm.decode_s_per_token == pytest.approx(0.15)
        cm.observe_prefill(10, 1.0)
        assert cm.prefill_s_per_token > 0


class TestAdmissionQueue:
    def _q(self, **kw):
        return AdmissionQueue(AdmissionConfig(**kw),
                              cost=CostModel.from_tick(0.05))

    def test_reject_on_full_is_fast_fail(self):
        q = self._q(max_queue_depth=2)
        assert q.submit(_req(0), 0.0) == ADMITTED
        assert q.submit(_req(1), 0.0) == ADMITTED
        r = _req(2)
        assert q.submit(r, 0.0) == REJECTED
        assert r.rejected and r.fail_reason == "queue_full"
        assert r.terminal_state == "rejected"
        assert len(q) == 2 and len(q.rejected) == 1
        assert q.stats.counters["rejected"] == 1

    def test_edf_orders_by_absolute_deadline(self):
        q = self._q(max_queue_depth=8)
        late, soon = _req(0, deadline=9.0), _req(1, deadline=2.0)
        q.submit(late, 0.0)
        q.submit(soon, 0.0)
        assert q.pop_admissible(0.0) is soon
        assert q.pop_admissible(0.0) is late

    def test_priority_class_trumps_deadline(self):
        q = self._q(max_queue_depth=8)
        q.submit(_req(0, deadline=1.0, prio=PRIO_BATCH), 0.0)
        inter = _req(1, deadline=8.0, prio=PRIO_INTERACTIVE)
        q.submit(inter, 0.0)
        assert q.pop_admissible(0.0) is inter

    def test_fifo_when_edf_disabled(self):
        q = self._q(max_queue_depth=8, edf=False)
        a, b = _req(0, deadline=9.0), _req(1, deadline=1.0)
        q.submit(a, 0.0)
        q.submit(b, 0.0)
        assert q.pop_admissible(0.0) is a

    def test_sheds_expired_deadline(self):
        q = self._q(max_queue_depth=8)
        r = _req(0, arrival=0.0, deadline=1.0)
        q.submit(r, 0.0)
        assert q.pop_admissible(5.0) is None
        assert r.shed and r.shed_reason == "deadline_expired"
        assert r.terminal_state == "shed"

    def test_sheds_infeasible_budget(self):
        q = self._q(max_queue_depth=8)
        r = _req(0, arrival=0.0, tokens=100, deadline=1.0)
        q.submit(r, 0.0)
        assert q.pop_admissible(0.5) is None
        assert r.shed and r.shed_reason == "infeasible"
        assert q.stats.counters["shed_infeasible"] == 1

    def test_shedding_disabled_serves_expired(self):
        q = self._q(max_queue_depth=8, shed=False)
        r = _req(0, arrival=0.0, deadline=1.0)
        q.submit(r, 0.0)
        assert q.pop_admissible(5.0) is r

    def test_expire_sheds_while_slots_full(self):
        q = self._q(max_queue_depth=8)
        q.submit(_req(0, deadline=1.0), 0.0)
        q.submit(_req(1, deadline=30.0), 0.0)
        assert q.expire(5.0) == 1
        assert len(q) == 1

    def test_requeue_append_bypasses_depth_bound(self):
        q = self._q(max_queue_depth=1)
        q.submit(_req(0), 0.0)
        q.append(_req(1))
        assert len(q) == 2

    def test_retry_backoff_respected(self):
        q = self._q(max_queue_depth=8)
        r = _req(0)
        r.retry_at = 5.0
        q.append(r)
        assert q.pop_admissible(1.0) is None
        assert q.pop_admissible(6.0) is r

    def test_kv_watermark_hysteresis(self):
        q = self._q(max_queue_depth=8, kv_high_watermark=0.9,
                    kv_low_watermark=0.7)
        q.submit(_req(0), 0.0)
        assert q.pop_admissible(0.0, kv_used_frac=0.95) is None
        assert q.pop_admissible(0.0, kv_used_frac=0.8) is None
        assert q.stats.counters["kv_gate_trips"] == 1
        assert q.pop_admissible(0.0, kv_used_frac=0.6) is not None

    def test_saturation_tracks_the_reference(self):
        q = self._q(max_queue_depth=4)
        ref = JA.AdmissionQueue(JA.AdmissionConfig(max_queue_depth=4),
                                cost=JA.CostModel.from_tick(0.05))
        assert q.saturation() == 0.0
        for i in range(8):
            a = q.submit(_req(i), 0.0)
            b = ref.submit(JaxRequest(rid=i, arrival=0.0, prompt_len=8,
                                      max_new_tokens=4), 0.0)
            assert a == b and q.saturation() == ref.saturation()
        assert q.saturation() > 0.5


class TestBrownout:
    def _bo(self, **kw):
        return BrownoutController(AdmissionConfig(
            brownout_high=0.75, brownout_low=0.25, brownout_dwell_s=2.0,
            **kw))

    def test_level_rises_after_dwell(self):
        bo = self._bo()
        assert [bo.update(t, 0.9) for t in (0.0, 1.0, 2.5, 5.0)] == \
            [0, 0, 1, 2]

    def test_level_decays_when_calm(self):
        bo = self._bo()
        bo.level = 2
        bo.update(0.0, 0.1)
        assert bo.update(3.0, 0.1) == 1
        assert bo.update(6.0, 0.1) == 0

    def test_mid_band_holds_level(self):
        bo = self._bo()
        bo.level = 1
        bo.update(0.0, 0.5)
        assert bo.update(10.0, 0.5) == 1

    def test_budget_factor_orders_by_priority(self):
        bo = self._bo()
        bo.level = 1
        fi, fs, fb = (bo.budget_factor(p) for p in
                      (PRIO_INTERACTIVE, PRIO_STANDARD, PRIO_BATCH))
        assert fi > fs > fb
        assert fs == pytest.approx(0.75)

    def test_budget_floor(self):
        bo = self._bo()
        bo.level = 3
        assert bo.budget_factor(PRIO_BATCH) == \
            AdmissionConfig().brownout_min_frac

    def test_max_level_sheds_batch_class_only(self):
        bo = self._bo()
        bo.level = AdmissionConfig().brownout_max_level
        assert bo.sheds(PRIO_BATCH)
        assert not bo.sheds(PRIO_STANDARD)
        assert not bo.sheds(PRIO_INTERACTIVE)


# ---------------------------------------------------------------------------
# Engine under overload, held against the reference engine
# ---------------------------------------------------------------------------
def _trace(pkg, rate=30.0, duration=3.0, deadline=2.0, seed=0):
    fn = synth_requests if pkg == "torch" else jax_synth
    return fn(np.random.default_rng(seed), rate=rate, cv=2.0,
              duration=duration, prompt_mean=16, decode_mean=8,
              deadline_s=deadline, priority_mix=(0.2, 0.6, 0.2))


def _engine(pkg, adm=None, **kw):
    if pkg == "torch":
        return TE.FlexPipeEngine(CFG, PARAMS, [0, 2], TE.EngineConfig(
            max_batch=4, max_seq=96, admission=adm, **kw), device="cpu")
    jadm = None if adm is None else JA.AdmissionConfig(**adm.__dict__)
    return JE.FlexPipeEngine(JCFG, JPARAMS, [0, 2], JE.EngineConfig(
        max_batch=4, max_seq=96, admission=jadm, **kw))


def _record_outputs(eng, out: dict):
    """Record each slot's tokens when its request leaves it (the reference
    engine keeps no per-request output)."""
    base = type(eng.slots[0])

    class Recording(base):
        def __setattr__(self, k, v):
            if k == "request" and v is None and \
                    getattr(self, "request", None) is not None:
                out[self.request.rid] = list(self.generated)
            super().__setattr__(k, v)

    eng.slots = [Recording() for _ in eng.slots]


_CASES = {"bounded": ({"max_queue_depth": 8}, {}),
          "brownout": ({"max_queue_depth": 4, "brownout_dwell_s": 0.2,
                        "brownout_high": 0.5},
                       {"rate": 60.0, "duration": 3.0, "deadline": 4.0}),
          "fifo": (None, {"rate": 10.0, "duration": 2.0, "deadline": 30.0})}

_RUNS: dict = {}


def _overload_run(pkg, case):
    """One run per package and case of _CASES, made once."""
    key = (pkg, case)
    adm_kw, trace_kw = _CASES[case]
    if key not in _RUNS:
        reqs = _trace(pkg, **trace_kw)
        adm = AdmissionConfig(**adm_kw) if adm_kw is not None else None
        eng = _engine(pkg, adm)
        outs: dict = {}
        _record_outputs(eng, outs)
        stats = eng.run(reqs)
        _RUNS[key] = (reqs, eng, stats, outs)
    return _RUNS[key]


def _accounting(reqs):
    return [(r.rid, r.terminal_state, r.queue_wait, r.max_new_tokens,
             r.degraded, r.shed_reason, r.fail_reason, r.start, r.first_token,
             r.finish) for r in reqs]


class TestEngineOverload:
    @pytest.mark.parametrize("case", list(_CASES))
    def test_requests_and_streams_equal_the_reference(self, case):
        reqs, eng, stats, outs = _overload_run("torch", case)
        jreqs, jeng, jstats, jouts = _overload_run("jax", case)
        assert _accounting(reqs) == _accounting(jreqs)
        done = [r for r in reqs if r.terminal_state == "completed"]
        assert done and {r.rid: r.output for r in done} == \
            {r.rid: jouts[r.rid] for r in done}
        assert outs == jouts
        assert stats.counters == jstats.counters
        assert stats.ttfts == jstats.ttfts
        assert stats.saturation_samples == jstats.saturation_samples

    def test_accounting_invariant_under_overload(self):
        reqs, eng, stats, _ = _overload_run("torch", "bounded")
        counts, violations = audit_requests(reqs)
        assert violations == []
        assert sum(counts.values()) == len(reqs)
        assert set(counts) == set(TERMINAL_STATES)
        assert counts["rejected"] > 0
        assert counts["completed"] == stats.completed
        assert counts["rejected"] == len(eng.rejected_requests)
        assert counts["shed"] == len(eng.shed_requests)
        assert counts["rejected"] == stats.counters["rejected"]
        assert stats.overload_summary()["rejected"] == counts["rejected"]

    def test_admitted_requests_meet_slo(self):
        _, _, stats, _ = _overload_run("torch", "bounded")
        assert stats.completed > 0
        assert stats.slo_met >= 0.9 * stats.completed
        assert stats.goodput(3.0) == stats.slo_met / 3.0

    def test_fifo_unchanged_without_admission(self):
        reqs, eng, stats, _ = _overload_run("torch", "fifo")
        counts, violations = audit_requests(reqs)
        assert violations == [] and counts["completed"] == len(reqs)
        assert stats.counters.get("rejected", 0) == 0
        assert eng.rejected_requests == [] == eng.shed_requests

    def test_brownout_degrades_budget_under_saturation(self):
        reqs, _, stats, _ = _overload_run("torch", "brownout")
        assert stats.counters.get("brownout_degraded", 0) > 0
        assert any(r.degraded for r in reqs if r.finish >= 0)

    def test_ttft_recorded(self):
        reqs = _trace("torch", rate=6.0, duration=2.0, deadline=30.0)
        stats = _engine("torch").run(reqs)
        assert len(stats.ttfts) == stats.completed
        assert all(t >= 0 for t in stats.ttfts)
        assert all(r.first_token >= r.arrival for r in reqs)
        p = stats.ttft_percentiles()
        assert p["p50"] <= p["p99"]

    def test_first_token_set_on_early_finish(self):
        eng = _engine("torch")
        r = Request(rid=0, arrival=0.0, prompt_len=8, max_new_tokens=1)
        eng.submit(r)
        eng._admit(0.5)
        assert r.first_token == 0.5 and r.finish == 0.5

    @pytest.mark.parametrize("pkg", ["torch", "jax"])
    def test_queue_wait_is_per_attempt(self, pkg):
        eng = _engine(pkg)
        pol = FaultPolicy if pkg == "torch" else JaxFaultPolicy
        eng.attach_faults(policy=pol(timeout_s=30.0,
                                     degrade_last_attempt=False))
        R = Request if pkg == "torch" else JaxRequest
        r = R(rid=0, arrival=0.0, prompt_len=8, max_new_tokens=64,
              deadline_s=500.0)
        eng.submit(r)
        eng._admit(0.0)
        assert r.queue_wait == 0.0
        eng._apply_fault_policy(40.0)
        assert r.attempts == 1 and r.enqueued_at == 40.0
        eng._admit(41.0)
        assert r.queue_wait == pytest.approx(1.0)
        assert eng.stats.counters["timeouts"] == 1

    def test_kv_used_frac_tracks_active_rows(self):
        eng = _engine("torch")
        assert eng.kv_used_frac() == 0.0
        eng.submit(Request(rid=0, arrival=0.0, prompt_len=12,
                           max_new_tokens=8))
        eng._admit(0.0)
        assert eng.kv_used_frac() == pytest.approx(12 / (4 * 96))
        paged = _engine("torch", kv=TE.KVCacheConfig(paged=True,
                                                     block_size=8))
        paged.submit(Request(rid=0, arrival=0.0, prompt_len=12,
                             max_new_tokens=8))
        paged._admit(0.0)
        assert paged.kv_used_frac() == paged.allocator.occupancy() > 0

    def test_paged_admission_waits_for_blocks(self):
        """A paged pool too small for the burst holds requests in the queue
        (not a terminal outcome) until blocks free; every request ends."""
        eng = _engine("torch", AdmissionConfig(max_queue_depth=16),
                      kv=TE.KVCacheConfig(paged=True, block_size=8,
                                          n_blocks=8))
        reqs = [Request(rid=i, arrival=0.0, prompt_len=20, max_new_tokens=6,
                        deadline_s=60.0) for i in range(5)]
        stats = eng.run(reqs)
        counts, violations = audit_requests(reqs)
        assert violations == [] and counts["completed"] == 5
        assert stats.completed == 5 and eng.block_stats()["used_blocks"] == 0
