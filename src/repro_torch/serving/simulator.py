"""Discrete-event cluster simulator: FlexPipe vs. baseline policies on the
82-GPU fragmented cluster (the paper's cluster-scale experiments, §9).

Ports ``repro/serving/simulator.py`` (numpy only; no tensor, no card):
``TABLE2``, ``table2_profile``, ``Policy``, ``POLICIES``, ``Instance`` and
``ClusterSim``, on the port's own controller, allocation, affinity,
admission, fault and metrics modules, so the same trace, cluster and rngs
give the reference's numbers.  The reference also imports ``core.scaling.decide_scale_up`` and
builds an ``AffinityScheduler`` that nothing reads; both are left out.

One queueing/service core; systems differ ONLY in policy knobs:

  FlexPipe        adaptive granularity (Alg. 1), Eq.11/12 stage-level
                  scaling, warm starts (host cache + Eq. 13), 30% reserve
  AlpaServe-like  static S chosen for the long-term average, 75% reserve,
                  pipeline-level cold-start scaling
  ServerlessLLM   static S, fast loading (checkpoint streaming ~ warm),
                  function-level scaling, 60% reserve
  MuxServe-like   static S, GPU multiplexing (interference gamma(CV), Eq. 9)
  Tetris-like     no pipeline parallelism (single-GPU), tensor-sharing
                  memory savings, slow scaling

Service model, calibrated to the paper's Table 2 (OPT-66B on A100 GPUs at
sequence length 4096: the paper's own measurements, not numbers from this
port or its card):
  stage compute  t_c(S)   = C0/S   per token-batch iteration
  stage comm     delta(S) = delta0*S per iteration (more hops)
  max batch      b(S)     = b0*S/4
  param load     load(S)  = L0/S   per stage instance (8.7x effect)
The per-iteration latency of an S-stage pipeline serving a batch is
  T_iter(S) = S*t_c(S)*(1+interf) + delta(S),
throughput(S) = b(S)/T_iter(S); burstiness inflates queueing per Eq. 1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.affinity import HostParamCache
from repro_torch.core.allocation import multiplexing_penalty
from repro_torch.core.granularity import GranularityProfile
from repro_torch.core.refactoring import RefactoringController
from repro_torch.serving.admission import AdmissionConfig, BrownoutController
from repro_torch.serving.cluster import FragmentedCluster
from repro_torch.serving.faults import (COMM_TRANSIENT, OOM, PREEMPT_STAGE,
                                        SLOWDOWN, FaultInjector)
from repro_torch.serving.metrics import ServingStats
from repro_torch.serving.workload import Request, audit_requests


# the paper's Table 2 anchors: OPT-66B on A100 GPUs, sequence length 4096
TABLE2 = {4: dict(load=47.14, compute=69.94e-3, comm=6.3e-3, batch=128),
          8: dict(load=13.05, compute=36.63e-3, comm=14.7e-3, batch=256),
          16: dict(load=9.19, compute=18.67e-3, comm=31.5e-3, batch=512),
          32: dict(load=5.43, compute=9.67e-3, comm=65.1e-3, batch=1024)}


def table2_profile(S: int, model_scale: float = 1.0) -> GranularityProfile:
    """Interpolated Table-2 profile for stage count S (log-log interp)."""
    ks = sorted(TABLE2)
    S = max(min(S, ks[-1]), ks[0])
    lo = max(k for k in ks if k <= S)
    hi = min(k for k in ks if k >= S)
    def lerp(a, b):
        if lo == hi:
            return a
        t = (math.log(S) - math.log(lo)) / (math.log(hi) - math.log(lo))
        return math.exp((1 - t) * math.log(a) + t * math.log(b))
    load = lerp(TABLE2[lo]["load"], TABLE2[hi]["load"]) * model_scale
    comp = lerp(TABLE2[lo]["compute"], TABLE2[hi]["compute"]) * model_scale
    comm = lerp(TABLE2[lo]["comm"], TABLE2[hi]["comm"])
    # interactive-regime batch slots: Table-2 max batch is KV-memory bound at
    # seq 4096; live serving sustains ~1/16 of it per iteration (documented
    # calibration -- preserves the paper's 8x fine/coarse batch ratio)
    batch = max(int(lerp(TABLE2[lo]["batch"], TABLE2[hi]["batch"]) / 16), 1)
    t_iter = S * comp + comm
    fill = (S - 1) * comp                  # pipeline fill for a request
    thr = batch / t_iter
    lat = t_iter + fill
    cv_opt = math.sqrt(S) if S > 4 else 0.25 * S   # §3.3: S ∝ √CV
    return GranularityProfile(stages=S, batch=int(batch), throughput=thr,
                              latency=lat, cv_opt=cv_opt, load_time=load,
                              comm_ms=comm * 1e3)


@dataclass
class Policy:
    name: str
    adaptive: bool = False             # FlexPipe granularity adaptation
    static_stages: int = 4
    reserve_frac: float = 0.75         # always-on share of peak instances
    warm_start: bool = False           # host-memory parameter cache
    stage_level_scaling: bool = False  # Eq. 11 fine-grained scaling
    multiplex: bool = False            # MuxServe-style GPU sharing
    pipeline: bool = True              # Tetris: False (single-GPU replicas)
    scale_out_queue: int = 32          # queue length triggering scale-up
    reclaim_after: float = 300.0       # idle reclamation window (5 min)
    # overload protection (serving/admission.py knobs mirrored so the
    # simulator can compare static vs adaptive overload behavior; all off
    # by default = legacy unbounded FIFO)
    admission_depth: int = 0           # bounded queue; 0 = unbounded
    edf: bool = False                  # earliest-deadline-first dispatch
    shedding: bool = False             # deadline-based load shedding
    brownout: bool = False             # degrade token budgets under pressure


FLEXPIPE = Policy("flexpipe", adaptive=True, reserve_frac=0.30,
                  warm_start=True, stage_level_scaling=True,
                  scale_out_queue=6)
FLEXPIPE_OVERLOAD = Policy("flexpipe-overload", adaptive=True,
                           reserve_frac=0.30, warm_start=True,
                           stage_level_scaling=True, scale_out_queue=6,
                           admission_depth=256, edf=True, shedding=True,
                           brownout=True)
ALPASERVE = Policy("alpaserve", static_stages=4, reserve_frac=0.75)
SERVERLESSLLM = Policy("serverlessllm", static_stages=8, reserve_frac=0.60,
                       warm_start=True)
MUXSERVE = Policy("muxserve", static_stages=4, reserve_frac=0.75,
                  multiplex=True)
TETRIS = Policy("tetris", static_stages=1, reserve_frac=0.60, pipeline=False,
                warm_start=True, multiplex=True)  # tensor-sharing couples tenants

POLICIES = {p.name: p for p in
            (FLEXPIPE, FLEXPIPE_OVERLOAD, ALPASERVE, SERVERLESSLLM,
             MUXSERVE, TETRIS)}


@dataclass
class Instance:
    iid: int
    stages: int
    profile: GranularityProfile
    gpus: list
    ready_at: float
    queue: list = field(default_factory=list)
    busy_until: float = 0.0
    last_used: float = 0.0
    busy_time: float = 0.0
    slow_until: float = 0.0            # injected straggler window
    slow_factor: float = 1.0


class ClusterSim:
    """Event-driven simulation of one model served under a policy."""

    def __init__(self, policy: Policy, cluster: FragmentedCluster,
                 rng: np.random.Generator, *, model_scale: float = 1.0,
                 mem_per_stage: float = 15e9, slo: float = 10.0,
                 peak_instances: int = 8,
                 fault_injector: FaultInjector | None = None):
        self.pol = policy
        self.cluster = cluster
        self.rng = rng
        self.faults = fault_injector
        self._backlog: list[Request] = []
        self.model_scale = model_scale
        self.mem_per_stage = mem_per_stage
        self.slo = slo
        self.stats = ServingStats()
        self.instances: list[Instance] = []
        self._iid = 0
        self.peak_instances = peak_instances
        self.host_cache = HostParamCache()
        profiles = [table2_profile(s, model_scale) for s in (2, 4, 8, 16, 32)]
        self.controller = RefactoringController(profiles, cooldown_s=20.0) \
            if policy.adaptive else None
        self.refactor_count = 0
        self.scale_events = 0
        self.alloc_wait_total = 0.0
        # overload protection (mirrors serving/admission.py for the engine)
        self.rejected: list[Request] = []
        self.shed: list[Request] = []
        self.brownout = BrownoutController(AdmissionConfig()) \
            if policy.brownout else None
        self._saturation = 0.0
        if policy.warm_start:
            # pre-deployment: stage params staged into host DRAM on a few
            # servers (the paper's parameter-locality preservation)
            for srv in range(min(8, len(cluster.servers))):
                self.host_cache.put(str(srv), "m", 0, mem_per_stage, 0.0)

    # ------------------------------------------------------------------
    def _profile(self, now: float) -> GranularityProfile:
        if self.controller is not None:
            return self.controller.current
        return table2_profile(self.pol.static_stages, self.model_scale)

    def _spawn(self, now: float, warm_hint: bool = False) -> float:
        """Start a new instance; returns its ready time."""
        prof = self._profile(now)
        S = prof.stages if self.pol.pipeline else 1
        gpus = self.cluster.find_gpus(S, self.mem_per_stage)
        wait = 0.0
        while not gpus:                         # fragmentation stall
            wait += 1.0
            gpus = self.cluster.find_gpus(S, self.mem_per_stage * 0.8)
            if wait > 30:
                break
        self.alloc_wait_total += wait
        if not gpus:
            return now + 60.0
        self.cluster.allocate(gpus, self.mem_per_stage)
        load = prof.load_time if self.pol.pipeline else TABLE2[4]["load"]
        if self.pol.warm_start or warm_hint:
            srv = str(gpus[0].server)
            if self.host_cache.has(srv, "m", 0):
                load *= 0.12                    # host-DRAM warm start
            self.host_cache.put(srv, "m", 0, self.mem_per_stage, now)
        ready = now + wait + load
        inst = Instance(self._iid, S, prof, gpus, ready_at=ready,
                        last_used=ready)
        self._iid += 1
        self.instances.append(inst)
        self.scale_events += 1
        return ready

    def _spawn_emergency(self, now: float) -> float:
        """FlexPipe recovery from a preempted instance: re-partition the
        pipeline around whatever stage budget the fragmented cluster can
        supply RIGHT NOW (coarser granularities need fewer free GPUs),
        then warm-start from the host parameter cache — recovery is a
        <10 ms inflight-refactor transition plus the warm load, not a
        cold pipeline restart."""
        prof0 = self._profile(now)
        tried = []
        S = prof0.stages if self.pol.pipeline else 1
        while S >= 1:
            if S not in tried:
                tried.append(S)
            gpus = self.cluster.find_gpus(S, self.mem_per_stage)
            if gpus:
                break
            S = S // 2 if S > 1 else 0
        if not gpus:
            return self._spawn(now)         # fall back to the waiting path
        self.cluster.allocate(gpus, self.mem_per_stage)
        prof = table2_profile(S, self.model_scale)
        load = prof.load_time
        srv = str(gpus[0].server)
        if self.host_cache.has(srv, "m", 0):
            load *= 0.12                    # host-DRAM warm start
        self.host_cache.put(srv, "m", 0, self.mem_per_stage, now)
        ready = now + 0.009 + load          # inflight-refactor transition
        inst = Instance(self._iid, S, prof, gpus, ready_at=ready,
                        last_used=ready)
        self._iid += 1
        self.instances.append(inst)
        self.scale_events += 1
        return ready

    def _handle_fault(self, ev, now: float) -> None:
        """Map one injected FaultEvent onto the live topology."""
        self.stats.bump("faults_injected")
        self.stats.fault_log.append((now, ev.kind, ev.detail))
        if not self.instances:
            return
        victim = self.instances[ev.stage % len(self.instances)]
        if ev.kind in (PREEMPT_STAGE, OOM):
            self.stats.bump("preemptions" if ev.kind == PREEMPT_STAGE
                            else "oom_events")
            # our allocation is evicted; queued requests survive host-side
            self.cluster.preempt(victim.gpus, self.mem_per_stage)
            requeued = list(victim.queue)
            victim.queue = []
            self.instances.remove(victim)
            if requeued:
                self.stats.bump("retries", len(requeued))
                for r in requeued:
                    r.attempts += 1
                    r.enqueued_at = now      # per-attempt queue accounting
                self._backlog.extend(requeued)
            if self.pol.adaptive:
                ready = self._spawn_emergency(now)
                self.stats.bump("emergency_refactors")
            else:
                ready = self._spawn(now, warm_hint=False)
                self.stats.bump("cold_restarts")
            self.stats.record_recovery(max(ready - now, 0.0), t=now,
                                       kind=ev.kind)
        elif ev.kind == SLOWDOWN:
            self.stats.bump("slowdowns")
            victim.slow_until = now + ev.duration
            victim.slow_factor = ev.factor
            if self.pol.adaptive and victim.queue:
                # Llumnix-style graceful migration off the straggler
                self.stats.bump("graceful_migrations")
                self._backlog.extend(victim.queue)
                victim.queue = []
        elif ev.kind == COMM_TRANSIENT:
            self.stats.bump("comm_errors")
            victim.busy_until = max(victim.busy_until, now) + 0.05

    # -- overload protection (mirrors serving/admission.py) ------------
    def _queued_total(self) -> int:
        return len(self._backlog) + sum(len(x.queue) for x in self.instances)

    def _shed_req(self, r: Request, reason: str) -> None:
        r.shed = True
        r.shed_reason = reason
        self.shed.append(r)
        self.stats.bump("shed")
        self.stats.bump(f"shed_{reason}")

    @staticmethod
    def _iter_times(prof: GranularityProfile) -> tuple[float, float]:
        """(t_iter, fill) under the same calibration the service loop
        uses (t_c derived from profile latency)."""
        S = prof.stages
        comp = (prof.latency - prof.comm_ms * 1e-3) / (2 * S - 1) \
            if prof.latency else 0.0
        return S * comp + prof.comm_ms * 1e-3, (S - 1) * comp

    def _feasible(self, r: Request, inst: Instance, now: float) -> bool:
        """Can this instance still deliver r inside its deadline?  The
        estimate charges the queue already ahead of r plus r's own
        iteration and pipeline fill (the sim-side prefill+decode cost)."""
        t_iter, fill = self._iter_times(inst.profile)
        iters_ahead = -(-len(inst.queue) // max(inst.profile.batch, 1))
        est_finish = max(inst.busy_until, now) \
            + (iters_ahead + 1) * t_iter + fill
        return est_finish <= r.arrival + r.deadline_s

    def _reclaim(self, now: float) -> None:
        keep = max(int(self.peak_instances * self.pol.reserve_frac), 1)
        alive = [i for i in self.instances if not i.queue
                 and i.busy_until < now]
        for inst in alive:
            if len(self.instances) <= keep:
                break
            if now - inst.last_used > self.pol.reclaim_after:
                self.cluster.release(inst.gpus, self.mem_per_stage)
                if self.pol.warm_start:
                    self.host_cache.put(str(inst.gpus[0].server), "m", 0,
                                        self.mem_per_stage, now)
                self.instances.remove(inst)

    # ------------------------------------------------------------------
    def run(self, requests: list[Request], *, control_dt: float = 5.0,
            horizon: float | None = None) -> dict:
        rng = self.rng
        reqs = sorted(requests, key=lambda r: r.arrival)
        horizon = horizon or (reqs[-1].arrival + 120.0 if reqs else 0.0)
        # warm pool: reserve_frac of peak
        n0 = max(int(self.peak_instances * self.pol.reserve_frac), 1)
        for _ in range(n0):
            self._spawn(0.0, warm_hint=True)
        for inst in self.instances:
            inst.ready_at = 0.0                 # pre-warmed

        i = 0
        now = 0.0
        next_ctl = 0.0
        self._backlog = []
        backlog = self._backlog
        recent_arrivals: list[float] = []
        cv_now = 1.0
        while now < horizon:
            # arrivals this tick: bounded admission rejects on a full
            # queue (fast-fail 503 — the request never enters the backlog)
            while i < len(reqs) and reqs[i].arrival <= now:
                r = reqs[i]
                recent_arrivals.append(r.arrival)
                if self.controller is not None:
                    self.controller.record_arrival(r.arrival)
                if self.pol.admission_depth and \
                        self._queued_total() >= self.pol.admission_depth:
                    r.rejected = True
                    r.fail_reason = "queue_full"
                    self.rejected.append(r)
                    self.stats.bump("rejected")
                else:
                    if r.enqueued_at < 0:
                        r.enqueued_at = r.arrival
                    backlog.append(r)
                i += 1
            if len(recent_arrivals) > 400:
                del recent_arrivals[:200]

            # injected faults (preemption / OOM / slowdown / comm)
            if self.faults is not None:
                for ev in self.faults.poll(now):
                    self._handle_fault(ev, now)

            # dispatch backlog to least-loaded ready instance (batched);
            # EDF orders by priority class then absolute deadline, and
            # shedding drops requests whose deadline the chosen instance
            # can no longer meet (before any service time is spent)
            ready = [x for x in self.instances if x.ready_at <= now]
            if ready and backlog:
                pend = sorted(backlog,
                              key=lambda r: (r.priority,
                                             r.arrival + r.deadline_s)) \
                    if self.pol.edf else list(backlog)
                del backlog[:]
                for r in pend:
                    inst = min(ready, key=lambda x: x.busy_until)
                    if self.brownout is not None \
                            and self.brownout.sheds(r.priority):
                        self._shed_req(r, "brownout")
                        continue
                    if self.pol.shedding \
                            and not self._feasible(r, inst, now):
                        reason = "deadline_expired" \
                            if now >= r.arrival + r.deadline_s \
                            else "infeasible"
                        self._shed_req(r, reason)
                        continue
                    inst.queue.append(r)

            # service: iteration-based — each pipeline iteration carries up
            # to batch(S) requests and occupies the pipe for t_iter(S);
            # a request additionally pays the (S-1)·t_c fill latency.
            for inst in ready:
                while inst.queue and inst.busy_until <= now + 1e-9:
                    prof = inst.profile
                    b = min(len(inst.queue), prof.batch)
                    batch, inst.queue = inst.queue[:b], inst.queue[b:]
                    S = prof.stages
                    comp = prof.latency and (prof.latency - prof.comm_ms * 1e-3) / (2 * S - 1)
                    t_iter = S * comp + prof.comm_ms * 1e-3
                    fill = (S - 1) * comp
                    interf = 0.0
                    if self.pol.multiplex:
                        # Eq. 9: interference grows with workload CV — bursty
                        # co-tenants contend for the shared GPU
                        interf = multiplexing_penalty(cv_now, gamma0=0.15)
                    service = t_iter * (1 + interf)
                    if self.brownout is not None and self.brownout.level:
                        # brownout: shrunken token budgets shorten the
                        # decode, scaling the iteration by the batch's
                        # mean per-priority budget factor
                        fs = [self.brownout.budget_factor(r.priority)
                              for r in batch]
                        for r, f in zip(batch, fs):
                            if f < 1.0 and not r.degraded:
                                r.degraded = True
                                self.stats.bump("brownout_degraded")
                        service *= float(np.mean(fs))
                    if now < inst.slow_until:
                        service *= inst.slow_factor
                    elif inst.slow_factor != 1.0:
                        inst.slow_factor = 1.0
                    t_start = max(inst.busy_until, now)
                    finish = t_start + service
                    inst.busy_time += service
                    inst.busy_until = finish
                    inst.last_used = finish
                    for r in batch:
                        r.start = max(now, r.arrival)
                        # per-attempt queue wait: from THIS attempt's
                        # enqueue, not spanning earlier failed attempts
                        since = r.enqueued_at if r.enqueued_at >= 0 \
                            else r.arrival
                        r.queue_wait = max(r.start - since, 0.0)
                        r.first_token = t_start + fill
                        r.finish = finish + fill
                        self.stats.record(
                            r.finish, r.latency, r.latency <= self.slo,
                            queue_s=r.queue_wait,
                            compute_s=S * comp, comm_s=prof.comm_ms * 1e-3,
                            ttft_s=r.first_token - r.arrival)

            # control plane
            if now >= next_ctl:
                next_ctl = now + control_dt
                win = [t for t in recent_arrivals if t >= now - 30.0]
                if len(win) > 4:
                    ivs = np.diff(win)
                    mu = float(np.mean(ivs))
                    cv_now = float(np.std(ivs) / mu) if mu > 0 else 1.0
                qlen = len(backlog) + sum(len(x.queue) for x in self.instances)
                self.stats.queue_samples.append((now, qlen))
                busy = [min(max(inst.busy_until - now, 0) / control_dt, 1.0)
                        for inst in self.instances]
                self.stats.util_samples.append(
                    (now, float(np.mean(busy)) if busy else 0.0))
                # saturation signal: queue depth against the admission
                # bound (or the scale-out threshold when unbounded)
                cap = self.pol.admission_depth or \
                    self.pol.scale_out_queue * max(len(self.instances), 1)
                self._saturation += 0.3 * (min(qlen / max(cap, 1), 1.0)
                                           - self._saturation)
                self.stats.record_saturation(now, self._saturation)
                if self.brownout is not None:
                    self.brownout.update(now, self._saturation)
                if self.controller is not None:
                    d = self.controller.step(now, qlen,
                                             saturation=self._saturation)
                    if d.changed:
                        self.refactor_count += 1
                        # inflight refactoring: instances adopt the new
                        # granularity after a brief transition (<10ms)
                        for inst in self.instances:
                            inst.profile = d.target
                            inst.stages = d.target.stages
                            inst.busy_until += 0.009
                if qlen > self.pol.scale_out_queue * max(len(self.instances), 1):
                    if self.pol.stage_level_scaling:
                        self._spawn(now)
                    else:
                        # coarse scaling: whole pipelines, cold
                        self._spawn(now, warm_hint=False)
                self._reclaim(now)
            now += 0.25

        horizon_used = max(now, 1.0)
        busy_frac = float(np.mean([inst.busy_time for inst in self.instances])
                          ) / horizon_used if self.instances else 0.0
        accounting, violations = audit_requests(reqs)
        return {
            "policy": self.pol.name,
            "completed": self.stats.completed,
            "goodput": self.stats.goodput(horizon_used),
            "latency": self.stats.latency_percentiles(),
            "mean_queue": float(np.mean([q for _, q in self.stats.queue_samples]))
            if self.stats.queue_samples else 0.0,
            "gpu_util": self.cluster.mean_utilization(),
            "busy_frac": busy_frac,
            "instances_final": len(self.instances),
            "refactor_count": self.refactor_count,
            "scale_events": self.scale_events,
            "alloc_wait_s": self.alloc_wait_total,
            "median_recovery_s": self.stats.median_recovery(),
            "breakdown": self.stats.mean_breakdown(),
            "faults": self.stats.fault_summary(horizon_used),
            "offered": len(reqs),
            "rejected": len(self.rejected),
            "shed": len(self.shed),
            "overload": self.stats.overload_summary(),
            "accounting": accounting,
            "accounting_violations": violations,
        }
