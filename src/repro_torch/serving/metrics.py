"""Serving metrics (the port's own copy of ``repro/serving/metrics.py``):
latency percentiles, goodput, admission and fault accounting,
pipeline-stall detection and recovery timing as the paper defines them
(§9.3):

  stall:    response latency exceeds 1.5× baseline (P25 of normal operation)
  recovery: latency returns within 1.2× baseline
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def percentiles(xs: list[float], qs=(50, 90, 95, 99)) -> dict:
    if not xs:
        return {f"p{q}": math.nan for q in qs}
    a = np.asarray(xs)
    return {f"p{q}": float(np.percentile(a, q)) for q in qs}


@dataclass
class ServingStats:
    latencies: list = field(default_factory=list)      # (finish_t, latency)
    completed: int = 0
    slo_met: int = 0
    queue_samples: list = field(default_factory=list)  # (t, qlen)
    util_samples: list = field(default_factory=list)   # (t, busy_frac)
    breakdown: dict = field(default_factory=lambda: {
        "queue": 0.0, "compute": 0.0, "comm": 0.0, "load": 0.0})
    # failure/recovery accounting (fault-injected serving)
    counters: dict = field(default_factory=dict)       # kind -> count
    recovery_times: list = field(default_factory=list)  # seconds per recovery
    fault_log: list = field(default_factory=list)      # (t, kind, detail)
    # overload accounting (serving/admission.py)
    ttfts: list = field(default_factory=list)          # time-to-first-token
    saturation_samples: list = field(default_factory=list)  # (t, sat 0..1)
    # paged-KV accounting: (t, used_blocks, free_blocks, fragmentation 0..1)
    block_samples: list = field(default_factory=list)

    def record(self, finish_t: float, latency: float, met_slo: bool,
               queue_s: float = 0.0, compute_s: float = 0.0,
               comm_s: float = 0.0, load_s: float = 0.0,
               ttft_s: float | None = None) -> None:
        self.latencies.append((finish_t, latency))
        self.completed += 1
        self.slo_met += int(met_slo)
        self.breakdown["queue"] += queue_s
        self.breakdown["compute"] += compute_s
        self.breakdown["comm"] += comm_s
        self.breakdown["load"] += load_s
        if ttft_s is not None and ttft_s >= 0:
            self.ttfts.append(ttft_s)

    def bump(self, kind: str, n: int = 1) -> None:
        self.counters[kind] = self.counters.get(kind, 0) + n

    def record_recovery(self, seconds: float, t: float = 0.0,
                        kind: str = "recovery", detail: str = "") -> None:
        self.recovery_times.append(seconds)
        self.fault_log.append((t, kind, detail))

    # -- summaries ---------------------------------------------------------
    def latency_percentiles(self) -> dict:
        return percentiles([l for _, l in self.latencies])

    def ttft_percentiles(self) -> dict:
        return percentiles(self.ttfts)

    def record_saturation(self, t: float, sat: float) -> None:
        self.saturation_samples.append((t, sat))

    def record_blocks(self, t: float, used: int, free: int,
                      frag: float) -> None:
        """Block-pool occupancy sample: used/free physical blocks and
        internal fragmentation (allocated-but-dead token slots in tail
        blocks / allocated capacity)."""
        self.block_samples.append((t, used, free, frag))

    def block_summary(self) -> dict:
        """Real KV footprint next to the slot-fraction watermark signal."""
        if not self.block_samples:
            return {"mean_used": 0.0, "max_used": 0, "min_free": 0,
                    "mean_frag": 0.0, "max_frag": 0.0}
        used = [u for _, u, _, _ in self.block_samples]
        free = [f for _, _, f, _ in self.block_samples]
        frag = [g for _, _, _, g in self.block_samples]
        return {"mean_used": float(np.mean(used)),
                "max_used": int(np.max(used)),
                "min_free": int(np.min(free)),
                "mean_frag": float(np.mean(frag)),
                "max_frag": float(np.max(frag))}

    def saturation_summary(self) -> dict:
        if not self.saturation_samples:
            return {"mean": 0.0, "max": 0.0}
        xs = [s for _, s in self.saturation_samples]
        return {"mean": float(np.mean(xs)), "max": float(np.max(xs))}

    def overload_summary(self) -> dict:
        """Admission/shedding/brownout accounting in one view."""
        c = self.counters
        return {
            "completed": self.completed,
            "slo_met": self.slo_met,
            "rejected": c.get("rejected", 0),
            "shed": c.get("shed", 0),
            "shed_deadline_expired": c.get("shed_deadline_expired", 0),
            "shed_infeasible": c.get("shed_infeasible", 0),
            "shed_brownout": c.get("shed_brownout", 0),
            "brownout_degraded": c.get("brownout_degraded", 0),
            "timeouts": c.get("timeouts", 0),
            "kv_gate_trips": c.get("kv_gate_trips", 0),
            "ttft": self.ttft_percentiles(),
            "saturation": self.saturation_summary(),
            "blocks": self.block_summary(),
        }

    def goodput(self, horizon: float) -> float:
        """SLO-satisfying completions per second."""
        return self.slo_met / max(horizon, 1e-9)

    def mean_breakdown(self) -> dict:
        n = max(self.completed, 1)
        return {k: v / n for k, v in self.breakdown.items()}

    def mean_utilization(self) -> float:
        if not self.util_samples:
            return 0.0
        return float(np.mean([u for _, u in self.util_samples]))

    # -- stall analysis (§9.3) ----------------------------------------------
    def stall_episodes(self, *, warmup_frac: float = 0.2,
                       window: float = 1.0, start_after: float = 60.0) -> list[dict]:
        """Detect stalls (latency > 1.5×P25) and recovery (≤ 1.2×P25).

        Episodes before ``start_after`` are excluded (instance warm-up is a
        cold-start, not a pipeline stall)."""
        if len(self.latencies) < 20:
            return []
        xs = sorted(self.latencies)
        n0 = int(len(xs) * warmup_frac)
        baseline = float(np.percentile([l for _, l in xs[:max(n0, 10)]], 25))
        hi, lo = 1.5 * baseline, 1.2 * baseline
        episodes = []
        cur = None
        # smooth over fixed windows: windows are contiguous, so a single
        # pointer sweep over the sorted list visits each entry once
        t_end = xs[-1][0]
        t = max(xs[0][0], start_after)
        j = 0
        while j < len(xs) and xs[j][0] < t:
            j += 1
        while t < t_end:
            k = j
            while k < len(xs) and xs[k][0] < t + window:
                k += 1
            if k > j:
                m = float(np.median([l for _, l in xs[j:k]]))
                if cur is None and m > hi:
                    cur = {"start": t, "peak": m}
                elif cur is not None:
                    cur["peak"] = max(cur["peak"], m)
                    if m <= lo:
                        cur["end"] = t + window
                        cur["recovery_s"] = cur["end"] - cur["start"]
                        episodes.append(cur)
                        cur = None
            j = k
            t += window
        return episodes

    def median_recovery(self, **kw) -> float:
        eps = self.stall_episodes(**kw)
        if not eps:
            return 0.0
        return float(np.median([e["recovery_s"] for e in eps]))

    # -- fault/availability summary ------------------------------------------
    def availability(self, horizon: float, **kw) -> float:
        """Fraction of the horizon NOT spent in a latency-stall episode
        (the §9.3 stall machinery doubles as the downtime detector under
        injected faults: a preempted pipeline shows up as a stall until
        recovery brings latency back under 1.2x baseline)."""
        if horizon <= 0:
            return 1.0
        down = sum(e["recovery_s"] for e in self.stall_episodes(**kw))
        return max(1.0 - down / horizon, 0.0)

    def fault_summary(self, horizon: float) -> dict:
        rt = np.asarray(self.recovery_times, dtype=float)
        return {
            "counters": dict(self.counters),
            "recoveries": int(rt.size),
            "median_recovery_s": float(np.median(rt)) if rt.size else 0.0,
            "max_recovery_s": float(rt.max()) if rt.size else 0.0,
            "availability": self.availability(horizon),
        }
