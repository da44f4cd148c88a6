"""Adaptive pipeline scaling (paper §7, Eq. 11–12).

Eq. 11 picks the scaling granularity m_j with a sigmoid in cv·q̂ — calm
system ⇒ coarse (whole-pipeline) scaling, bursty + backlogged ⇒ finest
(stage-level) scaling.  Eq. 12 gates the decision on SLO feasibility.
Ported from ``repro/core/scaling.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


def scaling_granularity(cv: float, queue_len: float, *, g_max: int = 32,
                        q_max: float = 1024.0, beta: float = 8.0,
                        gamma: float = 4.0) -> int:
    """Eq. 11: m = floor( G_max / (1 + β·e^{−γ·(cv·q̂)}) ), q̂=min(q/Qmax,1).

    Sigmoid avoids decision oscillation; returns ≥1."""
    q_hat = min(queue_len / q_max, 1.0)
    m = int(g_max / (1.0 + beta * math.exp(-gamma * cv * q_hat)))
    return max(m, 1)


def slo_feasible(*, deadline: float, init_time: float,
                 stage_throughputs: list[float], queue_len: float,
                 required: float) -> bool:
    """Eq. 12: (T_j − S_j)·Σ μ_jk / Q_j ≥ r_j."""
    budget = deadline - init_time
    if budget <= 0:
        return False
    cap = budget * sum(stage_throughputs)
    return cap / max(queue_len, 1.0) >= required


@dataclass
class ScalingDecision:
    granularity: int            # stages to scale by
    n_new_stages: int
    feasible: bool
    reason: str


def decide_scale_up(*, cv: float, queue_len: float, deadline: float,
                    init_time_per_stage: float, stage_throughput: float,
                    required_rate: float, g_max: int = 32,
                    q_max: float = 1024.0) -> ScalingDecision:
    """Combined Eq. 11 + Eq. 12 decision used by the engine/simulator."""
    m = scaling_granularity(cv, queue_len, g_max=g_max, q_max=q_max)
    # finer granularity ⇒ smaller parameter slice per new instance ⇒ faster
    # start (Table 2's 8.7× load-time effect)
    init = init_time_per_stage * (g_max / max(m, 1)) ** 0.5
    ok = slo_feasible(deadline=deadline, init_time=init,
                      stage_throughputs=[stage_throughput] * m,
                      queue_len=queue_len, required=required_rate)
    return ScalingDecision(
        granularity=m, n_new_stages=m, feasible=ok,
        reason=f"cv={cv:.2f} q={queue_len:.0f} -> m={m}, init={init:.2f}s, "
               f"slo_ok={ok}")
