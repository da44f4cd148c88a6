"""Granularity adaptation (paper §6.1, Eq. 4–5) and the queueing model that
explains it (§3.3, Eq. 1).

Each candidate granularity g_k = (η_k stages, b_k batch) carries a profile
(T_k throughput, L_k latency, ν_k optimal-CV) — measured on hardware, or
derived from the analytic cost model.  Ported from
``repro/core/granularity.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class GranularityProfile:
    stages: int                 # η_k
    batch: int                  # b_k
    throughput: float           # T_k (req/s per instance)
    latency: float              # L_k (s)
    cv_opt: float               # ν_k — CV this granularity is tuned for
    load_time: float = 0.0      # parameter load (Table 2 "Load")
    comm_ms: float = 0.0        # per-iteration inter-stage comm (Table 2)


def score(p: GranularityProfile, cv_now: float, *, t_max: float,
          l_min: float, alpha: float = 0.5, sigma: float = 1.0) -> float:
    """Eq. 4: [α·T/Tmax + (1−α)·Lmin/L] · exp(−|ν_t − ν_k|/σ)."""
    base = alpha * p.throughput / max(t_max, 1e-12) \
        + (1 - alpha) * max(l_min, 1e-12) / max(p.latency, 1e-12)
    return base * math.exp(-abs(cv_now - p.cv_opt) / max(sigma, 1e-12))


def select(profiles: list[GranularityProfile], cv_now: float,
           alpha: float = 0.5, sigma: float = 1.0) -> GranularityProfile:
    """argmax of Eq. 4 over the candidate set G."""
    t_max = max(p.throughput for p in profiles)
    l_min = min(p.latency for p in profiles)
    return max(profiles, key=lambda p: score(p, cv_now, t_max=t_max,
                                             l_min=l_min, alpha=alpha,
                                             sigma=sigma))


def instances(p: GranularityProfile, total_capacity: float, *,
              beta1: float = 1.0, beta2: float = 0.05) -> int:
    """Eq. 5: M(g_k) = floor(μ_total / μ_k), μ_k = T_k / (β1 + β2·η_k).

    β1/β2 model coordination overhead growing with stage count."""
    mu_k = p.throughput / (beta1 + beta2 * p.stages)
    return max(int(total_capacity / max(mu_k, 1e-12)), 1)


def gg_s_total_latency(S: int, rho: float, cv_a: float, cv_s: float,
                       lam: float, mu: float) -> float:
    """Eq. 1 (§3.3): extended G/G/S queue latency =
    queue term + per-stage congestion term (the paper's latency-vs-CV
    curves)."""
    if rho >= 1.0:
        return math.inf
    queue = (rho ** S) / (math.factorial(min(S, 20)) * (1 - rho)) \
        * (cv_a ** 2 + cv_s ** 2) / 2.0
    lam_i = lam / S
    mu_i = mu  # per-stage service rate: finer stages serve faster
    congestion = sum(lam_i / max(mu_i - lam_i, 1e-9) for _ in range(S)) \
        if mu_i > lam_i else math.inf
    return queue + congestion


def optimal_stage_count(cv_a: float, s_max: int = 32) -> int:
    """§3.3 empirical law: for CV_a > 3 the distributed-buffering effect
    dominates and S ∝ √CV_a is latency-optimal."""
    if cv_a <= 3.0:
        return max(2, min(4, s_max))
    s = int(round(4 * math.sqrt(cv_a)))
    # clamp to power of two for mesh factorization
    p = 1
    while p * 2 <= min(s, s_max):
        p *= 2
    return p
