"""Request-pattern monitoring (paper §6): coefficient of variation of
arrival intervals over sliding windows, plus the request-intensity gradient
("characteristic velocity" in Alg. 1) used for proactive adaptation.

The paper's Fig. 1 point — CV differs up to 7× across window sizes — is why
the monitor keeps several windows at once.  Ported from
``repro/core/cv_monitor.py``.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass


@dataclass
class CVEstimate:
    cv: float
    mean_interval: float
    n: int


class CVMonitor:
    """Sliding-window CV of request inter-arrival times."""

    def __init__(self, windows: tuple[float, ...] = (15.0, 180.0, 3600.0),
                 max_events: int = 200_000):
        self.windows = windows
        self._arrivals: deque[float] = deque(maxlen=max_events)
        self._rate_hist: deque[tuple[float, float]] = deque(maxlen=4096)

    def record(self, t: float) -> None:
        self._arrivals.append(t)

    def estimate(self, now: float, window: float | None = None) -> CVEstimate:
        """CV_a over the trailing `window` seconds (default: smallest)."""
        w = window or self.windows[0]
        lo = now - w
        xs = [t for t in self._arrivals if t >= lo]
        if len(xs) < 3:
            return CVEstimate(cv=0.0, mean_interval=math.inf, n=len(xs))
        ivs = [b - a for a, b in zip(xs, xs[1:])]
        mu = sum(ivs) / len(ivs)
        if mu <= 0:
            return CVEstimate(cv=0.0, mean_interval=0.0, n=len(xs))
        var = sum((x - mu) ** 2 for x in ivs) / len(ivs)
        return CVEstimate(cv=math.sqrt(var) / mu, mean_interval=mu, n=len(xs))

    def multi_window(self, now: float) -> dict[float, CVEstimate]:
        return {w: self.estimate(now, w) for w in self.windows}

    def rate(self, now: float, window: float = 15.0) -> float:
        lo = now - window
        return sum(1 for t in self._arrivals if t >= lo) / window

    def velocity(self, now: float, window: float = 15.0) -> float:
        """dλ/dt — intensity gradient (Alg. 1 line 3), finite-differenced
        between the current and previous window."""
        r_now = self.rate(now, window)
        r_prev = (sum(1 for t in self._arrivals
                      if now - 2 * window <= t < now - window) / window)
        return (r_now - r_prev) / window


def gamma_interarrivals(rng, rate: float, cv: float, n: int) -> list[float]:
    """Arrival process with exact target CV: gamma-distributed intervals
    with shape k = 1/cv², scale = 1/(rate·k).  cv=1 ⇒ Poisson."""
    if cv <= 0:
        return [1.0 / rate] * n
    k = 1.0 / (cv * cv)
    theta = 1.0 / (rate * k)
    return list(rng.gamma(k, theta, size=n))
