"""Requests and synthetic arrival processes (the port's own copy).

Mirrors all of ``repro/serving/workload.py``: ``Request`` (with its
admission and fault lifecycle fields), ``audit_requests``,
``synth_requests``, and the multi-phase traces (``Phase``,
``phased_trace``, ``azure_like_trace``) the cluster simulator replays,
drawing arrivals from ``core/cv_monitor.py``'s ``gamma_interarrivals``, so
the same seed gives the same requests in both packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.cv_monitor import gamma_interarrivals


@dataclass
class Request:
    rid: int
    arrival: float
    prompt_len: int
    max_new_tokens: int
    model: str = "default"
    deadline_s: float = 10.0            # SLO budget from arrival
    priority: int = 1                   # 0 interactive / 1 standard / 2 batch
    # lifecycle (filled by the engine or the simulator)
    start: float = -1.0
    first_token: float = -1.0
    finish: float = -1.0
    # admission-control lifecycle (serving/admission.py)
    enqueued_at: float = -1.0           # when THIS attempt entered the queue
    queue_wait: float = 0.0             # per-attempt queue wait (last attempt)
    rejected: bool = False              # bounded queue full at submit (503)
    shed: bool = False                  # dropped by load shedding
    shed_reason: str = ""
    # fault-tolerance lifecycle (serving/faults.py's FaultPolicy)
    attempts: int = 0                   # aborted attempts so far
    retry_at: float = 0.0               # earliest re-admission time (backoff)
    degraded: bool = False              # served with a reduced token budget
    failed: bool = False                # gave up after max_attempts
    fail_reason: str = ""
    # greedy tokens of the completed request (set by the engine)
    output: Optional[list] = None

    @property
    def latency(self) -> float:
        return self.finish - self.arrival if self.finish >= 0 else math.inf

    @property
    def met_slo(self) -> bool:
        return self.latency <= self.deadline_s

    @property
    def terminal_state(self) -> str:
        """Exactly one of TERMINAL_STATES, "pending" when no terminal flag
        is set, or "ambiguous" (an accounting fault) when two are."""
        flags = [("rejected", self.rejected), ("shed", self.shed),
                 ("failed", self.failed), ("completed", self.finish >= 0)]
        hits = [name for name, on in flags if on]
        if not hits:
            return "pending"
        return hits[0] if len(hits) == 1 else "ambiguous"


TERMINAL_STATES = ("completed", "rejected", "shed", "failed")


def audit_requests(requests: list) -> tuple[dict, list]:
    """Every submitted request must end in exactly one of TERMINAL_STATES.
    Returns (state counts, [(rid, state)] of each pending or ambiguous
    request)."""
    counts = {s: 0 for s in TERMINAL_STATES}
    violations = []
    for r in requests:
        s = r.terminal_state
        if s in counts:
            counts[s] += 1
        else:
            violations.append((r.rid, s))
    return counts, violations


def synth_requests(rng: np.random.Generator, *, rate: float, cv: float,
                   duration: float, prompt_mean: int = 512,
                   decode_mean: int = 64, model: str = "default",
                   t0: float = 0.0, deadline_s: float = 10.0,
                   priority_mix: tuple | None = None) -> list[Request]:
    """Gamma-process arrivals with target CV; Splitwise-like length mix.

    ``priority_mix`` draws each request's priority class from the given
    probabilities (index = class); None keeps every request standard and
    draws nothing for it, as the reference does."""
    n = int(rate * duration * 1.5) + 16
    ivs = gamma_interarrivals(rng, rate, cv, n)
    out = []
    t = t0
    rid = 0
    for iv in ivs:
        t += iv
        if t > t0 + duration:
            break
        p = int(np.clip(rng.lognormal(math.log(prompt_mean), 0.8), 16, 8192))
        d = int(np.clip(rng.lognormal(math.log(decode_mean), 0.6), 4, 1024))
        prio = 1
        if priority_mix is not None:
            mix = np.asarray(priority_mix, dtype=float)
            prio = int(rng.choice(len(mix), p=mix / mix.sum()))
        out.append(Request(rid=rid, arrival=t, prompt_len=p,
                           max_new_tokens=d, model=model,
                           deadline_s=deadline_s, priority=prio))
        rid += 1
    return out


@dataclass
class Phase:
    duration: float
    rate: float
    cv: float


def phased_trace(rng: np.random.Generator, phases: list[Phase],
                 **kw) -> list[Request]:
    """Concatenated phases (the paper's CV=1 -> burst -> stable
    scenarios); rids run on across phases."""
    out: list[Request] = []
    t0 = 0.0
    for ph in phases:
        reqs = synth_requests(rng, rate=ph.rate, cv=ph.cv,
                              duration=ph.duration, t0=t0, **kw)
        for r in reqs:
            r.rid = len(out)
            out.append(r)
        t0 += ph.duration
    return out


def azure_like_trace(rng: np.random.Generator, *, duration: float = 7200.0,
                     base_rate: float = 20.0, **kw) -> list[Request]:
    """A two-hour lifecycle like the paper's Figs. 8-9: a baseline of
    ``base_rate`` requests/s with bursts (2-5x the rate, CV 2-8) in a
    quarter of the 60-240 s phases."""
    phases = []
    t = 0.0
    while t < duration:
        burst = rng.random() < 0.25
        phases.append(Phase(
            duration=float(rng.uniform(60, 240)),
            rate=base_rate * (rng.uniform(2.0, 5.0) if burst
                              else rng.uniform(0.6, 1.2)),
            cv=float(rng.uniform(2.0, 8.0) if burst
                     else rng.uniform(0.3, 1.2))))
        t += phases[-1].duration
    return phased_trace(rng, phases, **kw)
