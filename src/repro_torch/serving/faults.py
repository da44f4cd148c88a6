"""Serving-side fault injection, detection and request policy (the port's
own copy of ``repro/serving/faults.py``, numpy only).

* ``FaultInjector``: a seeded schedule of fault events (stage preemption,
  memory-pressure OOM, transient comm errors, stragglers), drawn whole at
  construction from one numpy Generator, so the same seed injects the same
  faults as the reference, however often ``poll`` is called.
* ``FaultPolicy``: per-attempt timeout, capped exponential backoff retry,
  failure with a reason after ``max_attempts``, and an optional degraded
  token budget on the last attempt.
* ``StageHealthMonitor``: per-stage heartbeats (a stage that misses its
  window is dead) and a median-based straggler watchdog over decode-tick
  wall times.

Recovery lives in ``engine.FlexPipeEngine`` (emergency refactor under the
Eq. 10 validity mask, then delta replay).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# Fault kinds ---------------------------------------------------------------
PREEMPT_STAGE = "preempt_stage"    # instance reclaimed: stage memory is GONE
OOM = "oom"                        # background tenant memory pressure eviction
COMM_TRANSIENT = "comm_transient"  # transient inter-stage comm error (retry)
SLOWDOWN = "slowdown"              # straggler: stage runs factor x slower

FAULT_KINDS = (PREEMPT_STAGE, OOM, COMM_TRANSIENT, SLOWDOWN)

# Draw space for fault targets; consumers map onto live stages/instances
# with ``event.stage % n`` so the schedule stays valid as topology changes.
TARGET_SPACE = 1 << 16


@dataclass
class FaultEvent:
    t: float                       # injection time (sim-time seconds)
    kind: str
    stage: int = 0                 # raw target draw in [0, TARGET_SPACE)
    factor: float = 1.0            # slowdown multiplier
    duration: float = 0.0          # slowdown window length
    detail: str = ""


class FaultInjector:
    """Deterministic fault schedule over a horizon.

    Each fault kind is an independent Poisson process (exponential
    interarrivals) at its configured rate (events/second); targets are
    uniform draws in ``TARGET_SPACE``.  ``scripted`` builds an injector
    from an explicit event list (tests and benchmarks).
    """

    def __init__(self, *, seed: int = 0, horizon: float = 600.0,
                 preempt_rate: float = 0.0, oom_rate: float = 0.0,
                 comm_rate: float = 0.0, slowdown_rate: float = 0.0,
                 slowdown_factor: float = 4.0, slowdown_duration: float = 5.0,
                 events: Optional[list] = None):
        self.seed = seed
        self.horizon = horizon
        if events is not None:
            self.events = sorted(events, key=lambda e: e.t)
        else:
            rng = np.random.default_rng(seed)
            evs: list[FaultEvent] = []
            rates = ((PREEMPT_STAGE, preempt_rate), (OOM, oom_rate),
                     (COMM_TRANSIENT, comm_rate), (SLOWDOWN, slowdown_rate))
            for kind, rate in rates:
                if rate <= 0.0:
                    continue
                t = 0.0
                while True:
                    t += float(rng.exponential(1.0 / rate))
                    if t > horizon:
                        break
                    ev = FaultEvent(t=t, kind=kind,
                                    stage=int(rng.integers(TARGET_SPACE)))
                    if kind == SLOWDOWN:
                        ev.factor = slowdown_factor
                        ev.duration = slowdown_duration
                    evs.append(ev)
            self.events = sorted(evs, key=lambda e: e.t)
        self._cursor = 0

    @classmethod
    def scripted(cls, events: list) -> "FaultInjector":
        return cls(events=list(events))

    def poll(self, now: float) -> list[FaultEvent]:
        """All not-yet-delivered events with ``t <= now`` (in order)."""
        out = []
        while self._cursor < len(self.events) \
                and self.events[self._cursor].t <= now:
            out.append(self.events[self._cursor])
            self._cursor += 1
        return out

    def pending(self) -> int:
        return len(self.events) - self._cursor

    def reset(self) -> None:
        self._cursor = 0


# ---------------------------------------------------------------------------
# Request-level resilience policy
# ---------------------------------------------------------------------------

@dataclass
class FaultPolicy:
    """Per-request timeout + capped exponential backoff retry.

    An attempt that exceeds ``timeout_s`` (from this attempt's service
    start) is aborted; the request re-queues after
    ``backoff(attempt)`` seconds.  On its final attempt a request may be
    *degraded* (token budget scaled by ``degrade_frac``) so it completes
    inside the timeout instead of failing outright.  After
    ``max_attempts`` aborted attempts the request is failed with a
    reason (never silently dropped).
    """
    timeout_s: float = 30.0
    max_attempts: int = 3
    backoff_base_s: float = 0.5
    backoff_cap_s: float = 8.0
    degrade_last_attempt: bool = True
    degrade_frac: float = 0.5

    def backoff(self, attempt: int) -> float:
        """Capped exponential backoff before retry ``attempt`` (1-based)."""
        return min(self.backoff_base_s * (2.0 ** max(attempt - 1, 0)),
                   self.backoff_cap_s)

    def should_retry(self, attempts: int) -> bool:
        return attempts < self.max_attempts

    def is_last_attempt(self, attempts: int) -> bool:
        return attempts == self.max_attempts - 1

    def degraded_budget(self, budget: int) -> int:
        return max(int(budget * self.degrade_frac), 1)


# ---------------------------------------------------------------------------
# Stage health watchdog
# ---------------------------------------------------------------------------

@dataclass
class StageHealthMonitor:
    """Heartbeat + straggler detection for pipeline stages.

    Heartbeats: the engine beats every live stage once per decode tick;
    ``dead_stages(now)`` returns stages whose last beat is older than
    ``heartbeat_timeout_s`` (0 means "missed even one tick").

    Stragglers: ``observe_tick`` keeps a rolling median of decode-tick
    wall times (the reference trainer's step-watchdog scheme);
    a tick slower than ``straggler_factor`` x median for ``patience``
    consecutive ticks flags a straggler.
    """
    heartbeat_timeout_s: float = 0.0
    straggler_factor: float = 3.0
    patience: int = 3
    _last_beat: dict = field(default_factory=dict)
    _tick_times: list = field(default_factory=list)
    _slow_streak: int = 0

    def reset(self, n_stages: int, now: float = 0.0) -> None:
        self._last_beat = {s: now for s in range(n_stages)}
        self._slow_streak = 0

    def heartbeat(self, stage: int, now: float) -> None:
        self._last_beat[stage] = now

    def dead_stages(self, now: float) -> list[int]:
        return [s for s, t in sorted(self._last_beat.items())
                if now - t > self.heartbeat_timeout_s]

    def forget(self, stage: int) -> None:
        self._last_beat.pop(stage, None)

    def observe_tick(self, dt: float) -> str:
        """Returns 'ok' | 'straggler' for one decode tick's wall time."""
        self._tick_times.append(dt)
        if len(self._tick_times) > 64:
            del self._tick_times[:32]
        med = float(np.median(self._tick_times))
        if len(self._tick_times) >= 5 and dt > self.straggler_factor * med:
            self._slow_streak += 1
        else:
            self._slow_streak = 0
        return "straggler" if self._slow_streak >= self.patience else "ok"
