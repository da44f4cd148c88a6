"""Overload protection: SLO-aware admission control, load shedding and
brownout degradation (the port's own copy of ``repro/serving/admission.py``).

* ``AdmissionQueue``: a bounded queue that rejects on full before any
  prefill work is spent (503-style), pops by priority class then earliest
  absolute deadline (EDF), and sheds at pop time a request whose remaining
  SLO budget cannot cover its estimated prefill + decode time.
* ``CostModel``: the service-time estimate behind shedding, seeded from the
  engine's tick (``seed_from_tick``) or the card's roofline
  (``from_roofline``, H100 peaks by default) and refined by EMA
  observations.
* KV-watermark backpressure: a hysteresis gate over KV occupancy.
* ``BrownoutController``: sustained saturation raises a discrete level that
  shrinks ``max_new_tokens`` budgets by priority class, and at the top
  level sheds best-effort traffic.

Every submitted request ends in exactly one of {completed, rejected, shed,
failed} (``workload.audit_requests``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.launch.roofline import H100_SXM, Chip, layer_fwd
from repro_torch.serving.metrics import ServingStats
from repro_torch.serving.workload import Request

ADMITTED = "admitted"
REJECTED = "rejected"

# priority classes (Request.priority)
PRIO_INTERACTIVE = 0      # protected: degraded last, never brownout-shed
PRIO_STANDARD = 1
PRIO_BATCH = 2            # best-effort: degraded first, shed at max level

# relative brownout pressure per priority class (index = priority)
_PRIO_WEIGHT = (0.5, 1.0, 1.5)


# ---------------------------------------------------------------------------
# Service-time estimation
# ---------------------------------------------------------------------------

@dataclass
class CostModel:
    """Estimated service time of a request: fixed overhead + per-token
    prefill + per-token decode.  ``observe_*`` refines the terms with an
    EMA so the estimate tracks the live system; ``seed_from_tick`` /
    ``from_roofline`` provide the priors."""
    overhead_s: float = 0.0
    prefill_s_per_token: float = 0.0
    decode_s_per_token: float = 0.05
    ema: float = 0.2
    auto: bool = True                 # allow the engine to re-seed from tick

    def estimate(self, prompt_len: int, max_new_tokens: int) -> float:
        return (self.overhead_s + self.prefill_s_per_token * prompt_len
                + self.decode_s_per_token * max_new_tokens)

    def observe_prefill(self, prompt_len: int, seconds: float) -> None:
        if prompt_len > 0:
            per = seconds / prompt_len
            self.prefill_s_per_token += self.ema * (per - self.prefill_s_per_token)

    def observe_decode(self, seconds_per_token: float) -> None:
        self.decode_s_per_token += self.ema * (seconds_per_token
                                               - self.decode_s_per_token)

    def seed_from_tick(self, tick_s: float,
                       prefill_tokens_per_tick: int = 0) -> None:
        """Sim-time serving: prefill costs one admission tick, decode one
        tick per token (the engine's ``time_per_tick`` clock).

        With chunked prefill armed, a prompt instead costs one tick per
        ``prefill_tokens_per_tick`` prompt tokens (the engine's per-tick
        chunk budget), so feasibility shedding charges long prompts their
        real multi-tick prefill latency instead of a single tick."""
        self.overhead_s = tick_s
        self.prefill_s_per_token = (tick_s / prefill_tokens_per_tick
                                    if prefill_tokens_per_tick > 0 else 0.0)
        self.decode_s_per_token = tick_s

    @classmethod
    def from_tick(cls, tick_s: float,
                  prefill_tokens_per_tick: int = 0) -> "CostModel":
        cm = cls(auto=False)
        cm.seed_from_tick(tick_s, prefill_tokens_per_tick)
        return cm

    @classmethod
    def from_roofline(cls, cfg, *, batch: int = 1, ctx: int = 256,
                      tensor: int = 1, chip: Chip = H100_SXM,
                      bytes_per_el: int = 4) -> "CostModel":
        """Analytic prior from the card's roofline (launch/roofline.py):
        per-token time = max(flops/peak, hbm/bw) summed over layers, plus
        the lm_head.  For serving on a card, where the decode cadence is not
        a fixed sim-time tick."""
        peak = chip.peak_flops(bytes_per_el)
        dec = pre = 0.0
        for j in range(cfg.n_layers):
            c = layer_fwd(cfg, j, batch, ctx, tensor, True,
                          bytes_per_el=bytes_per_el)
            dec += max(c.flops / peak, c.hbm_bytes / chip.hbm_bw)
            c = layer_fwd(cfg, j, batch, ctx, tensor, False,
                          bytes_per_el=bytes_per_el)
            pre += max(c.flops / peak, c.hbm_bytes / chip.hbm_bw)
        # head: 2*B*d*V flops per sampled token
        head = 2 * batch * cfg.d_model * cfg.vocab_size / peak
        return cls(overhead_s=0.0,
                   prefill_s_per_token=(pre + head) / max(batch, 1),
                   decode_s_per_token=(dec + head) / max(batch, 1),
                   auto=False)


# ---------------------------------------------------------------------------
# Brownout degradation
# ---------------------------------------------------------------------------

@dataclass
class AdmissionConfig:
    max_queue_depth: int = 0          # bounded queue depth; 0 = unbounded
    edf: bool = True                  # earliest-deadline-first admission
    shed: bool = True                 # deadline-based load shedding
    shed_safety: float = 1.0          # margin multiplier on cost estimates
    # KV watermark backpressure over active slot rows (fractions)
    kv_high_watermark: float = 0.90
    kv_low_watermark: float = 0.75
    # brownout: sustained saturation above `high` raises the level every
    # `dwell_s`; below `low` it decays at the same cadence
    brownout: bool = True
    brownout_high: float = 0.75
    brownout_low: float = 0.25
    brownout_dwell_s: float = 2.0
    brownout_step: float = 0.25       # budget shaved per level (x prio weight)
    brownout_max_level: int = 3
    brownout_min_frac: float = 0.125  # floor on the degraded budget fraction
    saturation_ema: float = 0.3


class BrownoutController:
    """Discrete brownout levels driven by sustained saturation.

    ``budget_factor(priority)`` is the multiplier applied to a request's
    ``max_new_tokens`` at admission; interactive traffic is shaved gently,
    batch traffic aggressively.  At the maximum level, batch-class
    requests are shed outright (``sheds(priority)``)."""

    def __init__(self, cfg: AdmissionConfig):
        self.cfg = cfg
        self.level = 0
        self._since: Optional[float] = None    # entered current band at t
        self._band = 0                         # -1 low, 0 mid, +1 high

    def update(self, now: float, saturation: float) -> int:
        band = (1 if saturation >= self.cfg.brownout_high
                else -1 if saturation <= self.cfg.brownout_low else 0)
        if band != self._band:
            self._band = band
            self._since = now
        elif band and self._since is not None \
                and now - self._since >= self.cfg.brownout_dwell_s:
            if band > 0:
                self.level = min(self.level + 1, self.cfg.brownout_max_level)
            else:
                self.level = max(self.level - 1, 0)
            self._since = now
        return self.level

    def budget_factor(self, priority: int) -> float:
        if self.level == 0:
            return 1.0
        w = _PRIO_WEIGHT[min(max(priority, 0), len(_PRIO_WEIGHT) - 1)]
        return max(1.0 - self.cfg.brownout_step * self.level * w,
                   self.cfg.brownout_min_frac)

    def sheds(self, priority: int) -> bool:
        return (self.level >= self.cfg.brownout_max_level
                and priority >= PRIO_BATCH)


# ---------------------------------------------------------------------------
# The admission queue
# ---------------------------------------------------------------------------

class AdmissionQueue:
    """Bounded EDF admission queue with shedding and KV backpressure.

    List-compatible where the engine needs it (``len``, ``append`` for the
    retry/requeue path, iteration), so it drops in where the unbounded
    FIFO used to live."""

    def __init__(self, cfg: Optional[AdmissionConfig] = None,
                 cost: Optional[CostModel] = None,
                 stats: Optional[ServingStats] = None):
        self.cfg = cfg if cfg is not None else AdmissionConfig()
        self.cost = cost if cost is not None else CostModel()
        self.stats = stats if stats is not None else ServingStats()
        self.brownout = BrownoutController(self.cfg) if self.cfg.brownout \
            else None
        self.rejected: list[Request] = []
        self.shed: list[Request] = []
        self._q: list[Request] = []
        self._gated = False            # KV watermark hysteresis state
        self._sat = 0.0

    # -- list compatibility -------------------------------------------------
    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self):
        return iter(self._q)

    def append(self, req: Request) -> None:
        """Requeue path (retries): the request was already admitted once,
        so the depth bound does not apply again."""
        self._q.append(req)

    # -- admission ----------------------------------------------------------
    def submit(self, req: Request, now: float) -> str:
        """Bounded admission: reject-on-full is a fast fail — no prefill,
        no queueing, the caller can return a 503 immediately."""
        depth = self.cfg.max_queue_depth
        if depth and len(self._q) >= depth:
            req.rejected = True
            req.fail_reason = "queue_full"
            self.rejected.append(req)
            self.stats.bump("rejected")
            self._observe(1.0)
            return REJECTED
        req.enqueued_at = now
        self._q.append(req)
        self._observe(self._depth_frac())
        return ADMITTED

    def pop_admissible(self, now: float, kv_used_frac: float = 0.0,
                       fits=None) -> Optional[Request]:
        """Next request to serve, or None.

        Order: priority class, then absolute deadline (EDF) or FIFO.
        Requests whose deadline already passed, or whose remaining SLO
        budget cannot cover the estimated prefill+decode time, are shed
        here — before any prefill work is spent on them.  The KV watermark
        gate pauses admission entirely while cache occupancy is above the
        high watermark (until it falls below the low one).

        ``fits`` (optional ``Request -> bool``) is a hard resource check —
        the paged engine's block-availability gate.  A candidate that
        doesn't fit is put back (same position, so EDF order is stable)
        and admission waits for completions to free capacity; unlike
        shedding this is not a terminal outcome."""
        if self.kv_gate(kv_used_frac):
            return None
        while True:
            idx = self._best_eligible(now)
            if idx is None:
                self._observe(self._depth_frac())
                return None
            req = self._q.pop(idx)
            if self.brownout is not None and self.brownout.sheds(req.priority):
                self._shed(req, now, "brownout")
                continue
            if self.cfg.shed and not self._feasible(req, now):
                reason = "deadline_expired" \
                    if now >= req.arrival + req.deadline_s else "infeasible"
                self._shed(req, now, reason)
                continue
            if fits is not None and not fits(req):
                self._q.insert(idx, req)
                self._observe(self._depth_frac())
                return None
            self._observe(self._depth_frac())
            return req

    def expire(self, now: float) -> int:
        """Shed queued requests whose deadline has already passed (runs
        even when no slot is free, so a saturated engine never banks work
        it can only deliver dead)."""
        if not self.cfg.shed:
            return 0
        dead = [r for r in self._q if now >= r.arrival + r.deadline_s]
        for r in dead:
            self._q.remove(r)
            self._shed(r, now, "deadline_expired")
        return len(dead)

    # -- signals ------------------------------------------------------------
    def kv_gate(self, used_frac: float) -> bool:
        """Hysteresis watermark over KV slot-row occupancy."""
        if self._gated:
            if used_frac <= self.cfg.kv_low_watermark:
                self._gated = False
        elif used_frac >= self.cfg.kv_high_watermark:
            self._gated = True
            self.stats.bump("kv_gate_trips")
        return self._gated

    def saturation(self) -> float:
        """Smoothed overload signal in [0, 1]: queue-depth fraction, pushed
        toward 1 by reject/shed activity.  Feeds the brownout controller
        and, in the reference, its granularity controller."""
        return self._sat

    def update(self, now: float) -> int:
        """Advance the brownout controller on the current saturation."""
        if self.brownout is None:
            return 0
        return self.brownout.update(now, self._sat)

    def budget_factor(self, priority: int) -> float:
        if self.brownout is None:
            return 1.0
        return self.brownout.budget_factor(priority)

    # -- internals ----------------------------------------------------------
    def _depth_frac(self) -> float:
        depth = self.cfg.max_queue_depth
        if depth:
            return min(len(self._q) / depth, 1.0)
        # unbounded queue: saturate softly against a nominal depth of 16
        return min(len(self._q) / 16.0, 1.0)

    def _observe(self, instant: float) -> None:
        a = self.cfg.saturation_ema
        self._sat += a * (instant - self._sat)

    def _best_eligible(self, now: float) -> Optional[int]:
        best = None
        best_key = None
        for i, r in enumerate(self._q):
            if r.retry_at > now:
                continue
            key = (r.priority, r.arrival + r.deadline_s, i) if self.cfg.edf \
                else (0, 0.0, i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _feasible(self, req: Request, now: float) -> bool:
        remaining = (req.arrival + req.deadline_s) - now
        est = self.cost.estimate(req.prompt_len, req.max_new_tokens) \
            * self.cfg.shed_safety
        return est <= remaining

    def _shed(self, req: Request, now: float, reason: str) -> None:
        req.shed = True
        req.shed_reason = reason
        self.shed.append(req)
        self.stats.bump("shed")
        self.stats.bump(f"shed_{reason}")
        self._observe(1.0)
