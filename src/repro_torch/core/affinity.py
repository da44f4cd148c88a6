"""Memory-aware elastic scaling (paper §7, Eq. 13): host-memory parameter
cache + affinity scheduling that turns cold starts into warm starts.

    s* = argmax_{s ∈ H_i}  w_t·e^{−λ(t_now − t_s)} + w_g·|g_s ∩ G_avail|

Ported from ``repro/core/affinity.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.launch.roofline import H100_SXM


@dataclass
class HostCacheEntry:
    model: str
    stage_id: int
    nbytes: float
    cached_at: float


class HostParamCache:
    """Per-server host-DRAM cache of evicted stage parameters."""

    def __init__(self, capacity_bytes: float = 256e9):
        self.capacity = capacity_bytes
        self.entries: dict[str, dict] = {}      # server -> {(model,stage): entry}

    def put(self, server: str, model: str, stage_id: int, nbytes: float,
            now: float) -> None:
        d = self.entries.setdefault(server, {})
        d[(model, stage_id)] = HostCacheEntry(model, stage_id, nbytes, now)
        # LRU eviction
        while sum(e.nbytes for e in d.values()) > self.capacity and d:
            victim = min(d, key=lambda k: d[k].cached_at)
            del d[victim]

    def has(self, server: str, model: str, stage_id: int) -> bool:
        return (model, stage_id) in self.entries.get(server, {})

    def load_time(self, server: str, model: str, stage_id: int,
                  nbytes: float, *,
                  host_bw: float = H100_SXM.host_bw,
                  storage_bw: float = 2e9) -> float:
        """Warm start (host DRAM over PCIe) vs cold start (remote storage)."""
        if self.has(server, model, stage_id):
            return nbytes / host_bw
        return nbytes / storage_bw


@dataclass
class AffinityScheduler:
    """Eq. 13 server selection."""
    w_t: float = 0.6
    w_g: float = 0.4
    decay: float = 1.0 / 300.0          # λ: five-minute memory half-life-ish
    history: dict = field(default_factory=dict)   # model -> {server: last_t}

    def record_placement(self, model: str, server: str, now: float) -> None:
        self.history.setdefault(model, {})[server] = now

    def score(self, model: str, server: str, now: float,
              avail_gpus: int) -> float:
        t_s = self.history.get(model, {}).get(server)
        temporal = math.exp(-self.decay * (now - t_s)) if t_s is not None else 0.0
        return self.w_t * temporal + self.w_g * avail_gpus

    def select(self, model: str, servers: dict[str, int], now: float) -> str:
        """servers: name -> currently available GPU count."""
        hosted = self.history.get(model, {})
        pool = [s for s in servers if s in hosted] or list(servers)
        return max(pool, key=lambda s: self.score(model, s, now, servers[s]))
