"""Serving statistics the engine records (the port's own copy of the parts
of ``repro/serving/metrics.py`` that ``FlexPipeEngine`` uses)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ServingStats:
    latencies: list = field(default_factory=list)      # (finish_t, latency)
    completed: int = 0
    slo_met: int = 0
    queue_samples: list = field(default_factory=list)  # (t, qlen)
    counters: dict = field(default_factory=dict)       # kind -> count
    ttfts: list = field(default_factory=list)          # time-to-first-token
    # paged KV: (t, used_blocks, free_blocks, fragmentation 0..1)
    block_samples: list = field(default_factory=list)

    def record(self, finish_t: float, latency: float, met_slo: bool,
               ttft_s: float | None = None) -> None:
        self.latencies.append((finish_t, latency))
        self.completed += 1
        self.slo_met += int(met_slo)
        if ttft_s is not None and ttft_s >= 0:
            self.ttfts.append(ttft_s)

    def bump(self, kind: str, n: int = 1) -> None:
        self.counters[kind] = self.counters.get(kind, 0) + n

    def record_blocks(self, t: float, used: int, free: int,
                      frag: float) -> None:
        self.block_samples.append((t, used, free, frag))
