"""Fragmented serverless cluster model (paper §3.1, Table 1, Fig. 2).

Ports ``repro/serving/cluster.py`` unchanged (numpy only; no tensor, no
card): ``GPUDev``, ``Server`` and ``FragmentedCluster``.  ``synth`` draws
a cluster statistically matching the paper's measurements, the same GPU
table as the reference's for the same seed:
  - 42 servers / 82 GPUs (evaluation cluster), or C1/C2-scale variants
  - 216% average GPU subscription (about 2 tenants per GPU)
  - background memory occupancy: P50 about 29-54%, P95 about 99%
  - P(single GPU with >85% free memory) about 8.7%
  - P(4 co-located free GPUs on one server) about 0.02%
The GPU sizes are the paper's cluster's (80 GB cards), not this port's
measurements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class GPUDev:
    gid: int
    server: int
    mem: float = 80e9
    bg_mem: float = 0.0            # background-tenant memory
    used_mem: float = 0.0          # ours
    busy_until: float = 0.0

    @property
    def free_mem(self) -> float:
        return max(self.mem - self.bg_mem - self.used_mem, 0.0)

    @property
    def free_frac(self) -> float:
        return self.free_mem / self.mem


@dataclass
class Server:
    sid: int
    rack: int
    gpus: list = field(default_factory=list)


class FragmentedCluster:
    def __init__(self, servers: list[Server], gpus: list[GPUDev],
                 rng: np.random.Generator):
        self.servers = servers
        self.gpus = gpus
        self.rng = rng

    @classmethod
    def synth(cls, rng=None, n_servers: int = 42,
              n_gpus: int = 82, gpu_mem: float = 80e9,
              racks: int = 6, seed: int | None = None) -> "FragmentedCluster":
        """Synthesize a cluster.  ``rng`` may be a Generator or an int seed;
        ``seed=`` is an explicit alternative so fault-injected runs can be
        byte-reproduced from CLI flags."""
        if seed is not None:
            rng = np.random.default_rng(seed)
        elif isinstance(rng, (int, np.integer)):
            rng = np.random.default_rng(int(rng))
        elif rng is None:
            rng = np.random.default_rng(0)
        servers = [Server(sid=i, rack=i % racks) for i in range(n_servers)]
        gpus = []
        gid = 0
        # distribute GPUs round-robin (1-3 per server like a real mixed fleet)
        per = [n_gpus // n_servers] * n_servers
        for i in range(n_gpus - sum(per)):
            per[i % n_servers] += 1
        for s, k in zip(servers, per):
            for _ in range(k):
                g = GPUDev(gid=gid, server=s.sid, mem=gpu_mem)
                # background occupancy: beta-mixture matching Table 1
                if rng.random() < 0.15:
                    frac = rng.uniform(0.9, 0.995)       # saturated tail (P95 ~ 99%)
                else:
                    frac = float(np.clip(rng.beta(1.6, 2.2), 0.02, 0.98))
                g.bg_mem = frac * gpu_mem
                s.gpus.append(g)
                gpus.append(g)
                gid += 1
        return cls(servers, gpus, rng)

    # -- fragmentation statistics (validated in tests) ----------------------
    def p_free_gpu(self, thresh: float = 0.85) -> float:
        return float(np.mean([g.free_frac > thresh for g in self.gpus]))

    def p_colocated(self, k: int = 4, thresh: float = 0.85) -> float:
        ok = [sum(g.free_frac > thresh for g in s.gpus) >= k
              for s in self.servers]
        return float(np.mean(ok))

    def subscription_rate(self) -> float:
        """Tenants per GPU: about 1 background + ours."""
        return float(np.mean(
            [1.0 + (g.bg_mem > 0.05 * g.mem) + (g.used_mem > 0) for g in self.gpus]))

    # -- allocation ----------------------------------------------------------
    def find_gpus(self, n: int, mem_each: float,
                  same_server: bool = False) -> list[GPUDev]:
        """Free GPUs for n stages; same_server=True models tensor-parallel
        co-location (usually fails: the paper's 78% degradation)."""
        if same_server:
            for s in self.servers:
                c = [g for g in s.gpus if g.free_mem >= mem_each]
                if len(c) >= n:
                    return c[:n]
            return []
        c = sorted((g for g in self.gpus if g.free_mem >= mem_each),
                   key=lambda g: -g.free_mem)
        return c[:n] if len(c) >= n else []

    def allocate(self, gpus: list[GPUDev], mem_each: float) -> None:
        for g in gpus:
            g.used_mem += mem_each

    def release(self, gpus: list[GPUDev], mem_each: float,
                churn_prob: float = 0.6) -> None:
        """Released memory is immediately grabbed by competing tenants with
        probability churn_prob (the paper's 'immediate reallocation')."""
        for g in gpus:
            g.used_mem = max(g.used_mem - mem_each, 0.0)
            if self.rng.random() < churn_prob:
                g.bg_mem = min(g.bg_mem + 0.5 * mem_each, g.mem * 0.99)

    def preempt(self, gpus: list[GPUDev], mem_each: float) -> None:
        """Our allocation is evicted mid-service: the freed memory is grabbed
        by the background tenant immediately (churn_prob=1): the victim
        cannot simply re-allocate in place after a preemption."""
        for g in gpus:
            g.used_mem = max(g.used_mem - mem_each, 0.0)
            g.bg_mem = min(g.bg_mem + mem_each, g.mem * 0.99)

    def mean_utilization(self) -> float:
        return float(np.mean([(g.bg_mem + g.used_mem) / g.mem for g in self.gpus]))
