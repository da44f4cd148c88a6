"""Fine-grained model partitioning (paper §5, Eq. 2).

Solves, by dynamic programming over contiguous operator ranges:

    min_{S_1..S_K}  Σ_k | t_c(S_k) + s_p(S_k)/B − C |  +  λ·R(S_k)
    s.t.  ∪ S_k = V,  S_i ∩ S_j = ∅,  max_k s_p(S_k) ≤ M_GPU

- t_c(S_k): stage compute time, s_p(S_k): stage parameter bytes,
  B: inter-stage bandwidth, C: target compute/communication-overlap cycle.
- R(S_k): refactoring-potential regularizer — penalizes cuts that break
  repeating-pattern boundaries (so stages can later merge/split cheaply) and
  rewards balanced power-of-two layer counts.

The DP is exact for the contiguity-constrained problem: O(n² K) with
prefix sums.  Ported from ``repro/core/partitioner.py``; the link bandwidth
B and the memory cap M_GPU default to the H100's NVLink and HBM.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.graph import OpNode
from repro_torch.launch.roofline import H100_SXM


@dataclass(frozen=True)
class Partition:
    boundaries: tuple[int, ...]      # op index where each stage starts
    cost: float
    stage_compute: tuple[float, ...]
    stage_params: tuple[float, ...]

    @property
    def n_stages(self) -> int:
        return len(self.boundaries)

    def stage_of(self, op_index: int) -> int:
        s = 0
        for i, b in enumerate(self.boundaries):
            if op_index >= b:
                s = i
        return s

    def layer_boundaries(self, nodes: list[OpNode]) -> list[int]:
        """Stage starts expressed as layer indices (for cache regrouping)."""
        return [nodes[b].layer for b in self.boundaries]


def partition(nodes: list[OpNode], n_stages: int, *,
              bandwidth: float = H100_SXM.link_bw,
              target_cycle: float | None = None,
              lam: float = 0.2, mem_cap: float = H100_SXM.hbm_bytes,
              pattern_penalty: float = 1.0) -> Partition:
    """Exact DP for Eq. 2 over contiguous ranges."""
    n = len(nodes)
    K = n_stages
    if K > n:
        raise ValueError(f"{K} stages > {n} operators")
    # prefix sums
    pc = [0.0] * (n + 1)
    pp = [0.0] * (n + 1)
    for i, nd in enumerate(nodes):
        pc[i + 1] = pc[i] + nd.t_c
        pp[i + 1] = pp[i] + nd.s_p

    if target_cycle is None:
        # default C: perfectly balanced compute + its own load time
        target_cycle = (pc[n] + pp[n] / bandwidth) / K

    def seg_cost(i: int, j: int) -> float:
        """Cost of a stage spanning ops [i, j)."""
        t_c = pc[j] - pc[i]
        s_p = pp[j] - pp[i]
        if s_p > mem_cap:
            return math.inf
        base = abs(t_c + s_p / bandwidth - target_cycle)
        # R(S_k): boundary regularizer — a cut at i not on a pattern
        # boundary costs pattern_penalty × the target cycle
        r = 0.0 if (i == 0 or nodes[i].pattern_boundary) else pattern_penalty * target_cycle
        if j < n and not nodes[j].pattern_boundary:
            r += pattern_penalty * target_cycle
        return base + lam * r

    INF = math.inf
    dp = [[INF] * (n + 1) for _ in range(K + 1)]
    arg = [[-1] * (n + 1) for _ in range(K + 1)]
    dp[0][0] = 0.0
    for k in range(1, K + 1):
        for j in range(k, n + 1):
            best, bi = INF, -1
            for i in range(k - 1, j):
                if dp[k - 1][i] == INF:
                    continue
                c = dp[k - 1][i] + seg_cost(i, j)
                if c < best:
                    best, bi = c, i
            dp[k][j] = best
            arg[k][j] = bi
    if dp[K][n] == INF:
        raise ValueError("infeasible: memory cap too small for any partition")

    # reconstruct
    bounds = []
    j = n
    for k in range(K, 0, -1):
        i = arg[k][j]
        bounds.append(i)
        j = i
    bounds.reverse()

    ends = bounds[1:] + [n]
    return Partition(
        boundaries=tuple(bounds), cost=dp[K][n],
        stage_compute=tuple(pc[e] - pc[b] for b, e in zip(bounds, ends)),
        stage_params=tuple(pp[e] - pp[b] for b, e in zip(bounds, ends)))


def candidate_partitions(nodes: list[OpNode], stage_counts: list[int],
                         **kw) -> dict[int, Partition]:
    """Partition for every candidate granularity (the set G of §6)."""
    out = {}
    for k in stage_counts:
        try:
            out[k] = partition(nodes, k, **kw)
        except ValueError:
            continue
    return out
