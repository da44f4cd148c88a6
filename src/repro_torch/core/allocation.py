"""Hardware-efficiency GPU allocation (paper §6.2, Eq. 6–9).

Maximize   Σ_ij [ T_ij/m_j − γ(CV_i)·1(GPU j multiplexed) ]
s.t.       Σ_i x_ij·m_i ≤ M_j                 (memory, Eq. 7)
           |T_ij/T_i'j' − 1| ≤ ε within a granularity group (Eq. 8)
           no two stages of the SAME model on one GPU (hard rule, §6.2)

γ(CV) = γ0·(1 + a·CV²) (Eq. 9) — bursty workloads multiplex badly.

The ILP is NP-hard; we use the paper-faithful structure with a greedy
best-fit + local-search swap heuristic (documented deviation: the paper
doesn't specify its solver either).  Ported from ``repro/core/allocation.py``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field


def multiplexing_penalty(cv: float, gamma0: float = 0.05,
                         a: float = 0.5) -> float:
    """Eq. 9: γ(CV) = γ0 · (1 + a·CV²)."""
    return gamma0 * (1.0 + a * cv * cv)


@dataclass
class StageReq:
    model: str
    stage_id: int
    mem: float                  # bytes
    throughput: float           # T_ij (uniform across homogeneous GPUs)
    cv: float
    group: int = 0              # granularity group for Eq. 8


@dataclass
class GPU:
    gpu_id: int
    server: int
    mem_capacity: float
    free_mem: float = field(default=-1.0)
    assigned: list = field(default_factory=list)

    def __post_init__(self):
        if self.free_mem < 0:
            self.free_mem = self.mem_capacity


@dataclass
class Assignment:
    placement: dict             # (model, stage_id) -> gpu_id
    objective: float
    rejected: list


def _objective(stages_on: dict[int, list[StageReq]], gpus: dict[int, GPU]) -> float:
    total = 0.0
    for gid, ss in stages_on.items():
        if not ss:
            continue
        mux = len(ss) > 1
        for s in ss:
            total += s.throughput / max(s.mem, 1.0)
            if mux:
                total -= multiplexing_penalty(s.cv)
    return total


def allocate(stages: list[StageReq], gpus: list[GPU], *,
             eps: float = 0.3, swap_iters: int = 200,
             rng=None) -> Assignment:
    """Greedy best-fit + local-search swaps for Eq. 6–8."""
    gp = {g.gpu_id: g for g in gpus}
    on: dict[int, list[StageReq]] = {g.gpu_id: list(g.assigned) for g in gpus}
    placement: dict = {}
    rejected: list = []

    def ok(s: StageReq, gid: int) -> bool:
        g = gp[gid]
        used = sum(x.mem for x in on[gid])
        if used + s.mem > g.mem_capacity:
            return False
        if any(x.model == s.model for x in on[gid]):   # same-model exclusion
            return False
        # Eq. 8 load balance within granularity group
        for x in on[gid]:
            if x.group == s.group and x.throughput > 0:
                if abs(s.throughput / x.throughput - 1.0) > eps:
                    return False
        return True

    def marginal(s: StageReq, gid: int) -> float:
        mux_now = len(on[gid]) >= 1
        gain = s.throughput / max(s.mem, 1.0)
        if mux_now:
            gain -= multiplexing_penalty(s.cv)
            gain -= sum(multiplexing_penalty(x.cv) for x in on[gid]
                        if len(on[gid]) == 1)   # first co-tenant penalizes both
        return gain

    # greedy: biggest stages first, best marginal-gain GPU
    for s in sorted(stages, key=lambda x: -x.mem):
        cands = [gid for gid in on if ok(s, gid)]
        if not cands:
            rejected.append(s)
            continue
        best = max(cands, key=lambda gid: (marginal(s, gid),
                                           gp[gid].mem_capacity
                                           - sum(x.mem for x in on[gid])))
        on[best].append(s)
        placement[(s.model, s.stage_id)] = best

    # local search: try moving each placed stage to a better GPU
    r = rng or random.Random(0)
    keys = list(placement)
    for _ in range(swap_iters):
        if not keys:
            break
        k = r.choice(keys)
        s = next(x for x in on[placement[k]] if (x.model, x.stage_id) == k)
        cur = placement[k]
        base = _objective(on, gp)
        better = None
        for gid in on:
            if gid == cur:
                continue
            on[cur].remove(s)
            if ok(s, gid):
                on[gid].append(s)
                if _objective(on, gp) > base + 1e-12:
                    better = gid
                on[gid].remove(s)
            on[cur].append(s)
            if better:
                break
        if better is not None:
            on[cur].remove(s)
            on[better].append(s)
            placement[k] = better

    return Assignment(placement=placement, objective=_objective(on, gp),
                      rejected=rejected)
