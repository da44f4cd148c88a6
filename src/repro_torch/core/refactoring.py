"""Inflight refactoring: the Eq. 10 snapshot and merges, the migration cost
model, and Algorithm 1's granularity controller.

Ports all of ``repro/core/refactoring.py``: ``CacheSnapshot``,
``snapshot``, ``merge_with_mask``, ``block_validity``,
``merge_paged_with_mask``, ``MigrationCost``, ``plan_migration``,
``RefactorDecision`` and ``RefactoringController``.

    C(t) = KV_snapshot ⊗ M_valid  ∪  KV_live ⊗ (¬M_valid)

Each slot carries ``valid_len``, the count of its tokens whose cache rows
were final when the snapshot was taken.  After a stage is lost, rows below
that horizon come back from the snapshot and the rest from the live cache
(zeros on the lost stages, which the engine then rebuilds by replay).

PyTorch idiom, where JAX builds new trees: the engine allocates the
snapshot once, as a zeroed twin of its live cache tensors, and
``snapshot(..., out=twin)`` fills it with ``copy_``; the merges write the
snapshot's rows into the live tensors in place and return the same list.
O(1) recurrent state (rwkv ``sx_tm``, ``sx_cm``, ``wkv``; mamba ``conv``,
``ssm``) has no token axis to mask, so it keeps its live value, as in the
reference.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.cv_monitor import CVMonitor
from repro_torch.core.granularity import GranularityProfile, score, select
from repro_torch.launch.roofline import H100_SXM
from repro_torch.models.kvcache import migration_plan

# leaf name -> its token axis; every other leaf is O(1) recurrent state
_POSITIONAL_AXES = {"k": 2, "v": 2, "latent": 1, "k_rope": 1}


@dataclass
class CacheSnapshot:
    """Per-layer cache tensors and their validity horizon: an int for the
    whole batch, or a per-slot ``(B,)`` array."""
    per_layer: list
    valid_len: object


def _leaves(tree, prefix=None):
    """(leaf name, tensor) pairs of a per-layer cache tree, in a fixed
    order (the name is the innermost dict key)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, prefix)
    else:
        yield prefix, tree


def snapshot(per_layer_caches: list, valid_len, out: list) -> CacheSnapshot:
    """Copy the caches into ``out``, a twin of the same structure (the
    engine's, allocated once), with ``copy_``."""
    for (_, dst), (_, src) in zip(_leaves(out), _leaves(per_layer_caches)):
        dst.copy_(src)
    return CacheSnapshot(per_layer=out, valid_len=valid_len)


def merge_with_mask(snap: CacheSnapshot, live: list, live_len: int) -> list:
    """Eq. 10 on dense caches, in place: token rows [0, valid) of each
    positional leaf come from the snapshot, the rest keep their live value.
    A per-slot ``valid_len`` masks each batch row (axis 0) at its own
    horizon.  A leaf whose token axis is shorter than ``live_len``, or an
    empty ``live_len``, keeps its live value, as do O(1) state leaves."""
    valid = snap.valid_len
    per_slot = np.ndim(valid) == 1
    for (name, s_leaf), (_, l_leaf) in zip(_leaves(snap.per_layer),
                                           _leaves(live)):
        axis = _POSITIONAL_AXES.get(name)
        if axis is None or s_leaf.ndim <= axis \
                or not (s_leaf.shape[axis] >= live_len > 0):
            continue                      # O(1) state: live value wins
        if per_slot:
            for b, v in enumerate(np.asarray(valid).tolist()):
                if v > 0:
                    l_leaf[b].narrow(axis - 1, 0, v).copy_(
                        s_leaf[b].narrow(axis - 1, 0, v))
        elif int(valid) > 0:
            v = int(valid)
            l_leaf.narrow(axis, 0, v).copy_(s_leaf.narrow(axis, 0, v))
    return live


def block_validity(block_tables: np.ndarray, valid_len: np.ndarray,
                   block_size: int, n_blocks: int) -> np.ndarray:
    """Snapshot-valid token count of each PHYSICAL block.

    ``block_tables`` are the snapshot-time ``(B, max_blocks)`` tables and
    ``valid_len`` each slot's horizon (0 for a slot the snapshot does not
    cover).  Slot b's logical block j holds tokens [j bs, (j+1) bs), so its
    physical block is valid up to ``clamp(valid_len[b] - j bs, 0, bs)``
    offsets.  Blocks of uncovered slots and the null block 0 stay at 0, so
    a freed and reused block never takes stale snapshot rows."""
    bv = np.zeros(n_blocks, np.int64)
    tables = np.asarray(block_tables)
    vl = np.asarray(valid_len).reshape(-1)
    for b in range(tables.shape[0]):
        v = int(vl[b]) if b < vl.size else 0
        for j in range(-(-v // block_size)):
            pid = int(tables[b, j])
            if pid > 0:
                bv[pid] = min(block_size, v - j * block_size)
    return bv


def merge_paged_with_mask(snap: CacheSnapshot, live: list,
                          block_valid: np.ndarray) -> list:
    """Eq. 10 on block pools, in place: offsets below ``block_valid[pid]``
    of physical block ``pid`` come from the snapshot, the rest keep their
    live value.  Only blocks with a positive count are touched.  Leaves
    other than ``(n_blocks, Kh, block_size, hd)`` k/v pools keep their live
    value."""
    bv = np.asarray(block_valid)
    ids = np.nonzero(bv > 0)[0]
    if not ids.size:
        return live
    idx = m = None
    for (name, s_leaf), (_, l_leaf) in zip(_leaves(snap.per_layer),
                                           _leaves(live)):
        if name not in ("k", "v") or s_leaf.ndim != 4 \
                or s_leaf.shape[0] != bv.shape[0]:
            continue
        if idx is None:                   # every pool shares one layout
            idx = torch.from_numpy(ids).to(l_leaf.device)
            cnt = torch.from_numpy(bv[ids]).to(l_leaf.device)
            off = torch.arange(s_leaf.shape[2], device=l_leaf.device)
            m = (off[None, :] < cnt[:, None])[:, None, :, None]
        l_leaf[idx] = torch.where(m, s_leaf[idx], l_leaf[idx])
    return live


# ---------------------------------------------------------------------------
# Migration cost model
# ---------------------------------------------------------------------------

@dataclass
class MigrationCost:
    moved_layers: list                    # (layer, old_stage, new_stage)
    cache_bytes_moved: float
    param_bytes_moved: float
    transfer_s: float
    delta_sync_s: float


def plan_migration(old_bounds: list[int], new_bounds: list[int],
                   n_layers: int, *, cache_bytes_per_layer: float,
                   param_bytes_per_layer: float,
                   link_bw: float = H100_SXM.link_bw,
                   decode_rate: float = 50.0,
                   inflight_tokens: int = 1) -> MigrationCost:
    """Bytes and time to move ownership between stage groupings over a
    card-to-card link (NVLink by default)."""
    moves = migration_plan(old_bounds, new_bounds, n_layers)
    cb = len(moves) * cache_bytes_per_layer
    pb = len(moves) * param_bytes_per_layer
    t = (cb + pb) / link_bw
    # delta pass: tokens decoded during transfer need re-sync (Eq. 10 mask)
    delta_tokens = max(int(t * decode_rate), inflight_tokens)
    delta = delta_tokens * cache_bytes_per_layer / max(link_bw, 1.0) \
        * len(moves) / max(n_layers, 1)
    return MigrationCost(moved_layers=moves, cache_bytes_moved=cb,
                         param_bytes_moved=pb, transfer_s=t,
                         delta_sync_s=delta)


# ---------------------------------------------------------------------------
# Algorithm 1 — the controller loop
# ---------------------------------------------------------------------------

@dataclass
class RefactorDecision:
    target: GranularityProfile
    changed: bool
    score_s: float                        # decision latency (paper: <5 ms)
    reason: str


class RefactoringController:
    """Algorithm 1: continuous monitoring + proactive granularity selection.

    hysteresis: a switch must win by `switch_margin` and survive
    `cooldown_s` since the last switch (avoids oscillation — the sigmoid
    of Eq. 11 plays the same role for scaling)."""

    def __init__(self, profiles: list[GranularityProfile], *,
                 alpha: float = 0.5, sigma: float = 1.0,
                 switch_margin: float = 0.05, cooldown_s: float = 10.0,
                 saturation_gain: float = 1.0):
        if not profiles:
            raise ValueError("need at least one granularity profile")
        self.profiles = profiles
        self.alpha = alpha
        self.sigma = sigma
        self.switch_margin = switch_margin
        self.cooldown_s = cooldown_s
        self.saturation_gain = saturation_gain
        self.monitor = CVMonitor()
        self.current = profiles[0]
        self._last_switch = -math.inf
        self.history: list[tuple[float, int]] = []

    def record_arrival(self, t: float) -> None:
        self.monitor.record(t)

    def step(self, now: float, queue_len: float = 0.0,
             saturation: float = 0.0) -> RefactorDecision:
        t0 = time.perf_counter()
        est = self.monitor.estimate(now)
        vel = self.monitor.velocity(now)
        # proactive: extrapolate CV half a window ahead using the intensity
        # gradient sign (paper: "anticipate traffic shifts")
        cv_eff = est.cv * (1.15 if vel > 0 else 1.0)
        # overload composition: the admission queue's saturation signal
        # blends cv_eff toward the most burst-tuned profile's cv_opt, so
        # sustained pressure (which can be LOW-CV — a steady flood) still
        # steers selection toward deeper, higher-throughput pipelines and
        # refactoring composes with load shedding instead of fighting it
        sat = min(max(saturation * self.saturation_gain, 0.0), 1.0)
        if sat > 0.0:
            cv_hi = max(p.cv_opt for p in self.profiles)
            cv_eff += sat * max(cv_hi - cv_eff, 0.0)
        best = select(self.profiles, cv_eff, alpha=self.alpha,
                      sigma=self.sigma)
        changed = False
        if best.stages != self.current.stages:
            t_max = max(p.throughput for p in self.profiles)
            l_min = min(p.latency for p in self.profiles)
            s_new = score(best, cv_eff, t_max=t_max, l_min=l_min,
                          alpha=self.alpha, sigma=self.sigma)
            s_cur = score(self.current, cv_eff, t_max=t_max, l_min=l_min,
                          alpha=self.alpha, sigma=self.sigma)
            if (s_new > s_cur * (1 + self.switch_margin)
                    and now - self._last_switch >= self.cooldown_s):
                changed = True
                self.current = best
                self._last_switch = now
                self.history.append((now, best.stages))
        dt = time.perf_counter() - t0
        return RefactorDecision(
            target=self.current, changed=changed, score_s=dt,
            reason=f"cv={est.cv:.2f} vel={vel:+.2f} q={queue_len:.0f} "
                   f"sat={sat:.2f} -> S={self.current.stages}")
