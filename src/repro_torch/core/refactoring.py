"""Eq. 10 of the paper: token-validity-masked cache snapshots and merges.

Ports ``CacheSnapshot``, ``snapshot``, ``merge_with_mask``,
``block_validity`` and ``merge_paged_with_mask`` of
``repro/core/refactoring.py``.

    C(t) = KV_snapshot ⊗ M_valid  ∪  KV_live ⊗ (¬M_valid)

Each slot carries ``valid_len``, the count of its tokens whose cache rows
were final when the snapshot was taken.  After a stage is lost, rows below
that horizon come back from the snapshot and the rest from the live cache
(zeros on the lost stages, which the engine then rebuilds by replay).

PyTorch idiom, where JAX builds new trees: the engine allocates the
snapshot once, as a zeroed twin of its live cache tensors, and
``snapshot(..., out=twin)`` fills it with ``copy_``; the merges write the
snapshot's rows into the live tensors in place and return the same list.
O(1) recurrent state (rwkv ``sx_tm``, ``sx_cm``, ``wkv``) has no token axis
to mask, so it keeps its live value, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch

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
