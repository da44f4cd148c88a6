"""Sharding rules: which mesh axes split each dim of each stacked param.

Ports ``repro/parallel/sharding.py``.  The refined mesh has five axes,
any of them of size 1:

    ("pod", "data", "stage", "tensor", "replica")

- pod / data / replica: the batch (data parallelism, serving replicas);
- stage: pipeline stages (params stacked with leading (S, pps) dims);
- tensor: tensor parallelism inside a stage.

The embedding and the head are vocab-parallel over ("stage", "tensor").

A spec is a ``P``: one entry per dim, None (whole), an axis name, or a
tuple of names (the dim split row-major over them, the first slowest), as
a ``jax.sharding.PartitionSpec`` is.  ``shard`` takes this rank's slice of
a global tree, the counterpart of placing it with the reference's
``shardings(mesh, specs)``; ``unshard`` gathers a local tree back.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, PipelinePlan
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import comm

DP_AXES = ("pod", "data", "replica")     # batch axes
VP_AXES = ("stage", "tensor")            # vocab-parallel axes
MESH_AXES = ("pod", "data", "stage", "tensor", "replica")


class P:
    """A partition spec: per dim, None, an axis name, or a tuple of names.
    Not a tuple, so trees of specs keep it as one leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(tuple(e) if isinstance(e, list) else e
                             for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"

    def axes(self) -> set:
        """Every axis name the spec splits a dim over."""
        out = set()
        for e in self.entries:
            if e is None:
                continue
            out.update((e,) if isinstance(e, str) else e)
        return out


def refine_mesh(base_mesh: Mesh, plan: PipelinePlan) -> Mesh:
    """Reshape the base mesh's model axis into (stage, tensor, replica)
    over the same ranks."""
    if base_mesh.axis_names == ("data", "model"):
        pod, (data, model) = 1, base_mesh.shape
    elif base_mesh.axis_names == ("pod", "data", "model"):
        pod, data, model = base_mesh.shape
    else:
        raise ValueError(f"unexpected mesh axes {base_mesh.axis_names}")
    if model != plan.model_axis:
        raise ValueError(f"plan S*T*R = {plan.model_axis} does not fill the "
                         f"mesh's model axis ({model})")
    return Mesh(MESH_AXES, (pod, data, plan.stages, plan.tensor,
                            plan.replica), base_mesh.device)


# ---------------------------------------------------------------------------
# Per-leaf tensor-parallel dimension rules (on UNSTACKED leaf shapes)
# ---------------------------------------------------------------------------

# name -> dim index (negative, from the right) to shard over "tensor"
_TENSOR_RULES_BY_NAME = {
    # attention
    "wq": -2, "wk": -2, "wv": -2, "bq": -2, "bk": -2, "bv": -2, "wo": -3,
    # mla
    "wq_up": -2, "wk_up": -2, "wv_up": -2,
    # mamba
    "w_x": -1, "w_z": -1, "conv_w": -1, "conv_b": -1, "x_proj": -2,
    "dt_proj": -1, "dt_bias": -1, "A_log": -2, "D": -1, "out_proj": -2,
    # rwkv
    "Wr": -1, "Wk": -1, "Wv": -1, "Wg": -1, "Wo": -2, "w0": -1, "u": -1,
    "ln_x": -1, "wB": -1, "Wk_cm": -1, "Wv_cm": -2,
}

# replicated despite looking shardable
_REPLICATED_NAMES = {
    "router", "scale", "gate", "wq_down", "wkv_down", "q_norm", "kv_norm",
    "wA", "maa_x", "maa_k", "maa_r", "maa", "A", "B", "Wr_cm", "pos_embed",
}

# MLP names whose rule depends on context (dense 2D vs MoE 3D expert-stacked)
_MLP_NAMES = {"w_gate", "w_up", "w_down", "w1", "w2"}


def _attn_heads_shardable(cfg: ModelConfig, T: int) -> bool:
    """Sharding q/o heads is only consistent if the kv heads either shard
    the same way or the LOCAL q heads still cover whole kv groups
    (H/T must be a multiple of the replicated Kh)."""
    H, Kh = cfg.n_heads, cfg.n_kv_heads
    if H % T:
        return False
    if Kh % T == 0:
        return True
    return (H // T) % Kh == 0


def tensor_dim(cfg: ModelConfig, path_names: tuple, shape: tuple,
               T: int = 1) -> Optional[int]:
    """Which (negative) dim of the unstacked leaf shards over "tensor"."""
    name = path_names[-1]
    if name in _REPLICATED_NAMES:
        return None
    if name in _MLP_NAMES:
        if len(shape) == 3:               # MoE expert-stacked: expert parallel
            return -3
        if name in ("w_down", "w2"):      # dense down-proj: ff dim is first
            return -2
        return -1                         # dense up/gate: ff dim is last
    if name in ("wq", "bq", "wo") and T > 1 \
            and not _attn_heads_shardable(cfg, T):
        # q/o heads replicate too (GQA consistency; the overcount is undone
        # by the divide-by-T in layers.apply_attention)
        return None
    return _TENSOR_RULES_BY_NAME.get(name)


def _leaf_spec(cfg: ModelConfig, plan: PipelinePlan, path_names: tuple,
               shape: tuple, stacked: bool) -> P:
    lead = 2 if stacked else 0            # (S, pps) stacking dims
    dims: list = [None] * len(shape)
    if stacked:
        dims[0] = "stage"
    td = tensor_dim(cfg, path_names, shape[lead:], plan.tensor)
    if td is not None and plan.tensor > 1:
        idx = len(shape) + td             # negative -> absolute (incl. lead)
        if shape[idx] % plan.tensor == 0:  # else replicate (kv heads < T)
            dims[idx] = "tensor"
    return P(*dims)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists; ``path`` holds
    the keys and list indices down to the leaf, as strings."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def stacked_param_specs(cfg: ModelConfig, plan: PipelinePlan,
                        stacked_tree) -> dict:
    """Specs for the stacked param tree of ``pipeline.stack_params`` (any
    tree of its structure whose leaves have shapes: tensors or meta
    tensors)."""
    def spec_for(names, leaf):
        nd = len(leaf.shape)
        if names[0] == "embed":
            return P(VP_AXES, None)
        if names[0] == "lm_head":
            return P(None, VP_AXES)
        if names[0] in ("pos_embed", "final_norm"):
            return P(*([None] * nd))
        if names[0] == "encoder":
            dims = [None] * nd
            if "blocks" in names:
                # stacked on one leading (n_enc,) dim, stage-replicated
                td = tensor_dim(cfg, names, tuple(leaf.shape[1:]),
                                plan.tensor)
                if td is not None and plan.tensor > 1 \
                        and leaf.shape[nd + td] % plan.tensor == 0:
                    dims[nd + td] = "tensor"
            return P(*dims)
        return _leaf_spec(cfg, plan, names, tuple(leaf.shape),
                          names[0] == "stages")

    return _map_with_path(spec_for, stacked_tree)


def batch_spec(decode_sp: bool = False) -> P:
    return P(DP_AXES)


# ---------------------------------------------------------------------------
# FSDP (ZeRO-3) over the data axis
# ---------------------------------------------------------------------------

def fsdp_dim(shape: tuple, spec: P, data_size: int = 16,
             min_dim: int = 0) -> Optional[int]:
    """The dim to split over "data" as well: the largest divisible one not
    already split.  None: the leaf stays replicated (norms, biases,
    scalars)."""
    best, best_size = None, 0
    for i, n in enumerate(shape):
        if i < min_dim:
            continue
        if i < len(spec) and spec[i] is not None:
            continue
        if n % data_size == 0 and n > best_size and n >= data_size:
            best, best_size = i, n
    return best


def apply_fsdp(specs_tree, struct_tree, data_size: int = 16,
               min_dim: int = 0):
    """Add "data" to each leaf's spec at its ``fsdp_dim``.  Returns
    (new_specs, gather_dims): the chosen dim of each leaf, or -1."""
    def one(spec, leaf):
        d = fsdp_dim(tuple(leaf.shape), spec, data_size, min_dim)
        if d is None:
            return spec, -1
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        entries[d] = "data"
        return P(*entries), d

    pairs = _zip_map(one, specs_tree, struct_tree)
    return (_map_with_path(lambda _, p: p[0], pairs),
            _map_with_path(lambda _, p: p[1], pairs))


def _zip_map(fn, a, b):
    """``fn`` over the leaves of two trees of one structure (dicts and
    lists), into a tree of that structure."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_zip_map(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def fsdp_gather(tree, dims_tree, gather_dtype=None):
    """All-gather the data-split leaves back to full size (differentiable:
    the backward is a psum_scatter).

    ``gather_dtype`` (torch.float8_e4m3fn): bf16 leaves are cast to it
    before the gather and back after, halving the wire bytes."""
    def one(leaf, d):
        if d < 0:
            return leaf
        if gather_dtype is not None and leaf.dtype == torch.bfloat16:
            g = comm.all_gather(leaf.to(gather_dtype).view(torch.uint8),
                                "data", dim=d)
            return g.view(gather_dtype).to(leaf.dtype)
        return comm.all_gather(leaf, "data", dim=d)
    return _zip_map(one, tree, dims_tree)


# ---------------------------------------------------------------------------
# Local slices of global trees, and back
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec: P, mesh: Mesh) -> tuple:
    """A leaf's shape at one rank: each split dim divided by the ranks
    along its axes."""
    out = list(shape)
    for i, e in enumerate(spec):
        n = mesh.size(_entry_axes(e)) if e is not None else 1
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {e} ({n} ranks)")
        out[i] //= n
    return tuple(out)


def shard_leaf(x: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a global leaf (a contiguous copy)."""
    out = x
    for i, e in enumerate(spec):
        axes = _entry_axes(e)
        if not axes:
            continue
        n = mesh.size(axes)
        size = x.shape[i] // n
        out = out.narrow(i, mesh.index(axes) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def shard(tree, specs, mesh: Mesh):
    """This rank's slice of every leaf of a global tree, by ``specs``."""
    return _zip_map(lambda x, s: shard_leaf(x, s, mesh), tree, specs)


def unshard(tree, specs, mesh: Mesh):
    """The global tree from every rank's local one (collective: every rank
    of the mesh calls it)."""
    with comm.bind(mesh):
        return _zip_map(lambda x, s: comm.gather_leaf(
            x, [_entry_axes(e) or None for e in s]), tree, specs)
