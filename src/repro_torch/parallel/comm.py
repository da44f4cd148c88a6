"""Collectives over named mesh axes, the port's counterpart of the
``jax.lax`` collectives that ``repro/parallel`` and ``repro/models`` call
inside ``shard_map``.

One process per rank: each rank holds its local shard of every tensor and
runs the same sequence of operations, so every rank of a group issues the
same collectives in the same order, in the forward and in the backward.
A collective names one mesh axis or a tuple of them; the group is this
rank's slice of the bound mesh along those axes (``launch.mesh.Mesh``),
and axes of size 1 drop out, as in JAX, where a collective over a size-1
axis is the identity.

Each differentiable collective is a ``torch.autograd.Function`` whose
backward is the transpose JAX uses under ``shard_map(check_vma=False)``,
the setting of the reference's step builders:

- ``psum`` -> ``psum`` of the cotangents (so a loss replicated on N ranks
  of a psum's group takes N times the single-device gradient there: the
  reference's own behaviour, ROADMAP.md section 3);
- ``ppermute`` -> the inverse permutation;
- tiled ``all_gather`` -> ``psum_scatter``, and back;
- ``pmax`` -> zeros (the reference's stop-gradient ``_pmax_sg``, the only
  pmax on a differentiated path).

The mesh is bound for the length of a step (``bind``), as a module-wide
setting rather than a thread's, because on CUDA autograd runs the backward,
and a checkpoint's recompute, on a thread of its own.  Each Function keeps
its group in its context for the backward.

Backends: ``nccl`` when each rank owns a device (``launch.mesh`` refuses
two ranks on one device), ``gloo`` on the CPU, and ``gloo`` on a shared
card when the caller names it.  Gloo reduces and broadcasts CUDA tensors
itself; every other collective on a CUDA tensor under gloo is staged
through pinned host memory and back, on the rank's current stream (the
copies synchronize it).  ``stats()`` counts the collectives issued, by op
and in all, the bytes of the local tensor each one takes, by op, and the
bytes staged.

A meta tensor (``launch/dryrun.py`` runs a rank's step at full size on
them, in torch's fake process group) carries no data: its collective is
counted and its output shaped, and no process group is called.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Sequence, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]

_BOUND = None                       # the mesh collectives run over
_STATS: collections.Counter = collections.Counter()
# what gloo takes on CUDA tensors without staging through the host
_GLOO_CUDA_OPS = ("all_reduce",)


@contextlib.contextmanager
def bind(mesh):
    """Run collectives over ``mesh`` (a ``launch.mesh.Mesh``, or None for
    one rank) inside the block."""
    global _BOUND
    prev, _BOUND = _BOUND, mesh
    try:
        yield mesh
    finally:
        _BOUND = prev


def stats() -> dict:
    """Since the last ``reset_stats``: collectives issued (``collectives``,
    and by op: ``all_reduce``, ``all_gather``, ``reduce_scatter``,
    ``ppermute``), the bytes of the local tensor each op took
    (``<op>_bytes``: the input of an all-reduce, all-gather or
    reduce-scatter, the tensor a ppermute sends), and bytes staged through
    host memory (gloo on a CUDA tensor)."""
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.clear()


def _names(axes: Axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _live(axes: Axes) -> tuple:
    """The axes of ``axes`` with more than one rank on the bound mesh."""
    names = _names(axes)
    mesh = _BOUND
    if mesh is None:
        return ()
    return tuple(a for a in names if mesh.size((a,)) > 1)


def axis_size(axes: Axes) -> int:
    """Ranks along ``axes`` (1 with no mesh bound), the counterpart of
    ``jax.lax.psum(1, axes)``."""
    mesh = _BOUND
    return 1 if mesh is None else mesh.size(_names(axes))


def axis_index(axes: Axes) -> int:
    """This rank's index along ``axes``, row-major over them in the order
    given (0 with no mesh bound), the counterpart of
    ``jax.lax.axis_index``."""
    mesh = _BOUND
    if mesh is None:
        return 0
    return mesh.index(_names(axes))


# ---------------------------------------------------------------------------
# the raw collectives (no autograd), staged through the host where needed
# ---------------------------------------------------------------------------

def _staged(mesh, op: str, t: torch.Tensor) -> bool:
    return (t.device.type == "cuda" and mesh.backend == "gloo"
            and op not in _GLOO_CUDA_OPS)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)                      # synchronous: waits for the stream
    _STATS["bytes_staged"] += t.numel() * t.element_size()
    return h


def _from_host(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    _STATS["bytes_staged"] += h.numel() * h.element_size()
    return h.to(like.device)


def _count(op: str, x: torch.Tensor) -> None:
    _STATS["collectives"] += 1
    _STATS[op] += 1
    _STATS[op + "_bytes"] += x.numel() * x.element_size()


def _meta(x: torch.Tensor) -> bool:
    return x.device.type == "meta"


def _all_reduce(mesh, axes: tuple, x: torch.Tensor,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``axes``."""
    _count("all_reduce", x)
    return _reduce(mesh, axes, x, op)


def _reduce(mesh, axes: tuple, x: torch.Tensor, op) -> torch.Tensor:
    if _meta(x):
        return x.detach().clone()
    g = mesh.group(axes)
    if _staged(mesh, "all_reduce", x):
        h = _to_host(x)
        dist.all_reduce(h, op=op, group=g)
        return _from_host(h, x)
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=op, group=g)
    return y


def _all_gather(mesh, axes: tuple, x: torch.Tensor, dim: int):
    """``x`` of every rank along ``axes``, concatenated on ``dim`` in the
    order of their index along ``axes``."""
    _count("all_gather", x)
    if _meta(x):
        return torch.cat([x.detach()] * mesh.size(axes), dim=dim)
    g = mesh.group(axes)
    order = mesh.gather_order(axes)
    staged = _staged(mesh, "all_gather", x)
    src = _to_host(x) if staged else x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in order]
    dist.all_gather(parts, src, group=g)
    out = torch.cat([parts[i] for i in order], dim=dim)
    return _from_host(out, x) if staged else out


def _reduce_scatter(mesh, axes: tuple, x: torch.Tensor, dim: int):
    """``x`` summed over ``axes``, then this rank's tile of ``dim`` (its
    index along ``axes``)."""
    _count("reduce_scatter", x)
    n = mesh.size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} is "
                         f"not divisible by {n} ranks")
    # a sum then a slice, on every backend: gloo has no reduce_scatter, and
    # under nccl each rank so moves n times the bytes it keeps
    # (dist.reduce_scatter_tensor would not)
    total = _reduce(mesh, axes, x, dist.ReduceOp.SUM)
    i = mesh.index(axes)
    return total.narrow(dim, i * (x.shape[dim] // n),
                        x.shape[dim] // n).contiguous()


def _permute(mesh, axis: str, x: torch.Tensor, perm) -> torch.Tensor:
    """Send ``x`` along ``axis`` by ``perm`` (pairs (src index, dst
    index)); a rank no pair sends to gets zeros, as in JAX."""
    _count("ppermute", x)
    if _meta(x):
        return torch.zeros_like(x)
    me = mesh.index((axis,))
    members = mesh.members((axis,))
    staged = _staged(mesh, "ppermute", x)
    src = _to_host(x) if staged else x.detach().contiguous()
    out = torch.zeros_like(src)
    ops = []
    for s, d in perm:
        if s == me:
            ops.append(dist.P2POp(dist.isend, src, members[d],
                                  group=mesh.group((axis,))))
        if d == me:
            ops.append(dist.P2POp(dist.irecv, out, members[s],
                                  group=mesh.group((axis,))))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return _from_host(out, x) if staged else out


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(mesh, axes, x)

    @staticmethod
    def backward(ctx, g):
        # transpose of psum under check_vma=False: psum
        return _all_reduce(ctx.mesh, ctx.axes, g), None, None


class _PmaxNoGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(mesh, axes, x, op=dist.ReduceOp.MAX)

    @staticmethod
    def backward(ctx, g):
        # the reference's _pmax_sg: a stability shift, zero gradient
        return torch.zeros_like(g), None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _permute(mesh, axis, x, perm)

    @staticmethod
    def backward(ctx, g):
        # transpose of ppermute: the inverse permutation
        inv = tuple((d, s) for s, d in ctx.perm)
        return _permute(ctx.mesh, ctx.axis, g, inv), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        # transpose of a tiled all_gather: psum_scatter
        return (_reduce_scatter(ctx.mesh, ctx.axes, g, ctx.dim), None, None,
                None)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _reduce_scatter(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        # transpose of psum_scatter: a tiled all_gather
        return _all_gather(ctx.mesh, ctx.axes, g, ctx.dim), None, None, None


def psum(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Sum over ``axes``; the backward sums the cotangents over them."""
    live = _live(axes)
    if not live:
        return x
    return _Psum.apply(x, _BOUND, live)


def pmax(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Max over ``axes``, with a zero gradient (the reference's
    ``_pmax_sg``; its plain ``pmax`` runs only in decode, which nothing
    differentiates)."""
    live = _live(axes)
    if not live:
        return x.detach()
    return _PmaxNoGrad.apply(x, _BOUND, live)


def ppermute(x: torch.Tensor, axis: str, perm) -> torch.Tensor:
    """Send ``x`` along ``axis`` by ``perm``, pairs (src, dst) of indices
    along it; the backward sends the cotangents back."""
    if not _live(axis):
        return x
    return _Permute.apply(x, _BOUND, axis, tuple(tuple(p) for p in perm))


def all_gather(x: torch.Tensor, axes: Axes, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Tiled all-gather over ``axes`` on ``dim`` (``jax.lax.all_gather(...,
    axis=dim, tiled=True)``); the backward is ``psum_scatter``."""
    if not tiled:
        raise ValueError("all_gather: only the tiled form is used")
    live = _live(axes)
    if not live:
        return x
    return _AllGather.apply(x, _BOUND, live, dim % x.dim())


def psum_scatter(x: torch.Tensor, axes: Axes, dim: int = 0,
                 tiled: bool = True) -> torch.Tensor:
    """Sum over ``axes``, keeping this rank's tile of ``dim``; the backward
    is a tiled all-gather."""
    if not tiled:
        raise ValueError("psum_scatter: only the tiled form is used")
    live = _live(axes)
    if not live:
        return x
    return _PsumScatter.apply(x, _BOUND, live, dim % x.dim())


def gather_leaf(x: torch.Tensor, axes_by_dim) -> torch.Tensor:
    """Undo a sharding, no autograd: ``axes_by_dim[i]`` names the axes dim
    i is split over (None where it is whole).  A new tensor, never a view
    of ``x``."""
    out, gathered = x.detach(), False
    for dim, axes in enumerate(axes_by_dim):
        live = _live(axes) if axes is not None else ()
        if live:
            out, gathered = _all_gather(_BOUND, live, out, dim), True
    return out if gathered else out.clone()


def where(cond: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` where a rank-dependent ``cond`` holds, else ``b``, through
    ``torch.where`` so that both branches stay in the autograd graph of
    every rank (and their backward collectives run everywhere)."""
    c = torch.full((), bool(cond), dtype=torch.bool, device=a.device)
    return torch.where(c, a, b)
