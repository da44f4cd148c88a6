"""Meshes over ranks, and worlds of rank processes.

Ports ``repro/launch/mesh.py``.  Where JAX lays a mesh over the devices of
one process, the port runs one process per rank: a ``Mesh`` names its axes
and their sizes, gives this rank's coordinates (the world's ranks laid out
row-major over the axes, as ``np.reshape`` lays devices out), and holds one
process group for every slice of every set of axes with more than one rank,
which ``parallel.comm`` runs its collectives over.

Every rank creates every group, in the same order, or ``new_group`` hangs:
groups are made when a mesh is made, for the slices of each subset of its
axes in a fixed order, and kept by their member ranks, so two meshes of a
world share the groups they have in common.  Every rank must make the same
meshes in the same order.

Each rank's device is ``cuda:(local_rank % device_count)`` unless the caller
passes ``device="cpu"``.  The backend is the caller's: ``nccl`` raises where
two ranks would share a device (NCCL refuses that), ``gloo`` runs on the CPU
and, when asked for by name, on a shared card through host memory
(``parallel.comm``).

``run_world`` starts a world of rank processes (``spawn``), each of which
initialises the process group from a ``file://`` rendezvous and calls a
function; it kills the whole world on the first rank that fails or when
the world overruns its time, and raises with the failing rank's traceback.
"""
from __future__ import annotations

import itertools
import math
import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

# member ranks -> process group, made in the same order on every rank
_GROUPS: dict[tuple, object] = {}


def _group_of(ranks: tuple):
    if ranks not in _GROUPS:
        if len(ranks) == dist.get_world_size():
            _GROUPS[ranks] = dist.group.WORLD
        else:
            _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


class Mesh:
    """Named axes over ranks ``0 .. prod(shape) - 1`` of the world.

    A rank of the world past the mesh's size (``elastic_mesh`` over
    survivors) takes part in making the groups and in nothing else: its
    ``coords`` is None."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 device=None):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(n) for n in shape)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"mesh axes {self.axis_names} and shape "
                             f"{self.shape} differ in length")
        self.n = math.prod(self.shape)
        on = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if on else 1
        self.rank = dist.get_rank() if on else 0
        if self.n > world:
            raise ValueError(f"a {self.shape} mesh needs {self.n} ranks; "
                             f"the world has {world}")
        self.backend = dist.get_backend() if on else None
        self.device = torch.device(device) if device is not None else \
            _rank_device(self.rank)
        self.coords = (tuple(int(c) for c in
                             _unravel(self.rank, self.shape))
                       if self.rank < self.n else None)
        self._groups: dict[frozenset, object] = {}
        live = [a for a, n in zip(self.axis_names, self.shape) if n > 1]
        for k in range(1, len(live) + 1):
            for axes in itertools.combinations(live, k):
                for ranks in self._slices(axes):
                    g = _group_of(ranks)
                    if self.rank in ranks:
                        self._groups[frozenset(axes)] = g

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")

    def _slices(self, axes: Sequence[str]):
        """Member ranks of every slice along ``axes``, in a fixed order."""
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.shape)) if i not in idx]
        for fixed in itertools.product(*(range(self.shape[i])
                                         for i in rest)):
            ranks = []
            for var in itertools.product(*(range(self.shape[i])
                                           for i in idx)):
                c = [0] * len(self.shape)
                for i, v in zip(rest, fixed):
                    c[i] = v
                for i, v in zip(idx, var):
                    c[i] = v
                ranks.append(_ravel(c, self.shape))
            yield tuple(sorted(ranks))

    def size(self, axes) -> int:
        """Ranks along an axis name or a tuple of them."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[self.axis_names.index(a)]
                         for a in names)

    def index(self, axes) -> int:
        """This rank's index along ``axes``, row-major in the order
        given."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in names:
            k = self.axis_names.index(a)
            i = i * self.shape[k] + self.coords[k]
        return i

    def members(self, axes) -> list[int]:
        """The ranks of this rank's slice along ``axes``, by their index
        along ``axes``."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        ks = [self.axis_names.index(a) for a in names]
        out = []
        for var in itertools.product(*(range(self.shape[k]) for k in ks)):
            c = list(self.coords)
            for k, v in zip(ks, var):
                c[k] = v
            out.append(_ravel(c, self.shape))
        return out

    def group(self, axes):
        return self._groups[frozenset((axes,) if isinstance(axes, str)
                                      else axes)]

    def gather_order(self, axes) -> list[int]:
        """For each index along ``axes``, the group rank that holds it
        (``all_gather`` lists its parts by group rank)."""
        g = self.group(axes)
        return [dist.get_group_rank(g, r) for r in self.members(axes)]


def _unravel(i: int, shape) -> list[int]:
    out = []
    for n in reversed(shape):
        out.append(i % n)
        i //= n
    return out[::-1]


def _ravel(coords, shape) -> int:
    i = 0
    for c, n in zip(coords, shape):
        i = i * n + c
    return i


def _rank_device(rank: int) -> torch.device:
    """The rank's CUDA device: ``local_rank % device_count`` (raises
    without CUDA)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' explicitly to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh over the world that ``init_process_group`` set
    up (one rank when there is none)."""
    return Mesh(("data", "model"), (data, model), device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's 16 x 16 single-pod mesh, or 2 x 16 x 16 over pods:
    the world must hold exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return Mesh(axes, shape, device)


# ---------------------------------------------------------------------------
# worlds of rank processes
# ---------------------------------------------------------------------------

# a collective that waits longer than this raises in its rank
PG_TIMEOUT_S = 120.0


def init_rank(rank: int, world: int, backend: str, init_method: str,
              device=None) -> torch.device:
    """Set this process's device and join the world's process group.
    Returns the device.  ``nccl`` raises where the host holds more ranks
    than devices."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
    if device is None or torch.device(device).type == "cuda":
        dev = _rank_device(rank) if device is None else torch.device(device)
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if backend == "nccl" and local > torch.cuda.device_count():
            raise ValueError(
                f"nccl: {local} ranks on {torch.cuda.device_count()} "
                "device(s); NCCL refuses two ranks on one device (pass "
                "backend='gloo' to share a card through host memory)")
        torch.cuda.set_device(dev)
    else:
        if backend == "nccl":
            raise ValueError("nccl needs CUDA devices; use gloo on the CPU")
        dev = torch.device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=PG_TIMEOUT_S))
    return dev


def _rank_main(rank, world, backend, device, threads, out_dir):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = init_rank(rank, world, backend,
                        f"file://{Path(out_dir) / 'rendezvous'}", device)
        with open(Path(out_dir) / "args.pkl", "rb") as f:
            fn, args = pickle.load(f)
        res = fn(rank, world, dev, *args)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    except BaseException:                  # report, then leave at once
        (Path(out_dir) / f"rank{rank}.err").write_text(
            traceback.format_exc())
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def run_world(fn: Callable, nranks: int, args: tuple = (), *,
              backend: str, device=None, timeout_s: float = 240.0,
              threads: Optional[int] = None) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``nranks`` spawned
    processes joined in one process group; returns each rank's result (it
    must pickle).  ``fn`` must be importable by its module path.  The first
    rank to fail, or a world still running after ``timeout_s``, kills every
    rank and raises with the failing rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    work = Path(tempfile.mkdtemp(prefix="repro_torch_world_"))
    # the function and its arguments go through a file, read after the
    # rendezvous: a start's payload past a pipe's buffer would make each
    # start wait for the last child to have read it
    with open(work / "args.pkl", "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, nranks, backend, device, threads,
                               str(work)))
             for r in range(nranks)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while True:
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed:
                errs = [(work / f"{p.name}.err") for p in procs]
                text = "\n".join(f"--- {e.stem}\n{e.read_text()}"
                                 for e in errs if e.exists())
                raise RuntimeError(
                    f"{failed[0].name} of {nranks} failed (exit "
                    f"{failed[0].exitcode}); the world was stopped\n{text}")
            if all(p.exitcode == 0 for p in procs):
                break
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"a world of {nranks} ranks ran past "
                                   f"{timeout_s} s and was stopped")
            multiprocessing.connection.wait(
                [p.sentinel for p in procs if p.exitcode is None],
                timeout=min(left, 1.0))
        out = []
        for r in range(nranks):
            with open(work / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=30)
        shutil.rmtree(work, ignore_errors=True)
