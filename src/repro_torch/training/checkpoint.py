"""Checkpointing and restart for fault tolerance.

Ports ``repro/training/checkpoint.py`` in its on-disk format: each leaf an
``.npy`` file (bf16 stored as its uint16 bits), an ``index.json`` with each
file's shape, dtype and a sha256 prefix, written into a temporary directory
and renamed into place (atomic), the three newest steps kept.  Leaves come
in ``jax.tree_util``'s order (``repro_torch.tree``), so each package
restores the other's checkpoint of the same tree, bit for bit.  The index's
``treedef`` is the port's own structure description (metadata, never
compared).

Each leaf's file is written once and hashed from memory (restore reads
each file once, into the buffer its tensor then views), by a pool of
threads over the leaves: hashing and file I/O release the GIL, and a
full-width checkpoint is gigabytes.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name): bf16 as its uint16 bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_torch(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":                     # the stored uint16 bits
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _sha(data) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def _write(fn: str, store: np.ndarray) -> str:
    """``store`` as an .npy file; returns the file's hash prefix, taken
    over its header (read back) and the array's own bytes, which np.save
    writes after the header as they lie in memory (C order)."""
    with open(fn, "wb") as f:
        np.save(f, store)
        size = f.tell()
    with open(fn, "rb") as f:
        header = f.read(size - store.nbytes)
    h = hashlib.sha256(header)
    h.update(store.reshape(-1).view(np.uint8))
    return h.hexdigest()[:16]


def _read(fn: str, sha: str, verify: bool) -> np.ndarray:
    """One .npy file, read once into a writable buffer that the returned
    array views."""
    with open(fn, "rb") as f:
        data = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(data)
    if verify and _sha(data) != sha:
        raise IOError(f"corrupt checkpoint leaf {os.path.basename(fn)}")
    buf = io.BytesIO(data)
    major, _ = np.lib.format.read_magic(buf)
    read_header = (np.lib.format.read_array_header_1_0 if major == 1
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(buf)
    arr = np.frombuffer(data, dtype=dtype, offset=buf.tell(),
                        count=int(np.prod(shape)))
    return arr.reshape(shape, order="F" if fortran else "C")


def save(path: str, tree, step: int = 0, meta: dict | None = None) -> dict:
    """Atomic checkpoint: leaves as .npy + index.json with hashes."""
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=path, prefix=".tmp_")
    leaves, treedef = tree_flatten(tree)
    index = {"step": step, "time": time.time(), "n_leaves": len(leaves),
             "treedef": repr(treedef), "meta": meta or {},
             "leaves": []}
    with ThreadPoolExecutor(_workers()) as pool:
        jobs = []
        for i, leaf in enumerate(leaves):
            store, dtype = _to_numpy(leaf)       # the copy to the host
            if not store.flags.c_contiguous:     # (a 0-d array stays 0-d)
                store = np.ascontiguousarray(store)
            fn = f"leaf_{i:05d}.npy"
            jobs.append(pool.submit(_write, os.path.join(tmp, fn), store))
            index["leaves"].append({"file": fn, "shape": list(store.shape),
                                    "dtype": dtype})
        for info, job in zip(index["leaves"], jobs):
            info["sha"] = job.result()
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    final = os.path.join(path, f"step_{step:08d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(path, keep=3)
    return index


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(path: str, tree_like, step: int | None = None,
            verify: bool = True):
    """Restore into the structure of ``tree_like`` (shapes must match);
    each leaf on the device of ``tree_like``'s leaf (the CPU for a leaf
    that is not a tensor), in the dtype the file holds.  Returns (tree,
    step, meta)."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    leaves, treedef = tree_flatten(tree_like)
    if len(leaves) != index["n_leaves"]:
        raise ValueError(f"leaf count mismatch: {len(leaves)} vs "
                         f"{index['n_leaves']}")
    with ThreadPoolExecutor(_workers()) as pool:
        arrays = pool.map(lambda info: _read(os.path.join(d, info["file"]),
                                             info["sha"], verify),
                          index["leaves"])
        out = []
        for i, (ref, info, arr) in enumerate(zip(leaves, index["leaves"],
                                                 arrays)):
            exp = tuple(getattr(ref, "shape", ()))
            if tuple(arr.shape) != exp:
                raise ValueError(f"shape mismatch leaf {i}: {arr.shape} vs "
                                 f"{exp}")
            dev = ref.device if torch.is_tensor(ref) else "cpu"
            out.append(_to_torch(arr, info["dtype"], dev))
    return tree_unflatten(treedef, out), step, index["meta"]


def _gc(path: str, keep: int = 3) -> None:
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(path)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"), ignore_errors=True)
