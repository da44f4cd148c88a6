"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface.  It is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library under ``build/kernels/`` at the
repository root, and loaded with ``ctypes``.  A library's file name carries
a hash of its source and flags, so an edited source rebuilds on first use
and an unchanged one is loaded as it is.  ``load_all`` starts one ``nvcc``
per source at once and waits for all of them.

There is no fallback: without ``nvcc`` the build raises, and only a tensor
on the CPU takes a kernel's plain PyTorch version (see the wrappers).

Every wrapper adds one to ``launches[name]`` when it launches its kernel,
and nowhere else, so a run can show which kernels its path went through.
The backward kernels count under ``flash_attention_bwd`` and ``wkv6_bwd``
(one per backward call, whatever its number of launches).

Under autograd a wrapper either goes through an ``autograd.Function``
whose backward is a kernel too (flash attention, wkv6) or raises
(``refuse_grad``: the decode kernels, which nothing differentiates).

Tensors on the ``meta`` device (``launch/dryrun.py`` runs a step at full
size on them) take a third route (``route``): the wrapper runs the checks
it runs before a launch, all but the data's alignment, so a call the card
refuses raises there too, then returns ``meta_outputs``, the call's
outputs as shapes with no data, differentiable to its inputs' shapes.  It
computes nothing, so it is no fallback: a CPU tensor still takes the
plain version and a CUDA tensor the kernel.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
CUDA_HOME_DEFAULT = "/usr/local/cuda"
# -Xptxas -v: each kernel's registers, spills and shared memory, kept in
# the build's log beside its library (``ptxas_report``)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

# name -> (C function, argtypes) for every entry point of a library
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES: dict[str, dict[str, list]] = {
    "decode_attention": {
        # q, k, v, cache_len, scratch, tickets, out,
        # B, H, Kh, Smax, hd, hdv, scale, q dtype, cache dtype, cluster,
        # smem, stream
        "decode_attention_launch":
            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I,
             _I, _I, _P],
        # q, k_pool, v_pool, tables, cache_len, scratch, tickets, out,
        # B, H, Kh, block_size, M, hd, hdv, scale, q dtype, cache dtype,
        # cluster, smem, stream
        "paged_decode_attention_launch":
            [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
             _I, _I, _I, _I, _P],
    },
    "flash_attention": {
        # q, k, v, out, scratch, B, Sq, Skv, H, Kh, hd, hdv,
        # q_offset, causal, window, scale, dtype, span, smem, stream
        "flash_attention_launch":
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
             _I, _I, _I, _P],
    },
    "flash_attention_bwd": {
        # q, k, v, o, dout, dq, dk, dv, scratch, B, Sq, Skv, H, Kh, hd, hdv,
        # q_offset, causal, window, scale, keys, rows, smem, row_smem, stream
        "flash_attention_bwd_launch":
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _I, _I, _I, _F, _I, _I, _I, _I, _P],
    },
    "rwkv6_wkv": {
        # r, k, v, w, u, state (in and out), y,
        # B, S, H, hd, rows, dtype, smem, stream
        "wkv6_launch":
            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "rwkv6_wkv_bwd": {
        # r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, du, dstate0,
        # scratch, B, S, H, hd, cluster, chunk, smem, stream
        "wkv6_bwd_launch":
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
             _I, _I, _I, _I, _I, _I, _P],
    },
}

launches: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    launches.clear()


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default location.  Raises if there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append(os.path.join(CUDA_HOME_DEFAULT, "bin", "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{CUDA_HOME_DEFAULT}/bin): the repro_torch CUDA kernels are built "
        "from kernels/csrc/*.cu with the CUDA toolkit for sm_90a. Install the "
        "toolkit or point CUDA_HOME at it; for CPU tensors the wrappers use "
        "their plain PyTorch versions and need no build.")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(nvcc: str, outs: dict[str, Path]) -> None:
    """Run one nvcc per source, all at once; raise on the first failure
    after every compiler process has ended."""
    jobs = []
    for name, out in outs.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((proc, cmd, tmp, out))
    errors = []
    for proc, cmd, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}) building "
                          f"{out.name}:\n{' '.join(cmd)}\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)         # atomic: readers never see half
    if errors:
        raise RuntimeError("\n".join(errors))


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def load_all(names=None) -> dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every named kernel library."""
    names = list(SIGNATURES if names is None else names)
    todo = [n for n in names if n not in _LIBS]
    if todo:
        paths = {n: _lib_path(n) for n in todo}
        missing = {n: paths[n] for n in todo if not paths[n].exists()}
        if missing:
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _build(nvcc, missing)
        for n in todo:
            _LIBS[n] = _load(n, paths[n])
    return {n: _LIBS[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use."""
    return load_all([name])[name]


def ptxas_report(name: str) -> dict[str, dict[str, int]]:
    """Registers, spill bytes and static shared memory of each kernel of
    library ``name``, by mangled function name, from the ``-Xptxas -v``
    output of its build (empty if the library was built elsewhere)."""
    log = _lib_path(name).with_suffix(".log")
    if not log.exists():
        return {}
    out: dict[str, dict[str, int]] = {}
    fn = None
    for line in log.read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line) or \
            re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("static_smem", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                out[fn][key] = int(m.group(1))
    return out


def route(t, what: str) -> str:
    """Which way a wrapper goes for its input ``t``: ``"plain"`` on the CPU
    (the plain PyTorch version), ``"kernel"`` on CUDA, ``"meta"`` on meta
    tensors (shapes only: the wrapper checks its inputs as for the kernel,
    then returns ``meta_outputs``); any other device raises."""
    kind = {"cpu": "plain", "cuda": "kernel", "meta": "meta"}.get(
        t.device.type)
    if kind is None:
        raise ValueError(f"{what}: no kernel for {t.device}")
    return kind


class _Shapes(torch.autograd.Function):
    """A kernel's call on meta tensors: ``make()``'s outputs, and as the
    gradients, meta tensors of the tensor inputs' shapes."""

    @staticmethod
    def forward(ctx, make, *inputs):
        ctx.like = [(t.shape, t.dtype) if torch.is_tensor(t) else None
                    for t in inputs]
        return make()

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(None if x is None else
                        torch.empty(x[0], dtype=x[1], device="meta")
                        for x in ctx.like))


def meta_outputs(make, *inputs):
    """The meta route of a wrapper: ``make()``, a tensor or a tuple of meta
    tensors of the outputs' shapes and dtypes; where autograd records the
    call, the gradients of ``inputs`` are meta tensors of their shapes.
    Counts no launch."""
    return _Shapes.apply(make, *inputs)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors``: grad mode is on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would record a kernel that has no backward: its
    output, written by a ctypes launch, would carry no gradient."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, and its output would "
            "carry no gradient; call it under torch.no_grad() or on tensors "
            "that do not require grad (ROADMAP.md, section 2)")


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           "(cudaGetLastError after the launch)")
