"""FlexPipe serving data plane in PyTorch, with hand-written CUDA kernels.

A port of the JAX package ``repro`` (the reference) for NVIDIA Hopper.  It
imports neither ``jax`` nor anything of ``repro``.

Device rule: every entry point that creates tensors takes a ``device``.
``None`` means CUDA; if CUDA is missing that raises instead of falling back.
Only an explicit ``device="cpu"`` runs on the CPU, where each kernel wrapper
uses its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without CUDA)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' explicitly to run the plain "
                "PyTorch versions of the kernels on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
