"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches the kernel (built on first use by ``build.py``) or raises.
"""
