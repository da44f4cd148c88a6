"""JAX references compiled for the training tests.

``run_once(fn, *args)`` runs ``jax.jit(fn)`` on ``args`` with XLA's LLVM
backend optimization off: these programs run once or a few times, and on
the CPU their compile time (several seconds per model's gradient) halves.
The numbers are the same program's, to rounding."""
import jax

OPTIONS = {"xla_backend_optimization_level": 0}


def compiled(fn, *args, **jit_kw):
    """``jax.jit(fn, **jit_kw)`` compiled for ``args`` with ``OPTIONS``."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn, **jit_kw)
    return jitted.lower(*args).compile(compiler_options=OPTIONS)


def run_once(fn, *args):
    return compiled(fn, *args)(*args)


def np_params(cfg, seed=0):
    """Params for both packages, drawn by the port's init (no JAX compile)
    and handed over as numpy: the JAX package's layout and scales."""
    import torch

    from repro_torch.convert import tree_to_numpy
    from repro_torch.models.transformer import init_model
    return tree_to_numpy(init_model(cfg, torch.Generator().manual_seed(seed),
                                    device="cpu"))
