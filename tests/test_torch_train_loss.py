"""repro_torch's loss_fn and its gradients against the JAX package's, for
every architecture's smoke config, on the same converted params and batch.

The loss is held at rtol 1e-5 and every gradient leaf at atol 1e-5, rtol
1e-4, except rwkv6's: its group norm over 16-wide heads sees variances of
~5e-7 at the first token (the state is zero there), so the backward
multiplies f32 rounding by up to ~1/sqrt(1e-5 + 5e-7), about 300.  Two f32
computations of its gradients then differ by about 1e-4 of a leaf's largest
gradient (the port against itself with parts of the layer widened: 1.4e-4;
against the JAX package over four batches: 1.1e-4 to 8.8e-4), so rwkv6's
leaves are held to 2e-3 of each leaf's largest |gradient|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_compile import np_params, run_once

from repro.configs.base import get_arch as jax_arch
from repro.models.model import loss_fn as jax_loss_fn
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import loss_fn
from repro_torch.tree import tree_flatten, tree_unflatten

torch.set_num_threads(2)

ARCHS = ("qwen1.5-0.5b", "rwkv6-1.6b", "gemma3-1b", "gemma3-12b",
         "deepseek-moe-16b", "jamba-v0.1-52b", "qwen1.5-110b",
         "llama-3.2-vision-11b", "whisper-tiny", "deepseek-v2-236b")
MOE = ("deepseek-moe-16b", "jamba-v0.1-52b", "deepseek-v2-236b")
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
RWKV_LEAF_TOL = 2e-3          # times the leaf's largest |gradient|


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32),
         # a mask that drops a few targets
         "mask": (rng.random((8, 16)) > 0.2).astype(np.float32)}
    if cfg.encoder_layers:
        b["frames"] = rng.standard_normal((8, 16, cfg.d_model)).astype(
            np.float32)
    elif cfg.n_memory_tokens:
        b["memory"] = rng.standard_normal(
            (8, cfg.n_memory_tokens, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference(arch):
    """The loss, nll and aux, and every gradient leaf, at aux_weight 0 and,
    for the MoE models, 0.01 (the gradient at 0.01 is the nll's plus 0.01
    times the aux's, both from one JAX program)."""
    jcfg, cfg = jax_arch(arch).smoke_config, get_arch(arch).smoke_config
    params = np_params(cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    nb = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}

    def parts(p):
        _, m = jax_loss_fn(jcfg, p, jb, aux_weight=0.0)
        return jnp.stack([m["nll"], m["aux"]])

    moe = arch in MOE

    def ref(p):
        # one program: the MoE models' two rows of the Jacobian at once
        if moe:
            return parts(p), jax.jacrev(parts)(p)
        return parts(p), jax.grad(lambda p: parts(p)[0])(p)

    (nll, aux), jac = run_once(ref, jparams)
    leaves, treedef = tree_flatten(params_from_numpy(params, "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    for w in ((0.0, 0.01) if moe else (0.0,)):
        diff = [x.detach().requires_grad_(True) for x in leaves]
        total, m = loss_fn(cfg, tree_unflatten(treedef, diff), tb,
                           aux_weight=w)
        grads = torch.autograd.grad(total, diff)
        got = {k: float(v.detach()) for k, v in dict(m, total=total).items()}
        np.testing.assert_allclose(got["nll"], float(nll), rtol=1e-5)
        np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(got["total"], float(nll) + w * float(aux),
                                   rtol=1e-5)
        want = [np.asarray(a[0] + w * a[1]) if moe else np.asarray(a)
                for a in jax.tree.leaves(jac)]
        assert len(want) == len(grads)
        for g, x in zip(grads, want):
            tol = (dict(rtol=0, atol=RWKV_LEAF_TOL * np.abs(x).max())
                   if arch == "rwkv6-1.6b" else GRAD_TOL)
            np.testing.assert_allclose(g.numpy(), x, **tol)


def test_loss_mask_and_default():
    """Without a mask every target counts; with one, the loss is the
    masked mean (and an all-zero mask gives 0, not a division by 0)."""
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    params = params_from_numpy(np_params(cfg, 1), "cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1).items()}
    full, m_full = loss_fn(cfg, params, {k: b[k] for k in ("tokens",
                                                           "labels")})
    ones = dict(b, mask=torch.ones_like(b["mask"]))
    torch.testing.assert_close(loss_fn(cfg, params, ones)[0], full)
    zero = dict(b, mask=torch.zeros_like(b["mask"]))
    assert float(loss_fn(cfg, params, zero)[1]["nll"]) == 0.0
    assert float(m_full["aux"]) == 0.0
