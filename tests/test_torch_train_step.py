"""repro_torch's one-rank train step against the JAX package's
``build_train_step`` on a (1, 1) mesh: qwen1.5-0.5b and rwkv6-1.6b smoke
configs, M = 2 microbatches, remat on and off, 3 steps on TokenPipeline
data; the loss's invariance to M at one rank; and the stacked param layout
for S in {1, 2, 4}.  Plans over several ranks are held in
tests/test_torch_parallel_*.py.

Each step's loss, grad norm and lr are held at rtol 1e-5 (rwkv6's grad norm
at 1e-3: its group norm conditions the gradients, see
tests/test_torch_train_loss.py).  The params after 3 steps are held at atol
1e-4 (qwen) and 2e-3 (rwkv6), rtol 1e-4: AdamW divides each gradient
element by its own RMS, so an element whose gradient is near zero moves by
up to the learning rate (1e-3) a step whichever way its f32 sum rounds; and
at most 0.1 % of qwen's elements (15 % of rwkv6's, whose gradients all
carry the group norm's conditioning) may differ by more than 1e-6
(measured: 0.02 % and 8 %).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_compile import compiled, np_params, run_once

from repro.configs.base import PipelinePlan as JPlan
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_arch as jax_arch
from repro.models.model import loss_fn as jax_loss_fn
from repro.parallel.pipeline import build_train_step as jax_build_train_step
from repro.parallel.pipeline import stack_params as jax_stack_params
from repro.parallel.pipeline import unstack_params as jax_unstack_params
from repro.training.optimizer import AdamWConfig as JAdamW
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.configs.base import PipelinePlan, ShapeConfig, get_arch
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.model import loss_fn
from repro_torch.parallel.pipeline import (build_train_step, stack_params,
                                           stacked_param_struct,
                                           unstack_params, vp_cross_entropy)
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
PARAM_ATOL = {"qwen1.5-0.5b": 1e-4, "rwkv6-1.6b": 2e-3}
# the share of param elements that may differ by more than 1e-6
PARAM_SHARE = {"qwen1.5-0.5b": 1e-3, "rwkv6-1.6b": 0.15}
GNORM_RTOL = {"qwen1.5-0.5b": 1e-5, "rwkv6-1.6b": 1e-3}


def _np_params(arch, seed=0):
    return np_params(get_arch(arch).smoke_config, seed)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-1.6b"])
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_equals_reference(arch, remat):
    jcfg, cfg = jax_arch(arch).smoke_config, get_arch(arch).smoke_config
    params = _np_params(arch)
    jplan = JPlan(microbatches=2, remat=remat)
    plan = PipelinePlan(microbatches=2, remat=remat)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jstep, _ = jax_build_train_step(jcfg, jplan, mesh,
                                    JShape("t", 16, 8, "train"),
                                    JAdamW(**OPT), param_dtype=jnp.float32)
    step, structs = build_train_step(cfg, plan, None,
                                     ShapeConfig("t", 16, 8, "train"),
                                     AdamWConfig(**OPT),
                                     param_dtype=torch.float32)
    js = jax_stack_params(jcfg, jplan, jax.tree.map(jnp.asarray, params))
    jo = jax_init_opt_state(js)
    tp = stack_params(cfg, plan, params_from_numpy(params, "cpu"))
    to = init_opt_state(tp)
    assert [tuple(s.shape) for s in tree_leaves(structs["params"])] == \
        [tuple(p.shape) for p in tree_leaves(tp)]
    data = TokenPipeline(DataConfig(cfg.vocab_size, 16, 8, seed=0))
    batches = [data.batch(i) for i in range(3)]
    jfn = compiled(jstep, js, jo, {k: jnp.asarray(v)
                                   for k, v in batches[0].items()})
    for b in batches:
        js, jo, jm = jfn(js, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = step(tp, to, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        for k, rtol in (("loss", 1e-5), ("lr", 1e-5),
                        ("grad_norm", GNORM_RTOL[arch])):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol)
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    assert int(to.step) == int(jo.step) == 3
    want = jax.tree.leaves(jax.tree.map(
        np.asarray, jax_unstack_params(jcfg, jplan, js)))
    got = tree_leaves(tree_to_numpy(unstack_params(cfg, plan, tp)))
    assert len(got) == len(want)
    off = n = 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=PARAM_ATOL[arch], rtol=1e-4)
        off += int((np.abs(g - w) > 1e-6).sum())
        n += g.size
    assert off <= PARAM_SHARE[arch] * n, \
        f"{off} of {n} elements differ by more than 1e-6"


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    return {"tokens": tokens, "labels": tokens}


@functools.lru_cache(maxsize=1)
def _reference_loss():
    """The reference's loss_fn on the invariance test's weights and batch
    (compiled once for the three plans)."""
    jcfg = jax_arch("qwen1.5-0.5b").smoke_config
    b = _batch(get_arch("qwen1.5-0.5b").smoke_config)
    return float(run_once(lambda p, b: jax_loss_fn(jcfg, p, b, 0.0)[0],
                          jax.tree.map(jnp.asarray,
                                       _np_params("qwen1.5-0.5b")),
                          {k: jnp.asarray(v) for k, v in b.items()}))


@pytest.mark.parametrize("M", [1, 2, 4])
def test_plan_changes_preserve_loss(M):
    """FlexPipe invariance at one rank: the step's loss for M microbatches
    equals loss_fn's (the port's and the reference's) on the same weights,
    at the reference test's 3e-3 and at 1e-5."""
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    params = _np_params("qwen1.5-0.5b")
    b = _batch(cfg)
    ref = _reference_loss()
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    mine = float(loss_fn(cfg, params_from_numpy(params, "cpu"), tb,
                         aux_weight=0.0)[0])
    plan = PipelinePlan(microbatches=M)
    step, _ = build_train_step(cfg, plan, None,
                               ShapeConfig("t", 16, 8, "train"), AdamWConfig(),
                               param_dtype=torch.float32, aux_weight=0.0)
    p = stack_params(cfg, plan, params_from_numpy(params, "cpu"))
    _, _, m = step(p, init_opt_state(p), tb)
    for want in (ref, mine):
        assert abs(float(m["loss"]) - want) < 3e-3
        np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-5)


def test_cross_entropy_chunks_and_token_count():
    """The seq-chunked cross entropy: chunks of 4 give the one-chunk sum;
    a length the chunk does not divide counts only the positions its
    chunks cover, as the reference's token_count does."""
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    p = stack_params(cfg, PipelinePlan(),
                     params_from_numpy(_np_params("qwen1.5-0.5b"), "cpu"))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model))
                         .astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    whole, n = vp_cross_entropy(cfg, PipelinePlan(), p, x, lab)
    parts, n4 = vp_cross_entropy(cfg, PipelinePlan(), p, x, lab, chunk=4)
    assert float(n) == float(n4) == 32
    torch.testing.assert_close(parts, whole)
    _, n5 = vp_cross_entropy(cfg, PipelinePlan(), p, x, lab, chunk=5)
    assert float(n5) == 2 * 3 * 5              # 3 chunks of 5 of 16


@pytest.mark.parametrize("arch,S", [
    ("qwen1.5-0.5b", 1), ("qwen1.5-0.5b", 2), ("qwen1.5-0.5b", 4),
    ("jamba-v0.1-52b", 1), ("rwkv6-1.6b", 2), ("whisper-tiny", 1),
    ("deepseek-v2-236b", 2)])
def test_stacked_layout_equals_reference(arch, S):
    """stack_params gives the reference's tree (keys, shapes, values) for
    S stages; unstack_params gives the params back exactly."""
    jcfg, cfg = jax_arch(arch).smoke_config, get_arch(arch).smoke_config
    params = _np_params(arch, seed=1)
    jplan, plan = JPlan(stages=S), PipelinePlan(stages=S)
    want = jax.tree.map(np.asarray, run_once(
        lambda p: jax_stack_params(jcfg, jplan, p),
        jax.tree.map(jnp.asarray, params)))
    tp = params_from_numpy(params, "cpu")
    stacked = stack_params(cfg, plan, tp)
    got = tree_to_numpy(stacked)

    def same(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a.shape == b.shape and np.array_equal(a, b)

    same(got, want)
    meta = stacked_param_struct(cfg, plan, torch.float32)
    assert [tuple(x.shape) for x in tree_leaves(meta)] == \
        [tuple(x.shape) for x in tree_leaves(stacked)]
    back = unstack_params(cfg, plan, stacked)
    for a, b in zip(tree_leaves(tp), tree_leaves(back)):
        assert torch.equal(a, b)
