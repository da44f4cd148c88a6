"""bf16 training, the reference's default, on the CPU.

The backward kernel of flash attention takes bf16: f32 math on the widened
inputs, each gradient rounded once to bf16 (``csrc/flash_attention_bwd.cu``).
Its plain version, ``flash_attention_bwd_plain``, follows that rule; here
it is held at bf16 against ``jax.grad`` of the JAX package's references at
bf16 inputs, at every head pair the kernel takes.

Then the one-rank ``build_train_step`` at its default dtype (bf16, as the
reference's ``build_train_step``) on the smoke configs of qwen1.5-0.5b,
gemma3-1b (hd 256) and deepseek-v2-236b (MLA's (192, 128) pair), against
the reference's step at its default dtype on the same converted params cast
to bf16, over 3 steps.  The two packages round to bf16 at other places
(PyTorch rounds each operation's output; XLA fuses chains of operations and
rounds once), so the port's bf16 run is as far from the reference's as two
independent bf16 runs are.  Each quantity's tolerance is therefore the
reference's own bf16-to-f32 distance (its step at f32 on the params at f32)
times ``FACTOR``: for the loss and the grad norm the largest distance over
the 3 steps, for each leaf the distance of its update over the 3 steps.
The worst ratios measured (port-to-reference over the reference's
distance): loss 0.80, grad norm 0.66, a leaf's update 1.09 (the q and k
biases, whose gradients are rounding noise in both packages: a softmax
row does not see a bias added to every key).

The kernel itself (bf16 bits against the f32 kernel on the widened
inputs, repeat bits, against its plain version) is held on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 21: those files
import no JAX.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_compile import compiled, hold_update, np_params, run_once

from repro.configs.base import PipelinePlan as JPlan
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_arch as jax_arch
from repro.kernels.ref import attention_ref
from repro.models.layers import flash_attention_jnp
from repro.parallel.pipeline import build_train_step as jax_build_train_step
from repro.parallel.pipeline import stack_params as jax_stack_params
from repro.training.optimizer import AdamWConfig as JAdamW
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.configs.base import PipelinePlan, ShapeConfig, get_arch
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import flash_attention as FA
from repro_torch.parallel.pipeline import build_train_step, stack_params
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

# chip_smoke.py's TOL["bfloat16"]: below one bf16 ulp the floor
BF16_ATOL = 5e-3
# flash_attention_jnp: twice its own bf16-to-f32 distance, element by
# element, plus this share of the largest gradient (the f32 sums of the two
# packages differ by about 1e-6 of it, which can move a value across a
# rounding midpoint)
JNP_ATOL_SHARE = 1e-5
# each train quantity: the reference's bf16-to-f32 distance times FACTOR
FACTOR = 2.0
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS = 3


def _bf16_np(rng, shape):
    """Normals rounded to bf16, as f32 numpy (both packages get the same
    bf16 values)."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _ulp_bf16(x):
    """One bf16 ulp at each |x| (normal range)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


def _jax_grads(fn, q, k, v, do, dtype):
    """dq, dk, dv of ``fn`` at ``dtype`` inputs for the cotangent ``do``, by
    jax.vjp, as f32 numpy."""
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    cot = jnp.asarray(do, dtype)

    def grads(q, k, v):
        return jax.vjp(fn, q, k, v)[1](cot)
    return [np.asarray(g.astype(jnp.float32)) for g in run_once(grads, *args)]


# (mask, G, q_offset): end-aligned rows where q_offset is None
FLASH_CASES = [("causal", 1, None), ("window", 4, 5), ("full", 4, None),
               ("causal", 2, 3)]


@pytest.mark.parametrize("hd,hdv", FA.HEAD_DIM_PAIRS)
@pytest.mark.parametrize("mask,G,q_offset", FLASH_CASES)
def test_flash_bwd_plain_bf16_equals_jax(hd, hdv, mask, G, q_offset):
    """The plain backward at bf16 (bf16 gradients) against jax.grad of
    ref.attention_ref at bf16 inputs within one bf16 ulp or BF16_ATOL, and
    of flash_attention_jnp (kv blocks of 16) at bf16 within twice its own
    distance from its f32 gradients plus a share of the largest gradient.
    attention_ref aligns rows to the end of the keys: a q_offset case
    gives it the keys the rows can reach (q_offset + Sq of them); the keys
    past them have zero gradients."""
    rng = np.random.default_rng(hd + 7 * G + (q_offset or 0))
    B, Sq, Skv, Kh = 2, 20, 28, 2
    H = Kh * G
    causal, window = mask != "full", 8 if mask == "window" else 0
    q, k = _bf16_np(rng, (B, Sq, H, hd)), _bf16_np(rng, (B, Skv, Kh, hd))
    v, do = _bf16_np(rng, (B, Skv, Kh, hdv)), _bf16_np(rng, (B, Sq, H, hdv))
    got = FA.flash_attention_bwd_plain(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)),
        causal=causal, window=window, q_offset=q_offset)
    assert all(g.dtype == torch.bfloat16 for g in got)
    got = [g.float().numpy() for g in got]

    reach = Skv if q_offset is None or not causal else q_offset + Sq
    want = _jax_grads(functools.partial(attention_ref, causal=causal,
                                        window=window),
                      q, k[:, :reach], v[:, :reach], do, jnp.bfloat16)
    for i, (g, w) in enumerate(zip(got, want)):
        if i:                              # dk, dv: keys past the reach
            assert not g[:, reach:].any()
            g = g[:, :reach]
        tol = np.maximum(_ulp_bf16(w), BF16_ATOL)
        assert (np.abs(g - w) <= tol).all(), \
            ("attention_ref", i, float(np.abs(g - w).max()))

    jnp_fn = functools.partial(flash_attention_jnp, causal=causal,
                               window=window, kv_block=16,
                               q_offset=(Skv - Sq) if q_offset is None
                               else q_offset)
    w16 = _jax_grads(jnp_fn, q, k, v, do, jnp.bfloat16)
    w32 = _jax_grads(jnp_fn, q, k, v, do, jnp.float32)
    for i, (g, a, b) in enumerate(zip(got, w16, w32)):
        atol = JNP_ATOL_SHARE * float(np.abs(b).max())
        assert (np.abs(g - a) <= 2 * np.abs(a - b) + atol).all(), \
            ("flash_attention_jnp", i, float(np.abs(g - a).max()))


def test_flash_bwd_plain_bf16_is_the_widened_f32_rounded():
    """The plain backward's bf16 rule: the f32 backward of the widened
    inputs, each gradient rounded once to bf16, with D from its own f32
    output or, as the kernel, from the forward's output ``o``; at f32 the
    ``o`` path (the kernel's decomposition written out) is autograd's
    gradient."""
    rng = np.random.default_rng(3)
    ins = [torch.from_numpy(_bf16_np(rng, s)).to(torch.bfloat16)
           for s in ((2, 24, 4, 64), (2, 24, 2, 64), (2, 24, 2, 64),
                     (2, 24, 4, 64))]
    wide = [t.float() for t in ins]
    o16 = FA.flash_attention_plain(*ins[:3], window=8)
    o32 = FA.flash_attention_plain(*wide[:3], window=8)
    assert o16.dtype == torch.bfloat16
    for o in (None, o16):
        got = FA.flash_attention_bwd_plain(*ins, window=8, o=o)
        want = FA.flash_attention_bwd_plain(
            *wide, window=8, o=None if o is None else o.float())
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            assert torch.equal(g, w.to(torch.bfloat16))
    auto = FA.flash_attention_bwd_plain(*wide, window=8)
    for g, w in zip(FA.flash_attention_bwd_plain(*wide, window=8, o=o32),
                    auto):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the one-rank train step at its default dtype
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ["qwen1.5-0.5b", "gemma3-1b", "deepseek-v2-236b"]


def _jax_run(arch, params, batches, dtype):
    """The reference's build_train_step on a (1, 1) mesh at its default
    dtype (``dtype`` None: bf16) or at ``dtype``, over ``batches``: each
    step's metrics, the stacked params before and after, as f64 numpy."""
    jcfg = jax_arch(arch).smoke_config
    jplan = JPlan(microbatches=2)
    kw = {} if dtype is None else {"param_dtype": dtype}
    step, _ = jax_build_train_step(
        jcfg, jplan, jax.make_mesh((1, 1), ("data", "model")),
        JShape("t", 16, 8, "train"), JAdamW(**OPT), **kw)
    cast = jnp.bfloat16 if dtype is None else dtype
    st = jax_stack_params(jcfg, jplan, jax.tree.map(
        lambda x: jnp.asarray(x, cast), params))
    opt = jax_init_opt_state(st)
    f64 = lambda t: jax.tree.map(  # noqa: E731
        lambda x: np.asarray(x.astype(jnp.float32), np.float64), t)
    before = f64(st)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    fn = compiled(step, st, opt, jb[0])
    metrics = []
    for b in jb:
        st, opt, m = fn(st, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, before, f64(st)


@functools.lru_cache(maxsize=None)
def _runs(arch):
    """The port's default-dtype run and the reference's at bf16 and f32,
    from the same params and TokenPipeline batches."""
    cfg = get_arch(arch).smoke_config
    params = np_params(cfg, 0)
    data = TokenPipeline(DataConfig(cfg.vocab_size, 16, 8, seed=0))
    batches = [data.batch(i) for i in range(STEPS)]
    ref16 = _jax_run(arch, params, batches, None)
    ref32 = _jax_run(arch, params, batches, jnp.float32)
    plan = PipelinePlan(microbatches=2)
    step, structs = build_train_step(cfg, plan, None,
                                     ShapeConfig("t", 16, 8, "train"),
                                     AdamWConfig(**OPT))
    assert {s.dtype for s in tree_leaves(structs["params"])} == \
        {torch.bfloat16}
    tp = stack_params(cfg, plan, tree_map(lambda x: x.to(torch.bfloat16),
                                          params_from_numpy(params, "cpu")))
    to = init_opt_state(tp)
    metrics = []
    for b in batches:
        tp, to, m = step(tp, to, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    assert {p.dtype for p in tree_leaves(tp)} == {torch.bfloat16}
    after = tree_to_numpy(tree_map(lambda x: x.double(), tp))
    return metrics, after, ref16, ref32


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_bf16_step_loss_and_grad_norm(arch):
    """Each step's loss and grad norm against the reference's bf16 step
    within FACTOR times the largest distance over the steps between the
    reference's bf16 and f32 runs; the lr exactly as the reference's."""
    mine, _, (m16, _, _), (m32, _, _) = _runs(arch)
    for key in ("loss", "grad_norm"):
        dist = max(abs(a[key] - b[key]) for a, b in zip(m16, m32))
        assert dist > 0, key
        for i, (a, b) in enumerate(zip(mine, m16)):
            assert math.isfinite(a[key])
            assert abs(a[key] - b[key]) <= FACTOR * dist, \
                (key, i, a[key], b[key], dist)
    for a, b in zip(mine, m16):
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_bf16_step_updates(arch):
    """Each leaf's change over the 3 steps against the reference's bf16
    run's, by ``hold_update``, at FACTOR times the reference's own
    bf16-to-f32 distance of that change over its size (a leaf the
    reference's bf16 run leaves where it was, such as a norm's scale of 1
    under updates below half its ulp, must stay too)."""
    _, after, (_, before, want), (_, before32, want32) = _runs(arch)
    got = jax.tree.leaves(after)
    want, before = jax.tree.leaves(want), jax.tree.leaves(before)
    want32, before32 = jax.tree.leaves(want32), jax.tree.leaves(before32)
    assert len(got) == len(want) == len(want32)
    moved = 0
    for a, b, p, c, p32 in zip(got, want, before, want32, before32):
        assert a.shape == b.shape
        dw, d32 = b - p, c - p32
        size = np.linalg.norm(dw)
        rtol = FACTOR * np.linalg.norm(dw - d32) / size if size else 0.0
        hold_update([a], [b], [p], rtol)
        moved += size > 0
    assert moved > len(got) // 2
