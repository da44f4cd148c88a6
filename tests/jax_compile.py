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


def with_gates(tree, seed):
    """``tree`` with every cross ``gate`` set from ``seed`` to +-[0.5,
    1.5]: |tanh| >= 0.46, so a wrong cross layer changes the tokens (the
    init sets every gate to 0, where a cross layer adds nothing)."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: (np.float32(rng.choice([-1.0, 1.0])
                                   * rng.uniform(0.5, 1.5))
                        if k == "gate" else walk(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return walk(tree)


def np_params(cfg, seed=0):
    """Params for both packages, drawn by the port's init (no JAX compile)
    and handed over as numpy: the JAX package's layout and scales."""
    import torch

    from repro_torch.convert import tree_to_numpy
    from repro_torch.models.transformer import init_model
    return tree_to_numpy(init_model(cfg, torch.Generator().manual_seed(seed),
                                    device="cpu"))


# ---------------------------------------------------------------------------
# the reference's SPMD steps on the 8-device host mesh, for the multi-rank
# tests (tests/torch_dist.py runs the port's side)
# ---------------------------------------------------------------------------

def host_mesh(shape=(2, 4)):
    """The reference test's (data, model) mesh, or (pod, data, model)."""
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    return jax.make_mesh(shape, names)


def case_batch(cfg, seed=0, B=8, S=16):
    """tokens (labels = tokens, as tests/test_pipeline_parallel.py has
    them) and the arch's frames or memory, as numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    elif cfg.n_memory_tokens:
        batch["memory"] = rng.standard_normal(
            (B, cfg.n_memory_tokens, cfg.d_model)).astype(np.float32)
    return batch


def jax_train(arch, plan_kw, params, batch, opt_kw, mesh_shape=(2, 4),
              compress_pod=False):
    """One step of the reference's build_train_step: (metrics, stacked
    params, m, v, the stacked params before the step) as numpy trees."""
    import jax.numpy as jnp
    import numpy as np

    from repro.configs.base import PipelinePlan, ShapeConfig, get_arch
    from repro.parallel.pipeline import build_train_step, stack_params
    from repro.training.optimizer import AdamWConfig, init_opt_state
    cfg = get_arch(arch).smoke_config
    plan = PipelinePlan(**plan_kw)
    B, S = batch["tokens"].shape
    step, _ = build_train_step(cfg, plan, host_mesh(mesh_shape),
                               ShapeConfig("t", S, B, "train"),
                               AdamWConfig(**opt_kw),
                               param_dtype=jnp.float32,
                               compress_pod=compress_pod, aux_weight=0.0)
    stacked = stack_params(cfg, plan, jax.tree.map(jnp.asarray, params))
    opt = init_opt_state(stacked)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    before = to_np(stacked)
    p, o, m = compiled(step, stacked, opt, jb)(stacked, opt, jb)
    return ({k: float(v) for k, v in m.items()}, to_np(p), to_np(o.m),
            to_np(o.v), before)


def single_device(arch, params, batch):
    """The reference's loss_fn on one device, and the port's single-device
    gradient norm of its own loss_fn (held to the reference's in
    tests/test_torch_train_loss.py)."""
    import jax.numpy as jnp
    import torch

    from repro.configs.base import get_arch as jax_arch
    from repro.models.model import loss_fn as jax_loss_fn
    from repro_torch.configs.base import get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import loss_fn
    from repro_torch.tree import tree_flatten, tree_unflatten
    jcfg, cfg = jax_arch(arch).smoke_config, get_arch(arch).smoke_config
    ref = float(run_once(lambda p, b: jax_loss_fn(jcfg, p, b, 0.0)[0],
                         jax.tree.map(jnp.asarray, params),
                         {k: jnp.asarray(v) for k, v in batch.items()}))
    leaves, treedef = tree_flatten(params_from_numpy(params, "cpu"))
    leaves = [x.requires_grad_(True) for x in leaves]
    loss, _ = loss_fn(cfg, tree_unflatten(treedef, leaves),
                      {k: torch.from_numpy(v) for k, v in batch.items()},
                      aux_weight=0.0)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                for g in grads if g is not None)))
    return ref, norm


def hold_trees(got, want, atol, rtol, what=""):
    """Every leaf of two numpy trees (the port's, the reference's) of one
    structure close; returns the largest difference."""
    import numpy as np
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), (what, len(g), len(w))
    worst = 0.0
    for a, b in zip(g, w):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=what)
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def hold_update(got, want, before, rtol):
    """Each leaf's change from ``before`` in ``got`` (the port's) against
    its change in ``want`` (the reference's): the norm of their difference
    at most ``rtol`` times the norm of the reference's change; returns the
    largest such ratio."""
    import numpy as np
    worst = 0.0
    for a, b, p in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(before)):
        dg = a.astype(np.float64) - p
        dw = b.astype(np.float64) - p
        off, size = np.linalg.norm(dg - dw), np.linalg.norm(dw)
        assert off <= rtol * size, ("update", a.shape, off, size)
        worst = max(worst, off / size if size else 0.0)
    return worst


# the port's change of the params in one step against the reference's, in
# norm per leaf (hold_update): 4x the largest ratio the CPU cases show
# (5.1e-3); an update lost or put on another shard is off by 1 or more
UPDATE_RTOL = 2e-2


def hold_train(got, jax_out, ref_loss, norm1, world, tol, hold=None,
               world_rtol=1e-4, update_rtol=UPDATE_RTOL):
    """The port's train case against the reference's step and its
    single-device loss; both grad norms against ``world`` times the
    single-device one at ``world_rtol`` (the reference's quirk, ROADMAP.md
    section 3).  ``hold(got, want, tol, name)`` holds the params and
    moments (``hold_trees`` at ``tol[name]`` by default).
    Adam's first step moves each param by about the step's lr, which can
    lie below the params' atol; so each leaf's change (after - before) is
    also held to the reference's change in norm (``hold_update``), where an
    update that was lost or put on another shard is off by its own size."""
    import numpy as np
    jm, jp, jmo, jv, jp0 = jax_out
    tm = got["metrics"][0]
    assert abs(tm["loss"] - ref_loss) < 3e-3, (tm["loss"], ref_loss)
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=1e-6)
    for name, g, w in (("params", got["params"], jp), ("m", got["m"], jmo),
                       ("v", got["v"], jv)):
        if hold is None:
            hold_trees(g, w, *tol[name], what=name)
        else:
            hold(g, w, tol[name], name)
    hold_update(got["params"], jp, jp0, update_rtol)
    np.testing.assert_allclose(jm["grad_norm"] / norm1, world,
                               rtol=world_rtol)
    np.testing.assert_allclose(tm["grad_norm"] / norm1, world,
                               rtol=world_rtol)


def train_case(arch, S, T, R, opt, M=2, **plan):
    """A train case for tests/torch_dist.py: the port's init (seed 0, cross
    gates from seed 7) and ``case_batch``, one step at AdamW ``opt``."""
    from repro_torch.configs.base import get_arch
    cfg = get_arch(arch).smoke_config
    return {"kind": "train", "arch": arch,
            "plan": dict(stages=S, tensor=T, replica=R, microbatches=M,
                         **plan),
            "params": with_gates(np_params(cfg), 7),
            "batches": [case_batch(cfg)], "opt": opt}


def jax_serve(arch, plan_kw, params, tokens, max_seq, mesh_shape=(2, 4),
              extra=None):
    """The reference's build_prefill_step over ``tokens[:, :-1]`` (and
    ``extra``: the arch's memory or frames), then its build_decode_step on
    the last token: (global prefill logits, global caches, decode logits)
    as numpy."""
    import jax.numpy as jnp
    import numpy as np

    from repro.configs.base import PipelinePlan, ShapeConfig, get_arch
    from repro.parallel.pipeline import (build_decode_step,
                                         build_prefill_step, stack_params)
    cfg = get_arch(arch).smoke_config
    plan = PipelinePlan(**plan_kw)
    B, S = tokens.shape
    mesh = host_mesh(mesh_shape)
    f32 = jnp.float32
    pre, _ = build_prefill_step(cfg, plan, mesh,
                                ShapeConfig("p", max_seq, B, "prefill"),
                                param_dtype=f32, cache_dtype=f32)
    dec, _ = build_decode_step(cfg, plan, mesh,
                               ShapeConfig("d", max_seq, B, "decode"),
                               param_dtype=f32, cache_dtype=f32)
    stacked = stack_params(cfg, plan, jax.tree.map(jnp.asarray, params))
    batch = {"tokens": jnp.asarray(tokens[:, :-1]),
             **{k: jnp.asarray(v) for k, v in (extra or {}).items()}}
    last, caches = compiled(pre, stacked, batch)(stacked, batch)
    caches_np = jax.tree.map(np.asarray, caches)
    args = (stacked, caches, jnp.asarray(tokens[:, -1:]),
            jnp.asarray(S - 1, jnp.int32))
    logits, _ = compiled(dec, *args)(*args)
    return np.asarray(last), caches_np, np.asarray(logits)


def single_device_serve(arch, params, tokens, max_seq, extra=None):
    """The reference's single-device prefill over ``tokens[:, :-1]`` (and
    ``extra``) and decode_step on the last token: (prefill logits,
    caches, decode logits) as numpy."""
    import jax.numpy as jnp
    import numpy as np

    from repro.configs.base import get_arch
    from repro.models.model import decode_step, prefill
    cfg = get_arch(arch).smoke_config
    S = tokens.shape[1]

    def run(p, t, ex):
        last, cache = prefill(cfg, p, {"tokens": t[:, :-1], **ex},
                              max_seq=max_seq, cache_dtype=jnp.float32)
        logits, _ = decode_step(cfg, p, t[:, -1:], cache, S - 1)
        return last, cache, logits

    out = run_once(run, jax.tree.map(jnp.asarray, params),
                   jnp.asarray(tokens),
                   {k: jnp.asarray(v) for k, v in (extra or {}).items()})
    return jax.tree.map(np.asarray, out)
