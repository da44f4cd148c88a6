"""Worlds of repro_torch ranks for the multi-rank tests (a helper, like
jax_compile.py, not a test file).

``run_cases(cases)`` starts one gloo world of ``nranks`` CPU processes
through ``repro_torch.launch.mesh.run_world`` (spawned, a ``file://``
rendezvous in a fresh temporary directory, one torch thread a rank, a 120 s
process-group timeout, the whole world killed after 240 s or on the first
rank that fails, with that rank's traceback in the error) and runs a list
of cases in it, every rank in the same order.  A case is a dict of numpy
inputs that the parent made (the test files compute the JAX side on the
8-device host mesh); the result of each case is rank 0's, global trees
gathered back with ``sharding.unshard``.

The ranks import only this module, numpy and repro_torch: no JAX and
nothing of ``repro`` (each checks ``sys.modules``).
"""
import sys

import numpy as np

NRANKS = 8


def run_cases(cases, nranks=NRANKS, timeout_s=240.0, device="cpu"):
    """Rank 0's result of each case, in order.  ``device=None`` puts each
    rank on its CUDA device (ranks sharing a card when there is one)."""
    from repro_torch.launch.mesh import run_world
    out = run_world(_rank_main, nranks, (cases,), backend="gloo",
                    device=device, timeout_s=timeout_s, threads=1)
    return out[0]


def _rank_main(rank, world, device, cases):
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        raise RuntimeError(f"rank {rank} imported {bad[:5]}")
    results = [HANDLERS[c["kind"]](c, device) for c in cases]
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        raise RuntimeError(f"rank {rank} imported {bad[:5]}")
    return results if rank == 0 else None


def _np(tree):
    from repro_torch.convert import tree_to_numpy
    return tree_to_numpy(tree)


def _torch(tree, device):
    import torch
    if isinstance(tree, dict):
        return {k: _torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def _counts():
    """The kernels' launches and the collectives since the last reset."""
    from repro_torch.kernels import build
    from repro_torch.parallel import comm
    out = {"launches": dict(build.launches), "comm": comm.stats()}
    build.reset_launches()
    comm.reset_stats()
    return out


def _setup(c, device):
    import torch

    from repro_torch.configs.base import PipelinePlan, get_arch
    from repro_torch.launch.mesh import Mesh
    cfg = get_arch(c["arch"]).smoke_config
    plan = PipelinePlan(**c["plan"])
    shape = c.get("mesh", (2, 4))
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    base = Mesh(names, shape, device)
    return torch, cfg, plan, base


def _train(c, device):
    """``steps`` train steps on the stacked params; the metrics of each,
    and the global stacked params and moments after the last."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.parallel.pipeline import build_train_step, stack_params
    from repro_torch.parallel.sharding import shard, unshard
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    torch, cfg, plan, base = _setup(c, device)
    B, S = c["batches"][0]["tokens"].shape
    step, st = build_train_step(
        cfg, plan, base, ShapeConfig("t", S, B, "train"),
        AdamWConfig(**c["opt"]), param_dtype=torch.float32,
        compress_pod=c.get("compress_pod", False),
        aux_weight=c.get("aux_weight", 0.0))
    mesh = st["mesh"]
    g = stack_params(cfg, plan, params_from_numpy(c["params"], device))
    p = shard(g, st["pspecs"], mesh)
    o = init_opt_state(p)
    metrics = []
    _counts()
    for b in c["batches"]:
        p, o, m = step(p, o, shard(_torch(b, device), st["bspecs"], mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "mesh": dict(zip(mesh.axis_names,
                                                mesh.shape)), **_counts()}
    if c.get("return_params", True):
        out["params"] = _np(unshard(p, st["pspecs"], mesh))
        out["m"] = _np(unshard(o.m, st["pspecs"], mesh))
        out["v"] = _np(unshard(o.v, st["pspecs"], mesh))
    return out


def _serve(c, device):
    """A prefill of all but the last ``decode_steps`` tokens (with the
    case's memory or frames), then one decode step of each later token; every step's global logits, the global
    caches after the prefill, and each step's kernel launches and
    collectives at this rank."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.parallel.pipeline import (build_decode_step,
                                               build_prefill_step,
                                               stack_params)
    from repro_torch.parallel.sharding import shard, unshard
    torch, cfg, plan, base = _setup(c, device)
    tokens = torch.from_numpy(c["tokens"]).to(device)
    B = tokens.shape[0]
    n_dec = c.get("decode_steps", 1)
    S0 = tokens.shape[1] - n_dec
    max_seq = c["max_seq"]
    f32 = torch.float32
    pre, pst = build_prefill_step(cfg, plan, base,
                                  ShapeConfig("p", max_seq, B, "prefill"),
                                  param_dtype=f32, cache_dtype=f32)
    dec, dst = build_decode_step(cfg, plan, base,
                                 ShapeConfig("d", max_seq, B, "decode"),
                                 param_dtype=f32, cache_dtype=f32)
    mesh = pst["mesh"]
    g = stack_params(cfg, plan, params_from_numpy(c["params"], device))
    p = shard(g, pst["pspecs"], mesh)
    batch = {"tokens": tokens[:, :S0]}
    for k in ("memory", "frames"):
        if k in c:
            batch[k] = torch.from_numpy(c[k]).to(device)
    _counts()
    last, caches = pre(p, shard(batch, pst["bspecs"], mesh))
    counts = {"prefill_counts": _counts()}
    out = {"prefill": _np(unshard(last, pst["lspec"], mesh)),
           "caches": _np(unshard(caches, pst["cspecs"], mesh)),
           "decode": []}
    for i in range(n_dec):
        tok = shard(tokens[:, S0 + i:S0 + i + 1], dst["tspec"], mesh)
        _counts()
        logits, caches = dec(p, caches, tok, S0 + i)
        counts[f"decode{i}_counts"] = _counts()
        out["decode"].append(_np(unshard(logits, dst["lspec"], mesh)))
    return {**out, **counts}


def _roundtrip(c, device):
    """stack -> shard -> unshard -> unstack of the params, and the global
    stacked tree."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.parallel.pipeline import (stack_params,
                                               stacked_param_struct,
                                               unstack_params)
    from repro_torch.parallel.sharding import (refine_mesh, shard,
                                               stacked_param_specs, unshard)
    torch, cfg, plan, base = _setup(c, device)
    mesh = refine_mesh(base, plan)
    specs = stacked_param_specs(cfg, plan, stacked_param_struct(
        cfg, plan, torch.float32))
    g = stack_params(cfg, plan, params_from_numpy(c["params"], device))
    back = unshard(shard(g, specs, mesh), specs, mesh)
    return {"stacked": _np(back),
            "params": _np(unstack_params(cfg, plan, back))}


def _compressed(c, device):
    """``compressed_psum`` over "pod" of each rank's row of ``g``, and the
    global result (rows by pod index)."""
    import torch

    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import comm
    from repro_torch.training.compression import compressed_psum
    mesh = Mesh(("pod", "model"), c["mesh"], device)
    g = torch.from_numpy(c["g"])
    with comm.bind(mesh):
        mine = g[mesh.index("pod") * mesh.size("model")
                 + mesh.index("model")]
        out = compressed_psum(mine, "pod")
        return _np(comm.gather_leaf(out[None], [("pod", "model")]))


def _comm(c, device):
    """Each collective of ``parallel.comm`` over a (data 2, model 4) mesh,
    a scalar of their outputs psummed over every rank, and its gradient
    at this rank's row of ``x`` (``jax.grad`` inside ``shard_map``, as the
    reference's steps take theirs); both gathered by rank; rank 0's fp8
    FSDP gather of a bf16 leaf over "data".  And ``make_production_mesh``
    on a world of 8."""
    import torch

    from repro_torch.launch.mesh import Mesh, make_production_mesh
    from repro_torch.parallel import comm
    mesh = Mesh(("data", "model"), (2, 4), device)
    w = torch.from_numpy(c["w"])
    with comm.bind(mesh):
        r = mesh.index(("data", "model"))
        x = torch.from_numpy(c["x"][r:r + 1]).requires_grad_(True)
        a = comm.psum(x, "model")
        b = comm.all_gather(x, "model", dim=1)
        s = comm.psum_scatter(b * w[4], "model", dim=1)
        d = comm.ppermute(x, "model", [(i, (i + 1) % 4) for i in range(4)])
        m = comm.pmax(x, "data")
        local = ((a * w[0][:, :6]).sum() + (b * w[1]).sum()
                 + (s * w[2][:, :6]).sum() + (d * w[3][:, :6]).sum()
                 + (m * x).sum())
        total = comm.psum(local, ("data", "model"))
        total.backward()
        out = {"total": float(total),
               "grad": _np(comm.gather_leaf(x.grad, [("data", "model")])),
               "index": (comm.axis_index("data"), comm.axis_index("model"),
                         comm.axis_index(("data", "model")))}
    with comm.bind(mesh):
        # FSDP's fp8 gather: a bf16 leaf cast to float8_e4m3fn for the wire
        # (gloo moves its bytes) and back
        from repro_torch.parallel.sharding import fsdp_gather
        leaf = torch.from_numpy(c["x"][r:r + 1]).to(torch.bfloat16)
        out["fp8"] = _np(fsdp_gather({"w": leaf}, {"w": 0},
                                     gather_dtype=torch.float8_e4m3fn)["w"])
    try:
        make_production_mesh(device=device)
    except ValueError as e:
        out["production"] = str(e)
    return out


def _elastic(c, device):
    """``elastic_mesh``'s shape and axes for each (n, model, pods), or the
    error it raised; and the coordinates of rank 0."""
    from repro_torch.training.fault_tolerance import elastic_mesh
    out = []
    for n, model, pods in c["calls"]:
        try:
            m = elastic_mesh(n, model, pods, device=device)
            out.append((m.shape, m.axis_names, m.coords))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


HANDLERS = {"train": _train, "serve": _serve, "roundtrip": _roundtrip,
            "compressed": _compressed, "elastic": _elastic, "comm": _comm}
