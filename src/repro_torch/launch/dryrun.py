"""Multi-pod dry run: every (architecture x input shape) cell on the
production meshes, as one rank's real step at the cell's full shape on
meta tensors, with the roofline beside it.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each cell on 256 or 512 fake CPU devices and records XLA's memory and cost
analyses and a census of the HLO's collectives.  The port has no HLO.  It
joins torch's fake process group as one rank of a world of 256 (512 over
two pods), builds the production mesh (``launch/mesh.py``) and the plan's
step (``parallel/pipeline.py``), and runs the step once on this rank's
local params, optimizer state, caches and inputs as meta tensors: every
operation computes shapes only (the kernel wrappers' meta route,
``kernels/build.py``), and every collective is counted with its bytes
(``parallel/comm.py``).  Each cell records:

- the plan, or ``skipped`` for the arch's ``skip_shapes``;
- ``memory``: the bytes of the local params, optimizer moments, caches and
  inputs the step holds (the counterpart of ``memory_analysis``);
- ``collectives``: by op, the calls one step issues at this rank and the
  bytes of their local tensors (``comm.stats()``).  Every call is counted,
  loop bodies each time they run; the reference's HLO census counts each
  occurrence once, loop bodies once;
- ``param_dtype``: bf16 for every cell, as the reference's (its
  ``build_train_step``, ``build_prefill_step`` and ``build_decode_step``
  default to bf16, and its dry run passes no dtype);
- ``roofline`` and ``hbm_analytic``: ``step_costs`` and ``hbm_footprint``
  on an H100 (``launch/roofline.py``) at that dtype's bytes;
- ``status`` ``error`` and the reason where the step cannot run on meta
  tensors (an operation that needs data, or a kernel call the card would
  refuse: the wrappers check their inputs on meta as on CUDA), as the
  reference records a compile failure; the run then exits non-zero.

Usage (the CPU; nothing runs on a device):
    PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-110b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k --multipod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --out results/torch_dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import (SHAPES, ModelConfig, PipelinePlan,
                                      ShapeConfig, get_arch, list_archs)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.roofline import H100_SXM, hbm_footprint, step_costs
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import shard
from repro_torch.tree import tree_leaves, tree_map

GB = 1024 ** 3
CENSUS = ("every collective call one step issues at this rank, loop bodies "
          "counted each time they run; bytes: the local tensor each call "
          "takes")
# the steps' params: bf16 for every kind, the reference's default
PARAM_DTYPE = {"train": torch.bfloat16, "prefill": torch.bfloat16,
               "decode": torch.bfloat16}


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as rank ``rank`` of a world of ``world`` in torch's fake
    process group, whose collectives move nothing; the groups the meshes
    made are dropped on the way out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
        mesh_mod._GROUPS.clear()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _fill(struct, device, seed: int = 0, vocab: int = 2):
    """Tensors of ``struct``'s shapes and dtypes on ``device``: uninitialised
    on meta; elsewhere small normals from ``seed`` (ids below ``vocab``)."""
    if torch.device(device).type == "meta":
        return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                              device="meta"), struct)
    g = torch.Generator().manual_seed(seed)

    def one(s):
        if s.dtype.is_floating_point:
            x = torch.randn(s.shape, generator=g) * 0.02
        else:
            x = torch.randint(0, vocab, s.shape, generator=g)
        return x.to(device=device, dtype=s.dtype)
    return tree_map(one, struct)


def step_census(cfg: ModelConfig, shape: ShapeConfig, plan: PipelinePlan,
                base_mesh, *, param_dtype: torch.dtype,
                device="meta") -> dict:
    """Build ``plan``'s step for ``shape`` on ``base_mesh`` and run it once
    on this rank's local params, optimizer state, caches and inputs on
    ``device`` (meta: shapes only; the CPU: small normals from seed 0).
    Returns the bytes it held by kind, and the collectives it issued."""
    from repro_torch.parallel.pipeline import (build_decode_step,
                                               build_prefill_step,
                                               build_train_step)
    from repro_torch.training.optimizer import init_opt_state
    vocab = cfg.vocab_size
    if shape.kind == "train":
        step, st = build_train_step(cfg, plan, base_mesh, shape,
                                    param_dtype=param_dtype)
    elif shape.kind == "prefill":
        step, st = build_prefill_step(cfg, plan, base_mesh, shape,
                                      param_dtype=param_dtype)
    else:
        step, st = build_decode_step(cfg, plan, base_mesh, shape,
                                     param_dtype=param_dtype)
    mesh = st["mesh"]
    local = (lambda tree, specs: shard(tree, specs, mesh)) if mesh \
        is not None else (lambda tree, specs: tree)
    params = local(_fill(st["params"], device, 0, vocab), st["pspecs"])
    mem = {"params": _nbytes(params), "opt": 0, "cache": 0, "inputs": 0}
    comm.reset_stats()
    if shape.kind == "train":
        opt = init_opt_state(params)
        batch = local(_fill(st["batch"], device, 1, vocab), st["bspecs"])
        mem["opt"] = _nbytes(opt)
        mem["inputs"] = _nbytes(batch)
        comm.reset_stats()
        step(params, opt, batch)
    elif shape.kind == "prefill":
        batch = local(_fill(st["batch"], device, 1, vocab), st["bspecs"])
        mem["inputs"] = _nbytes(batch)
        comm.reset_stats()
        _, caches = step(params, batch)
        mem["cache"] = _nbytes(caches)
    else:
        caches = local(_fill(st["cache"], device, 2, vocab), st["cspecs"])
        tokens = local(_fill(st["tokens"], device, 1, vocab), st["tspec"])
        mem["cache"] = _nbytes(caches)
        mem["inputs"] = _nbytes(tokens)
        comm.reset_stats()
        step(params, caches, tokens, shape.seq_len - 1)
    stats = comm.stats()
    comm.reset_stats()
    ops = ("all_reduce", "all_gather", "reduce_scatter", "ppermute")
    return {"memory": mem,
            "collectives": {"counts": {op: stats.get(op, 0) for op in ops},
                            "bytes": {op: stats.get(op + "_bytes", 0)
                                      for op in ops},
                            "total": stats.get("collectives", 0),
                            "what": CENSUS}}


def census_rank(rank: int, world: int, device, cases, mesh_shape,
                param_dtype=torch.float32) -> list:
    """``step_census`` of each (cfg, shape, plan) of ``cases`` at this rank
    of a (data, model) ``mesh_shape`` mesh: a rank of a real world
    (``launch.mesh.run_world``) on the CPU, or of a ``fake_world`` on
    meta tensors; the two must count the same collectives."""
    base = mesh_mod.make_local_mesh(*mesh_shape, device=device)
    return [step_census(cfg, shape, plan, base, device=device,
                        param_dtype=param_dtype)
            for cfg, shape, plan in cases]


def _plan_record(plan: PipelinePlan) -> dict:
    return {"S": plan.stages, "T": plan.tensor, "R": plan.replica,
            "M": plan.microbatches, "fsdp": plan.fsdp,
            "sp": plan.seq_parallel_kv, "kv_dtype": plan.kv_dtype,
            "fsdp_fp8_gather": plan.fsdp_fp8_gather}


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             plan: PipelinePlan | None = None, verbose: bool = True) -> dict:
    """One cell, in the fake world the caller joined (``fake_world``)."""
    spec = get_arch(arch)
    cfg, shape = spec.config, SHAPES[shape_name]
    plan = plan if plan is not None else spec.plan_for(shape_name)
    pod = 2 if multi_pod else 1
    dtype = PARAM_DTYPE[shape.kind]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "rank": dist.get_rank(), "plan": _plan_record(plan),
           "param_dtype": str(dtype).removeprefix("torch.")}
    if shape_name in spec.skip_shapes:
        rec["status"] = "skipped"
        rec["skip_reason"] = "the arch's skip_shapes (as the reference's)"
        return rec
    try:
        t0 = time.time()
        base = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                             device="meta")
        rec.update(step_census(cfg, shape, plan, base, param_dtype=dtype))
        rec["status"] = "ok"
        rec["run_s"] = round(time.time() - t0, 1)
        rec["memory"] = {k + "_gb": v / GB for k, v in rec["memory"].items()}
        rec["roofline"] = step_costs(cfg, shape, plan, pod=pod, chip=H100_SXM,
                                     bytes_per_el=dtype.itemsize)
        rec["hbm_analytic"] = hbm_footprint(cfg, shape, plan, pod=pod,
                                            chip=H100_SXM,
                                            bytes_per_el=dtype.itemsize)
        if verbose:
            r, m = rec["roofline"], rec["memory"]
            print(f"  OK run={rec['run_s']:.1f}s | "
                  f"compute={r['compute_s'] * 1e3:.1f}ms "
                  f"mem={r['memory_s'] * 1e3:.1f}ms "
                  f"coll={r['collective_s'] * 1e3:.1f}ms dom={r['dominant']} "
                  f"bubble={r['bubble_fraction']:.2f} | "
                  f"hbm={rec['hbm_analytic']['total_gb']:.1f}GB "
                  f"held={sum(m.values()):.2f}GB")
            print(f"     collectives: {rec['collectives']['counts']}")
    except Exception as e:  # noqa: BLE001 (record and go on)
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"  ERROR {type(e).__name__}: {str(e)[:200]}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true",
                    help="run only the 2x16x16 mesh (default: both)")
    ap.add_argument("--singlepod", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun.json")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True]
    if args.multipod:
        meshes = [True]
    elif args.singlepod:
        meshes = [False]

    results = []
    for mp in meshes:
        with fake_world(512 if mp else 256), torch.no_grad():
            for arch in archs:
                for shape in shapes:
                    print(f"[{'2x16x16' if mp else '16x16'}] {arch} x "
                          f"{shape}")
                    results.append(run_cell(arch, shape, mp))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    # merge with earlier results (a re-run overwrites its cells)
    existing = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    key = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
    merged = {key(r): r for r in existing}
    for r in results:
        r.pop("traceback", None)
        merged[key(r)] = r
    with open(args.out, "w") as f:
        json.dump(list(merged.values()), f, indent=1)

    n = {s: sum(1 for r in results if r["status"] == s)
         for s in ("ok", "skipped", "error")}
    print(f"\n== dry-run: {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['error']} errors -> {args.out}")
    for r in results:
        if r["status"] == "error":
            print(f"  FAIL {r['arch']} x {r['shape']} [{r['mesh']}]: "
                  f"{r['error'][:160]}")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
