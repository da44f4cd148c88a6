"""Plan hillclimbing: for chosen (arch x shape) cells, a sequence of plan
variants, each with its roofline terms and, by default, a check that the
plan's step runs.

The counterpart of ``repro/launch/hillclimb.py``, with the same cells and
variants.  The roofline terms come from ``launch/roofline.py`` on the
``Chip`` passed in (``H100_SXM`` by default) at ``bytes_per_el`` (2: the
steps' bf16); the reference's compile check becomes the meta dry run of
``launch/dryrun.py`` (one rank's real step at the cell's full shape on meta
tensors in a fake world of 256 ranks, train steps at f32, where a kernel
call the card would refuse fails the check), which also records the
step's collectives.  Results append to ``results/torch_perf_iterations.json``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell qwen110b_decode
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --no-compile
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.configs.base import SHAPES, PipelinePlan, get_arch
from repro_torch.launch.roofline import (H100_SXM, Chip, hbm_footprint,
                                         step_costs)

# hypothesis -> plan-variant sequences per cell (the reference's)
CELLS = {
    # (1) most representative of the paper: big-model decode serving.
    #     baseline S=8,T=2,M=4 is memory-bound with a 64% bubble.
    #     Hypotheses: (a) bubble ~ (S-1)/(M+S-1): trade stage depth for
    #     tensor width; (b) fp8 KV halves both the dominant memory term
    #     and the footprint.
    "qwen110b_decode": ("qwen1.5-110b", "decode_32k", [
        ("baseline S8 T2 M4 (paper-faithful granularity)",
         PipelinePlan(stages=8, tensor=2, replica=1, microbatches=4)),
        ("it1: more microbatches M=8 (bubble 0.64->0.47)",
         PipelinePlan(stages=8, tensor=2, replica=1, microbatches=8)),
        ("it2: S=4,T=4 M=8 (bubble ->0.27, same memory)",
         PipelinePlan(stages=4, tensor=4, replica=1, microbatches=8)),
        ("it3: S=2,T=8 M=8 (bubble ->0.11)",
         PipelinePlan(stages=2, tensor=8, replica=1, microbatches=8)),
        ("it4: + fp8 KV cache (memory term + footprint /2)",
         PipelinePlan(stages=2, tensor=8, replica=1, microbatches=8,
                      kv_dtype="fp8")),
        ("it5: S=1,T=8,R=2 pure-TP replicas (no pipeline)",
         PipelinePlan(stages=1, tensor=8, replica=2, microbatches=4,
                      kv_dtype="fp8")),
    ]),
    # (2) most collective-bound: MoE + MLA training.  FSDP re-gathers the
    #     full stage parameters every tick (forward and backward).
    #     Hypotheses: (a) gather traffic ~ ticks = M+S-1: shrink ticks;
    #     (b) fp8 gathers halve wire bytes; (c) compute/collective balance
    #     sets the optimum M.
    "dsv2_train": ("deepseek-v2-236b", "train_4k", [
        ("baseline S4 T4 M8 fsdp (paper-faithful)",
         PipelinePlan(stages=4, tensor=4, replica=1, microbatches=8,
                      fsdp=True)),
        ("it1: M=4 (ticks 11->7: gather x0.64, bubble 0.27->0.43)",
         PipelinePlan(stages=4, tensor=4, replica=1, microbatches=4,
                      fsdp=True)),
        ("it2: S=2,T=8 M=4 (ticks->5)",
         PipelinePlan(stages=2, tensor=8, replica=1, microbatches=4,
                      fsdp=True)),
        ("it3: + fp8 fsdp gathers (wire /2)",
         PipelinePlan(stages=2, tensor=8, replica=1, microbatches=4,
                      fsdp=True, fsdp_fp8_gather=True)),
        ("it4: S=1,T=16 M=2 (no pipeline: ticks=M=2)",
         PipelinePlan(stages=1, tensor=16, replica=1, microbatches=2,
                      fsdp=True, fsdp_fp8_gather=True)),
        ("it5: S=2,T=8 M=2 (check: fewer ticks vs bubble)",
         PipelinePlan(stages=2, tensor=8, replica=1, microbatches=2,
                      fsdp=True, fsdp_fp8_gather=True)),
    ]),
    # (3) worst bubble: low-batch 32k prefill (M=1).  The paper's own
    #     insight applies: stable, low-concurrency prefill wants coarse
    #     pipelines and more TP.
    "qwen110b_prefill": ("qwen1.5-110b", "prefill_32k", [
        ("baseline S4 T4 M1 (bubble 0.75)",
         PipelinePlan(stages=4, tensor=4, replica=1, microbatches=1)),
        ("it1: M=2 (Bm=1 each; bubble 0.6)",
         PipelinePlan(stages=4, tensor=4, replica=1, microbatches=2)),
        ("it2: S=2,T=8 M=2 (bubble 0.33)",
         PipelinePlan(stages=2, tensor=8, replica=1, microbatches=2)),
        ("it3: S=1,T=16 M=1 (pure TP: bubble 0)",
         PipelinePlan(stages=1, tensor=16, replica=1, microbatches=1)),
        ("it4: S=1,T=8,R=2 (TP + 2 replicas)",
         PipelinePlan(stages=1, tensor=8, replica=2, microbatches=1)),
        ("it5: S=2,T=8 M=2 + fp8 prefill cache (fits HBM)",
         PipelinePlan(stages=2, tensor=8, replica=1, microbatches=2,
                      kv_dtype="fp8")),
    ]),
}


def effective_time(r: dict, kind: str) -> float:
    base = max(r["compute_s"], r["memory_s"], r["collective_s"])
    if kind != "train":
        return base / max(1 - r["bubble_fraction"], 1e-9)
    return base


def evaluate(arch: str, shape_name: str, label: str, plan: PipelinePlan,
             compile_check: bool = True, *, chip: Chip = H100_SXM,
             bytes_per_el: int = 2) -> dict:
    """One variant: its roofline terms on ``chip`` and, with
    ``compile_check``, the meta dry run of its step (``compiled``: whether
    it ran, and its collectives)."""
    cfg = get_arch(arch).config
    shape = SHAPES[shape_name]
    plan.validate(cfg, 16)
    r = step_costs(cfg, shape, plan, chip=chip, bytes_per_el=bytes_per_el)
    h = hbm_footprint(cfg, shape, plan, chip=chip, bytes_per_el=bytes_per_el)
    rec = {"label": label, "arch": arch, "shape": shape_name,
           "plan": dataclasses.asdict(plan), "roofline": r, "hbm": h,
           "effective_s": effective_time(r, shape.kind)}
    if compile_check:
        from repro_torch.launch import dryrun
        t0 = time.time()
        with dryrun.fake_world(256):
            cell = dryrun.run_cell(arch, shape_name, False, plan=plan,
                                   verbose=False)
        rec["compiled"] = cell["status"] == "ok"
        rec["compile_s"] = round(time.time() - t0, 1)
        if rec["compiled"]:
            rec["collectives"] = cell["collectives"]
        else:
            rec["error"] = cell.get("error", "")[:300]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None)
    ap.add_argument("--out", default="results/torch_perf_iterations.json")
    ap.add_argument("--no-compile", action="store_true")
    args = ap.parse_args(argv)

    cells = [args.cell] if args.cell else list(CELLS)
    all_recs = []
    for cell in cells:
        arch, shape_name, variants = CELLS[cell]
        print(f"\n=== {cell}: {arch} x {shape_name} ===")
        best = None
        for label, plan in variants:
            rec = evaluate(arch, shape_name, label, plan,
                           compile_check=not args.no_compile)
            rec["cell"] = cell
            r = rec["roofline"]
            ok = rec.get("compiled", "n/a")
            fits = next(v for k, v in rec["hbm"].items()
                        if k.startswith("fits_"))
            print(f"  {label}")
            print(f"    comp={r['compute_s']:.2f}s mem={r['memory_s']:.3f}s "
                  f"coll={r['collective_s']:.2f}s "
                  f"bubble={r['bubble_fraction']:.2f} dom={r['dominant']} "
                  f"eff={rec['effective_s']:.3f}s "
                  f"hbm={rec['hbm']['total_gb']:.1f}GB fits={fits} "
                  f"compiled={ok}")
            if best is None or rec["effective_s"] < best["effective_s"]:
                best = rec
            all_recs.append(rec)
        base = next(x for x in all_recs if x["cell"] == cell)
        print(f"  >> best: {best['label']}: {base['effective_s']:.3f}s -> "
              f"{best['effective_s']:.3f}s "
              f"({base['effective_s'] / best['effective_s']:.2f}x)")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    existing = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    existing.extend(all_recs)
    with open(args.out, "w") as f:
        json.dump(existing, f, indent=1)
    print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
