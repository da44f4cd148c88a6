"""Quickstart: serve a small model with batched requests through the
FlexPipe engine, including one live, controller-driven refactoring.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu] \
        [--arch qwen1.5-0.5b]

The twin of ``examples/quickstart.py``, with random weights from the
port's own init (seed 0).  ``--device`` defaults to CUDA and raises without
it; ``--arch`` serves another registered arch's smoke config (any of
``serve``'s list, deepseek-v2-236b's MLA included; the reference serves
qwen1.5-0.5b only), starting from two balanced stages,
and gives a cross-attention or encoder-decoder arch's requests seeded
memories (``serve.attach_memories``).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_arch
from repro_torch.core.controller import FlexPipeController
from repro_torch.core.granularity import GranularityProfile
from repro_torch.kernels import build
from repro_torch.launch.serve import attach_memories
from repro_torch.models.transformer import init_model
from repro_torch.serving.engine import (EngineConfig, FlexPipeEngine,
                                        balanced_boundaries)
from repro_torch.serving.workload import synth_requests

PROFILES = (
    GranularityProfile(stages=2, batch=8, throughput=90, latency=0.4,
                       cv_opt=0.5),
    GranularityProfile(stages=4, batch=16, throughput=110, latency=0.6,
                       cv_opt=2.5),
)


def requests() -> list:
    """A stable phase, then a burst: the controller should refactor 2 -> 4."""
    rng = np.random.default_rng(0)
    reqs = synth_requests(rng, rate=4.0, cv=0.4, duration=4.0,
                          prompt_mean=24, decode_mean=8)
    reqs += synth_requests(rng, rate=40.0, cv=5.0, duration=3.0, t0=4.0,
                           prompt_mean=24, decode_mean=8)
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch).smoke_config           # reduced config
    print(f"model: {cfg.name} ({cfg.n_layers}L, d={cfg.d_model}) on {device}")
    params = init_model(cfg, torch.Generator().manual_seed(0), device=device)

    controller = FlexPipeController(cfg, list(PROFILES))
    engine = FlexPipeEngine(
        cfg, params, boundaries=balanced_boundaries(cfg.n_layers, 2),
        ecfg=EngineConfig(max_batch=4, max_seq=96, control_interval=0.5,
                          # build both granularity profiles up front so the
                          # live refactor below is a pure cache hit
                          warm_profiles=tuple(p.stages for p in PROFILES)),
        device=device)

    reqs = requests()
    attach_memories(cfg, params, reqs, engine.ecfg.max_seq,
                    np.random.default_rng(1))
    print(f"submitting {len(reqs)} requests (stable -> burst)")
    build.reset_launches()
    stats = engine.run(reqs, controller=controller, time_per_tick=0.05)
    lat = stats.latency_percentiles()
    print(f"completed={stats.completed} p50={lat['p50']:.2f}s "
          f"p99={lat['p99']:.2f}s")
    print(f"refactor events: {len(engine.refactor_events)}")
    for ev in engine.refactor_events:
        print(f"  stages {len(ev['from'])} -> {len(ev['to'])} "
              f"({ev['inflight']} in-flight requests, {ev['t']*1e3:.3f} ms, "
              f"executor-cache hit={ev['compile_cache_hit']})")
    print("launches=" + json.dumps(dict(sorted(build.launches.items()))))
    if stats.completed != len(reqs):
        raise SystemExit(f"only {stats.completed} of {len(reqs)} requests "
                         "completed")
    print("OK")


if __name__ == "__main__":
    main()
