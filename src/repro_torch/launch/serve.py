"""Serving launcher: run the FlexPipe engine on an arch's smoke config with
a CV-controlled workload and live, controller-driven refactoring.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --rate 10 --cv 4 --duration 3 [--device cpu]

The twin of ``repro/launch/serve.py``: the same flags, profiles, boundaries
and ``EngineConfig``, with random weights from the port's own init (seed 0)
and ``--device``, which defaults to CUDA and raises without it.  The last
line counts the kernel launches of the run (none on the CPU, where each
kernel wrapper runs its plain version).  ``--arch`` takes every
registered arch: qwen1.5-0.5b, qwen1.5-110b, gemma3-1b, gemma3-12b,
rwkv6-1.6b, deepseek-moe-16b, deepseek-v2-236b (MLA), jamba-v0.1-52b,
llama-3.2-vision-11b and whisper-tiny.

Unlike the reference's launcher, which gives no request a memory, a
cross-attention or encoder-decoder arch (llama-3.2-vision-11b,
whisper-tiny) gets one per request from the run's seeded generator
(``attach_memories``): the frontend stub the configs describe, image
tokens or the encoder's output over frame embeddings.
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
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import build
from repro_torch.models.model import run_encoder
from repro_torch.models.transformer import init_model
from repro_torch.serving.admission import AdmissionConfig
from repro_torch.serving.engine import (EngineConfig, FlexPipeEngine,
                                        KVCacheConfig, PrefillConfig,
                                        memory_rows)
from repro_torch.serving.faults import (FaultInjector, FaultPolicy,
                                        StageHealthMonitor)
from repro_torch.serving.workload import audit_requests, synth_requests


def attach_memories(cfg: ModelConfig, params: dict, reqs: list,
                    max_seq: int, rng: np.random.Generator) -> None:
    """Give each request the memory a frontend would make, drawn from
    ``rng``: image tokens (1, M, d) for a cross-attention model, the
    encoder's output over frames (1, max_seq, d) for an encoder-decoder
    one; requests of other models are left as they are."""
    rows = memory_rows(cfg, max_seq)
    if rows is None:
        return
    for r in reqs:
        x = rng.standard_normal((1, rows, cfg.d_model)).astype(np.float32)
        if cfg.encoder_layers:
            frames = torch.from_numpy(x).to(params["embed"].device)
            r.memory = run_encoder(cfg, params, frames)
        else:
            r.memory = x


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--rate", type=float, default=10.0)
    ap.add_argument("--cv", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist; "
                         "'cpu' runs the kernels' plain versions)")
    # fault injection (0 disables a kind); the schedule is fully determined
    # by --fault-seed, so fault runs are reproducible
    fault = ap.add_argument_group("faults")
    fault.add_argument("--fault-seed", type=int, default=0)
    fault.add_argument("--preempt-rate", type=float, default=0.0,
                       help="stage preemptions per second of sim time")
    fault.add_argument("--slowdown-rate", type=float, default=0.0)
    fault.add_argument("--request-timeout", type=float, default=30.0)
    # KV-cache layout (EngineConfig.kv — KVCacheConfig)
    kv = ap.add_argument_group("kv-cache")
    kv.add_argument("--paged", action="store_true",
                    help="paged KV cache: block pools + per-slot tables")
    kv.add_argument("--block-size", type=int, default=16)
    kv.add_argument("--n-blocks", type=int, default=0,
                    help="physical blocks in the pool (0 = auto-size to "
                         "the dense footprint)")
    kv.add_argument("--paged-kernel", action="store_true",
                    help="block-table-walk decode kernel instead of the "
                         "gather path")
    # prefill scheduling (EngineConfig.prefill — PrefillConfig)
    pf = ap.add_argument_group("prefill")
    pf.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked continuous-batching prefill: tokens per "
                         "chunk (pow2 >= 16; 0 = whole-prompt prefill)")
    pf.add_argument("--prefill-budget", type=int, default=0,
                    help="max bucketed prompt tokens prefetched per tick "
                         "(0 = one chunk per tick)")
    pf.add_argument("--no-prefill-buckets", action="store_true",
                    help="disable pow2 prompt bucketing")
    # overload protection (EngineConfig.admission — AdmissionConfig);
    # --admission-depth arms it
    adm = ap.add_argument_group("admission")
    adm.add_argument("--admission-depth", type=int, default=0,
                     help="bounded admission queue depth (0 = unbounded "
                          "FIFO, admission control off)")
    adm.add_argument("--no-edf", action="store_true",
                     help="disable earliest-deadline-first admission")
    adm.add_argument("--no-shed", action="store_true",
                     help="disable deadline-based load shedding")
    adm.add_argument("--no-brownout", action="store_true",
                     help="disable brownout budget degradation")
    adm.add_argument("--kv-high", type=float, default=0.90,
                     help="KV watermark: pause admission above this "
                          "slot-row occupancy fraction")
    adm.add_argument("--kv-low", type=float, default=0.75,
                     help="KV watermark: resume admission below this")
    adm.add_argument("--deadline", type=float, default=10.0,
                     help="per-request SLO budget (seconds from arrival)")
    adm.add_argument("--priority-mix", default=None,
                     help="comma probabilities for interactive,standard,"
                          "batch classes (e.g. 0.2,0.6,0.2)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.smoke_config
    params = init_model(cfg, torch.Generator().manual_seed(0), device=device)
    n = cfg.n_layers
    profiles = [
        GranularityProfile(stages=max(n // 4, 1), batch=8, throughput=90,
                           latency=0.4, cv_opt=0.5),
        GranularityProfile(stages=max(n // 2, 2), batch=16, throughput=110,
                           latency=0.6, cv_opt=2.5),
    ]
    controller = FlexPipeController(cfg, profiles)
    admission = None
    if args.admission_depth > 0:
        admission = AdmissionConfig(
            max_queue_depth=args.admission_depth,
            edf=not args.no_edf, shed=not args.no_shed,
            brownout=not args.no_brownout,
            kv_high_watermark=args.kv_high, kv_low_watermark=args.kv_low)
    eng = FlexPipeEngine(cfg, params,
                         boundaries=[i * 4 for i in range(max(n // 4, 1))],
                         ecfg=EngineConfig(
                             max_batch=args.max_batch, max_seq=96,
                             # build every granularity the controller can
                             # pick: refactors then never build mid-stream
                             warm_profiles=tuple(p.stages for p in profiles),
                             # bound post-preemption replay to 8 ticks
                             snapshot_interval=8,
                             admission=admission,
                             kv=KVCacheConfig(
                                 paged=args.paged,
                                 block_size=args.block_size,
                                 n_blocks=args.n_blocks,
                                 paged_kernel=args.paged_kernel),
                             prefill=PrefillConfig(
                                 buckets=not args.no_prefill_buckets,
                                 chunk=args.prefill_chunk,
                                 budget=args.prefill_budget)),
                         device=device)
    if args.preempt_rate or args.slowdown_rate:
        eng.attach_faults(
            injector=FaultInjector(seed=args.fault_seed,
                                   horizon=args.duration,
                                   preempt_rate=args.preempt_rate,
                                   slowdown_rate=args.slowdown_rate),
            policy=FaultPolicy(timeout_s=args.request_timeout),
            monitor=StageHealthMonitor())
    rng = np.random.default_rng(0)
    mix = tuple(float(x) for x in args.priority_mix.split(",")) \
        if args.priority_mix else None
    reqs = synth_requests(rng, rate=args.rate, cv=args.cv,
                          duration=args.duration, prompt_mean=24,
                          decode_mean=8, deadline_s=args.deadline,
                          priority_mix=mix)
    attach_memories(cfg, params, reqs, eng.ecfg.max_seq, rng)
    print(f"{cfg.name}: serving {len(reqs)} requests "
          f"(rate={args.rate}, cv={args.cv}) on {device}")
    build.reset_launches()
    stats = eng.run(reqs, controller=controller)
    lat = stats.latency_percentiles()
    print(f"completed={stats.completed} p50={lat['p50']:.2f}s "
          f"p99={lat['p99']:.2f}s refactors={len(eng.refactor_events)}")
    if eng.admission is not None:
        o = stats.overload_summary()
        counts, violations = audit_requests(reqs)
        print(f"admission: rejected={o['rejected']} shed={o['shed']} "
              f"brownout_degraded={o['brownout_degraded']} "
              f"ttft_p99={o['ttft']['p99']:.2f}s "
              f"saturation_mean={o['saturation']['mean']:.2f}")
        print(f"accounting={counts} violations={len(violations)} "
              f"goodput={stats.slo_met / max(args.duration, 1e-9):.2f}/s")
    if eng.faults is not None:
        s = stats.fault_summary(args.duration)
        print(f"faults={s['counters']} recoveries={s['recoveries']} "
              f"median_recovery={s['median_recovery_s'] * 1e3:.1f}ms "
              f"failed={len(eng.failed_requests)}")
    print("launches=" + json.dumps(dict(sorted(build.launches.items()))))


if __name__ == "__main__":
    main()
