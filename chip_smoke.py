#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each fatal on failure:
  1. print the card (nvidia-smi name and power limit), torch/CUDA versions
     and the TF32 flags (both set off);
  2. build every CUDA kernel from src/repro_torch/kernels/csrc into
     build/kernels/ (one nvcc per source, in parallel);
  3. hold each kernel against its plain PyTorch version on the card, f32 and
     bf16, at the serving paths' shapes and at decode lengths straddling
     the split kernel's chunks; the paged kernel, the gather path and the
     dense kernel must agree bit for bit on equal live rows; wkv6 calls
     chained through their state must give one whole call's bits; time
     kernel, plain version and one PyTorch library call computing the same
     function, beside the bound; the same for gemma3-1b's attention shapes
     (head_dim 256, one kv head, a 512-token window) and MLA prefill's
     (hd 192, hdv 128), and at head_dim 128, deepseek-moe-16b's (16
     heads: prompt buckets of 512 and 1024, and a 128-row chunk at the
     end of a 512-token bucket) and jamba-v0.1-52b's (32 on 8 kv heads)
     decode, paged decode and flash shapes; each span or cluster kernel
     (flash at hd >= 128, decode at hd 256) with its registers and spills
     (from this run's build log, -Xptxas -v), its device time by kernel
     and its combine's share of it (the profiler), and in the log only its
     planned launch geometry (CTAs, cluster size, dynamic shared memory,
     computed from the wrapper's plan); the bf16 flash kernels on wgmma
     (flash_wgmma_kernel, hd <= 64, (128, 128) and (192, 128), and
     flash_wgspan_kernel at (256, 256)) at each pair against the plain
     version and their designs' mirror, repeat bits, no spills, the CTAs
     an SM holds; at bf16 (192, 128) (MLA prefill, 16 heads and
     deepseek-v2-236b's 128 at the 512 and 1024 buckets) and (256, 256)
     (gemma3-1b's 571-token prompt, causal and window 512) each is also
     timed in turns with the span kernel it replaced (built in phase 2
     from a copy of the source whose bf16 dispatch sends those pairs
     there);
  4. check the port's logits on the card against its CPU path (smoke size,
     qwen1.5-0.5b, rwkv6-1.6b, gemma3-1b, deepseek-moe-16b and
     jamba-v0.1-52b);
  5. serve full-width qwen1.5-0.5b (random weights from seed 0): a dense
     run through FlexPipeEngine.run, then dense, paged-gather and
     paged-kernel runs refactored [0,12] -> [0,6,12,18] -> [0,12] mid-stream;
     every stream must equal the unrefactored dense run, and every kernel
     must have been launched by the engine;
  6. time a cold and a warm refactor of a loaded dense engine (the cold
     one must allocate far less than the live cache), then profile a few
     dense decode ticks: device time by kernel, idle share;
  7. serve full-width rwkv6-1.6b the same way (dense only: its state does
     not page): run(), then a run refactored at the same ticks, streams
     bit-identical, every WKV step of the path in the wkv6 kernel, and each
     generated token of two requests equal to a whole-sequence forward's;
  8. phase 6 for the rwkv6-1.6b engine, and one 512-token stage prefill's
     wall time and device time by kernel;
  9. full-width qwen1.5-0.5b again: chunked prefill, an emergency refactor
     after a preempted stage, a graceful migration and an admission burst;
 10. the controller plane: full-width qwen1.5-0.5b (dense, and paged
     through the paged kernel) and rwkv6-1.6b (dense, its state regrouped)
     served through FlexPipeEngine.run(controller=FlexPipeController(...))
     on the quickstart's trace; every refactor warm, the control steps
     equal to the smoke config's run of the same trace on the CPU, the
     streams equal to a run with no controller, the median decision
     latency (score_s) under the paper's 5 ms; the launchers (python -m
     repro_torch.launch.serve and .quickstart) run as subprocesses on the
     card beside the CPU runs and the runs with no controller;
 11. serve full-width gemma3-1b (sliding-window ring caches, GeGLU,
     head_dim 256) as phase 5 serves qwen: run(), then a run refactored
     [0,13] -> [0,7,14,20] -> [0,13], streams bit-identical, every prefill
     and decode step through the flash and decode kernels, decode ==
     forward for two requests, and three profiled decode ticks, their
     device time by kernel beside the one-CTA-per-chunk decode kernel's;
 12. serve full-width deepseek-moe-16b (28 layers, 64 routed experts top-6
     and 2 shared, head_dim 128): run(), dense and paged-kernel runs
     refactored [0,14] -> [0,7,14,21] -> [0,14] with streams bit-identical
     and paged == dense, a chunk-128 run whose streams are counted where
     they differ from whole-prompt prefill (capacity drops: the
     reference's behaviour), decode == forward for two requests at the
     capacity factor E/K (nothing dropped), three profiled decode ticks,
     one 512-token prefill through all 28 layers (wall time, device time
     and the flash kernels' share) and the peak device memory;
 13. serve full-width jamba-v0.1-52b cut to one 8-layer Jamba block (7
     Mamba layers, 1 attention layer, 4 MoE MLPs of 16 experts):
     run() and a run refactored [0,4] -> [0,2,4,6] -> [0,4] with streams
     bit-identical, decode == forward at capacity factor E/K on requests
     in reused slots, three profiled decode ticks and the peak memory;
 14. serve full-width llama-3.2-vision-11b at full depth (40 layers, 8 of
     them gated cross attention over 1601 seeded image tokens a request,
     every gate set nonzero from a seed): run() and a run refactored
     [0,20] -> [0,10,20,30] -> [0,20], streams bit-identical, the flash
     and decode launches of the cross layers counted apart from the self
     layers', one served cross call of each kernel held against its plain
     version, decode == forward, three profiled ticks, the peak memory;
 15. serve full-width whisper-tiny with max_seq 1500: the port's encoder
     on the card over seeded (1, 1500, 384) frames makes each request's
     memory (its device time and flash launches), then as phase 14,
     refactored [0,2] -> [0,1,2,3] -> [0,2];
 16. serve full-width qwen1.5-110b cut to 8 layers (64 heads on 8, G = 8):
     run(), dense and paged-kernel runs refactored [0,4] -> [0,2,4,6] ->
     [0,4], streams bit-identical and paged == dense, decode == forward,
     three profiled ticks, the peak memory.  Phase 3 also holds and times
     non-causal flash at the vision cross shapes (Skv 1601) and whisper's
     encoder (hd 64, 1500 frames), cross decode over 1601 and 1500 memory
     rows, and decode at G = 8;
 17. serve full-width deepseek-v2-236b cut to 3 layers (MLA: 128 heads,
     kv_lora 512, q_lora 1536, (nope, rope, v) = (128, 64, 128); 160
     routed experts top-6 and 2 shared): run() and a run refactored [0,1]
     -> [0,1,2] -> [0,1], streams bit-identical, flash at (192, 128) once
     per layer per prefill and no decode kernel (decode is the absorbed
     form, torch products), decode == forward at capacity factor E/K,
     three profiled ticks, the absorbed decode timed alone at the served
     shape, the peak memory.  Phase 3 also holds and times flash at (192,
     128) with 128 heads (a 512 bucket and the 1024 bucket);
 18. training through the one-rank train step (repro_torch.parallel.
     pipeline.build_train_step): the backward kernels of flash attention
     and wkv6 against autograd through their plain versions at the
     full-width training shapes (flash B 4, Sq = Skv 512, 16 heads of 64,
     causal; wkv6 B 4, S 512, 32 heads of 64), two calls' bits equal,
     timed beside the bound, the plain backward and SDPA's backward; one
     step of qwen1.5-0.5b at full width cut to 2 layers on the card
     against the same step on the CPU; qwen1.5-0.5b at full width and
     depth (B 8, seq 512, M 2, remat, f32) for 20 steps, its loss falling,
     flash 24 x M x 2 and its backward 24 x M launches a step, no decode,
     ms per step, tokens/s, device busy and idle share, peak memory; the
     same run under TrainSupervisor with a checkpoint every 5 steps and a
     fault at step 12, each step's loss equal to the uninterrupted run's;
     rwkv6-1.6b at full width (B 4, seq 512, M 1) for 5 steps, wkv6's
     backward 24 launches a step;
 19. multi-rank execution: 4 rank processes share the card (spawned, the
     gloo backend named, every kernel built in phase 2 and only loaded by
     the ranks, each rank importing repro_torch alone) and run full-width
     qwen1.5-0.5b (24 layers, its vocabulary split over S x T = 4) at S =
     2, T = 2, M = 2 from the same seeded weights as a one-rank run here:
     build_prefill_step at B 8 x 512, 16 build_decode_step steps fed the
     one-rank run's greedy tokens (logits within PAR_LOGIT_TOL of its,
     greedy tokens equal where its top-2 margin exceeds 1e-3), and 5
     build_train_step steps (remat; step 0's loss within 1e-4 of one
     rank's, its grad norm 4 x one rank's, as the reference's psum
     transpose makes it, the loss falling); per rank the flash, flash
     backward and decode launches (exact counts), one served call of each
     held against its plain version, the collectives issued and bytes
     staged through host memory, ms per decode and train step and the
     peak memory, all labelled as 4 ranks on one card;
 20. caches narrower than the query: dense and paged decode over every
     (q, cache) pair of {f32, bf16} x {f32, bf16, float8_e4m3fn} at
     qwen1.5-0.5b's, qwen1.5-110b's (G = 8) and gemma3-1b's (hd 256)
     decode shapes, each against its plain version, paged == the dense
     kernel on the gathered view bit for bit, each timed beside its bytes
     bound and its plain version; full-width qwen1.5-0.5b served through
     the engine with cache_dtype="bfloat16" under f32 params (phase 5's
     requests) and through one rank of build_prefill_step /
     build_decode_step at PipelinePlan(kv_dtype="fp8") (phase 19's prefill
     and 16 decode steps), each path's launches counted and one served
     decode call of each held against its plain version at a real tick;
     and launch/roofline.py's step_costs on an H100 (f32) beside phase
     18's train step, phase 5/6's decode tick and phase 19's steps, the
     gap recorded;
 21. bf16 training, the reference's default dtype: the flash backward
     kernel at bf16 at both training shapes (phase 18's, and the (128,
     128) template at 16 heads of 128), within one bf16 ulp of the f32
     kernel on the widened inputs rounded to bf16 and of its plain
     version, two calls' bits equal, timed beside its bound (bf16 tensor
     cores, and 3xTF32 as the products it runs), the f32 kernel on the
     same widened inputs, its plain version and SDPA's bf16 backward; the
     bf16 forward (flash_wgmma_kernel, against the plain version and its
     mirror) at the training call and at the (128, 128) template, each
     beside its bound and SDPA's bf16 forward, and at (128, 128) in turns
     with the span kernel it replaced (phase 3's copy of the source); one
     bf16 step
     of full-width qwen1.5-0.5b cut to 2 layers on the card against the
     same step on the CPU; through build_train_step's default dtype for 5
     steps each, full-width qwen1.5-0.5b at full depth and full-width
     deepseek-moe-16b cut to 4 of its 28 layers (every flash call at (128,
     128): 16 forward and 8 backward launches a step; its first flash
     call held against the plain version and the mirror), each loss
     falling, flash and flash-backward launches a step exactly counted,
     ms per step, device busy share and peak memory;
 22. serving at the reference's default bf16 params: full-width
     qwen1.5-0.5b with bf16 params and a bf16 cache on phase 5's 16
     requests (run(), dense and paged-kernel runs refactored [0,12] ->
     [0,6,12,18] -> [0,12]; streams bit-identical, paged == dense; flash
     24 per prefill, on flash_wgmma_kernel at hd 64, and decode or paged
     decode 24 per tick with a bf16 query over the bf16 cache, exactly
     counted; one served call of each kernel at a real tick held within
     one bf16 ulp or 5e-3 of its plain version, flash also of its mirror;
     ms/tick, tok/s, three profiled ticks, peak memory); deepseek-v2-236b
     cut to 3 layers at bf16 (about 26 GB; bf16 latent cache; run() and a
     run refactored [0,1] -> [0,1,2] -> [0,1], streams bit-identical;
     flash at (192, 128) 3 per prefill, no decode kernel; its first
     served flash call held against plain and mirror; three profiled
     ticks, peak memory and headroom; the bf16 decode-vs-forward logit
     distance of requests 8 and 13, recorded); one rank of
     build_prefill_step / build_decode_step for qwen1.5-0.5b at their
     default bf16 (phase 19's B 8 x 512 prefill and 16 decode steps,
     launches exactly counted, one served call of each kernel held); and
     phase 4 at bf16 for qwen1.5-0.5b, deepseek-v2 with its MLA heads
     widened to the served pair and gemma3-1b with 256-wide heads (the
     card's logits within 2x the CPU's own bf16-to-f32 distance, from the
     same bf16-rounded weights; the argmax agreement recorded); and
     full-width gemma3-1b at bf16 params and bf16 caches on phase 11's
     requests (run() and a run refactored [0,13] -> [0,7,14,20] ->
     [0,13], streams bit-identical; flash at (256, 256), on
     flash_wgspan_kernel, 26 per prefill and the hd-256 decode kernel
     over the bf16 caches 26 per tick, exactly counted; a local and a
     global layer's served flash call and one decode call held against
     their plain versions, flash also against the mirror; the bf16
     decode-vs-forward distance of requests 8 and 13, recorded; ms/tick,
     tok/s, three profiled ticks, peak memory).
The line before the last holds the per-kernel results as JSON, and the last
line is {"ok": true, "device": {...}}.  Without CUDA, or without the rest of
the repository, it exits non-zero and prints no result.
"""
import os

# deterministic cuBLAS: bit-identical streams across runs need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import collections  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()

# H100 SXM data sheet peaks (NVIDIA), dense, at the 700 W limit
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12,
            # f32 products on the tensor cores as 3xTF32: three TF32
            # products (495 TFLOP/s) for each f32 one
            "tf32x3": 495e12 / 3}
# bf16: 2.5x the largest error these shapes showed on an H100 (2.0e-3).
# Beyond it a bf16 output may only be the plain output's neighbour: a flip
# of the final rounding, which two summation orders cannot rule out where
# the exact value lies next to a rounding midpoint; at |out| >= 1 one bf16
# ulp (>= 7.8e-3) exceeds 5e-3.  Such flips are counted and reported.
TOL = {"float32": 3e-5, "bfloat16": 5e-3}
# wkv6, times the plain version's mean |y|: f32 as tests/test_kernels.py's
# wkv tolerance; bf16 one ulp (2^-7) of the largest |y|, which stays under
# about 6 mean |y| here (kernel and plain round y to bf16 apart)
WKV_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# H100 SXM maximum SM clock (data sheet) and the latency of a dependent f32
# fused multiply-add, in cycles: the floor S dependent WKV steps set
SM_CLOCK_HZ = 1.98e9
FMA_CYCLES = 4
# decode == forward is required where the forward's top-2 logit margin
# exceeds this (the two paths sum in different orders)
MARGIN_TOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    """Print a line; a phase's heading ("== N. ...") with the seconds
    since the script started, so that each phase's share of the run shows."""
    if a and str(a[0]).startswith("== "):
        a = (f"{a[0]} [{time.perf_counter() - T_START:.1f} s]",) + a[1:]
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of one call, by CUDA events around ``iters`` calls.
    A device-side sleep ahead of the first event lets the host queue every
    call first, so a kernel shorter than its wrapper's host time is timed on
    the device, not at the host's enqueue rate (a call that alone queues
    more than the sleep still reads high)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(0.05 * SM_CLOCK_HZ))        # about 50 ms
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(bytes_moved, ops, dtype):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks(torch, span_lib):
    """Phase 3; ``span_lib``: the earlier design's library (EARLIER_EDIT),
    the span kernel that flash_wgmma_kernel at bf16 (192, 128) is timed
    beside."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import (
        CHUNK, WIDE_HD, decode_attention, decode_attention_plain,
        gather_pages, paged_decode_attention, paged_decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        attention_mask, flash_attention, flash_attention_plain)
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def rnd(shape, dt):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev, dts[dt])

    results = {}

    def compare(name, dt, out, ref, case):
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        typical = float(ref.float().abs().mean())
        finite = bool(torch.isfinite(out.float()).all())
        over = diff > TOL[dt]
        flips = 0
        if dt == "bfloat16":     # neighbours: bit patterns one apart
            near = (out.view(torch.int16).int()
                    - ref.view(torch.int16).int()).abs() == 1
            flips = int((over & near).sum())
            over = over & ~near
        r = results.setdefault(name, {"max_abs_err": 0.0,
                                      "max_abs_err_bf16": 0.0,
                                      "bf16_rounding_flips": 0})
        r["bf16_rounding_flips"] += flips
        key = "max_abs_err" if dt == "float32" else "max_abs_err_bf16"
        if err >= r[key]:
            r[key] = err
            r["mean_abs_out" if dt == "float32"
              else "mean_abs_out_bf16"] = typical
        log(f"  {name:24s} {dt:8s} {case:34s} max|err| {err:.3e} "
            f"(tol {TOL[dt]:g}), mean|out| {typical:.3e}"
            + (f", {flips} of {out.numel()} one-ulp rounding flips over "
               "the tolerance" if flips else ""))
        check(finite, f"{name} {dt} {case}: non-finite output")
        check(not bool(over.any()), f"{name} {dt} {case}: error {err} > "
              f"{TOL[dt]}" + (" beyond a one-ulp rounding flip"
                              if dt == "bfloat16" else ""))
        return err

    # --- dense and paged decode: B=8, H=Kh=16, hd=64, Smax=1024 ---------
    B, H, Kh, hd, Smax, bs = 8, 16, 16, 64, 1024, 16
    M = Smax // bs
    n_blocks = 1 + B * M
    ragged = np.array([1024, 1, 17, 512, 600, 333, 1000, 64], np.int32)
    # lengths straddling the split kernel's chunk boundaries
    edges = np.array([0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 1,
                      Smax, 600], np.int32)

    def decode_case(dt, lens, label, geo=None):
        """Dense and paged kernels against their plain versions, then the
        paged kernel, the gather path and the dense kernel on the same live
        rows: the same bits, and the same bits again on a second call.  On
        a tile core (hd < 256: the lane core at G <= 2, the mma core above)
        also against its mirror (decode_mma_plain), a second dense call and
        NaN in every dead row: the same bits.  ``geo``: (H, Kh, hd, Smax)
        other than qwen's."""
        H, Kh, hd, Smax = geo or (16, 16, 64, 1024)
        M = Smax // bs
        n_blocks = 1 + B * M
        q = rnd((B, H, hd), dt)
        kc, vc = rnd((B, Kh, Smax, hd), dt), rnd((B, Kh, Smax, hd), dt)
        cl = torch.from_numpy(lens).to(dev)
        compare("decode_attention", dt, decode_attention(q, kc, vc, cl),
                decode_attention_plain(q, kc, vc, cl), label)
        # pools: live blocks at shuffled ids, one dead block past the live
        # length per slot (as after admission), null (0) entries elsewhere
        kp = rnd((n_blocks, Kh, bs, hd), dt)
        vp = rnd((n_blocks, Kh, bs, hd), dt)
        perm = rng.permutation(np.arange(1, n_blocks))
        tables = np.zeros((B, M), np.int32)
        plens = np.minimum(lens, Smax - bs)
        i = 0
        for b in range(B):
            nb = -(-int(plens[b]) // bs) + 1
            tables[b, :nb] = perm[i:i + nb]
            i += nb
        bt = torch.from_numpy(tables).to(dev)
        pcl = torch.from_numpy(plens).to(dev)
        paged = paged_decode_attention(q, kp, vp, bt, pcl)
        compare("paged_decode_attention", dt, paged,
                paged_decode_attention_plain(q, kp, vp, bt, pcl),
                label + ", null + dead blocks")
        kg, vg = gather_pages(kp, bt), gather_pages(vp, bt)
        kd, vd = kc.clone(), vc.clone()
        for b, n in enumerate(plens.tolist()):
            kd[b, :, :n] = kg[b, :, :n]
            vd[b, :, :n] = vg[b, :, :n]
        same = {"gather path": decode_attention(q, kg, vg, pcl),
                "dense kernel": decode_attention(q, kd, vd, pcl),
                "paged kernel again": paged_decode_attention(q, kp, vp, bt,
                                                             pcl)}
        torch.cuda.synchronize()
        for what, out in same.items():
            check(torch.equal(out, paged), f"decode {dt} {label}: the {what} "
                  "differs from the paged kernel on equal live rows")
        log(f"  {'decode paths':24s} {dt:8s} {label:34s} paged kernel == "
            f"gather path == dense kernel == paged again, bit for bit")
        if hd < WIDE_HD:
            tile_holds(torch, q, kc, vc, cl, dt, label)
        return q, kc, vc, cl, kp, vp, bt, pcl, plens

    for dt in ("float32", "bfloat16"):
        decode_case(dt, edges, f"lengths at chunk edges (C={CHUNK})")
        q, kc, vc, cl, kp, vp, bt, pcl, plens = decode_case(
            dt, ragged, "ragged cache_len")
        if dt == "float32":
            live = int(ragged.sum())
            es = 4
            nbytes = (B * H * hd * 2 + live * Kh * 2 * hd) * es + B * 4
            ops = 2 * H * live * 2 * hd
            t_bound, by = bound(nbytes, ops, dt)
            mask = (torch.arange(Smax, device=dev)[None, :]
                    < cl[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            results["decode_attention"].update(
                ms=time_ms(torch, lambda: decode_attention(q, kc, vc, cl)),
                plain_ms=time_ms(torch, lambda: decode_attention_plain(
                    q, kc, vc, cl), iters=5),
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4, kc, vc, attn_mask=mask)),
                bound_ms=t_bound, bound_by=by,
                shape=f"B={B} H=Kh={H} hd={hd} Smax={Smax} f32, "
                      f"sum(cache_len)={live}",
                **tile_row(torch, q, kc, vc, cl, False))
            plive = int(plens.sum())
            pbytes = (B * H * hd * 2 + plive * Kh * 2 * hd) * es + B * 4 \
                + sum(-(-int(x) // bs) for x in plens) * 4
            t_bound, by = bound(pbytes, 2 * H * plive * 2 * hd, dt)
            results["paged_decode_attention"].update(
                ms=time_ms(torch, lambda: paged_decode_attention(
                    q, kp, vp, bt, pcl)),
                plain_ms=time_ms(torch, lambda: paged_decode_attention_plain(
                    q, kp, vp, bt, pcl), iters=5),
                library_ms=None, bound_ms=t_bound, bound_by=by,
                shape=f"B={B} H=Kh={H} hd={hd} bs={bs} n_blocks={n_blocks} "
                      f"f32, sum(cache_len)={plive}",
                **tile_row(torch, q, (kp, vp, bt), None, pcl, True))

    # --- flash prefill ----------------------------------------------------
    cases = [  # (B, Sq, Skv, H, Kh, window, q_offset, label)
        (1, 512, 512, 16, 16, 0, None, "Sq=Skv=512 end-aligned"),
        (1, 128, 640, 16, 16, 0, 256, "Sq=128 Skv=640 q_offset=256"),
        (1, 512, 512, 16, 16, 128, None, "Sq=Skv=512 window=128"),
        (1, 512, 512, 16, 8, 0, None, "GQA G=2 Sq=Skv=512"),
        (1, 64, 64, 16, 16, 0, None, "Sq=Skv=64 (small bucket)"),
        (1, 1024, 1024, 16, 16, 0, None, "Sq=Skv=1024 end-aligned"),
    ]
    for dt in ("float32", "bfloat16"):
        for (Bq, Sq, Skv, Hq, Khq, win, qo, label) in cases:
            q = rnd((Bq, Sq, Hq, hd), dt)
            k, v = rnd((Bq, Skv, Khq, hd), dt), rnd((Bq, Skv, Khq, hd), dt)
            kw = dict(causal=True, window=win, q_offset=qo)
            compare("flash_attention", dt, flash_attention(q, k, v, **kw),
                    flash_attention_plain(q, k, v, **kw), label)
            if dt == "float32" and label.startswith("Sq=Skv=512 end"):
                pairs = int(attention_mask(Sq, Skv, causal=True, window=0,
                                           q_offset=Skv - Sq,
                                           device="cpu").sum())
                nbytes = (2 * Bq * Sq * Hq * hd + 2 * Bq * Skv * Khq * hd) * 4
                ops = 2 * 2 * hd * Bq * Hq * pairs
                # f32 runs on the tensor cores as 3xTF32
                t_bound, by = bound(nbytes, ops, "tf32x3")
                log(f"  {'flash_attention bound':24s} bytes "
                    f"{nbytes / PEAK_BYTES * 1e3:.5f} ms, 3xTF32 "
                    f"{ops / PEAK_OPS['tf32x3'] * 1e3:.5f} ms, f32 CUDA "
                    f"cores {ops / PEAK_OPS['float32'] * 1e3:.5f} ms "
                    f"({ops} ops, {pairs} unmasked pairs per head)")
                qt, kt, vt = (x.transpose(1, 2).contiguous()
                              for x in (q, k, v))
                results["flash_attention"].update(
                    ms=time_ms(torch, lambda: flash_attention(q, k, v, **kw)),
                    plain_ms=time_ms(torch, lambda: flash_attention_plain(
                        q, k, v, **kw), iters=5),
                    library_ms=time_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True)),
                    bound_ms=t_bound, bound_by=by,
                    shape=f"B=1 Sq=Skv=512 H=Kh=16 hd=64 causal f32")
            if dt == "float32" and label.startswith("Sq=Skv=1024"):
                qt, kt, vt = (x.transpose(1, 2).contiguous()
                              for x in (q, k, v))
                ms = time_ms(torch, lambda: flash_attention(q, k, v, **kw))
                lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
                log(f"  {'flash_attention':24s} {ms:.4f} ms  library "
                    f"{lib:.4f} ms  [B=1 Sq=Skv=1024 H=Kh=16 hd=64 causal "
                    f"f32]")
    wgmma_checks(torch, rnd, results)
    flash_composition(torch, rnd)
    # the chunked-prefill shape: a 128-row chunk at the end of a 512-token
    # bucket, K/V read back from the cache (phase 9's chunk 128)
    q = rnd((1, 128, 16, hd), "float32")
    k, v = rnd((1, 512, 16, hd), "float32"), rnd((1, 512, 16, hd), "float32")
    kw = dict(causal=True, q_offset=384)
    mask = attention_mask(128, 512, causal=True, window=0, q_offset=384,
                          device=dev)
    pairs = int(mask.sum())
    t_bound, by = bound((2 * 128 * 16 * hd + 2 * 512 * 16 * hd) * 4,
                        2 * 2 * hd * 16 * pairs, "tf32x3")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    results["flash_attention"]["chunk"] = dict(
        ms=time_ms(torch, lambda: flash_attention(q, k, v, **kw)),
        plain_ms=time_ms(torch, lambda: flash_attention_plain(q, k, v, **kw),
                         iters=5),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
        bound_ms=t_bound, bound_by=by,
        shape="B=1 Sq=128 Skv=512 q_offset=384 H=Kh=16 hd=64 causal f32")
    c = results["flash_attention"]["chunk"]
    log(f"  {'flash_attention chunk':24s} {c['ms']:.4f} ms  plain "
        f"{c['plain_ms']:.4f} ms  library {c['library_ms']:.4f} ms  bound "
        f"{c['bound_ms']:.4f} ms ({by})  [{c['shape']}]")
    head_shape_checks(torch, rnd, compare, decode_case, results, span_lib)
    wkv_checks(torch, rnd, results)
    for name, r in results.items():
        lib = r["library_ms"]
        log(f"  {name:24s} {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"library {('%.4f ms' % lib) if lib is not None else 'n/a'}  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  [{r['shape']}]")
    build.reset_launches()       # comparison launches do not count
    return results


def wgmma_beside_span(torch, span_lib, q, k, v, kw, label):
    """A bf16 kernel on wgmma (flash_wgmma_kernel at (192, 128),
    flash_wgspan_kernel at (256, 256)) on a causal end-aligned call, with
    its window: within one bf16 ulp or TOL["bfloat16"] of the plain
    version and of flash_wgmma_plain, its CTAs an SM, and its time in turns
    with the span kernel it replaced (the earlier design's library:
    kernel, span, span, kernel)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    kernel = lambda: FA.flash_attention(q, k, v, **kw)  # noqa: E731
    with torch.no_grad():
        got = kernel()
        n_p, e_p = _over_ulp(torch, got, FA.flash_attention_plain(q, k, v,
                                                                  **kw))
        n_m, e_m = _over_ulp(torch, got, FA.flash_wgmma_plain(q, k, v, **kw))
        span = earlier_span_forward(torch, span_lib, q, k, v,
                                    kw.get("window", 0))
        n_e, e_e = _over_ulp(torch, span(), FA.flash_attention_plain(
            q, k, v, **kw))
        check(n_p == 0 and n_m == 0, f"flash_wgmma_kernel {label}: {n_p} "
              f"elements beyond one bf16 ulp or {TOL['bfloat16']} of the "
              f"plain version, {n_m} of the mirror")
        check(n_e == 0, f"the span kernel {label}: {n_e} elements beyond "
              "one bf16 ulp of the plain version")
        check(torch.equal(got, kernel()),
              f"flash_wgmma_kernel {label}: two calls gave other bits")
        turns = [time_ms(torch, f) for f in (kernel, span, span, kernel)]
    hd, hdv = q.shape[-1], v.shape[-1]
    return dict(ms=min(turns[0], turns[3]), earlier_ms=min(turns[1],
                                                           turns[2]),
                max_abs_err_vs_plain=e_p,
                ms_turns=turns, max_abs_err_vs_mirror=e_m,
                earlier_max_abs_err=e_e,
                earlier=f"flash_span_kernel<bf16, {hd}, {hdv}> and its "
                        "combine, the design this pair ran before (kernel, "
                        "span, span, kernel in turns)",
                occupancy=build.library(
                    "flash_attention").flash_wgmma_occupancy(hd, hdv))


def head_shape_checks(torch, rnd, compare, decode_case, results, span_lib):
    """gemma3-1b's attention shapes (hd 256, 4 query heads on one kv head),
    MLA prefill's (hd 192, hdv 128), and deepseek-moe-16b's (hd 128, 16
    heads) and jamba-v0.1-52b's (hd 128, 32 heads on 8 kv heads), f32 and
    bf16, against the plain versions: flash at a 571-token prompt, local
    (window 512) and global, at (192, 128) and at hd 128 (Sq = Skv = 512,
    causal); dense and paged decode on a 512-row ring and 1024-row caches;
    paged == gather == dense bit for bit.  Each f32 case is timed beside its
    bound and one SDPA call, and each flash case at bf16 too (its own row,
    "bf16": the span kernel at hd 256, or flash_wgmma_kernel, with its
    registers and spills; at (192, 128) also held against its mirror, with
    its CTAs an SM and its time in turns with the span kernel it replaced,
    ``span_lib``); each span or cluster kernel also reports its
    registers, spills and device time by kernel, and logs its planned
    launch geometry."""
    from repro_torch.kernels.decode_attention import (
        WIDE_HD, _group_slots, decode_attention, decode_attention_plain,
        paged_decode_attention, paged_decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        attention_mask, flash_attention, flash_attention_plain, is_span)
    import torch.nn.functional as F

    dev = torch.device("cuda")

    def sdpa_ms(label, fn):
        try:
            return time_ms(torch, fn)
        except RuntimeError as e:          # a yardstick only: none there
            log(f"  {label}: no SDPA call for this shape ({e})"[:200])
            return None

    flash = [  # (key, B, Sq, Skv, q_offset, H, Kh, hd, hdv, window, causal)
        ("hd256_window", 1, 571, 571, 0, 4, 1, 256, 256, 512, True),
        ("hd256_causal", 1, 571, 571, 0, 4, 1, 256, 256, 0, True),
        ("hd192_128", 1, 512, 512, 0, 16, 16, 192, 128, 0, True),
        # deepseek-v2-236b's MLA prefill (phase 17): 128 heads, a served
        # 512 bucket and the 1024 bucket
        ("hd192_128_h128", 1, 512, 512, 0, 128, 128, 192, 128, 0, True),
        ("hd192_128_h128_1024", 1, 1024, 1024, 0, 128, 128, 192, 128, 0,
         True),
        ("hd128", 1, 512, 512, 0, 16, 16, 128, 128, 0, True),
        ("hd128_gqa", 1, 512, 512, 0, 32, 8, 128, 128, 0, True),
        # deepseek-moe-16b's chunk-128 step at the end of a 512-token
        # bucket (phase 12's chunked run), and its largest bucket
        ("hd128_chunk", 1, 128, 512, 384, 16, 16, 128, 128, 0, True),
        ("hd128_1024", 1, 1024, 1024, 0, 16, 16, 128, 128, 0, True),
        # llama-3.2-vision-11b's cross prefill over 1601 memory keys, non-
        # causal (phase 14): a 600-token prompt and the 1024 bucket
        ("hd128_cross_600", 1, 600, 1601, 0, 32, 8, 128, 128, 0, False),
        ("hd128_cross_1024", 1, 1024, 1601, 0, 32, 8, 128, 128, 0, False),
        # whisper-tiny's encoder over 1500 frames, one and two at a time,
        # and its decoder's cross prefill at the 1024 bucket (phase 15)
        ("hd64_encoder", 1, 1500, 1500, 0, 6, 6, 64, 64, 0, False),
        ("hd64_encoder_b2", 2, 1500, 1500, 0, 6, 6, 64, 64, 0, False),
        ("hd64_cross_1024", 1, 1024, 1500, 0, 6, 6, 64, 64, 0, False),
    ]
    # vision's cross prefill at lengths off the 64-row query tile (each row
    # reads all 13 spans); then a 600-token prompt padded to the 1024
    # bucket: its real rows equal the unpadded call's bit for bit
    for dt in ("float32", "bfloat16"):
        for Sq in (1, 24, 63, 64, 65):
            q = rnd((1, Sq, 32, 128), dt)
            k, v = rnd((1, 1601, 8, 128), dt), rnd((1, 1601, 8, 128), dt)
            kw = dict(causal=False, q_offset=0)
            compare("flash_attention", dt, flash_attention(q, k, v, **kw),
                    flash_attention_plain(q, k, v, **kw),
                    f"cross Sq={Sq} Skv=1601 H=32 Kh=8 hd=128")
        q = rnd((1, 1024, 32, 128), dt)
        k, v = rnd((1, 1601, 8, 128), dt), rnd((1, 1601, 8, 128), dt)
        padded = flash_attention(q, k, v, causal=False, q_offset=0)
        real = flash_attention(q[:, :600].contiguous(), k, v, causal=False)
        torch.cuda.synchronize()
        check(torch.equal(padded[:, :600], real), f"flash {dt}: a padded "
              "bucket's real rows differ from the unpadded call")
        log(f"  {'flash cross bucket':24s} {dt:8s} {'Sq 600 in 1024':34s} "
            "real rows bit-identical to the unpadded call")
    for key, B, Sq, Skv, qo, H, Kh, hd, hdv, win, causal in flash:
        shape = (f"B={B} Sq={Sq} Skv={Skv} q_offset={qo} H={H} Kh={Kh} "
                 f"hd={hd} hdv={hdv} "
                 + ((f"window={win}" if win else "causal") if causal
                    else "non-causal"))
        for dt in ("float32", "bfloat16"):
            q = rnd((B, Sq, H, hd), dt)
            k, v = rnd((B, Skv, Kh, hd), dt), rnd((B, Skv, Kh, hdv), dt)
            kw = dict(causal=causal, window=win, q_offset=qo)
            err = compare("flash_attention", dt,
                          flash_attention(q, k, v, **kw),
                          flash_attention_plain(q, k, v, **kw), shape)
            mask = attention_mask(Sq, Skv, causal=causal, window=win,
                                  q_offset=qo, device=dev)
            pairs = B * int(mask.sum())
            # q read and out written, k and v read, once each; S and P.V,
            # one product each (3xTF32 in f32)
            nbytes = B * (Sq * H + Skv * Kh) * (hd + hdv) * q.element_size()
            t_bound, by = bound(nbytes, 2 * H * pairs * (hd + hdv),
                                "tf32x3" if dt == "float32" else dt)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)) \
                if win or qo else \
                (lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True))
            r = dict(ms=time_ms(torch, lambda: flash_attention(q, k, v, **kw)),
                     plain_ms=time_ms(torch, lambda: flash_attention_plain(
                         q, k, v, **kw), iters=5),
                     library_ms=sdpa_ms(shape, lib), bound_ms=t_bound,
                     bound_by=by, max_abs_err=err, shape=shape + " f32")
            if dt != "float32":
                # the bf16 call's own row: flash_wgspan_kernel (the span
                # plan on wgmma) at (256, 256), else flash_wgmma_kernel
                kname = ("flash_wgspan_kernel" if is_span(
                    hd, hdv, torch.bfloat16) else "flash_wgmma_kernel")
                r.update(shape=shape + " bf16", kernel=kname,
                         ptxas=ptxas("flash_attention",
                                     f"{kname}ILi{hd}ELi{hdv}E"))
                if (hd, hdv) in ((192, 128), (256, 256)) and causal \
                        and qo == 0 and B == 1 and Sq == Skv:
                    r.update(wgmma_beside_span(torch, span_lib, q, k, v, kw,
                                               shape))
                    check(not r["ptxas"].get("spill_stores")
                          and not r["ptxas"].get("spill_loads")
                          and r["occupancy"] >= (1 if hd == 256 else 2),
                          f"{kname} ({hd}, {hdv}): spills {r['ptxas']} or "
                          f"{r['occupancy']} CTAs an SM")
                if hd == 256:
                    r.update(split_share(torch, "flash_combine_kernel",
                                         lambda: flash_attention(q, k, v,
                                                                 **kw)))
                results["flash_attention"][key]["bf16"] = r
                log(f"  {'flash_attention ' + key:24s} {r['ms']:.4f} ms  "
                    f"plain {r['plain_ms']:.4f} ms  SDPA "
                    f"{r['library_ms']} ms  bound {t_bound:.4f} ms ({by})  "
                    f"{r['kernel']} {r['ptxas']}"
                    + (f"  earlier design (the span kernel) "
                       f"{r['earlier_ms']:.4f} ms, turns "
                       f"{[round(t, 4) for t in r['ms_turns']]}, vs mirror "
                       f"{r['max_abs_err_vs_mirror']:.3e}, "
                       f"{r['occupancy']} CTAs an SM"
                       if "earlier_ms" in r else "")
                    + f"  [{r['shape']}]")
                continue
            results["flash_attention"][key] = r
            log(f"  {'flash_attention ' + key:24s} {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library {r['library_ms']} ms  "
                f"bound {t_bound:.4f} ms ({by})  [{r['shape']}]")
            if hd >= 128:
                log(f"  {'  planned launch':24s} " + json.dumps(
                    flash_geometry(torch, hd, hdv, Sq, Skv, qo, B * H, win,
                                   causal)))
                r.update(ptxas("flash_attention",
                               f"flash_span_kernelIfLi{hd}ELi{hdv}E"))
                r.update(split_share(torch, "flash_combine_kernel",
                                     lambda: flash_attention(q, k, v, **kw)))
                log(f"  {'  measured':24s} "
                    + json.dumps({x: r[x] for x in WIDE_KEYS if x in r}))
    # gemma3 decode: one kv head, G = 4; a local layer's 512-row ring and a
    # global layer's 1024 rows; lengths at the split kernel's chunk edges.
    # Then deepseek-moe-16b's and jamba-v0.1-52b's 1024-row caches at hd 128
    B = 8
    ragged = [1024, 1, 17, 512, 600, 333, 1000, 64]
    decode = [  # (key, H, Kh, hd, Smax, cache_len)
        ("hd256_ring", 4, 1, 256, 512, [1, 127, 128, 129, 512, 255, 384,
                                        511]),
        ("hd256_global", 4, 1, 256, 1024, ragged),
        ("hd128_mha", 16, 16, 128, 1024, ragged),
        ("hd128_gqa", 32, 8, 128, 1024, ragged),
        # qwen1.5-110b's 64 heads on 8 (G = 8) at the chunk edges (phase 16)
        ("hd128_g8", 64, 8, 128, 1024, [0, 1, 127, 128, 129, 257, 1024,
                                        600]),
    ]
    # cross decode reads every memory row: llama-3.2-vision-11b's 1601
    # (phase 14) and whisper-tiny's 1500 encoder frames (phase 15); cross
    # caches do not page
    cross = [("hd128_cross", 32, 8, 128, 1601), ("hd64_cross", 6, 6, 64, 1500)]
    for key, H, Kh, hd, M in cross:
        label = f"cross hd={hd} H={H} Kh={Kh} cache_len={M}"
        for dt in ("float32", "bfloat16"):
            q = rnd((B, H, hd), dt)
            kc, vc = rnd((B, Kh, M, hd), dt), rnd((B, Kh, M, hd), dt)
            out = decode_attention(q, kc, vc, M)
            err = compare("decode_attention", dt, out,
                          decode_attention_plain(q, kc, vc, M), label)
            torch.cuda.synchronize()
            check(torch.equal(decode_attention(q, kc, vc, M), out),
                  f"decode {dt} {label}: a second call differs")
            if hd < WIDE_HD:
                tile_holds(torch, q, kc, vc, torch.full(
                    (B,), M, dtype=torch.int32, device=dev), dt, label)
            if dt != "float32":
                continue
            nbytes = (B * H * hd * 2 + B * M * Kh * 2 * hd) * 4
            t_bound, by = bound(nbytes, 2 * H * B * M * 2 * hd, dt)
            q4 = q[:, :, None, :]
            shape = f"B={B} H={H} Kh={Kh} hd={hd} cache_len=Smax={M} f32"
            r = dict(ms=time_ms(torch, lambda: decode_attention(q, kc, vc,
                                                                M)),
                     plain_ms=time_ms(torch, lambda: decode_attention_plain(
                         q, kc, vc, M), iters=5),
                     library_ms=sdpa_ms(shape, lambda: (
                         F.scaled_dot_product_attention(
                             q4, kc, vc, enable_gqa=True))),
                     bound_ms=t_bound, bound_by=by, max_abs_err=err,
                     shape=shape)
            results["decode_attention"][key] = r
            if hd < WIDE_HD:
                r.update(tile_row(torch, q, kc, vc, torch.full(
                    (B,), M, dtype=torch.int32, device=dev), False))
            log(f"  {'decode_attention ' + key:24s} {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library {r['library_ms']} ms  "
                f"bound {t_bound:.4f} ms ({by})  [{shape}]"
                + (f"  {r['kernel']} {r['ptxas']}, vs mirror "
                   f"{r['max_abs_err_vs_mirror']:.3e}" if "kernel" in r
                   else ""))
    for key, H, Kh, hd, Smax, lens in decode:
        lens = np.array(lens, np.int32)
        label = f"hd={hd} H={H} Kh={Kh} Smax={Smax}"
        for dt in ("float32", "bfloat16"):
            q, kc, vc, cl, kp, vp, bt, pcl, plens = decode_case(
                dt, lens, label, (H, Kh, hd, Smax))
            if dt != "float32":
                continue
            err = float((decode_attention(q, kc, vc, cl)
                         - decode_attention_plain(q, kc, vc, cl)).abs().max())
            live = int(lens.sum())
            nbytes = (B * H * hd * 2 + live * Kh * 2 * hd) * 4 + B * 4
            t_bound, by = bound(nbytes, 2 * H * live * 2 * hd, dt)
            mask = (torch.arange(Smax, device=dev)[None, :]
                    < cl[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            shape = (f"B={B} H={H} Kh={Kh} hd={hd} Smax={Smax} f32, "
                     f"sum(cache_len)={live}")
            r = dict(ms=time_ms(torch, lambda: decode_attention(q, kc, vc,
                                                                cl)),
                     plain_ms=time_ms(torch, lambda: decode_attention_plain(
                         q, kc, vc, cl), iters=5),
                     library_ms=sdpa_ms(shape, lambda: (
                         F.scaled_dot_product_attention(
                             q4, kc, vc, attn_mask=mask, enable_gqa=True))),
                     bound_ms=t_bound, bound_by=by, max_abs_err=err,
                     shape=shape)
            results["decode_attention"][key] = r
            if hd < WIDE_HD:
                r.update(tile_row(torch, q, kc, vc, cl, False))
            log(f"  {'decode_attention ' + key:24s} {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library {r['library_ms']} ms  "
                f"bound {t_bound:.4f} ms ({by})  [{shape}]"
                + (f"  {r['kernel']} {r['ptxas']}, vs mirror "
                   f"{r['max_abs_err_vs_mirror']:.3e}" if "kernel" in r
                   else ""))
            if hd == 256:
                log(f"  {'  planned launch':24s} " + json.dumps(
                    decode_geometry(torch, lens, Smax, B, H, Kh)))
                r.update(ptxas("decode_attention",
                               "decode_cluster_kernelIfLi"
                               f"{_group_slots(H // Kh)}ELb0E"))
                r.update(split_share(torch, "decode_combine",
                                     lambda: decode_attention(q, kc, vc, cl)))
                log(f"  {'  measured':24s} "
                    + json.dumps({x: r[x] for x in WIDE_KEYS if x in r}))
            # the paged kernel shares the core: off gemma3's path (windowed
            # configs do not page), timed at each shape for its row
            plive = int(plens.sum())
            pbytes = (B * H * hd * 2 + plive * Kh * 2 * hd) * 4 + B * 4 \
                + sum(-(-int(x) // 16) for x in plens) * 4
            t_bound, by = bound(pbytes, 2 * H * plive * 2 * hd, dt)
            err = float((paged_decode_attention(q, kp, vp, bt, pcl)
                         - paged_decode_attention_plain(
                             q, kp, vp, bt, pcl)).abs().max())
            pshape = (f"B={B} H={H} Kh={Kh} hd={hd} bs=16, "
                      f"{bt.shape[1]} blocks a slot, f32, "
                      f"sum(cache_len)={plive}")
            r = dict(ms=time_ms(torch, lambda: paged_decode_attention(
                         q, kp, vp, bt, pcl)),
                     plain_ms=time_ms(torch, lambda: (
                         paged_decode_attention_plain(q, kp, vp, bt, pcl)),
                         iters=5),
                     library_ms=None, bound_ms=t_bound, bound_by=by,
                     max_abs_err=err, shape=pshape)
            results["paged_decode_attention"][key] = r
            if hd < WIDE_HD:
                r.update(tile_row(torch, q, (kp, vp, bt), None, pcl, True))
            log(f"  {'paged_decode ' + key:24s} {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  bound {t_bound:.4f} ms ({by})  "
                f"[{pshape}]" + (f"  {r['kernel']} {r['ptxas']}, vs mirror "
                                 f"{r['max_abs_err_vs_mirror']:.3e}"
                                 if "kernel" in r else ""))


# what phase 3 measures beside each span or cluster kernel's time, and
# puts in the kernels line (the planned geometry is logged, not put there)
WIDE_KEYS = ("registers", "spill_stores", "spill_loads", "kernels_us",
             "combine_share")


def ptxas(lib, pattern):
    """Registers and spill bytes of the kernel whose mangled name holds
    ``pattern``, from the build's -Xptxas -v log."""
    from repro_torch.kernels import build
    for fn, r in build.ptxas_report(lib).items():
        if pattern in fn:
            return {k: r.get(k) for k in ("registers", "spill_stores",
                                          "spill_loads")}
    return {"registers": "not in the build log"}


def flash_geometry(torch, hd, hdv, Sq, Skv, q_offset, H, window,
                   causal=True):
    """The span kernel's planned launch at (hd, hdv) over H heads (B * H
    for a batch), f32, from the wrapper's plan (computed, not measured):
    its CTAs (one per item), the rows it finishes itself (one span), the
    rows the combine merges, and its dynamic shared memory."""
    from repro_torch.kernels import flash_attention as fk
    geo = fk._geometry(hd, hdv, torch.float32)
    _, rows, ctas = fk.span_plan(Sq, Skv, causal=causal, window=window,
                                 q_offset=q_offset)
    return dict(ctas=len(ctas) * H,
                rows_direct=sum(len(r) == 1 for r in rows) * H,
                rows_merged=sum(len(r) > 1 for r in rows) * H,
                dynamic_smem=geo.smem, span=geo.span)


def decode_geometry(torch, lens, Smax, B, H, Kh):
    """The hd-256 decode kernel's planned launch, f32, dense, from the
    wrapper's plan (computed, not measured): CTAs launched and in live
    clusters, cluster size, dynamic shared memory."""
    from repro_torch.kernels import decode_attention as dk
    geo = dk._geometry(256, torch.float32, H // Kh)
    plan = dk.cluster_plan(torch.as_tensor(lens), Smax)
    return dict(ctas=geo.cluster * dk.n_chunks(Smax) * B * Kh,
                live_ctas=geo.cluster * sum(len(c) for c in plan) * Kh,
                loading_ctas=sum(len(sl) for c in plan for sl in c) * Kh,
                cluster=geo.cluster, dynamic_smem=geo.smem)


def tile_holds(torch, q, kc, vc, cl, dt, label):
    """A tile decode core (hd < 256: the lane core at G <= 2, the mma core
    above) on a dense call: within the tolerance of its mirror
    (decode_mma_plain, its order of sums), the same bits again on a second
    call, and the same bits with NaN in every row at or past cache_len."""
    from repro_torch.kernels.decode_attention import (core, decode_attention,
                                                      decode_mma_plain)
    out = decode_attention(q, kc, vc, cl)
    try:
        err = _pair_hold(torch, out, decode_mma_plain(q, kc, vc, cl), dt)
    except SmokeFailure as e:
        raise SmokeFailure(f"decode {dt} {label} vs its mirror: {e}") \
            from None
    kn, vn = kc.clone(), vc.clone()
    Smax = kc.shape[2]
    for b, n in enumerate(cl.tolist()):
        kn[b, :, min(n, Smax):] = float("nan")
        vn[b, :, min(n, Smax):] = float("nan")
    pad = (0, 0, 0, 16)                 # 16 more rows past the cache, NaN
    kn = torch.nn.functional.pad(kn.float(), pad, value=float("nan")).to(
        kc.dtype)
    vn = torch.nn.functional.pad(vn.float(), pad, value=float("nan")).to(
        vc.dtype)
    nan_dead = decode_attention(q, kn, vn, cl)
    again = decode_attention(q, kc, vc, cl)
    torch.cuda.synchronize()
    check(torch.equal(nan_dead, out), f"decode {dt} {label}: NaN in dead "
          "rows changed the output")
    check(torch.equal(again, out), f"decode {dt} {label}: a second call "
          "differs")
    name = core(q.shape[-1], q.shape[1] // kc.shape[1])
    log(f"  {name:24s} {dt:8s} {label:34s} vs mirror {err:.3e}; a second "
        "call and NaN in every dead row: the same bits")
    return err


def tile_row(torch, q, kc, vc, cl, paged):
    """A phase-3 row on a tile core (the lane or the mma core): its kernel,
    registers and spills, and its largest error against the mirror (paged:
    ``kc`` holds the pools and tables, the mirror runs on the gathered
    view)."""
    from repro_torch.kernels.decode_attention import (
        core, decode_attention, decode_mma_plain, gather_pages,
        paged_decode_attention)
    if paged:
        kp, vp, bt = kc
        out = paged_decode_attention(q, kp, vp, bt, cl)
        kc, vc = gather_pages(kp, bt), gather_pages(vp, bt)
    else:
        out = decode_attention(q, kc, vc, cl)
    err = _pair_hold(torch, out, decode_mma_plain(q, kc, vc, cl),
                     str(q.dtype)[6:])
    return dict(kernel=core(q.shape[-1], q.shape[1] // kc.shape[1]),
                max_abs_err_vs_mirror=err, ptxas=decode_core_ptxas(
                    torch, q.shape[-1], q.shape[1] // kc.shape[1], kc.dtype,
                    paged))


def decode_core_ptxas(torch, hd, G, cdt, paged):
    """Registers and spills of the tile core's instantiation that a call
    at (hd, G) over a cache of ``cdt`` runs."""
    from repro_torch.kernels.decode_attention import core
    mangled = {torch.float32: "f", torch.bfloat16: "13__nv_bfloat16",
               torch.float8_e4m3fn: "13__nv_fp8_e4m3"}[cdt]
    name = core(hd, G)
    kg = f"ELi{G}" if name == "decode_lane_kernel" else ""
    return ptxas("decode_attention",
                 f"{name}I{mangled}Li{hd}{kg}ELb{int(paged)}E")


def split_share(torch, combine, fn, reps=20):
    """Device time of ``fn``'s kernels under the profiler (us per call) and
    the share of those whose name holds ``combine``; a combine folded into
    its split kernel has no launch of its own (share 0)."""
    rows, _ = kernel_profile(torch, fn, reps)
    us = {}
    for key, t, _ in rows:
        us[key[:60]] = us.get(key[:60], 0.0) + t / reps
    total = sum(us.values())
    comb = sum(t for key, t in us.items() if combine in key)
    return dict(kernels_us=us,
                combine_share=comb / total if total else "not measured")


def wgmma_checks(torch, rnd, results):
    """The bf16 flash kernels on wgmma at each pair: flash_wgmma_kernel at
    (16, 16), (32, 32), (64, 64), (128, 128) and (192, 128), and
    flash_wgspan_kernel (the span plan's items) at (256, 256): causal,
    windowed, q_offset with Sq and Skv off the 64-row tile and GQA,
    non-causal, rows that see no key; 0 elements beyond one bf16 ulp or
    TOL["bfloat16"] of the plain version and of the designs' plain mirror
    (flash_wgmma_plain: the same 64-key tiles, online softmax and P as bf16
    hi + lo, at (256, 256) per span and merged in span order), a second
    call's bits equal, no spills in the build log, and the CTAs an SM holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) at least the launch
    bounds' minimum (3 up to hd 64, 2 at hd 128 and 192, 1 at 256)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, flash_wgmma_plain)
    cases = [  # (B, Sq, Skv, H, Kh, window, q_offset, causal, label)
        (1, 512, 512, 16, 16, 0, None, True, "Sq=Skv=512 causal"),
        (2, 130, 130, 4, 4, 40, None, True, "B=2 Sq=Skv=130 window=40"),
        (1, 70, 200, 8, 2, 0, 100, True, "Sq=70 Skv=200 q_offset=100 G=4"),
        (1, 17, 90, 4, 1, 0, 0, False, "Sq=17 Skv=90 non-causal G=4"),
        (1, 100, 40, 4, 4, 0, -70, True, "Sq=100 Skv=40 q_offset=-70"),
    ]
    out = {"kernel": "flash_wgmma_kernel", "cases": 0,
           "max_abs_err_vs_plain": 0.0, "max_abs_err_vs_mirror": 0.0,
           "tolerance": "one bf16 ulp or %g, of the plain version and of "
                        "flash_wgmma_plain" % TOL["bfloat16"]}
    for hd, hdv in ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128),
                    (256, 256)):
        kname = "flash_wgspan_kernel" if hd == 256 else "flash_wgmma_kernel"
        for B, Sq, Skv, H, Kh, win, qo, causal, label in cases:
            q = rnd((B, Sq, H, hd), "bfloat16")
            k, v = rnd((B, Skv, Kh, hd), "bfloat16"), rnd((B, Skv, Kh, hdv),
                                                          "bfloat16")
            kw = dict(causal=causal, window=win, q_offset=qo)
            got = flash_attention(q, k, v, **kw)
            again = flash_attention(q, k, v, **kw)
            plain = flash_attention_plain(q, k, v, **kw)
            mirror = flash_wgmma_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            case = f"({hd}, {hdv}) {label}"
            n_p, e_p = _over_ulp(torch, got, plain)
            n_m, e_m = _over_ulp(torch, got, mirror)
            log(f"  {kname:24s} bfloat16 {case:40s} max|err| "
                f"{e_p:.3e} vs plain ({int((got != plain).sum())} of "
                f"{got.numel()} differ), {e_m:.3e} vs the mirror "
                f"({int((got != mirror).sum())} differ); {n_p} and {n_m} "
                "beyond one bf16 ulp or %g" % TOL["bfloat16"])
            check(bool(torch.isfinite(got.float()).all()),
                  f"{kname} {case}: non-finite output")
            check(n_p == 0 and n_m == 0, f"{kname} {case}: "
                  f"{n_p} elements beyond one bf16 ulp or "
                  f"{TOL['bfloat16']} of the plain version, {n_m} of the "
                  "mirror")
            check(torch.equal(got, again),
                  f"{kname} {case}: two calls gave other bits")
            out["cases"] += 1
            out["max_abs_err_vs_plain"] = max(out["max_abs_err_vs_plain"],
                                              e_p)
            out["max_abs_err_vs_mirror"] = max(
                out["max_abs_err_vs_mirror"], e_m)
        r = ptxas("flash_attention", f"{kname}ILi{hd}ELi{hdv}E")
        out[f"ptxas_{hd}"] = r
        log(f"  {kname:24s} ({hd}, {hdv}) registers and spills: {r}")
        check(not r.get("spill_stores") and not r.get("spill_loads"),
              f"{kname} ({hd}, {hdv}) spills: {r}")
        occ = build.library("flash_attention").flash_wgmma_occupancy(hd,
                                                                     hdv)
        out[f"occupancy_{hd}"] = occ
        log(f"  {kname:24s} ({hd}, {hdv}): {occ} CTAs an SM")
        check(occ >= (3 if hd <= 64 else 1 if hd == 256 else 2),
              f"{kname} ({hd}, {hdv}): {occ} CTAs an SM")
    results["flash_attention"]["bf16_one_pass"] = out


def flash_composition(torch, rnd):
    """Chunked prefill's invariant on the kernel: a prompt's rows computed
    chunk by chunk (Sq = chunk, q_offset = c0, Skv = Sp, the bucket) equal
    one whole call (Sq = Skv = Sp) bit for bit: the extra fully masked
    tiles and the other warp's key half add only exact zeros and exact
    scales of 1 to a row, and the span kernel's spans are absolute.
    Chunks of 16 (like a prompt's last 16- or 32-token piece) sit off the
    kernel's 64-row tile."""
    from repro_torch.kernels.flash_attention import flash_attention
    # qwen1.5-0.5b's attention, deepseek-moe-16b's and jamba-v0.1-52b's
    # (hd 128), then gemma3-1b's (hd 256, a window)
    shapes = [(16, 16, 64, Sp, 0) for Sp in (128, 512)] + [
        (16, 16, 128, 512, 0), (32, 8, 128, 571, 0),
        (4, 1, 256, 512, 128), (4, 1, 256, 571, 512)]
    for dt in ("float32", "bfloat16"):
        for H, Kh, hd, Sp, win in shapes:
            q = rnd((1, Sp, H, hd), dt)
            k, v = rnd((1, Sp, Kh, hd), dt), rnd((1, Sp, Kh, hd), dt)
            kw = dict(causal=True, window=win)
            whole = flash_attention(q, k, v, q_offset=0, **kw)
            for chunk in (16, 64, 128):
                parts = [flash_attention(q[:, c0:c0 + chunk].contiguous(), k,
                                         v, q_offset=c0, **kw)
                         for c0 in range(0, Sp, chunk)]
                got = torch.cat(parts, 1)
                torch.cuda.synchronize()
                case = (f"hd={hd} Sp={Sp}" + (f" window={win}" if win else "")
                        + f" chunk={chunk}")
                check(torch.equal(got, whole),
                      f"flash {dt} {case}: chunked calls differ from one "
                      f"call (max |d| "
                      f"{float((got.float() - whole.float()).abs().max())})")
                log(f"  {'flash composition':24s} {dt:8s} {case:34s} "
                    f"bit-identical to one call")


def wkv_checks(torch, rnd, results):
    """wkv6 against wkv6_plain at the rwkv6-1.6b path's two shapes (prefill
    B=1 S=512, decode B=8 S=1; H=32, hd=64); chained calls against one whole
    call, bit for bit; the decode shape and prompts of 64, 512 and 600 tokens
    timed beside their bounds."""
    from repro_torch.kernels.rwkv6_wkv import _geometry, wkv6, wkv6_plain

    H, hd = 32, 64
    r_ = results.setdefault("wkv6", {"max_abs_err": 0.0,
                                     "max_abs_err_bf16": 0.0})

    def inputs(B, S, dt, state):
        r, k, v = (rnd((B, S, H, hd), dt) * 0.5 for _ in range(3))
        w = (torch.sigmoid(rnd((B, S, H, hd), "float32")) * 0.5
             + 0.45).to(r.dtype)
        u = rnd((H, hd), "float32") * 0.1
        st0 = rnd((B, H, hd, hd), "float32") if state else None
        return r, k, v, w, u, st0

    def compare(dt, case, out, ref):
        (y, st), (y_ref, st_ref) = out, ref
        torch.cuda.synchronize()
        mean_y = float(y_ref.float().abs().mean())
        mean_s = float(st_ref.abs().mean())
        err = float((y.float() - y_ref.float()).abs().max())
        err_s = float((st - st_ref).abs().max())
        key = "max_abs_err" if dt == "float32" else "max_abs_err_bf16"
        if err >= r_[key]:
            r_[key] = err
            r_["mean_abs_out" if dt == "float32"
               else "mean_abs_out_bf16"] = mean_y
        log(f"  {'wkv6':24s} {dt:8s} {case:34s} max|err| y {err:.3e} "
            f"(tol {WKV_TOL[dt]:g} x mean|y| {mean_y:.3e}), state "
            f"{err_s:.3e} (tol {WKV_TOL['float32']:g} x {mean_s:.3e})")
        check(bool(torch.isfinite(y.float()).all())
              and bool(torch.isfinite(st).all()),
              f"wkv6 {dt} {case}: non-finite output")
        check(err <= WKV_TOL[dt] * mean_y,
              f"wkv6 {dt} {case}: y error {err} > {WKV_TOL[dt]} x {mean_y}")
        check(err_s <= WKV_TOL["float32"] * mean_s,
              f"wkv6 {dt} {case}: state error {err_s}")

    for dt in ("float32", "bfloat16"):
        for B, S, state, label in ((1, 512, False, "prefill S=512, no state0"),
                                   (1, 512, True, "prefill S=512, state0"),
                                   (8, 1, True, "decode B=8, state0")):
            args = inputs(B, S, dt, state)
            ref = wkv6_plain(*args)        # before wkv6 overwrites state0
            compare(dt, label, wkv6(*args), ref)

    # exact composition: calls chained through the state they leave give
    # the bits of one whole call (a split inside a time tile, one at a
    # multiple of it, a prefill then single-step decode calls, and 8 single
    # steps against one 8-step call)
    tt = _geometry(hd, torch.float32, 512).tile

    def chained(args, cuts):
        r, k, v, w, u, st = args
        st, ys = st.clone(), []
        for a, b in zip([0] + cuts, cuts + [r.shape[1]]):
            y, st = wkv6(*(x[:, a:b].contiguous() for x in (r, k, v, w)), u,
                         st)
            ys.append(y)
        return torch.cat(ys, 1), st

    for dt in ("float32", "bfloat16"):
        args = inputs(1, 512, dt, True)
        short = tuple(x[:, :8].contiguous() for x in args[:4]) + args[4:]
        for whole_args, cuts, label in (
                (args, [200], "[0,200) + [200,512)"),
                (args, [8 * tt], f"[0,{8 * tt}) + [{8 * tt},512) (8 TT)"),
                (args, list(range(505, 512)), "[0,505) + 7 single steps"),
                (short, list(range(1, 8)), "8 single steps vs one call")):
            y, st = chained(whole_args, cuts)
            y_w, st_w = wkv6(*whole_args[:5], whole_args[5].clone())
            torch.cuda.synchronize()
            check(torch.equal(y, y_w) and torch.equal(st, st_w),
                  f"wkv6 {dt} {label}: chained calls differ from one call "
                  f"(max |dy| {float((y.float() - y_w.float()).abs().max())}"
                  f", max |dstate| {float((st - st_w).abs().max())})")
            log(f"  {'wkv6 composition':24s} {dt:8s} {label:34s} y and state "
                f"bit-identical to one call")

    def timing(B, S, plain=True, dt="float32"):
        """(ms, plain ms, bound ms, by, floor ms) of one call with a state0,
        as the serving path makes it (each timed call carries the state on
        from the last)."""
        args = inputs(B, S, dt, True)
        es = args[0].element_size()
        nbytes = (5 * B * S * H * hd) * es + (H * hd + 2 * B * H * hd * hd) * 4
        # 5 flops per state element and step: y += r * (S + u k v) (one
        # multiply-add with u k v shared by a row) and S = w S + k v; f32
        # arithmetic in both dtypes
        ops = 5 * B * H * hd * hd * S
        t_bound, by = bound(nbytes, ops, "float32")
        return (time_ms(torch, lambda: wkv6(*args)),
                time_ms(torch, lambda: wkv6_plain(*args), iters=3)
                if plain else None,
                t_bound, by, S * FMA_CYCLES / SM_CLOCK_HZ * 1e3)

    # the floor of S dependent steps is a data-sheet reckoning, not a
    # measurement: it goes to the log, not to the kernels line
    ms, plain, t_bound, by, floor = timing(8, 1)
    r_.update(ms=ms, plain_ms=plain, library_ms=None, bound_ms=t_bound,
              bound_by=by, shape=f"decode B=8 S=1 H={H} hd={hd} f32, state0")
    log(f"  {'wkv6 decode':24s} 1 dependent step {floor:.6f} ms "
        f"(S x {FMA_CYCLES} cycles at {SM_CLOCK_HZ / 1e9:g} GHz)")
    r_["prefill_lengths"] = []
    for S in (64, 512, 600):
        ms, plain, t_bound, by, floor = timing(1, S, plain=S == 512)
        p = dict(ms=ms, bound_ms=t_bound, bound_by=by,
                 shape=f"prefill B=1 S={S} H={H} hd={hd} f32, state0")
        if S == 512:
            r_["prefill"] = dict(p, plain_ms=plain)
        else:
            r_["prefill_lengths"].append(p)
        log(f"  {'wkv6 prefill':24s} {ms:.4f} ms  plain "
            f"{'%.4f ms' % plain if plain is not None else 'not timed'}  "
            f"library n/a  bound {t_bound:.4f} ms ({by}), {S} dependent "
            f"steps {floor:.4f} ms, measured "
            f"{ms / S * 1e-3 * SM_CLOCK_HZ:.0f} cycles per step  "
            f"[{p['shape']}]")
    # bf16 halves the bytes a step reads from shared memory and adds the
    # conversions to f32: beside f32, it shows which of the two holds a step
    ms, _, t_bound, by, _ = timing(1, 512, plain=False, dt="bfloat16")
    log(f"  {'wkv6 prefill':24s} {ms:.4f} ms  bound {t_bound:.4f} ms ({by}), "
        f"{ms / 512 * 1e-3 * SM_CLOCK_HZ:.0f} cycles per step  [prefill B=1 "
        f"S=512 H={H} hd={hd} bf16, state0]")


# ---------------------------------------------------------------------------
# phase 4: the port's logits on the card against its CPU path
# ---------------------------------------------------------------------------

def smoke_cfg(arch):
    """``arch``'s smoke config at head dims the kernels are built for."""
    from repro_torch.configs.base import get_arch, shrink
    cfg = get_arch(arch).smoke_config
    if cfg.resolved_head_dim < 16:
        # qwen1.5-110b's smoke config has head_dim 8, under the kernels'
        # smallest (16): the same heads at twice the width
        cfg = shrink(cfg, d_model=16 * cfg.n_heads)
    if cfg.mla is not None:
        # MLA's smoke heads (24, 16) are no pair the flash kernel is built
        # for: the real model's (nope, rope, v) = (128, 64, 128)
        cfg = shrink(cfg, mla=dataclasses.replace(
            cfg.mla, nope_head_dim=128, rope_head_dim=64, v_head_dim=128))
    return cfg


def small_model_check(torch, arch):
    from repro_torch.convert import tree_from_numpy, tree_to_numpy
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_model

    cfg = smoke_cfg(arch)
    cpu = init_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    set_gates(cpu, 1)
    gpu = tree_from_numpy(tree_to_numpy(cpu), "cuda")
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 40)))}
    if cfg.encoder_layers:                      # whisper: encoder frames
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, 48, cfg.d_model)).astype(np.float32))
    elif cfg.n_memory_tokens:                   # vision: image tokens
        batch["memory"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_memory_tokens, cfg.d_model)).astype(np.float32))
    lc, _, _ = M.forward(cfg, cpu, batch)
    lg, _, _ = M.forward(cfg, gpu, {k: v.cuda() for k, v in batch.items()})
    err = float((lg.cpu() - lc).abs().max())
    log(f"  {arch} smoke-size forward, card vs CPU: logits "
        f"{tuple(lg.shape)}, max|err| {err:.3e} (tol 1e-4)")
    check(bool(torch.isfinite(lg).all()), "non-finite logits on the card")
    check(err <= 1e-4, f"{arch}: card logits differ from the CPU path by "
          f"{err}")


# ---------------------------------------------------------------------------
# phase 5: serve full-width qwen1.5-0.5b
# ---------------------------------------------------------------------------

def make_requests(cfg, Request, memories=None):
    """The 16 requests every serving phase sends; ``memories``: one cross-
    attention memory per request (the same tensors in every run)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(16):
        r = Request(rid=i, arrival=0.0, prompt_len=int(rng.integers(24, 601)),
                    max_new_tokens=32)
        r.prompt_tokens = rng.integers(0, cfg.vocab_size, r.prompt_len)
        if memories is not None:
            r.memory = memories[i]
        out.append(r)
    return out


def forward_batch(torch, req, toks):
    """A whole-sequence forward's batch for ``req``: its tokens and, where
    it has one, its memory."""
    batch = {"tokens": torch.from_numpy(toks)[None].cuda()}
    if getattr(req, "memory", None) is not None:
        batch["memory"] = req.memory
    return batch


def top2_margin(torch, cfg, params, req, upto):
    """Top-2 logit gap where the stream chose its token ``upto``."""
    from repro_torch.models import model as M
    toks = np.concatenate([req.prompt_tokens, req.output[:upto]])
    logits, _, _ = M.forward(cfg, params, forward_batch(torch, req, toks))
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def serve(torch, label, cfg, params, kv, refactors, boundaries=(0, 12),
          memories=None, max_seq=1024, cache_dtype="float32", watch=None):
    """Phase 5's 16 requests through an engine: run(), or stepped with
    ``refactors`` (tick -> boundaries); ``watch``: a function called just
    before the requests go in, returning the function that ends it."""
    from repro_torch.kernels import build
    from repro_torch.serving.engine import (EngineConfig, FlexPipeEngine,
                                            KVCacheConfig)
    from repro_torch.serving.workload import Request

    eng = FlexPipeEngine(cfg, params, list(boundaries),
                         EngineConfig(max_batch=8, max_seq=max_seq,
                                      cache_dtype=cache_dtype,
                                      kv=KVCacheConfig(**kv)))
    eng.warmup((4,))                # two balanced stages and four
    reqs = make_requests(cfg, Request, memories)
    torch.cuda.synchronize()
    build.reset_launches()
    CROSS_LAUNCHES.clear()
    CROSS_HELD[:] = [{"armed": True}]
    unwatch = watch() if watch else (lambda: None)
    t0 = time.perf_counter()
    decode_s, decode_tok, decode_ticks, ticks, ticks_decoding = 0.0, 0, 0, 0, 0
    if refactors is None:
        step = eng.step

        def counted_step(now):                 # run() steps the engine
            nonlocal ticks_decoding
            rep = step(now)
            ticks_decoding += rep.decoded > 0
            return rep
        eng.step = counted_step
        try:
            eng.run(reqs)                      # the user's entry point
        finally:
            eng.step = step
            unwatch()
    else:
        for r in reqs:
            eng.submit(r, now=0.0)
        now = 0.0
        while eng.queue or any(not s.done for s in eng.slots):
            if ticks in refactors:
                ev = eng.refactor(refactors[ticks])
                check(ev["compile_cache_hit"] and ev["new_traces"] == 0,
                      f"{label}: warmed refactor built programs: {ev}")
            t1 = time.perf_counter()
            rep = eng.step(now)
            dt = time.perf_counter() - t1      # step ends in a host sync
            ticks_decoding += rep.decoded > 0
            if rep.admitted == 0 and rep.decoded:
                decode_s += dt
                decode_tok += rep.decoded
                decode_ticks += 1
            ticks += 1
            now += 0.05
        unwatch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launches)
    streams = {r.rid: list(r.output or []) for r in reqs}
    check(all(r.finish >= 0 and len(r.output) == 32 for r in reqs),
          f"{label}: not every request completed with 32 tokens")
    check(all(0 <= t < cfg.vocab_size for s in streams.values() for t in s),
          f"{label}: token ids out of range")
    if kv.get("paged"):
        check(eng.block_stats()["used_blocks"] == 0,
              f"{label}: blocks leaked")
    info = {"wall_s": wall, "launches": launches, "ticks": ticks,
            "ticks_decoding": ticks_decoding,
            "refactors": len(eng.refactor_events)}
    if CROSS_LAUNCHES:
        info["launches_cross"] = dict(CROSS_LAUNCHES)
    if decode_ticks:
        info.update(decode_tok_per_s=decode_tok / decode_s,
                    decode_ms_per_tick=decode_s / decode_ticks * 1e3,
                    decode_ticks_timed=decode_ticks)
    log(f"  {label:22s} {json.dumps(info)}")
    del eng
    torch.cuda.empty_cache()
    return streams, reqs, info


def kernel_profile(torch, fn, reps):
    """``reps`` calls of ``fn`` under torch.profiler: the kernel events only
    (an operator's device time repeats its kernels'), as (name, device us,
    count) rows by time, and the wall time in us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return rows, wall_us


def loaded_engine(torch, cfg, params, boundaries=(0, 12), memories=None,
                  max_seq=1024, cache_dtype="float32"):
    """A dense engine at batch 8 with phase 5's first 8 requests admitted
    and 3 decode ticks run."""
    from repro_torch.serving.engine import EngineConfig, FlexPipeEngine
    from repro_torch.serving.workload import Request

    eng = FlexPipeEngine(cfg, params, list(boundaries),
                         EngineConfig(max_batch=8, max_seq=max_seq,
                                      cache_dtype=cache_dtype))
    for r in make_requests(cfg, Request, memories)[:8]:
        eng.submit(r, now=0.0)
    eng._admit(0.0)
    for t in range(3):
        eng.decode_step(0.0)
    torch.cuda.synchronize()
    return eng


def profile_ticks(torch, eng, ticks):
    """Device time by kernel over ``ticks`` decode ticks under the profiler,
    and the device's idle share of their wall time."""
    rows, wall_us = kernel_profile(torch, lambda: eng.decode_step(0.0), ticks)
    busy_us = sum(r[1] for r in rows)
    if not rows:
        log("  profiler saw no device time: not measured")
        return {}
    out = dict(profiled_ms_per_tick=wall_us / ticks / 1e3,
               busy_ms_per_tick=busy_us / ticks / 1e3,
               idle_share=1 - busy_us / wall_us)
    log(f"  {ticks} decode ticks: wall {out['profiled_ms_per_tick']:.3f} "
        f"ms/tick, device busy {out['busy_ms_per_tick']:.3f} ms/tick, "
        f"idle share {out['idle_share']:.3f} (profiler on)")
    ours = ("decode_lane_kernel", "decode_mma_kernel", "flash_kernel",
            "flash_wgmma_kernel", "wkv6_kernel", "decode_cluster_kernel",
            "flash_span_kernel", "flash_combine_kernel",
            "flash_wgspan_kernel")
    for i, (key, us, n) in enumerate(rows):
        if i < 10 or any(k in key for k in ours):
            log(f"    {us / ticks:10.1f} us/tick {n / ticks:6.1f}/tick  "
                f"{key[:80]}")
    out["by_kernel"] = [(key, us / ticks, n / ticks) for key, us, n in rows]
    return out


def count_syncs(torch, eng):
    """The calls of one decode tick that wait for the device (the B-id copy
    must), one line each."""
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng.decode_step(0.0)
    torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    log(f"  synchronizing calls in one decode tick: {len(syncs)}")
    return syncs


def profile_decode(torch, card, cfg, params, extra_limit, ticks=5):
    """Device time by kernel over a few steady dense decode ticks at batch 8,
    and the device's idle share of their wall time.  A cold refactor may
    allocate at most 1/``extra_limit`` of the live cache."""
    eng = loaded_engine(torch, cfg, params)
    # a cold refactor warms its new program on small scratch caches: it must
    # not allocate anything on the scale of the live cache
    live = sum(t.numel() * t.element_size() for c in eng.caches
               for t in c["mixer"].values())
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cold = eng.refactor([0, 8, 16])
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    warm = eng.refactor([0, 12])
    log(f"  cold refactor [0,12] -> [0,8,16]: {cold['t'] * 1e3:.3f} ms, "
        f"new_traces {cold['new_traces']}, peak extra allocation {extra} B "
        f"(live cache {live} B); warm refactor back: {warm['t'] * 1e3:.3f} "
        f"ms, hit {warm['compile_cache_hit']}")
    check(not cold["compile_cache_hit"] and cold["new_traces"] == 1,
          f"cold refactor accounting: {cold}")
    check(warm["compile_cache_hit"] and warm["new_traces"] == 0,
          f"warm refactor accounting: {warm}")
    check(extra * extra_limit <= live,
          f"cold refactor allocated {extra} B beside a {live} B live cache "
          f"(limit 1/{extra_limit})")
    syncs = count_syncs(torch, eng)
    for m in syncs[:6]:
        log(f"    {m[:100]}")
    out = {"cold_refactor_ms": cold["t"] * 1e3, "cold_extra_bytes": extra,
           "live_cache_bytes": live, "warm_refactor_ms": warm["t"] * 1e3,
           "syncs_per_tick": len(syncs)}
    out.update(profile_ticks(torch, eng, ticks))
    out.pop("by_kernel", None)
    log(f"  {cfg.name} profile summary on {card}: {json.dumps(out)}")
    return out


def profile_prefill(torch, card, cfg, params, S=512, reps=3,
                    boundaries=(0, 12), ours=("wkv6", ("wkv6_kernel",))):
    """One full-width prefill of an S-token prompt through every stage
    (``boundaries``, a request into a free slot, as admission makes it):
    its wall time unprofiled, which ends in the first token's copy to the
    host (the engine's part of time to first token), and under the
    profiler its device time by kernel and the share of it of ``ours``
    (a label and the kernel names it sums)."""
    from repro_torch.serving.engine import EngineConfig, FlexPipeEngine
    from repro_torch.serving.workload import Request

    eng = FlexPipeEngine(cfg, params, list(boundaries),
                         EngineConfig(max_batch=8, max_seq=1024))
    rng = np.random.default_rng(1)
    slots = iter(range(8))

    def prefill():
        req = Request(rid=0, arrival=0.0, prompt_len=S, max_new_tokens=32)
        req.prompt_tokens = rng.integers(0, cfg.vocab_size, S)
        eng._prefill_into_slot(next(slots), req)

    prefill()                                  # warm
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        prefill()
        walls.append((time.perf_counter() - t0) * 1e3)
    rows, wall_us = kernel_profile(torch, prefill, 1)
    busy_us = sum(r[1] for r in rows)
    label, names = ours
    our_us = sum(r[1] for r in rows if any(n in r[0] for n in names))
    out = {"prompt_tokens": S, "wall_ms": sorted(walls)[len(walls) // 2],
           "wall_ms_all": walls}
    if rows:
        out.update({"profiled_wall_ms": wall_us / 1e3,
                    "busy_ms": busy_us / 1e3,
                    "idle_share": 1 - busy_us / wall_us,
                    f"{label}_ms": our_us / 1e3,
                    f"{label}_share": our_us / busy_us,
                    f"{label}_launches": sum(r[2] for r in rows if any(
                        n in r[0] for n in names))})
        log(f"  one {S}-token prefill: wall {out['wall_ms']:.3f} ms "
            f"(median of {reps}, unprofiled), device busy "
            f"{out['busy_ms']:.3f} ms, {label} {our_us / 1e3:.3f} ms "
            f"({out[f'{label}_share']:.3f} of busy), idle share "
            f"{out['idle_share']:.3f} (profiler on)")
        for key, us, n in rows[:10]:
            log(f"    {us:10.1f} us {n:5d} calls  {key[:80]}")
    else:
        log("  profiler saw no device time: not measured")
    log(f"  {cfg.name} prefill summary on {card}: {json.dumps(out)}")
    del eng
    torch.cuda.empty_cache()
    return out


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def decode_equals_forward(torch, cfg, params, reqs):
    """Each generated token of ``reqs`` is the argmax of one whole-sequence
    forward over prompt + output, wherever that forward's top-2 margin
    exceeds MARGIN_TOL."""
    from repro_torch.models import model as M
    checked, skipped, low = 0, 0, float("inf")
    for req in reqs:
        toks = np.concatenate([req.prompt_tokens, req.output[:-1]])
        logits, _, _ = M.forward(cfg, params, forward_batch(torch, req, toks))
        tail = logits[0, len(req.prompt_tokens) - 1:].float()
        top = torch.topk(tail, 2, dim=-1)
        margin = (top.values[:, 0] - top.values[:, 1]).cpu().numpy()
        ids = top.indices[:, 0].cpu().numpy()
        for j, tok in enumerate(req.output):
            if margin[j] <= MARGIN_TOL:
                skipped += 1
                continue
            checked += 1
            low = min(low, float(margin[j]))
            check(int(ids[j]) == tok,
                  f"request {req.rid}: token {j} is {tok} on the decode "
                  f"path, {int(ids[j])} by forward (margin {margin[j]:.3e})")
    log(f"  decode == forward for requests {[r.rid for r in reqs]}: "
        f"{checked} tokens equal, {skipped} skipped (top-2 margin <= "
        f"{MARGIN_TOL:g}), smallest margin checked {low:.3e}")


def serving(torch, card, arch, generator, refactored, prefix="",
            boundaries=(0, 12), moves=None, cfg=None, params=None,
            memories=None, max_seq=1024, dtype=None, cache_dtype="float32",
            watches=None):
    """Serve full-width ``arch`` (or ``cfg``, a depth cut of it; ``params``
    if given, else drawn from ``generator`` in ``dtype``, f32 by default):
    a dense run through run(), then one run per ``refactored`` entry (label
    -> KV config) refactored mid-stream (``moves``: tick -> boundaries);
    every stream must equal the run() streams.  ``memories``: each
    request's cross-attention memory; ``watches``: label -> serve's
    ``watch`` for that run."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import init_model

    cfg = cfg or get_arch(arch).config
    t0 = time.perf_counter()
    if params is None:
        params = init_model(cfg, generator, dtype or torch.float32,
                            device="cuda")
    n = sum(t.numel() for t in tree_leaves(params))
    pdt = str(params["embed"].dtype).replace("torch.", "")
    log(f"  {arch}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_heads} heads, vocab {cfg.vocab_size}, {n} params {pdt}, "
        f"{cache_dtype} cache ({time.perf_counter() - t0:.1f} s to init)")
    check(n == cfg.param_count(), "param count mismatch")
    moves = moves or {10: [0, 6, 12, 18], 30: [0, 12]}
    watches = watches or {}
    base, base_reqs, info_a = serve(
        torch, prefix + "dense run()", cfg, params, {}, None, boundaries,
        memories, max_seq, cache_dtype, watches.get(prefix + "dense run()"))
    runs = {prefix + "dense run()": info_a}
    for label, kv in refactored.items():
        label = prefix + label
        streams, reqs, info = serve(torch, label, cfg, params, kv, moves,
                                    boundaries, memories, max_seq,
                                    cache_dtype, watches.get(label))
        runs[label] = info
        check(info["refactors"] == 2, f"{label}: refactors did not happen")
        if streams != base:
            rid = next(r for r in base if base[r] != streams[r])
            j = next(i for i, (a, b) in enumerate(zip(base[rid],
                                                      streams[rid])) if a != b)
            req = next(r for r in reqs if r.rid == rid)
            m = top2_margin(torch, cfg, params, req, j)
            log(f"  {label}: request {rid} differs first at token {j} "
                f"(top-2 logit margin there {m:.3e})")
            raise SmokeFailure(f"{label}: streams differ from the dense run")
        log(f"  {label}: all 16 streams bit-identical to the dense run")
    a = runs[prefix + "dense refactored"]
    log(f"  {arch} decode: {a['decode_tok_per_s']:.1f} tok/s, "
        f"{a['decode_ms_per_tick']:.3f} ms/tick at batch 8 (dense, {pdt} "
        f"params, {cache_dtype} cache) on {card}")
    return cfg, params, base_reqs, runs


# ---------------------------------------------------------------------------
# phase 9: chunked prefill, the fault path and admission control
# ---------------------------------------------------------------------------

TICK = 0.05                                  # simulated seconds per tick


def serve_loop(torch, label, cfg, params, ecfg, *, boundaries=(0, 12),
               refactors=None, faults=None):
    """Submit phase 5's 16 requests and step the engine until every one has
    completed with its 32 tokens, refactoring at the given ticks;
    ``faults`` returns attach_faults' keywords.  Returns (streams,
    requests, info, engine)."""
    from repro_torch.kernels import build
    from repro_torch.serving.engine import FlexPipeEngine
    from repro_torch.serving.workload import Request

    eng = FlexPipeEngine(cfg, params, list(boundaries), ecfg)
    if faults is not None:
        eng.attach_faults(**faults())
    reqs = make_requests(cfg, Request)
    longest = max(reqs, key=lambda r: r.prompt_len)
    torch.cuda.synchronize()
    build.reset_launches()
    for r in reqs:
        eng.submit(r, now=0.0)
    t0 = time.perf_counter()
    now, ticks = 0.0, 0
    mid_prefill, decoded_in_long_prefill, long_prefill_ticks = [], 0, 0
    while len(eng.queue) or any(not s.done for s in eng.slots):
        if refactors and ticks in refactors:
            ev = eng.refactor(refactors[ticks])
            check(ev["compile_cache_hit"] and ev["new_traces"] == 0,
                  f"{label}: warmed refactor built programs: {ev}")
        rep = eng.step(now)
        if longest.start >= 0 and longest.first_token < 0:
            long_prefill_ticks += 1
            decoded_in_long_prefill += rep.decoded > 0
        # after this tick: is a slot mid-prefill with committed rows?
        mid_prefill.append(any(not s.done and not s.generated and s.pos > 0
                               for s in eng.slots))
        ticks += 1
        now += TICK
        check(ticks < 5000, f"{label}: did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(r.finish >= 0 and len(r.output) == 32 for r in reqs),
          f"{label}: not every request completed with 32 tokens")
    streams = {r.rid: list(r.output) for r in reqs}
    check(all(0 <= t < cfg.vocab_size for st in streams.values() for t in st),
          f"{label}: token ids out of range")
    if eng.ecfg.paged:
        check(eng.block_stats()["used_blocks"] == 0, f"{label}: blocks leaked")
    info = {"wall_s": wall, "ticks": ticks,
            "launches": dict(build.launches),
            "counters": dict(eng.stats.counters),
            "refactors": len(eng.refactor_events),
            "long_prompt": longest.prompt_len,
            "ticks_in_long_prefill": long_prefill_ticks,
            "decode_ticks_in_long_prefill": decoded_in_long_prefill,
            "mid_prefill": mid_prefill}
    log(f"  {label:30s} " + json.dumps(
        {k: v for k, v in info.items() if k != "mid_prefill"}))
    return streams, reqs, info, eng


def hold_streams(torch, cfg, params, label, got, ref, ref_reqs, exact):
    """``exact`` rids must equal the reference streams; every other rid may
    first differ only at a token whose top-2 logit margin (a whole-sequence
    forward over the reference's prompt and tokens) is under MARGIN_TOL.
    Returns the number of streams that differed."""
    by_rid = {r.rid: r for r in ref_reqs}
    differed = []
    for rid, want in ref.items():
        have = got.get(rid)
        check(have is not None, f"{label}: request {rid} did not complete")
        if have == want:
            continue
        check(rid not in exact, f"{label}: request {rid} differs from the "
              "reference where the shapes are equal")
        j = next((n for n, (a, b) in enumerate(zip(have, want)) if a != b),
                 min(len(have), len(want)))
        m = top2_margin(torch, cfg, params, by_rid[rid], j)
        log(f"  {label}: request {rid} first differs at token {j} (top-2 "
            f"margin of the reference there {m:.3e})")
        check(m < MARGIN_TOL, f"{label}: request {rid} differs at token {j} "
              f"where the reference's top-2 margin is {m:.3e} >= "
              f"{MARGIN_TOL:g}")
        differed.append(rid)
    log(f"  {label}: {len(ref) - len(differed)} of {len(ref)} streams "
        f"bit-identical to the reference ({len(exact)} required exact), "
        f"{len(differed)} differ under the margin rule")
    return len(differed)


def time_chunks(torch, card, cfg, params, chunk=128, S=512):
    """Wall time of one chunk at Lb = ``chunk`` (host clock around the
    engine's chunk call, synchronized), a chunk's device time by kernel, and
    the transposing copy a chunk makes per layer for kv_extent = S."""
    from repro_torch.models.layers import _dense_rows
    from repro_torch.serving.engine import (EngineConfig, FlexPipeEngine,
                                            PrefillConfig)
    from repro_torch.serving.workload import Request

    eng = FlexPipeEngine(cfg, params, [0, 12], EngineConfig(
        max_batch=8, max_seq=1024, prefill=PrefillConfig(chunk=chunk)))
    rng = np.random.default_rng(2)

    def assign(slot):
        req = Request(rid=slot, arrival=0.0, prompt_len=S, max_new_tokens=32)
        req.prompt_tokens = rng.integers(0, cfg.vocab_size, S)
        eng._assign_slot(slot, req, 0.0)

    walls = []
    for slot in range(4):                      # slot 0 warms the programs
        assign(slot)
        for _ in range(S // chunk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._prefill_chunk_into(slot, 0.0)
            torch.cuda.synchronize()
            if slot:
                walls.append((time.perf_counter() - t0) * 1e3)
    assign(4)
    rows, wall_us = kernel_profile(
        torch, lambda: eng._prefill_chunk_into(4, 0.0), 1)
    busy = sum(r[1] for r in rows)
    flash = sum(r[1] for r in rows if "flash_kernel" in r[0])
    k = eng.caches[0]["mixer"]["k"][:1]
    copy_ms = time_ms(torch, lambda: _dense_rows(k, S, torch.float32))
    out = {"chunk": chunk, "kv_extent": S,
           "wall_ms_per_chunk": sorted(walls)[len(walls) // 2],
           "wall_ms_all": walls, "copy_ms_per_layer_leaf": copy_ms,
           "copy_ms_per_chunk": copy_ms * 2 * cfg.n_layers}
    if rows:
        out.update(busy_ms=busy / 1e3, flash_ms=flash / 1e3,
                   idle_share=1 - busy / wall_us)
    log(f"  one chunk at Lb={chunk}, kv_extent={S}: wall "
        f"{out['wall_ms_per_chunk']:.3f} ms (median of {len(walls)}, "
        f"synchronized); transposing copy {copy_ms:.4f} ms per layer and "
        f"leaf, {out['copy_ms_per_chunk']:.3f} ms per chunk")
    for key, us, n in rows[:8]:
        log(f"    {us:10.1f} us {n:5d} calls  {key[:80]}")
    log(f"  chunk summary on {card}: {json.dumps(out)}")
    del eng
    torch.cuda.empty_cache()
    return out


def chunked_phase(torch, card, cfg, params, base, base_reqs):
    """Chunked prefill at chunk 128 (dense, paged gather and paged kernel,
    refactored at ticks 10 and 30, and one dense run unrefactored) and 64:
    streams exact among the chunk-128 runs, against whole-prompt prefill by
    the margin rule where they differ; flash launched 24 times per chunk;
    decode ticks during the longest prompt's prefill."""
    from repro_torch.serving.engine import (EngineConfig, KVCacheConfig,
                                            PrefillConfig)

    moves = {10: [0, 6, 12, 18], 30: [0, 12]}
    runs = {}

    def ecfg(chunk, **kv):
        return EngineConfig(max_batch=8, max_seq=1024, warm_profiles=(4,),
                            prefill=PrefillConfig(chunk=chunk),
                            kv=KVCacheConfig(**kv))

    for label, chunk, kv, refs in (
            ("chunk128 dense", 128, {}, None),
            ("chunk128 dense refact.", 128, {}, moves),
            ("chunk128 paged gather refact.", 128,
             dict(paged=True, block_size=16), moves),
            ("chunk128 paged kernel refact.", 128,
             dict(paged=True, block_size=16, paged_kernel=True), moves),
            ("chunk64 dense refact.", 64, {}, moves)):
        streams, reqs, info, eng = serve_loop(torch, label, cfg, params,
                                              ecfg(chunk, **kv),
                                              refactors=refs)
        n_chunks = info["counters"]["prefill_chunks"]
        flash = info["launches"].get("flash_attention", 0)
        log(f"  {label}: flash launches {flash} = {cfg.n_layers} x "
            f"{n_chunks} chunks: {cfg.n_layers * n_chunks}")
        check(flash == cfg.n_layers * n_chunks,
              f"{label}: flash launches {flash} != 24 x {n_chunks} chunks")
        check(info["decode_ticks_in_long_prefill"] > 0,
              f"{label}: no decode tick ran during the {info['long_prompt']}"
              "-token prompt's prefill")
        if refs:
            check(info["refactors"] == 2, f"{label}: refactors did not happen")
        runs[label] = (streams, info, reqs)
        del eng
        torch.cuda.empty_cache()
    ref = runs["chunk128 dense"][0]
    for label in ("chunk128 dense refact.", "chunk128 paged gather refact.",
                  "chunk128 paged kernel refact."):
        check(runs[label][0] == ref, f"{label}: streams differ from the "
              "unrefactored chunk-128 dense run (equal shapes)")
    log("  chunk-128 runs (dense, refactored dense, paged gather, paged "
        "kernel): all 16 streams bit-identical to each other")
    differed = {
        "chunk128 vs whole prompt": hold_streams(
            torch, cfg, params, "chunk128 vs whole prompt", ref, base,
            base_reqs, exact=()),
        "chunk64 vs whole prompt": hold_streams(
            torch, cfg, params, "chunk64 vs whole prompt",
            runs["chunk64 dense refact."][0], base, base_reqs, exact=())}
    return runs, differed


def fault_phase(torch, card, cfg, params, base, base_reqs, chunk_ref,
                chunk_info):
    """Eq. 10 on the card: a stage of [0, 6, 12, 18] preempted at tick 22
    (dense, paged kernel; two ticks after the last snapshot, so a delta is
    replayed), a preemption while a chunked prefill is mid-prompt, and a
    graceful migration under an injected slowdown.
    Recoveries must be warm; streams exact where the replay rebuilt only
    rows first made by decode ticks, by the margin rule elsewhere."""
    from repro_torch.core.refactoring import (CacheSnapshot, merge_with_mask,
                                              snapshot)
    from repro_torch.serving.engine import (EngineConfig, KVCacheConfig,
                                            PrefillConfig)
    from repro_torch.serving.faults import (PREEMPT_STAGE, SLOWDOWN,
                                            FaultEvent, FaultInjector,
                                            StageHealthMonitor)

    def ecfg(chunk=0, **kv):
        return EngineConfig(max_batch=8, max_seq=1024, warm_profiles=(2, 3, 4),
                            snapshot_interval=4,
                            prefill=PrefillConfig(chunk=chunk),
                            kv=KVCacheConfig(**kv))

    def preempt(tick):
        return lambda: dict(
            injector=FaultInjector.scripted([FaultEvent(
                t=(tick - 0.5) * TICK, kind=PREEMPT_STAGE, stage=1)]),
            monitor=StageHealthMonitor())

    # the chunked fault lands where a slot is mid-prompt (after a snapshot)
    mid = next(t for t in range(12, len(chunk_info["mid_prefill"]))
               if chunk_info["mid_prefill"][t - 1])
    out = {}
    for label, cfg_, tick, ref, ref_reqs in (
            ("fault dense", ecfg(), 22, base, base_reqs),
            ("fault paged kernel", ecfg(paged=True, block_size=16,
                                        paged_kernel=True), 22, base,
             base_reqs),
            ("fault chunk128 mid-prompt", ecfg(128), mid, chunk_ref[0],
             chunk_ref[1])):
        streams, reqs, info, eng = serve_loop(
            torch, label, cfg, params, cfg_, boundaries=(0, 6, 12, 18),
            faults=preempt(tick))
        recs = eng.recovery_events
        check(len(recs) == 1 and recs[0]["kind"] == "emergency_refactor",
              f"{label}: expected one emergency refactor, got {recs}")
        check(info["counters"].get("graceful_migrations", 0) == 0,
              f"{label}: a migration without an injected slowdown")
        rec = recs[0]
        check(rec["new_traces"] == 0 and rec["compile_cache_hit"]
              and rec["was_warm"], f"{label}: recovery not warm: {rec}")
        spans = rec["replay_spans"]
        # exact: the replay rebuilt only rows that decode ticks made
        exact = {rid for rid, (v, pos, plen) in spans.items() if v >= plen}
        exact |= set(ref) - set(spans)        # ended or not yet admitted
        if label.startswith("fault chunk"):
            check(any(p < plen for _, p, plen in spans.values()),
                  f"{label}: no slot was mid-prompt at the fault")
        snap_bytes = sum(t.numel() * t.element_size()
                         for c in eng._snap_caches
                         for t in c["mixer"].values())
        n_diff = hold_streams(torch, cfg, params, label, streams, ref,
                              ref_reqs, exact)
        out[label] = {
            "tick": tick, "recovery_s": rec["recovery_s"],
            "replayed_ticks": rec["replayed_ticks"],
            "compile_cache_hit": rec["compile_cache_hit"],
            "new_traces": rec["new_traces"], "to": rec["refactor"]["to"],
            "snapshot_bytes": snap_bytes, "exact_required": len(exact),
            "margin_rule_streams": n_diff,
            "replay_spans": {str(k): v for k, v in spans.items()}}
        if label == "fault dense":
            # the snapshot's copy and a merge at the live horizons, timed
            # on the loaded engine (its run is over, the values are spent)
            pos = np.array([int(x) for x in eng._snapshot.valid_len])
            pos[pos == 0] = 512
            live = int(pos.max())
            out[label]["snapshot_copy_ms"] = time_ms(
                torch, lambda: snapshot(eng.caches, pos,
                                        out=eng._snap_caches), iters=5)
            out[label]["merge_ms"] = time_ms(
                torch, lambda: merge_with_mask(
                    CacheSnapshot(eng._snap_caches, pos), eng.caches, live),
                iters=5)
        log(f"  {label} on {card}: " + json.dumps(
            {k: v for k, v in out[label].items() if k != "replay_spans"}))
        del eng
        torch.cuda.empty_cache()

    def slow():
        return dict(
            injector=FaultInjector.scripted([FaultEvent(
                t=9.5 * TICK, kind=SLOWDOWN, stage=1, factor=50.0,
                duration=30.0)]),
            monitor=StageHealthMonitor(straggler_factor=3.0, patience=3))

    label = "graceful migration"
    streams, _, info, eng = serve_loop(torch, label, cfg, params, ecfg(),
                                       boundaries=(0, 6, 12, 18),
                                       faults=slow)
    migs = [r for r in eng.recovery_events
            if r["kind"] == "graceful_migration"]
    check(len(migs) == 1 and migs[0]["replayed_ticks"] == 0
          and migs[0]["new_traces"] == 0 and migs[0]["compile_cache_hit"],
          f"{label}: expected one warm migration, got {eng.recovery_events}")
    check(streams == base, f"{label}: streams differ from the dense run")
    out[label] = {"recovery_s": migs[0]["recovery_s"],
                  "t": migs[0]["t"], "to": migs[0]["refactor"]["to"],
                  "new_traces": 0}
    log(f"  {label}: all 16 streams bit-identical to the dense run; "
        + json.dumps(out[label]))
    del eng
    torch.cuda.empty_cache()
    return out


def admission_phase(torch, card, cfg, params, base, base_reqs):
    """A burst of phase 5's requests at twice the rate its run() sustained,
    with deadlines and priority classes: every request ends in exactly one
    terminal state, every completed stream is a prefix of its unconstrained
    stream."""
    from repro_torch.serving.admission import AdmissionConfig
    from repro_torch.serving.engine import EngineConfig, FlexPipeEngine
    from repro_torch.serving.workload import Request, audit_requests

    makespan = max(r.finish for r in base_reqs) + TICK
    rate = 2 * len(base_reqs) / makespan
    reqs = make_requests(cfg, Request)
    for i, r in enumerate(reqs):
        r.arrival = i / rate
        r.deadline_s = 0.75 * makespan
        r.priority = i % 3                 # interactive, standard, batch
    adm = AdmissionConfig(max_queue_depth=4, brownout_dwell_s=0.25,
                          brownout_high=0.5)
    eng = FlexPipeEngine(cfg, params, [0, 12], EngineConfig(
        max_batch=8, max_seq=1024, admission=adm))
    t0 = time.perf_counter()
    stats = eng.run(reqs, time_per_tick=TICK)      # the user's entry point
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, violations = audit_requests(reqs)
    check(not violations, f"admission: requests without one terminal "
          f"state: {violations}")
    check(counts["completed"] > 0, "admission: nothing completed")
    for r in reqs:
        if r.finish >= 0:
            check(r.output == base[r.rid][:len(r.output)],
                  f"admission: request {r.rid}'s stream is not a prefix of "
                  "its unconstrained stream")
    horizon = len(stats.queue_samples) * TICK
    out = {"rate_req_per_s": rate, "deadline_s": 0.75 * makespan,
           "sustained_req_per_s": len(base_reqs) / makespan,
           "wall_s": wall, "counts": counts,
           "goodput_req_per_s": stats.goodput(horizon),
           "shed": len(eng.shed_requests),
           "rejected": len(eng.rejected_requests),
           "degraded": sum(r.degraded for r in reqs),
           "overload": {k: v for k, v in stats.overload_summary().items()
                        if k not in ("ttft", "blocks", "saturation")}}
    log(f"  admission burst on {card} (simulated time, {TICK} s per tick): "
        + json.dumps(out))
    del eng
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10: the controller plane driving full-width qwen1.5-0.5b and rwkv6
# ---------------------------------------------------------------------------

class Recorder:
    """Passes the engine's calls to a FlexPipeController and logs every
    control step, with its decision latency."""

    def __init__(self, inner):
        self.inner = inner
        self.steps, self.score_s = [], []

    def on_request(self, t):
        self.inner.on_request(t)

    def control_step(self, now, queue_len, saturation=0.0):
        d, mig = self.inner.control_step(now, queue_len,
                                         saturation=saturation)
        self.steps.append((now, queue_len, saturation, d.target.stages,
                           d.changed, d.reason))
        self.score_s.append(d.score_s)
        return d, mig


def controller_run(torch, label, cfg, params, device, boundaries, kv=None,
                   controller=True):
    """The quickstart's trace through FlexPipeEngine.run at max_batch 8 and
    max_seq 1024, under a FlexPipeController with the quickstart's two
    profiles (both warmed) or with none."""
    from repro_torch.core.controller import FlexPipeController
    from repro_torch.kernels import build
    from repro_torch.launch import quickstart
    from repro_torch.serving.engine import (EngineConfig, FlexPipeEngine,
                                            KVCacheConfig)
    from repro_torch.serving.workload import audit_requests

    eng = FlexPipeEngine(cfg, params, list(boundaries), EngineConfig(
        max_batch=8, max_seq=1024, control_interval=0.5,
        warm_profiles=tuple(p.stages for p in quickstart.PROFILES),
        kv=KVCacheConfig(**(kv or {}))), device=device)
    rec = Recorder(FlexPipeController(cfg, list(quickstart.PROFILES))) \
        if controller else None
    reqs = quickstart.requests()
    builds = eng.executors.builds
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    stats = eng.run(reqs, controller=rec, time_per_tick=TICK)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launches)
    counts, violations = audit_requests(reqs)
    check(stats.completed == len(reqs) == 81 and not violations,
          f"{label}: {stats.completed} of {len(reqs)} completed, "
          f"violations {violations}")
    # an unbucketed (recurrent) model's stage prefills are not warmed, as
    # in the reference: they are built at first use, and its refactors
    # must still be warm
    built = eng.executors.builds - builds
    check(built == 0 or not eng.executors.can_bucket,
          f"{label}: {built} programs built after warm-up")
    events = eng.refactor_events
    check(all(ev["compile_cache_hit"] and ev["new_traces"] == 0
              for ev in events), f"{label}: a refactor was not warm: {events}")
    if eng.ecfg.paged:
        check(eng.block_stats()["used_blocks"] == 0, f"{label}: blocks leaked")
    changed = [st for st in rec.steps if st[4]] if rec else []
    info = {"wall_s": wall, "ticks": len(stats.queue_samples),
            "completed": stats.completed, "launches": launches,
            "refactors": len(events),
            # (tick, from-stages, to-stages, in-flight) of each refactor
            "decisions": [(round(st[0] / TICK), len(ev["from"]),
                           len(ev["to"]), ev["inflight"])
                          for st, ev in zip(changed, events)],
            "refactor_ms": [ev["t"] * 1e3 for ev in events],
            "control_steps": len(rec.steps) if rec else 0,
            "prefill_builds": built}
    if cuda:
        log(f"  {label:26s} " + json.dumps(info))
    out = {"info": info, "streams": {r.rid: list(r.output) for r in reqs},
           "steps": rec.steps if rec else None,
           "score_s": rec.score_s if rec else [],
           "events": [(len(ev["from"]), len(ev["to"]), ev["inflight"])
                      for ev in events]}
    del eng
    if cuda:
        torch.cuda.empty_cache()
    return out


LAUNCHERS = {
    "serve qwen dense": (["-m", "repro_torch.launch.serve", "--arch",
                          "qwen1.5-0.5b", "--rate", "10", "--cv", "4",
                          "--duration", "3"],
                         ("flash_attention", "decode_attention")),
    "serve qwen paged kernel": (["-m", "repro_torch.launch.serve", "--arch",
                                 "qwen1.5-0.5b", "--rate", "10", "--cv", "4",
                                 "--duration", "3", "--paged",
                                 "--paged-kernel"],
                                ("flash_attention", "paged_decode_attention")),
    "serve rwkv6": (["-m", "repro_torch.launch.serve", "--arch",
                     "rwkv6-1.6b", "--rate", "10", "--cv", "4",
                     "--duration", "3"], ("wkv6",)),
    "quickstart": (["-m", "repro_torch.launch.quickstart"],
                   ("flash_attention", "decode_attention")),
}


def start_launchers():
    """Each launcher as a subprocess on the card, all at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return {label: subprocess.Popen([sys.executable, *argv], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            for label, (argv, _) in LAUNCHERS.items()}, time.perf_counter()


def finish_launchers(card, started, timeout=600):
    """Wait for the launchers: each must exit 0, report at least one
    refactor (serve) or OK (quickstart), and launch its path's kernels."""
    procs, t0 = started
    out = {}
    try:
        for label, proc in procs.items():
            left = max(timeout - (time.perf_counter() - t0), 1.0)
            text, _ = proc.communicate(timeout=left)
            out[label] = (proc.returncode, text)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    res = {}
    for label, (rc, text) in out.items():
        lines = text.strip().splitlines()
        check(rc == 0, f"{label}: exit {rc}\n" + "\n".join(lines[-20:]))
        launched = json.loads(next(x for x in lines
                                   if x.startswith("launches="))[9:])
        done = next(x for x in lines if x.startswith("completed="))
        if label == "quickstart":
            check(lines[-1] == "OK", f"{label}: no OK")
        else:
            n = int(done.split("refactors=")[1].split()[0])
            check(n >= 1, f"{label}: no refactor")
        for k in LAUNCHERS[label][1]:
            check(launched.get(k, 0) > 0, f"{label}: {k} not launched")
        res[label] = {"result": done, "launches": launched}
        log(f"  {label:24s} exit 0, {done}, launches {json.dumps(launched)} "
            f"on {card}")
    log(f"  launchers: {time.perf_counter() - t0:.1f} s wall from their "
        "start, in parallel with each other and with the CPU runs and the "
        "runs with no controller")
    return res


CONTROLLER_RUNS = {
    # label: (model, KVCacheConfig fields, decode kernel)
    "controller dense": ("qwen", None, "decode_attention"),
    "controller paged kernel": ("qwen", dict(paged=True, block_size=16,
                                             paged_kernel=True),
                                "paged_decode_attention"),
    "controller rwkv6 dense": ("rwkv6", None, "wkv6"),
}


def controller_phase(torch, card, models, decode_ms_per_tick):
    """Full-width qwen1.5-0.5b (dense and paged kernel) and rwkv6-1.6b
    (dense) under the controller: all 81 requests complete, at least one
    warm refactor, control steps equal to the smoke config's run on the
    CPU, streams equal to a run with no controller.  The launchers run as
    subprocesses meanwhile, until the runs under the controller, which are
    timed alone on the card."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.admission import CostModel

    started = start_launchers()
    cpu, base = {}, {}
    for name, (cfg, params) in models.items():
        smoke = get_arch(cfg.name).smoke_config
        t0 = time.perf_counter()
        cpu[name] = controller_run(
            torch, f"{name} smoke config on the CPU", smoke,
            init_model(smoke, torch.Generator().manual_seed(0),
                       device="cpu"),
            "cpu", [0, smoke.n_layers // 2])
        log(f"  {name} smoke config on the CPU: "
            f"{cpu[name]['info']['ticks']} ticks, decisions "
            f"{cpu[name]['info']['decisions']} "
            f"({time.perf_counter() - t0:.1f} s)")
        check(cpu[name]["info"]["refactors"] >= 1,
              f"{name} CPU run: no controller refactor")
    for name, (cfg, params) in models.items():
        base[name] = controller_run(torch, f"{name} no controller", cfg,
                                    params, "cuda", [0, 12],
                                    controller=False)
        check(base[name]["info"]["refactors"] == 0,
              f"{name}: refactor without a controller")
    launchers = finish_launchers(card, started)
    runs = {}
    for label, (name, kv, decode) in CONTROLLER_RUNS.items():
        cfg, params = models[name]
        run = controller_run(torch, label, cfg, params, "cuda", [0, 12], kv)
        runs[label] = run
        ref = cpu[name]
        check(run["info"]["refactors"] >= 1, f"{label}: no refactor")
        check(run["steps"] == ref["steps"] and run["events"] == ref["events"],
              f"{label}: control steps or refactors differ from the CPU "
              f"run's: {run['info']['decisions']} vs "
              f"{ref['info']['decisions']}")
        check(run["streams"] == base[name]["streams"],
              f"{label}: streams differ from the run with no controller")
        kernels = ("wkv6",) if name == "rwkv6" else ("flash_attention",
                                                     decode)
        for k in kernels:
            check(run["info"]["launches"].get(k, 0) > 0,
                  f"{label}: {k} not launched")
        log(f"  {label}: 81 streams bit-identical to the run with no "
            "controller; control steps equal the CPU run's")
    scores = sorted(x for r in runs.values() for x in r["score_s"])
    dense = runs["controller dense"]["info"]
    rwkv = runs["controller rwkv6 dense"]["info"]
    summary = {
        "card": card,
        "score_ms_median": scores[len(scores) // 2] * 1e3,
        "score_ms_max": scores[-1] * 1e3, "control_steps": len(scores),
        "decisions": {k: r["info"]["decisions"] for k, r in runs.items()},
        "refactor_ms": {k: r["info"]["refactor_ms"] for k, r in runs.items()},
        "ticks": {k: r["info"]["ticks"] for k, r in runs.items()},
        "wall_s": {k: r["info"]["wall_s"] for k, r in runs.items()},
        "no_controller": {k: {kk: b["info"][kk] for kk in ("ticks", "wall_s")}
                          for k, b in base.items()},
        "rwkv6_prefill_builds": rwkv["prefill_builds"],
    }
    for name, (cfg, _) in models.items():
        info = rwkv if name == "rwkv6" else dense
        summary[f"{name}_prior_ms_per_decode_token"] = \
            CostModel.from_roofline(cfg, batch=8, ctx=256) \
            .decode_s_per_token * 1e3
        summary[f"{name}_measured_ms_per_decode_token"] = \
            decode_ms_per_tick[name] / 8
        summary[f"{name}_run_ms_per_tick_per_8"] = \
            info["wall_s"] / info["ticks"] * 1e3 / 8
    log(f"  decision latency (score_s) on {card}: median "
        f"{summary['score_ms_median']:.4f} ms, max "
        f"{summary['score_ms_max']:.4f} ms over {len(scores)} steps")
    check(summary["score_ms_median"] < 5.0,
          f"decision latency: median score_s "
          f"{summary['score_ms_median']:.4f} ms, not under the paper's 5 ms")
    log(f"  controller refactors on {card}: " + ", ".join(
        f"{k} {[round(x, 4) for x in v]} ms"
        for k, v in summary["refactor_ms"].items()))
    log(f"  runs on {card}: " + ", ".join(
        f"{k} {summary['ticks'][k]} ticks {summary['wall_s'][k]:.2f} s"
        for k in runs) + "; with no controller (beside the launchers): "
        + ", ".join(f"{k} {b['info']['ticks']} ticks "
                    f"{b['info']['wall_s']:.2f} s" for k, b in base.items()))
    for name in models:
        log(f"  {name} roofline prior "
            f"{summary[f'{name}_prior_ms_per_decode_token']:.4f} ms per "
            f"decode token (batch 8, ctx 256, f32) beside "
            f"{summary[f'{name}_measured_ms_per_decode_token']:.4f} ms "
            f"measured (serving phase's decode tick / 8) and "
            f"{summary[f'{name}_run_ms_per_tick_per_8']:.4f} ms (controller "
            f"run's wall per tick / 8) on {card}")
    summary["launchers"] = launchers
    log("  phase 10 summary: " + json.dumps(summary))
    return runs, summary


# ---------------------------------------------------------------------------
# phase 11: serve full-width gemma3-1b (ring caches, GeGLU, head_dim 256)
# ---------------------------------------------------------------------------

def gemma3_phase(torch, card):
    """Full-width gemma3-1b on phase 5's 16 requests (prompts of 74-571
    tokens: five roll into the 512-row rings, and the 494-token one wraps
    them while it decodes): run(), then a run refactored [0, 13] ->
    [0, 7, 14, 20] at tick 10 and back at tick 30, streams bit-identical and
    the refactors warm; every prefill through flash (26 per prompt) and
    every decode step through the decode kernel (26 per tick); decode ==
    forward for requests 8 and 13 under the margin rule; three steady
    decode ticks profiled."""
    t0 = time.perf_counter()
    cfg, params, reqs, runs = serving(
        torch, card, "gemma3-1b",
        torch.Generator(device="cuda").manual_seed(0),
        {"dense refactored": {}}, prefix="gemma3 ", boundaries=(0, 13),
        moves={10: [0, 7, 14, 20], 30: [0, 13]})
    run = runs["gemma3 dense refactored"]
    want = {"flash_attention": cfg.n_layers * len(reqs),
            "decode_attention": cfg.n_layers * run["ticks_decoding"]}
    for name, n in want.items():
        got = run["launches"].get(name, 0)
        log(f"  {name} launches in the refactored run: {got} (want {n})")
        check(got == n, f"gemma3: {name} launched {got} times, not {n}")
    decode_equals_forward(torch, cfg, params,
                          [r for r in reqs if r.rid in (8, 13)])
    eng = loaded_engine(torch, cfg, params, (0, 13))
    prof = profile_ticks(torch, eng, 3)
    del eng
    torch.cuda.empty_cache()
    by_kernel = prof.pop("by_kernel", [])
    log("  device time per tick by kernel, this run beside the one-CTA-per-"
        "chunk decode kernels' run (NVIDIA H100 80GB HBM3, 700 W):")
    for label, pattern, earlier in GEMMA3_TICK_EARLIER:
        got = [(us, n) for key, us, n in by_kernel if pattern in key]
        us = sum(u for u, _ in got)
        n = sum(c for _, c in got)
        log(f"    {label:44s} {us:8.1f} us/tick ({n:5.1f} launches)   "
            f"earlier {earlier}")
    if prof:
        log(f"    {'device busy per tick':44s} "
            f"{prof['busy_ms_per_tick'] * 1e3:8.1f} us            earlier "
            f"7590.0 us")
    log(f"  gemma3-1b phase on {card}: {json.dumps(prof)}, "
        f"{time.perf_counter() - t0:.1f} s")
    return runs


# gemma3-1b's decode tick by kernel before the hd-256 decode kernel took a
# cluster per chunk (PERF.md section 5): (label, name pattern, earlier
# time per tick)
GEMMA3_TICK_EARLIER = [
    ("ours: decode at hd 256 (cluster, combine in)", "decode_cluster_kernel",
     "n/a"),
    ("ours: decode_split_kernel<float, 256, 4>", "decode_split_kernel",
     "730.2 us (26)"),
    ("ours: decode_combine_kernel", "decode_combine_kernel", "189.5 us (26)"),
    ("SIMT sgemm 128x32", "128x32", "1938.5 us (129)"),
    ("gemmSN", "gemmSN", "1356.2 us (52)"),
    ("lm_head sgemm_largek", "largek", "655.3 us (1)"),
    ("splitK", "splitK", "261.4 us"),
]


# ---------------------------------------------------------------------------
# phases 12 and 13: full-width deepseek-moe-16b and jamba-v0.1-52b
# ---------------------------------------------------------------------------

GiB = 1024 ** 3
# deepseek-moe-16b runs at full depth: 67.5 GB of f32 weights and 3.76 GB of
# dense caches at batch 8 x 1024 rows must leave at least 4 GiB of the card
# jamba-v0.1-52b (51.6 B params, 206 GB f32) cut to one 8-layer Jamba block
# (13.3 B params, 53.2 GB): the depth is cut, no width
JAMBA_LAYERS = 8


def free_weights(torch):
    """Drop what earlier phases left on the card; the bytes still held."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_memory(torch, label):
    """The peak device memory since the last reset, and what it left free
    of the card's total."""
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.mem_get_info()[1]
    out = {"peak_allocated_bytes": peak, "card_total_bytes": total,
           "headroom_bytes": total - peak}
    log(f"  {label} peak device memory: {peak / GiB:.2f} GiB allocated of "
        f"{total / GiB:.2f} GiB ({(total - peak) / GiB:.2f} GiB left)")
    return out


def no_drop(cfg):
    """``cfg`` at capacity factor E/K: every expert takes every row of a
    call (cap >= T), so a decode tick and a whole-sequence forward keep
    the same assignments."""
    mo = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))


def decode_equals_forward_no_drop(torch, cfg, params, rids, boundaries):
    """Phase 5's 16 requests served at capacity factor E/K with the same
    weights, then decode == forward for ``rids`` (admitted into reused
    slots)."""
    from repro_torch.serving.engine import EngineConfig, FlexPipeEngine
    from repro_torch.serving.workload import Request

    cfg = no_drop(cfg)
    eng = FlexPipeEngine(cfg, params, list(boundaries),
                         EngineConfig(max_batch=8, max_seq=1024))
    reqs = make_requests(cfg, Request)
    eng.run(reqs)
    check(all(len(r.output) == 32 for r in reqs),
          f"{cfg.name} at capacity factor E/K: not every request completed")
    del eng
    torch.cuda.empty_cache()
    decode_equals_forward(torch, cfg, params,
                          [r for r in reqs if r.rid in rids])


def profile_moe_ticks(torch, cfg, params, boundaries, memories=None,
                      max_seq=1024, cache_dtype="float32"):
    """The host syncs of one decode tick, then three steady decode ticks
    under the profiler: device busy, idle share and the kernels that take
    the time."""
    eng = loaded_engine(torch, cfg, params, boundaries, memories, max_seq,
                        cache_dtype)
    syncs = count_syncs(torch, eng)
    prof = profile_ticks(torch, eng, 3)
    prof["syncs_per_tick"] = len(syncs)
    del eng
    torch.cuda.empty_cache()
    by_kernel = prof.pop("by_kernel", [])
    prof["top_kernels"] = [(k[:80], round(us, 1), round(n, 1))
                           for k, us, n in by_kernel[:12]]
    return prof


def want_launches(label, run, want):
    for name, n in want.items():
        got = run["launches"].get(name, 0)
        log(f"  {name} launches in {label}: {got} (want {n})")
        check(got == n, f"{label}: {name} launched {got} times, not {n}")


def deepseek_phase(torch, card):
    """Full-width deepseek-moe-16b on phase 5's 16 requests: run(), then
    dense and paged-kernel runs refactored [0, 14] -> [0, 7, 14, 21] at
    tick 10 and back at tick 30; streams bit-identical, paged == dense
    (each tick routes the same batch, so capacity drops agree); flash 28
    per prefill, decode (paged decode in the paged run) 28 per decoding
    tick.  A chunk-128 run counts the streams that differ from whole-prompt
    prefill (the capacity depends on the tokens in a call, as in the
    reference).  Decode == forward at capacity factor E/K for requests 8
    and 13; three profiled decode ticks; the peak device memory."""
    from repro_torch.configs.base import get_arch
    from repro_torch.serving.engine import EngineConfig, PrefillConfig

    t0 = time.perf_counter()
    held = free_weights(torch)
    log(f"  device memory held from earlier phases: {held} B")
    cfg = get_arch("deepseek-moe-16b").config
    half = cfg.n_layers // 2
    quarter = [0, half // 2, half, half + half // 2]
    cfg, params, reqs, runs = serving(
        torch, card, "deepseek-moe-16b",
        torch.Generator(device="cuda").manual_seed(0),
        {"dense refactored": {},
         "paged kernel refact.": dict(paged=True, block_size=16,
                                      paged_kernel=True)},
        prefix="deepseek-moe ", boundaries=(0, half),
        moves={10: quarter, 30: [0, half]}, cfg=cfg)
    L = cfg.n_layers
    dense = runs["deepseek-moe dense refactored"]
    want_launches("the dense refactored run", dense, {
        "flash_attention": L * len(reqs),
        "decode_attention": L * dense["ticks_decoding"]})
    paged = runs["deepseek-moe paged kernel refact."]
    want_launches("the paged kernel run", paged, {
        "flash_attention": L * len(reqs),
        "paged_decode_attention": L * paged["ticks_decoding"],
        "decode_attention": 0})
    base = {r.rid: list(r.output) for r in reqs}
    streams, _, info, eng = serve_loop(
        torch, "deepseek-moe chunk128 dense", cfg, params,
        EngineConfig(max_batch=8, max_seq=1024,
                     prefill=PrefillConfig(chunk=128)), boundaries=(0, half))
    del eng
    torch.cuda.empty_cache()
    n_chunks = info["counters"]["prefill_chunks"]
    want_launches("the chunk-128 run", info,
                  {"flash_attention": L * n_chunks})
    differ = sorted(r for r in base if streams[r] != base[r])
    first = {r: next(j for j, (a, b) in enumerate(zip(base[r], streams[r]))
                     if a != b) for r in differ}
    log(f"  chunk-128 streams that differ from whole-prompt prefill: "
        f"{len(differ)} of 16 (first differing token by request: {first}); "
        "capacity drops depend on the tokens in a call, as in the "
        "reference (ROADMAP.md, section 3): counted, not failed")
    runs["deepseek-moe chunk128 dense"] = info
    decode_equals_forward_no_drop(torch, cfg, params, (8, 13), (0, half))
    prof = profile_moe_ticks(torch, cfg, params, (0, half))
    # time to first token's device part through all 28 layers, and flash's
    # share: a 512-token prompt (bucket 512) and the longest of the 16, 571
    # tokens (bucket 1024, as 5 of them)
    prefill = {S: profile_prefill(torch, card, cfg, params, S=S,
                                  boundaries=(0, half),
                                  ours=("flash", ("flash_span_kernel",
                                                  "flash_combine_kernel",
                                                  "flash_kernel")))
               for S in (512, 571)}
    mem = peak_memory(torch, "deepseek-moe-16b")
    out = {"layers": L, "chunk128_streams_differing": len(differ),
           "chunk128_first_differing_token": first, **prof,
           "prefill": prefill[512], "prefill_1024": prefill[571], **mem,
           "s": time.perf_counter() - t0}
    check(mem["headroom_bytes"] >= 4 * GiB,
          f"deepseek-moe-16b at full depth left {mem['headroom_bytes']} B "
          "free at its peak, under 4 GiB")
    log(f"  deepseek-moe-16b phase on {card}: {json.dumps(out)}")
    return runs, out


def jamba_phase(torch, card):
    """jamba-v0.1-52b cut to one Jamba block (8 layers) at full width, on
    phase 5's 16 requests: run(), then a run refactored [0, 4] ->
    [0, 2, 4, 6] at tick 10 and back at 30, exact-length prefill; streams
    bit-identical; flash once per prefill and decode once per decoding tick
    (the one attention layer); decode == forward at capacity factor E/K for
    requests 8 and 13, whose slots were used before (Mamba state carried
    across prefill, ticks and slot reuse); three profiled decode ticks; the
    peak device memory."""
    from repro_torch.configs.base import get_arch, shrink

    t0 = time.perf_counter()
    held = free_weights(torch)
    log(f"  device memory held from earlier phases: {held} B")
    cfg = shrink(get_arch("jamba-v0.1-52b").config, n_layers=JAMBA_LAYERS)
    cfg, params, reqs, runs = serving(
        torch, card, "jamba-v0.1-52b",
        torch.Generator(device="cuda").manual_seed(0),
        {"dense refactored": {}}, prefix="jamba ", boundaries=(0, 4),
        moves={10: [0, 2, 4, 6], 30: [0, 4]}, cfg=cfg)
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.layer_kind(i).mixer == "attn")
    run = runs["jamba dense refactored"]
    want_launches("the refactored run", run, {
        "flash_attention": n_attn * len(reqs),
        "decode_attention": n_attn * run["ticks_decoding"]})
    decode_equals_forward_no_drop(torch, cfg, params, (8, 13), (0, 4))
    prof = profile_moe_ticks(torch, cfg, params, (0, 4))
    mem = peak_memory(torch, "jamba-v0.1-52b (8 layers)")
    out = {"layers": cfg.n_layers, "attention_layers": n_attn, **prof,
           **mem, "s": time.perf_counter() - t0}
    log(f"  jamba-v0.1-52b phase on {card}: {json.dumps(out)}")
    return runs, out


# ---------------------------------------------------------------------------
# phases 14-16: llama-3.2-vision-11b, whisper-tiny, qwen1.5-110b
# ---------------------------------------------------------------------------

# launches made inside cross-attention layers while ``watch_cross`` is on,
# and the served cross calls held against the plain versions, since serve()
# last cleared them and armed the holds (after its warm-up)
CROSS_LAUNCHES = collections.Counter()
CROSS_HELD: list = []
# qwen1.5-110b (80 layers, 111.2 B params, 444.8 GB f32) cut to 8 layers at
# full width: 13.4 B params, 53.4 GB; the depth is cut, no width
QWEN110B_LAYERS = 8


def set_gates(params, seed):
    """Every cross-attention ``gate`` set from ``seed`` to +-[0.5, 1.5]
    (|tanh| >= 0.46), in place: the reference initialises them to 0, where
    a wrong cross kernel would change no token.  Returns the values."""
    rng = np.random.default_rng(seed)
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if k == "gate":
                    out.append(float(rng.choice([-1.0, 1.0])
                                     * rng.uniform(0.5, 1.5)))
                    v.fill_(out[-1])
                else:
                    walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
    walk(params)
    return out


@contextlib.contextmanager
def watch_cross(torch):
    """While on, count the launches made inside cross-attention layers into
    CROSS_LAUNCHES, and hold the first served cross prefill's flash output
    and the first served cross decode's output against the plain version
    on that call's own inputs (the plain versions launch nothing) into
    CROSS_HELD, which it yields: after a serving run, that run's holds."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import layers as L

    inner = L.apply_cross_attention
    plain = {"flash_attention": flash_attention_plain,
             "decode_attention": decode_attention_plain}
    held = CROSS_HELD

    def layer(cfg, params, x, **kw):
        before = dict(build.launches)
        name = "decode_attention" if x.shape[1] == 1 else "flash_attention"
        if not held or any(h.get("kernel") == name for h in held):
            out = inner(cfg, params, x, **kw)
        else:
            kernel, calls = getattr(L, name), []

            def record(*a, **k):
                calls.append((a, k, kernel(*a, **k)))
                return calls[-1][2]
            setattr(L, name, record)
            try:
                out = inner(cfg, params, x, **kw)
            finally:
                setattr(L, name, kernel)
            a, k, got = calls[0]
            err = float((got.float() - plain[name](*a, **k).float())
                        .abs().max())
            held.append({"kernel": name, "max_abs_err": err,
                         "q": list(a[0].shape), "k": list(a[1].shape)})
            log(f"  served cross {name} q{list(a[0].shape)} "
                f"k{list(a[1].shape)}: kernel vs plain on the call's own "
                f"inputs max|err| {err:.3e} (tol {TOL['float32']:g})")
            check(err <= TOL["float32"], f"served cross {name}: error {err}")
        for n, v in build.launches.items():
            CROSS_LAUNCHES[n] += v - before.get(n, 0)
        return out

    L.apply_cross_attention = layer
    held.clear()                       # unarmed until serve() arms it
    try:
        yield held
    finally:
        L.apply_cross_attention = inner
        if held and "armed" in held[0]:
            del held[0]


def cross_counts(label, cfg, run, n_prefills):
    """The flash and decode launches of ``run`` split between its cross
    layers (the cross mixers, or whisper's extra cross sub-blocks) and its
    self-attention layers; each checked against one launch per layer per
    prefill and per decoding tick."""
    n_cross = sum(1 for i in range(cfg.n_layers)
                  if cfg.layer_kind(i).mixer == "cross"
                  or cfg.layer_kind(i).extra_cross)
    n_self = sum(1 for i in range(cfg.n_layers)
                 if cfg.layer_kind(i).mixer == "attn")
    cross = run.get("launches_cross", {})
    out = {}
    for name, per in (("flash_attention", n_prefills),
                      ("decode_attention", run["ticks_decoding"])):
        c = cross.get(name, 0)
        out[name] = {"cross": c, "self": run["launches"].get(name, 0) - c}
        log(f"  {label} {name}: {c} in the {n_cross} cross layers, "
            f"{out[name]['self']} in the {n_self} self-attention layers")
        check(c == n_cross * per and out[name]["self"] == n_self * per,
              f"{label}: {name} launches {out[name]} are not one per layer "
              f"for each of {per} calls")
    return out


def vision_phase(torch, card):
    """Full-width llama-3.2-vision-11b at full depth (40 layers, 8 of them
    gated cross attention, 9.78 B params, 39.1 GB f32) on phase 5's 16
    requests, each with seeded image tokens (1, 1601, 4096) and every gate
    set nonzero: run(), then a run refactored [0, 20] -> [0, 10, 20, 30] at
    tick 10 and back at 30, streams bit-identical; flash 40 per prefill (32
    causal, 8 non-causal over the memory) and decode 40 per decoding tick
    (8 over all 1601 memory rows), counted apart; paged decode never (cross
    caches do not page); one served cross call of each kernel held against
    its plain version; decode == forward for requests 8 and 13; three
    profiled decode ticks; the peak device memory."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import init_model

    t0 = time.perf_counter()
    held = free_weights(torch)
    log(f"  device memory held from earlier phases: {held} B")
    cfg = get_arch("llama-3.2-vision-11b").config
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    gates = set_gates(params, 0)
    log(f"  cross gates set from seed 0: min |tanh| "
        f"{min(abs(np.tanh(g)) for g in gates):.3f} over {len(gates)}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    mems = [torch.randn((1, cfg.n_memory_tokens, cfg.d_model),
                        generator=gen, device="cuda") for _ in range(16)]
    half = cfg.n_layers // 2
    with watch_cross(torch) as holds:
        cfg, params, reqs, runs = serving(
            torch, card, "llama-3.2-vision-11b", None,
            {"dense refactored": {}}, prefix="vision ", boundaries=(0, half),
            moves={10: [0, half // 2, half, half + half // 2],
                   30: [0, half]}, cfg=cfg, params=params, memories=mems)
    run = runs["vision dense refactored"]
    L = cfg.n_layers
    want_launches("the refactored run", run, {
        "flash_attention": L * len(reqs),
        "decode_attention": L * run["ticks_decoding"],
        "paged_decode_attention": 0})
    split = cross_counts("vision", cfg, run, len(reqs))
    check(sorted(h["kernel"] for h in holds) == ["decode_attention",
                                                 "flash_attention"],
          f"vision: served cross calls held: {holds}")
    decode_equals_forward(torch, cfg, params,
                          [r for r in reqs if r.rid in (8, 13)])
    prof = profile_moe_ticks(torch, cfg, params, (0, half), mems)
    mem = peak_memory(torch, "llama-3.2-vision-11b")
    out = {"layers": L, "launches_split": split, "served_holds": holds,
           "decode_ms_per_tick": run.get("decode_ms_per_tick"),
           "decode_tok_per_s": run.get("decode_tok_per_s"), **prof, **mem,
           "s": time.perf_counter() - t0}
    log(f"  llama-3.2-vision-11b phase on {card}: {json.dumps(out)}")
    return runs, out


def whisper_phase(torch, card):
    """Full-width whisper-tiny (4 encoder and 4 decoder layers, d 384, 6
    heads of 64) with max_seq = 1500, so the engine's cross memory is
    whisper's 1500 encoder frames: the port's run_encoder on the card over
    seeded frames (1, 1500, 384) makes each of phase 5's 16 requests' memory
    (its device time and its 4 flash launches a call), every gate set
    nonzero; run(), then a run refactored [0, 2] -> [0, 1, 2, 3] at tick 10
    and back at 30, streams bit-identical; flash 8 per prefill and decode 8
    per decoding tick, half of each in the cross sub-blocks; one served
    cross call of each kernel held against its plain version; decode ==
    forward for requests 8 and 13; three profiled decode ticks."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_model

    t0 = time.perf_counter()
    free_weights(torch)
    cfg = get_arch("whisper-tiny").config
    max_seq = cfg.n_memory_tokens                      # 1500 frames
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    set_gates(params, 0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = [torch.randn((1, max_seq, cfg.d_model), generator=gen,
                          device="cuda") for _ in range(16)]
    torch.cuda.synchronize()
    build.reset_launches()
    mems = [M.run_encoder(cfg, params, f) for f in frames]
    torch.cuda.synchronize()
    enc_flash = build.launches.get("flash_attention", 0)
    check(enc_flash == cfg.encoder_layers * len(frames),
          f"whisper encoder: {enc_flash} flash launches for {len(frames)} "
          "calls")
    check(all(bool(torch.isfinite(m).all()) and m.shape == (1, max_seq,
                                                             cfg.d_model)
              for m in mems), "whisper encoder: bad output")
    rows, wall_us = kernel_profile(
        torch, lambda: M.run_encoder(cfg, params, frames[0]), 5)
    enc = {"encoder_calls": len(frames), "encoder_flash_launches": enc_flash,
           "encoder_busy_ms": sum(r[1] for r in rows) / 5 / 1e3,
           "encoder_wall_ms": wall_us / 5 / 1e3,
           "encoder_flash_ms": sum(r[1] for r in rows if "flash" in r[0])
           / 5 / 1e3}
    log(f"  whisper encoder over (1, {max_seq}, {cfg.d_model}) frames: "
        f"{json.dumps(enc)} (profiler on)")
    with watch_cross(torch) as holds:
        cfg, params, reqs, runs = serving(
            torch, card, "whisper-tiny", None, {"dense refactored": {}},
            prefix="whisper ", boundaries=(0, 2),
            moves={10: [0, 1, 2, 3], 30: [0, 2]}, cfg=cfg, params=params,
            memories=mems, max_seq=max_seq)
    run = runs["whisper dense refactored"]
    L = cfg.n_layers
    want_launches("the refactored run", run, {
        "flash_attention": 2 * L * len(reqs),
        "decode_attention": 2 * L * run["ticks_decoding"],
        "paged_decode_attention": 0})
    split = cross_counts("whisper", cfg, run, len(reqs))
    check(sorted(h["kernel"] for h in holds) == ["decode_attention",
                                                 "flash_attention"],
          f"whisper: served cross calls held: {holds}")
    decode_equals_forward(torch, cfg, params,
                          [r for r in reqs if r.rid in (8, 13)])
    prof = profile_moe_ticks(torch, cfg, params, (0, 2), mems, max_seq)
    out = {"layers": L, **enc, "launches_split": split,
           "served_holds": holds,
           "decode_ms_per_tick": run.get("decode_ms_per_tick"),
           "decode_tok_per_s": run.get("decode_tok_per_s"), **prof,
           "s": time.perf_counter() - t0}
    log(f"  whisper-tiny phase on {card}: {json.dumps(out)}")
    return runs, out


def qwen110b_phase(torch, card):
    """qwen1.5-110b cut to 8 layers at full width (64 heads on 8, G = 8;
    QKV bias; untied head) on phase 5's 16 requests: run(), then dense and
    paged-kernel runs refactored [0, 4] -> [0, 2, 4, 6] at tick 10 and back
    at 30, streams bit-identical and paged == dense; flash 8 per prefill,
    decode (paged decode in the paged run) 8 per decoding tick; decode ==
    forward for requests 8 and 13; three profiled decode ticks; the peak
    device memory."""
    from repro_torch.configs.base import get_arch, shrink

    t0 = time.perf_counter()
    free_weights(torch)
    full = get_arch("qwen1.5-110b").config
    cfg = shrink(full, n_layers=QWEN110B_LAYERS)
    log(f"  qwen1.5-110b: {full.n_layers} layers, {full.param_count()} "
        f"params ({full.param_count() * 4 / 1e9:.1f} GB f32) cut in depth to "
        f"{cfg.n_layers} layers at full width: {cfg.param_count()} params "
        f"({cfg.param_count() * 4 / 1e9:.1f} GB)")
    half = cfg.n_layers // 2
    cfg, params, reqs, runs = serving(
        torch, card, "qwen1.5-110b",
        torch.Generator(device="cuda").manual_seed(0),
        {"dense refactored": {},
         "paged kernel refact.": dict(paged=True, block_size=16,
                                      paged_kernel=True)},
        prefix="qwen110b ", boundaries=(0, half),
        moves={10: [0, half // 2, half, half + half // 2], 30: [0, half]},
        cfg=cfg)
    L = cfg.n_layers
    dense = runs["qwen110b dense refactored"]
    want_launches("the dense refactored run", dense, {
        "flash_attention": L * len(reqs),
        "decode_attention": L * dense["ticks_decoding"],
        "paged_decode_attention": 0})
    paged = runs["qwen110b paged kernel refact."]
    want_launches("the paged kernel run", paged, {
        "flash_attention": L * len(reqs),
        "paged_decode_attention": L * paged["ticks_decoding"],
        "decode_attention": 0})
    decode_equals_forward(torch, cfg, params,
                          [r for r in reqs if r.rid in (8, 13)])
    prof = profile_moe_ticks(torch, cfg, params, (0, half))
    mem = peak_memory(torch, f"qwen1.5-110b ({L} layers)")
    out = {"layers": L, "params": cfg.param_count(),
           "decode_ms_per_tick": dense.get("decode_ms_per_tick"),
           "decode_tok_per_s": dense.get("decode_tok_per_s"),
           "paged_decode_ms_per_tick": paged.get("decode_ms_per_tick"),
           **prof, **mem, "s": time.perf_counter() - t0}
    log(f"  qwen1.5-110b phase on {card}: {json.dumps(out)}")
    return runs, out


# ---------------------------------------------------------------------------
# phase 17: deepseek-v2-236b (MLA) cut in depth
# ---------------------------------------------------------------------------

# 3 of 60 layers at full width: 12.96 B params, 51.9 GB f32 (4 would be
# 67.7 GB, too close to 80 GB beside a 1024-row MoE call's buffers)
DSV2_LAYERS = 3


def time_absorbed_decode(torch, cfg, params):
    """The absorbed MLA decode (torch products; no kernel of the JAX
    package covers it) at the served shape: batch 8 over a 1024-row
    latent cache at phase 5's first 8 prompt lengths, one layer's
    weights, timed as phase 3 times a kernel, beside the bound of the work
    those lengths need (the live latent rows and both up-projections read
    once)."""
    from repro_torch.models.layers import mla_absorbed_decode
    from repro_torch.serving.workload import Request

    m, H, B, Smax = cfg.mla, cfg.n_heads, 8, 1024
    nd, rd, r, vd = (m.nope_head_dim, m.rope_head_dim, m.kv_lora_rank,
                     m.v_head_dim)
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    q_nope, q_rope = rnd(B, 1, H, nd), rnd(B, 1, H, rd)
    lat, kr = rnd(B, Smax, r), rnd(B, Smax, rd)
    p = params["blocks"][0]["mixer"]
    lens = [q.prompt_len for q in make_requests(cfg, Request)[:B]]
    pos = torch.tensor(lens, device="cuda")
    scale = (nd + rd) ** -0.5

    def fn():
        return mla_absorbed_decode(q_nope, q_rope, lat, kr, p["wk_up"],
                                   p["wv_up"], pos, scale)

    ms = time_ms(torch, fn)
    live = sum(lens) + B                        # rows [0, pos] per slot
    nbytes = 4 * (live * (r + rd) + p["wk_up"].numel() + p["wv_up"].numel()
                  + q_nope.numel() + q_rope.numel() + B * H * vd)
    ops = 2 * H * (B * nd * r + live * (r + rd) + live * r + B * r * vd)
    t_bound, by = bound(nbytes, ops, "float32")
    out = {"ms": ms, "bound_ms": t_bound, "bound_by": by,
           "shape": f"B={B} H={H} Smax={Smax} r={r} rd={rd} nd={nd} vd={vd}"
                    f" f32, sum(pos + 1)={live}"}
    log(f"  absorbed MLA decode, one layer: {ms:.4f} ms, bound "
        f"{t_bound:.4f} ms ({by})  [{out['shape']}]")
    return out


def deepseek_v2_phase(torch, card):
    """deepseek-v2-236b cut to 3 layers at full width (MLA with 128 heads;
    160 routed experts top-6 and 2 shared; untied head) on phase 5's 16
    requests: run(), then a run refactored [0, 1] -> [0, 1, 2] at tick 10
    and back at 30, streams bit-identical; flash (at (192, 128)) 3 per
    prefill, decode and paged decode never; decode == forward at capacity
    factor E/K for requests 8 and 13; three profiled decode ticks; the
    absorbed decode timed alone and its share of a tick's device time; the
    peak device memory."""
    from repro_torch.configs.base import get_arch, shrink

    t0 = time.perf_counter()
    free_weights(torch)
    full = get_arch("deepseek-v2-236b").config
    cfg = shrink(full, n_layers=DSV2_LAYERS)
    log(f"  deepseek-v2-236b: {full.n_layers} layers, {full.param_count()} "
        f"params ({full.param_count() * 4 / 1e9:.1f} GB f32) cut in depth to "
        f"{cfg.n_layers} layers at full width: {cfg.param_count()} params "
        f"({cfg.param_count() * 4 / 1e9:.1f} GB)")
    cfg, params, reqs, runs = serving(
        torch, card, "deepseek-v2-236b",
        torch.Generator(device="cuda").manual_seed(0),
        {"dense refactored": {}}, prefix="deepseek-v2 ", boundaries=(0, 1),
        moves={10: [0, 1, 2], 30: [0, 1]}, cfg=cfg)
    L = cfg.n_layers
    for label in ("deepseek-v2 dense run()", "deepseek-v2 dense refactored"):
        want_launches(label, runs[label], {
            "flash_attention": L * len(reqs), "decode_attention": 0,
            "paged_decode_attention": 0})
    decode_equals_forward_no_drop(torch, cfg, params, (8, 13), (0, 1))
    prof = profile_moe_ticks(torch, cfg, params, (0, 1))
    absorbed = time_absorbed_decode(torch, cfg, params)
    if prof.get("busy_ms_per_tick"):
        absorbed["share_of_busy_tick"] = \
            L * absorbed["ms"] / prof["busy_ms_per_tick"]
        log(f"  absorbed decode: {L} x {absorbed['ms']:.4f} ms = "
            f"{absorbed['share_of_busy_tick']:.3f} of the busy tick")
    mem = peak_memory(torch, f"deepseek-v2-236b ({L} layers)")
    dense = runs["deepseek-v2 dense refactored"]
    out = {"layers": L, "params": cfg.param_count(),
           "decode_ms_per_tick": dense.get("decode_ms_per_tick"),
           "decode_tok_per_s": dense.get("decode_tok_per_s"),
           **prof, "absorbed_decode": absorbed, **mem,
           "s": time.perf_counter() - t0}
    check(mem["headroom_bytes"] >= 2 * GiB,
          f"deepseek-v2-236b at {L} layers left {mem['headroom_bytes']} B "
          "free at its peak, under 2 GiB")
    log(f"  deepseek-v2-236b phase on {card}: {json.dumps(out)}")
    return runs, out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 18: training (the backward kernels; qwen1.5-0.5b and rwkv6-1.6b)
# ---------------------------------------------------------------------------

# the backward kernels against autograd through their plain versions, f32,
# on the card: the largest error over every gradient, times the largest
# |gradient| (both sum over hundreds of rows, keys or steps, in other
# orders); 13x the largest an H100 showed (6.6e-7 flash, 7.8e-7 wkv6)
BWD_TOL = 1e-5
# qwen1.5-0.5b's training call (B 4: one of M = 2 microbatches of 8, 16
# heads of 64, causal) and rwkv6-1.6b's (B 4, 32 heads of 64)
FLASH_TRAIN = dict(B=4, S=512, H=16, hd=64)
WKV_TRAIN = dict(B=4, S=512, H=32, hd=64)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=10, total_steps=20)
TRAIN_STEPS = 20
FAULT_AT, CKPT_EVERY = 12, 5
RWKV_TRAIN_STEPS = 5


def _bwd_compare(torch, name, got, ref):
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    top = max(float(r.abs().max()) for r in ref)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    log(f"  {name:24s} float32  max|err| {err:.3e} (tol {BWD_TOL:g} x "
        f"max|grad| {top:.3e})")
    check(finite, f"{name}: non-finite gradient")
    check(err <= BWD_TOL * top, f"{name}: error {err} > {BWD_TOL} x {top}")
    return err, top


def _bwd_kernels_info(torch, lib, fn, smem):
    """Registers, spills and dynamic shared memory of each kernel of a
    backward library (its build log), and each kernel's share of one call's
    device time (torch.profiler over 5 calls)."""
    from repro_torch.kernels import build

    regs = {}
    for name, r in build.ptxas_report(lib).items():
        m = re.search(r"(row_kernel|dkdv_kernel|dq_combine_kernel|"
                      r"dq_bf16_kernel|dkdv_bf16_kernel|wkv6_bwd_kernel|"
                      r"du_sum_kernel)(I\w+)?", name)
        if m:      # the kernel's name and its template's ints
            args = re.findall(r"Li(\d+)E", m.group(2) or "")
            regs[f"{m.group(1)}<{','.join(args)}>"] = dict(r)
    rows, _ = kernel_profile(torch, fn, 5)
    total = sum(r[1] for r in rows) or 1.0
    share = {key[:60]: dict(ms=us / 5e3, share=us / total)
             for key, us, _ in rows}
    log(f"    {lib}: dynamic shared memory {smem}; registers and spills "
        f"{json.dumps(regs)}")
    for key, d in share.items():
        log(f"    {d['ms']:.4f} ms ({d['share']:.3f})  {key}")
    if not rows:
        log("    the profiler saw no device time in this profile: by kernel "
            "not measured (the training runs' profiles split it)")
    return dict(ptxas=regs, dynamic_smem=smem,
                by_kernel=share or "not measured")


def training_kernel_checks(torch):
    """Each backward kernel at its full-width training shape against
    autograd through the plain version on the same inputs: every gradient,
    a second call's bits, and the kernel's, the plain backward's and (for
    flash) SDPA's backward's device times beside the bound; flash also at
    (128, 128) on the same shape beside SDPA's backward; each kernel's
    registers, spills and shared memory, and its share of a call."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv6_wkv as RW

    dev = torch.device("cuda")
    rng = np.random.default_rng(18)

    def rnd(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)

    out = {}
    B, S, H, hd = (FLASH_TRAIN[k] for k in ("B", "S", "H", "hd"))
    q, k, v, do = (rnd((B, S, H, hd)) for _ in range(4))
    scale = 1.0 / math.sqrt(hd)
    with torch.no_grad():
        o = FA.flash_attention(q, k, v)
    args = (q, k, v, o, do, True, 0, scale, 0)
    got = FA._launch_backward(*args)
    ref = FA.flash_attention_bwd_plain(q, k, v, do)
    err, top = _bwd_compare(torch, "flash_attention_bwd", got, ref)
    check(all(torch.equal(a, b) for a, b in
              zip(got, FA._launch_backward(*args))),
          "flash_attention_bwd: two calls gave different bits")
    ms = time_ms(torch, lambda: FA._launch_backward(*args))
    with torch.enable_grad():
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        op = FA.flash_attention_plain(*ins)
        plain = time_ms(torch, lambda: torch.autograd.grad(
            op, ins, do, retain_graph=True), iters=5)
        # SDPA's backward alone, (B, H, S, hd) layout
        sins = [t.transpose(1, 2).contiguous().requires_grad_(True)
                for t in (q, k, v)]
        so = F.scaled_dot_product_attention(*sins, is_causal=True)
        sdo = do.transpose(1, 2).contiguous()
        lib = time_ms(torch, lambda: torch.autograd.grad(
            so, sins, sdo, retain_graph=True))
    del op, so, ins, sins
    pairs = B * H * S * (S + 1) // 2
    # q, k, v, o and dO read once, dq, dk and dv written once; 5 products of
    # hd per visible pair (S, dP, dV, dK, dQ) as 3xTF32
    t_bound, by = bound(8 * B * S * H * hd * 4, 5 * 2 * hd * pairs, "tf32x3")
    shape = f"B={B} Sq=Skv={S} H=Kh={H} hd={hd} causal f32"
    out["flash_attention_bwd"] = dict(
        max_abs_err=err, max_abs_grad=top, ms=ms, plain_ms=plain,
        library_ms=lib, bound_ms=t_bound, bound_by=by, shape=shape)
    log(f"  {'flash_attention_bwd':24s} {ms:.4f} ms  plain {plain:.4f} ms  "
        f"SDPA backward {lib:.4f} ms  bound {t_bound:.4f} ms ({by})  "
        f"[{shape}]")
    geo = FA._bwd_geometry(hd, hd)
    out["flash_attention_bwd"].update(_bwd_kernels_info(
        torch, "flash_attention_bwd", lambda: FA._launch_backward(*args),
        {"dkdv_kernel": geo.smem, "row_kernel": geo.row_smem,
         "dq_combine_kernel": 0}))
    del args, q, k, v, do, o
    # the design's second template: (128, 128), query tiles of 32
    q, k, v, do = (rnd((B, S, H, 128)) for _ in range(4))
    with torch.no_grad():
        o = FA.flash_attention(q, k, v)
    args = (q, k, v, o, do, True, 0, 1.0 / math.sqrt(128), 0)
    got = FA._launch_backward(*args)
    err128, top128 = _bwd_compare(torch, "flash_attention_bwd (128)", got,
                                  FA.flash_attention_bwd_plain(q, k, v, do))
    ms128 = time_ms(torch, lambda: FA._launch_backward(*args))
    with torch.enable_grad():
        sins = [t.transpose(1, 2).contiguous().requires_grad_(True)
                for t in (q, k, v)]
        so = F.scaled_dot_product_attention(*sins, is_causal=True)
        sdo = do.transpose(1, 2).contiguous()
        lib128 = time_ms(torch, lambda: torch.autograd.grad(
            so, sins, sdo, retain_graph=True))
    del so, sins
    b128, by128 = bound(8 * B * S * H * 128 * 4, 5 * 2 * 128 * pairs,
                        "tf32x3")
    out["flash_attention_bwd"]["hd128"] = dict(
        ms=ms128, library_ms=lib128, bound_ms=b128, bound_by=by128,
        max_abs_err=err128, max_abs_grad=top128,
        shape=f"B={B} Sq=Skv={S} H=Kh={H} hd=128 causal f32")
    log(f"  {'flash_attention_bwd (128)':24s} {ms128:.4f} ms  SDPA backward "
        f"{lib128:.4f} ms  bound {b128:.4f} ms ({by128})")
    del args, q, k, v, do, o, got

    B, S, H, hd = (WKV_TRAIN[k] for k in ("B", "S", "H", "hd"))
    r, kk, vv = (rnd((B, S, H, hd), 0.5) for _ in range(3))
    w = torch.sigmoid(rnd((B, S, H, hd))) * 0.5 + 0.45
    u = rnd((H, hd), 0.1)
    st0 = rnd((B, H, hd, hd))
    dy = rnd((B, S, H, hd))
    wargs = (r, kk, vv, w, u, st0, dy, None)
    got = RW._launch_backward(*wargs)
    ref = RW.wkv6_bwd_plain(*wargs)
    err, top = _bwd_compare(torch, "wkv6_bwd", got, ref)
    check(all(torch.equal(a, b) for a, b in
              zip(got, RW._launch_backward(*wargs))),
          "wkv6_bwd: two calls gave different bits")
    ms = time_ms(torch, lambda: RW._launch_backward(*wargs))
    plain = time_ms(torch, lambda: RW.wkv6_bwd_plain(*wargs), iters=2,
                    warmup=1)
    n = B * S * H * hd
    # r, k, v, w and dy read, dr, dk, dv and dw written, u, du, state0 and
    # dstate0; 14 flops per state element and step (the state recomputed:
    # a product and a multiply-add; the backward step: five multiply-adds
    # and a product)
    t_bound, by = bound((9 * n + 2 * H * hd + 2 * B * H * hd * hd) * 4,
                        14 * B * H * hd * hd * S, "float32")
    shape = f"B={B} S={S} H={H} hd={hd} f32, state0"
    out["wkv6_bwd"] = dict(
        max_abs_err=err, max_abs_grad=top, ms=ms, plain_ms=plain,
        library_ms=None, bound_ms=t_bound, bound_by=by, shape=shape)
    log(f"  {'wkv6_bwd':24s} {ms:.4f} ms  plain {plain:.4f} ms (forward "
        f"and backward, host-bound)  library n/a  bound {t_bound:.4f} ms "
        f"({by})  [{shape}]")
    geo = RW._bwd_geometry(hd)
    out["wkv6_bwd"].update(_bwd_kernels_info(
        torch, "rwkv6_wkv_bwd", lambda: RW._launch_backward(*wargs),
        {"wkv6_bwd_kernel": geo.smem, "du_sum_kernel": 0}))
    out["wkv6_bwd"]["geometry"] = geo._asdict()
    return out


def _train_setup(torch, cfg, plan, seq, batch, device, generator,
                 bf16=False):
    """Params, optimizer state, step and data of a one-rank train run: f32,
    or (``bf16``) at build_train_step's default dtype, bf16, from the same
    f32 draws rounded to bf16."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.pipeline import build_train_step, stack_params
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.tree import tree_map

    params = stack_params(cfg, plan, init_model(cfg, generator,
                                                device=device))
    if bf16:
        params = tree_map(lambda t: t.to(torch.bfloat16), params)
    opt = init_opt_state(params)
    kw = {} if bf16 else {"param_dtype": torch.float32}
    step, structs = build_train_step(
        cfg, plan, None, ShapeConfig("train", seq, batch, "train"),
        AdamWConfig(**TRAIN_OPT), **kw)
    want = torch.bfloat16 if bf16 else torch.float32
    check(all(s.dtype == want for s in tree_leaves(structs["params"])),
          f"train step: params are not {want}")
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch, seed=0))
    return params, opt, step, data


def _batch(torch, data, i, device):
    b = data.batch(i)
    return {k: torch.from_numpy(b[k]).to(device) for k in ("tokens",
                                                           "labels")}


def train_card_vs_cpu(torch):
    """One train step of qwen1.5-0.5b at full width cut to 2 layers (B 2,
    S 128, M 2, remat on) on the card and on the CPU from the same params:
    loss, grad norm and every param after the update.  Adam's first step
    moves each element by lr_1 (1 + wd |p|) times the sign of its gradient
    (m/sqrt(v) = g/|g|), so an element whose gradient is near zero may move
    the other way on the other device: params are held to 2.5 lr_1, and the
    share of elements differing by more than 1e-6 is reported."""
    from repro_torch.configs.base import PipelinePlan, get_arch, shrink
    from repro_torch.training.optimizer import AdamWConfig, schedule
    from repro_torch.tree import tree_leaves

    cfg = shrink(get_arch("qwen1.5-0.5b").config, n_layers=2)
    plan = PipelinePlan(microbatches=2, remat=True)
    res = {}
    for dev in ("cpu", "cuda"):
        params, opt, step, data = _train_setup(
            torch, cfg, plan, 128, 2, dev, torch.Generator().manual_seed(0))
        params, opt, m = step(params, opt, _batch(torch, data, 0, dev))
        res[dev] = (params, {k: float(v) for k, v in m.items()})
    lr1 = float(schedule(AdamWConfig(**TRAIN_OPT), 1))
    a, b = res["cpu"][1], res["cuda"][1]
    d_max, n_off, n_all = 0.0, 0, 0
    for pc, pg in zip(tree_leaves(res["cpu"][0]), tree_leaves(res["cuda"][0])):
        d = (pc - pg.cpu()).abs()
        d_max = max(d_max, float(d.max()))
        n_off += int((d > 1e-6).sum())
        n_all += d.numel()
    out = {"loss_cpu": a["loss"], "loss_cuda": b["loss"],
           "grad_norm_cpu": a["grad_norm"], "grad_norm_cuda": b["grad_norm"],
           "param_max_abs_diff": d_max, "lr_1": lr1,
           "param_share_over_1e-6": n_off / n_all}
    log(f"  card vs CPU (2 layers, B 2, S 128): {json.dumps(out)}")
    check(abs(a["loss"] - b["loss"]) <= 1e-5 * abs(a["loss"]),
          "train step: loss on the card differs from the CPU's")
    check(abs(a["grad_norm"] - b["grad_norm"]) <= 1e-4 * a["grad_norm"],
          "train step: grad norm on the card differs from the CPU's")
    check(d_max <= 2.5 * lr1, f"train step: params differ by {d_max}")
    return out


def train_run(torch, card, label, cfg, plan, seq, batch, steps, want,
              bf16=False):
    """``steps`` train steps from seeded params on the card (f32, or bf16:
    ``_train_setup``): every loss finite, the launches per step of each
    kernel as ``want`` says, ms per step and tokens/s (host clock around
    synchronized steps), device busy and idle share over one profiled step,
    peak memory.  Returns (losses, info, setup)."""
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    free_weights(torch)
    params, opt, step, data = _train_setup(
        torch, cfg, plan, seq, batch, dev,
        torch.Generator(device="cuda").manual_seed(0), bf16)
    batches = [_batch(torch, data, i, dev) for i in range(steps)]
    torch.cuda.synchronize()
    build.reset_launches()
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[i])
        losses.append(float(m["loss"]))          # waits for the step
        times.append(time.perf_counter() - t0)
    launches = dict(build.launches)
    for name, per_step in want.items():
        n = launches.get(name, 0)
        log(f"  {label}: {name} launches {n} = {steps} x {per_step}")
        check(n == steps * per_step,
              f"{label}: {name} launched {n} times, not {steps} x "
              f"{per_step}")
    check(all(math.isfinite(x) for x in losses),
          f"{label}: a non-finite loss: {losses}")
    ms = 1e3 * float(np.median(times[1:]))
    info = {"steps": steps, "losses": losses, "ms_per_step": ms,
            "tok_per_s": batch * seq / ms * 1e3,
            "launches": {k: v for k, v in launches.items() if v}}
    last = batches[-1]
    rows, wall_us = kernel_profile(torch, lambda: step(params, opt, last), 1)
    busy_us = sum(r[1] for r in rows)
    if rows:
        info.update(profiled_ms_per_step=wall_us / 1e3,
                    busy_ms_per_step=busy_us / 1e3,
                    idle_share=1 - busy_us / wall_us)
        ours = ("flash_kernel", "flash_wgmma_kernel", "row_kernel",
                "dkdv_kernel", "dq_bf16_kernel", "dkdv_bf16_kernel",
                "dq_combine_kernel", "wkv6_kernel", "wkv6_bwd_kernel")
        for i, (key, us, n) in enumerate(rows):
            if i < 8 or any(k in key for k in ours):
                log(f"    {us / 1e3:10.3f} ms {n:6d}x  {key[:80]}")
        info["by_kernel"] = [(key, us / 1e3, n) for key, us, n in rows[:20]]
        # each backward kernel's share of its backward's device time in
        # the step: the flash backward's row pass, main kernel and combine
        for name, parts in (("flash_attention_bwd", ("row_kernel",
                                                     "dkdv_kernel",
                                                     "dq_combine_kernel")),
                            ("wkv6_bwd", ("wkv6_bwd_kernel",
                                          "du_sum_kernel"))):
            us = {k: sum(u for key, u, _ in rows if f"::{k}<" in key
                         or f"::{k}(" in key) for k in parts}
            tot = sum(us.values())
            if tot > 0:
                info[f"{name}_split"] = {k: dict(ms=u / 1e3, share=u / tot)
                                         for k, u in us.items()}
                log(f"    {name} in the step: " + ", ".join(
                    f"{k} {u / 1e3:.3f} ms ({u / tot:.3f})"
                    for k, u in us.items()))
    else:
        log("  profiler saw no device time: busy and idle not measured")
    info.update(peak_memory(torch, label))
    log(f"  {label} on {card}: " + json.dumps(
        {k: v for k, v in info.items() if k != "by_kernel"}))
    return losses, info, (params, opt, step, batches)


def supervised_run(torch, cfg, plan, seq, batch, ref_losses):
    """The same run under TrainSupervisor, a checkpoint every CKPT_EVERY
    steps (params and optimizer state, in the reference's format, under
    build/), a fault injected at step FAULT_AT: each step after the
    restore must give the uninterrupted run's loss."""
    import shutil

    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.fault_tolerance import TrainSupervisor

    dev = torch.device("cuda")
    free_weights(torch)
    params, opt, step, data = _train_setup(
        torch, cfg, plan, seq, batch, dev,
        torch.Generator(device="cuda").manual_seed(0))
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    sup = TrainSupervisor(ckpt_dir=str(ckpt_dir), ckpt_every=CKPT_EVERY)
    losses: dict = {}
    t_io = [0.0]

    def one_step(state, i):
        p, o = state
        p, o, m = step(p, o, _batch(torch, data, i, dev))
        losses.setdefault(i, []).append(float(m["loss"]))
        return (p, o)

    def save(state, i):
        t0 = time.perf_counter()
        ckpt.save(str(ckpt_dir), state, step=i)
        t_io[0] += time.perf_counter() - t0

    def restore():
        # a second restore would mean a real failure: let it through
        check(sup.restarts <= 1, "train supervisor: more than one restart")
        t0 = time.perf_counter()
        state, i, _ = ckpt.restore(str(ckpt_dir), (params, opt))
        t_io[0] += time.perf_counter() - t0
        return state, i

    t0 = time.perf_counter()
    state, n = sup.run(n_steps=TRAIN_STEPS, step_fn=one_step,
                       state=(params, opt), save_fn=save, restore_fn=restore,
                       inject_fault_at=FAULT_AT)
    wall = time.perf_counter() - t0
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    restored_at = FAULT_AT - FAULT_AT % CKPT_EVERY
    replayed = [i for i in sorted(losses) if len(losses[i]) > 1]
    last = [losses[i][-1] for i in range(TRAIN_STEPS)]
    bits = all(last[i] == ref_losses[i] for i in range(TRAIN_STEPS))
    out = {"steps": n, "restarts": sup.restarts, "restored_at": restored_at,
           "replayed_steps": replayed, "losses_equal_bits": bits,
           "checkpoint_io_s": t_io[0], "wall_s": wall}
    log(f"  supervised run: {json.dumps(out)}")
    check(n == TRAIN_STEPS and sup.restarts == 1,
          "train supervisor: not one restart")
    check(replayed == list(range(restored_at, FAULT_AT)),
          f"train supervisor: replayed {replayed}")
    for i in range(TRAIN_STEPS):
        check(abs(last[i] - ref_losses[i]) <= 1e-6 * abs(ref_losses[i]),
              f"train supervisor: step {i} loss {last[i]} != "
              f"{ref_losses[i]}")
    return out


def training_phase(torch, card):
    """Phase 18: the port's one-rank train step on the card.  qwen1.5-0.5b
    at full width cut to 2 layers against the CPU; at full width and depth
    (24 layers, B 8, seq 512, M 2, remat, f32) for TRAIN_STEPS steps, its
    loss falling, flash forward 24 x M x 2 launches a step (remat runs each
    tick's forward again), the flash backward 24 x M, no decode; the same
    run under TrainSupervisor with a fault; rwkv6-1.6b at full width (24
    layers, B 4, seq 512, M 1) for a few steps, wkv6's backward 24 a
    step."""
    from repro_torch.configs.base import PipelinePlan, get_arch

    t0 = time.perf_counter()
    free_weights(torch)
    out = {"card_vs_cpu": train_card_vs_cpu(torch)}
    cfg = get_arch("qwen1.5-0.5b").config
    plan = PipelinePlan(microbatches=2, remat=True)
    L, M = cfg.n_layers, plan.microbatches
    losses, info, setup = train_run(
        torch, card, "qwen1.5-0.5b train", cfg, plan, 512, 8, TRAIN_STEPS, {"flash_attention": L * M * 2,
                      "flash_attention_bwd": L * M, "decode_attention": 0,
                      "paged_decode_attention": 0})
    del setup
    first, tail = losses[0], float(np.mean(losses[-5:]))
    log(f"  qwen1.5-0.5b losses: {losses}")
    check(tail < first, f"qwen1.5-0.5b: the last 5 steps' mean loss {tail} "
          f"is not below step 0's {first}")
    out["qwen"] = info
    out["supervised"] = supervised_run(torch, cfg, plan, 512, 8, losses)
    cfg = get_arch("rwkv6-1.6b").config
    plan = PipelinePlan(microbatches=1, remat=True)
    losses, info, setup = train_run(
        torch, card, "rwkv6-1.6b train", cfg, plan, 512, 4, RWKV_TRAIN_STEPS, {"wkv6": cfg.n_layers * 2,
                           "wkv6_bwd": cfg.n_layers})
    del setup
    out["rwkv6"] = info
    free_weights(torch)
    out["s"] = time.perf_counter() - t0
    log(f"  phase 18 on {card}: {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 19: multi-rank execution, 4 ranks sharing the card
# ---------------------------------------------------------------------------

# full-width qwen1.5-0.5b (24 layers, its 151,936-token vocabulary split over
# S x T = 4) at S = 2, T = 2, M = 2 on a (data 1, model 4) mesh of 4 rank
# processes on cuda:0.  NCCL refuses two ranks on one device, so the world
# runs gloo, named; gloo reduces CUDA tensors itself and every other
# collective (the stage rotation's sends, the gathers) is staged through
# pinned host memory.  Times here are not multi-GPU times.
PAR_RANKS = 4
PAR_PLAN = dict(stages=2, tensor=2, replica=1, microbatches=2)
PAR_B, PAR_SQ, PAR_DECODE, PAR_STEPS = 8, 512, 16, 5
PAR_LABEL = "4 ranks on one card, gloo through host memory"
# the 4-rank logits against the one-rank path's on the same card and
# weights: the tensor-parallel psums and the vocab shards' sums run in other
# orders than one rank's (f32); 5.7x the largest error an H100 showed over
# the prefill and 16 decode steps (1.75e-5)
PAR_LOGIT_TOL = 1e-4
PAR_TIMEOUT_S = 600.0


def _par_shapes():
    from repro_torch.configs.base import ShapeConfig
    return (ShapeConfig("p", PAR_SQ + PAR_DECODE, PAR_B, "prefill"),
            ShapeConfig("d", PAR_SQ + PAR_DECODE, PAR_B, "decode"),
            ShapeConfig("t", PAR_SQ, PAR_B, "train"))


def _par_batches(torch, cfg, device):
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=PAR_SQ, global_batch=PAR_B,
                                    seed=0))
    return [_batch(torch, data, i, device) for i in range(PAR_STEPS)]


def parallel_reference(torch):
    """The one-rank path on the card, from the same seeded weights: a
    prefill of B 8 x 512 seeded tokens, 16 greedy decode steps, and
    PAR_STEPS train steps (remat); logits, fed tokens, top-2 margins,
    losses and grad norms, with ms per decode and train step."""
    from repro_torch.configs.base import PipelinePlan, get_arch
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.pipeline import (build_decode_step,
                                               build_prefill_step,
                                               build_train_step,
                                               stack_params)
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state

    dev = torch.device("cuda")
    cfg = get_arch("qwen1.5-0.5b").config
    f32 = torch.float32
    one = PipelinePlan(microbatches=PAR_PLAN["microbatches"])
    ps, ds, ts = _par_shapes()
    params = stack_params(cfg, one, init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), f32, dev))
    rng = np.random.default_rng(19)
    tokens = rng.integers(0, cfg.vocab_size, (PAR_B, PAR_SQ)).astype(
        np.int32)
    pre, _ = build_prefill_step(cfg, one, None, ps, f32, cache_dtype=f32)
    dec, _ = build_decode_step(cfg, one, None, ds, f32, cache_dtype=f32)
    last, caches = pre(params, {"tokens": torch.from_numpy(tokens).to(dev)})
    logits, fed, times = [last.cpu().numpy()], [], []
    for i in range(PAR_DECODE):
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        fed.append(tok.cpu().numpy())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, caches = dec(params, caches, tok, PAR_SQ + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        logits.append(last.cpu().numpy())
    del caches
    top2 = [np.sort(x, axis=-1)[:, -2:] for x in logits]
    margins = [t[:, 1] - t[:, 0] for t in top2]
    step, _ = build_train_step(cfg, PipelinePlan(
        microbatches=PAR_PLAN["microbatches"], remat=True), None, ts,
        AdamWConfig(**TRAIN_OPT), param_dtype=f32)
    opt = init_opt_state(params)
    losses, gnorms, ttimes = [], [], []
    for b in _par_batches(torch, cfg, dev):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        ttimes.append(time.perf_counter() - t0)
    del params, opt
    free_weights(torch)
    return {"tokens": tokens, "logits": logits, "fed": fed,
            "margins": margins, "losses": losses, "grad_norms": gnorms,
            "decode_ms": 1e3 * float(np.median(times)),
            "train_ms": 1e3 * float(np.median(ttimes[1:]))}


def _capture(torch, calls, L, stage):
    """Wrap the model's flash and decode entry points to keep in ``calls``
    (cloned) the inputs of one call of each kind from this rank's first
    real tick, tick == stage index: at an earlier tick a later stage runs
    on the zero state, whose v is constant along the sequence, so its
    attention returns v and its dQ and dK are 0, which no kernel fault
    would change.  Each pass (the prefill, a decode step, a train step's
    forward) calls each of the stage's L layers once a tick, from tick 0."""
    from repro_torch.models import layers
    seen = {}

    def wrap(name, fn):
        def wrapped(*a, **kw):
            key = name + ("_train" if torch.is_grad_enabled() and
                          a[0].requires_grad else "")
            n = seen[key] = seen.get(key, -1) + 1
            if n // L == stage and key not in calls:
                calls[key] = ([x.detach().clone() if torch.is_tensor(x)
                               else x for x in a], dict(kw))
            return fn(*a, **kw)
        return wrapped

    layers.flash_attention = wrap("flash_attention", layers.flash_attention)
    layers.decode_attention = wrap("decode_attention",
                                   layers.decode_attention)


def _varies(x, dim):
    """Whether ``x`` differs anywhere along ``dim``."""
    return bool((x - x.narrow(dim, 0, 1)).abs().amax() > 0)


def _served_holds(torch, calls):
    """Each captured call through its kernel and its plain version: the
    largest error (forward) or the largest error over the gradients (the
    flash backward, autograd through the plain version)."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA

    out = {}
    (q, k, v), kw = calls["flash_attention"]
    check(all(_varies(x, 1) for x in (q, k, v)),
          "phase 19: the served flash call's q, k or v is constant along "
          "the sequence")
    with torch.no_grad():
        got = FA.flash_attention(q, k, v, **kw)
        ref = FA.flash_attention_plain(q, k, v, **kw)
    out["flash_attention"] = float((got - ref).abs().max())
    a, _ = calls["decode_attention"]
    check(_varies(a[0], 0) and _varies(a[2], 2),
          "phase 19: the served decode call's q is constant over the batch "
          "or its v cache along the sequence")
    with torch.no_grad():
        got = DA.decode_attention(*a)
        ref = DA.decode_attention_plain(*a)
    out["decode_attention"] = float((got - ref).abs().max())
    (q, k, v), kw = calls["flash_attention_train"]
    check(all(_varies(x, 1) for x in (q, k, v)),
          "phase 19: the trained flash call's q, k or v is constant along "
          "the sequence")
    rng = np.random.default_rng(20)
    do = torch.from_numpy(rng.standard_normal(q.shape[:-1] + (
        v.shape[-1],)).astype(np.float32)).to(q.device)
    with torch.no_grad():
        o = FA.flash_attention(q, k, v, **kw)
    scale = kw.get("scale") or 1.0 / math.sqrt(q.shape[-1])
    got = FA._launch_backward(q, k, v, o, do, kw.get("causal", True),
                              kw.get("window", 0), scale,
                              kw.get("q_offset") or 0)
    ref = FA.flash_attention_bwd_plain(q, k, v, do, causal=kw.get(
        "causal", True), window=kw.get("window", 0), scale=kw.get("scale"),
        q_offset=kw.get("q_offset"))
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    top = max(float(r.abs().max()) for r in ref)
    out["flash_attention_bwd"] = err
    out["flash_attention_bwd_max_abs_grad"] = top
    return out


def parallel_rank(rank, world, device, ref):
    """One rank of phase 19: its shards of the weights, the prefill, the
    decode steps (fed the one-rank path's tokens) and the train steps,
    each of its kernel launches and collectives counted from 0 just before
    and read just after; then one served call of each kernel against its
    plain version.  Rank 0 also gathers the logits and compares them."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    check(not bad, f"rank {rank} imported {bad[:5]}")
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.base import PipelinePlan, get_arch
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel import comm
    from repro_torch.parallel.pipeline import (build_decode_step,
                                               build_prefill_step,
                                               build_train_step,
                                               stack_params)
    from repro_torch.parallel.sharding import shard, unshard
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state

    build.load_all()                     # the parent built every library
    f32 = torch.float32
    cfg = get_arch("qwen1.5-0.5b").config
    base = make_local_mesh(1, world, device)
    ps, ds, ts = _par_shapes()
    plan = PipelinePlan(**PAR_PLAN)
    pre, pst = build_prefill_step(cfg, plan, base, ps, f32, cache_dtype=f32)
    dec, dst = build_decode_step(cfg, plan, base, ds, f32, cache_dtype=f32)
    mesh = pst["mesh"]
    g = stack_params(cfg, plan, init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), f32, device))
    params = shard(g, pst["pspecs"], mesh)
    del g
    torch.cuda.empty_cache()
    calls = {}
    _capture(torch, calls, cfg.n_layers // plan.stages, mesh.index("stage"))
    out = {"rank": rank, "coords": mesh.coords}

    def counts():
        c = {"launches": {k: v for k, v in build.launches.items() if v},
             "comm": comm.stats()}
        build.reset_launches()
        comm.reset_stats()
        return c

    tokens = torch.from_numpy(ref["tokens"]).to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts()
    t0 = time.perf_counter()
    last, caches = pre(params, {"tokens": tokens})
    torch.cuda.synchronize()
    out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    local, times = [last], []
    for i in range(PAR_DECODE):
        tok = torch.from_numpy(ref["fed"][i]).to(device)
        t0 = time.perf_counter()
        lg, caches = dec(params, caches, tok, PAR_SQ + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        local.append(lg)
    out["serve"] = counts()
    out["decode_ms"] = 1e3 * float(np.median(times))
    del caches
    step, _ = build_train_step(cfg, PipelinePlan(**PAR_PLAN, remat=True),
                               base, ts, AdamWConfig(**TRAIN_OPT),
                               param_dtype=f32)
    opt = init_opt_state(params)
    batches = _par_batches(torch, cfg, device)
    torch.cuda.synchronize()
    counts()
    losses, gnorms, ttimes = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        ttimes.append(time.perf_counter() - t0)
    out["train"] = counts()
    out.update(losses=losses, grad_norms=gnorms,
               train_ms=1e3 * float(np.median(ttimes[1:])),
               peak_allocated_bytes=torch.cuda.max_memory_allocated())
    out["served_holds"] = _served_holds(torch, calls)
    errs, wrong, held = [], 0, 0
    for i, lg in enumerate(local):
        full = unshard(lg, pst["lspec"], mesh).cpu().numpy()
        if rank == 0:
            errs.append(float(np.abs(full - ref["logits"][i]).max()))
            if i < PAR_DECODE:
                want = ref["fed"][i][:, 0]
                sure = ref["margins"][i] > MARGIN_TOL
                held += int(sure.sum())
                wrong += int((full.argmax(-1) != want)[sure].sum())
    out.update(logit_errors=errs, greedy_held=held, greedy_wrong=wrong)
    return out


def parallel_phase(torch, card, backend="gloo"):
    """Phase 19: multi-rank execution.  The one-rank reference runs here
    on cuda:0; then PAR_RANKS rank processes (spawned, the backend named,
    every kernel built here first: the ranks only load build/kernels), each
    importing repro_torch alone, sit on cuda:(rank % device_count): under
    gloo they share one card, under nccl each needs its own.  A failing
    rank or a world past its time fails the phase."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.mesh import run_world

    cards = torch.cuda.device_count()
    label = PAR_LABEL if backend == "gloo" and cards == 1 else (
        f"{PAR_RANKS} ranks on {cards} cards, {backend}"
        + (" through host memory" if backend == "gloo" else ""))
    t0 = time.perf_counter()
    free_weights(torch)
    ref = parallel_reference(torch)
    log(f"  one rank on {card}: decode {ref['decode_ms']:.3f} ms a step, "
        f"train {ref['train_ms']:.3f} ms a step, losses {ref['losses']}")
    t1 = time.perf_counter()
    ranks = run_world(parallel_rank, PAR_RANKS, (ref,), backend=backend,
                      device=None, timeout_s=PAR_TIMEOUT_S)
    world_s = time.perf_counter() - t1
    r0 = ranks[0]
    L = get_arch("qwen1.5-0.5b").config.n_layers // PAR_PLAN["stages"]
    M = PAR_PLAN["microbatches"]
    ticks = M + PAR_PLAN["stages"] - 1
    want_serve = {"flash_attention": ticks * L,
                  "decode_attention": PAR_DECODE * ticks * L}
    want_train = {"flash_attention": PAR_STEPS * ticks * L * 2,
                  "flash_attention_bwd": PAR_STEPS * ticks * L}
    for r in ranks:
        log(f"  rank {r['rank']} {r['coords']} ({label}): " + json.dumps(
            {k: r[k] for k in ("serve", "train", "prefill_ms", "decode_ms",
                               "train_ms", "peak_allocated_bytes",
                               "served_holds")}))
        for part, want in (("serve", want_serve), ("train", want_train)):
            got = r[part]["launches"]
            for name, n in want.items():
                check(got.get(name, 0) == n,
                      f"phase 19 rank {r['rank']}: {name} launched "
                      f"{got.get(name, 0)} times in {part}, not {n}")
            check(got.get("paged_decode_attention", 0) == 0,
                  "phase 19: paged decode launched")
        if backend == "gloo":
            check(r["serve"]["comm"].get("bytes_staged", 0) > 0,
                  "phase 19: no collective was staged through host memory")
        h = r["served_holds"]
        for name in ("flash_attention", "decode_attention"):
            check(h[name] <= TOL["float32"],
                  f"phase 19 rank {r['rank']}: served {name} off its plain "
                  f"version by {h[name]}")
        check(h["flash_attention_bwd"] <= BWD_TOL * h[
            "flash_attention_bwd_max_abs_grad"],
              f"phase 19 rank {r['rank']}: flash backward off by "
              f"{h['flash_attention_bwd']}")
        check(r["losses"] == r0["losses"], "phase 19: ranks' losses differ")
    err = max(r0["logit_errors"])
    log(f"  4-rank logits against one rank: max|err| {err:.3e} over the "
        f"prefill and {PAR_DECODE} decode steps (tol {PAR_LOGIT_TOL:g}); "
        f"greedy tokens equal at {r0['greedy_held'] - r0['greedy_wrong']} "
        f"of {r0['greedy_held']} rows with a top-2 margin over "
        f"{MARGIN_TOL:g}")
    check(err <= PAR_LOGIT_TOL, f"phase 19: logits off by {err}")
    check(r0["greedy_wrong"] == 0, "phase 19: a greedy token differs")
    l0, l1 = r0["losses"][0], ref["losses"][0]
    ratio = r0["grad_norms"][0] / ref["grad_norms"][0]
    log(f"  train: losses {r0['losses']} (one rank {ref['losses']}); step-0 "
        f"grad norm {r0['grad_norms'][0]:.4f} = {ratio:.5f} x one rank's "
        f"(the reference's psum-transpose count, ROADMAP.md section 3)")
    check(abs(l0 - l1) <= 1e-4 * abs(l1), f"phase 19: step-0 loss {l0} != "
          f"{l1}")
    check(abs(ratio - PAR_RANKS) <= 1e-3 * PAR_RANKS,
          f"phase 19: grad norm ratio {ratio}, not {PAR_RANKS}")
    check(r0["losses"][-1] < r0["losses"][0], "phase 19: the loss did not "
          "fall")
    out = {"ranks": ranks, "one_rank": {k: ref[k] for k in (
        "decode_ms", "train_ms", "losses", "grad_norms", "tokens", "fed",
        "logits")},
        "logit_max_abs_err": err, "world_s": world_s,
        "s": time.perf_counter() - t0, "label": label}
    log(f"  phase 19 on {card} ({label}): world {world_s:.1f} s, "
        f"phase {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: decode over caches narrower than the query, and the roofline
# ---------------------------------------------------------------------------

PAIR_QDTS = ("float32", "bfloat16")
PAIR_CDTS = ("float32", "bfloat16", "float8_e4m3fn")
_RAGGED = [1024, 1, 17, 512, 600, 333, 1000, 64]
PAIR_SHAPES = {  # name: (B, H, Kh, hd, Smax, cache_len)
    "qwen1.5-0.5b": (8, 16, 16, 64, 1024, _RAGGED),
    "qwen1.5-110b G=8": (8, 64, 8, 128, 1024,
                         [0, 1, 127, 128, 129, 257, 1024, 600]),
    "gemma3-1b hd=256": (8, 4, 1, 256, 1024, _RAGGED),
}
# a served decode call is taken at this tick, or decode step, of its path
# (every slot is decoding by then), from its middle layer: past layer 0, q
# depends on each slot's cache, not only on its token and position
KV_HOLD_TICK = 5


def _pair_hold(torch, out, ref, qdt):
    """The largest error of ``out`` against ``ref``, failing beyond the
    tolerance of q's dtype (for bf16, beyond a one-ulp flip of the final
    rounding, as phase 3)."""
    diff = (out.float() - ref.float()).abs()
    over = diff > TOL[qdt]
    if qdt == "bfloat16":
        near = (out.view(torch.int16).int()
                - ref.view(torch.int16).int()).abs() <= 1
        over &= ~near
    check(bool(torch.isfinite(out.float()).all()), "non-finite output")
    check(not bool(over.any()), f"error {float(diff.max())} > {TOL[qdt]}")
    return float(diff.max())


def decode_pair_checks(torch, card):
    """Phase 20 (a): dense and paged decode over every (q, cache) pair of
    {f32, bf16} x {f32, bf16, fp8} at qwen1.5-0.5b's, qwen1.5-110b's (G =
    8) and gemma3-1b's (hd 256, the cluster core) decode shapes: each
    against its plain version, paged == the dense kernel on the gathered
    view bit for bit, and each timed beside its bytes bound and its plain
    version (the bound halves from bf16 to fp8 and quarters from f32)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, gather_pages,
        WIDE_HD, core, paged_decode_attention, paged_decode_attention_plain)
    import torch.nn.functional as F
    dev = torch.device("cuda")
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn}
    rng = np.random.default_rng(20)
    out = {}
    for shape, (B, H, Kh, hd, Smax, lens) in PAIR_SHAPES.items():
        bs = 16
        M = Smax // bs
        n_blocks = 1 + B * M
        f32 = {k: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dev) for k, s in (
            ("q", (B, H, hd)), ("k", (B, Kh, Smax, hd)),
            ("v", (B, Kh, Smax, hd)), ("kp", (n_blocks, Kh, bs, hd)),
            ("vp", (n_blocks, Kh, bs, hd)))}
        perm = rng.permutation(np.arange(1, n_blocks))
        tables = np.zeros((B, M), np.int32)
        i = 0
        for b, n in enumerate(lens):
            nb = -(-n // bs)
            tables[b, :nb] = perm[i:i + nb]
            i += nb
        bt = torch.from_numpy(tables).to(dev)
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        live = int(sum(lens))
        for qdt in PAIR_QDTS:
            q = f32["q"].to(dts[qdt])
            for cdt in PAIR_CDTS:
                kc, vc, kp, vp = (f32[x].to(dts[cdt]) for x in
                                  ("k", "v", "kp", "vp"))
                label = f"{shape} q={qdt} cache={cdt}"
                try:
                    dense = decode_attention(q, kc, vc, cl)
                    err = _pair_hold(torch, dense, decode_attention_plain(
                        q, kc, vc, cl), qdt)
                    paged = paged_decode_attention(q, kp, vp, bt, cl)
                    perr = _pair_hold(torch, paged,
                                      paged_decode_attention_plain(
                                          q, kp, vp, bt, cl), qdt)
                    gathered = decode_attention(q, gather_pages(kp, bt),
                                                gather_pages(vp, bt), cl)
                    torch.cuda.synchronize()
                    check(torch.equal(paged, gathered), "paged != dense")
                    mirror = None
                    if hd < WIDE_HD:
                        # a tile core: its mirror, NaN in the dead rows, and
                        # a second call's bits
                        mirror = tile_holds(torch, q, kc, vc, cl, qdt, label)
                        again = (decode_attention(q, kc, vc, cl),
                                 paged_decode_attention(q, kp, vp, bt, cl))
                        torch.cuda.synchronize()
                        check(torch.equal(again[0], dense)
                              and torch.equal(again[1], paged),
                              "a second call differs")
                except SmokeFailure as e:
                    raise SmokeFailure(f"phase 20 {label}: {e}") from None
                es = kc.element_size()
                nbytes = (B * H * hd * 2 * q.element_size()
                          + live * Kh * 2 * hd * es + B * 4)
                t_bound, by = bound(nbytes, 2 * H * live * 2 * hd,
                                    "float32")
                r = {"max_abs_err": err, "paged_max_abs_err": perr,
                     "max_abs_err_vs_mirror": mirror,
                     "kernel": core(hd, H // Kh),
                     "ms": time_ms(torch, lambda: decode_attention(
                         q, kc, vc, cl)),
                     "paged_ms": time_ms(torch, lambda: paged_decode_attention(
                         q, kp, vp, bt, cl)),
                     "plain_ms": time_ms(torch, lambda: decode_attention_plain(
                         q, kc, vc, cl), iters=5),
                     "paged_plain_ms": time_ms(
                         torch, lambda: paged_decode_attention_plain(
                             q, kp, vp, bt, cl), iters=5),
                     "bound_ms": t_bound, "bound_by": by,
                     "library_ms": None}
                if qdt == cdt:
                    # SDPA's masked call (GQA heads by enable_gqa), dense
                    mask = (torch.arange(Smax, device=dev)[None, :]
                            < cl[:, None])[:, None, None, :]
                    r["library_ms"] = time_ms(torch, lambda: (
                        F.scaled_dot_product_attention(
                            q[:, :, None, :], kc, vc, attn_mask=mask,
                            enable_gqa=True)))
                out[label] = r
                log(f"  {label:50s} max|err| {err:.3e} (paged {perr:.3e}, "
                    f"== dense bits) {r['ms']:.4f} ms, paged "
                    f"{r['paged_ms']:.4f}, plain {r['plain_ms']:.4f} and "
                    f"{r['paged_plain_ms']:.4f}, bound {t_bound:.4f} ({by}), "
                    f"SDPA {r['library_ms']}, {r['kernel']}")
    log(f"  phase 20 (a) on {card}: {len(out)} (shape, q, cache) "
        "cases held")
    return out, decode_ptxas()


def decode_ptxas():
    """Per core and cache type, the most registers and the spill bytes
    over the decode library's instantiations (this run's build log)."""
    from repro_torch.kernels import build
    out = {}
    for fn, r in build.ptxas_report("decode_attention").items():
        core = ("cluster" if "decode_cluster_kernel" in fn else "lane"
                if "decode_lane_kernel" in fn else "mma"
                if "decode_mma_kernel" in fn else None)
        if core is None:
            continue
        cdt = ("float8_e4m3fn" if "__nv_fp8_e4m3" in fn else "bfloat16"
               if "__nv_bfloat16" in fn else "float32")
        e = out.setdefault(f"{core} {cdt}", {"instantiations": 0,
                                             "registers_max": 0,
                                             "spill_bytes": 0})
        e["instantiations"] += 1
        e["registers_max"] = max(e["registers_max"], r.get("registers", 0))
        e["spill_bytes"] += r.get("spill_stores", 0) + r.get("spill_loads",
                                                             0)
    log("  decode instantiations by core and cache type (-Xptxas -v): "
        + json.dumps(out))
    return out


def _watch_decode(torch, calls, at):
    """Wrap the model's decode entry point: keep (cloned) the inputs of
    its ``at``-th call, and count the calls by (q, cache) dtypes."""
    from repro_torch.models import layers
    orig = layers.decode_attention
    seen = collections.Counter()

    def wrapped(q, k, v, *a, **kw):
        n = sum(seen.values())
        seen[(str(q.dtype), str(k.dtype))] += 1
        if n == at:
            calls["decode"] = ([x.detach().clone() if torch.is_tensor(x)
                                else x for x in (q, k, v, *a)], dict(kw))
        return orig(q, k, v, *a, **kw)
    layers.decode_attention = wrapped
    return orig, seen


def _served_decode_hold(torch, calls, label):
    """The captured call through the kernel and its plain version; it must
    be a real one: q varying over the batch and v along the sequence."""
    from repro_torch.kernels import decode_attention as DA
    check("decode" in calls, f"phase 20 {label}: no decode call captured")
    a, kw = calls["decode"]
    check(_varies(a[0], 0) and _varies(a[1].float(), 2)
          and _varies(a[2].float(), 2),
          f"phase 20 {label}: the served decode call's q is constant over "
          "the batch, or its k or v cache along the sequence")
    with torch.no_grad():
        got = DA.decode_attention(*a, **kw)
        ref = DA.decode_attention_plain(*a, **kw)
    err = float((got - ref).abs().max())
    check(err <= TOL["float32"], f"phase 20 {label}: served decode off its "
          f"plain version by {err}")
    return {"max_abs_err": err, "q": str(a[0].dtype), "cache": str(a[1].dtype)}


def narrow_cache_serving(torch, card, base_streams, one_rank):
    """Phase 20 (b): full-width qwen1.5-0.5b (random f32 weights, seed 0)
    through the engine with cache_dtype="bfloat16" (phase 5's 16
    requests), and through one rank of build_prefill_step /
    build_decode_step at PipelinePlan(kv_dtype="fp8") (phase 19's B 8 x 512
    prefill and 16 decode steps, fed its one-rank path's tokens); each
    path's launches counted from 0 just before and read just after, and one
    served decode call of each held against its plain version."""
    from repro_torch.configs.base import PipelinePlan, get_arch
    from repro_torch.kernels import build
    from repro_torch.models import layers
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.pipeline import (build_decode_step,
                                               build_prefill_step,
                                               stack_params)
    from repro_torch.serving.engine import EngineConfig, FlexPipeEngine
    from repro_torch.serving.workload import Request

    dev = torch.device("cuda")
    cfg = get_arch("qwen1.5-0.5b").config
    f32 = torch.float32
    free_weights(torch)
    out = {}
    # the engine, a bf16 cache under phase 5's f32 params
    params = init_model(cfg, torch.Generator().manual_seed(0), f32, dev)
    eng = FlexPipeEngine(cfg, params, [0, 12], EngineConfig(
        max_batch=8, max_seq=1024, cache_dtype="bfloat16"))
    caches = [t for c in eng.caches for t in c["mixer"].values()]
    check(all(t.dtype == torch.bfloat16 for t in caches),
          "phase 20: the engine's caches are not bf16")
    reqs = make_requests(cfg, Request)
    calls = {}
    orig, seen = _watch_decode(torch, calls, KV_HOLD_TICK * cfg.n_layers
                               + cfg.n_layers // 2)
    # run() steps the engine; each step that decoded launches one decode
    # per layer, each request's prefill one flash per layer (phase 5)
    ticks_decoding, step = [0], eng.step

    def counted_step(now):
        rep = step(now)
        ticks_decoding[0] += rep.decoded > 0
        return rep
    eng.step = counted_step
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        eng.run(reqs)
    finally:
        layers.decode_attention = orig
        eng.step = step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launches)
    check(all(r.finish >= 0 and len(r.output) == 32 for r in reqs),
          "phase 20: a request did not complete with 32 tokens")
    L = cfg.n_layers
    want_launches("the bf16-cache engine run", {"launches": launches}, {
        "flash_attention": L * len(reqs),
        "decode_attention": L * ticks_decoding[0],
        "paged_decode_attention": 0})
    same = sum(list(r.output) == base_streams[r.rid] for r in reqs)
    out["engine_bf16_cache"] = {
        "wall_s": wall, "launches": launches,
        "ticks_decoding": ticks_decoding[0],
        "calls_by_dtype": {f"q={a} cache={b}": n
                           for (a, b), n in seen.items()},
        "streams_equal_to_f32_cache": same,
        "served_hold": _served_decode_hold(torch, calls, "engine")}
    log("  engine, bf16 cache, f32 params: "
        + json.dumps(out["engine_bf16_cache"]))
    del eng, params
    free_weights(torch)
    # one rank of the pipeline steps at kv_dtype="fp8", on phase 19's
    # one-rank weights
    plan = PipelinePlan(microbatches=PAR_PLAN["microbatches"],
                        kv_dtype="fp8")
    ps, ds, _ = _par_shapes()
    sp = stack_params(cfg, plan, init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), f32, dev))
    pre, _ = build_prefill_step(cfg, plan, None, ps, f32)
    dec, _ = build_decode_step(cfg, plan, None, ds, f32)
    calls = {}
    orig, seen = _watch_decode(torch, calls, KV_HOLD_TICK * cfg.n_layers
                               * PAR_PLAN["microbatches"] + cfg.n_layers // 2)
    tokens = torch.from_numpy(one_rank["tokens"]).to(dev)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        last, kv = pre(sp, {"tokens": tokens})
        leaves = [t for layer in kv.values() for part in layer.values()
                  for t in part.values()]
        check(all(t.dtype == torch.float8_e4m3fn for t in leaves),
              "phase 20: the fp8 plan's caches are not float8_e4m3fn")
        logits, times = [last], []
        for i in range(PAR_DECODE):
            tok = torch.from_numpy(one_rank["fed"][i]).to(dev)
            t1 = time.perf_counter()
            lg, kv = dec(sp, kv, tok, PAR_SQ + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            logits.append(lg)
    finally:
        layers.decode_attention = orig
    torch.cuda.synchronize()
    launches = dict(build.launches)
    ticks = PAR_PLAN["microbatches"]
    want = {"flash_attention": ticks * cfg.n_layers,
            "decode_attention": PAR_DECODE * ticks * cfg.n_layers}
    for name, n in want.items():
        check(launches.get(name, 0) == n, f"phase 20: {name} launched "
              f"{launches.get(name, 0)} times on the fp8 path, not {n}")
    errs, agree = [], 0
    for i, lg in enumerate(logits):
        lg = lg.float().cpu().numpy()
        check(np.isfinite(lg).all(), "phase 20: non-finite fp8 logits")
        errs.append(float(np.abs(lg - one_rank["logits"][i]).max()))
        if i < PAR_DECODE:
            agree += int((lg.argmax(-1) == one_rank["fed"][i][:, 0]).sum())
    out["pipeline_fp8_cache"] = {
        "launches": launches,
        "calls_by_dtype": {f"q={a} cache={b}": n
                           for (a, b), n in seen.items()},
        "decode_ms": 1e3 * float(np.median(times)),
        "logit_max_abs_diff_to_f32_cache": max(errs),
        "greedy_equal_to_f32_cache": f"{agree} of {PAR_DECODE * PAR_B}",
        "served_hold": _served_decode_hold(torch, calls, "fp8 pipeline")}
    log(f"  one rank, PipelinePlan(kv_dtype='fp8'): "
        f"{json.dumps(out['pipeline_fp8_cache'])}")
    del sp, kv, logits
    free_weights(torch)
    return out


def roofline_gaps(torch, card, measured):
    """Phase 20 (c): launch/roofline.py's step_costs on H100_SXM (f32,
    bytes_per_el=4) beside the steps measured earlier in this run: phase
    18's qwen train step, phase 5/6's dense decode tick (one rank), and
    phase 19's S = 2, T = 2 steps (4 ranks, on one card here).  The gap is
    recorded, not tuned away."""
    from repro_torch.configs.base import PipelinePlan, ShapeConfig, get_arch
    from repro_torch.launch.roofline import H100_SXM, step_costs
    cfg = get_arch("qwen1.5-0.5b").config
    ps, ds, ts = _par_shapes()
    cases = [
        ("phase 18 train step, one rank", ShapeConfig("t", 512, 8, "train"),
         PipelinePlan(microbatches=2, remat=True), 1, measured["train"]),
        ("phase 5/6 decode tick, one rank", ShapeConfig("d", 1024, 8,
                                                        "decode"),
         PipelinePlan(), 1, measured["tick"]),
        ("phase 19 prefill, S2 T2, a rank", ShapeConfig(
            "p", PAR_SQ, PAR_B, "prefill"), PipelinePlan(**PAR_PLAN), 4,
         measured["par_prefill"]),
        ("phase 19 decode step, S2 T2, a rank", ds, PipelinePlan(**PAR_PLAN),
         4, measured["par_decode"]),
        ("phase 19 train step, S2 T2, a rank", ts,
         PipelinePlan(**PAR_PLAN, remat=True), 4, measured["par_train"]),
    ]
    out = []
    for label, shape, plan, model, ms in cases:
        r = step_costs(cfg, shape, plan, pod=1, data=1, model=model,
                       chip=H100_SXM, bytes_per_el=4)
        pred = r["step_time_lower_bound_s"] * 1e3
        row = {"case": label, "predicted_ms": pred,
               "dominant": r["dominant"],
               "compute_ms": r["compute_s"] * 1e3,
               "memory_ms": r["memory_s"] * 1e3,
               "collective_ms": r["collective_s"] * 1e3,
               "measured": ms,
               "measured_over_predicted": {k: v / pred for k, v in ms.items()
                                           if isinstance(v, float)}}
        out.append(row)
        log(f"  {label:38s} roofline {pred:9.3f} ms ({r['dominant']}); "
            f"measured {json.dumps(ms)}")
    log(f"  phase 20 (c) on {card}: the roofline is a lower bound; each "
        "measured step's gap to it is recorded above")
    return out


def narrow_cache_phase(torch, card, base_streams, one_rank, measured):
    t0 = time.perf_counter()
    pairs, regs = decode_pair_checks(torch, card)
    served = narrow_cache_serving(torch, card, base_streams, one_rank)
    gaps = roofline_gaps(torch, card, measured)
    out = {"pairs": pairs, "ptxas": regs, "served": served,
           "roofline": gaps, "s": time.perf_counter() - t0}
    log(f"  phase 20 on {card}: {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 21: bf16 training, the reference's default dtype
# ---------------------------------------------------------------------------

BF16_TRAIN_STEPS = 5
# deepseek-moe-16b's bf16 run: 4 of its 28 layers at full width (2.8 B
# params; bf16 params and gradients and f32 moments are about 33 GB)
DSMOE_TRAIN_LAYERS = 4
# the 2-layer bf16 step, card against CPU: two bf16 runs lie as far apart
# as bf16 lies from f32, so the loss and grad norm are held within
# BF16_FACTOR times the larger of the two devices' bf16-to-f32 distances
# (phase 18's f32 step from the same draws); each param within 2.5 lr_1
# (phase 18's rule) plus one bf16 ulp of its value (a flip of the final
# rounding)
BF16_FACTOR = 2.0


def _ulp_bf16(torch, x):
    """One bf16 ulp at each |x| (normal range)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30)))
                      - 7)


def _over_ulp(torch, got, want):
    """Elements of ``got`` beyond one bf16 ulp of ``want`` or
    TOL["bfloat16"], and the largest |got - want|."""
    d = (got.float() - want.float()).abs()
    tol = torch.clamp(_ulp_bf16(torch, want.float()), min=TOL["bfloat16"])
    return int((d > tol).sum()), float(d.max())


# phases 3 and 21 time the bf16 forward at (192, 128), (128, 128) and
# (256, 256) beside the design each replaced, the span kernel's mma.sync
# path: a copy of csrc/flash_attention.cu whose bf16 dispatch sends the
# three pairs to flash_span_kernel again, built with the others in phase 2
# into build/earlier/
EARLIER_EDIT = [("RT_WG(128, 128)", "RT_SPAN(__nv_bfloat16, 128, 128)"),
                ("RT_WG(192, 128)", "RT_SPAN(__nv_bfloat16, 192, 128)"),
                ("RT_WGS(256, 256)", "RT_SPAN(__nv_bfloat16, 256, 256)")]


def start_earlier_span():
    """Start nvcc on the earlier design's copy (EARLIER_EDIT); returns the
    process and the library's path."""
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention.cu").read_text()
    for old, new in EARLIER_EDIT:
        check(src.count(old) == 1, "flash_attention.cu: the bf16 "
              f"dispatch's {old} is not there once")
        src = src.replace(old, new)
    out = ROOT / "build" / "earlier"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "flash_attention_span128.cu"
    cu.write_text(src)
    lib = out / "libflash_attention_span128.so"
    return subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(lib), str(cu)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), lib


def finish_earlier_span(started):
    """Wait for the earlier design's build; its library, loaded."""
    import ctypes
    from repro_torch.kernels import build
    proc, path = started
    text, _ = proc.communicate()
    check(proc.returncode == 0, f"the earlier design's build failed: {text}")
    lib = ctypes.CDLL(str(path))
    for fn, sig in build.SIGNATURES["flash_attention"].items():
        getattr(lib, fn).argtypes = sig
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def earlier_span_forward(torch, lib, q, k, v, window=0):
    """A causal, end-aligned bf16 call (q (B, S, H, hd), k (B, S, Kh, hd),
    v (B, S, Kh, hdv); ``window``: a sliding window) through the span
    kernel of the earlier design's library: a function that launches it
    into one output.  Its launches count nowhere (build.launches counts the
    port's)."""
    from repro_torch.kernels import flash_attention as FA
    B, S, H, hd = q.shape
    Kh, hdv = k.shape[2], v.shape[-1]
    geo = FA._span_geometry(hd, hdv, q.element_size())
    out = torch.empty((B, S, H, hdv), dtype=q.dtype, device=q.device)
    scratch = torch.empty(B * H * S * FA.n_spans(S) * (hdv + 2),
                          dtype=torch.float32, device=q.device)

    def call():
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, S, S, H, Kh, hd, hdv, 0, 1, window,
            1.0 / math.sqrt(hd), 1, geo.span, geo.smem,
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the earlier design's launch failed: {err}")
        return out
    return call


def bf16_bwd_kernel_checks(torch, span_lib):
    """The flash backward kernel at bf16 at both training shapes: its
    gradients bf16; each within one bf16 ulp or TOL["bfloat16"] of the f32
    kernel on the widened inputs (q, k, v, the forward's bf16 output, dO),
    rounded to bf16, with the elements that differ at all counted (its
    m16n8k16 products sum in another order than 3xTF32, so the two may
    round to neighbours), and of its plain version on the same inputs (D
    from the forward's bf16 output, as the kernel); a second call's bits
    equal; its device time, each of its two kernels' share, beside the
    bound (bf16 tensor cores), the f32 kernel's on the widened inputs (the
    design the bf16 backward ran before: widened bf16 in its f32 tiles),
    the plain backward's and SDPA's bf16 backward's; its kernels' registers
    and spills.  Then the bf16 forward (flash_wgmma_kernel) at qwen's
    training call (the kernel its bf16 step runs 96 times) and at the
    (128, 128) template (deepseek-moe-16b's call), each against its plain
    version and its mirror, repeat bits, no spills, beside its bound and
    SDPA's bf16 forward; at (128, 128) also beside the span kernel it
    replaced (``span_lib``: that design's library), timed in turns."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    out = {}
    B, S, H = (FLASH_TRAIN[k] for k in ("B", "S", "H"))
    pairs = B * H * S * (S + 1) // 2
    for hd in (FLASH_TRAIN["hd"], 128):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (B, S, H, hd)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(4))
        with torch.no_grad():
            o = FA.flash_attention(q, k, v)
        args = (q, k, v, o, do, True, 0, 1.0 / math.sqrt(hd), 0)
        wide = tuple(t.float() for t in args[:5]) + args[5:]
        got = FA._launch_backward(*args)
        f32 = [w.to(torch.bfloat16) for w in FA._launch_backward(*wide)]
        label = f"flash_attention_bwd bf16 hd={hd}"
        check(all(g.dtype == torch.bfloat16 for g in got),
              f"{label}: gradients are not bf16")
        check(all(bool(torch.isfinite(g.float()).all()) for g in got),
              f"{label}: non-finite gradient")
        flips = [int((g != w).sum()) for g, w in zip(got, f32)]
        vs_f32 = [_over_ulp(torch, g, w) for g, w in zip(got, f32)]
        over_f32 = sum(n for n, _ in vs_f32)
        log(f"  {label}: vs the f32 kernel on the widened inputs, rounded: "
            f"{flips} elements differ (dq, dk, dv), max|err| "
            f"{max(e for _, e in vs_f32):.3e}, {over_f32} beyond one bf16 "
            f"ulp or {TOL['bfloat16']:g}")
        check(over_f32 == 0, f"{label}: {over_f32} elements beyond one bf16 "
              f"ulp or {TOL['bfloat16']} of the f32 kernel's, rounded")
        check(all(torch.equal(a, b) for a, b in zip(
            got, FA._launch_backward(*args))),
            f"{label}: two calls gave different bits")
        ref = FA.flash_attention_bwd_plain(q, k, v, do, o=o)
        vs_plain = [_over_ulp(torch, g, r) for g, r in zip(got, ref)]
        err = max(e for _, e in vs_plain)
        over = sum(n for n, _ in vs_plain)
        top = max(float(r.float().abs().max()) for r in ref)
        log(f"  {label}: max|err| vs plain {err:.3e} (tol one bf16 ulp or "
            f"{TOL['bfloat16']:g}; max|grad| {top:.3e}), {over} over")
        check(over == 0, f"{label}: {over} elements beyond one bf16 ulp or "
              f"{TOL['bfloat16']} of the plain version")
        ms = time_ms(torch, lambda: FA._launch_backward(*args))
        earlier = time_ms(torch, lambda: FA._launch_backward(*wide))
        with torch.enable_grad():
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            op = FA.flash_attention_plain(*ins)
            plain = time_ms(torch, lambda: torch.autograd.grad(
                op, ins, do, retain_graph=True), iters=5)
            sins = [t.transpose(1, 2).contiguous().requires_grad_(True)
                    for t in (q, k, v)]
            so = F.scaled_dot_product_attention(*sins, is_causal=True)
            sdo = do.transpose(1, 2).contiguous()
            lib = time_ms(torch, lambda: torch.autograd.grad(
                so, sins, sdo, retain_graph=True))
        del op, so, ins, sins
        # q, k, v, o and dO read once, dq, dk and dv written once (bf16); 5
        # products of hd per visible pair
        t_bound, by = bound(8 * B * S * H * hd * 2, 5 * 2 * hd * pairs,
                            "bfloat16")
        shape = f"B={B} Sq=Skv={S} H=Kh={H} hd={hd} causal bf16"
        out[hd] = dict(max_abs_err=err, max_abs_grad=top, ms=ms,
                       earlier_ms=earlier, plain_ms=plain, library_ms=lib,
                       bound_ms=t_bound, bound_by=by, shape=shape,
                       differ_from_f32_rounded=flips,
                       max_abs_err_vs_f32_rounded=max(e for _, e in vs_f32))
        log(f"  {label}: {ms:.4f} ms  earlier design (the f32 kernel on the "
            f"widened inputs) {earlier:.4f} ms  plain {plain:.4f} ms  SDPA "
            f"bf16 backward {lib:.4f} ms  bound {t_bound:.4f} ms ({by})  "
            f"[{shape}]")
        geo = FA._bwd_geometry(hd, hd, torch.bfloat16)
        out[hd].update(_bwd_kernels_info(
            torch, "flash_attention_bwd", lambda: FA._launch_backward(*args),
            {"dkdv_bf16_kernel": geo.smem, "dq_bf16_kernel": geo.row_smem}))
        out[hd]["ptxas"] = {k: r for k, r in out[hd]["ptxas"].items()
                            if "bf16" in k}
        del args, wide, got, f32, ref, q, k, v, do, o
    # the bf16 forward as the bf16 steps call it (flash_wgmma_kernel): at
    # qwen's training call, and at the (128, 128) template on the same
    # shape (deepseek-moe-16b's call), there in turns with the span kernel
    # it replaced (the earlier design's library)
    for hd in (FLASH_TRAIN["hd"], 128):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, S, H, hd)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(3))
        shape = f"B={B} Sq=Skv={S} H=Kh={H} hd={hd} causal bf16"
        label = f"flash_attention bf16 ({shape})"
        with torch.no_grad():
            got = FA.flash_attention(q, k, v)
            ref = FA.flash_attention_plain(q, k, v)
            over, err = _over_ulp(torch, got, ref)
            check(over == 0, f"{label}: {over} elements beyond one bf16 ulp "
                  f"or {TOL['bfloat16']} of the plain version")
            check(torch.equal(got, FA.flash_attention(q, k, v)),
                  f"{label}: two calls gave other bits")
            n_m, e_m = _over_ulp(torch, got, FA.flash_wgmma_plain(q, k, v))
            check(n_m == 0, f"{label}: {n_m} elements beyond one bf16 ulp "
                  f"or {TOL['bfloat16']} of flash_wgmma_plain")
            r = dict(max_abs_err=err, max_abs_err_vs_mirror=e_m,
                     shape=shape, kernel="flash_wgmma_kernel",
                     ptxas=ptxas("flash_attention",
                                 f"flash_wgmma_kernelILi{hd}ELi{hd}E"))
            check(not r["ptxas"].get("spill_stores")
                  and not r["ptxas"].get("spill_loads"),
                  f"{label}: spills {r['ptxas']}")
            r["plain_ms"] = time_ms(
                torch, lambda: FA.flash_attention_plain(q, k, v), iters=5)
            kernel = lambda: FA.flash_attention(q, k, v)  # noqa: E731
            if hd == 128:
                span = earlier_span_forward(torch, span_lib, q, k, v)
                n_e, e_e = _over_ulp(torch, span(), ref)
                check(n_e == 0, f"{label}: the span kernel's output has {n_e} "
                      "elements beyond one bf16 ulp of the plain version")
                turns = [time_ms(torch, f) for f in (kernel, span, span,
                                                     kernel)]
                r.update(ms=min(turns[0], turns[3]),
                         earlier_ms=min(turns[1], turns[2]),
                         ms_turns=turns, earlier_max_abs_err=e_e,
                         earlier="flash_span_kernel<bf16, 128, 128> and its "
                                 "combine, the design this pair ran before "
                                 "(kernel, span, span, kernel in turns)")
            else:
                r["ms"] = time_ms(torch, kernel)
            sq, sk, sv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            r["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, is_causal=True))
        # q, k, v read and out written once (bf16); S and P.V, 2 products
        # of hd per visible pair
        r["bound_ms"], r["bound_by"] = bound(4 * B * S * H * hd * 2,
                                             2 * 2 * hd * pairs, "bfloat16")
        out["forward" if hd == FLASH_TRAIN["hd"] else "forward_hd128"] = r
        log(f"  flash_attention bf16: {r['ms']:.4f} ms"
            + (f"  earlier design (the span kernel) {r['earlier_ms']:.4f} "
               f"ms, turns {[round(t, 4) for t in r['ms_turns']]}"
               if "earlier_ms" in r else "")
            + f"  plain {r['plain_ms']:.4f} ms  SDPA bf16 forward "
            f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})  max|err| vs plain {err:.3e}, vs "
            f"flash_wgmma_plain {e_m:.3e}; {r['ptxas']}  [{shape}]")
    return out



def bf16_card_vs_cpu(torch, f32_step):
    """One bf16 train step of qwen1.5-0.5b at full width cut to 2 layers
    (phase 18's setup, its f32 draws rounded to bf16) on the card and on
    the CPU: loss and grad norm within BF16_FACTOR times the larger
    bf16-to-f32 distance of the two devices (``f32_step``: phase 18's f32
    step), every param within 2.5 lr_1 plus one bf16 ulp."""
    from repro_torch.configs.base import PipelinePlan, get_arch, shrink
    from repro_torch.training.optimizer import AdamWConfig, schedule
    from repro_torch.tree import tree_leaves

    cfg = shrink(get_arch("qwen1.5-0.5b").config, n_layers=2)
    plan = PipelinePlan(microbatches=2, remat=True)
    res = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        params, opt, step, data = _train_setup(
            torch, cfg, plan, 128, 2, dev, torch.Generator().manual_seed(0),
            bf16=True)
        params, opt, m = step(params, opt, _batch(torch, data, 0, dev))
        res[dev] = (params, {k: float(v) for k, v in m.items()},
                    time.perf_counter() - t0)
    lr1 = float(schedule(AdamWConfig(**TRAIN_OPT), 1))
    a, b = res["cpu"][1], res["cuda"][1]
    out = {"loss_cpu": a["loss"], "loss_cuda": b["loss"],
           "grad_norm_cpu": a["grad_norm"], "grad_norm_cuda": b["grad_norm"],
           "cpu_s": res["cpu"][2], "lr_1": lr1}
    for key, f32k in (("loss", "loss"), ("grad_norm", "grad_norm")):
        dist = max(abs(a[key] - f32_step[f"{f32k}_cpu"]),
                   abs(b[key] - f32_step[f"{f32k}_cuda"]))
        out[f"{key}_bf16_to_f32"] = dist
        check(abs(a[key] - b[key]) <= BF16_FACTOR * dist,
              f"bf16 train step: {key} on the card {b[key]} vs the CPU's "
              f"{a[key]}, beyond {BF16_FACTOR} x {dist}")
    worst, n_off, n_all = 0.0, 0, 0
    for pc, pg in zip(tree_leaves(res["cpu"][0]), tree_leaves(res["cuda"][0])):
        check(pc.dtype == pg.dtype == torch.bfloat16,
              "bf16 train step: a param left bf16")
        pc, pg = pc.float(), pg.float().cpu()
        d = (pc - pg).abs()
        worst = max(worst, float((d / (2.5 * lr1 + _ulp_bf16(torch, pc)))
                                 .max()))
        n_off += int((d > 0).sum())
        n_all += d.numel()
    out.update(param_worst_share_of_tol=worst, param_share_differing=n_off
               / n_all)
    log(f"  bf16 card vs CPU (2 layers, B 2, S 128): {json.dumps(out)}")
    check(worst <= 1.0, f"bf16 train step: a param differs by {worst} of "
          f"2.5 lr_1 + one bf16 ulp")
    return out


SERVED = ("flash_attention", "decode_attention", "paged_decode_attention")


def _watch_served(torch, calls, at, flash_at=(0,)):
    """A ``watch`` for serve() (or around a train run): wrap the model's
    flash, decode and paged decode entry points to keep in ``calls``
    (cloned) the inputs of the run's first flash call (layer 0 on the first
    prompt or batch; with ``flash_at``, of each flash call of those
    indices, under "flash_attention@i" past the first) and of the ``at``-th
    call of each decode kind (a real tick's), and count the calls by (q, k)
    dtypes."""
    from repro_torch.models import layers

    def watch():
        orig = {n: getattr(layers, n) for n in SERVED}
        seen = collections.Counter()

        def wrap(name):
            def wrapped(*a, **kw):
                n = sum(v for (k, *_), v in seen.items() if k == name)
                seen[(name, str(a[0].dtype), str(a[1].dtype))] += 1
                if name == "flash_attention":
                    key = None if n not in flash_at else (
                        name if n == flash_at[0] else f"{name}@{n}")
                else:
                    key = name if n == at else None
                if key:
                    calls[key] = ([x.detach().clone() if torch.is_tensor(x)
                                   else x for x in a], dict(kw))
                return orig[name](*a, **kw)
            return wrapped
        for name in SERVED:
            setattr(layers, name, wrap(name))

        def unwatch():
            for name, fn in orig.items():
                setattr(layers, name, fn)
            calls["by_dtype"] = {f"{k} q={a} k={b}": n
                                 for (k, a, b), n in seen.items()}
        return unwatch
    return watch


def _hold_served(torch, calls, name, label, key=None):
    """The captured call of ``name`` (``calls[key]``, ``name`` by default)
    through its kernel against its plain version (flash also against
    flash_wgmma_plain), within one bf16 ulp or TOL["bfloat16"]; the call
    must be a real one (flash: q, k and v vary along the sequence; decode:
    q over the batch, the caches along the rows)."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    key = key or name
    check(key in calls, f"{label}: no {key} call captured")
    a, kw = calls[key]
    if name == "flash_attention":
        real = all(_varies(x, 1) for x in a[:3])
    elif name == "decode_attention":
        real = (_varies(a[0], 0) and _varies(a[1].float(), 2)
                and _varies(a[2].float(), 2))
    else:
        real = _varies(a[0], 0) and _varies(a[1].float(), 0)
    check(real, f"{label}: the captured {name} call is constant where a "
          "real call varies")
    fn = {"flash_attention": FA.flash_attention,
          "decode_attention": DA.decode_attention,
          "paged_decode_attention": DA.paged_decode_attention}[name]
    plain = {"flash_attention": FA.flash_attention_plain,
             "decode_attention": DA.decode_attention_plain,
             "paged_decode_attention": DA.paged_decode_attention_plain}[name]
    with torch.no_grad():
        got = fn(*a, **kw)
        check(torch.equal(got, fn(*a, **kw)),
              f"{label}: the served {name} call gave other bits again")
        n_p, e_p = _over_ulp(torch, got, plain(*a, **kw))
        n_m, e_m = (_over_ulp(torch, got, FA.flash_wgmma_plain(*a, **kw))
                    if name == "flash_attention" else (0, None))
    out = {"q": list(a[0].shape), "k": list(a[1].shape),
           "dtype": str(a[0].dtype), "cache_dtype": str(a[1].dtype),
           "max_abs_err": e_p}
    if "window" in kw:
        out["window"] = kw["window"]
    if e_m is not None:
        out["max_abs_err_vs_mirror"] = e_m
    log(f"  {label}: served {name} {json.dumps(out)}")
    check(got.dtype == a[0].dtype == torch.bfloat16,
          f"{label}: the served {name} call is not bf16")
    check(n_p == 0 and n_m == 0, f"{label}: the served {name} call has "
          f"{n_p} elements beyond one bf16 ulp or {TOL['bfloat16']} of its "
          f"plain version, {n_m} of flash_wgmma_plain")
    return out


def bf16_training_phase(torch, card, f32_step, span_lib):
    """Phase 21: the bf16 backward kernel and the bf16 forward at both
    training shapes, a 2-layer bf16 step on the card against the CPU, and
    through build_train_step's default dtype (B 8, seq 512, M 2, remat) for
    BF16_TRAIN_STEPS steps each: full-width qwen1.5-0.5b at full depth
    (flash 24 x M x 2 and its backward 24 x M launches a step) and
    full-width deepseek-moe-16b cut to DSMOE_TRAIN_LAYERS layers (16 heads
    of 128: flash_wgmma_kernel at (128, 128), L x M x 2 and its backward L
    x M a step; its first flash call held against its plain version and
    mirror); each loss falling, no decode."""
    from repro_torch.configs.base import PipelinePlan, get_arch, shrink

    t0 = time.perf_counter()
    free_weights(torch)
    out = {"kernel": bf16_bwd_kernel_checks(torch, span_lib),
           "card_vs_cpu": bf16_card_vs_cpu(torch, f32_step)}
    cfg = get_arch("qwen1.5-0.5b").config
    plan = PipelinePlan(microbatches=2, remat=True)
    L, M = cfg.n_layers, plan.microbatches
    losses, info, setup = train_run(
        torch, card, "qwen1.5-0.5b train bf16", cfg, plan, 512, 8,
        BF16_TRAIN_STEPS, {"flash_attention": L * M * 2,
                           "flash_attention_bwd": L * M,
                           "decode_attention": 0,
                           "paged_decode_attention": 0}, bf16=True)
    del setup
    log(f"  qwen1.5-0.5b bf16 losses: {losses}")
    check(losses[-1] < losses[0], f"qwen1.5-0.5b bf16: the last loss "
          f"{losses[-1]} is not below step 0's {losses[0]}")
    out["qwen"] = info
    # deepseek-moe-16b: each flash call is the (128, 128) template's shape
    # (B 4 a microbatch, seq 512, 16 heads of 128, causal)
    full = get_arch("deepseek-moe-16b").config
    cfg = shrink(full, n_layers=DSMOE_TRAIN_LAYERS)
    n = cfg.param_count()
    log(f"  deepseek-moe-16b: {DSMOE_TRAIN_LAYERS} of {full.n_layers} "
        f"layers at full width, {n} params; bf16 params and gradients and "
        f"f32 moments: {12 * n / GiB:.1f} GiB before the step's "
        "temporaries")
    L = cfg.n_layers
    calls = {}
    unwrap = _watch_served(torch, calls, 0)()
    try:
        losses, info, setup = train_run(
            torch, card, "deepseek-moe-16b train bf16", cfg, plan, 512, 8,
            BF16_TRAIN_STEPS, {"flash_attention": L * M * 2,
                               "flash_attention_bwd": L * M,
                               "decode_attention": 0,
                               "paged_decode_attention": 0}, bf16=True)
    finally:
        unwrap()
    del setup
    log(f"  deepseek-moe-16b bf16 losses: {losses}")
    check(losses[-1] < losses[0], f"deepseek-moe-16b bf16: the last loss "
          f"{losses[-1]} is not below step 0's {losses[0]}")
    info["layers"] = L
    info["params"] = n
    info["first_flash_call"] = _hold_served(
        torch, calls, "flash_attention", "deepseek-moe-16b train bf16")
    out["deepseek_moe"] = info
    free_weights(torch)
    out["s"] = time.perf_counter() - t0
    log(f"  phase 21 on {card}: {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 22: serving at the reference's default bf16 params
# ---------------------------------------------------------------------------

def bf16_small_model_check(torch, arch):
    """Phase 4 at bf16: the smoke config (smoke_cfg: deepseek-v2 with its
    MLA heads widened to the served pair; gemma3 with its heads widened to
    the served 256, here only, so that flash runs at (256, 256)) from the
    same bf16-rounded weights on the card and on the CPU; the card's logits
    within BF16_FACTOR times the CPU's own bf16-to-f32 distance, and how
    often the argmax agrees."""
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_model
    from repro_torch.tree import tree_map

    cfg = smoke_cfg(arch)
    if arch == "gemma3-1b":
        cfg = dataclasses.replace(cfg, head_dim=256)
    f32 = init_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    cpu = tree_map(lambda t: t.to(torch.bfloat16), f32)
    f32 = tree_map(lambda t: t.float(), cpu)        # the same rounded weights
    gpu = tree_map(lambda t: t.to("cuda"), cpu)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 40)))}
    l32, _, _ = M.forward(cfg, f32, batch)
    l16, _, _ = M.forward(cfg, cpu, batch)
    lg, _, _ = M.forward(cfg, gpu, {k: v.cuda() for k, v in batch.items()})
    lg = lg.float().cpu()
    dist = float((l16.float() - l32.float()).abs().max())
    err = float((lg - l16.float()).abs().max())
    agree = float((lg.argmax(-1) == l16.argmax(-1)).float().mean())
    out = {"card_vs_cpu_bf16": err, "cpu_bf16_to_f32": dist,
           "argmax_agrees": agree, "params": str(
               next(iter(tree_leaves(gpu))).dtype)}
    log(f"  {arch} smoke-size forward at bf16, card vs CPU: "
        f"{json.dumps(out)} (limit {BF16_FACTOR} x the CPU's distance)")
    check(bool(torch.isfinite(lg).all()), f"{arch}: non-finite bf16 logits")
    check(dist > 0 and err <= BF16_FACTOR * dist, f"{arch}: bf16 card "
          f"logits {err} from the CPU's, beyond {BF16_FACTOR} x {dist}")
    return out


def decode_vs_forward_bf16(torch, cfg, params, reqs, rids):
    """For ``rids``: each served stream fed back through the model's own
    prefill (bf16 cache) and decode steps, its logits against one
    whole-sequence forward's at the same positions, for an MoE config at
    capacity factor E/K (the same expert assignments): the largest distance
    and how often the argmax agrees, recorded, not held (bf16 rounds the
    two paths apart)."""
    from repro_torch.models import model as M
    cfg = no_drop(cfg) if cfg.moe is not None else cfg
    out = {}
    with torch.no_grad():
        for req in (r for r in reqs if r.rid in rids):
            toks = np.concatenate([req.prompt_tokens, req.output[:-1]])
            full, _, _ = M.forward(cfg, params, forward_batch(torch, req,
                                                              toks))
            full = full[0, len(req.prompt_tokens) - 1:].float()
            last, cache = M.prefill(
                cfg, params, forward_batch(torch, req, req.prompt_tokens),
                1024, cache_dtype=torch.bfloat16)
            steps = [last[0].float()]
            for j, tok in enumerate(req.output[:-1]):
                lg, cache = M.decode_step(
                    cfg, params, torch.tensor([[tok]], device="cuda"), cache,
                    len(req.prompt_tokens) + j)
                steps.append(lg[0].float())
            steps = torch.stack(steps)
            out[req.rid] = {
                "max_abs_diff": float((steps - full).abs().max()),
                "argmax_agrees": float((steps.argmax(-1) == full.argmax(-1))
                                       .float().mean()),
                "max_abs_logit": float(full.abs().max())}
            del cache
    log(f"  bf16 decode vs forward (bf16 cache; MoE at cf E/K), not held: "
        f"{json.dumps(out)}")
    return out


def bf16_one_rank(torch, one_rank):
    """One rank of build_prefill_step / build_decode_step for full-width
    qwen1.5-0.5b at their default bf16 params and cache: phase 19's B 8 x
    512 prefill and 16 greedy decode steps; launches counted from 0 just
    before and read just after, one served call of each kernel held
    against its plain version; the logits' distance to phase 19's f32
    one-rank path and its greedy agreement, recorded."""
    from repro_torch.configs.base import PipelinePlan, get_arch
    from repro_torch.kernels import build
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.pipeline import (build_decode_step,
                                               build_prefill_step,
                                               stack_params)

    dev = torch.device("cuda")
    cfg = get_arch("qwen1.5-0.5b").config
    plan = PipelinePlan(microbatches=PAR_PLAN["microbatches"])
    ps, ds, _ = _par_shapes()
    sp = stack_params(cfg, plan, init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16,
        dev))
    pre, _ = build_prefill_step(cfg, plan, None, ps)
    dec, _ = build_decode_step(cfg, plan, None, ds)
    calls = {}
    M, L = PAR_PLAN["microbatches"], cfg.n_layers
    unwatch = _watch_served(torch, calls, KV_HOLD_TICK * L * M + L // 2)()
    tokens = torch.from_numpy(one_rank["tokens"]).to(dev)
    torch.cuda.synchronize()
    build.reset_launches()
    try:
        last, kv = pre(sp, {"tokens": tokens})
        leaves = [t for layer in kv.values() for part in layer.values()
                  for t in part.values()]
        check(all(t.dtype == torch.bfloat16 for t in leaves),
              "phase 22: the one-rank steps' caches are not bf16")
        logits, times = [last], []
        for i in range(PAR_DECODE):
            tok = last.argmax(-1, keepdim=True).to(torch.int32)
            t1 = time.perf_counter()
            last, kv = dec(sp, kv, tok, PAR_SQ + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            logits.append(last)
    finally:
        unwatch()
    torch.cuda.synchronize()
    launches = dict(build.launches)
    want_launches("one rank at bf16", {"launches": launches}, {
        "flash_attention": M * L, "decode_attention": PAR_DECODE * M * L,
        "paged_decode_attention": 0})
    errs, agree = [], 0
    for i, lg in enumerate(logits):
        lg = lg.float().cpu().numpy()
        check(np.isfinite(lg).all(), "phase 22: non-finite bf16 logits")
        errs.append(float(np.abs(lg - one_rank["logits"][i]).max()))
        if i < PAR_DECODE:
            agree += int((lg.argmax(-1) == one_rank["fed"][i][:, 0]).sum())
    out = {"launches": launches, "calls_by_dtype": calls["by_dtype"],
           "decode_ms": 1e3 * float(np.median(times)),
           "logit_max_abs_diff_to_f32": max(errs),
           "greedy_equal_to_f32": f"{agree} of {PAR_DECODE * PAR_B}",
           "served": {n: _hold_served(torch, calls, n, "one rank at bf16")
                      for n in SERVED[:2]}}
    log(f"  one rank at bf16 params and cache: {json.dumps(out)}")
    del sp, kv, logits
    free_weights(torch)
    return out


def bf16_serving_phase(torch, card, one_rank):
    """Phase 22: serving at the reference's default bf16 params.
    (a) full-width qwen1.5-0.5b, bf16 params and cache, phase 5's 16
    requests: run(), a dense and a paged-kernel run refactored [0, 12] ->
    [0, 6, 12, 18] -> [0, 12], streams bit-identical; flash 24 per prefill
    (flash_wgmma_kernel at hd 64) and decode or paged decode 24 per tick,
    exactly; one served call of each kernel held against its plain version
    (flash also against flash_wgmma_plain); ms/tick, tok/s, three profiled
    ticks, peak memory.  (b) deepseek-v2-236b cut to DSV2_LAYERS layers,
    bf16 params and latent cache: run() and a run refactored [0, 1] -> [0,
    1, 2] -> [0, 1], streams bit-identical; flash at (192, 128) 3 per
    prefill, no decode kernel; its first served flash call held; three
    profiled ticks, peak memory and headroom; the bf16 decode-vs-forward
    distance for requests 8 and 13, recorded.  (c) one rank of the
    pipeline steps at their default bf16 (bf16_one_rank).  (d) phase 4 at
    bf16 (bf16_small_model_check) for qwen1.5-0.5b, the widened MLA
    deepseek-v2 and gemma3-1b with 256-wide heads.  (e) full-width
    gemma3-1b at bf16 params and bf16 caches (gemma3_bf16)."""
    from repro_torch.configs.base import get_arch, shrink

    t0 = time.perf_counter()
    free_weights(torch)
    out = {}
    # (a) qwen1.5-0.5b
    calls = {"dense": {}, "paged": {}}
    L = get_arch("qwen1.5-0.5b").config.n_layers
    at = KV_HOLD_TICK * L + L // 2
    cfg, params, reqs, runs = serving(
        torch, card, "qwen1.5-0.5b", torch.Generator().manual_seed(0),
        {"dense refactored": {},
         "paged kernel refact.": dict(paged=True, block_size=16,
                                      paged_kernel=True)},
        prefix="qwen bf16 ", dtype=torch.bfloat16, cache_dtype="bfloat16",
        watches={"qwen bf16 dense refactored":
                 _watch_served(torch, calls["dense"], at),
                 "qwen bf16 paged kernel refact.":
                 _watch_served(torch, calls["paged"], at)})
    for label, run in runs.items():
        paged = "paged" in label
        want_launches(label, run, {
            "flash_attention": L * len(reqs),
            "decode_attention": 0 if paged else L * run["ticks_decoding"],
            "paged_decode_attention":
                L * run["ticks_decoding"] if paged else 0})
    served = {"flash_attention": _hold_served(
                  torch, calls["dense"], "flash_attention", "qwen bf16"),
              "decode_attention": _hold_served(
                  torch, calls["dense"], "decode_attention", "qwen bf16"),
              "paged_decode_attention": _hold_served(
                  torch, calls["paged"], "paged_decode_attention",
                  "qwen bf16")}
    prof = profile_moe_ticks(torch, cfg, params, (0, 12),
                             cache_dtype="bfloat16")
    mem = peak_memory(torch, "qwen1.5-0.5b at bf16")
    dense = runs["qwen bf16 dense refactored"]
    out["qwen"] = {"runs": runs, "served": served,
                   "calls_by_dtype": calls["dense"]["by_dtype"],
                   "paged_calls_by_dtype": calls["paged"]["by_dtype"],
                   "decode_ms_per_tick": dense["decode_ms_per_tick"],
                   "decode_tok_per_s": dense["decode_tok_per_s"], **prof,
                   **mem}
    del params
    free_weights(torch)
    # (b) deepseek-v2-236b, DSV2_LAYERS layers
    full = get_arch("deepseek-v2-236b").config
    cfg = shrink(full, n_layers=DSV2_LAYERS)
    log(f"  deepseek-v2-236b: {cfg.n_layers} of {full.n_layers} layers at "
        f"full width, {cfg.param_count()} params "
        f"({cfg.param_count() * 2 / 1e9:.1f} GB bf16)")
    calls = {}
    cfg, params, reqs, runs = serving(
        torch, card, "deepseek-v2-236b",
        torch.Generator(device="cuda").manual_seed(0),
        {"dense refactored": {}}, prefix="deepseek-v2 bf16 ",
        boundaries=(0, 1), moves={10: [0, 1, 2], 30: [0, 1]}, cfg=cfg,
        dtype=torch.bfloat16, cache_dtype="bfloat16",
        watches={"deepseek-v2 bf16 dense run()":
                 _watch_served(torch, calls, 0)})
    Lv = cfg.n_layers
    for label, run in runs.items():
        want_launches(label, run, {
            "flash_attention": Lv * len(reqs), "decode_attention": 0,
            "paged_decode_attention": 0})
    first = _hold_served(torch, calls, "flash_attention",
                         "deepseek-v2 bf16")
    check(first["q"][-1] == 192 and first["k"][-1] == 192,
          f"deepseek-v2 bf16: the first flash call is not at hd 192: {first}")
    streams = decode_vs_forward_bf16(torch, cfg, params, reqs, (8, 13))
    prof = profile_moe_ticks(torch, cfg, params, (0, 1),
                             cache_dtype="bfloat16")
    mem = peak_memory(torch, f"deepseek-v2-236b at bf16 ({Lv} layers)")
    check(mem["headroom_bytes"] >= 2 * GiB,
          f"deepseek-v2-236b at bf16 left {mem['headroom_bytes']} B free "
          "at its peak, under 2 GiB")
    dense = runs["deepseek-v2 bf16 dense refactored"]
    out["deepseek_v2"] = {
        "runs": runs, "layers": Lv, "params": cfg.param_count(),
        "first_flash_call": first, "decode_vs_forward": streams,
        "decode_ms_per_tick": dense["decode_ms_per_tick"],
        "decode_tok_per_s": dense["decode_tok_per_s"], **prof, **mem}
    del params
    free_weights(torch)
    # (c) one rank of the pipeline steps, (d) phase 4 at bf16
    out["one_rank"] = bf16_one_rank(torch, one_rank)
    out["small"] = {arch: bf16_small_model_check(torch, arch)
                    for arch in ("qwen1.5-0.5b", "deepseek-v2-236b",
                                 "gemma3-1b")}
    # (e) gemma3-1b
    out["gemma3"] = gemma3_bf16(torch, card)
    out["s"] = time.perf_counter() - t0
    log(f"  phase 22 on {card}: " + json.dumps(
        {k: v for k, v in out.items()
         if k not in ("qwen", "deepseek_v2", "gemma3")}))
    for k in ("qwen", "deepseek_v2", "gemma3"):
        log(f"  phase 22 {k}: " + json.dumps(
            {a: b for a, b in out[k].items() if a != "runs"}))
    return out


def gemma3_bf16(torch, card):
    """Phase 22 (e): full-width gemma3-1b (26 layers, 4 heads on 1 of 256,
    window 512 on the local layers) at bf16 params and bf16 caches (local
    rings, global rows) on phase 11's 16 requests: run(), then a run
    refactored [0, 13] -> [0, 7, 14, 20] at tick 10 and back at tick 30,
    streams bit-identical; flash (flash_wgspan_kernel at (256, 256)) 26
    per prompt and decode (the hd-256 cluster kernel, a bf16 query over a
    bf16 cache) 26 per decoding tick, exactly; the refactored run's first
    prompt's flash calls at layer 0 (local, window 512) and layer 5
    (global), and one decode call of a real tick, held against their plain
    versions (flash also against flash_wgmma_plain); the bf16
    decode-vs-forward distance for requests 8 and 13, recorded; ms/tick,
    tok/s, three profiled ticks and peak memory."""
    from repro_torch.configs.base import get_arch

    t0 = time.perf_counter()
    free_weights(torch)
    L = get_arch("gemma3-1b").config.n_layers
    calls = {}
    cfg, params, reqs, runs = serving(
        torch, card, "gemma3-1b",
        torch.Generator(device="cuda").manual_seed(0),
        {"dense refactored": {}}, prefix="gemma3 bf16 ", boundaries=(0, 13),
        moves={10: [0, 7, 14, 20], 30: [0, 13]}, dtype=torch.bfloat16,
        cache_dtype="bfloat16",
        watches={"gemma3 bf16 dense refactored": _watch_served(
            torch, calls, KV_HOLD_TICK * L + L // 2, flash_at=(0, 5))})
    for label, run in runs.items():
        want_launches(label, run, {
            "flash_attention": L * len(reqs),
            "decode_attention": L * run["ticks_decoding"],
            "paged_decode_attention": 0})
    served = {
        "flash_local": _hold_served(torch, calls, "flash_attention",
                                    "gemma3 bf16 (layer 0, local)"),
        "flash_global": _hold_served(torch, calls, "flash_attention",
                                     "gemma3 bf16 (layer 5, global)",
                                     key="flash_attention@5"),
        "decode": _hold_served(torch, calls, "decode_attention",
                               "gemma3 bf16")}
    check(served["flash_local"].get("window") == cfg.sliding_window
          and served["flash_global"].get("window") == 0
          and served["flash_local"]["q"][-1] == 256,
          f"gemma3 bf16: the held flash calls are not a local and a global "
          f"layer's at hd 256: {served}")
    streams = decode_vs_forward_bf16(torch, cfg, params, reqs, (8, 13))
    prof = profile_moe_ticks(torch, cfg, params, (0, 13),
                             cache_dtype="bfloat16")
    mem = peak_memory(torch, "gemma3-1b at bf16")
    dense = runs["gemma3 bf16 dense refactored"]
    out = {"runs": runs, "served": served,
           "calls_by_dtype": calls["by_dtype"], "decode_vs_forward": streams,
           "decode_ms_per_tick": dense["decode_ms_per_tick"],
           "decode_tok_per_s": dense["decode_tok_per_s"], **prof, **mem,
           "s": time.perf_counter() - t0}
    del params
    free_weights(torch)
    log(f"  phase 22 (e) gemma3-1b at bf16 on {card}: {out['s']:.1f} s")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    log("== 1. device")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    log(f"  allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    log("== 2. build")
    t0 = time.perf_counter()
    started = start_earlier_span()
    try:
        build.load_all()
    finally:
        span_lib = finish_earlier_span(started)
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({build.BUILD_DIR}; phase 21's earlier design beside them)")
    log("== 3. kernels vs plain versions")
    kres = kernel_checks(torch, span_lib)
    log("== 4. small-input model check")
    for arch in ("qwen1.5-0.5b", "rwkv6-1.6b", "gemma3-1b",
                 "deepseek-moe-16b", "jamba-v0.1-52b", "qwen1.5-110b",
                 "llama-3.2-vision-11b", "whisper-tiny", "deepseek-v2-236b"):
        small_model_check(torch, arch)
    log("== 5. serving qwen1.5-0.5b")
    cfg, params, base_reqs, runs = serving(
        torch, card, "qwen1.5-0.5b", torch.Generator().manual_seed(0),
        {"dense refactored": {},
         "paged gather refact.": dict(paged=True, block_size=16),
         "paged kernel refact.": dict(paged=True, block_size=16,
                                      paged_kernel=True)})
    log("== 6. where a dense decode tick's time goes")
    tick_profile = profile_decode(torch, card, cfg, params, 20)
    qwen = (cfg, params, base_reqs)           # phase 9 serves it again
    log("== 7. serving rwkv6-1.6b")
    # 1/10: a cold refactor's throwaway tick holds one layer's scratch
    # state (B x (H hd^2 + 2 d) f32, 1/24 of the live state; the kernel
    # updates it in place) and the B x V f32 logits (1/49): about 1/16 in
    # all, and no second copy of the live state
    cfg, params, reqs, rwkv_runs = serving(
        torch, card, "rwkv6-1.6b",
        torch.Generator(device="cuda").manual_seed(0),
        {"dense refactored": {}}, prefix="rwkv6 ")
    runs.update(rwkv_runs)
    ref = rwkv_runs["rwkv6 dense refactored"]
    want = cfg.n_layers * (len(reqs) + ref["ticks_decoding"])
    got = ref["launches"].get("wkv6", 0)
    log(f"  wkv6 launches in the refactored run: {got} = {cfg.n_layers} x "
        f"({len(reqs)} prefills + {ref['ticks_decoding']} decode ticks): "
        f"{want}")
    check(got == want, "not every WKV step of the rwkv6 path ran in wkv6")
    decode_equals_forward(torch, cfg, params,
                          sorted(reqs, key=lambda r: r.prompt_len)[::15])
    log("== 8. where an rwkv6 decode tick's and prefill's time goes")
    profile_decode(torch, card, cfg, params, 10)
    profile_prefill(torch, card, cfg, params)
    rwkv = (cfg, params)                      # phase 10 serves it again
    log("== 9. qwen1.5-0.5b: chunked prefill, the fault path, admission")
    cfg, params, base_reqs = qwen
    base = {r.rid: list(r.output) for r in base_reqs}
    chunk_runs, differed = chunked_phase(torch, card, cfg, params, base,
                                         base_reqs)
    chunk_timing = time_chunks(torch, card, cfg, params)
    ref_streams, ref_info, ref_reqs = chunk_runs["chunk128 dense"]
    fault_runs = fault_phase(torch, card, cfg, params, base, base_reqs,
                             (ref_streams, ref_reqs), ref_info)
    admission = admission_phase(torch, card, cfg, params, base, base_reqs)
    log("  phase 9 summary on " + card + ": " + json.dumps({
        "margin_rule_streams": differed, "chunk": chunk_timing,
        "faults": {k: {kk: vv for kk, vv in v.items() if kk != "replay_spans"}
                   for k, v in fault_runs.items()},
        "admission": admission}))
    log("== 10. the controller plane on full-width qwen1.5-0.5b and "
        "rwkv6-1.6b")
    ctl_runs, ctl = controller_phase(
        torch, card, {"qwen": (cfg, params), "rwkv6": rwkv},
        {"qwen": runs["dense refactored"]["decode_ms_per_tick"],
         "rwkv6": runs["rwkv6 dense refactored"]["decode_ms_per_tick"]})

    log("== 11. serving gemma3-1b")
    del params, rwkv, qwen
    torch.cuda.empty_cache()
    g_runs = gemma3_phase(torch, card)
    log("== 12. serving deepseek-moe-16b")
    d_runs, d_out = deepseek_phase(torch, card)
    log("== 13. serving jamba-v0.1-52b (one 8-layer Jamba block)")
    j_runs, j_out = jamba_phase(torch, card)
    log("== 14. serving llama-3.2-vision-11b (cross attention, 40 layers)")
    v_runs, v_out = vision_phase(torch, card)
    log("== 15. serving whisper-tiny (its encoder on the card, 1500 frames)")
    w_runs, w_out = whisper_phase(torch, card)
    log(f"== 16. serving qwen1.5-110b ({QWEN110B_LAYERS} of 80 layers)")
    q_runs, q_out = qwen110b_phase(torch, card)
    log(f"== 17. serving deepseek-v2-236b ({DSV2_LAYERS} of 60 layers, MLA)")
    v2_runs, v2_out = deepseek_v2_phase(torch, card)
    log("== 18. training: the backward kernels, qwen1.5-0.5b and rwkv6-1.6b")
    tres = training_kernel_checks(torch)
    t_out = training_phase(torch, card)
    log(f"== 19. multi-rank: {PAR_RANKS} ranks on one card (S = "
        f"{PAR_PLAN['stages']}, T = {PAR_PLAN['tensor']}, gloo)")
    p_out = parallel_phase(torch, card)
    log("== 20. decode over bf16 and fp8 caches; the roofline beside the "
        "card")
    ranks = p_out["ranks"]
    n_out = narrow_cache_phase(torch, card, base, p_out["one_rank"], {
        "train": {"ms_per_step": t_out["qwen"]["ms_per_step"],
                  "busy_ms_per_step": t_out["qwen"].get(
                      "busy_ms_per_step", "not measured")},
        "tick": {"ms_per_tick": runs["dense refactored"][
            "decode_ms_per_tick"], "busy_ms_per_tick": tick_profile.get(
                "busy_ms_per_tick", "not measured")},
        "par_prefill": {"ms_per_rank_max": max(r["prefill_ms"]
                                               for r in ranks)},
        "par_decode": {"ms_per_rank_max": max(r["decode_ms"] for r in ranks),
                       "one_rank_ms": p_out["one_rank"]["decode_ms"]},
        "par_train": {"ms_per_rank_max": max(r["train_ms"] for r in ranks),
                      "one_rank_ms": p_out["one_rank"]["train_ms"]}})

    log("== 21. bf16 training (the reference's default dtype)")
    b_out = bf16_training_phase(torch, card, t_out["card_vs_cpu"],
                                span_lib)
    log("== 22. serving at bf16 params: qwen1.5-0.5b, deepseek-v2-236b "
        f"({DSV2_LAYERS} layers), one rank's steps, phase 4 at bf16, "
        "gemma3-1b")
    s_out = bf16_serving_phase(torch, card, p_out["one_rank"])

    paths = {"decode_attention": "dense run()",
             "flash_attention": "dense run()",
             "paged_decode_attention": "paged kernel refact.",
             "wkv6": "rwkv6 dense run()"}
    replaces = {
        "decode_attention": "src/repro/kernels/decode_attention.py:87",
        "paged_decode_attention": "src/repro/kernels/decode_attention.py:183",
        "flash_attention": "src/repro/kernels/flash_attention.py:71",
        "wkv6": "src/repro/kernels/rwkv6_wkv.py:59"}
    sources = {
        "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "paged_decode_attention":
            "src/repro_torch/kernels/csrc/decode_attention.cu",
        "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "wkv6": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu"}
    tolerance = {name: (TOL["float32"], "%g, or one bf16 ulp (a flip of the "
                        "final rounding)" % TOL["bfloat16"])
                 for name in paths}
    tolerance["wkv6"] = ("%g x mean|y|" % WKV_TOL["float32"],
                         "%g x mean|y|" % WKV_TOL["bfloat16"])
    kernels = []
    for name in paths:
        n = runs[paths[name]]["launches"].get(name, 0)
        check(n > 0, f"{name} was not launched on the serving path")
        r = kres[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": n,
            "max_abs_err": r["max_abs_err"],
            "max_abs_err_bf16": r["max_abs_err_bf16"],
            "mean_abs_out": r["mean_abs_out"],
            "mean_abs_out_bf16": r["mean_abs_out_bf16"],
            "tolerance": tolerance[name][0],
            "tolerance_bf16": tolerance[name][1],
            "bf16_rounding_flips": r.get("bf16_rounding_flips", 0),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "launched_in": paths[name]})
        if "kernel" in r:                  # the decode core at this shape
            kernels[-1]["kernel"] = r["kernel"]
        if name == "flash_attention":
            kernels[-1]["chunk"] = r["chunk"]
            kernels[-1]["bf16_one_pass"] = r["bf16_one_pass"]
            info = chunk_runs["chunk128 dense"][1]
            kernels[-1]["launches_chunked"] = \
                info["launches"]["flash_attention"]
            kernels[-1]["chunked_launched_in"] = "chunk128 dense"
        ctl_path = {"paged_decode_attention": "controller paged kernel",
                    "wkv6": "controller rwkv6 dense"}.get(
                        name, "controller dense")
        kernels[-1]["launches_controller"] = \
            ctl_runs[ctl_path]["info"]["launches"].get(name, 0)
        kernels[-1]["controller_launched_in"] = ctl_path
        check(kernels[-1]["launches_controller"] > 0,
              f"{name} was not launched on the controller path")
        if "prefill" in r:
            kernels[-1]["prefill"] = r["prefill"]
            kernels[-1]["prefill_lengths"] = r["prefill_lengths"]
        if name in ("flash_attention", "decode_attention"):
            g = g_runs["gemma3 dense refactored"]
            kernels[-1]["launches_gemma3"] = g["launches"].get(name, 0)
            kernels[-1]["gemma3_launched_in"] = "gemma3 dense refactored"
            check(kernels[-1]["launches_gemma3"] > 0,
                  f"{name} was not launched on the gemma3 path")
        if name != "wkv6":
            dpath = ("deepseek-moe paged kernel refact."
                     if name == "paged_decode_attention"
                     else "deepseek-moe dense refactored")
            kernels[-1]["launches_deepseek_moe"] = \
                d_runs[dpath]["launches"].get(name, 0)
            kernels[-1]["deepseek_moe_launched_in"] = dpath
            check(kernels[-1]["launches_deepseek_moe"] > 0,
                  f"{name} was not launched on the deepseek-moe path")
            kernels[-1]["launches_jamba"] = \
                j_runs["jamba dense refactored"]["launches"].get(name, 0)
            kernels[-1]["jamba_launched_in"] = "jamba dense refactored"
            # Mamba state does not page: jamba serves on dense caches only
            paged_only = name == "paged_decode_attention"
            check((kernels[-1]["launches_jamba"] == 0) == paged_only,
                  f"{name} launched {kernels[-1]['launches_jamba']} times "
                  "on the jamba path")
        # phases 14-17: each path's run, its count checked: > 0 where the
        # kernel serves the model, 0 for paged decode on the cross and MLA
        # models (their caches do not page), for decode on deepseek-v2 and
        # for wkv6 on all four
        for tag, model_runs, dense_run, paged_run in (
                ("vision", v_runs, "vision dense refactored", None),
                ("whisper", w_runs, "whisper dense refactored", None),
                ("qwen110b", q_runs, "qwen110b dense refactored",
                 "qwen110b paged kernel refact."),
                ("deepseek_v2", v2_runs, "deepseek-v2 dense refactored",
                 None)):
            run = (paged_run if name == "paged_decode_attention" and paged_run
                   else dense_run)
            n = model_runs[run]["launches"].get(name, 0)
            kernels[-1][f"launches_{tag}"] = n
            kernels[-1][f"{tag}_launched_in"] = run
            # MLA's decode is the absorbed form: flash only
            must = (name == "flash_attention" or (
                name == "decode_attention" and tag != "deepseek_v2") or (
                name == "paged_decode_attention" and paged_run is not None))
            check(n > 0 if must else n == 0,
                  f"{name} launched {n} times on the {tag} path ({run})")
            cross = model_runs[run].get("launches_cross", {})
            if must and tag in ("vision", "whisper"):
                kernels[-1][f"launches_{tag}_cross"] = cross.get(name, 0)
        if name in ("flash_attention", "decode_attention"):
            # phase 19: per rank, its serving and its training counted apart
            kernels[-1]["launches_parallel_per_rank"] = [
                {"serve": r["serve"]["launches"].get(name, 0),
                 "train": r["train"]["launches"].get(name, 0)}
                for r in p_out["ranks"]]
            kernels[-1]["parallel_launched_in"] = p_out["label"]
            kernels[-1]["parallel_served_max_abs_err"] = [
                r["served_holds"][name] for r in p_out["ranks"]]
        if name in ("decode_attention", "paged_decode_attention"):
            # phase 20: every (q, cache) dtype pair at three shapes, and the
            # launches of the two narrow-cache paths (both dense)
            ms_key, plain_key, err_key = (
                ("ms", "plain_ms", "max_abs_err")
                if name == "decode_attention" else
                ("paged_ms", "paged_plain_ms", "paged_max_abs_err"))
            kernels[-1]["cache_pairs"] = {
                label: {"ms": c[ms_key], "plain_ms": c[plain_key],
                        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                        "max_abs_err": c[err_key],
                        "max_abs_err_vs_mirror": c["max_abs_err_vs_mirror"],
                        "kernel": c["kernel"],
                        "library_ms": c["library_ms"]}
                for label, c in n_out["pairs"].items()}
            kernels[-1]["cache_pairs_ptxas"] = n_out["ptxas"]
            for path, run in n_out["served"].items():
                kernels[-1][f"launches_{path}"] = run["launches"].get(name, 0)
                if name == "decode_attention":
                    kernels[-1][f"{path}_served_max_abs_err"] = \
                        run["served_hold"]["max_abs_err"]
        # phase 22: qwen1.5-0.5b at bf16 params and cache (flash at hd 64
        # is flash_wgmma_kernel), the one rank's bf16 steps
        qb = s_out["qwen"]
        run = ("qwen bf16 paged kernel refact."
               if name == "paged_decode_attention"
               else "qwen bf16 dense refactored")
        if name != "wkv6":
            kernels[-1]["launches_bf16_serving"] = \
                qb["runs"][run]["launches"].get(name, 0)
            kernels[-1]["bf16_serving_launched_in"] = run
            kernels[-1]["bf16_serving_served_max_abs_err"] = \
                qb["served"][name]["max_abs_err"]
            check(kernels[-1]["launches_bf16_serving"] > 0,
                  f"{name} was not launched on the bf16 serving path")
        if name in ("flash_attention", "decode_attention"):
            kernels[-1]["launches_bf16_one_rank"] = \
                s_out["one_rank"]["launches"].get(name, 0)
            # phase 22 (e): gemma3-1b at bf16 params and caches (flash at
            # (256, 256) is flash_wgspan_kernel)
            gb = s_out["gemma3"]
            run = "gemma3 bf16 dense refactored"
            kernels[-1]["launches_bf16_serving_gemma3"] = \
                gb["runs"][run]["launches"].get(name, 0)
            kernels[-1]["bf16_serving_gemma3_launched_in"] = run
            check(kernels[-1]["launches_bf16_serving_gemma3"] > 0,
                  f"{name} was not launched on the gemma3 bf16 path")
        for key in ("hd256_window", "hd256_causal", "hd192_128",
                    "hd192_128_h128", "hd192_128_h128_1024",
                    "hd256_ring", "hd256_global", "hd128", "hd128_mha",
                    "hd128_gqa", "hd128_chunk", "hd128_1024",
                    "hd128_cross_600", "hd128_cross_1024", "hd64_encoder",
                    "hd64_encoder_b2", "hd64_cross_1024", "hd128_cross",
                    "hd64_cross", "hd128_g8"):
            if key in r:
                kernels[-1][key] = r[key]
    # the backward kernels: launches counted in phase 18's training runs
    for name, fwd, run in (("flash_attention_bwd", "flash_attention",
                            "qwen"),
                           ("wkv6_bwd", "wkv6", "rwkv6")):
        r = tres[name]
        n = t_out[run]["launches"].get(name, 0)
        check(n > 0, f"{name} was not launched on the training path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": sources[fwd].replace(".cu", "_bwd.cu"),
            "replaces": replaces[fwd] + " (its gradient; the Pallas "
                        "package has no backward kernel)",
            "launches": n, "launched_in": f"{run} training, "
                                          f"{t_out[run]['steps']} steps",
            "max_abs_err": r["max_abs_err"],
            "max_abs_grad": r["max_abs_grad"],
            "tolerance": f"{BWD_TOL:g} x max|grad|",
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "by_kernel": r["by_kernel"], "ptxas": r["ptxas"],
            "dynamic_smem": r["dynamic_smem"]})
        if "hd128" in r:
            kernels[-1]["hd128"] = r["hd128"]
        kernels[-1]["split_in_training"] = t_out[run].get(f"{name}_split",
                                                          "not measured")
        if name == "flash_attention_bwd":
            kernels[-1]["launches_parallel_per_rank"] = [
                r["train"]["launches"].get(name, 0) for r in p_out["ranks"]]
            kernels[-1]["parallel_launched_in"] = p_out["label"]
            kernels[-1]["parallel_served_max_abs_err"] = [
                r["served_holds"][name] for r in p_out["ranks"]]
    # the bf16 backward: the same kernel's bf16 instantiation, its launches
    # counted in phase 21's bf16 training run
    n = b_out["qwen"]["launches"].get("flash_attention_bwd", 0)
    check(n > 0, "the bf16 flash backward was not launched on the bf16 "
          "training path")
    r = b_out["kernel"][FLASH_TRAIN["hd"]]
    kernels.append({
        "name": "flash_attention_bwd_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": replaces["flash_attention"] + " (its gradient at bf16; "
                    "the Pallas package has no backward kernel)",
        "launches": n, "launched_in": f"qwen bf16 training, "
                                      f"{b_out['qwen']['steps']} steps",
        "max_abs_err": r["max_abs_err"], "max_abs_grad": r["max_abs_grad"],
        "tolerance": "one bf16 ulp or %g, of the plain version and of the "
                     "f32 kernel on the widened inputs, rounded"
                     % TOL["bfloat16"],
        "differ_from_f32_rounded": r["differ_from_f32_rounded"],
        "ms": r["ms"], "earlier_ms": r["earlier_ms"],
        "earlier": "the f32 kernel on the widened inputs, the design the "
                   "bf16 backward ran before",
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": r["shape"], "by_kernel": r["by_kernel"],
        "ptxas": r["ptxas"], "dynamic_smem": r["dynamic_smem"],
        "hd128": dict(b_out["kernel"][128], launches=b_out["deepseek_moe"][
            "launches"].get("flash_attention_bwd", 0),
            launched_in=f"deepseek-moe-16b bf16 training "
                        f"({b_out['deepseek_moe']['layers']} layers), "
                        f"{b_out['deepseek_moe']['steps']} steps")})
    check(kernels[-1]["hd128"]["launches"] > 0, "the bf16 flash backward at "
          "(128, 128) was not launched on the deepseek-moe bf16 path")
    # the bf16 forward: flash_wgmma_kernel at the training call, its
    # launches counted in the same bf16 training run
    n = b_out["qwen"]["launches"].get("flash_attention", 0)
    check(n > 0, "the bf16 flash forward was not launched on the bf16 "
          "training path")
    r = b_out["kernel"]["forward"]
    kernels.append({
        "name": "flash_attention_bf16_train", "route": "cuda",
        "source": sources["flash_attention"],
        "replaces": replaces["flash_attention"], "launches": n,
        "launched_in": f"qwen bf16 training, {b_out['qwen']['steps']} steps",
        "max_abs_err": r["max_abs_err"],
        "tolerance": tolerance["flash_attention"][1],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": r["shape"], "kernel": "flash_wgmma_kernel",
        "max_abs_err_vs_mirror": r["max_abs_err_vs_mirror"],
        "ptxas": r["ptxas"], "hd128": b_out["kernel"]["forward_hd128"]})
    # the bf16 forward at (128, 128): flash_wgmma_kernel at the template,
    # its launches counted in deepseek-moe-16b's bf16 training run
    d = b_out["deepseek_moe"]
    n = d["launches"].get("flash_attention", 0)
    check(n > 0, "the bf16 flash forward at (128, 128) was not launched on "
          "the deepseek-moe bf16 training path")
    r = b_out["kernel"]["forward_hd128"]
    kernels.append({
        "name": "flash_attention_bf16_hd128", "route": "cuda",
        "source": sources["flash_attention"],
        "replaces": replaces["flash_attention"], "launches": n,
        "launched_in": f"deepseek-moe-16b bf16 training ({d['layers']} "
                       f"layers), {d['steps']} steps",
        "max_abs_err": r["max_abs_err"],
        "max_abs_err_vs_mirror": r["max_abs_err_vs_mirror"],
        "tolerance": tolerance["flash_attention"][1],
        "ms": r["ms"], "earlier_ms": r["earlier_ms"],
        "earlier": r["earlier"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "shape": r["shape"],
        "kernel": "flash_wgmma_kernel", "ptxas": r["ptxas"],
        "occupancy": kres["flash_attention"]["bf16_one_pass"][
            "occupancy_128"],
        "first_flash_call": d["first_flash_call"]})
    # the bf16 forward at (192, 128): flash_wgmma_kernel on deepseek-v2's
    # MLA prefill (phase 3's 128-head rows), its launches counted in phase
    # 22's bf16 run() of deepseek-v2-236b
    dv = s_out["deepseek_v2"]
    n = dv["runs"]["deepseek-v2 bf16 dense run()"]["launches"].get(
        "flash_attention", 0)
    check(n > 0, "the bf16 flash forward at (192, 128) was not launched on "
          "the deepseek-v2 bf16 serving path")
    fa = kres["flash_attention"]
    r = fa["hd192_128_h128"]["bf16"]
    kernels.append({
        "name": "flash_attention_bf16_mla", "route": "cuda",
        "source": sources["flash_attention"],
        "replaces": replaces["flash_attention"], "launches": n,
        "launched_in": "deepseek-v2 bf16 dense run() "
                       f"({dv['layers']} layers, bf16 params and cache)",
        "max_abs_err": r["max_abs_err"],
        "max_abs_err_vs_mirror": r["max_abs_err_vs_mirror"],
        "tolerance": tolerance["flash_attention"][1],
        "ms": r["ms"], "earlier_ms": r["earlier_ms"],
        "earlier": r["earlier"], "ms_turns": r["ms_turns"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": r["shape"], "kernel": "flash_wgmma_kernel",
        "ptxas": r["ptxas"], "occupancy": r["occupancy"],
        "bucket_1024": {x: fa["hd192_128_h128_1024"]["bf16"][x] for x in (
            "ms", "earlier_ms", "ms_turns", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err",
            "max_abs_err_vs_mirror", "shape")},
        "heads_16": {x: fa["hd192_128"]["bf16"][x] for x in (
            "ms", "earlier_ms", "plain_ms", "bound_ms", "library_ms",
            "max_abs_err", "shape")},
        "first_flash_call": dv["first_flash_call"]})
    # the bf16 forward at (256, 256): flash_wgspan_kernel on gemma3-1b's
    # 571-token prompt (phase 3's hd256 rows), its launches counted in
    # phase 22 (e)'s refactored bf16 run of gemma3-1b
    gb = s_out["gemma3"]
    run = "gemma3 bf16 dense refactored"
    n = gb["runs"][run]["launches"].get("flash_attention", 0)
    check(n > 0, "the bf16 flash forward at (256, 256) was not launched on "
          "the gemma3-1b bf16 serving path")
    r = fa["hd256_causal"]["bf16"]
    kernels.append({
        "name": "flash_attention_bf16_hd256", "route": "cuda",
        "source": sources["flash_attention"],
        "replaces": replaces["flash_attention"], "launches": n,
        "launched_in": f"{run} (26 layers, bf16 params and caches)",
        "max_abs_err": r["max_abs_err_vs_plain"],
        "max_abs_err_vs_mirror": r["max_abs_err_vs_mirror"],
        "tolerance": tolerance["flash_attention"][1],
        "ms": r["ms"], "earlier_ms": r["earlier_ms"],
        "earlier": r["earlier"], "ms_turns": r["ms_turns"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": r["shape"], "kernel": "flash_wgspan_kernel",
        "ptxas": r["ptxas"], "occupancy": r["occupancy"],
        "kernels_us": r.get("kernels_us"),
        "window_512": {x: fa["hd256_window"]["bf16"].get(x) for x in (
            "ms", "earlier_ms", "ms_turns", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err_vs_plain",
            "max_abs_err_vs_mirror", "kernels_us", "shape")},
        "served": gb["served"]})
    log(f"  phase 18 (training) {t_out['s']:.1f} s; phase 19 (multi-rank) "
        f"{p_out['s']:.1f} s; phase 20 (narrow caches) {n_out['s']:.1f} s; "
        f"phase 21 (bf16 training) {b_out['s']:.1f} s; phase 22 (bf16 "
        f"serving) {s_out['s']:.1f} s")
    log("  phase 20 roofline against the card: " + json.dumps(
        n_out["roofline"]))
    log(f"  phases 12-17: deepseek-moe-16b {d_out['s']:.1f} s, "
        f"jamba-v0.1-52b {j_out['s']:.1f} s, llama-3.2-vision-11b "
        f"{v_out['s']:.1f} s, whisper-tiny {w_out['s']:.1f} s, "
        f"qwen1.5-110b {q_out['s']:.1f} s, deepseek-v2-236b "
        f"{v2_out['s']:.1f} s; chip_smoke.py "
        f"{time.perf_counter() - T_START:.1f} s in all")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
