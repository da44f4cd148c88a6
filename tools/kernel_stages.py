#!/usr/bin/env python3
"""Where the flash, decode and backward kernels spend their time, stage by
stage, on one NVIDIA GPU, and what flash costs over the calls the served
models make.

    python3 tools/kernel_stages.py [--tree DIR] [hd256] [hd128] [served] [bwd]
                                   [wkvbwd]

(default: the first three, on this checkout's sources; --tree measures
another checkout's, such as a parent unpacked under build/: its sources are
instrumented and its package imported).

hd256 and hd128 copy csrc/decode_attention.cu and csrc/flash_attention.cu
into build/stages/, insert a clock64() read by thread 0 of every CTA at the
stage boundaries named below (and a %globaltimer read), build each copy
with the flags of kernels/build.py, launch it through ctypes, and print the
median and the largest cycle count from CTA entry to each boundary over the
CTAs that reached it.  The instrumented copies are for this measurement
only; the kernels the port runs are built from the unmodified sources.

hd256: chip_smoke.py phase 3's gemma3-1b shapes, f32 (decode B=8, H=4,
Kh=1, Smax 512 and 1024; flash Sq=Skv=571, H=4, Kh=1, causal), through the
cluster and span kernels.

hd128: the span kernel at deepseek-moe-16b's flash shape, f32 (Sq=Skv=512,
H=Kh=16, causal): its stage clocks, and the registers and spills of the
(128, 128) and (192, 128) kernels from the build's -Xptxas -v log.

served: flash through the tree's own wrapper, f32, at every distinct call
that chip_smoke.py's phases 12 and 13 make (deepseek-moe-16b, 16 heads:
each of the 16 prompts at its pow2 bucket, and chunk by chunk at 128 rows;
jamba-v0.1-52b, 32 heads on 8: each prompt at its exact length), each
timed with CUDA events, and per run the sum over its calls of count x ms
for one layer.  Run on two trees in one call, it gives the net change of a
kernel change over the mix of shapes those runs serve.

bwd: the backward kernels through the tree's own launchers, f32, at the
training calls of chip_smoke.py's phase 18 (flash at qwen1.5-0.5b's B 4,
Sq = Skv 512, 16 heads of 64, causal, and at (128, 128) on the same
shape; wkv6 at rwkv6-1.6b's B 4, S 512, 32 heads of 64, with a state0),
each timed with CUDA events beside SDPA's backward on the same inputs, and
the device time of each kernel of a call (torch.profiler).  Run it on the
parent and the change in turns (parent, change, change, parent) in one
call to compare the two.

wkvbwd: the wkv6 backward kernel at the same rwkv6 call, stage by stage:
cycles that thread 0 of each CTA adds up per stage over the chunk loops
(an instrumented copy of csrc/rwkv6_wkv_bwd.cu), and how many of its
clusters the card holds at once (cudaOccupancyMaxActiveClusters).

Needs CUDA and nvcc; exits non-zero without them.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TREE = ROOT                      # the checkout whose kernels are measured
CSRC = TREE / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "stages"

STAMP = ("if (threadIdx.x == 0) {{ long long c_ = clock64(); "
         "unsigned long long g_; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_)); "
         "const int id_ = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
         " + blockIdx.x; stage_c[id_ * 32 + ({k})] = c_; "
         "stage_g[id_ * 32 + ({k})] = g_; }}\n")
DECLS = '''__device__ long long stage_c[1 << 16];
__device__ unsigned long long stage_g[1 << 16];
'''
ACCESSORS = '''
extern "C" int stages_get(void* c, void* g, int n) {
  cudaMemcpyFromSymbol(c, stage_c, n * 8);
  return (int)cudaMemcpyFromSymbol(g, stage_g, n * 8);
}
extern "C" int stages_clear() {
  static long long z[1 << 16];
  cudaMemcpyToSymbol(stage_c, z, sizeof(z));
  return (int)cudaMemcpyToSymbol(stage_g, z, sizeof(z));
}
'''

# (text in the source, stage index, name, stamp before the text?)
DECODE = [
    ("  cg::cluster_group cluster = cg::this_cluster();", "0", "entry", True),
    ("  if (n > 0 && warp == 0) {\n    // one bulk copy", "1",
     "cache_len read", True),
    ("  // q, scaled, in f32 (rows past G are never read)", "2",
     "copies issued", True),
    ("  if (n > 0) {\n    // partial scores", "3", "q in shared memory",
     True),
    ("    float s[KG];", "4", "K arrived", True),
    ("    mbar_wait0(vbar);", "5", "S and softmax", True),
    ("    // P.V: thread tid holds", "6", "V arrived", True),
    ("  cluster.sync();   // every slice's", "7", "P.V", True),
    ("  // every live rank's m and l, gathered once", "8",
     "cluster barrier", True),
    ("  cluster_arrive();   // done with", "9", "merged partial written",
     True),
    ("  if (last) {\n    // columns", "10", "ticket taken", True),
    ("    float O[PER];", "11", "combine: m, l gathered", True),
    ("  cluster_wait();   // no CTA leaves", "12", "end", True),
]
# the span kernel: one CTA per (span, 64 query rows, b*h) work item
FLASH = [
    ("  const Item item = find_item<BK>(blockIdx.x,", "0", "entry", True),
    ("    const T* kt = kring + ((it & 1) * BK + kg * WK) * KS;",
     "1 + 4 * min(it, 3)", "tile ready", True),
    ("    scores<HD, NT, s_chains<T, HD>()>(s, qw, kt, g, t);\n",
     "2 + 4 * min(it, 3)", "S", False),
    ("    pair_sync(rw);     // the tile's whole P is in shared memory",
     "3 + 4 * min(it, 3)", "softmax, P exchanged", False),
    ("    accumulate<HDV, NP, NO>(o, p, vt, g, t);", "4 + 4 * min(it, 3)",
     "P.V", False),
    ("  // row sums: across the quad, then the pair's key halves in order",
     "17", "tiles done", True),
    ("          make_float2(o[n][2 * r], o[n][2 * r + 1]);\n  }\n}", "18",
     "partials written", None),
]


def instrument(name, points, tag="", edits=()):
    src = (CSRC / f"{name}.cu").read_text()
    for text, k, _, before in points:
        if src.count(text) != 1:
            raise SystemExit(f"{name}.cu changed: stage anchor not found "
                             f"once: {text!r}")
        stamp = STAMP.format(k=k)
        if before is None:               # before the function's last brace
            src = src.replace(text, text[:-1] + stamp + "}")
        else:
            src = src.replace(text, stamp + text if before else
                              text + "\n" + stamp)
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}.cu changed: edit anchor not found "
                             f"once: {old!r}")
        src = src.replace(old, new)
    src = src.replace("namespace {\n", DECLS + "namespace {\n", 1)
    src += ACCESSORS
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}{tag}.cu"
    cu.write_text(src)
    lib = OUT / f"lib{name}{tag}.so"
    from repro_torch.kernels import build
    r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                        str(CSRC), "-o", str(lib), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    lib = ctypes.CDLL(str(lib))
    for fn, sig in build.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = sig
    return lib


def report(lib, n_ctas, names, label):
    """Per boundary: cycles from CTA entry (median, max) and from the
    boundary before it (median), over the CTAs that reached both."""
    n = n_ctas * 32
    c = np.zeros(n, np.int64)
    g = np.zeros(n, np.uint64)
    lib.stages_get(c.ctypes.data, g.ctypes.data, n)
    c, g = c.reshape(-1, 32), g.reshape(-1, 32).astype(np.int64)
    live = c[:, 0] != 0
    c, g = c[live], g[live]
    print(f"{label}: {int(live.sum())} CTAs ran past entry; entries spread "
          f"over {int(g[:, 0].max() - g[:, 0].min())} ns; the last CTA "
          f"ended {int((g.max(axis=1) - g[:, 0].min()).max())} ns after the "
          f"first began")
    prev = 0
    for k, name in names:
        ok = c[:, k] != 0
        if ok.any():
            d = c[ok, k] - c[ok, 0]
            both = ok & (c[:, prev] != 0)
            step = np.median(c[both, k] - c[both, prev]) if both.any() \
                else float("nan")
            print(f"  {name:28s} cycles from entry: median "
                  f"{np.median(d):8.0f}  max {d.max():8.0f}  from the last "
                  f"boundary: median {step:7.0f}  ({int(ok.sum())} CTAs)")
            prev = k


def flash_caller(lib, torch, fk, S, Sq, H, Kh, hd, hdv, q_offset, dev,
                 stream):
    """A launch of the instrumented flash library at B=1, f32, causal."""
    q = torch.randn(1, Sq, H, hd, device=dev)
    k = torch.randn(1, S, Kh, hd, device=dev)
    v = torch.randn(1, S, Kh, hdv, device=dev)
    out = torch.empty(1, Sq, H, hdv, device=dev)
    geo = fk._geometry(hd, hdv, torch.float32)
    scratch = torch.empty(H * Sq * fk.n_spans(S) * (hdv + 2), device=dev)

    def call():
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), 1, Sq, S, H, Kh, hd, hdv, q_offset, 1, 0,
            hd ** -0.5, 0, geo.span, geo.smem, stream)
        assert err == 0, err
    return call, geo


def run_stages(lib, torch, call, n_ctas, names, label):
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    lib.stages_clear()
    call()
    torch.cuda.synchronize()
    report(lib, n_ctas, names, label)


def span_names(tiles):
    """The span kernel's stages: per tile of the item, then its end."""
    return [(1 + 4 * t + j, f"tile {t}: {n}") for t in range(tiles)
            for j, n in enumerate(["ready", "S", "softmax, P exchanged",
                                   "P.V"])] + \
        [(17, "tiles done"), (18, "partials written")]


def hd256(torch, dk, fk, dev, stream):
    lib = instrument("decode_attention", DECODE)
    B, H, Kh, hd = 8, 4, 1, 256
    for Smax, lens in ((512, [1, 127, 128, 129, 512, 255, 384, 511]),
                       (1024, [1024, 1, 17, 512, 600, 333, 1000, 64])):
        q = torch.randn(B, H, hd, device=dev)
        kc = torch.randn(B, Kh, Smax, hd, device=dev)
        vc = torch.randn_like(kc)
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = torch.empty(B, H, hd, device=dev)
        scratch = dk._scratch(B, H, Kh, Smax, hd, dev)
        geo = dk._geometry(hd, torch.float32, H // Kh)
        tickets = dk._tickets(geo, B * Kh * geo.cluster, dev)

        def call():
            err = lib.decode_attention_launch(
                q.data_ptr(), kc.data_ptr(), vc.data_ptr(), cl.data_ptr(),
                scratch.data_ptr(), tickets.data_ptr(), out.data_ptr(), B, H,
                Kh, Smax, hd, hd, hd ** -0.5, 0, 0, geo.cluster, geo.smem,
                stream)
            assert err == 0, err
        run_stages(lib, torch, call, geo.cluster * dk.n_chunks(Smax) * B * Kh,
                   [(int(k), name) for _, k, name, _ in DECODE[1:]],
                   f"decode_cluster_kernel<float, 4>, Smax {Smax}, "
                   f"cache_len {lens}")

    lib = instrument("flash_attention", FLASH)
    S = 571
    call, geo = flash_caller(lib, torch, fk, S, S, H, 1, hd, hd, 0, dev,
                             stream)
    run_stages(lib, torch, call, len(fk.span_plan(S, S, q_offset=0)[2]) * H,
               span_names(4), f"flash_span_kernel<float, 256, 256>, "
               f"Sq=Skv={S}, H={H}, Kh=1, causal")


def hd128(torch, fk, dev, stream):
    from repro_torch.kernels import build
    build.library("flash_attention")
    print("ptxas (-Xptxas -v) of the flash kernels at (128, 128) and "
          "(192, 128):")
    for fn, r in sorted(build.ptxas_report("flash_attention").items()):
        if "Li128E" in fn:
            print(f"  {fn}: {r}")
    S, H = 512, 16
    lib = instrument("flash_attention", FLASH)
    call, _ = flash_caller(lib, torch, fk, S, S, H, H, 128, 128, 0, dev,
                           stream)
    run_stages(lib, torch, call, len(fk.span_plan(S, S, q_offset=0)[2]) * H,
               span_names(2), f"flash_span_kernel<float, 128, 128>, "
               f"Sq=Skv={S}, H=Kh={H}, causal")


def served_calls():
    """{run: {(Sq, Skv, q_offset, H, Kh): calls per layer}} for the flash
    calls of chip_smoke.py's phase 12 (16 prompts of 24-600 tokens, the
    same lengths as make_requests draws, pow2 buckets of at least 16 and at
    most max_seq 1024; chunks of 128 rows, a last partial chunk padded to
    its pow2 bucket) and phase 13 (exact lengths: Mamba layers do not
    bucket)."""
    import chip_smoke as cs
    from repro_torch.configs.base import get_arch
    from repro_torch.serving.workload import Request

    def pow2(n, cap):
        b = 16
        while b < n:
            b *= 2
        return min(b, cap)
    runs = {"deepseek-moe-16b whole prompts": {},
            "deepseek-moe-16b chunks of 128": {},
            "jamba-v0.1-52b whole prompts": {}}
    cfg = get_arch("deepseek-moe-16b").config
    for r in cs.make_requests(cfg, Request):
        n, sp = r.prompt_len, pow2(r.prompt_len, 1024)
        key = (sp, sp, 0, 16, 16)
        d = runs["deepseek-moe-16b whole prompts"]
        d[key] = d.get(key, 0) + 1
        d = runs["deepseek-moe-16b chunks of 128"]
        for c0 in range(0, n, 128):
            key = (pow2(min(128, n - c0), 128), sp, c0, 16, 16)
            d[key] = d.get(key, 0) + 1
    cfg = get_arch("jamba-v0.1-52b").config
    for r in cs.make_requests(cfg, Request):
        key = (r.prompt_len, r.prompt_len, 0, 32, 8)
        d = runs["jamba-v0.1-52b whole prompts"]
        d[key] = d.get(key, 0) + 1
    return runs


def served(torch, dev):
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import flash_attention
    print("flash at (128, 128), f32, over the served calls (CUDA events, "
          "ms per call; sum: calls x ms for one layer):")
    for run, calls in served_calls().items():
        total = 0.0
        for (Sq, Skv, qo, H, Kh), n in sorted(calls.items()):
            q = torch.randn(1, Sq, H, 128, device=dev)
            k, v = (torch.randn(1, Skv, Kh, 128, device=dev)
                    for _ in range(2))
            ms = cs.time_ms(torch,
                            lambda: flash_attention(q, k, v, q_offset=qo))
            total += n * ms
            print(f"  {run}: Sq={Sq} Skv={Skv} q_offset={qo} H={H} Kh={Kh}"
                  f"  x{n}  {ms:.4f} ms")
        print(f"  {run}: sum {total:.4f} ms per layer")


# the wkv6 backward kernel's stages, as cycles that thread 0 of each CTA
# adds up over the chunk loops (STG(k) adds the cycles since the last STG)
WKV_BWD_STAGES = [
    (0, "pass 1: chunk arrived"), (1, "pass 1: steps"),
    (2, "pass 2: copies awaited"), (3, "pass 2: barrier"),
    (4, "pass 2: next copies issued, dots"), (5, "pass 2: recompute and walk"),
    (6, "pass 2: dv written"), (7, "pass 2: cluster barrier"),
    (8, "pass 2: rows reduced"), (9, "dstate0, du")]
WKV_BWD_EDITS = [
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  cg::cluster_group cluster = cg::this_cluster();\n"
     "  long long c_last_ = clock64(), c_acc_[10] = {0};\n"),
    ("    cp_async_wait<2>();\n    __syncthreads();\n",
     "    cp_async_wait<2>();\n    __syncthreads();\n    STG(0)\n"),
    ("    __syncthreads();                 // this stage read before it is "
     "refilled\n  }\n",
     "    __syncthreads();                 // this stage read before it is "
     "refilled\n    STG(1)\n  }\n"),
    ("    cp_async_wait<0>();\n    // the chunk's stage has landed",
     "    cp_async_wait<0>();\n    STG(2)\n"
     "    // the chunk's stage has landed"),
    ("    if (ch > 0) stage(ch - 1);\n    cp_async_commit();\n",
     "    STG(3)\n    if (ch > 0) stage(ch - 1);\n    cp_async_commit();\n"),
    ("    // the chunk's second sub-chunk from the state TR steps in",
     "    STG(4)\n"
     "    // the chunk's second sub-chunk from the state TR steps in"),
    ("    cluster_arrive();     // this rank's pushes",
     "    STG(5)\n    cluster_arrive();     // this rank's pushes"),
    ("    cluster_wait();       // every rank's pushes",
     "    STG(6)\n    cluster_wait();       // every rank's pushes"),
    ("    // rows [rank RC, rank RC + RC)",
     "    STG(7)\n    // rows [rank RC, rank RC + RC)"),
    ("      du = fmaf(rr * kk, vdy, du);\n    }\n  }\n",
     "      du = fmaf(rr * kk, vdy, du);\n    }\n    STG(8)\n  }\n"),
    ("    a.du_part[size_t(bh) * HD + rank * RC + tid] = acc;\n  }\n}",
     "    a.du_part[size_t(bh) * HD + rank * RC + tid] = acc;\n  }\n"
     "  STG(9)\n  if (threadIdx.x == 0) {\n"
     "    const int id_ = blockIdx.y * gridDim.x + blockIdx.x;\n"
     "    for (int k_ = 0; k_ < 10; ++k_) stage_c[id_ * 32 + k_] = "
     "c_acc_[k_];\n  }\n}"),
    ("  RT_CASE(16) RT_CASE(32) RT_CASE(64) RT_CASE(128)\n#undef RT_CASE\n"
     "  return static_cast<int>(cudaErrorInvalidValue);\n}\n",
     "  RT_CASE(16) RT_CASE(32) RT_CASE(64) RT_CASE(128)\n#undef RT_CASE\n"
     "  return static_cast<int>(cudaErrorInvalidValue);\n}\n"
     "extern \"C\" int wkv6_bwd_occupancy64(int* clusters, int* blocks) {\n"
     "  using G = Geo<64>;\n  auto kern = wkv6_bwd_kernel<64>;\n"
     "  cudaFuncSetAttribute(kern, "
     "cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * G::kFloats);\n"
     "  cudaLaunchConfig_t cfg = {};\n"
     "  cfg.gridDim = dim3(G::C, 128, 1);\n"
     "  cfg.blockDim = dim3(G::NT, 1, 1);\n"
     "  cfg.dynamicSmemBytes = 4 * G::kFloats;\n"
     "  cudaLaunchAttribute attr[1];\n"
     "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
     "  attr[0].val.clusterDim.x = G::C;\n"
     "  attr[0].val.clusterDim.y = 1;\n  attr[0].val.clusterDim.z = 1;\n"
     "  cfg.attrs = attr;\n  cfg.numAttrs = 1;\n"
     "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, G::NT, "
     "4 * G::kFloats);\n"
     "  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, "
     "kern, &cfg));\n}\n"),
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n#define STG(k) if (threadIdx.x == "
     "0) { long long c_ = clock64(); c_acc_[k] += c_ - c_last_; c_last_ = "
     "c_; }\n"),
]


def wkv_bwd_stages(torch, dev, stream):
    """The wkv6 backward kernel at rwkv6-1.6b's training call, stage by
    stage: cycles per CTA summed over its chunks (median and largest over
    the CTAs)."""
    from repro_torch.kernels import rwkv6_wkv as RW
    lib = instrument("rwkv6_wkv_bwd", [], edits=WKV_BWD_EDITS)
    B, S, H, hd = 4, 512, 32, 64
    geo = RW._bwd_geometry(hd)
    r, k, v, dy = (torch.randn(B, S, H, hd, device=dev) for _ in range(4))
    w = torch.sigmoid(torch.randn(B, S, H, hd, device=dev)) * 0.5 + 0.45
    u = torch.randn(H, hd, device=dev) * 0.1
    st0 = torch.randn(B, H, hd, hd, device=dev)
    outs = [torch.empty_like(r) for _ in range(4)]
    du, ds0 = torch.empty_like(u), torch.empty_like(st0)
    scratch = torch.empty(B * H * hd + B * H * -(-S // geo.chunk) * hd * hd,
                          device=dev)

    def call():
        err = lib.wkv6_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), st0.data_ptr(), dy.data_ptr(), None,
            *(t.data_ptr() for t in outs), du.data_ptr(), ds0.data_ptr(),
            scratch.data_ptr(), B, S, H, hd, geo.cluster, geo.chunk,
            geo.smem, stream)
        assert err == 0, err
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    clusters, blocks = ctypes.c_int(0), ctypes.c_int(0)
    lib.wkv6_bwd_occupancy64(ctypes.byref(clusters), ctypes.byref(blocks))
    print(f"wkv6_bwd_kernel<64>: at most {clusters.value} clusters of "
          f"{geo.cluster} at once on the card, {blocks.value} CTAs an SM")
    lib.stages_clear()
    call()
    torch.cuda.synchronize()
    n = B * H * geo.cluster * 32
    c = np.zeros(n, np.int64)
    g = np.zeros(n, np.uint64)
    lib.stages_get(c.ctypes.data, g.ctypes.data, n)
    c = c.reshape(-1, 32)[:, :10]
    print(f"wkv6_bwd_kernel<64>, B={B} S={S} H={H}, {c.shape[0]} CTAs "
          f"(cycles a CTA, summed over its chunks):")
    for k, name in WKV_BWD_STAGES:
        print(f"  {name:30s} median {np.median(c[:, k]):9.0f}  max "
              f"{c[:, k].max():9.0f}")
    tot = c.sum(axis=1)
    print(f"  {'all':30s} median {np.median(tot):9.0f}  max {tot.max():9.0f}")


def bwd(torch, dev):
    import math

    import chip_smoke as cs
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv6_wkv as RW
    rng = np.random.default_rng(18)

    def rnd(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)

    def by_kernel(fn):
        rows, _ = cs.kernel_profile(torch, fn, 5)
        total = sum(r[1] for r in rows)
        return "; ".join(f"{key[:40]} {us / 5e3:.4f} ms ({us / total:.3f})"
                         for key, us, n in rows)

    print(f"backward kernels of {TREE}, f32 (CUDA events, ms per call):")
    B, S, H = 4, 512, 16
    for hd in (64, 128):
        q, k, v, do = (rnd((B, S, H, hd)) for _ in range(4))
        with torch.no_grad():
            o = FA.flash_attention(q, k, v)
        args = (q, k, v, o, do, True, 0, 1.0 / math.sqrt(hd), 0)
        ms = cs.time_ms(torch, lambda: FA._launch_backward(*args))
        with torch.enable_grad():
            sins = [t.transpose(1, 2).contiguous().requires_grad_(True)
                    for t in (q, k, v)]
            so = F.scaled_dot_product_attention(*sins, is_causal=True)
            sdo = do.transpose(1, 2).contiguous()
            lib = cs.time_ms(torch, lambda: torch.autograd.grad(
                so, sins, sdo, retain_graph=True))
        del so, sins
        print(f"  flash backward ({hd}, {hd}) B={B} Sq=Skv={S} H={H} causal:"
              f" {ms:.4f} ms  SDPA backward {lib:.4f} ms  ratio "
              f"{ms / lib:.3f}")
        shares = by_kernel(lambda: FA._launch_backward(*args))
        print(f"    by kernel: {shares}")
    B, S, H, hd = 4, 512, 32, 64
    r, kk, vv = (rnd((B, S, H, hd), 0.5) for _ in range(3))
    w = torch.sigmoid(rnd((B, S, H, hd))) * 0.5 + 0.45
    u, st0, dy = rnd((H, hd), 0.1), rnd((B, H, hd, hd)), rnd((B, S, H, hd))
    wargs = (r, kk, vv, w, u, st0, dy, None)
    ms = cs.time_ms(torch, lambda: RW._launch_backward(*wargs))
    print(f"  wkv6 backward B={B} S={S} H={H} hd={hd} state0: {ms:.4f} ms")
    print(f"    by kernel: {by_kernel(lambda: RW._launch_backward(*wargs))}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    global TREE, CSRC
    args = sys.argv[1:]
    if args[:1] == ["--tree"]:
        TREE = Path(args[1]).resolve()
        CSRC = TREE / "src" / "repro_torch" / "kernels" / "csrc"
        args = args[2:]
    sys.path.insert(0, str(TREE / "src"))
    sys.path.insert(0, str(ROOT))
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    which = args or ["hd256", "hd128", "served"]
    if "hd256" in which:
        hd256(torch, dk, fk, dev, stream)
    if "hd128" in which:
        hd128(torch, fk, dev, stream)
    if "served" in which:
        served(torch, dev)
    if "bwd" in which:
        bwd(torch, dev)
    if "wkvbwd" in which:
        wkv_bwd_stages(torch, dev, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
