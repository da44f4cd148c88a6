#!/usr/bin/env python3
"""Where the flash, decode and backward kernels spend their time, stage by
stage, on one NVIDIA GPU, and what flash costs over the calls the served
models make.

    python3 tools/kernel_stages.py [--tree DIR] [hd256] [hd128] [served] [bwd]
                                   [wkvbwd] [bf16bwd] [bf16fwd] [decode]

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

bwd: the backward kernels through the tree's own launchers at the
training calls of chip_smoke.py's phases 18 and 21 (flash at qwen1.5-0.5b's
B 4, Sq = Skv 512, 16 heads of 64, causal, and at (128, 128) on the same
shape, in f32 and in bf16; wkv6 at rwkv6-1.6b's B 4, S 512, 32 heads of 64,
with a state0, f32), each timed with CUDA events beside SDPA's backward on
the same inputs (in the same dtype), and the device time of each kernel of
a call (torch.profiler).  Run it on the parent and the change in turns
(parent, change, change, parent) in one call to compare the two.

bf16bwd: the bf16 flash backward's two kernels (dq_bf16_kernel, then
dkdv_bf16_kernel) at qwen1.5-0.5b's training call and at (128, 128),
through an instrumented copy of csrc/flash_attention_bwd.cu: per CTA its
entry and exit (%globaltimer) and the tiles it walks, reported as each
kernel's span and the CTA time by tiles walked (the slope is the time a
tile costs under the card's real concurrency); and a copy with every
product of the dK/dV kernel removed (its loads, barriers and softmax
alone; outputs wrong, timing only), timed beside the real call.

bf16fwd: the bf16 flash forward through the tree's own wrapper at
qwen1.5-0.5b's training call (B 4, Sq = Skv 512, 16 heads of 64, causal),
at the (128, 128) template on the same shape (deepseek-moe-16b's call),
at (192, 128) on deepseek-v2-236b's MLA prefill (B 1, 128 heads, a
512 bucket and the 1024 bucket, causal) and at (256, 256) on gemma3-1b's
571-token prompt (B 1, 4 heads on 1, causal and window 512), each beside
SDPA's bf16 forward on the same inputs (GQA heads expanded by
enable_gqa, the window as a mask) (run it on the parent and the change
in turns in one call); where the
tree's flash_wgmma_kernel takes (192, 128) with a per-pair ring depth
(kWgStages192), that pair again through a copy of the source built with
the other depth (2 or 3 stages), in turns with the tree's; where the
tree's span combine loads several spans' partials at once
(kCombineGroup), the (256, 256) calls again through a copy whose combine
loads one span at a time, in turns with the tree's; then,
where the tree has flash_wgmma_kernel, that kernel's registers and spills
and its per-CTA timeline at each of those calls it takes, (192, 128) at
the 512 bucket (an instrumented copy of csrc/flash_attention.cu): each
CTA's entry and exit (%globaltimer) and its
tiles, the time a tile costs under the card's real concurrency, and by
tiles walked the median cycles of the prologue (Q and the first tile
issued and awaited), a tile's stages (its copies awaited, the barrier and
the next tile's copies issued; S, with the last tile's P.V issued behind
it; the softmax, while that P.V runs; that P.V awaited, O rescaled and P
split) and the epilogue (the last tile's P.V, O stored); and where the
tree has flash_wgspan_kernel, its registers and spills and its per-CTA
timeline at gemma3-1b's two calls: each CTA's entry and exit, its SM, its
span and tiles, and by tiles walked the median cycles of finding its item,
issuing its copies, each tile's stages (its copies awaited and the
barrier; S, with tile 0's P.V issued behind it; the softmax; that P.V
awaited, O rescaled and P split), the last P.V and the epilogue (rows
staged in shared memory, their stores issued: thread 0's clock does not
see them drain), beside the combine kernel's device time.

decode: decode at DECODE_ROWS, B 8: qwen1.5-0.5b's G = 1 shape (16 heads
of 64, Smax 1024, ragged lengths) over every (q, cache) pair of {f32, bf16}
x {f32, bf16, fp8}, deepseek-moe-16b's 16 heads of 128 and whisper-tiny's
cross decode over 1500 rows (f32), qwen1.5-110b's G = 8 at the chunk edges
(f32 and bf16), jamba's 32 on 8, vision's cross decode over 1601 rows, and
gemma3-1b's bf16 decode at hd 256 (a 512-row ring and 1024 rows), and an
f32 query over each cache type at the lane core's other instantiations (hd
16 and 32 at G 1 and 2, hd 64 at G 2, hd 128) and the mma core at hd 32,
dense and paged, through each tree's library called raw with its own
wrapper's geometry.  Unlike the other modes, --tree DIR here names a
second tree (a parent unpacked under build/): this checkout's kernels,
copies of its source with VARIANTS' edits (below hd 256) and DIR's are
timed in turns (DIR, checkout, the variants and back; whether each gives
the checkout's bits), each row beside its bytes bound, the
plain version and SDPA's masked call (dense, q and the cache in one
dtype), with device time by kernel and the combine kernel's share
(profiler); then each tree's G <= 2 core at qwen1.5-0.5b's bf16 shape,
dense, stage by stage: cycles that thread 0 of each CTA adds up per stage
(an instrumented copy; decode_split_kernel's stages inside its loop are
summed over it), median and largest over the live CTAs.

wkvbwd: the wkv6 backward kernel at the same rwkv6 call, stage by stage:
cycles that thread 0 of each CTA adds up per stage over the chunk loops
(an instrumented copy of csrc/rwkv6_wkv_bwd.cu), and how many of its
clusters the card holds at once (cudaOccupancyMaxActiveClusters).

Needs CUDA and nvcc; exits non-zero without them.
"""
import ctypes
import re
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
    ("  const Item item = find_item<BK, kThreads>(blockIdx.x,", "0",
     "entry", True),
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


def instrument(name, points, tag="", edits=(), csrc=None, defer=False):
    """An instrumented copy of csrc/``name``.cu, built and loaded; with
    ``defer``, its nvcc started and a function returned that waits for it
    and loads the library (so several copies build at once)."""
    csrc = csrc or CSRC
    src = (csrc / f"{name}.cu").read_text()
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
    proc = subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                             str(csrc), "-o", str(lib), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)

    def load():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(log)
        out = ctypes.CDLL(str(lib))
        for fn, sig in build.SIGNATURES[name].items():
            getattr(out, fn).argtypes = sig
        return out
    return load if defer else load()


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
        tickets = dk._tickets(B * Kh * geo.cluster, dev)

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


GTIME = ("unsigned long long {v}; asm volatile(\"mov.u64 %0, "
         "%%globaltimer;\" : \"=l\"({v}));")
# per CTA: entry and exit times in stage_g, its SM and tiles walked in
# stage_c; the dQ kernel in slots 0-1, the dK/dV kernel in slots 2-3
BF16_TIMELINE = [
    ("  const int row0 = q0 + 16 * rq;                 // this warp's rows\n",
     "  const int row0 = q0 + 16 * rq;                 // this warp's rows\n"
     "  " + GTIME.format(v="tl0_") + "\n"),
    ("      store2(pq + 8 * n, dq[n][2 * r] * f, dq[n][2 * r + 1] * f);\n"
     "  }\n}",
     "      store2(pq + 8 * n, dq[n][2 * r] * f, dq[n][2 * r + 1] * f);\n"
     "  }\n  if (threadIdx.x == 0) {\n    " + GTIME.format(v="tl1_") +
     "\n    unsigned sm_; asm volatile(\"mov.u32 %0, %%smid;\" : "
     "\"=r\"(sm_));\n    const int id_ = blockIdx.y * gridDim.x + "
     "blockIdx.x;\n    stage_g[id_ * 32] = tl0_; stage_g[id_ * 32 + 1] = "
     "tl1_;\n    stage_c[id_ * 32] = sm_; stage_c[id_ * 32 + 1] = nk;\n  }"
     "\n}"),
    ("  const int key0 = k0 + 16 * rk;                 // this warp's keys\n",
     "  const int key0 = k0 + 16 * rk;                 // this warp's keys\n"
     "  " + GTIME.format(v="tl0_") + "\n"),
    ("      store2(pv + 8 * n, dv[n][2 * r], dv[n][2 * r + 1]);\n  }\n}\n\n"
     "template <typename K>",
     "      store2(pv + 8 * n, dv[n][2 * r], dv[n][2 * r + 1]);\n  }\n"
     "  if (threadIdx.x == 0) {\n    " + GTIME.format(v="tl1_") +
     "\n    unsigned sm_; asm volatile(\"mov.u32 %0, %%smid;\" : "
     "\"=r\"(sm_));\n    const int id_ = blockIdx.y * gridDim.x + "
     "blockIdx.x;\n    stage_g[id_ * 32 + 2] = tl0_; stage_g[id_ * 32 + 3] "
     "= tl1_;\n    stage_c[id_ * 32 + 2] = sm_; stage_c[id_ * 32 + 3] = "
     "n_it;\n  }\n}\n\ntemplate <typename K>"),
]
# the dK/dV kernel without its four products
BF16_NO_PRODUCTS = [
    ("      mma_rows<HD, NT, QS, QS>(s, kw, qst, lane);\n", "      zero(s);\n"),
    ("      mma_rows<HDV, NT, VS, VS>(dp, vw, ost, lane);\n",
     "      zero(dp);\n"),
    ("      mma_frag<NT / 2, G::NV, VS>(dv, s, ost + ck * (HDV / G::CK), "
     "lane);\n", ""),
    ("      mma_frag<NT / 2, G::NK, QS>(dk, dp, qst + ck * (HD / G::CK), "
     "lane);\n", ""),
]


def bf16_bwd_stages(torch, dev, stream):
    """The bf16 flash backward's kernels at the training calls: per-CTA
    timelines, and the dK/dV kernel without its products."""
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    timed = instrument("flash_attention_bwd", [], tag="_timeline",
                       edits=BF16_TIMELINE)
    bare = instrument("flash_attention_bwd", [], tag="_noprod",
                      edits=BF16_NO_PRODUCTS)
    regs = {}
    for k, r in build.ptxas_report("flash_attention_bwd").items():
        m = re.search(r"([a-z]+_bf16_kernel)ILi(\d+)ELi(\d+)E", k)
        if m and "registers" in r:
            regs[f"{m.group(1)}<{m.group(2)},{m.group(3)}>"] = r["registers"]
    print(f"bf16 flash backward kernels, registers a thread: {regs}")
    rng = np.random.default_rng(28)
    B, S, H = 4, 512, 16
    for hd in (64, 128):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (B, S, H, hd)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(4))
        with torch.no_grad():
            o = FA.flash_attention(q, k, v)
        geo = FA._bwd_geometry(hd, hd, torch.bfloat16)
        outs = [torch.empty_like(t) for t in (q, k, v)]
        scratch = torch.empty(2 * B * H * S, device=dev)

        def call(lib):
            err = lib.flash_attention_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), *(t.data_ptr() for t in outs),
                scratch.data_ptr(), B, S, S, H, H, hd, hd, 0, 1, 0,
                hd ** -0.5, 1, geo.keys, geo.rows, geo.smem, geo.row_smem,
                stream)
            assert err == 0, err
        ms = {}
        for name, lib in (("real", build.library("flash_attention_bwd")),
                          ("no dK/dV products", bare), ("real", None)):
            lib = lib or build.library("flash_attention_bwd")
            ms.setdefault(name, []).append(
                cs.time_ms(torch, lambda: call(lib), iters=50))
        print(f"  ({hd}, {hd}) B={B} Sq=Skv={S} H={H} causal: "
              + "; ".join(f"{n} {min(t):.4f} ms" for n, t in ms.items()))
        for _ in range(3):
            call(timed)
        torch.cuda.synchronize()
        timed.stages_clear()
        call(timed)
        torch.cuda.synchronize()
        n = 1 << 16
        c = np.zeros(n, np.int64)
        g = np.zeros(n, np.uint64)
        timed.stages_get(c.ctypes.data, g.ctypes.data, n)
        c, g = c.reshape(-1, 32), g.reshape(-1, 32).astype(np.int64)
        for name, k0 in (("dq_bf16_kernel", 0), ("dkdv_bf16_kernel", 2)):
            live = g[:, k0] != 0
            t0 = g[live, k0].min()
            dur = (g[live, k0 + 1] - g[live, k0]) / 1e3
            tiles = c[live, k0 + 1]
            fit = np.polyfit(tiles, dur, 1) if len(set(tiles)) > 1 \
                else (float("nan"), float("nan"))
            print(f"    {name}: {int(live.sum())} CTAs on "
                  f"{len(set(c[live, k0]))} SMs, span "
                  f"{(g[live, k0 + 1].max() - t0) / 1e3:.2f} us, last entry "
                  f"{(g[live, k0].max() - t0) / 1e3:.2f} us; CTA us = "
                  f"{fit[1]:.2f} + {fit[0]:.2f} per tile walked")
            for nt in sorted(set(tiles)):
                sel = tiles == nt
                print(f"      {nt:3d} tiles: {int(sel.sum()):4d} CTAs, us "
                      f"median {np.median(dur[sel]):.2f} max "
                      f"{dur[sel].max():.2f}, entry median "
                      f"{np.median(g[live, k0][sel] - t0) / 1e3:.2f}")


# the bf16 one-pass forward (flash_wgmma_kernel): thread 0 of each CTA
# stamps clock64 at its entry (slot 0), when its first copies are issued (1)
# and per tile walked (the first FWD_TILES): the tile ready (2 + 4 it), S
# (3 + 4 it), softmax and P split (4 + 4 it), P.V (5 + 4 it); and its end
# (62); stage_g holds the CTA's entry and exit %globaltimer, its SM and the
# tiles it walked (slots 0-3)
FWD_TILES = 14
FWD_SLOTS = 64
FWD_STAMP = ("if (threadIdx.x == 0) stage_c[((blockIdx.y * gridDim.x + "
             "blockIdx.x) * {n}) + ({k})] = clock64();\n")


def _fwd_stamp(k):
    return FWD_STAMP.format(n=FWD_SLOTS, k=k)


FWD_TIMELINE = [
    ("  unsigned char* vs = ks + NS * KT;\n",
     "  unsigned char* vs = ks + NS * KT;\n  " + _fwd_stamp(0)
     + "  " + GTIME.format(v="tl0_") + "\n"),
    ("    if (!kLagV) load_v(0);\n  }\n  cp_async_commit();\n",
     "    if (!kLagV) load_v(0);\n  }\n  cp_async_commit();\n  "
     + _fwd_stamp(1)),
    ("    const int st = it % NS;\n",
     "    const int st = it % NS;\n    const int sl_ = 2 + 4 * "
     f"min(it, {FWD_TILES - 1});\n    " + _fwd_stamp("sl_")),
    ("    rt::reg_fence(s);\n",
     "    rt::reg_fence(s);\n    " + _fwd_stamp("sl_ + 1")),
    ("    // tile it - 1's P.V is done: O and P's registers are free\n",
     "    " + _fwd_stamp("sl_ + 2")
     + "    // tile it - 1's P.V is done: O and P's registers are free\n"),
    ("    wg_split(s, ph, pl);\n  }\n  if (n_tiles > 0) {",
     "    wg_split(s, ph, pl);\n    " + _fwd_stamp("sl_ + 3")
     + "  }\n  if (n_tiles > 0) {"),
    ("                                                            c));\n"
     "  }\n}",
     "                                                            c));\n"
     "  }\n  " + _fwd_stamp(62) + "  if (threadIdx.x == 0) {\n    "
     + GTIME.format(v="tl1_") + "\n    unsigned sm_; asm volatile(\"mov.u32 "
     "%0, %%smid;\" : \"=r\"(sm_));\n    const int id_ = (blockIdx.y * "
     f"gridDim.x + blockIdx.x) * {FWD_SLOTS};\n    stage_g[id_] = tl0_; "
     "stage_g[id_ + 1] = tl1_; stage_g[id_ + 2] = sm_; stage_g[id_ + 3] = "
     "n_tiles;\n  }\n}"),
]


# (hd, hdv, B, S, H, Kh, window): the bf16 forward's calls that bf16fwd
# times, causal and end-aligned; gemma3-1b's are its two layer kinds on
# its longest prompt
FWD_CALLS = [(64, 64, 4, 512, 16, 16, 0), (128, 128, 4, 512, 16, 16, 0),
             (192, 128, 1, 512, 128, 128, 0),
             (192, 128, 1, 1024, 128, 128, 0),
             (256, 256, 1, 571, 4, 1, 0), (256, 256, 1, 571, 4, 1, 512)]
# the ring depth at (192, 128) (kWgStages192), and the other one tried
DEPTH_192 = "constexpr int kWgStages192 = {};"
# the spans of a row whose partials the combine loads at once, and the
# one-span-at-a-time combine it replaced (the same sums, the same bits)
COMBINE_GROUP = ("constexpr int kCombineGroup = 8;",
                 "constexpr int kCombineGroup = 1;")


def _bf16_inputs(torch, rng, dev, hd, hdv, B, S, H, Kh=None):
    Kh = H if Kh is None else Kh
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, torch.bfloat16)
        for shape in ((B, S, H, hd), (B, S, Kh, hd), (B, S, Kh, hdv)))
    return q, k, v


def _raw_wgmma(torch, lib, q, k, v, stages, stream):
    """A causal bf16 call through ``lib``'s launcher with the one-pass
    geometry of a ``stages``-deep ring."""
    from repro_torch.kernels import flash_attention as FA
    B, S, H, hd = q.shape
    hdv = v.shape[-1]
    out = torch.empty((B, S, H, hdv), dtype=q.dtype, device=q.device)
    smem = FA.wg_smem(hd, hdv, stages)

    def call():
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            B, S, S, H, H, hd, hdv, 0, 1, 0, hd ** -0.5, 1, 0, smem, stream)
        assert err == 0, err
        return out
    return call


def _raw_wgspan(torch, lib, q, k, v, window, stream):
    """A causal bf16 call through ``lib``'s launcher with the bf16 span
    design's geometry (flash_wgspan_kernel, then the combine)."""
    from repro_torch.kernels import flash_attention as FA
    B, S, H, hd = q.shape
    Kh, hdv = k.shape[2], v.shape[-1]
    out = torch.empty((B, S, H, hdv), dtype=q.dtype, device=q.device)
    scratch = torch.empty(B * H * S * FA.n_spans(S) * (hdv + 2),
                          dtype=torch.float32, device=q.device)

    def call():
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, S, S, H, Kh, hd, hdv, 0, 1, window,
            hd ** -0.5, 1, FA.SPAN, FA.wg_span_smem(hd, hdv), stream)
        assert err == 0, err
        return out
    return call


def bf16_fwd_stages(torch, dev, stream):
    """The bf16 forward at FWD_CALLS through the tree's wrapper, beside
    SDPA's bf16 forward; (192, 128) at the other ring depth in turns with
    the tree's; then, where the tree has flash_wgmma_kernel, its per-CTA
    timeline at each of those calls that it takes, from an instrumented
    copy."""
    import chip_smoke as cs
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    rng = np.random.default_rng(29)
    src = (CSRC / "flash_attention.cu").read_text()
    depth = next((n for n in (2, 3) if src.count(DEPTH_192.format(n)) == 1),
                 None)
    alt = 5 - depth if depth else None
    other = instrument("flash_attention", [], tag=f"_depth{alt}", edits=[
        (DEPTH_192.format(depth), DEPTH_192.format(alt))]) if depth else None
    one_span = instrument("flash_attention", [], tag="_combine1",
                          edits=[COMBINE_GROUP]) \
        if src.count(COMBINE_GROUP[0]) == 1 else None
    print(f"bf16 flash forward of {TREE} (CUDA events, ms per call):")
    for hd, hdv, B, S, H, Kh, win in FWD_CALLS:
        q, k, v = _bf16_inputs(torch, rng, dev, hd, hdv, B, S, H, Kh)
        sq, sk, sv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = FA.attention_mask(S, S, causal=True, window=win, q_offset=0,
                                 device=q.device)
        sdpa = (lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask, enable_gqa=True)) if win else \
            (lambda: F.scaled_dot_product_attention(
                sq, sk, sv, is_causal=True, enable_gqa=True))
        ms, lib = [], []
        with torch.no_grad():
            for _ in range(2):
                ms.append(cs.time_ms(
                    torch, lambda: FA.flash_attention(q, k, v, window=win),
                    iters=50))
                lib.append(cs.time_ms(torch, sdpa, iters=50))
            print(f"  ({hd}, {hdv}) B={B} Sq=Skv={S} H={H} Kh={Kh} "
                  f"{f'window={win}' if win else 'causal'}: "
                  f"{min(ms):.4f} ms ({ms[0]:.4f}, {ms[1]:.4f})  SDPA bf16 "
                  f"forward {min(lib):.4f} ms  ratio "
                  f"{min(ms) / min(lib):.3f}")
            if hd == 192 and other is not None:
                mine = lambda: FA.flash_attention(q, k, v)  # noqa: E731
                alt_call = _raw_wgmma(torch, other, q, k, v, alt, stream)
                ref = mine()
                same = torch.equal(alt_call(), ref)
                turns = [cs.time_ms(torch, f, iters=50)
                         for f in (mine, alt_call, alt_call, mine)]
                print(f"    ring depth {depth} (the tree's) {turns[0]:.4f}, "
                      f"{turns[3]:.4f} ms; {alt} stages {turns[1]:.4f}, "
                      f"{turns[2]:.4f} ms (turns: tree, {alt}, {alt}, "
                      f"tree); the same bits: {same}")
            if hd == 256 and one_span is not None \
                    and f"RT_WGS({hd}, {hdv})" in src:
                mine = lambda: FA.flash_attention(  # noqa: E731
                    q, k, v, window=win)
                alt_call = _raw_wgspan(torch, one_span, q, k, v, win, stream)
                same = torch.equal(alt_call(), mine())
                turns = [cs.time_ms(torch, f, iters=50)
                         for f in (mine, alt_call, alt_call, mine)]
                print(f"    combine loading 8 spans at once (the tree's) "
                      f"{turns[0]:.4f}, {turns[3]:.4f} ms; one span at a "
                      f"time {turns[1]:.4f}, {turns[2]:.4f} ms (turns: "
                      f"tree, one, one, tree); the same bits: {same}")
    build.library("flash_attention")
    regs = {k: r for k, r in build.ptxas_report("flash_attention").items()
            if "flash_wgmma_kernel" in k or "flash_wgspan_kernel" in k}
    print(f"  flash_wgmma_kernel and flash_wgspan_kernel registers and "
          f"spills: {regs}")
    if all(src.count(old) == 1 for old, _ in FWD_TIMELINE):
        fwd_timeline(torch, dev, stream,
                     [c[:5] for c in FWD_CALLS[:3]
                      if f"RT_WG({c[0]}, {c[1]})" in src])
    else:
        print("  (no flash_wgmma_kernel of this layout in this tree: no "
              "timeline)")
    if all(src.count(old) == 1 for old, _ in WGSPAN_TIMELINE):
        timed = instrument("flash_attention", [], tag="_wgspan_timeline",
                           edits=WGSPAN_TIMELINE)
        for hd, hdv, B, S, H, Kh, win in FWD_CALLS:
            if f"RT_WGS({hd}, {hdv})" in src:
                _wgspan_timeline(torch, dev, stream, timed, hd, hdv, B, S,
                                 H, Kh, win)
    else:
        print("  (no flash_wgspan_kernel in this tree: no span timeline)")


def fwd_timeline(torch, dev, stream, calls, tag="_fwd_timeline"):
    """flash_wgmma_kernel's per-CTA timeline at each (hd, hdv, B, S, H) of
    ``calls``, from an instrumented copy of the tree's
    csrc/flash_attention.cu."""
    timed = instrument("flash_attention", [], tag=tag, edits=FWD_TIMELINE)
    for call in calls:
        _fwd_timeline(torch, dev, stream, timed, *call)


def _fwd_timeline(torch, dev, stream, timed, hd, hdv, B, S, H):
    from repro_torch.kernels import flash_attention as FA
    rng = np.random.default_rng(29)
    q, k, v = _bf16_inputs(torch, rng, dev, hd, hdv, B, S, H)
    call = _raw_wgmma(torch, timed, q, k, v, FA.wg_stages(hd), stream)
    assert B * H * -(-S // FA.TILE_Q) * FWD_SLOTS <= 1 << 16, \
        "more CTAs than the stamp arrays hold"
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    timed.stages_clear()
    call()
    torch.cuda.synchronize()
    n = 1 << 16
    c = np.zeros(n, np.int64)
    g = np.zeros(n, np.uint64)
    timed.stages_get(c.ctypes.data, g.ctypes.data, n)
    c = c.reshape(-1, FWD_SLOTS)
    g = g.reshape(-1, FWD_SLOTS).astype(np.int64)
    live = g[:, 0] != 0
    c, g = c[live], g[live]
    t0 = g[:, 0].min()
    dur = (g[:, 1] - g[:, 0]) / 1e3
    tiles = g[:, 3]
    fit = np.polyfit(tiles, dur, 1)
    print(f"  flash_wgmma_kernel<{hd}, {hdv}>, B={B} Sq=Skv={S} H={H} "
          "causal: "
          f"{len(g)} CTAs on {len(set(g[:, 2]))} SMs, span "
          f"{(g[:, 1].max() - t0) / 1e3:.2f} us, last entry "
          f"{(g[:, 0].max() - t0) / 1e3:.2f} us; CTA us = {fit[1]:.2f} + "
          f"{fit[0]:.2f} per tile walked")
    for nt in sorted(set(tiles)):
        sel = tiles == nt
        cc = c[sel]
        last = 2 + 4 * (min(nt, FWD_TILES) - 1)
        stages = {"prologue (entry to tile 0 ready)": cc[:, 2] - cc[:, 0],
                  "epilogue (the last P.V, O stored)":
                      cc[:, 62] - cc[:, last + 3]}
        per = {"ready (copies awaited, barrier, next issued)": [],
               "S (the last tile's P.V issued)": [], "softmax": [],
               "the last tile's P.V awaited, O rescaled, P split": []}
        names = list(per)
        for it in range(min(nt, FWD_TILES)):
            b = 2 + 4 * it
            if it:
                per[names[0]].append(cc[:, b] - cc[:, b - 1])
            for j in range(1, 4):
                per[names[j]].append(cc[:, b + j] - cc[:, b + j - 1])
        txt = "; ".join(f"{name} {np.median(x):.0f}"
                        for name, x in stages.items())
        txt += "; a tile: " + ", ".join(
            f"{name} {np.median(np.concatenate(x)):.0f}"
            for name, x in per.items() if x)
        print(f"    {nt:3d} tiles: {int(sel.sum()):4d} CTAs, us median "
              f"{np.median(dur[sel]):.2f} max {dur[sel].max():.2f}, entry "
              f"median {np.median(g[sel, 0] - t0) / 1e3:.2f}; cycles "
              f"(median): {txt}")


# flash_wgspan_kernel (the bf16 span design): thread 0 of each CTA stamps
# clock64 at its entry (slot 0), its item found (1), its copies issued (2),
# per tile it (of at most 2): the tile ready (3 + 4 it), S (4 + 4 it), the
# softmax (5 + 4 it), tile 0's P.V awaited, O rescaled and P split (6 + 4
# it); the last P.V done (11), its rows staged in shared memory (12) and
# its end (62); stage_g holds its entry and
# exit %globaltimer, its SM, its tiles and its span (slots 0-4)
WGSPAN_TIMELINE = [
    ("  unsigned char* vs = ks + NT * KT;\n",
     "  unsigned char* vs = ks + NT * KT;\n  " + _fwd_stamp(0)
     + "  " + GTIME.format(v="tl0_") + "\n"),
    ("  const int n_tiles = span_tiles<BK>(tk, span);   // 1 or 2\n",
     "  const int n_tiles = span_tiles<BK>(tk, span);   // 1 or 2\n  "
     + _fwd_stamp(1)),
    ("  if (n_tiles > 1) load(VTile{}, 1, v, vs);\n  cp_async_commit();\n",
     "  if (n_tiles > 1) load(VTile{}, 1, v, vs);\n  cp_async_commit();\n  "
     + _fwd_stamp(2)),
    ("    __syncthreads();   // every thread's copies of them landed\n",
     "    __syncthreads();   // every thread's copies of them landed\n    "
     + _fwd_stamp("3 + 4 * it")),
    ("    rt::reg_fence(s);   // S of tile it is in registers\n",
     "    rt::reg_fence(s);   // S of tile it is in registers\n    "
     + _fwd_stamp("4 + 4 * it")),
    ("    // tile 0's P.V is done: O and P's registers are free\n",
     "    " + _fwd_stamp("5 + 4 * it")
     + "    // tile 0's P.V is done: O and P's registers are free\n"),
    ("    wg_split(s, ph, pl);\n  }\n  // the last tile's P.V, once its V "
     "landed\n",
     "    wg_split(s, ph, pl);\n    " + _fwd_stamp("6 + 4 * it")
     + "  }\n  // the last tile's P.V, once its V landed\n"),
    ("    for (int hf = 0; hf < NH; ++hf) rt::reg_fence(o[hf]);\n  }\n",
     "    for (int hf = 0; hf < NH; ++hf) rt::reg_fence(o[hf]);\n  }\n  "
     + _fwd_stamp(11)),
    ("  __syncthreads();\n  for (int rr = warp; rr < kBQ; rr += kWgThreads "
     "/ 32) {\n",
     "  __syncthreads();\n  " + _fwd_stamp(12) + "  for (int rr = warp; rr "
     "< kBQ; rr += kWgThreads / 32) {\n"),
    ("    for (int i = lane; i < (HDV + 2) / 2; i += 32) pp[i] = s2[i];\n"
     "  }\n}",
     "    for (int i = lane; i < (HDV + 2) / 2; i += 32) pp[i] = s2[i];\n"
     "  }\n  " + _fwd_stamp(62) + "  if (threadIdx.x == 0) {\n    "
     + GTIME.format(v="tl1_") + "\n    unsigned sm_; asm volatile(\"mov.u32 "
     "%0, %%smid;\" : \"=r\"(sm_));\n    const int id_ = (blockIdx.y * "
     f"gridDim.x + blockIdx.x) * {FWD_SLOTS};\n    stage_g[id_] = tl0_; "
     "stage_g[id_ + 1] = tl1_; stage_g[id_ + 2] = sm_; stage_g[id_ + 3] = "
     "n_tiles; stage_g[id_ + 4] = span;\n  }\n}"),
]


def _wgspan_timeline(torch, dev, stream, timed, hd, hdv, B, S, H, Kh,
                     window):
    """flash_wgspan_kernel's per-CTA timeline at one causal call (an
    instrumented copy), beside the combine kernel's device time."""
    import chip_smoke as cs
    rng = np.random.default_rng(29)
    q, k, v = _bf16_inputs(torch, rng, dev, hd, hdv, B, S, H, Kh)
    call = _raw_wgspan(torch, timed, q, k, v, window, stream)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    timed.stages_clear()
    call()
    torch.cuda.synchronize()
    n = 1 << 16
    c = np.zeros(n, np.int64)
    g = np.zeros(n, np.uint64)
    timed.stages_get(c.ctypes.data, g.ctypes.data, n)
    c = c.reshape(-1, FWD_SLOTS)
    g = g.reshape(-1, FWD_SLOTS).astype(np.int64)
    live = g[:, 0] != 0
    assert live.sum() * FWD_SLOTS <= n, "more CTAs than the stamp arrays hold"
    c, g = c[live], g[live]
    t0 = g[:, 0].min()
    dur = (g[:, 1] - g[:, 0]) / 1e3
    tiles = g[:, 3]
    rows, _ = cs.kernel_profile(torch, call, 20)
    kern = "; ".join(f"{key.split('::')[-1][:32]} {us / 20:.2f} us"
                     for key, us, _ in rows)
    print(f"  flash_wgspan_kernel<{hd}, {hdv}>, B={B} Sq=Skv={S} H={H} "
          f"Kh={Kh} {f'window={window}' if window else 'causal'}: "
          f"{len(g)} CTAs on {len(set(g[:, 2]))} SMs, span "
          f"{(g[:, 1].max() - t0) / 1e3:.2f} us, last entry "
          f"{(g[:, 0].max() - t0) / 1e3:.2f} us; device time by kernel "
          f"(profiler, instrumented copy): {kern}")
    for nt in sorted(set(tiles)):
        sel = tiles == nt
        cc = c[sel]
        last = 6 + 4 * (nt - 1)
        txt = (f"item found {np.median(cc[:, 1] - cc[:, 0]):.0f}, copies "
               f"issued {np.median(cc[:, 2] - cc[:, 1]):.0f}")
        for it in range(nt):
            b = 3 + 4 * it
            ready = np.median(cc[:, b] - cc[:, b - 1])
            txt += (f"; tile {it}: ready {ready:.0f}"
                    f", S {np.median(cc[:, b + 1] - cc[:, b]):.0f}, softmax "
                    f"{np.median(cc[:, b + 2] - cc[:, b + 1]):.0f}, P.V "
                    "awaited, O rescaled, P split "
                    f"{np.median(cc[:, b + 3] - cc[:, b + 2]):.0f}")
        txt += (f"; the last P.V {np.median(cc[:, 11] - cc[:, last]):.0f}, "
                f"rows staged {np.median(cc[:, 12] - cc[:, 11]):.0f}, their "
                f"stores issued {np.median(cc[:, 62] - cc[:, 12]):.0f}")
        print(f"    {nt} tiles: {int(sel.sum()):4d} CTAs, us median "
              f"{np.median(dur[sel]):.2f} max {dur[sel].max():.2f}, entry "
              f"median {np.median(g[sel, 0] - t0) / 1e3:.2f}, exit max "
              f"{(g[sel, 1].max() - t0) / 1e3:.2f}; cycles (median): {txt}")


# ---------------------------------------------------------------------------
# decode: the hd <= 128 decode core at G >= 4, two trees in turns
# ---------------------------------------------------------------------------

# per-stage cycles that thread 0 of each CTA adds up (STG(k) adds the
# cycles since the last STG; DEP(x) waits for x's producer first), stored
# to stage_c at the kernel's end
STG_MACROS = (
    "#define STG(k) if (threadIdx.x == 0) { long long c_ = clock64(); "
    "c_acc_[k] += c_ - c_last_; c_last_ = c_; }\n"
    "#define DEP(x) asm volatile(\"\" :: \"f\"(x));\n")
STG_INIT = "  long long c_last_ = clock64(), c_acc_[13] = {0};\n"
STG_STORE = ("  if (threadIdx.x == 0) {\n    const int id_ = blockIdx.y * "
             "gridDim.x + blockIdx.x;\n    for (int k_ = 0; k_ < 13; ++k_) "
             "stage_c[id_ * 32 + k_] = c_acc_[k_];\n  }\n")
# the split core (decode_split_kernel, before the lane core): stages inside
# its loop over 4 rows at a time are summed over the loop
SPLIT_STAGES = ["q loads issued", "cache loads issued", "cache loads landed",
                "q.k and its shuffles", "softmax (m, l)", "P.V (acc)",
                "row groups merged (butterfly)",
                "warp state written, barrier", "warps merged, partial written"]
SPLIT_EDITS = [
    ("  const int r = lane / LPR;                   // row within a warp-wide "
     "load\n",
     "  const int r = lane / LPR;                   // row within a warp-wide "
     "load\n" + STG_INIT),
    ("  float m[KG], l[KG], acc[KG][VEC];\n",
     "  STG(0)\n  float m[KG], l[KG], acc[KG][VEC];\n"),
    ("    }\n#pragma unroll\n    for (int u = 0; u < U; ++u) {\n"
     "      float kf[VEC], vf[VEC];\n",
     "    }\n    STG(1)\n    { const float w_ = __uint_as_float(kr[U - 1].x ^ "
     "vr[U - 1].x); DEP(w_) }\n    STG(2)\n#pragma unroll\n    for (int u = "
     "0; u < U; ++u) {\n      float kf[VEC], vf[VEC];\n"),
    ("          s += __shfl_xor_sync(rt::kFull, s, o);\n"
     "        if (ok[u] && g < G) {\n",
     "          s += __shfl_xor_sync(rt::kFull, s, o);\n        STG(3)\n"
     "        if (ok[u] && g < G) {\n"),
    ("          l[g] = l[g] * corr + p;\n",
     "          l[g] = l[g] * corr + p;\n          DEP(l[g]) STG(4)\n"),
    ("          m[g] = mn;\n        }\n",
     "          m[g] = mn;\n          DEP(acc[g][VEC - 1]) STG(5)\n"
     "        }\n"),
    ("  // once a multiply-add is contracted the butterfly's lanes need not "
     "agree\n",
     "  DEP(acc[KG - 1][VEC - 1]) STG(6)\n  // once a multiply-add is "
     "contracted the butterfly's lanes need not agree\n"),
    ("  __syncthreads();\n\n  // the warps merge in warp order; one partial",
     "  __syncthreads();\n  STG(7)\n\n  // the warps merge in warp order; one "
     "partial"),
    ("    pp[2 + d] = O;\n  }\n}\n\n// the ticket counters",
     "    pp[2 + d] = O;\n  }\n  STG(8)\n" + STG_STORE + "}\n\n"
     "// the ticket counters"),
]
# the lane core (decode_lane_kernel): thread 0's warp walks the chunk's
# first tile; a CTA that did not take the last ticket stores its stages
# when it publishes its partial, the last one again after the fold
LANE_STAGES = ["barriers set, q issued, row looked up",
               "bulk copies issued", "q to shared memory, barrier",
               "K landed", "S (one key a lane)", "softmax (one update a tile)",
               "V landed", "P.V", "warp state written, barrier",
               "merged, ticket (fold: last CTA)"]
LANE_EDITS = [
    ("  unsigned char* vt = kTogether ? kt + TB : kt;\n",
     "  unsigned char* vt = kTogether ? kt + TB : kt;\n" + STG_INIT),
    ("  // the tile's n live rows of src into dst",
     "  STG(0)\n  // the tile's n live rows of src into dst"),
    ("    if (kTogether) stage(v, vt, vbar);        // all the chunk's bytes "
     "in flight\n  }\n",
     "    if (kTogether) stage(v, vt, vbar);        // all the chunk's bytes "
     "in flight\n  }\n  STG(1)\n"),
    ("  __syncthreads();\n\n  if (n > 0) {\n    mbar_wait0(kbar);\n",
     "  __syncthreads();\n  STG(2)\n\n  if (n > 0) {\n    mbar_wait0(kbar);"
     "\n    STG(3)\n"),
    ("    // one softmax update a tile and query row: the row's max over the\n",
     "    DEP(s[KG - 1]) STG(4)\n    // one softmax update a tile and query "
     "row: the row's max over the\n"),
    ("    if (!kTogether) {\n      // V into K's rows",
     "    DEP(l[KG - 1]) STG(5)\n    if (!kTogether) {\n      // V into K's "
     "rows"),
    ("    mbar_wait0(vbar);\n    __syncwarp();                             "
     "// every lane's P\n",
     "    mbar_wait0(vbar);\n    __syncwarp();                             "
     "// every lane's P\n    STG(6)\n"),
    ("    // the warp's state: m, l, and O (KG x HD f32) over its K rows",
     "    DEP(acc[KG - 1][EPL - 1]) STG(7)\n    // the warp's state: m, l, and "
     "O (KG x HD f32) over its K rows"),
    ("  __syncthreads();\n\n  merge_fold<HD, KG>(",
     "  __syncthreads();\n  STG(8)\n  merge_fold<HD, KG>("),
    ("                     part, tickets, out, bkh, b, kh, H, nch, chunk, "
     "q_bf16);\n}\n",
     "                     part, tickets, out, bkh, b, kh, H, nch, chunk, "
     "q_bf16);\n  STG(9)\n" + STG_STORE + "}\n"),
]
_RAGGED = [1024, 1, 17, 512, 600, 333, 1000, 64]
_G8_LENS = [0, 1, 127, 128, 129, 257, 1024, 600]
_RING_LENS = [1, 127, 128, 129, 512, 255, 384, 511]
_PAIRS = [(q, c) for q in ("float32", "bfloat16")
          for c in ("float32", "bfloat16", "float8_e4m3fn")]
_F32 = [("float32", "float32")]
_BF16 = [("bfloat16", "bfloat16")]
_F32Q = [("float32", c) for c in ("float32", "bfloat16", "float8_e4m3fn")]
# (row, H, Kh, hd, Smax, cache_len or None for every row, (q, cache)
# pairs), B 8: chip_smoke.py's decode shapes.  G <= 2: qwen1.5-0.5b's
# (phases 3, 20 and 22), deepseek-moe-16b's 16 heads of 128 (phase 12),
# whisper-tiny's cross decode over 1500 frames (phase 15); G >= 4 at hd
# 128: qwen1.5-110b's G = 8 at the chunk edges, jamba's 32 on 8, vision's
# cross decode over 1601 rows; hd 256: gemma3-1b's bf16 decode (phase 22
# (e)) over a local layer's 512-row ring and a global layer's 1024 rows;
# then the lane core's other instantiations (hd 16 and 32 at G 1 and 2, hd
# 64 at G 2, hd 128 at G 1 and 2), an f32 query over each cache type, and
# the mma core at hd 32 (G = 8)
DECODE_ROWS = [("qwen", 16, 16, 64, 1024, _RAGGED, _PAIRS),
               ("deepseek_moe", 16, 16, 128, 1024, _RAGGED, _F32),
               ("whisper_cross", 6, 6, 64, 1500, None, _F32),
               ("hd128_g8", 64, 8, 128, 1024, _G8_LENS, _F32 + _BF16),
               ("hd128_gqa", 32, 8, 128, 1024, _RAGGED, _F32),
               ("hd128_cross", 32, 8, 128, 1601, None, _F32),
               ("gemma3_ring", 4, 1, 256, 512, _RING_LENS, _BF16),
               ("gemma3_global", 4, 1, 256, 1024, _RAGGED, _BF16),
               ("hd16_g1", 16, 16, 16, 1024, _RAGGED, _F32Q),
               ("hd16_g2", 16, 8, 16, 1024, _RAGGED, _F32Q),
               ("hd32_g1", 16, 16, 32, 1024, _RAGGED, _F32Q),
               ("hd32_g2", 16, 8, 32, 1024, _RAGGED, _F32Q),
               ("hd64_g2", 16, 8, 64, 1024, _RAGGED, _F32Q),
               ("hd128_g1", 16, 16, 128, 1024, _RAGGED, _F32Q[1:]),
               ("hd128_g2", 16, 8, 128, 1024, _RAGGED, _F32Q),
               ("hd32_g8", 64, 8, 32, 1024, _G8_LENS, _F32)]
# copies of this checkout's source timed beside it below hd 256: (name, its
# edits (old text, found once, and new), the launch's dynamic shared memory
# at (hd, the cache's bytes an element); None: the checkout's geometry).
# chunks: the folded combine always a chunk at a time (fold_chunks), never
# its acc loaded 8 chunks deep (fold_deep).  (The lane core's design rounds
# were timed the same way: PERF.md section 6)
VARIANTS = [
    ("chunks",
     [("  if (PER <= 2 && live <= kFold)\n    fold_deep<HD, NR>(pb, live, G, "
       "out, o0, q_bf16);\n  else\n    fold_chunks", "  fold_chunks")],
     None),
]


def _tree_module(tree, tag):
    """``tree``'s kernels/decode_attention.py as a module of its own (its
    _geometry and dtype codes)."""
    import importlib.util
    path = tree / "src" / "repro_torch" / "kernels" / "decode_attention.py"
    spec = importlib.util.spec_from_file_location(f"decode_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tickets_ptr(mod, geo, B, Kh, device):
    """``mod``'s ticket counters for a launch of ``geo`` (None where its
    core takes none: a parent whose split core has a separate combine and
    whose ``_tickets`` takes the geometry)."""
    import inspect
    n = B * Kh * geo.cluster
    t = (mod._tickets(geo, n, device)
         if len(inspect.signature(mod._tickets).parameters) == 3
         else mod._tickets(n, device))
    return None if t is None else t.data_ptr()


def _raw_decode(torch, lib, mod, q, k, v, cl, stream, tables=None,
                smem=None):
    """One call through ``lib``'s launcher (dense, or paged with
    ``tables``) with the geometry of ``mod`` (its tree's wrapper), its
    dynamic shared memory ``smem`` where given."""
    B, H, hd = q.shape
    Kh, rows = k.shape[1], k.shape[2]
    M = tables.shape[1] if tables is not None else 0
    cap = M * rows if tables is not None else rows
    geo = mod._geometry(hd, k.dtype, H // Kh)
    if smem is not None:
        geo = geo._replace(smem=smem)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    scratch = mod._scratch(B, H, Kh, cap, hd, q.device)
    qd, cd = mod._DTYPES[q.dtype], mod.CACHE_DTYPES[k.dtype]
    tickets = _tickets_ptr(mod, geo, B, Kh, q.device)

    def call():
        if tables is None:
            err = lib.decode_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), cl.data_ptr(),
                scratch.data_ptr(), tickets, out.data_ptr(), B, H, Kh, rows,
                hd, hd, hd ** -0.5, qd, cd, geo.cluster, geo.smem, stream)
        else:
            err = lib.paged_decode_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(),
                cl.data_ptr(), scratch.data_ptr(), tickets, out.data_ptr(),
                B, H, Kh, rows, M, hd, hd, hd ** -0.5, qd, cd, geo.cluster,
                geo.smem, stream)
        assert err == 0, err
        return out
    return call


def _decode_inputs(torch, rng, dev, H, Kh, hd, Smax, lens, cdt, qdt):
    """q, the dense caches, pools of 16-row blocks at shuffled ids holding
    the same live rows, their tables and cache_len (B 8)."""
    B, bs = 8, 16
    lens = lens or [Smax] * B
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(
        np.float32)).to(dev, qdt)
    kc, vc = (torch.from_numpy(rng.standard_normal((B, Kh, Smax, hd)).astype(
        np.float32)).to(dev, cdt) for _ in range(2))
    M = -(-Smax // bs)
    n_blocks = 1 + B * M
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((B, M), np.int32)
    pools = [torch.zeros((n_blocks, Kh, bs, hd), dtype=cdt, device=dev)
             for _ in range(2)]
    i = 0
    for b, n in enumerate(lens):
        nb = -(-n // bs)
        tables[b, :nb] = perm[i:i + nb]
        i += nb
    bt = torch.from_numpy(tables).to(dev)
    for pool, dense in zip(pools, (kc, vc)):
        pad = torch.nn.functional.pad(dense, (0, 0, 0, M * bs - Smax))
        pool[bt.long()] = pad.reshape(B, Kh, M, bs, hd).movedim(1, 2)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kc, vc, pools[0], pools[1], bt, cl


def _stage_report(torch, lib, call, n_ctas, names, label):
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    lib.stages_clear()
    call()
    torch.cuda.synchronize()
    n = n_ctas * 32
    c = np.zeros(n, np.int64)
    g = np.zeros(n, np.uint64)
    lib.stages_get(c.ctypes.data, g.ctypes.data, n)
    c = c.reshape(-1, 32)[:, :len(names)]
    c = c[c.sum(axis=1) > 0]
    print(f"  {label}: {len(c)} live CTAs, thread 0's cycles a stage "
          "(median, max):")
    for k, name in enumerate(names):
        on = c[:, k] > 0               # a stage some CTAs skip: over the rest
        x = c[on, k] if 0 < on.sum() < len(c) else c[:, k]
        print(f"    {name:34s} {np.median(x):8.0f} {x.max():8.0f}"
              + (f"  ({int(on.sum())} CTAs)" if 0 < on.sum() < len(c)
                 else ""))
    tot = c.sum(axis=1)
    print(f"    {'all':34s} {np.median(tot):8.0f} {tot.max():8.0f}")


def _by_kernel(torch, cs, call):
    split = cs.split_share(torch, "decode_combine", call)
    share = split["combine_share"]
    us = {}
    for k, x in split["kernels_us"].items():
        name = re.search(r"(\w+)(<|\(|$)", k.replace("void ", "").replace(
            "(anonymous namespace)::", "")).group(1)[-32:]
        us[name] = round(us.get(name, 0.0) + x, 2)
    return us, share if isinstance(share, str) else f"{share:.3f}"


def decode_stages(torch, dev, stream):
    """Decode at DECODE_ROWS: this checkout's kernels, its VARIANTS below
    hd 256 and, with --tree, the tree's (a parent), in turns (tree,
    checkout, the variants and back), each beside its bytes bound, the
    plain version and SDPA's masked call (dense, q and the cache in one
    dtype); device time by kernel and the combine's share (profiler); then
    each tree's G <= 2 core at qwen1.5-0.5b's bf16 shape, dense, stage by
    stage (an instrumented copy)."""
    import chip_smoke as cs
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    trees = [("checkout", ROOT)] + ([("tree", TREE)] if TREE != ROOT else [])
    libs, mods, timed, smems = {}, {}, {}, {}
    for name, tree in trees:
        csrc = tree / "src" / "repro_torch" / "kernels" / "csrc"
        src = (csrc / "decode_attention.cu").read_text()
        mods[name] = _tree_module(tree, name)
        libs[name] = instrument("decode_attention", [], tag=f"_{name}",
                                csrc=csrc, defer=True)
        split = "\ndecode_split_kernel(" in src     # its definition
        edits, stages = ((SPLIT_EDITS, SPLIT_STAGES) if split
                         else (LANE_EDITS, LANE_STAGES))
        timed[name] = (instrument(
            "decode_attention", [], tag=f"_{name}_stages", csrc=csrc,
            edits=[("namespace cg = cooperative_groups;\n",
                    "namespace cg = cooperative_groups;\n" + STG_MACROS)]
            + edits, defer=True), stages)
        print(f"{name}: {tree}, "
              f"{'decode_split_kernel' if split else 'decode_lane_kernel'} "
              "at G <= 2")
        if name != "checkout":
            continue
        for vname, edits, vsmem in VARIANTS:
            if all(src.count(old) == 1 for old, _ in edits):
                libs[vname] = instrument(
                    "decode_attention", [], tag=f"_{vname}", csrc=csrc,
                    edits=edits, defer=True)
                mods[vname] = mods[name]
                smems[vname] = vsmem
                print(f"{vname}: a copy of the checkout with {len(edits)} "
                      "edits")
    libs = {n: load() for n, load in libs.items()}    # every build at once
    timed = {n: (load(), st) for n, (load, st) in timed.items()}
    rng = np.random.default_rng(34)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn}
    print("decode, B 8 (CUDA events, ms per call; turns: tree, checkout, "
          "the variants and back):")
    for key, H, Kh, hd, Smax, lens, pairs in DECODE_ROWS:
        for qdt, cdt in pairs:
            q, kc, vc, kp, vp, bt, cl = _decode_inputs(
                torch, rng, dev, H, Kh, hd, Smax, lens, dts[cdt], dts[qdt])
            live = int(cl.sum())
            nbytes = (8 * H * hd * 2 * q.element_size()
                      + live * Kh * 2 * hd * kc.element_size() + 8 * 4)
            t_bound, by = cs.bound(nbytes, 2 * H * live * 2 * hd, "float32")
            for paged in (False, True) if lens else (False,):
                args = (kp, vp, cl) if paged else (kc, vc, cl)
                tables = bt if paged else None
                calls = {n: _raw_decode(
                    torch, libs[n], mods[n], q, *args, stream, tables,
                    smems[n](hd, kc.element_size()) if smems.get(n) else
                    None) for n in libs if n not in smems or hd < 256}
                with torch.no_grad():
                    ref = (DA.paged_decode_attention_plain(q, kp, vp, bt, cl)
                           if paged else DA.decode_attention_plain(q, kc, vc,
                                                                   cl))
                    got = {n: c().clone() for n, c in calls.items()}
                errs = {n: float((o.float() - ref.float()).abs().max())
                        for n, o in got.items()}
                vs = [n for n in calls if n in smems]
                eq = {n: torch.equal(got[n], got["checkout"]) for n in got
                      if n != "checkout"}
                same = "".join(f"; {n} {'==' if e else '!='} the checkout's "
                               "bits" for n, e in eq.items())
                order = [n for n in ["tree", "checkout", *vs, *vs[::-1],
                                     "checkout", "tree"] if n in calls]
                turns = [cs.time_ms(torch, calls[n], iters=50) for n in order]
                ms = {n: [t for o, t in zip(order, turns) if o == n]
                      for n in calls}
                plain = cs.time_ms(torch, lambda: (
                    DA.paged_decode_attention_plain(q, kp, vp, bt, cl)
                    if paged else DA.decode_attention_plain(q, kc, vc, cl)),
                    iters=5)
                sdpa = None
                if not paged and qdt == cdt:
                    mask = (torch.arange(Smax, device=dev)[None, :]
                            < cl[:, None])[:, None, None, :]
                    q4 = q[:, :, None, :]
                    sdpa = cs.time_ms(torch, lambda: (
                        F.scaled_dot_product_attention(
                            q4, kc, vc, attn_mask=mask, enable_gqa=True)))
                us, share = _by_kernel(torch, cs, calls["checkout"])
                print(f"  {key} {'paged' if paged else 'dense'} q={qdt} "
                      f"cache={cdt}: checkout "
                      f"{', '.join(f'{t:.4f}' for t in ms['checkout'])}"
                      + "".join(f"; {n} {', '.join(f'{t:.4f}' for t in v)}"
                                for n, v in ms.items() if n != "checkout")
                      + f"; bound {t_bound:.4f} ({by}); plain {plain:.4f}; "
                      f"SDPA {'%.4f' % sdpa if sdpa else 'none'}{same}; "
                      "max|err| vs "
                      f"plain {errs}; the checkout's device us by kernel "
                      f"(profiler) {us}, the combine's share {share}")
                if key == "qwen" and cdt == qdt:
                    for n in calls:
                        if n != "checkout":
                            us, share = _by_kernel(torch, cs, calls[n])
                            print(f"    {n}'s device us by kernel {us}, the "
                                  f"combine's share {share}")
    for name, (lib, stages) in timed.items():
        q, kc, vc, kp, vp, bt, cl = _decode_inputs(
            torch, rng, dev, 16, 16, 64, 1024, _RAGGED, torch.bfloat16,
            torch.bfloat16)
        call = _raw_decode(torch, lib, mods[name], q, kc, vc, cl, stream)
        _stage_report(torch, lib, call, 8 * 16 * 8, stages,
                      f"{name}: qwen dense bf16/bf16, per-stage timeline")


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
        return "; ".join(
            f"{key.replace('void (anonymous namespace)::', '')[:40]} "
            f"{us / 5e3:.4f} ms ({us / total:.3f})" for key, us, n in rows)

    print(f"backward kernels of {TREE} (CUDA events, ms per call):")
    B, S, H = 4, 512, 16
    for dt, hd in ((torch.float32, 64), (torch.float32, 128),
                   (torch.bfloat16, 64), (torch.bfloat16, 128)):
        q, k, v, do = (rnd((B, S, H, hd)).to(dt) for _ in range(4))
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
        print(f"  flash backward ({hd}, {hd}) {str(dt)[6:]} B={B} Sq=Skv={S} "
              f"H={H} causal: {ms:.4f} ms  SDPA backward {lib:.4f} ms  ratio "
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
    if "decode" in args and TREE != ROOT and len(args) > 1:
        print("decode with --tree compares two trees: run it alone",
              file=sys.stderr)
        return 2
    # decode times this checkout against --tree: this checkout's package
    sys.path.insert(0, str((ROOT if "decode" in args else TREE) / "src"))
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
    if "bf16bwd" in which:
        bf16_bwd_stages(torch, dev, stream)
    if "bf16fwd" in which:
        bf16_fwd_stages(torch, dev, stream)
    if "decode" in which:
        decode_stages(torch, dev, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
