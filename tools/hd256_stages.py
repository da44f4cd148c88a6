#!/usr/bin/env python3
"""Where the hd-256 flash and decode kernels spend their time, stage by
stage, on one NVIDIA GPU.

    python3 tools/hd256_stages.py        # from the repository root

It copies csrc/decode_attention.cu and csrc/flash_attention.cu into
build/stages/, inserts a clock64() read by thread 0 of every CTA at the
stage boundaries named below (and a %globaltimer read for decode), builds
each copy with the flags of kernels/build.py, launches it through ctypes at
chip_smoke.py phase 3's f32 shapes (gemma3-1b: decode B=8, H=4, Kh=1,
Smax 512 and 1024; flash Sq=Skv=571, H=4, Kh=1, causal), and prints the
median and the largest cycle count from CTA entry to each boundary over the
CTAs that reached it.  The instrumented copies are for this measurement
only; the kernels the port runs are built from the unmodified sources.
Needs CUDA and nvcc; exits non-zero without them.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
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
FLASH = [
    ("  const int span = blockIdx.x;\n  const int q0 = blockIdx.y * kBQ;",
     "0", "entry", True),
    ("    __syncthreads();   // tile it (and q) visible to every warp\n"
     "    const T* kt = kring + ((it & 1) * BK + kg * WK) * KS;",
     "1 + 5 * min(it, 3)", "tile ready", False),
    ("    scores<HD, NT, kChains>(s, qw, kt, g, t);",
     "2 + 5 * min(it, 3)", "S", False),
    ("    // the tile's row maxima, key halves in order",
     "3 + 5 * min(it, 3)", "maxima exchanged", True),
    ("    pair_sync(rw);     // the tile's whole P is in shared memory",
     "4 + 5 * min(it, 3)", "P exchanged", False),
    ("    accumulate<HDV, NP, NO>(o, p, vt, g, t);", "5 + 5 * min(it, 3)",
     "P.V", False),
    ("  // row sums: across the quad, then the pair's key halves in order",
     "21", "tiles done", True),
    ("          make_float2(o[n][2 * r], o[n][2 * r + 1]);\n  }\n}", "22",
     "partials written", None),
]


def instrument(name, points):
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
    src = src.replace("namespace {\n", DECLS + "namespace {\n", 1)
    src += ACCESSORS
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    lib = OUT / f"lib{name}.so"
    from repro_torch.kernels import build
    r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                        str(CSRC), "-o", str(lib), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    lib = ctypes.CDLL(str(lib))
    sig = build.SIGNATURES[name][f"{name}_launch"]
    getattr(lib, f"{name}_launch").argtypes = sig
    return lib


def report(lib, n_ctas, names, label):
    n = n_ctas * 32
    c = np.zeros(n, np.int64)
    g = np.zeros(n, np.uint64)
    lib.stages_get(c.ctypes.data, g.ctypes.data, n)
    c, g = c.reshape(-1, 32), g.reshape(-1, 32).astype(np.int64)
    live = c[:, 0] != 0
    c, g = c[live], g[live]
    print(f"{label}: {int(live.sum())} CTAs ran past entry; entries spread "
          f"over {int(g[:, 0].max() - g[:, 0].min())} ns")
    for k, name in names:
        ok = c[:, k] != 0
        if ok.any():
            d = c[ok, k] - c[ok, 0]
            print(f"  {name:28s} cycles from entry: median "
                  f"{np.median(d):8.0f}  max {d.max():8.0f}  "
                  f"({int(ok.sum())} CTAs)")


def main():
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

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
                Kh, Smax, hd, hd, hd ** -0.5, 0, geo.cluster, geo.smem,
                stream)
            assert err == 0, err
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        lib.stages_clear()
        call()
        torch.cuda.synchronize()
        report(lib, geo.cluster * dk.n_chunks(Smax) * B * Kh,
               [(int(k), name) for _, k, name, _ in DECODE[1:]],
               f"decode_cluster_kernel<float, 4>, Smax {Smax}, "
               f"cache_len {lens}")

    lib = instrument("flash_attention", FLASH)
    S = 571
    q = torch.randn(1, S, H, hd, device=dev)
    k = torch.randn(1, S, 1, hd, device=dev)
    v = torch.randn_like(k)
    out = torch.empty_like(q)
    geo = fk._geometry(hd, hd, torch.float32)
    scratch = torch.empty(H * S * fk.n_spans(S) * (hd + 2), device=dev)

    def call():
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), 1, S, S, H, 1, hd, hd, 0, 1, 0, hd ** -0.5,
            0, geo.span, geo.smem, stream)
        assert err == 0, err
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    lib.stages_clear()
    call()
    torch.cuda.synchronize()
    names = [(1 + 5 * t + j, f"tile {t}: {n}") for t in range(4)
             for j, n in enumerate(["ready", "S", "maxima exchanged",
                                    "P exchanged", "P.V"])]
    report(lib, fk.n_spans(S) * -(-S // fk.TILE_Q) * H,
           names + [(21, "tiles done"), (22, "partials written")],
           f"flash_span_kernel<float>, Sq=Skv={S}, H={H}, Kh=1, causal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
