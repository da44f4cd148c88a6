#!/usr/bin/env python3
"""Hold the kernels of two trees to the same bits, on one NVIDIA GPU.

    python3 tools/kernel_bits.py save TREE OUT.pt    # TREE: a checkout's root
    python3 tools/kernel_bits.py compare A.pt B.pt [EXPECTED ...]

``save`` builds TREE's kernels (into build/kernels_<tree>/ beside the usual
build directory, so two trees never share a library) and stores their
outputs on fixed inputs made from seed 0: dense and paged decode at hd 16,
32, 64, 128 and 256 with G = 1, 4 and 8 and cache lengths at chunk edges
(with q and the cache in one dtype, and, where TREE's decode takes them,
over a cache in another dtype than q: names holding "cache="), and
flash at every (hd, hdv) the kernel takes, causal, with a window and a
q_offset, in f32 and bf16; wkv6's output and final state at hd 16, 64 and
128, with and without a state0, over 1, 9 and 600 steps, in f32 and bf16;
and the backward kernels' gradients (names starting "backward"): flash at
every (hd, hdv), causal, with a window and a q_offset, and GQA, in f32
and, where TREE's flash backward takes it, bf16 through autograd (names
starting "backward bf16"), and wkv6 at hd 16, 64 and 128 with a state0 and
a final-state gradient.  ``compare``
holds every output whose name holds none of the EXPECTED substrings (say
``"(128, 128)"``: the flash outputs a change redesigned, or ``backward``)
to the same bits, prints the names of the expected ones that changed, and
exits non-zero if any other output differs, or if an output other than a
"cache=" pair or a bf16 backward is missing from one of the two files (a
tree whose kernel refuses an input saves none of it).  To compare
a commit with its parent, unpack the parent into a git-ignored directory
(``git archive``) and run save for parent, change, change, parent, then
compare each pair.
"""
import sys
from pathlib import Path


def save(tree: str, out: str) -> int:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build
    build.BUILD_DIR = (build.BUILD_DIR.parent /
                       ("kernels_" + "_".join(root.parts[1:])))
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      paged_decode_attention)
    import math

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv6_wkv as RW
    from repro_torch.kernels.flash_attention import flash_attention
    dev = "cuda"
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(0)

        def rnd(*shape):
            x = rng.standard_normal(shape).astype(np.float32)
            return torch.from_numpy(x).to(dev, dt)
        cl = torch.tensor([300, 1, 129, 0, 257], dtype=torch.int32,
                          device=dev)
        for hd in (16, 32, 64, 128, 256):
            for H, Kh in ((16, 16), (8, 2), (8, 1)):
                q = rnd(5, H, hd)
                kc, vc = rnd(5, Kh, 300, hd), rnd(5, Kh, 300, hd)
                outs[f"decode {dt} hd={hd} H={H} Kh={Kh}"] = \
                    decode_attention(q, kc, vc, cl).cpu()
                kp, vp = rnd(40, Kh, 16, hd), rnd(40, Kh, 16, hd)
                bt = torch.from_numpy(
                    rng.integers(1, 40, (5, 19)).astype(np.int32)).to(dev)
                outs[f"paged {dt} hd={hd} H={H} Kh={Kh}"] = \
                    paged_decode_attention(q, kp, vp, bt, cl).cpu()
                for cdt in (torch.float32, torch.bfloat16,
                            torch.float8_e4m3fn):
                    if cdt == dt:
                        continue
                    c = [t.float().to(cdt) for t in (kc, vc, kp, vp)]
                    key = f"q={dt} cache={cdt} hd={hd} H={H} Kh={Kh}"
                    try:
                        outs["decode " + key] = decode_attention(
                            q, c[0], c[1], cl).cpu()
                        outs["paged " + key] = paged_decode_attention(
                            q, c[2], c[3], bt, cl).cpu()
                    except (TypeError, ValueError):
                        pass        # a tree whose kernel takes one dtype
        for hd, hdv in ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128),
                        (256, 256)):
            for Sq, Skv, win, qo in ((512, 512, 0, None), (200, 330, 64, 130),
                                     (65, 65, 0, None)):
                q, k, v = rnd(1, Sq, 8, hd), rnd(1, Skv, 4, hd), \
                    rnd(1, Skv, 4, hdv)
                outs[f"flash {dt} ({hd}, {hdv}) Sq={Sq} Skv={Skv} "
                     f"window={win}"] = flash_attention(
                         q, k, v, causal=True, window=win,
                         q_offset=qo).cpu()
        for hd in (16, 64, 128):
            for S in (1, 9, 600):
                r, k, v = rnd(2, S, 4, hd), rnd(2, S, 4, hd), rnd(2, S, 4, hd)
                w = torch.sigmoid(rnd(2, S, 4, hd).float()).to(dt) * 0.5 \
                    + 0.45
                u = rnd(4, hd).float() * 0.1
                for with_state in (False, True):
                    st = rnd(2, 4, hd, hd).float() if with_state else None
                    y, fin = RW.wkv6(r, k, v, w, u, st)
                    key = f"wkv6 {dt} hd={hd} S={S} state0={with_state}"
                    outs[key + " y"] = y.cpu()
                    outs[key + " state"] = fin.cpu()
    rng = np.random.default_rng(1)

    def rnd32(*shape, scale=1.0):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(x).to(dev)
    for hd, hdv in FA.HEAD_DIM_PAIRS:
        for Sq, Skv, H, Kh, win, qo, causal in (
                (512, 512, 8, 4, 0, 0, True), (200, 330, 8, 2, 64, 130, True),
                (65, 129, 4, 4, 0, 0, False)):
            q, k, v = rnd32(1, Sq, H, hd), rnd32(1, Skv, Kh, hd), \
                rnd32(1, Skv, Kh, hdv)
            do = rnd32(1, Sq, H, hdv)
            with torch.no_grad():
                o = flash_attention(q, k, v, causal=causal, window=win,
                                    q_offset=qo)
            grads = FA._launch_backward(q, k, v, o, do, causal, win,
                                        1.0 / math.sqrt(hd), qo)
            for name, g in zip(("dq", "dk", "dv"), grads):
                outs[f"backward flash ({hd}, {hdv}) Sq={Sq} Skv={Skv} H={H} "
                     f"Kh={Kh} window={win} causal={causal} {name}"] = g.cpu()
            bf = [t.to(torch.bfloat16).requires_grad_(True) for t in (q, k, v)]
            try:
                o = flash_attention(*bf, causal=causal, window=win,
                                    q_offset=qo)
            except NotImplementedError:
                continue            # a tree whose backward takes f32 only
            grads = torch.autograd.grad(o, bf, do.to(torch.bfloat16))
            for name, g in zip(("dq", "dk", "dv"), grads):
                outs[f"backward bf16 flash ({hd}, {hdv}) Sq={Sq} Skv={Skv} "
                     f"H={H} Kh={Kh} window={win} causal={causal} "
                     f"{name}"] = g.cpu()
    for hd in (16, 64, 128):
        B, S, H = 2, 100, 4
        r, k, v = (rnd32(B, S, H, hd, scale=0.5) for _ in range(3))
        w = torch.sigmoid(rnd32(B, S, H, hd)) * 0.5 + 0.45
        grads = RW._launch_backward(r, k, v, w, rnd32(H, hd, scale=0.1),
                                    rnd32(B, H, hd, hd), rnd32(B, S, H, hd),
                                    rnd32(B, H, hd, hd))
        for name, g in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), grads):
            outs[f"backward wkv6 hd={hd} S={S} {name}"] = g.cpu()
    torch.save(outs, out)
    print(f"{root}: {len(outs)} outputs saved to {out}")
    return 0


def compare(a: str, b: str, *expected: str) -> int:
    import torch
    x, y = torch.load(a), torch.load(b)
    differ = [k for k in x if k not in y or not torch.equal(x[k], y[k])]
    free = [k for k in x if any(e in k for e in expected)]
    bad = [k for k in differ if k not in free]
    moved = [k for k in differ if k in free]
    print(f"{a} vs {b}: {len(x)} outputs; {len(x) - len(free)} held to the "
          f"same bits, {len(bad)} of them differ"
          + (": " + ", ".join(bad[:10]) if bad else ""))
    if expected:
        print(f"  expected to change ({', '.join(expected)}): {len(moved)} "
              f"of {len(free)} changed" + "".join(f"\n    {k}"
                                                for k in moved))
    alone = sorted(set(x) ^ set(y))
    if alone:
        print(f"  in one file only: {len(alone)}"
              + "".join(f"\n    {k}" for k in alone[:10]))
    optional = ("cache=", "backward bf16")
    return 1 if bad or any(not any(o in k for o in optional)
                           for k in alone) else 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "save":
        sys.exit(save(*sys.argv[2:]))
    if len(sys.argv) >= 4 and sys.argv[1] == "compare":
        sys.exit(compare(*sys.argv[2:]))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
