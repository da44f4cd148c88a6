#!/usr/bin/env python3
"""Run chip_smoke.py's multi-rank path (phase 19) alone, on a chosen
backend: full-width qwen1.5-0.5b at S = 2, T = 2, M = 2, a prefill of B 8
x 512, 16 decode steps and 5 train steps, against one rank in this process
on cuda:0, with every check of phase 19.

    python3 tools/multi_rank.py --backend nccl      # 4 cards, a rank each
    python3 tools/multi_rank.py --backend gloo      # any cards, shared

Each rank sits on ``cuda:(rank % device_count)``; NCCL refuses two ranks on
one device, so ``--backend nccl`` needs 4 cards.  Prints the card's name
and power limit, one line per card, then phase 19's lines; exits non-zero
where a check fails.
"""
import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("multi_rank: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60).stdout.strip()
    print(cards, flush=True)
    build.load_all()                       # before the ranks: they load
    cs.parallel_phase(torch, cards.splitlines()[0], args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
