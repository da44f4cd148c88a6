"""Computation-graph cost model (paper §5: "computation graph analysis and
operator-level profiling").

Ports ``repro/core/graph.py``.  The graph G=(V,E) has one node per
*operator group* — the mixer and MLP of each layer — annotated with the
profiled triple (t_c, s_p, s_a): compute time, parameter bytes, activation
bytes.  Here the "profiler" is the analytic roofline of a card
(``launch/roofline.py``, the H100 by default) evaluated at a reference
batch; measured times can be fed through the same interface.

Pattern boundaries are marked so the partitioner's R(S_k) regularizer can
prefer cuts that keep repeating patterns intact.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.roofline import (H100_SXM, Chip, layer_fwd,
                                         layer_param_bytes)


@dataclass(frozen=True)
class OpNode:
    index: int                 # topological position
    layer: int                 # owning layer
    name: str                  # e.g. "L12.mixer"
    t_c: float                 # compute seconds at reference batch (1 card)
    s_p: float                 # parameter bytes
    s_a: float                 # activation (boundary) bytes at reference batch
    pattern_boundary: bool     # True if a cut BEFORE this node lands on a
                               # repeating-pattern boundary


def build_graph(cfg: ModelConfig, *, ref_tokens: int = 4096,
                ctx: int = 4096, chip: Chip = H100_SXM,
                bytes_per_el: int = 4) -> list[OpNode]:
    """One OpNode per (layer, mixer|mlp) in topological order, timed on
    ``chip`` with elements of ``bytes_per_el`` bytes."""
    peak = chip.peak_flops(bytes_per_el)
    nodes: list[OpNode] = []
    idx = 0
    for layer in range(cfg.n_layers):
        j = layer % cfg.pattern_size
        full = layer_fwd(cfg, j, ref_tokens, ctx, T=1, decode=False,
                         bytes_per_el=bytes_per_el)
        pbytes = layer_param_bytes(cfg, j, T=1, bytes_per_el=bytes_per_el)
        # split layer costs ~60/40 between mixer and mlp (operator level)
        for part, frac in (("mixer", 0.6), ("mlp", 0.4)):
            t_c = full.flops * frac / peak + pbytes * frac / chip.hbm_bw
            nodes.append(OpNode(
                index=idx, layer=layer, name=f"L{layer}.{part}",
                t_c=t_c, s_p=pbytes * frac,
                s_a=ref_tokens * cfg.d_model * bytes_per_el,
                pattern_boundary=(part == "mixer"
                                  and layer % cfg.pattern_size == 0)))
            idx += 1
    return nodes


def batch_aware_activation(s_a_base: float, b: int, b_base: int,
                           alpha: float = 0.18) -> float:
    """Eq. 3: s_a(S_k, b) = s_a_base * (1 + alpha * log(b / b_base)).

    alpha is learned from profiles by linear regression (fit_alpha)."""
    if b <= 0 or b_base <= 0:
        return s_a_base
    return s_a_base * (1.0 + alpha * math.log(b / b_base))


def fit_alpha(samples: list[tuple[int, float]], b_base: int,
              s_a_base: float) -> float:
    """Least-squares fit of Eq. 3's alpha from (batch, bytes) profiles."""
    num = den = 0.0
    for b, s in samples:
        x = math.log(b / b_base)
        y = s / s_a_base - 1.0
        num += x * y
        den += x * x
    return num / den if den else 0.0
