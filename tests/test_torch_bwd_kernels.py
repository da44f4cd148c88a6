"""The backward kernels' decompositions, on the CPU.

Flash attention's backward kernel writes dQ as one f32 partial per key tile
and sums each row's partials in key-tile order; wkv6's splits a head's
state columns over a cluster of CTAs and sums the row gradients (dr, dk,
dw) over the ranks in rank order.  Their plain mirrors
(``flash_bwd_partials_plain`` with ``flash_bwd_combine_plain``,
``wkv6_bwd_partials_plain`` with ``wkv6_bwd_groups_plain``) are held here
to the backward's plain versions (autograd through ``flash_attention_plain``
and ``wkv6_plain``) and to ``jax.grad`` of the JAX package's jnp paths, at
the tolerances of tests/test_torch_train_kernels.py; the partials summed in
order must equal the whole gradient at 1e-6 of its largest element.  The
launch geometry the C launchers check is pinned in
tests/test_torch_train_kernels.py::test_backward_kernel_geometry.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_compile import run_once

from repro.models.layers import flash_attention_jnp
from repro.models.ssm import _wkv_scan
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rwkv6_wkv as RW

torch.set_num_threads(2)

FLASH_TOL = dict(atol=3e-5, rtol=3e-5)
WKV_TOL = dict(atol=1e-4, rtol=1e-4)
# the partials summed in order against the whole gradient: the same
# products, summed in another order
PART_TOL = 1e-6


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close_rel(got, want, tol):
    """|got - want| <= tol x max|want| elementwise."""
    top = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * max(top, 1e-30), (err, top)


# ---------------------------------------------------------------------------
# flash attention: dQ as key-tile partials
# ---------------------------------------------------------------------------

# (causal, window, G, Sq, Skv, q_offset): key tiles of 64 (32 at hd 256)
# cut at their edges, windows, rows that see no key, q_offset below 0
FLASH_CASES = [
    (True, 0, 1, 65, 65, None),          # the last tile holds one key
    (True, 0, 4, 40, 129, None),         # GQA, three tiles, end-aligned
    (True, 16, 1, 70, 64, None),         # a window; Skv on the tile edge
    (True, 8, 2, 20, 100, 150),          # windowed rows that see no key
    (True, 0, 1, 30, 63, -10),           # q_offset < 0: rows see no key
    (False, 0, 4, 33, 65, None),         # full attention
]


def _flash_inputs(hd, hdv, G, Sq, Skv, seed):
    rng = np.random.default_rng(seed)
    B, Kh = 2, 2
    H = Kh * G
    return (_np(rng, (B, Sq, H, hd)), _np(rng, (B, Skv, Kh, hd)),
            _np(rng, (B, Skv, Kh, hdv)), _np(rng, (B, Sq, H, hdv)))


@pytest.mark.parametrize("hd,hdv", [(16, 16), (64, 64), (256, 256)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_partials(hd, hdv, case):
    """The partials combined in key-tile order against the plain backward
    (3e-5) and, at hd 16 and 64, jax.grad of flash_attention_jnp (3e-5);
    dk and dv of the main pass too; the partials summed in order against
    the whole dS.K (1e-6 of its largest element); tiles a row does not see
    are never read."""
    causal, window, G, Sq, Skv, q_offset = case
    q, k, v, do = _flash_inputs(hd, hdv, G, Sq, Skv, hd + Sq + Skv)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    part, dk, dv = FA.flash_bwd_partials_plain(*t, **kw)
    nkt, rows, _ = FA.bwd_plan(Sq, Skv, hd, hdv, **kw)
    assert part.shape == (2, 2 * G, nkt, Sq, hd)
    dq = FA.flash_bwd_combine_plain(part, Skv=Skv, hdv=hdv, **kw)
    want = FA.flash_attention_bwd_plain(*t, **kw)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, **FLASH_TOL)
    # the combine never reads a tile its row does not see
    poisoned = part.clone()
    for i, r in enumerate(rows):
        keep = torch.zeros(nkt, dtype=torch.bool)
        keep[r.start:r.stop] = True
        poisoned[:, :, ~keep, i] = float("nan")
    assert torch.equal(FA.flash_bwd_combine_plain(poisoned, Skv=Skv,
                                                  hdv=hdv, **kw), dq)
    # partials in key-tile order == the whole product over all keys
    whole = part.sum(dim=2) * (1.0 / hd ** 0.5)
    _close_rel(dq, whole.permute(0, 2, 1, 3), PART_TOL)
    if hd == 256:     # its plain backward is held to JAX in
        return        # tests/test_torch_train_kernels.py
    qo = (Skv - Sq) if q_offset is None else q_offset

    def loss(q, k, v):
        return jnp.sum(flash_attention_jnp(q, k, v, causal=causal,
                                           window=window, q_offset=qo,
                                           kv_block=16) * do)
    via_jax = run_once(jax.grad(loss, argnums=(0, 1, 2)), q, k, v)
    for g, a in zip((dq, dk, dv), via_jax):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), **FLASH_TOL)


def test_flash_bwd_plan():
    """The main kernel's split at qwen1.5-0.5b's training call (Sq = Skv =
    512, causal): 8 key tiles whose CTAs visit 8, 7, ..., 1 query tiles
    (key tile 0, the longest, first): 36 live pairs of 64; each row's
    partials are the tiles up to its own; a window narrows both."""
    nkt, rows, ctas = FA.bwd_plan(512, 512, 64, 64)
    assert nkt == 8
    assert [len(q) for _, q in ctas] == [8, 7, 6, 5, 4, 3, 2, 1]
    assert sum(len(q) for _, q in ctas) == 36
    assert rows[0] == range(0, 1) and rows[511] == range(0, 8)
    assert rows[64] == range(0, 2)
    _, rows, ctas = FA.bwd_plan(512, 512, 64, 64, window=64)
    assert rows[300] == range(3, 5) and rows[383] == range(5, 6)
    assert all(len(q) <= 2 for _, q in ctas)
    # (256, 256): key tiles of 32, query tiles of 32
    nkt, rows, ctas = FA.bwd_plan(100, 100, 256, 256)
    assert nkt == 4 and [len(q) for _, q in ctas] == [4, 3, 2, 1]
    # rows past every key, and before every key
    _, rows, ctas = FA.bwd_plan(10, 20, 64, 64, q_offset=-15)
    assert all(len(r) == 0 for r in rows) and ctas == [(0, [])]


# ---------------------------------------------------------------------------
# wkv6: state columns in groups
# ---------------------------------------------------------------------------

def _wkv_inputs(hd, S, seed, state):
    rng = np.random.default_rng(seed)
    B, H = 2, 2
    r, k, v = (_np(rng, (B, S, H, hd), 0.5) for _ in range(3))
    w = (1 / (1 + np.exp(-_np(rng, (B, S, H, hd)))) * 0.5 + 0.45).astype(
        np.float32)
    u = _np(rng, (H, hd), 0.1)
    s0 = _np(rng, (B, H, hd, hd)) if state else None
    dy = _np(rng, (B, S, H, hd))
    ds = _np(rng, (B, H, hd, hd)) if state else None
    return r, k, v, w, u, s0, dy, ds


@functools.lru_cache(maxsize=None)
def _wkv_jax(hd, S, state):
    """jax.grad of _wkv_scan on the case's inputs (dstate0 without a
    state0: the gradient of a zero state0)."""
    r, k, v, w, u, s0, dy, ds = _wkv_inputs(hd, S, hd + S, state)
    B, H = r.shape[0], r.shape[2]
    s0 = s0 if state else np.zeros((B, H, hd, hd), np.float32)

    def loss(*a):
        y, st = _wkv_scan(*a)
        out = jnp.sum(y * dy)
        return out + jnp.sum(st * ds) if state else out
    return run_once(jax.grad(loss, argnums=tuple(range(6))),
                    r, k, v, w, u, s0)


@pytest.mark.parametrize("hd,S", [(16, 17), (64, 33)])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("state", [False, True])
def test_wkv6_bwd_groups(hd, S, groups, state):
    """The column-group backward against the plain backward and jax.grad
    of _wkv_scan (1e-4); its per-group partials summed in rank order
    against one group's whole row sums (1e-6 of the largest)."""
    r, k, v, w, u, s0, dy, ds = _wkv_inputs(hd, S, hd + S, state)
    t = [None if x is None else torch.from_numpy(x)
         for x in (r, k, v, w, u, s0, dy, ds)]
    got = RW.wkv6_bwd_groups_plain(*t, groups=groups)
    want = RW.wkv6_bwd_plain(*t)
    assert (got[5] is None) == (not state)
    for g, x in zip(got, want):
        if x is not None:
            torch.testing.assert_close(g, x, **WKV_TOL)
    via_jax = _wkv_jax(hd, S, state)
    for g, a in zip(got[:5] + ((got[5],) if state else ()), via_jax):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), **WKV_TOL)
    # the partials: one group's row sums are the whole; the groups' sums
    # in rank order equal them to rounding; dv and dstate0 do not depend
    # on the split
    pr, pk, pw, pvd, dv, ds0 = RW.wkv6_bwd_partials_plain(*t, groups=groups)
    one = RW.wkv6_bwd_partials_plain(*t, groups=1)
    assert pr.shape == (groups,) + r.shape and pvd.shape == (groups,) \
        + r.shape[:3]
    for parts, whole in zip((pr, pk, pw, pvd), one[:4]):
        acc = parts[0]
        for c in range(1, groups):
            acc = acc + parts[c]
        _close_rel(acc, whole[0], PART_TOL)
    _close_rel(dv, one[4], PART_TOL)
    _close_rel(ds0, one[5], PART_TOL)


def test_wkv6_bwd_groups_refuse_uneven_split():
    """The groups cut the columns evenly, as the cluster's ranks do."""
    t = [torch.zeros(1, 3, 1, 16)] * 4 + [torch.zeros(1, 16), None,
                                          torch.zeros(1, 3, 1, 16)]
    with pytest.raises(ValueError, match="groups"):
        RW.wkv6_bwd_partials_plain(*t, groups=3)
