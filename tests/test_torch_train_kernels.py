"""The gradients of repro_torch's kernels, on the CPU.

The plain versions' gradients (autograd through ``flash_attention_plain``
and ``wkv6_plain``, the backward kernels' plain versions) against
``jax.grad`` of the JAX package's jnp paths and references; and the rule
that keeps a CUDA kernel from dropping a gradient, pinned by stand-ins: with
the wrappers routed to their kernel branch on CPU tensors and the library
loader made to fail, the decode wrappers refuse autograd before reaching
it, and flash attention and wkv6 go through their ``autograd.Function``s,
whose stand-in kernels then give the plain version's gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_compile import run_once

from repro.kernels import ref
from repro.models.layers import flash_attention_jnp
from repro.models.ssm import _wkv_scan
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rwkv6_wkv as RW
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)

torch.set_num_threads(2)

# f32 attention, as tests/test_kernels.py holds the forward
FLASH_TOL = dict(atol=3e-5, rtol=3e-5)
# f32 wkv, as tests/test_kernels.py holds the forward
WKV_TOL = dict(atol=1e-4, rtol=1e-4)


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,hdv", [(16, 16), (64, 64), (128, 128),
                                    (192, 128), (256, 256)])
@pytest.mark.parametrize("mask", ["causal", "window", "full"])
@pytest.mark.parametrize("G", [1, 4])
def test_flash_plain_grads_equal_jax(hd, hdv, mask, G):
    """dq, dk and dv of the plain version against jax.grad of
    flash_attention_jnp (in kv blocks of 16) and of ref.attention_ref, for
    the same dout, end-aligned rows (q_offset = Skv - Sq)."""
    rng = np.random.default_rng(hd + 7 * G)
    B, Sq, Skv, Kh = 2, 20, 28, 2
    H = Kh * G
    causal, window = mask != "full", 8 if mask == "window" else 0
    q, k = _np(rng, (B, Sq, H, hd)), _np(rng, (B, Skv, Kh, hd))
    v, do = _np(rng, (B, Skv, Kh, hdv)), _np(rng, (B, Sq, H, hdv))

    def jax_grads(fn):
        return run_once(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * do),
                                 argnums=(0, 1, 2)), q, k, v)

    via_jnp = jax_grads(lambda q, k, v: flash_attention_jnp(
        q, k, v, causal=causal, window=window, q_offset=Skv - Sq,
        kv_block=16))
    via_ref = jax_grads(lambda q, k, v: ref.attention_ref(
        q, k, v, causal=causal, window=window))
    got = FA.flash_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, do)), causal=causal,
        window=window)
    for g, a, b in zip(got, via_jnp, via_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), **FLASH_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(b), **FLASH_TOL)


# ---------------------------------------------------------------------------
# wkv6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("S", [1, 9, 40])
def test_wkv6_plain_grads_equal_jax(hd, S):
    """dr, dk, dv, dw, du and dstate0 of the plain version, with a nonzero
    state0 and a final-state gradient, against jax.grad of _wkv_scan and
    ref.wkv6_ref."""
    rng = np.random.default_rng(S + hd)
    B, H = 2, 2
    r, k, v = (_np(rng, (B, S, H, hd), 0.5) for _ in range(3))
    w = (1 / (1 + np.exp(-_np(rng, (B, S, H, hd)))) * 0.5 + 0.45).astype(
        np.float32)
    u = _np(rng, (H, hd), 0.1)
    s0 = _np(rng, (B, H, hd, hd))
    dy, ds = _np(rng, (B, S, H, hd)), _np(rng, (B, H, hd, hd))

    def jax_grads(fn):
        def loss(*a):
            y, st = fn(*a)
            return jnp.sum(y * dy) + jnp.sum(st * ds)
        return run_once(jax.grad(loss, argnums=tuple(range(6))),
                        r, k, v, w, u, s0)

    via_scan = jax_grads(_wkv_scan)
    via_ref = jax_grads(lambda r, k, v, w, u, s0: ref.wkv6_ref(
        r, k, v, w, u, state0=s0))
    t = [torch.from_numpy(x) for x in (r, k, v, w, u, s0, dy, ds)]
    got = RW.wkv6_bwd_plain(*t)
    for g, a, b in zip(got, via_scan, via_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), **WKV_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(b), **WKV_TOL)


def test_wkv6_bwd_plain_without_state():
    """No state0 (the training call) and no final-state gradient: the
    gradients of y alone, dstate0 None."""
    rng = np.random.default_rng(3)
    B, S, H, hd = 1, 12, 2, 16
    r, k, v, w, dy = (torch.from_numpy(_np(rng, (B, S, H, hd), 0.5))
                      for _ in range(5))
    w = torch.sigmoid(w) * 0.5 + 0.45
    u = torch.from_numpy(_np(rng, (H, hd), 0.1))
    got = RW.wkv6_bwd_plain(r, k, v, w, u, None, dy)
    assert got[5] is None
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    y, _ = RW.wkv6_plain(*ins)
    want = torch.autograd.grad(y, ins, dy)
    for g, x in zip(got[:5], want):
        torch.testing.assert_close(g, x)


# ---------------------------------------------------------------------------
# the rule: no CUDA kernel output drops a gradient (stand-ins)
# ---------------------------------------------------------------------------

@pytest.fixture
def kernel_branch(monkeypatch):
    """CPU tensors routed to the wrappers' kernel branch, and a library
    loader that fails if it is reached."""
    def loader(name):
        raise AssertionError(f"library loader reached for {name}")

    monkeypatch.setattr(build, "route", lambda t, what: "kernel")
    monkeypatch.setattr(build, "library", loader)


def test_decode_wrappers_refuse_grad(kernel_branch):
    q = torch.zeros((2, 4, 16), requires_grad=True)
    kc = torch.zeros((2, 2, 32, 16))
    pool = torch.zeros((5, 2, 8, 16))
    tables = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="decode_attention: the CUDA "
                                           "kernel has no backward"):
        decode_attention(q, kc, kc, 5)
    with pytest.raises(RuntimeError, match="paged_decode_attention: the "
                                           "CUDA kernel has no backward"):
        paged_decode_attention(q, pool, pool, tables, 5)
    # a cache that requires grad is refused as well
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q.detach(), kc.requires_grad_(True), kc, 5)
    # without autograd the wrappers go on to the kernel: the loader
    with torch.no_grad():
        with pytest.raises(AssertionError, match="decode_attention"):
            decode_attention(q, kc, kc, 5)
        with pytest.raises(AssertionError, match="decode_attention"):
            paged_decode_attention(q, pool, pool, tables, 5)


def _flash_stand_ins(monkeypatch, calls):
    def fwd(q, k, v, causal, window, scale, q_offset):
        calls.append("forward")
        return FA.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        q_offset=q_offset)

    def bwd(q, k, v, o, dout, causal, window, scale, q_offset):
        calls.append("backward")
        return FA.flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                            window=window, scale=scale,
                                            q_offset=q_offset)

    monkeypatch.setattr(FA, "_launch_forward", fwd)
    monkeypatch.setattr(FA, "_launch_backward", bwd)


@pytest.mark.parametrize("window,q_offset", [(0, None), (6, 3)])
def test_flash_goes_through_its_function(kernel_branch, monkeypatch,
                                         window, q_offset):
    """Under autograd the kernel branch runs FlashAttentionFn: its output
    has a grad_fn, and backward gives the plain version's gradients (GQA:
    dk and dv summed over the group); without autograd it launches the
    forward alone."""
    calls = []
    _flash_stand_ins(monkeypatch, calls)
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(_np(rng, s)) for s in
                   ((2, 10, 4, 16), (2, 14, 2, 16), (2, 14, 2, 16),
                    (2, 10, 4, 16)))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FA.flash_attention(*ins, window=window, q_offset=q_offset)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, ins, do)
    assert calls == ["forward", "backward"]
    want = FA.flash_attention_bwd_plain(q, k, v, do, window=window,
                                        q_offset=q_offset)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    with torch.no_grad():
        assert FA.flash_attention(*ins, window=window).grad_fn is None
    assert calls == ["forward", "backward", "forward"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FA.flash_attention(*(t.to(torch.bfloat16).requires_grad_(True)
                             for t in (q, k, v)))


def _wkv_inputs(rng, B=2, S=7, H=2, hd=16):
    r, k, v = (torch.from_numpy(_np(rng, (B, S, H, hd), 0.5))
               for _ in range(3))
    w = torch.sigmoid(torch.from_numpy(_np(rng, (B, S, H, hd)))) * 0.5 + 0.45
    u = torch.from_numpy(_np(rng, (H, hd), 0.1))
    s0 = torch.from_numpy(_np(rng, (B, H, hd, hd)))
    return r, k, v, w, u, s0


def test_wkv6_goes_through_its_function(kernel_branch, monkeypatch):
    """Under autograd the kernel branch runs WKV6Fn: state0 is left as it
    was, the final state is a new tensor, and backward gives the plain
    version's gradients; without autograd the kernel overwrites state0 in
    place, the serving path's contract."""
    calls = []

    def fwd(r, k, v, w, u, st):
        calls.append("forward")
        y, s = RW.wkv6_plain(r, k, v, w, u, st)
        return y, st.copy_(s)

    def bwd(r, k, v, w, u, state0, dy, dstate):
        calls.append("backward")
        return RW.wkv6_bwd_plain(r, k, v, w, u, state0, dy, dstate)

    monkeypatch.setattr(RW, "_launch_forward", fwd)
    monkeypatch.setattr(RW, "_launch_backward", bwd)
    rng = np.random.default_rng(6)
    r, k, v, w, u, s0 = _wkv_inputs(rng)
    dy, ds = torch.randn_like(r), torch.randn_like(s0)
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0)]
    y, st = RW.wkv6(*ins)
    assert type(y.grad_fn).__name__ == "WKV6FnBackward"
    assert st is not ins[5] and torch.equal(ins[5].detach(), s0)
    got = torch.autograd.grad((y, st), ins, (dy, ds))
    assert calls == ["forward", "backward"]
    want = RW.wkv6_bwd_plain(r, k, v, w, u, s0, dy, ds)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, atol=0, rtol=0)
    # no state0 and only y's gradient: the training call
    y, _ = RW.wkv6(*ins[:5])
    got = torch.autograd.grad(y, ins[:5], dy)
    want = RW.wkv6_bwd_plain(r, k, v, w, u, None, dy)
    for g, x in zip(got, want[:5]):
        torch.testing.assert_close(g, x, atol=0, rtol=0)
    st0 = s0.clone()
    with torch.no_grad():
        y, st = RW.wkv6(r, k, v, w, u, st0)
    assert st is st0 and not torch.equal(st0, s0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RW.wkv6(*(t.to(torch.bfloat16) for t in (r, k, v, w)),
                ins[4], None)


def test_cpu_wkv6_under_autograd_keeps_state0():
    """On the CPU, too, a call that autograd records leaves state0 as it
    was (a later in-place write would corrupt what autograd saved)."""
    rng = np.random.default_rng(2)
    r, k, v, w, u, s0 = _wkv_inputs(rng)
    keep = s0.clone()
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    y, st = RW.wkv6(*ins, s0)
    assert torch.equal(s0, keep) and st is not s0
    torch.autograd.grad(y.sum() + st.sum(), ins)
    y2, st2 = RW.wkv6(r, k, v, w, u, s0)        # no autograd: in place
    assert st2 is s0 and torch.equal(st2, st.detach())


def test_backward_kernel_geometry():
    """The backward kernels' geometry, which their launchers check.  Flash:
    64 query rows a tile up to hd 64 and 32 above, 64 keys a CTA (32 at hd
    256), and both kernels' shared memory within a CTA's 227 KB at every
    head pair.  wkv6: 32 state columns a CTA (16 at hd 16), hd / 32 CTAs a
    cluster, 8 columns a thread, chunks of 16 steps; at hd 64 two CTAs fit
    an SM."""
    for hd, hdv in FA.HEAD_DIM_PAIRS:
        geo = FA._bwd_geometry(hd, hdv)
        assert geo.keys == (32 if hd == 256 else 64)
        assert geo.rows == (64 if max(hd, hdv) <= 64 else 32)
        assert geo.smem <= 227 * 1024 and geo.row_smem <= 227 * 1024
    assert FA._bwd_geometry(64, 64) == (64, 64, 160768, 53248)
    assert FA._bwd_geometry(256, 256).smem == 215552
    for hd in RW.HEAD_DIMS:
        geo = RW._bwd_geometry(hd)
        assert geo.cols == min(32, hd) and geo.cluster == hd // geo.cols
        assert geo.threads == hd * geo.cols // 8 and geo.chunk == 16
        assert 1 <= geo.cluster <= 8 and geo.smem <= 227 * 1024
    assert RW._bwd_geometry(64) == (2, 32, 256, 16, 91712)
    assert 2 * RW._bwd_geometry(64).smem <= 227 * 1024
