"""repro_torch on gemma3 (sliding-window ring caches, GeGLU, head_dim 256)
held against the JAX package on the same converted params (the configs
are held in test_torch_model.py): gemma3-1b's widths, the GeGLU MLP, windowed attention through prefill (shorter than the ring, as
long, longer: the roll), ragged decode across the ring's wrap, the kernels'
plain versions at hd 256 and (192, 128) against the Pallas kernels in
interpret mode, cache sizing and the roofline, logits, greedy streams and
engine streams (prompts longer than the window, decodes that wrap it, slot
reuse after a long prompt, refactors).  The reference's fault replay is
wrong on ring caches; the port refuses it (ROADMAP.md, section 3).  The
CUDA kernels at these shapes are tested in test_torch_cuda.py."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_arch as jax_arch
from repro.kernels.decode_attention import decode_attention as pl_decode
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro.launch import roofline as R
from repro.models import kvcache as JK
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.transformer import init_model as jax_init_model
from repro.serving import engine as JE
from repro.serving import faults as JF
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import serve
from repro_torch.launch.roofline import layer_fwd, layer_param_bytes
from repro_torch.models import kvcache as K
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.transformer import count_params
from repro_torch.serving import engine as TE
from repro_torch.serving.faults import (PREEMPT_STAGE, FaultEvent,
                                        FaultInjector,
                                        FaultPolicy, StageHealthMonitor)
from repro_torch.serving.workload import Request

torch.set_num_threads(2)

JCFG = jax_arch("gemma3-1b").smoke_config
CFG = get_arch("gemma3-1b").smoke_config
JPARAMS = jax_init_model(jax.random.PRNGKey(0), JCFG)
NP_PARAMS = jax.tree.map(np.asarray, JPARAMS)
PARAMS = params_from_numpy(NP_PARAMS, "cpu")
ATTN_TOL = dict(atol=3e-5, rtol=3e-5)      # f32 attention, as test_kernels
TOL = dict(atol=1e-5, rtol=1e-5)
LOCAL, GLOBAL = 0, 5                       # layers of the smoke config
W = CFG.sliding_window                     # 8


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(tol or TOL))


def _x(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_gemma3_1b_widths():
    cfg = get_arch("gemma3-1b").config
    assert [i for i in range(26) if cfg.is_global_layer(i)] == [5, 11, 18, 24]
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size) == (1152, 4, 1, 256, 6912, 262144)
    assert count_params(cfg) == 999_812_736
    caches = K.init_cache(cfg, 8, 1024, torch.float32, device="meta")
    assert K.cache_bytes(caches) == 251_658_240
    assert TE.balanced_boundaries(26, 2) == [0, 13]
    assert TE.balanced_boundaries(26, 4) == [0, 7, 14, 20]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_geglu_mlp_matches_jax():
    x, xj = _x(1, (2, 5, CFG.d_model))
    y, _, _ = L.apply_mlp(CFG, PARAMS["blocks"][0]["mlp"], x)
    yj, _, _ = JL.apply_mlp(JCFG, NP_PARAMS["blocks"][0]["mlp"], xj)
    _close(y, yj)
    # the SwiGLU of the same weights differs: the activation is gelu's
    swi = get_arch("qwen1.5-0.5b").smoke_config
    ys, _, _ = L.apply_mlp(swi, PARAMS["blocks"][0]["mlp"], x)
    assert not torch.allclose(y, ys)


def test_plain_gelu_mlp_matches_jax():
    """The two-matrix gelu MLP (whisper's ``w1/w2``) at gemma3's widths:
    tanh gelu, as ``jax.nn.gelu``'s default, not PyTorch's erf form."""
    from repro_torch.configs.base import shrink
    whisper_like = shrink(CFG, mlp_act="gelu")
    rng = np.random.default_rng(3)
    pj = {"w1": rng.standard_normal((CFG.d_model, 96)).astype(np.float32)
          / 8, "w2": rng.standard_normal((96, CFG.d_model)).astype(
              np.float32) / 10}
    x, xj = _x(2, (1, 3, CFG.d_model))
    y, _, _ = L.apply_mlp(whisper_like, params_from_numpy(pj, "cpu"), x)
    yj, _, _ = JL.apply_mlp(dataclasses.replace(JCFG, mlp_act="gelu"), pj,
                            xj)
    _close(y, yj)
    erf = torch.matmul(torch.nn.functional.gelu(
        torch.matmul(x, torch.from_numpy(pj["w1"]))),
        torch.from_numpy(pj["w2"]))
    assert not torch.allclose(y, erf, atol=1e-7, rtol=0)


def _caches(layer, B, max_seq):
    mine = K.init_cache(CFG, B, max_seq, torch.float32, device="cpu",
                        layers=range(layer, layer + 1))[0]["mixer"]
    theirs = JK.init_cache(JCFG, B, max_seq, jnp.float32,
                           layers=range(layer, layer + 1))[0]["mixer"]
    return mine, theirs


@pytest.mark.parametrize("S", [5, W, 21])
@pytest.mark.parametrize("layer", [LOCAL, GLOBAL])
def test_windowed_prefill_matches_jax(layer, S):
    """A prompt shorter than the ring, as long (roll by 0), longer (the
    last Smax rows rolled so position p sits at row p % Smax): output and
    cache against the JAX layer.  The global layer's cache holds every
    row."""
    glob = layer == GLOBAL
    p = PARAMS["blocks"][layer]["mixer"]
    pj = NP_PARAMS["blocks"][layer]["mixer"]
    c, cj = _caches(layer, 2, 32)
    assert c["k"].shape[2] == (32 if glob else W)
    x, xj = _x(3 + S, (2, S, CFG.d_model))
    y, c, _ = L.apply_attention(CFG, p, x, pos0=0, cache=c, is_global=glob)
    yj, cj, _ = JL.apply_attention(JCFG, pj, xj, pos0=0, cache=cj,
                                   is_global=glob)
    _close(y, yj, **ATTN_TOL)
    _close(c["k"], cj["k"], **ATTN_TOL)
    _close(c["v"], cj["v"], **ATTN_TOL)
    # no cache: the windowed prefill alone
    y0, _, _ = L.apply_attention(CFG, p, x, pos0=0, is_global=glob)
    _close(y0, yj, **ATTN_TOL)


@pytest.mark.parametrize("ragged", [True, False])
def test_windowed_decode_across_the_wrap_matches_jax(ragged):
    """Decode steps from a filled ring: slot 0 wraps mid-way (positions 5
    to 12), slot 1 has long wrapped; each step writes row pos % Smax and
    reads min(pos + 1, Smax) rows.  Scalar positions wrap too."""
    p = PARAMS["blocks"][LOCAL]["mixer"]
    pj = NP_PARAMS["blocks"][LOCAL]["mixer"]
    fill = np.random.default_rng(4).standard_normal((2, 1, W, 16))
    c = {n: torch.from_numpy(fill.astype(np.float32)) for n in ("k", "v")}
    cj = {n: jnp.asarray(fill, jnp.float32) for n in ("k", "v")}
    pos = np.array([5, 29], np.int64) if ragged else np.array([5, 5])
    for step in range(8):
        x, xj = _x(10 + step, (2, 1, CFG.d_model))
        if ragged:
            p0, p0j = torch.from_numpy(pos), jnp.asarray(pos, jnp.int32)
        else:
            p0, p0j = int(pos[0]), jnp.int32(pos[0])
        y, c, _ = L.apply_attention(CFG, p, x, pos0=p0, cache=c,
                                    is_global=False)
        yj, cj, _ = JL.apply_attention(JCFG, pj, xj, pos0=p0j, cache=cj,
                                       is_global=False)
        _close(y, yj, **ATTN_TOL)
        _close(c["k"], cj["k"], **ATTN_TOL)
        pos = pos + 1


def test_stale_rows_of_a_reused_slot_are_never_read():
    """The engine prefills a reused slot's rows [0, S) in place and leaves
    the rest as the last request left them (the reference prefills into a
    zeroed cache).  Until decode has overwritten them, min(pos + 1, Smax)
    keeps them unread: the same outputs as from zeroed caches, ring and
    global layers alike."""
    toks = np.random.default_rng(5).integers(0, CFG.vocab_size, (1, 5))
    outs = []
    for fill in (0.0, 1e3):
        cache = K.init_cache(CFG, 1, 32, torch.float32, device="cpu")
        for c in cache:
            for t in c["mixer"].values():
                t.fill_(fill)
        logits, cache, _ = M.forward(CFG, PARAMS,
                                     {"tokens": torch.from_numpy(toks)},
                                     cache=cache, pos0=0)
        seq = [logits[0, -1]]
        tok = logits[:, -1].argmax(-1)[:, None]
        for pos in range(5, 15):               # the rings wrap at 8
            logits, cache, _ = M.forward(CFG, PARAMS, {"tokens": tok},
                                         cache=cache,
                                         pos0=torch.tensor([pos]))
            seq.append(logits[0, -1])
            tok = logits[:, -1].argmax(-1)[:, None]
        outs.append(torch.stack(seq))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the kernels' plain versions at gemma3's and MLA's shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,hdv,H,Kh,S,window", [
    (256, 256, 4, 1, 40, W),          # gemma3: hd 256, a local layer
    (256, 256, 4, 1, 40, 0),          # a global layer
    (192, 128, 4, 4, 40, 0),          # MLA prefill: hd 192, hdv 128
])
def test_flash_plain_vs_pallas(hd, hdv, H, Kh, S, window):
    rng = np.random.default_rng(hd + window)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, S, H, hd), (1, S, Kh, hd), (1, S, Kh, hdv)))
    out = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=True, window=window)
    assert out.shape == (1, S, H, hdv)
    pallas = pl_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                      window=window, block_q=16, block_k=16, interpret=True)
    _close(out, pallas, **ATTN_TOL)


@pytest.mark.parametrize("Smax,lens", [(W, [1, 7, 8, 30]),
                                       (32, [1, 9, 31, 32])])
def test_decode_plain_vs_pallas_hd256(Smax, lens):
    """gemma3's decode: hd 256, G = 4, cache_len clipped to Smax by the
    caller (a wrapped ring reads every row)."""
    rng = np.random.default_rng(Smax)
    B, H, Kh, hd = len(lens), 4, 1, 256
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, Kh, Smax, hd)).astype(np.float32)
              for _ in range(2))
    cl = np.minimum(np.asarray(lens, np.int32), Smax)
    out = decode_attention_plain(*map(torch.from_numpy, (q, kc, vc, cl)))
    pallas = pl_decode(*map(jnp.asarray, (q, kc, vc, cl)), block_k=16,
                       interpret=True)
    _close(out, pallas, **ATTN_TOL)


# ---------------------------------------------------------------------------
# cache sizing and the roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma3-12b"])
def test_cache_sizing_equals_reference(arch):
    cfg, jcfg = get_arch(arch).smoke_config, jax_arch(arch).smoke_config
    for max_seq in (4, 32):
        caches = K.init_cache(cfg, 2, max_seq, torch.float32, device="meta")
        structs = JK.init_cache(jcfg, 2, max_seq, jnp.float32,
                                materialize=False)
        assert [tuple(c["mixer"]["k"].shape) for c in caches] == \
            [s["mixer"]["k"].shape for s in structs]
        assert K.cache_bytes(caches) == JK.cache_bytes(structs)
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            for T in (1, 2):
                assert K.dense_slot_bytes(cfg, max_seq, dt, T) == \
                    JK.dense_slot_bytes(jcfg, max_seq, jdt, T)
        old, new = [0, 2], [0, 1, 3, 4]
        per_stage = K.group_by_stage(caches, old)
        regrouped = K.regroup(per_stage, new)
        ref = JK.regroup(JK.group_by_stage(structs, old), new)
        assert [[tuple(c["mixer"]["k"].shape) for c in s] for s in regrouped] \
            == [[c["mixer"]["k"].shape for c in s] for s in ref]
        assert K.migration_plan(old, new, cfg.n_layers) == \
            JK.migration_plan(old, new, jcfg.n_layers)
    assert not K.can_page(cfg) and not JK.can_page(jcfg)


@pytest.mark.parametrize("size", ["config", "smoke_config"])
def test_roofline_equals_reference(size):
    cfg = getattr(get_arch("gemma3-1b"), size)
    jcfg = getattr(jax_arch("gemma3-1b"), size)
    for j in range(cfg.pattern_size):         # local and global layers
        for tok, ctx, decode in ((8, 1024, True), (512, 512, False),
                                 (1, 100, True)):
            mine = layer_fwd(cfg, j, tok, ctx, 1, decode, bytes_per_el=R.BYTES)
            ref = R.layer_fwd(jcfg, j, tok, ctx, 1, decode)
            assert (mine.flops, mine.hbm_bytes) == (ref.flops,
                                                     ref.hbm_bytes), j
        assert layer_param_bytes(cfg, j, 1, bytes_per_el=R.BYTES) == \
            R.layer_param_bytes(jcfg, j, 1)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

_OTHER = {}


def _arch(arch):
    """(port params, JAX params) of an arch's smoke config, made once."""
    if arch == "gemma3-1b":
        return PARAMS, JPARAMS
    if arch not in _OTHER:
        jp = jax_init_model(jax.random.PRNGKey(0), jax_arch(arch).smoke_config)
        _OTHER[arch] = (params_from_numpy(jax.tree.map(np.asarray, jp),
                                          "cpu"), jp)
    return _OTHER[arch]


@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma3-12b"])
def test_forward_logits_match_jax(arch):
    cfg, jcfg = get_arch(arch).smoke_config, jax_arch(arch).smoke_config
    params, jparams = _arch(arch)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 21))
    logits, _, _ = M.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    lj, _, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    assert logits.shape == (2, 21, cfg.vocab_size)
    _close(logits, lj, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma3-12b"])
def test_greedy_generate_streams_match_jax(arch):
    """A 13-token prompt rolls into the 8-row rings (position 12 at row
    4); 6 steps write rows 5, 6, 7, 0, 1, 2: across the ring's end."""
    cfg, jcfg = get_arch(arch).smoke_config, jax_arch(arch).smoke_config
    params, jparams = _arch(arch)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 13))
    out, cache = M.greedy_generate(cfg, params,
                                   {"tokens": torch.from_numpy(toks)},
                                   steps=6, max_seq=32)
    oj, _ = JM.greedy_generate(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                               steps=6, max_seq=32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(oj))
    assert cache[0]["mixer"]["k"].shape[2] == W          # a ring
    assert cache[5]["mixer"]["k"].shape[2] == 32         # global


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# max_batch 2, so slots are reused: the 5-token prompt follows the 20-token
# one into slot 0 (its rows 5.. hold the last request's), 20 and 11 roll
# into the rings, 8 fills one exactly, and every decode of 9 tokens after
# the 5- and 8-token prompts wraps them
PROMPTS = (20, 11, 5, 8, 11, 5)
TOKENS = 9


def _reqs(R_):
    rng = np.random.default_rng(3)
    out = []
    for i, n in enumerate(PROMPTS):
        r = R_(rid=i, arrival=0.0, prompt_len=n, max_new_tokens=TOKENS)
        r.prompt_tokens = rng.integers(0, CFG.vocab_size, n)
        out.append(r)
    return out


def _streams(eng, R_, refactors=None):
    reqs = _reqs(R_)
    for r in reqs:
        eng.submit(r, now=0.0)
    owner, hist, t = {}, {}, 0
    while eng.queue or any(not s.done for s in eng.slots):
        if refactors and t in refactors:
            ev = eng.refactor(refactors[t])
            assert ev["inflight"] > 0
            assert ev["compile_cache_hit"] and ev["new_traces"] == 0, ev
        eng.step(t * 0.05)
        for i, s in enumerate(eng.slots):
            if s.request is not None:
                owner[i] = s.request.rid
            if i in owner and s.generated:
                hist[owner[i]] = list(s.generated)
        t += 1
    assert sorted(hist) == [r.rid for r in reqs]
    return hist, reqs


def _engine(boundaries, **kw):
    ecfg = dict(max_batch=2, max_seq=32, warm_profiles=(2, 4))
    ecfg.update(kw)
    return TE.FlexPipeEngine(CFG, PARAMS, boundaries, TE.EngineConfig(**ecfg),
                             device="cpu")


@pytest.fixture(scope="module")
def jax_streams():
    eng = JE.FlexPipeEngine(JCFG, JPARAMS, [0, 7],
                            JE.EngineConfig(max_batch=2, max_seq=32))
    assert not eng.executors.can_bucket
    return _streams(eng, JaxRequest)[0]


@pytest.mark.parametrize("start,refactors", [
    ([0, 7], None),
    ([0, 7], {3: [0, 4, 7, 10], 12: [0, 7]}),           # split and back
    ([0, 4, 7, 10], {2: [0, 7]}),                       # merge
])
def test_engine_streams_match_jax(jax_streams, start, refactors):
    streams, _ = _streams(_engine(start), Request, refactors)
    assert streams == jax_streams
    assert all(len(s) == TOKENS for s in streams.values())


def test_engine_streams_equal_forward():
    """Each stream is the argmax of a whole-sequence (windowed flash)
    forward, token by token, for the prompts that roll, wrap and reuse."""
    streams, reqs = _streams(_engine([0, 7]), Request)
    for r in reqs[:3]:
        toks = np.concatenate([r.prompt_tokens, streams[r.rid][:-1]])
        logits, _, _ = M.forward(CFG, PARAMS,
                                 {"tokens": torch.from_numpy(toks)[None]})
        assert logits[0, r.prompt_len - 1:].argmax(-1).tolist() == \
            streams[r.rid]


def test_engine_fused_matches_unfused():
    a, _ = _streams(_engine([0, 7]), Request)
    b, _ = _streams(_engine([0, 7], fused_decode=False), Request)
    assert a == b


def test_engine_paths_of_a_windowed_config():
    """Rings take exact-length prefills and no paging; chunked prefill
    warns and falls back, as in the reference; warmed refactors between
    the balanced cuts build nothing."""
    eng = _engine([0, 7])
    assert not eng.executors.can_bucket and not eng.executors.can_chunk
    assert eng.executors.prefill_bucket(5) == 5
    assert [tuple(c["mixer"]["k"].shape) for c in eng.caches[4:7]] == \
        [(2, 1, W, 16), (2, 1, 32, 16), (2, 1, W, 16)]
    with pytest.raises(ValueError, match="non-windowed"):
        _engine([0, 7], kv=TE.KVCacheConfig(paged=True, block_size=8))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng2 = _engine([0, 7], prefill=TE.PrefillConfig(chunk=16))
    assert eng2._chunk == 0
    assert any("sliding window" in str(w.message) for w in caught)
    for target in ([0, 4, 7, 10], [0, 7]):
        ev = eng.refactor(target)
        assert ev["compile_cache_hit"] and ev["new_traces"] == 0


# ---------------------------------------------------------------------------
# the fault path: wrong in the reference on ring caches, refused here
# ---------------------------------------------------------------------------

def test_ring_fault_replay_diverges_in_reference_and_port_refuses():
    """The reference's merge_with_mask skips a leaf shorter than the live
    length (a ring, once any slot has passed it), so a lost local layer
    keeps zeros where the replay does not reach: the streams differ from
    the fault-free run from the first token after the fault."""
    def run(fault):
        eng = JE.FlexPipeEngine(JCFG, JPARAMS, [0, 7], JE.EngineConfig(
            max_batch=4, max_seq=64, warm_profiles=(1, 2) if fault else (),
            snapshot_interval=4))
        for i in range(3):
            eng.submit(JaxRequest(rid=i, arrival=0.0, prompt_len=12 + i,
                                  max_new_tokens=20))
        eng._admit(0.0)
        if fault:
            eng.attach_faults(injector=JF.FaultInjector.scripted(
                [JF.FaultEvent(t=1.1, kind=JF.PREEMPT_STAGE, stage=0)]),
                monitor=JF.StageHealthMonitor())
        for t in range(12):
            eng.fault_step((t + 1) * 0.1)
            eng.decode_step((t + 1) * 0.1)
        return [list(s.generated) for s in eng.slots][:3]

    clean, faulty = run(False), run(True)
    assert [a[:11] for a in clean] == [b[:11] for b in faulty]
    assert all(a[11] != b[11] for a, b in zip(clean, faulty))   # the quirk

    eng = _engine([0, 7], snapshot_interval=4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, section 3"):
        eng.attach_faults(injector=FaultInjector.scripted(
            [FaultEvent(t=1.1, kind=PREEMPT_STAGE, stage=0)]))
    with pytest.raises(NotImplementedError, match="sliding-window"):
        eng.attach_faults(monitor=StageHealthMonitor())
    with pytest.raises(NotImplementedError, match="sliding-window"):
        eng._on_stage_failure([0], 0.0)
    eng.attach_faults(policy=FaultPolicy(timeout_s=30.0))   # request-level
    assert eng.run(_reqs(Request)[:2]).completed == 2


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_launcher_runs_gemma3(capsys):
    """On the CPU only when asked: without --device it needs CUDA."""
    argv = ["--arch", "gemma3-1b", "--rate", "10", "--cv", "4",
            "--duration", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(argv)
    serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "gemma3-1b: serving" in out
    line = next(x for x in out.splitlines() if x.startswith("completed="))
    n = int(out.split("serving ")[1].split()[0])
    assert line.startswith(f"completed={n} ")
