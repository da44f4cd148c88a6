"""repro_torch's encoder-decoder path on whisper-tiny held against the JAX
package on the same converted params: the plain gelu MLP, learned
positions (a scalar start and ragged per-slot decode), ``run_encoder``
(non-causal flash, no cache), a decoder block with its ``extra_cross``
sub-block (memory given, then read from the cache), the cache layout, the
logits and greedy streams from ``frames``, and engine streams against
``repro.serving.engine.FlexPipeEngine`` on requests whose ``memory`` is
the encoder's output (bucketed prefill, slot reuse, a request without
memory, a live refactor, a bounded admission queue).  Every cross
``gate`` is set from a seed (the reference's are 0).  The reference's
fault replay is wrong for cross caches; the port refuses it."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_arch as jax_arch
from repro.models import kvcache as JK
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models.transformer import init_model as jax_init_model
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import kvcache as K
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.transformer import count_params
from repro_torch.serving import engine as TE
from repro_torch.serving.workload import Request
from test_torch_cross import (assert_port_refuses_faults, fault_streams,
                              serve_pair, with_gates)

torch.set_num_threads(2)

ARCH = "whisper-tiny"
JCFG = jax_arch(ARCH).smoke_config
CFG = get_arch(ARCH).smoke_config
D = CFG.d_model
NP_PARAMS = with_gates(jax.tree.map(np.asarray, jax.jit(
    jax_init_model, static_argnums=1)(jax.random.PRNGKey(0), JCFG)), 2)
JPARAMS = jax.tree.map(jnp.asarray, NP_PARAMS)
PARAMS = params_from_numpy(NP_PARAMS, "cpu")
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _close(a, b, **tol):
    np.testing.assert_allclose(_np(a), _np(b), **(tol or TOL["float32"]))


def _rand(seed, shape, dt="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(TORCH_DT[dt])
    return t, jnp.asarray(t.float().numpy()).astype(dt)


def test_whisper_tiny_sizes():
    cfg = get_arch(ARCH).config
    assert (cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, cfg.d_ff,
            cfg.encoder_layers, cfg.mlp_act) == (384, 6, 64, 1536, 4, "gelu")
    assert count_params(cfg) == JT.count_params(jax_arch(ARCH).config)
    assert M.run_encoder is not None and cfg.rope_theta == 0


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["decoder", "encoder"])
def test_gelu_mlp_matches_jax(where, dt):
    pj = (NP_PARAMS["blocks"][0] if where == "decoder"
          else NP_PARAMS["encoder"]["blocks"][1])["mlp"]
    assert set(pj) == {"w1", "w2"}
    x, xj = _rand(1, (2, 5, D), dt)
    y, _, _ = L.apply_mlp(CFG, params_from_numpy(pj, "cpu", TORCH_DT[dt]), x)
    yj, _, _ = JL.apply_mlp(JCFG, jax.tree.map(
        lambda a: jnp.asarray(a).astype(dt), pj), xj)
    _close(y, yj, **TOL[dt])


@pytest.mark.parametrize("pos0", [0, 17, "ragged"])
def test_learned_positions_match_jax(pos0):
    S = 1 if pos0 == "ragged" else 6
    toks = np.random.default_rng(2).integers(0, CFG.vocab_size, (3, S))
    p, pj = pos0, pos0
    if pos0 == "ragged":
        pos = np.array([0, 9, 63])
        p, pj = torch.from_numpy(pos), jnp.asarray(pos, jnp.int32)
    x = M.embed_tokens(CFG, PARAMS, torch.from_numpy(toks), p)
    xj = JM.embed_tokens(JCFG, JPARAMS, jnp.asarray(toks), pj)
    _close(x, xj)
    assert (x - PARAMS["embed"][torch.from_numpy(toks)]).abs().max() > 1e-3


@pytest.mark.parametrize("B,S", [(1, 20), (2, 33)])
def test_run_encoder_matches_jax(B, S):
    f, fj = _rand(3, (B, S, D))
    mem = M.run_encoder(CFG, PARAMS, f)
    memj = JM.run_encoder(JCFG, JPARAMS, fj)
    assert mem.shape == (B, S, D)
    _close(mem, memj, atol=1e-4, rtol=1e-4)


def test_extra_cross_block_matches_jax():
    """A decoder block: a 6-token prefill with the memory (the cross cache
    written), then a ragged decode step that reads the cross cache."""
    kind = CFG.layer_kind(0)
    assert kind.extra_cross
    bp, bpj = PARAMS["blocks"][1], JPARAMS["blocks"][1]
    x, xj = _rand(4, (2, 6, D))
    mem, memj = _rand(5, (2, 32, D))
    cache = K.init_cache(CFG, 2, 32, torch.float32, device="cpu",
                         layers=range(1, 2))[0]
    jcache = JK.init_cache(JCFG, 2, 32, jnp.float32, layers=range(1, 2))[0]
    assert set(cache) == {"mixer", "cross"}
    y, _, _ = T.apply_block(CFG, kind, bp, x,
                            T.BlockCtx(pos0=0, cache=cache, memory=mem))
    yj, jcache, _ = JT.apply_block(JCFG, kind, bpj, xj,
                                   JT.BlockCtx(pos0=0, cache=jcache,
                                               memory=memj))
    _close(y, yj)
    xd, xdj = _rand(6, (2, 1, D))
    pos = np.array([6, 3])
    y, new, _ = T.apply_block(CFG, kind, bp, xd,
                              T.BlockCtx(pos0=torch.from_numpy(pos),
                                         cache=cache))
    yj, jnew, _ = JT.apply_block(JCFG, kind, bpj, xdj,
                                 JT.BlockCtx(pos0=jnp.asarray(pos, jnp.int32),
                                             cache=jcache))
    _close(y, yj)
    for part in ("mixer", "cross"):
        for n in ("k", "v"):
            _close(new[part][n], jnew[part][n])


def test_cache_layout_matches_jax():
    for size in ("config", "smoke_config"):
        cfg, jcfg = getattr(get_arch(ARCH), size), getattr(jax_arch(ARCH),
                                                           size)
        for max_seq in (16, 1500):
            mine = K.init_cache(cfg, 2, max_seq, torch.float32,
                                device="meta")
            theirs = JK.init_cache(jcfg, 2, max_seq, jnp.float32,
                                   materialize=False)
            assert [{p: {n: tuple(t.shape) for n, t in leaves.items()}
                     for p, leaves in c.items()} for c in mine] == \
                [{p: {n: tuple(t.shape) for n, t in leaves.items()}
                  for p, leaves in c.items()} for c in theirs]
            assert K.dense_slot_bytes(cfg, max_seq, torch.float32) == \
                JK.dense_slot_bytes(jcfg, max_seq, jnp.float32)
        assert not K.can_page(cfg) and not JK.can_page(jcfg)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _batch(seed, B, S, S_enc):
    toks = np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S))
    fr = np.random.default_rng(seed + 1).standard_normal(
        (B, S_enc, D)).astype(np.float32)
    return ({"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(fr)},
            {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)})


def test_forward_logits_with_frames_match_jax():
    b, bj = _batch(7, 2, 13, 24)
    lg, _, _ = M.forward(CFG, PARAMS, b)
    jlg, _, _ = jax.jit(JM.forward, static_argnums=0)(JCFG, JPARAMS, bj)
    _close(lg, jlg, atol=1e-4, rtol=1e-4)
    other, _, _ = M.forward(CFG, PARAMS, dict(b, frames=b["frames"] * 2))
    assert (other - lg).abs().max() > 1e-3


def test_greedy_generate_streams_match_jax():
    """The prefill's encoder output (24 frames) replaces the max_seq-row
    cross caches, as the reference's returned cache does, and every decode
    step reads it."""
    b, bj = _batch(8, 3, 10, 24)
    got, cache = M.greedy_generate(CFG, PARAMS, b, 8, 32)
    ref, _ = jax.jit(JM.greedy_generate, static_argnums=(0, 3, 4))(
        JCFG, JPARAMS, bj, 8, 32)
    assert got.tolist() == np.asarray(ref).tolist()
    assert cache[0]["cross"]["k"].shape == (3, 4, 24, 16)


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

MAX_SEQ, N_REQ, TOKENS, NO_MEMORY = 64, 6, 8, 4
START = TE.balanced_boundaries(CFG.n_layers, 2)
MOVES = {3: [0], 9: START}


def _reqs(R_):
    """Six requests, 3-30-token prompts, memories the reference's encoder
    made from seeded frames (1, max_seq, d); request 4 has none and reuses
    a slot whose last request had one."""
    rng = np.random.default_rng(9)
    frames = rng.standard_normal((N_REQ, MAX_SEQ, D)).astype(np.float32)
    mems = np.asarray(jax.jit(JM.run_encoder, static_argnums=0)(
        JCFG, JPARAMS, jnp.asarray(frames)))
    out = []
    for i in range(N_REQ):
        r = R_(rid=i, arrival=0.0, prompt_len=int(rng.integers(3, 31)),
               max_new_tokens=TOKENS)
        r.prompt_tokens = rng.integers(0, CFG.vocab_size, r.prompt_len)
        if i != NO_MEMORY:
            r.memory = mems[i:i + 1]
        out.append(r)
    return out


_JAX: dict = {}
RUNS = {"whole": {}, "refactored": dict(refactors=MOVES),
        "admission depth 3": dict(admission=3)}


def _serve(pkg, run):
    reqs = _reqs(Request if pkg == "torch" else JaxRequest)
    if pkg == "jax":
        run = "whole" if run == "refactored" else run
        if run in _JAX:
            return _JAX[run]
    out = serve_pair(pkg, CFG if pkg == "torch" else JCFG, PARAMS, JPARAMS,
                     reqs, max_seq=MAX_SEQ, warm=(1, 2), **RUNS[run]), reqs
    if pkg == "jax":
        _JAX[run] = out
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_engine_streams_match_jax(run):
    (got, turned), _ = _serve("torch", run)
    (ref, jturned), _ = _serve("jax", run)
    assert got == ref and turned == jturned
    if run == "admission depth 3":
        assert turned and len(got) == N_REQ - len(turned)
    else:
        assert sorted(got) == list(range(N_REQ))
        assert all(len(h) == TOKENS for h in got.values())


def test_engine_decode_equals_forward():
    """The port's engine streams against its own forward over prompt and
    output with the request's memory (zeros for the request without one:
    its cross caches were zeroed, and whisper's K/V projections have no
    bias), wherever the top-2 margin exceeds 1e-3."""
    (got, _), reqs = _serve("torch", "whole")
    checked = 0
    for r in reqs:
        mem = torch.as_tensor(getattr(r, "memory",
                                      np.zeros((1, MAX_SEQ, D), np.float32)))
        seq = np.concatenate([r.prompt_tokens, got[r.rid][:-1]])
        lg, _, _ = M.forward(CFG, PARAMS, {
            "tokens": torch.from_numpy(seq)[None], "memory": mem})
        lg = lg[0, len(r.prompt_tokens) - 1:]
        top2 = torch.topk(lg, 2, dim=-1).values
        for j, tok in enumerate(got[r.rid]):
            if top2[j, 0] - top2[j, 1] > 1e-3:
                assert int(lg[j].argmax()) == tok, (r.rid, j)
                checked += 1
    assert checked >= N_REQ * TOKENS - 4


def test_cross_fault_replay_diverges_in_reference_and_port_refuses():
    """The cross caches are max_seq rows long, so the reference's merge
    restores a lost stage's memory rows only below each slot's horizon and
    leaves the rest zero; the replay rebuilds self-attention rows only."""
    frames = np.random.default_rng(10).standard_normal(
        (3, 64, D)).astype(np.float32)
    mems = np.asarray(JM.run_encoder(JCFG, JPARAMS, jnp.asarray(frames)))
    clean, faulty = fault_streams(JCFG, JPARAMS, [0, 1],
                                  lambda i: mems[i:i + 1])
    assert [a[:11] for a in clean] == [b[:11] for b in faulty]
    assert any(a != b for a, b in zip(clean, faulty))       # the quirk
    assert_port_refuses_faults(CFG, PARAMS, [0, 1])


def test_serve_launcher_runs_whisper(capsys):
    """Each request's memory is the encoder's output over seeded frames."""
    serve.main(["--arch", ARCH, "--rate", "10", "--cv", "4", "--duration",
                "1", "--device", "cpu"])
    out = capsys.readouterr().out
    n = int(out.split("serving ")[1].split()[0])
    line = next(x for x in out.splitlines() if x.startswith("completed="))
    assert line.startswith(f"completed={n} ")
