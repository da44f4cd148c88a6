"""Serving at the reference's default bf16 params, on the CPU: qwen1.5-0.5b's
engine with bf16 params and a bf16 cache against the JAX engine at bf16
(the prefill logits of the engines' own stage programs, within FACTOR times
the reference's own bf16-to-f32 distance on the same weights), the port's
invariants at bf16 (a refactored run, paged gather and paged kernel runs
equal the dense run; chunked prefill equals the whole prompt), and
deepseek-v2-236b's smoke config with its MLA heads widened to the served
pair (nope 128, rope 64, v 128: flash at (192, 128)), whose forward is held
to ``repro.models.model.forward`` at bf16 by the same rule and whose engine
streams across a refactor equal its unrefactored run (the reference's
engine cannot serve MLA), and gemma3-1b's smoke config with its heads widened
to the served 256 (flash at (256, 256)), whose engine prefill logits are
held to the JAX engine's by the same rule and whose refactored run equals
its unrefactored one.  Streams are not held across packages: at bf16
the two packages round at other places, and a stream may leave the other's
where a top-2 margin is below bf16's rounding."""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import np_params
from repro.configs.base import MLAConfig as JaxMLA
from repro.configs.base import get_arch as jax_arch
from repro.models import model as JM
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import FlexPipeEngine as JaxEngine
from repro_torch.configs.base import MLAConfig, get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as M
from repro_torch.serving.engine import (EngineConfig, FlexPipeEngine,
                                        KVCacheConfig, PrefillConfig)
from repro_torch.serving.workload import Request
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

# a bf16 quantity within FACTOR times the reference's own distance between
# its bf16 and f32 values (the rule of test_torch_bf16_train.py)
FACTOR = 2.0
QWEN = "qwen1.5-0.5b"
# deepseek-v2-236b's MLA heads at the real model's dims: its prefill calls
# flash at (192, 128), the pair the card serves (the smoke's (24, 16) is
# not built there)
MLA = dict(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=64,
           nope_head_dim=128, v_head_dim=128)


def _mla_cfgs():
    """The widened MLA config in each package."""
    return (dataclasses.replace(get_arch("deepseek-v2-236b").smoke_config,
                                mla=MLAConfig(**MLA)),
            dataclasses.replace(jax_arch("deepseek-v2-236b").smoke_config,
                                mla=JaxMLA(**MLA)))


def _port_params(npp, dtype):
    return tree_map(lambda x: x.to(dtype), params_from_numpy(npp, "cpu"))


def _within(mine, ref16, ref32, what):
    """``mine`` (bf16 run) against the reference's bf16 run, within FACTOR
    times the reference's bf16-to-f32 distance."""
    dist = float((ref16 - ref32).abs().max())
    got = float((mine - ref16).abs().max())
    assert dist > 0, what
    assert torch.isfinite(mine).all(), what
    assert got <= FACTOR * dist, f"{what}: {got} > {FACTOR} x {dist}"
    return got, dist


# ---------------------------------------------------------------------------
# qwen1.5-0.5b: the engine at bf16 params and a bf16 cache
# ---------------------------------------------------------------------------

PROMPT = 23                          # tokens, padded to the 32 bucket


def _prompt(vocab):
    toks = np.zeros((1, 32), np.int64)
    toks[0, :PROMPT] = np.random.default_rng(3).integers(0, vocab, PROMPT)
    return toks


def _port_prefill_logits(cfg, npp, dtype, cache, boundaries):
    """The logits of a prompt's every row through the port engine's stage
    prefill programs (each stage's without the head), then lm_head."""
    eng = FlexPipeEngine(cfg, _port_params(npp, dtype), boundaries,
                         EngineConfig(max_batch=4, max_seq=64,
                                      cache_dtype=cache), device="cpu")
    assert {c.dtype for c in tree_leaves(eng.caches)} == {
        getattr(torch, cache)}
    out = torch.from_numpy(_prompt(cfg.vocab_size))
    for si, (lo, hi) in enumerate(eng._stage_ranges()):
        fn, _ = eng.executors.stage_prefill(lo, hi, first=si == 0,
                                            last=False)
        out, _ = fn(eng.params["blocks"][lo:hi], eng.executors.head_params,
                    out, eng.caches[lo:hi], 0, PROMPT, None)
    return M.lm_head(cfg, eng.params, out)[0, :PROMPT].float()


def _jax_prefill_logits(jcfg, npp, dtype, cache, boundaries):
    """The same through the JAX engine's stage prefill programs."""
    eng = JaxEngine(jcfg, jax.tree.map(lambda x: jnp.asarray(x, dtype), npp),
                    boundaries, JaxEngineConfig(max_batch=4, max_seq=64,
                                                cache_dtype=cache))
    out = jnp.asarray(_prompt(jcfg.vocab_size), jnp.int32)
    for si, (lo, hi) in enumerate(eng._stage_ranges()):
        fn, _ = eng.executors.stage_prefill(lo, hi, first=si == 0,
                                            last=False)
        out, new = fn(eng.params["blocks"][lo:hi], eng.executors.head_params,
                      out, eng.caches[lo:hi], jnp.asarray(0, jnp.int32),
                      jnp.asarray(PROMPT, jnp.int32), None)
        eng.caches[lo:hi] = new
    logits = JM.lm_head(jcfg, eng.params, out)[0, :PROMPT]
    return torch.from_numpy(np.array(logits.astype(jnp.float32)))


@pytest.mark.parametrize("boundaries", [[0, 2], [0, 1, 2, 3]])
def test_engine_prefill_logits_bf16_vs_reference(boundaries):
    """The engine's prefill at bf16 params and a bf16 cache (two and four
    stages) against the JAX engine's at bf16, within FACTOR times the
    reference's own bf16-to-f32 distance; at f32 both agree to 3e-5."""
    cfg, jcfg = get_arch(QWEN).smoke_config, jax_arch(QWEN).smoke_config
    npp = np_params(cfg, 0)
    mine = _port_prefill_logits(cfg, npp, torch.bfloat16, "bfloat16",
                                boundaries)
    ref16 = _jax_prefill_logits(jcfg, npp, jnp.bfloat16, "bfloat16",
                                boundaries)
    ref32 = _jax_prefill_logits(jcfg, npp, jnp.float32, "float32",
                                boundaries)
    mine32 = _port_prefill_logits(cfg, npp, torch.float32, "float32",
                                  boundaries)
    torch.testing.assert_close(mine32, ref32, atol=3e-5, rtol=3e-5)
    _within(mine, ref16, ref32, f"qwen prefill logits, stages {boundaries}")


# ---------------------------------------------------------------------------
# the port's invariants at bf16
# ---------------------------------------------------------------------------

def _streams(cfg, params, refactor=False, **ecfg):
    """Six requests (20-69-token prompts, 8 new tokens) on four slots, two
    slots reused; ``refactor``: [0, 2] -> the warmed 4-stage partition
    ([0, 1, 2, 3] at 4 layers) at tick 4 and back at tick 12.  Each
    request's greedy stream."""
    eng = FlexPipeEngine(cfg, params, [0, 2], EngineConfig(
        max_batch=4, max_seq=128, warm_profiles=(4,), **ecfg), device="cpu")
    four = eng._boundaries_for(4)
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(6):
        r = Request(rid=i, arrival=0.0, prompt_len=int(rng.integers(20, 70)),
                    max_new_tokens=8)
        r.prompt_tokens = rng.integers(0, cfg.vocab_size, r.prompt_len)
        reqs.append(r)
        eng.submit(r, now=0.0)
    for t in range(300):
        if refactor and t in (4, 12):
            ev = eng.refactor(four if t == 4 else [0, 2])
            assert ev["compile_cache_hit"]
        eng.step(t * 0.05)
        if not eng.queue and all(s.done for s in eng.slots):
            break
    assert all(r.output is not None and len(r.output) == 8 for r in reqs)
    return {r.rid: list(r.output) for r in reqs}


@functools.lru_cache(maxsize=None)
def _qwen16():
    cfg = get_arch(QWEN).smoke_config
    return cfg, _port_params(np_params(cfg, 0), torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _qwen16_dense(cache):
    cfg, params = _qwen16()
    return _streams(cfg, params, cache_dtype=cache)


@pytest.mark.parametrize("label,kv,refactor", [
    ("refactored", {}, True),
    ("paged gather", dict(paged=True, block_size=16), True),
    ("paged kernel", dict(paged=True, block_size=16, paged_kernel=True),
     True),
    ("paged kernel, no refactor", dict(paged=True, block_size=16,
                                       paged_kernel=True), False),
])
def test_bf16_engine_invariants(label, kv, refactor):
    """At bf16 params and a bf16 cache, a refactored run and paged runs
    (gathered and by the block-table kernel's plain version) give the dense
    unrefactored run's streams bit for bit."""
    cfg, params = _qwen16()
    got = _streams(cfg, params, refactor, cache_dtype="bfloat16",
                   kv=KVCacheConfig(**kv))
    assert got == _qwen16_dense("bfloat16"), label


@pytest.mark.parametrize("chunk", [16, 32])
def test_bf16_chunked_equals_whole_prompt(chunk):
    """Chunked prefill at bf16 params: with an f32 cache (the rows a chunk
    reads back are the fresh bf16 activations, exactly) the streams equal
    the whole-prompt run's; with a bf16 cache the engine warns and prefills
    whole prompts, as the reference does, and so equals it too."""
    cfg, params = _qwen16()
    got = _streams(cfg, params, prefill=PrefillConfig(chunk=chunk))
    assert got == _qwen16_dense("float32")
    with pytest.warns(UserWarning, match="cannot chunk bit-exactly"):
        got = _streams(cfg, params, cache_dtype="bfloat16",
                       prefill=PrefillConfig(chunk=chunk))
    assert got == _qwen16_dense("bfloat16")


# ---------------------------------------------------------------------------
# deepseek-v2-236b, its MLA heads widened to the served pair
# ---------------------------------------------------------------------------

def test_mla_forward_bf16_vs_reference():
    """The widened MLA model's forward at bf16 params against the
    reference's at bf16, within FACTOR times the reference's bf16-to-f32
    distance; at f32 both agree to 1e-4."""
    cfg, jcfg = _mla_cfgs()
    npp = np_params(cfg, 0)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40))
    fwd = jax.jit(lambda p, b: JM.forward(jcfg, p, b)[0])
    out = {}
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        lg, _, _ = M.forward(cfg, _port_params(npp, dt),
                             {"tokens": torch.from_numpy(toks)})
        jl = fwd(jax.tree.map(lambda x: jnp.asarray(x, jdt), npp),
                 {"tokens": jnp.asarray(toks, jnp.int32)})
        out[dt] = (lg.float(),
                   torch.from_numpy(np.array(jl.astype(jnp.float32))))
    torch.testing.assert_close(*out[torch.float32], atol=1e-4, rtol=1e-4)
    _within(out[torch.bfloat16][0], out[torch.bfloat16][1],
            out[torch.float32][1], "widened MLA logits")


def test_mla_engine_bf16_refactor_equals_unrefactored():
    """The widened MLA model served at bf16 params and a bf16 latent cache:
    a run refactored [0, 2] -> [0, 1, 2, 3] -> [0, 2] gives the
    unrefactored run's streams bit for bit, and its caches are bf16."""
    cfg, _ = _mla_cfgs()
    params = _port_params(np_params(cfg, 0), torch.bfloat16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        base = _streams(cfg, params, cache_dtype="bfloat16")
    assert _streams(cfg, params, True, cache_dtype="bfloat16") == base
    eng = FlexPipeEngine(cfg, params, [0, 2], EngineConfig(
        max_batch=4, max_seq=128, cache_dtype="bfloat16"), device="cpu")
    assert {c.dtype for c in tree_leaves(eng.caches)} == {torch.bfloat16}


# ---------------------------------------------------------------------------
# gemma3-1b, its heads widened to the served 256
# ---------------------------------------------------------------------------

GEMMA = "gemma3-1b"


def _gemma_cfgs():
    """gemma3-1b's smoke config (13 layers, window 8 on the local layers,
    4 heads on 1) with head_dim 256, the served width, so that its prefill
    calls flash at (256, 256), in each package."""
    return (dataclasses.replace(get_arch(GEMMA).smoke_config, head_dim=256),
            dataclasses.replace(jax_arch(GEMMA).smoke_config, head_dim=256))


def test_gemma3_engine_prefill_logits_bf16_vs_reference():
    """gemma3's engine prefill (two stages, a 23-token prompt that rolls
    the local layers' 8-row rings) at bf16 params and a bf16 cache against
    the JAX engine's at bf16, within FACTOR times the reference's own
    bf16-to-f32 distance; at f32 both agree to 3e-5."""
    cfg, jcfg = _gemma_cfgs()
    npp = np_params(cfg, 0)
    mine = _port_prefill_logits(cfg, npp, torch.bfloat16, "bfloat16",
                                [0, 7])
    ref16 = _jax_prefill_logits(jcfg, npp, jnp.bfloat16, "bfloat16", [0, 7])
    ref32 = _jax_prefill_logits(jcfg, npp, jnp.float32, "float32", [0, 7])
    mine32 = _port_prefill_logits(cfg, npp, torch.float32, "float32",
                                  [0, 7])
    torch.testing.assert_close(mine32, ref32, atol=3e-5, rtol=3e-5)
    _within(mine, ref16, ref32, "gemma3 prefill logits")


def test_gemma3_engine_bf16_refactor_equals_unrefactored():
    """gemma3 with 256-wide heads served at bf16 params and bf16 caches
    (local rings and global rows): a run refactored [0, 2] -> [0, 4, 7,
    10] -> [0, 2] gives the unrefactored run's streams bit for bit."""
    cfg, _ = _gemma_cfgs()
    params = _port_params(np_params(cfg, 0), torch.bfloat16)
    eng = FlexPipeEngine(cfg, params, [0, 2], EngineConfig(
        max_batch=4, max_seq=128, cache_dtype="bfloat16"), device="cpu")
    assert {c.dtype for c in tree_leaves(eng.caches)} == {torch.bfloat16}
    del eng
    base = _streams(cfg, params, cache_dtype="bfloat16")
    assert _streams(cfg, params, True, cache_dtype="bfloat16") == base
