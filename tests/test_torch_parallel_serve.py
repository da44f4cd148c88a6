"""repro_torch's multi-rank prefill and decode steps against the
reference's ``build_prefill_step`` and ``build_decode_step`` on the same
plan, in a gloo world of 8 CPU ranks on a (data 2, model 4) mesh
(tests/torch_dist.py) beside the JAX steps on the 8-device host mesh:

- qwen1.5-0.5b at S = 4, M = 2, as
  tests/test_pipeline_parallel.py::test_prefill_and_decode_match_reference
  has it: the prefill's last logits and the decode step's logits against
  the JAX steps and the reference's single-device ``prefill`` and
  ``decode_step``, at 1e-4;
- three plans the reference never tests, held the same way, the caches
  too: deepseek-v2-236b (MLA, expert-parallel MoE) at S = 2, T = 2;
  gemma3-12b at T = 4 (ring caches, q heads whole on every rank);
  jamba-v0.1-52b at T = 2, R = 2 (Mamba state split over "tensor");
  llama-3.2-vision-11b and whisper-tiny at T = 2, R = 2 (cross caches
  from image tokens and from the tensor-parallel encoder's output; every
  cross gate set from a seed, as the init's 0 would silence them);
- the reference's quirk with ``seq_parallel_kv`` (ROADMAP.md section 3):
  qwen1.5-0.5b at S = 2, T = 2, M = 2 with the KV rows split over "data".
  The port equals the JAX steps at 1e-4, caches included, and both decode
  logits that differ from the single-device ``decode_step`` by more than 1.
  Where it goes wrong: the prefill step runs its stages with no sequence
  axis, so a global layer takes the local cache of Smax / 2 rows for a
  ring (``apply_attention``'s ``S >= Smax`` branch,
  src/repro/models/layers.py:344-350): every data shard holds the last
  Smax / 2 prompt rows, rolled, where the decode step's
  ``sp_decode_attention`` reads shard r as rows [r Smax / 2, (r + 1) Smax /
  2).  The test holds that layout against the single-device cache.
"""
import numpy as np
import pytest
import torch
from jax_compile import (case_batch, jax_serve, np_params,
                         single_device_serve, with_gates)
from torch_dist import run_cases

from repro_torch.configs.base import get_arch

torch.set_num_threads(2)

MAX_SEQ = 16
CASES = {
    "qwen-S4": ("qwen1.5-0.5b", dict(stages=4, microbatches=2)),
    "mla-S2T2": ("deepseek-v2-236b", dict(stages=2, tensor=2,
                                           microbatches=2)),
    "gemma3-T4": ("gemma3-12b", dict(tensor=4, microbatches=2)),
    "jamba-T2R2": ("jamba-v0.1-52b", dict(tensor=2, replica=2,
                                          microbatches=2)),
    "vision-T2R2": ("llama-3.2-vision-11b", dict(tensor=2, replica=2,
                                                 microbatches=2)),
    "whisper-T2R2": ("whisper-tiny", dict(tensor=2, replica=2,
                                          microbatches=2)),
    "qwen-S2T2-sp": ("qwen1.5-0.5b", dict(stages=2, tensor=2,
                                          microbatches=2,
                                          seq_parallel_kv=True)),
}


def _tokens(arch):
    rng = np.random.default_rng(1)
    cfg = get_arch(arch).smoke_config
    return rng.integers(0, cfg.vocab_size, (8, MAX_SEQ)).astype(np.int32)


def _extra(arch):
    """The prefill's image tokens (vision) or frames (whisper, MAX_SEQ of
    them: the cross caches hold ``max_seq`` encoder rows)."""
    b = case_batch(get_arch(arch).smoke_config, seed=2, S=MAX_SEQ)
    return {k: b[k] for k in ("memory", "frames") if k in b}


def _case(name):
    arch, plan = CASES[name]
    return {"kind": "serve", "arch": arch, "plan": plan,
            "params": with_gates(np_params(get_arch(arch).smoke_config), 7),
            "tokens": _tokens(arch), "max_seq": MAX_SEQ, **_extra(arch)}


@pytest.fixture(scope="module")
def world():
    return dict(zip(CASES, run_cases([_case(n) for n in CASES])))


def _references(name):
    c = _case(name)
    jax_side = jax_serve(c["arch"], c["plan"], c["params"], c["tokens"],
                         MAX_SEQ, extra=_extra(c["arch"]))
    single = single_device_serve(c["arch"], c["params"], c["tokens"],
                                 MAX_SEQ, extra=_extra(c["arch"]))
    return jax_side, single


def _close(a, b):
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


def _caches_close(got, want):
    for j in want:
        for part in want[j]:
            for name in want[j][part]:
                _close(got[j][part][name], want[j][part][name])


@pytest.mark.parametrize("name", ["qwen-S4", "mla-S2T2", "gemma3-T4",
                                  "jamba-T2R2", "vision-T2R2",
                                  "whisper-T2R2"])
def test_prefill_and_decode_equal_reference(world, name):
    got = world[name]
    (jlast, jcaches, jlogits), (slast, _, slogits) = _references(name)
    _close(got["prefill"], jlast)
    _close(got["prefill"], slast)
    _close(got["decode"][0], jlogits)
    _close(got["decode"][0], slogits)
    _caches_close(got["caches"], jcaches)


def test_seq_parallel_decode_equals_reference_and_both_are_wrong(world):
    """The quirk, pinned: the port's sequence-parallel steps equal the
    reference's (logits and caches at 1e-4), and both decode logits that
    differ from the single-device decode by more than 1, while the
    prefill's logits agree with the single-device prefill."""
    got = world["qwen-S2T2-sp"]
    (jlast, jcaches, jlogits), (slast, scache, slogits) = \
        _references("qwen-S2T2-sp")
    _close(got["prefill"], jlast)
    _close(got["prefill"], slast)
    _close(got["decode"][0], jlogits)
    _caches_close(got["caches"], jcaches)
    assert np.abs(jlogits - slogits).max() > 1.0
    assert np.abs(got["decode"][0] - slogits).max() > 1.0
    # where: each data shard of a global layer's k rows (the global cache's
    # dim 4 is split over "data") holds the prompt's last Sloc rows as a
    # ring, row p % Sloc for position p, not rows [r Sloc, (r + 1) Sloc)
    S = MAX_SEQ - 1
    Sloc = MAX_SEQ // 2
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    pps = cfg.n_patterns // 2
    for layer in range(cfg.n_layers):
        s, p = divmod(layer, pps)
        k = got["caches"]["0"]["mixer"]["k"][s, p]      # (B, Kh, Smax, hd)
        ring = np.roll(scache[layer]["mixer"]["k"][:, :, S - Sloc:S],
                       S % Sloc, axis=2)
        for r in range(2):
            _close(k[:, :, r * Sloc:(r + 1) * Sloc], ring)
