"""repro_torch's multi-rank train step against the reference's
``build_train_step`` on the same plan: four of the six (arch, S, T, R)
cases of tests/test_pipeline_parallel.py::test_train_loss_matches_reference
(the other two are in tests/test_torch_parallel_models.py) and
whisper-tiny at T = 2, R = 2, its encoder tensor-parallel (which the
reference never tests), in a gloo
world of 8 CPU ranks on a (data 2, model 4) mesh (tests/torch_dist.py)
beside the JAX step on the 8-device host mesh, from the same weights
(every cross gate set from a seed: the init's 0 silences a cross layer)
and batch, one step at the reference test's AdamW settings (lr 1e-3, 100
warmup steps: lr 1e-5 at step 1).

Held (``jax_compile.hold_train``): the loss against the reference's
single-device ``loss_fn`` at the reference test's 3e-3 and against the JAX
step at 1e-5 relative; the grad norm against the JAX step at 1e-4
relative; the updated params and both moments, gathered back from every
rank, against the JAX step's at 1e-5 (the first moment is 0.1 x the
gradient, the second 0.05 x its square, so they hold the gradients
element by element).

And the reference's quirk (ROADMAP.md section 3): its steps are built with
``shard_map(check_vma=False)``, under which the transpose of a psum is a
psum, so every gradient is the single-device one times the device count:
the grad norm over the single-device gradient norm of ``loss_fn`` is 8 on
every plan, in the reference and in the port.
"""
import pytest
import torch
from jax_compile import hold_train, jax_train, single_device, train_case
from torch_dist import NRANKS, run_cases

torch.set_num_threads(2)

OPT = dict(lr=1e-3)
CASES = [("qwen1.5-0.5b", 4, 1, 1), ("qwen1.5-0.5b", 2, 2, 1),
         ("deepseek-moe-16b", 2, 2, 1),     # MoE expert-parallel
         ("rwkv6-1.6b", 4, 1, 1),           # attention-free
         ("whisper-tiny", 1, 2, 2)]         # encoder TP (untested there)
# (atol, rtol) of the params and moments against the JAX step
TOL = {"params": (1e-5, 1e-5), "m": (1e-5, 1e-5), "v": (1e-5, 1e-5)}


@pytest.fixture(scope="module")
def world():
    """The port's step on every case, in one world of 8 ranks."""
    return dict(zip(CASES, run_cases([train_case(*c, OPT) for c in CASES])))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-S{c[1]}"
                         f"T{c[2]}R{c[3]}")
def test_train_step_equals_reference(world, case):
    c = train_case(*case, OPT)
    got = world[case]
    assert got["mesh"] == dict(pod=1, data=2, stage=case[1], tensor=case[2],
                               replica=case[3])
    jax_out = jax_train(case[0], c["plan"], c["params"], c["batches"][0],
                        OPT)
    ref, norm1 = single_device(case[0], c["params"], c["batches"][0])
    hold_train(got, jax_out, ref, norm1, NRANKS, TOL)
