"""repro_torch's multi-rank train step against the reference's
``build_train_step`` on the same plan, for the model families whose
parallel branches tests/test_torch_parallel_train.py does not reach: two
of the six (arch, S, T, R) cases of
tests/test_pipeline_parallel.py::test_train_loss_matches_reference
(gemma3-12b's sliding windows at T = 4 with the q heads whole on every
rank, llama-3.2-vision-11b's cross attention at T = 2 R = 2), and one the
reference never tests: jamba-v0.1-52b at T = 2 (Mamba's tensor-parallel
psums, its MoE expert-parallel); each in a gloo
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
CASES = [("gemma3-12b", 1, 4, 1),           # sliding window + TP (q whole)
         ("llama-3.2-vision-11b", 1, 2, 2),  # cross-attn memory
         ("jamba-v0.1-52b", 1, 2, 2)]       # Mamba TP, MoE expert-parallel
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
