"""repro_torch across plans, FSDP, the compressed cross-pod reduction and
the elastic mesh, in a gloo world of 8 CPU ranks (tests/torch_dist.py),
against the reference on the 8-device host mesh:

- FSDP (tests/test_pipeline_parallel.py::test_train_with_fsdp_matches):
  qwen1.5-0.5b at S = 2, T = 2 with every param and moment split over
  "data" as well, one step against the reference's step, as
  tests/test_torch_parallel_train.py holds its cases;
- FlexPipe's invariance (::test_plan_changes_preserve_function): the same
  weights give the same loss at (S, T, M) = (1, 4, 1), (2, 2, 2) and
  (4, 1, 4), each step against the reference's;
- the stacked params of jamba-v0.1-52b at T = 4 split over the ranks and
  gathered back, bit for bit (::test_stack_unstack_roundtrip);
- ``compressed_psum`` over a pod axis of 2 against the reference's inside
  ``shard_map``, and a train step with ``compress_pod`` on a (pod 2, data
  1, model 4) mesh against the reference's;
- ``elastic_mesh``'s shapes and axes against the reference's;
- each collective of ``parallel.comm`` and its backward against
  ``jax.lax``'s collectives and their transposes under
  ``shard_map(check_vma=False)``, gradients taken inside, as the
  reference's steps take theirs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec
from jax_compile import (hold_train, jax_train, np_params, run_once,
                         single_device, train_case)
from torch_dist import NRANKS, run_cases

from repro.configs.base import PipelinePlan as JPlan
from repro.configs.base import get_arch as jax_arch
from repro.parallel.pipeline import stack_params as jax_stack_params
from repro.training.compression import compressed_psum as jax_compressed_psum
from repro.training.fault_tolerance import elastic_mesh as jax_elastic_mesh
from repro_torch.configs.base import get_arch

torch.set_num_threads(2)

TOL = {"params": (1e-5, 1e-5), "m": (1e-5, 1e-5), "v": (1e-5, 1e-5)}
FSDP = ("qwen1.5-0.5b", 2, 2, 1, dict(lr=1e-3))
# (S, T, M): the reference test's plans, AdamW at its defaults
PLANS = [(1, 4, 1), (2, 2, 2), (4, 1, 4)]
POD_MESH = (2, 1, 4)
ELASTIC = [(8, 4, 1), (7, 4, 1), (4, 4, 1), (8, 2, 2), (8, 1, 2), (3, 4, 1)]


def _comm_inputs():
    rng = np.random.default_rng(6)
    return {"x": rng.standard_normal((NRANKS, 6)).astype(np.float32),
            "w": rng.standard_normal((5, 1, 24)).astype(np.float32)}


def _g():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((NRANKS, 96)) * 3.0).astype(np.float32)


def _cases():
    fsdp = train_case(*FSDP, fsdp=True)
    plans = [train_case("qwen1.5-0.5b", S, T, 1, {}, M=M)
             for S, T, M in PLANS]
    pod = dict(train_case("qwen1.5-0.5b", 2, 2, 1, dict(lr=1e-3)),
               mesh=POD_MESH, compress_pod=True)
    jamba = get_arch("jamba-v0.1-52b").smoke_config
    return {"fsdp": fsdp, "plans": plans, "pod": pod,
            "roundtrip": {"kind": "roundtrip", "arch": "jamba-v0.1-52b",
                          "plan": dict(tensor=4),
                          "params": np_params(jamba, seed=1)},
            "compressed": {"kind": "compressed", "mesh": (2, 4), "g": _g()},
            "elastic": {"kind": "elastic", "calls": ELASTIC},
            "comm": {"kind": "comm", **_comm_inputs()}}


@pytest.fixture(scope="module")
def world():
    cases = _cases()
    order = ["fsdp", "plans0", "plans1", "plans2", "pod", "roundtrip",
             "compressed", "elastic", "comm"]
    flat = [cases["fsdp"], *cases["plans"], cases["pod"], cases["roundtrip"],
            cases["compressed"], cases["elastic"], cases["comm"]]
    return dict(zip(order, run_cases(flat)))


def test_fsdp_train_step_equals_reference(world):
    c = train_case(*FSDP, fsdp=True)
    got = world["fsdp"]
    b = c["batches"][0]
    hold_train(got, jax_train(FSDP[0], c["plan"], c["params"], b, FSDP[4]),
               *single_device(FSDP[0], c["params"], b), NRANKS, TOL)


@pytest.mark.parametrize("i", range(len(PLANS)),
                         ids=[f"S{S}T{T}M{M}" for S, T, M in PLANS])
def test_plan_changes_preserve_function(world, i):
    """FlexPipe's invariance at the SPMD level: each plan's step equals the
    reference's, and the loss is the same under every plan (1e-5)."""
    c = _cases()["plans"][i]
    b = c["batches"][0]
    ref, norm1 = single_device("qwen1.5-0.5b", c["params"], b)
    hold_train(world[f"plans{i}"], jax_train("qwen1.5-0.5b", c["plan"],
                                             c["params"], b, {}),
               ref, norm1, NRANKS, TOL)
    for j in range(len(PLANS)):
        np.testing.assert_allclose(world[f"plans{j}"]["metrics"][0]["loss"],
                                   world[f"plans{i}"]["metrics"][0]["loss"],
                                   rtol=1e-5)


def test_stack_shard_unshard_roundtrip(world):
    """jamba's params stacked, split over a T = 4 mesh and gathered back
    are the reference's stacked tree and the params, bit for bit."""
    c = _cases()["roundtrip"]
    got = world["roundtrip"]
    cfg = jax_arch("jamba-v0.1-52b").smoke_config
    want = jax.tree.map(np.asarray, run_once(
        lambda p: jax_stack_params(cfg, JPlan(tensor=4), p),
        jax.tree.map(jnp.asarray, c["params"])))
    for a, b in zip(jax.tree.leaves(got["stacked"]), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(c["params"])):
        np.testing.assert_array_equal(a, b)


def test_compressed_psum_equals_reference(world):
    """The int8 all-reduce over "pod": each rank's row quantized with the
    pod's shared scale, summed in int32, dequantized; the reference's
    inside shard_map, bit for bit, and within one quantum per summand of
    the exact sum."""
    g = _g()
    mesh = jax.make_mesh((2, 4), ("pod", "model"))
    spec = PartitionSpec(("pod", "model"))
    fn = jax.shard_map(lambda x: jax_compressed_psum(x[0], "pod")[None],
                       mesh=mesh, in_specs=spec, out_specs=spec,
                       check_vma=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(g)))
    got = world["compressed"]
    np.testing.assert_array_equal(got, want)
    exact = g.reshape(2, 4, -1).sum(0)
    quantum = np.abs(g.reshape(2, 4, -1)).max(axis=(0, 2)) / 127.0
    for r in range(NRANKS):
        err = np.abs(got[r] - exact[r % 4]).max()
        assert err <= 2 * 0.5 * quantum[r % 4] * 1.0001


def _quantized_hold(jax_m, lr):
    """A hold for the compressed step.  The int8 reduction rounds each
    gradient element to a quantum of its leaf's pod scale, q = max|g| /
    127, so a gradient that two summation orders put either side of a
    rounding midpoint moves by one quantum: all but 0.1 % of the elements
    are held at ``tol``, the rest within the moment's change for one
    quantum (m = 0.1 g, v = 0.05 g^2; g from the reference's m) or, for
    the params, two of the step's learning rates ``lr`` (Adam's first step
    moves each element by lr times the sign of its gradient)."""
    def hold(got, want, tol, name):
        off = n = 0
        for a, b, m in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                           jax.tree.leaves(jax_m)):
            assert a.shape == b.shape
            g = 10.0 * np.abs(m)
            q = 2.0 * g.max() / 127.0           # a quantum, twice over
            bound = {"m": 0.1 * q, "v": 0.05 * (2 * g * q + q * q),
                     "params": 2 * lr * 1.01}[name]
            d = np.abs(a - b)
            bad = d > tol[0] + tol[1] * np.abs(b)
            assert (d <= np.broadcast_to(bound, d.shape) + tol[0])[bad].all(), \
                (name, float(d.max()))
            off += int(bad.sum())
            n += a.size
        assert off <= 1e-3 * n, (name, off, n)
    return hold


def test_compress_pod_train_step_equals_reference(world):
    c = _cases()["pod"]
    b = c["batches"][0]
    assert world["pod"]["mesh"] == dict(pod=2, data=1, stage=2, tensor=2,
                                        replica=1)
    jax_out = jax_train("qwen1.5-0.5b", c["plan"], c["params"], b, c["opt"],
                        mesh_shape=POD_MESH, compress_pod=True)
    hold_train(world["pod"], jax_out,
               *single_device("qwen1.5-0.5b", c["params"], b), NRANKS, TOL,
               hold=_quantized_hold(jax_out[2], jax_out[0]["lr"]),
               # the int8 rounding moves the norm: 8.0012 in the reference
               world_rtol=1e-3)


def test_elastic_mesh_equals_reference(world):
    for call, got in zip(ELASTIC, world["elastic"]):
        try:
            m = jax_elastic_mesh(*call)
        except ValueError as e:
            assert got == ("ValueError", str(e)), call
            continue
        shape, names, coords = got
        assert (shape, names) == (m.devices.shape, m.axis_names), call
        assert coords == (0,) * len(shape)     # rank 0, on every mesh


def test_collectives_and_their_transposes_equal_reference(world):
    """psum, a tiled all_gather, psum_scatter, ppermute and the
    stop-gradient pmax over (data 2, model 4): a psummed scalar of their
    outputs and its gradient at every rank equal the reference's
    (``jax.grad`` inside ``shard_map(check_vma=False)``, where a psum's
    transpose is a psum); axis_index; make_production_mesh refusing a
    world of 8; and FSDP's fp8 gather of a bf16 leaf."""
    from jax import lax

    from repro.parallel.pipeline import _pmax_sg
    c = _comm_inputs()
    x, w = jnp.asarray(c["x"]), jnp.asarray(c["w"])
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    spec = PartitionSpec(("data", "model"))

    def body(xl):
        def total(xl):
            a = lax.psum(xl, "model")
            b = lax.all_gather(xl, "model", axis=1, tiled=True)
            s = lax.psum_scatter(b * w[4], "model",
                                 scatter_dimension=1, tiled=True)
            d = lax.ppermute(xl, "model", [(i, (i + 1) % 4)
                                           for i in range(4)])
            m = _pmax_sg(xl, "data")
            local = ((a * w[0][:, :6]).sum() + (b * w[1]).sum()
                     + (s * w[2][:, :6]).sum() + (d * w[3][:, :6]).sum()
                     + (m * xl).sum())
            return lax.psum(local, ("data", "model"))
        t, g = jax.value_and_grad(total)(xl)
        return t[None], g

    t, g = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=spec,
                                 out_specs=(spec, spec), check_vma=False))(x)
    got = world["comm"]
    np.testing.assert_allclose(got["total"], np.asarray(t)[0], rtol=1e-5)
    np.testing.assert_allclose(got["grad"], np.asarray(g), rtol=1e-5,
                               atol=1e-5)
    assert got["index"] == (0, 0, 0)
    assert "needs 256 ranks" in got["production"]
    # fsdp_fp8_gather: rank 0's rows along "data" (ranks 0 and 4), each
    # cast to float8_e4m3fn and back, as the reference's fsdp_gather does
    rows = torch.from_numpy(c["x"][[0, 4]]).to(torch.bfloat16)
    want = rows.to(torch.float8_e4m3fn).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got["fp8"], want)
