"""repro_torch's rwkv6 engine under FlexPipeController against the JAX
engine on examples/quickstart.py's setup: the recurrent state regroups
across the controller's refactor, and control steps, refactors, streams
and statistics equal the reference's (see test_torch_controller.py)."""
import pytest

from controller_parity import assert_same_run, run_jax, run_port


@pytest.fixture(scope="module")
def jax_run():
    return run_jax("rwkv6 dense")


def test_rwkv_controller_run_equals_reference(jax_run):
    mine, _ = run_port("rwkv6 dense")
    assert_same_run(mine, jax_run)
    assert mine["completed"] == mine["n"]
