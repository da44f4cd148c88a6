"""repro_torch's paged engine, decoding through the block-table-walk path,
under FlexPipeController against the JAX engine on examples/quickstart.py's
setup: the same control steps, refactors, streams and statistics, and the
streams equal the dense run's (see test_torch_controller.py)."""
import pytest

from controller_parity import assert_same_run, run_jax, run_port


@pytest.fixture(scope="module")
def jax_run():
    return run_jax("qwen paged kernel")


def test_paged_kernel_controller_run_equals_reference(jax_run):
    mine, eng = run_port("qwen paged kernel")
    assert_same_run(mine, jax_run)
    assert eng.block_stats()["used_blocks"] == 0
    dense, _ = run_port("qwen dense")
    assert mine["streams"] == dense["streams"]
    assert mine["steps"] == dense["steps"]
