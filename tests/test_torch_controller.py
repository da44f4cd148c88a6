"""repro_torch's engine under FlexPipeController against the JAX engine on
examples/quickstart.py's setup (profiles, trace, EngineConfig): the same
control steps, refactors, greedy streams, terminal states and latency
percentiles, dense and with AdmissionConfig(max_queue_depth=4) feeding the
saturation signal.  Also drives the port's launchers (``launch/serve.py``,
``launch/quickstart.py``) on the CPU, and their refusal to run without
CUDA unless given ``--device cpu``.  The paged-kernel and rwkv6 cases are
in test_torch_controller_paged.py and test_torch_controller_rwkv.py."""
import pytest
import torch

from controller_parity import assert_same_run, run_jax, run_port
from repro_torch.launch import quickstart, serve

CASES = ("qwen dense", "qwen admission")


@pytest.fixture(scope="module")
def jax_runs():
    return {case: run_jax(case) for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_controller_run_equals_reference(jax_runs, case):
    mine, _ = run_port(case)
    ref = jax_runs[case]
    assert_same_run(mine, ref)
    if case == "qwen dense":
        assert mine["completed"] == mine["n"] == 81
        assert [(len(e["from"]), len(e["to"]), e["inflight"])
                for e in mine["events"]] == [(2, 4, 4)]
    else:
        # the bounded queue rejected part of the burst, and saturation
        # reached the controller
        assert mine["audit"][0]["rejected"] > 0
        assert any(sat > 0 for _, _, sat, *_ in mine["steps"])


def test_quickstart_main_on_cpu(jax_runs, capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    ref = jax_runs["qwen dense"]
    lat = ref["latency"]
    assert f"completed={ref['completed']} p50={lat['p50']:.2f}s " \
        f"p99={lat['p99']:.2f}s" in out
    assert "refactor events: 1" in out
    assert "stages 2 -> 4 (4 in-flight requests" in out
    assert "executor-cache hit=True" in out
    assert "launches={}" in out                 # plain versions on the CPU
    assert out.rstrip().endswith("OK")


@pytest.mark.parametrize("extra", [
    [], ["--paged", "--paged-kernel"], ["--admission-depth", "4"],
    ["--arch", "rwkv6-1.6b"]], ids=["dense", "paged-kernel", "admission",
                                    "rwkv6"])
def test_serve_main_on_cpu(extra, capsys):
    argv = ["--arch", "qwen1.5-0.5b", "--rate", "10", "--cv", "4",
            "--duration", "3", "--device", "cpu"] + extra
    serve.main(argv)
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith("completed="))
    fields = dict(kv.split("=") for kv in line.split())
    assert int(fields["refactors"]) >= 1
    assert ("serving 45 requests" in out) and int(fields["completed"]) > 0
    if "--admission-depth" in extra:
        assert "violations=0" in out
    else:
        assert fields["completed"] == "45"


@pytest.mark.parametrize("main,argv", [
    (quickstart.main, []),
    (serve.main, ["--arch", "qwen1.5-0.5b", "--duration", "1"])])
def test_launchers_need_cuda_unless_told_cpu(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
