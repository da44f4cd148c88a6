"""repro_torch stands alone: it imports neither jax nor the JAX package.
The child interpreter imports every module, serves each model family's
smoke config, runs the cluster simulator and takes a train step with a
checkpoint round trip, with both blocked.

The import check runs in a fresh interpreter, since this test process has
already imported jax; a source scan backs it up."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"

_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax or repro now fails
sys.modules["repro"] = None
import torch
torch.set_num_threads(1)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
from repro_torch.configs.base import get_arch
from repro_torch.models.transformer import init_model
from repro_torch.serving.engine import (EngineConfig, FlexPipeEngine,
                                        KVCacheConfig)
from repro_torch.serving.workload import Request
cfg = get_arch("qwen1.5-0.5b").smoke_config
params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
for kv in (KVCacheConfig(), KVCacheConfig(paged=True, block_size=8)):
    eng = FlexPipeEngine(cfg, params, [0, 2],
                         EngineConfig(max_batch=2, max_seq=32, kv=kv),
                         device="cpu")
    reqs = [Request(rid=i, arrival=0.0, prompt_len=5 + i, max_new_tokens=3)
            for i in range(3)]
    assert eng.run(reqs).completed == 3
    assert all(len(r.output) == 3 for r in reqs)
from repro_torch.serving.admission import AdmissionConfig
from repro_torch.serving.engine import PrefillConfig
from repro_torch.serving.faults import (PREEMPT_STAGE, FaultEvent,
                                        FaultInjector, FaultPolicy,
                                        StageHealthMonitor)
from repro_torch.serving.workload import audit_requests
eng = FlexPipeEngine(cfg, params, [0, 2], EngineConfig(
    max_batch=2, max_seq=64, warm_profiles=(1, 2), snapshot_interval=2,
    prefill=PrefillConfig(chunk=16), admission=AdmissionConfig(
        max_queue_depth=8)), device="cpu")
eng.attach_faults(injector=FaultInjector.scripted(
    [FaultEvent(t=0.3, kind=PREEMPT_STAGE, stage=1)]),
    policy=FaultPolicy(timeout_s=60.0), monitor=StageHealthMonitor())
reqs = [Request(rid=i, arrival=0.0, prompt_len=20 + 7 * i, max_new_tokens=4,
                deadline_s=60.0) for i in range(3)]
assert eng.run(reqs).completed == 3
assert eng.stats.counters["prefill_chunks"] >= 4
assert eng.recovery_events[0]["new_traces"] == 0
assert audit_requests(reqs)[1] == []
cfg = get_arch("rwkv6-1.6b").smoke_config
params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
eng = FlexPipeEngine(cfg, params, [0, 2], EngineConfig(max_batch=2, max_seq=32),
                     device="cpu")
reqs = [Request(rid=i, arrival=0.0, prompt_len=5 + i, max_new_tokens=3)
        for i in range(3)]
assert eng.run(reqs).completed == 3
cfg = get_arch("gemma3-1b").smoke_config
params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
eng = FlexPipeEngine(cfg, params, [0, 7], EngineConfig(
    max_batch=2, max_seq=16, warm_profiles=(2, 4)), device="cpu")
reqs = [Request(rid=i, arrival=0.0, prompt_len=5 + 6 * i, max_new_tokens=6)
        for i in range(3)]
assert eng.run(reqs).completed == 3
assert eng.refactor([0, 4, 7, 10])["new_traces"] == 0
from repro_torch.serving.engine import balanced_boundaries
for arch, kv in (("deepseek-moe-16b", KVCacheConfig(paged=True, block_size=8,
                                                    paged_kernel=True)),
                 ("jamba-v0.1-52b", KVCacheConfig())):
    cfg = get_arch(arch).smoke_config
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = FlexPipeEngine(cfg, params, balanced_boundaries(cfg.n_layers, 2),
                         EngineConfig(max_batch=2, max_seq=32, kv=kv,
                                      warm_profiles=(2, 4)), device="cpu")
    reqs = [Request(rid=i, arrival=0.0, prompt_len=5 + 4 * i,
                    max_new_tokens=4) for i in range(3)]
    assert eng.run(reqs).completed == 3
    assert all(len(r.output) == 4 for r in reqs)
from repro_torch.core.controller import FlexPipeController
from repro_torch.core.granularity import GranularityProfile
from repro_torch.serving.workload import synth_requests
import numpy as np
cfg = get_arch("qwen1.5-0.5b").smoke_config
params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
profiles = [GranularityProfile(2, 8, 90, 0.4, 0.5),
            GranularityProfile(4, 16, 110, 0.6, 2.5)]
eng = FlexPipeEngine(cfg, params, [0, 2], EngineConfig(
    max_batch=4, max_seq=64, control_interval=0.5, warm_profiles=(2, 4)),
    device="cpu")
rng = np.random.default_rng(0)
reqs = synth_requests(rng, rate=4.0, cv=0.4, duration=2.0, prompt_mean=12,
                      decode_mean=4)
reqs += synth_requests(rng, rate=40.0, cv=5.0, duration=1.0, t0=2.0,
                       prompt_mean=12, decode_mean=4)
assert eng.run(reqs, controller=FlexPipeController(cfg, profiles)).completed \
    == len(reqs)
assert [len(ev["to"]) for ev in eng.refactor_events] == [4]
from repro_torch.launch.serve import attach_memories
for arch in ("llama-3.2-vision-11b", "whisper-tiny", "qwen1.5-110b",
             "deepseek-v2-236b"):
    cfg = get_arch(arch).smoke_config
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = FlexPipeEngine(cfg, params, balanced_boundaries(cfg.n_layers, 2),
                         EngineConfig(max_batch=2, max_seq=32,
                                      warm_profiles=(1, 2)), device="cpu")
    reqs = [Request(rid=i, arrival=0.0, prompt_len=5 + 4 * i,
                    max_new_tokens=4) for i in range(3)]
    attach_memories(cfg, params, reqs, 32, np.random.default_rng(0))
    assert eng.run(reqs).completed == 3
for mod in ("qwen1_5_110b", "llama3_2_vision_11b", "whisper_tiny",
            "deepseek_v2_236b"):
    assert f"repro_torch.configs.{mod}" in sys.modules, mod
import copy
from repro_torch.serving.cluster import FragmentedCluster
from repro_torch.serving.simulator import POLICIES, ClusterSim
from repro_torch.serving.workload import Phase, phased_trace
reqs = phased_trace(np.random.default_rng(0), [Phase(10, 10, 0.5),
                                               Phase(10, 40, 3.0)],
                    deadline_s=4.0)
for name in ("flexpipe", "alpaserve"):
    out = ClusterSim(POLICIES[name], FragmentedCluster.synth(seed=1),
                     np.random.default_rng(2), slo=4.0).run(
                         copy.deepcopy(reqs))
    assert out["completed"] == len(reqs), (name, out["completed"])
for mod in ("cluster", "simulator"):
    assert f"repro_torch.serving.{mod}" in sys.modules, mod
import tempfile
from repro_torch.configs.base import PipelinePlan, ShapeConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.model import loss_fn
from repro_torch.parallel.pipeline import build_train_step, stack_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
cfg = get_arch("qwen1.5-0.5b").smoke_config
plan = PipelinePlan(microbatches=2)
flat = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
params = stack_params(cfg, plan, flat)
opt = init_opt_state(params)
step, _ = build_train_step(cfg, plan, None, ShapeConfig("t", 16, 4, "train"),
                           AdamWConfig(), param_dtype=torch.float32)
b = {k: torch.from_numpy(v) for k, v in
     TokenPipeline(DataConfig(cfg.vocab_size, 16, 4)).batch(0).items()}
ref, _ = loss_fn(cfg, flat, b, aux_weight=0.0)
params, opt, m = step(params, opt, b)
assert abs(float(m["loss"]) - float(ref)) < 1e-5 * float(ref)
with tempfile.TemporaryDirectory() as d:
    ckpt.save(d, (params, opt), step=1)
    (p2, o2), s, _ = ckpt.restore(d, (params, opt))
    assert s == 1 and int(o2.step) == 1
for mod in ("tree", "parallel.pipeline", "parallel.comm",
            "parallel.sharding", "launch.mesh", "training.optimizer",
            "training.checkpoint", "training.compression",
            "training.fault_tolerance", "data.pipeline", "launch.train",
            "launch.train_pipeline"):
    assert f"repro_torch.{mod}" in sys.modules, mod
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("MODULES", len(names))
"""


def test_package_imports_and_serves_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", _CHILD], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split("MODULES")[1])
    assert n >= 45


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    return mods


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_and_no_repro(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path} imports {sorted(bad)}"
