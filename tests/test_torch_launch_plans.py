"""repro_torch's whole-step roofline, the archs' default plans, the meta
dry run and the plan hillclimb, against the JAX package.

- ``step_costs`` and ``hbm_footprint`` equal the reference's at rel 1e-12
  under the reference's constants (``REF_CHIP``, 2 bytes an element, a
  16 x 16 mesh, and 2 x 16 x 16), for every arch x shape x default plan and
  every hillclimb variant;
- ``default_plans`` and ``skip_shapes`` equal the reference's for all ten
  archs;
- the device-independent part of tests/test_roofline.py (bubble and
  microbatches, fp8 KV, useful ratio, MLA's cache);
- the meta dry run's census of collectives equals what a real gloo world
  of CPU ranks issues for the same plans on qwen's smoke config;
- ``hillclimb.evaluate(..., compile_check=False)`` equals the reference's.

``repro.launch.dryrun`` and ``repro.launch.hillclimb`` set XLA_FLAGS to
512 host devices when imported, which would change every later JAX test in
the worker: their numbers come from a ``python -c`` subprocess, and only
``repro.launch.roofline`` is imported here."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import PipelinePlan as JaxPlan
from repro.configs.base import get_arch as jax_arch
from repro.launch import roofline as R
from repro.models import transformer as JT
from repro_torch.configs.base import (SHAPES, PipelinePlan, ShapeConfig,
                                      get_arch, list_archs)
from repro_torch.launch import hillclimb
from repro_torch.launch.mesh import run_world
from repro_torch.launch.roofline import Chip, hbm_footprint, step_costs

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# the reference's constants as a Chip (its one peak serves both dtypes);
# hbm_footprint's key is then the reference's fits_16gb
REF_CHIP = Chip(hbm_bw=R.HBM_BW, flops_f32=R.PEAK_FLOPS,
                flops_bf16=R.PEAK_FLOPS, link_bw=R.ICI_BW, host_bw=R.DCN_BW,
                hbm_bytes=16 * 1024**3, name="16gb")
REL = 1e-12
# the reference's keys for the port's
KEYS = {"link_bytes": "ici_bytes", "host_bytes": "dcn_bytes"}
ARCHS = list_archs()


@pytest.fixture(scope="module", autouse=True)
def _memo_reference_counts():
    """The reference's ``layer_param_bytes`` and ``count_params`` trace the
    init with ``jax.eval_shape`` on every call (a whole model's for each
    step's param counts): remember each answer."""
    seen = {}
    orig_bytes, orig_count = R.layer_param_bytes, JT.count_params

    def memo(fn):
        def call(cfg, *args, **kw):
            key = (fn, id(cfg), args, tuple(sorted(kw.items())))
            if key not in seen:
                seen[key] = fn(cfg, *args, **kw)
            return seen[key]
        return call
    R.layer_param_bytes = memo(orig_bytes)
    JT.count_params = memo(orig_count)
    yield
    R.layer_param_bytes, JT.count_params = orig_bytes, orig_count


def _jplan(plan: PipelinePlan) -> JaxPlan:
    return JaxPlan(**dataclasses.asdict(plan))


def _same(mine: dict, ref: dict, what):
    assert {KEYS.get(k, k) for k in mine} == set(ref), what
    for k, v in mine.items():
        want = ref[KEYS.get(k, k)]
        if isinstance(v, (bool, str)):
            assert v == want, (what, k)
        else:
            assert v == pytest.approx(want, rel=REL, abs=0), (what, k)


def _hold(arch, shape_name, plan, pod):
    cfg, jcfg = get_arch(arch).config, jax_arch(arch).config
    mine = step_costs(cfg, SHAPES[shape_name], plan, pod=pod, data=16,
                      chip=REF_CHIP, bytes_per_el=R.BYTES)
    ref = R.step_costs(jcfg, JSHAPES[shape_name], _jplan(plan), pod=pod,
                       data=16)
    _same(mine, ref, (arch, shape_name, plan, pod))
    mine = hbm_footprint(cfg, SHAPES[shape_name], plan, pod=pod, data=16,
                         chip=REF_CHIP, bytes_per_el=R.BYTES)
    ref = R.hbm_footprint(jcfg, JSHAPES[shape_name], _jplan(plan), pod=pod,
                          data=16)
    _same(mine, ref, (arch, shape_name, plan, pod))


@pytest.mark.parametrize("arch", ARCHS)
def test_default_plans_and_skip_shapes_equal_reference(arch):
    spec, jspec = get_arch(arch), jax_arch(arch)
    assert spec.skip_shapes == jspec.skip_shapes
    assert set(spec.default_plans) == set(jspec.default_plans) == set(SHAPES)
    for name, plan in spec.default_plans.items():
        assert dataclasses.asdict(plan) == dataclasses.asdict(
            jspec.plan_for(name)), name
        assert spec.plan_for(name) is plan
        plan.validate(spec.config, 16)


@pytest.mark.parametrize("pod", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_costs_and_footprint_equal_reference(arch, pod):
    """Every shape at the arch's default plan, on one pod and on two."""
    for shape_name, plan in get_arch(arch).default_plans.items():
        _hold(arch, shape_name, plan, pod)


@pytest.mark.parametrize("cell", list(hillclimb.CELLS))
def test_step_costs_of_hillclimb_variants_equal_reference(cell):
    arch, shape_name, variants = hillclimb.CELLS[cell]
    for _, plan in variants:
        _hold(arch, shape_name, plan, 1)


def test_h100_constants_and_byte_scaling():
    """On the H100 the roofline takes the element size's peak, and the
    byte terms scale with bytes_per_el; fits_<name> names the card."""
    cfg = get_arch("qwen1.5-0.5b").config
    shape = SHAPES["decode_32k"]
    plan = get_arch("qwen1.5-0.5b").plan_for("decode_32k")
    r4 = step_costs(cfg, shape, plan)
    r2 = step_costs(cfg, shape, plan, bytes_per_el=2)
    assert r4["flops"] == r2["flops"]
    assert r4["hbm_bytes"] == pytest.approx(2 * r2["hbm_bytes"], rel=REL)
    assert r4["compute_s"] == pytest.approx(r4["flops"] / 67e12, rel=REL)
    assert r2["compute_s"] == pytest.approx(r2["flops"] / 989e12, rel=REL)
    h = hbm_footprint(cfg, shape, plan)
    assert h["fits_h100_sxm_80gb"] is True


# ---------------------------------------------------------------------------
# tests/test_roofline.py's device-independent checks, on the port
# ---------------------------------------------------------------------------

def test_step_costs_scale_with_stages():
    """More microbatches shrink the bubble and the compute term (less
    bubble garbage)."""
    cfg = get_arch("qwen1.5-110b").config
    shape = SHAPES["prefill_32k"]
    r1 = step_costs(cfg, shape, PipelinePlan(stages=4, tensor=4, replica=1,
                                             microbatches=1))
    r2 = step_costs(cfg, shape, PipelinePlan(stages=4, tensor=4, replica=1,
                                             microbatches=2))
    assert r2["bubble_fraction"] < r1["bubble_fraction"]
    assert r2["compute_s"] < r1["compute_s"]


def test_fp8_kv_halves_decode_memory_term():
    cfg = get_arch("qwen1.5-110b").config
    shape = SHAPES["decode_32k"]
    base = PipelinePlan(stages=2, tensor=8, replica=1, microbatches=8)
    fp8 = dataclasses.replace(base, kv_dtype="fp8")
    assert hbm_footprint(cfg, shape, fp8)["cache_gb"] == pytest.approx(
        hbm_footprint(cfg, shape, base)["cache_gb"] / 2)
    # the decode step's HBM bytes are the cache reads plus params and
    # activations; fp8 halves the cache reads only
    b, f = step_costs(cfg, shape, base), step_costs(cfg, shape, fp8)
    assert f["hbm_bytes"] < b["hbm_bytes"]
    assert f["flops"] == b["flops"]


def test_model_flops_useful_ratio_bounds():
    """0 < model FLOPs / counted FLOPs <= 1.2 for every non-skipped
    single-pod cell."""
    for arch in ARCHS:
        spec = get_arch(arch)
        for shape_name, plan in spec.default_plans.items():
            if shape_name in spec.skip_shapes:
                continue
            r = step_costs(spec.config, SHAPES[shape_name], plan)
            assert 0.0 < r["useful_ratio"] <= 1.2, (arch, shape_name)


def test_mla_cache_compression():
    """MLA's latent cache is over 50x smaller than materialized 128-head
    K/V, and deepseek-v2-236b's cache is smaller than qwen1.5-110b's."""
    plan = PipelinePlan()
    shape = ShapeConfig("one", 32768, 1, "decode")
    d = hbm_footprint(get_arch("deepseek-v2-236b").config, shape, plan,
                      data=1, bytes_per_el=2)["cache_gb"] * 1024**3
    q = hbm_footprint(get_arch("qwen1.5-110b").config, shape, plan,
                      data=1, bytes_per_el=2)["cache_gb"] * 1024**3
    full_heads = 60 * 2 * 128 * 128 * 32768 * 2
    assert full_heads / d > 50
    assert d < q


# ---------------------------------------------------------------------------
# the meta dry run against a real world
# ---------------------------------------------------------------------------

MESH = (2, 4)                       # (data, model): 8 ranks


def _census_cases():
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    return [
        (cfg, ShapeConfig("t", 16, 8, "train"),
         PipelinePlan(stages=2, tensor=2, replica=1, microbatches=2)),
        (cfg, ShapeConfig("t", 16, 8, "train"),
         PipelinePlan(stages=2, tensor=1, replica=2, microbatches=2,
                      fsdp=True)),
        (cfg, ShapeConfig("p", 16, 8, "prefill"),
         PipelinePlan(stages=2, tensor=2, replica=1, microbatches=2)),
        (cfg, ShapeConfig("d", 16, 8, "decode"),
         PipelinePlan(stages=4, tensor=1, replica=1, microbatches=2)),
    ]


def _meta_census(rank: int) -> list:
    """The dry run's census at ``rank`` of a fake world of 8, in a fresh
    interpreter (the fake process group stays out of this one)."""
    code = ("import json, sys; sys.path.insert(0, 'tests');"
            "import torch; from repro_torch.launch import dryrun;"
            "from test_torch_launch_plans import _census_cases, MESH;"
            f"r = {rank};"
            "ctx = dryrun.fake_world(8, r);"
            "ctx.__enter__();"
            "out = dryrun.census_rank(r, 8, 'meta', _census_cases(), MESH);"
            "print('CENSUS' + json.dumps(out))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.split("CENSUS")[1])


def test_meta_census_equals_a_gloo_world():
    """Train (tensor parallel; FSDP over replicas), prefill and decode on a
    (2, 4) mesh: every rank of a real gloo world of 8 CPU ranks issues the
    collectives, by op, count and bytes, that the meta dry run counts at
    that rank, and holds the same bytes of params, moments, caches and
    inputs."""
    from repro_torch.launch import dryrun
    world = run_world(dryrun.census_rank, 8,
                      (_census_cases(), MESH), backend="gloo",
                      device="cpu", threads=1)
    for rank in (0, 5):
        meta = _meta_census(rank)
        for case, got, want in zip(_census_cases(), world[rank], meta):
            what = (rank, case[1].kind, case[2])
            assert got["collectives"]["counts"] == \
                want["collectives"]["counts"], what
            assert got["collectives"]["bytes"] == \
                want["collectives"]["bytes"], what
            assert got["memory"] == want["memory"], what
            assert got["collectives"]["total"] > 0, what


# ---------------------------------------------------------------------------
# hillclimb
# ---------------------------------------------------------------------------

def _reference_hillclimb() -> list:
    code = "\n".join([
        "import dataclasses, json",
        "from repro.launch import hillclimb as H",
        "from repro.models import transformer as T",
        "seen, count = {}, T.count_params",     # each model traced once
        "def memo(cfg, active_only=False):",
        "    key = (id(cfg), active_only)",
        "    if key not in seen:",
        "        seen[key] = count(cfg, active_only)",
        "    return seen[key]",
        "T.count_params = memo",
        "out = [dict(cell=c, label=l, plan=dataclasses.asdict(p),",
        "            rec=H.evaluate(a, s, l, p, compile_check=False))",
        "       for c, (a, s, v) in H.CELLS.items() for l, p in v]",
        "print('HILL' + json.dumps(out))"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.split("HILL")[1])


def test_hillclimb_equals_reference():
    """The same cells, labels and plans as the reference's hillclimb, and
    under its constants the same roofline, footprint and effective_s."""
    ref = _reference_hillclimb()
    mine = [(c, label, plan) for c, (_, _, v) in hillclimb.CELLS.items()
            for label, plan in v]
    assert [(c, label, dataclasses.asdict(p)) for c, label, p in mine] == \
        [(r["cell"], r["label"], r["plan"]) for r in ref]
    for (cell, label, plan), r in zip(mine, ref):
        arch, shape_name, _ = hillclimb.CELLS[cell]
        rec = hillclimb.evaluate(arch, shape_name, label, plan,
                                 compile_check=False, chip=REF_CHIP,
                                 bytes_per_el=R.BYTES)
        assert "compiled" not in rec
        assert rec["effective_s"] == pytest.approx(
            r["rec"]["effective_s"], rel=REL, abs=0), label
        _same(rec["roofline"], r["rec"]["roofline"], label)
        _same(rec["hbm"], r["rec"]["hbm"], label)


def test_hillclimb_compile_check_runs_the_meta_dry_run():
    """With compile_check the variant's step runs on meta tensors in a
    fake world of 256 (in a fresh interpreter), and records its
    collectives."""
    code = ("import json; from repro_torch.launch import hillclimb as H;"
            "a, s, v = H.CELLS['qwen110b_decode'];"
            "rec = H.evaluate(a, s, *v[4]);"
            "print('REC' + json.dumps(rec))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.split("REC")[1])
    assert rec["compiled"] is True and rec["plan"]["kv_dtype"] == "fp8"
    assert rec["collectives"]["counts"]["all_reduce"] > 0


def test_dry_run_cell_records_a_step_the_card_refuses():
    """A cell whose step calls a kernel the card refuses (decode at
    G = H / Kh = 16 over the kernel's 8) records status=error with the
    wrapper's reason, and the same cell at qwen's own G = 1 records ok: the
    meta route checks what the CUDA route checks (in a fresh interpreter,
    in a fake world of 256)."""
    code = "\n".join([
        "import dataclasses, json",
        "from repro_torch.configs.base import PipelinePlan",
        "from repro_torch.launch import dryrun",
        "spec = dryrun.get_arch('qwen1.5-0.5b')",
        "g16 = dataclasses.replace(spec, config=dataclasses.replace(",
        "    spec.config, n_kv_heads=1))",
        "plan = PipelinePlan(stages=4, tensor=1, replica=4, microbatches=2)",
        "out = {}",
        "with dryrun.fake_world(256):",
        "    for name, s in (('g1', spec), ('g16', g16)):",
        "        dryrun.get_arch = lambda arch, s=s: s",
        "        out[name] = dryrun.run_cell('qwen1.5-0.5b', 'decode_32k',",
        "                                    False, plan=plan, verbose=False)",
        "print('CELLS' + json.dumps({k: {'status': v['status'],",
        "                                'error': v.get('error', '')}",
        "                            for k, v in out.items()}))"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    cells = json.loads(res.stdout.split("CELLS")[1])
    assert cells["g1"] == {"status": "ok", "error": ""}
    assert cells["g16"]["status"] == "error"
    assert "H / Kh <= 8" in cells["g16"]["error"], cells["g16"]
