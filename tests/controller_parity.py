"""Shared setup of the controller parity tests (test_torch_controller*.py,
and test_torch_cuda.py's controller cases): the quickstart's profiles,
trace and EngineConfig, run through the JAX engine and the port's on the
same params, reduced to what both must agree on.  JAX is imported only by
the functions that run it, so the card's tests can use the rest."""
import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.controller import FlexPipeController
from repro_torch.core.granularity import GranularityProfile
from repro_torch.kernels import build
from repro_torch.serving import admission as TA
from repro_torch.serving import engine as TE
from repro_torch.serving.workload import audit_requests, synth_requests

# examples/quickstart.py's two granularity profiles and engine settings
PROFILES = ((2, 8, 90, 0.4, 0.5), (4, 16, 110, 0.6, 2.5))
ECFG = dict(max_batch=4, max_seq=96, control_interval=0.5,
            warm_profiles=(2, 4))
CASES = {
    "qwen dense": ("qwen1.5-0.5b", {}, None),
    "qwen paged kernel": ("qwen1.5-0.5b",
                          dict(paged=True, block_size=16, paged_kernel=True),
                          None),
    "qwen admission": ("qwen1.5-0.5b", {}, dict(max_queue_depth=4)),
    "rwkv6 dense": ("rwkv6-1.6b", {}, None),
}


class Recorder:
    """Passes the engine's calls to a controller and logs every control
    step (the decision latency score_s is a host clock, so it is left
    out)."""

    def __init__(self, inner):
        self.inner = inner
        self.steps = []

    def on_request(self, t):
        self.inner.on_request(t)

    def control_step(self, now, queue_len, saturation=0.0):
        d, mig = self.inner.control_step(now, queue_len,
                                         saturation=saturation)
        self.steps.append((now, queue_len, saturation, d.target.stages,
                           d.changed, d.reason))
        return d, mig


def quickstart_requests(synth):
    """examples/quickstart.py's trace: a calm phase, then a burst."""
    rng = np.random.default_rng(0)
    reqs = synth(rng, rate=4.0, cv=0.4, duration=4.0, prompt_mean=24,
                 decode_mean=8)
    reqs += synth(rng, rate=40.0, cv=5.0, duration=3.0, t0=4.0,
                  prompt_mean=24, decode_mean=8)
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


def record_outputs(eng) -> dict:
    """Record each slot's tokens when its request leaves it (the reference
    engine keeps no per-request output)."""
    out: dict = {}
    base = type(eng.slots[0])

    class Recording(base):
        def __setattr__(self, k, v):
            if k == "request" and v is None and \
                    getattr(self, "request", None) is not None:
                out[self.request.rid] = list(self.generated)
            super().__setattr__(k, v)

    eng.slots = [Recording() for _ in eng.slots]
    return out


def _summary(eng, reqs, stats, rec, audit, streams):
    return {
        "steps": rec.steps if rec else None,
        "events": [{k: v for k, v in ev.items() if k != "t"}
                   for ev in eng.refactor_events],
        "streams": streams,
        "states": {r.rid: (r.terminal_state, r.first_token, r.finish,
                           r.degraded) for r in reqs},
        "completed": stats.completed,
        "latency": stats.latency_percentiles(),
        "queue": stats.queue_samples,
        "audit": audit(reqs),
        "n": len(reqs),
    }


def jax_params(arch):
    import jax
    from repro.configs.base import get_arch as jax_arch
    from repro.models.transformer import init_model as jax_init_model
    cfg = jax_arch(arch).smoke_config
    return cfg, jax_init_model(jax.random.PRNGKey(0), cfg)


def run_jax(case):
    from repro.core.controller import FlexPipeController as JaxController
    from repro.core.granularity import GranularityProfile as JaxProfile
    from repro.serving import admission as JA
    from repro.serving import engine as JE
    from repro.serving.workload import audit_requests as jax_audit
    from repro.serving.workload import synth_requests as jax_synth
    torch.set_num_threads(2)
    arch, kv, adm = CASES[case]
    cfg, params = jax_params(arch)
    eng = JE.FlexPipeEngine(cfg, params, [0, 2], JE.EngineConfig(
        **ECFG, kv=JE.KVCacheConfig(**kv),
        admission=JA.AdmissionConfig(**adm) if adm else None))
    rec = Recorder(JaxController(cfg, [JaxProfile(*p) for p in PROFILES]))
    reqs = quickstart_requests(jax_synth)
    streams = record_outputs(eng)
    stats = eng.run(reqs, controller=rec, time_per_tick=0.05)
    return _summary(eng, reqs, stats, rec, jax_audit, streams)


def run_port(case, params=None, device="cpu", controller=True):
    """The port's run of ``case``, under the controller or with none;
    ``params`` defaults to the JAX init's, converted.  Returns the summary
    (with the kernel launches of the run) and the engine."""
    arch, kv, adm = CASES[case]
    cfg = get_arch(arch).smoke_config
    if device == "cpu":
        torch.set_num_threads(2)
    if params is None:
        import jax
        from repro_torch.convert import params_from_numpy
        params = params_from_numpy(
            jax.tree.map(np.asarray, jax_params(arch)[1]), device)
    eng = TE.FlexPipeEngine(cfg, params, [0, 2], TE.EngineConfig(
        **ECFG, kv=TE.KVCacheConfig(**kv),
        admission=TA.AdmissionConfig(**adm) if adm else None),
        device=device)
    builds = eng.executors.builds
    rec = Recorder(FlexPipeController(
        cfg, [GranularityProfile(*p) for p in PROFILES])) \
        if controller else None
    reqs = quickstart_requests(synth_requests)
    streams = record_outputs(eng)
    build.reset_launches()
    stats = eng.run(reqs, controller=rec, time_per_tick=0.05)
    launches = dict(build.launches)
    assert all(r.output == streams[r.rid] for r in reqs if r.finish >= 0)
    out = _summary(eng, reqs, stats, rec, audit_requests, streams)
    out["launches"] = launches
    # programs built during the run: none where prompts are bucketed (an
    # unbucketed model's stage prefills are not warmed, as in the
    # reference: they are built at first use)
    out["builds_after_warmup"] = eng.executors.builds - builds
    out["bucketed"] = eng.executors.can_bucket
    return out, eng


def assert_same_run(mine, ref):
    """The port's run equals the reference's in every decision, refactor,
    stream, terminal state and statistic."""
    assert mine["steps"] == ref["steps"]
    assert mine["events"] == ref["events"]
    assert mine["streams"] == ref["streams"]
    assert mine["states"] == ref["states"]
    assert mine["completed"] == ref["completed"]
    assert mine["latency"] == ref["latency"]
    assert mine["queue"] == ref["queue"]
    assert mine["audit"] == ref["audit"]
    assert mine["audit"][1] == []               # one terminal state each
    assert len(mine["events"]) >= 1             # the controller refactored
    assert all(ev["compile_cache_hit"] and ev["new_traces"] == 0
               for ev in mine["events"])
    if mine["bucketed"]:
        assert mine["builds_after_warmup"] == 0
