"""FlexPipeController: composes the paper's three components (§4).

  1. Fine-grained partitioning (core/partitioner.py) builds the candidate
     partitions once per model.
  2. Inflight refactoring (core/refactoring.py) picks the live granularity
     from real-time CV.
  3. Adaptive scaling (core/scaling.py + hrg + affinity) reacts to queue
     pressure with topology-aware, warm-start instance placement.

Ports ``repro/core/controller.py``.  The engine (serving/engine.py) calls
``on_request`` for every submitted request and ``control_step`` every
``control_interval`` of simulated time.  The graph is timed on the H100's
roofline and the memory cap is its HBM.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.core.affinity import AffinityScheduler, HostParamCache
from repro_torch.core.granularity import GranularityProfile
from repro_torch.core.graph import build_graph
from repro_torch.core.hrg import HierarchicalResourceGraph
from repro_torch.core.partitioner import Partition, candidate_partitions
from repro_torch.core.refactoring import RefactoringController, plan_migration
from repro_torch.core.scaling import ScalingDecision, decide_scale_up
from repro_torch.launch.roofline import H100_SXM


@dataclass
class ControllerConfig:
    stage_counts: tuple[int, ...] = (2, 4, 8, 16)
    alpha: float = 0.5              # Eq. 4 throughput/latency weight
    sigma: float = 1.0              # Eq. 4 CV-affinity sensitivity
    mem_cap: float = H100_SXM.hbm_bytes
    slo_deadline: float = 2.0
    g_max: int = 32


class FlexPipeController:
    def __init__(self, cfg: ModelConfig,
                 profiles: list[GranularityProfile],
                 ctl: ControllerConfig = ControllerConfig()):
        self.cfg = cfg
        self.ctl = ctl
        self.nodes = build_graph(cfg)
        self.partitions: dict[int, Partition] = candidate_partitions(
            self.nodes, [s for s in ctl.stage_counts
                         if cfg.n_patterns % s == 0 or s <= cfg.n_patterns],
            mem_cap=ctl.mem_cap)
        self.refactor = RefactoringController(
            profiles, alpha=ctl.alpha, sigma=ctl.sigma)
        self.hrg = HierarchicalResourceGraph()
        self.affinity = AffinityScheduler()
        self.host_cache = HostParamCache()

    # -- data-plane hooks -----------------------------------------------
    def on_request(self, t: float) -> None:
        self.refactor.record_arrival(t)

    def control_step(self, now: float, queue_len: float,
                     saturation: float = 0.0):
        """One Alg. 1 iteration; returns (decision, migration|None).

        ``saturation`` is the admission queue's overload signal
        (serving/admission.py): it biases granularity selection toward
        deeper pipelines so refactoring and load shedding compose."""
        d = self.refactor.step(now, queue_len, saturation=saturation)
        mig = None
        if d.changed and len(self.partitions) >= 2:
            old_s = self.refactor.history[-2][1] if len(
                self.refactor.history) >= 2 else d.target.stages
            new_s = d.target.stages
            if old_s in self.partitions and new_s in self.partitions:
                ob = self.partitions[old_s].layer_boundaries(self.nodes)
                nb = self.partitions[new_s].layer_boundaries(self.nodes)
                per_layer_p = sum(n.s_p for n in self.nodes) / self.cfg.n_layers
                # the reference's flat 2 MB of cache per layer, kept as it
                # is so the migration estimate matches the reference's
                mig = plan_migration(
                    ob, nb, self.cfg.n_layers,
                    cache_bytes_per_layer=2e6,
                    param_bytes_per_layer=per_layer_p)
        return d, mig

    def scale_decision(self, now: float, queue_len: float,
                       required_rate: float,
                       stage_throughput: float = 100.0) -> ScalingDecision:
        cv = self.refactor.monitor.estimate(now).cv
        return decide_scale_up(
            cv=cv, queue_len=queue_len, deadline=self.ctl.slo_deadline,
            init_time_per_stage=0.3, stage_throughput=stage_throughput,
            required_rate=required_rate, g_max=self.ctl.g_max)

    def place_instance(self, model: str, servers: dict[str, int],
                       now: float) -> str:
        """Affinity (Eq. 13) then HRG tiebreak on contention."""
        s = self.affinity.select(model, servers, now)
        if self.hrg.servers:
            cands = [x for x in servers
                     if x in self.hrg.servers] or [s]
            s2 = self.hrg.least_contended(cands, now)
            # prefer affinity unless its path is badly contended
            if (s in self.hrg.servers and
                    self.hrg.path_pressure(s, now)
                    > 2 * self.hrg.path_pressure(s2, now)):
                s = s2
        self.affinity.record_placement(model, s, now)
        return s
