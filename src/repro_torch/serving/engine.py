"""FlexPipe serving engine on PyTorch: the data plane with live refactoring.

Ports the dense and paged serving path of ``repro/serving/engine.py``, for
attention models (with dense or MoE MLPs) and, dense only, MLA models
(deepseek-v2's latent caches) and models with recurrent layers (RWKV-6, and Jamba's Mamba-1 and attention hybrid) or
cross attention (llama-3.2-vision, whisper's decoder).  The
model is cut into pipeline stages at ``boundaries``; a ``refactor()``
re-groups the stage boundaries between decode ticks without dropping a
request, and greedy streams across it are bit-identical to an
uninterrupted run.

Hot path: admission prefills a whole prompt stage by stage, writing its KV
rows in place into the slot (dense rows, or blocks through the slot's
table).  Attention prompts are padded to a pow2 bucket; prompts of models
with recurrent (Mamba, RWKV) layers run at their exact length, from a
zeroed slot state.  A decode tick is one fused program: embed, every
stage, lm_head and an argmax on the device; the only per-tick sync is the
copy of B int32 ids to the host (plus the first token of each prefill).
Caches are preallocated tensors written in place (JAX donates them).

A refactor only re-views the per-layer cache list under new stage
ownership (no device traffic) and swaps in the configuration's decode
program from the executor cache.  ``refactor()`` reports
``compile_cache_hit`` (the program existed and had run) and ``new_traces``
(programs built during the call).  In eager PyTorch every configuration's
program runs the same per-layer loop, so a refactor changes no code that
executes: it re-groups bookkeeping, and the refactor checks prove that slot
and cache state survive the re-grouping (see executor_cache.py).

Chunked prefill (``PrefillConfig(chunk>0)``) splits a prompt into pow2
chunks pumped round-robin under a per-tick token budget while decode slots
keep emitting; every chunk attends over the whole prompt's bucket, so the
streams equal whole-prompt prefill.  The fault path (``snapshot_interval``,
``attach_faults``) keeps an Eq. 10 snapshot in a twin of the live caches,
and on a lost stage zeroes its caches in place, refactors onto the
survivors, restores committed rows from the snapshot and replays only the
tokens decoded since.  Admission control (``EngineConfig(admission=...)``)
bounds the queue, orders it by priority and deadline, sheds infeasible
work and browns out budgets under sustained saturation.

``run(controller=FlexPipeController(...))`` hands every arrival to the
controller and runs one Algorithm 1 step every ``control_interval`` of
simulated time; a changed granularity refactors to balanced boundaries for
its stage count, as the reference does (the controller's partitions are
not used; ROADMAP.md, section 3, known quirks of the reference).

Sliding-window models (gemma3) are served dense: local layers keep ring
caches of ``min(max_seq, window)`` rows, prompts prefill at their exact
length (a bucket's padding would land in the ring), and the paged and
chunked paths fall back as the reference's do.

A request may carry a cross-attention ``memory`` (1, M, d), a tensor or a
numpy array, as the reference's does: the whole-prompt prefill projects
it into the slot's cross caches, and decode reads them.  It moves to the
engine's device once, at its first admission, and stays on the request,
so a re-admission after preemption reuses it.  A request without one
reads zeroed cross caches, as in the reference.

Not ported and raising ``NotImplementedError``: the fault path for
recurrent (Mamba, RWKV), sliding-window and cross-attention models, whose
reference results are wrong (ROADMAP.md, section 3).  MoE models keep it, and replay as the
reference does: a tick's rows compete for expert capacity, so a stream can
depend on the batch it shares (ROADMAP.md, section 3).  MLA models keep it
too: their latent rows are positional like k/v rows, so the Eq. 10 merge
and the decode replay rebuild them exactly.

The reference's engine cannot decode MLA: its ``apply_mla`` writes the
cache at one scalar position, and the engine's positions are per slot
(ROADMAP.md, section 3).  Here the decode tick's ``(B,)`` positions reach
``apply_mla``, which writes and masks each slot at its own position: what
the reference's layer computes for that row alone.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (MIXER_CROSS, MIXER_MAMBA, MIXER_RWKV,
                                      ModelConfig)
from repro_torch.convert import torch_dtype
from repro_torch.core.refactoring import (CacheSnapshot, block_validity,
                                          merge_paged_with_mask,
                                          merge_with_mask, snapshot)
from repro_torch.kernels import build
from repro_torch.models.kvcache import (NULL_BLOCK, BlockAllocator,
                                        blocks_for, can_page, fragmentation,
                                        group_by_stage, init_cache,
                                        init_paged_cache, layer_shapes)
from repro_torch.models.model import embed_tokens, lm_head
from repro_torch.serving.admission import (ADMITTED, PRIO_STANDARD, REJECTED,
                                           AdmissionConfig, AdmissionQueue)
from repro_torch.serving.executor_cache import ExecutorCache, stage_ranges
from repro_torch.serving.faults import (COMM_TRANSIENT, OOM, PREEMPT_STAGE,
                                        SLOWDOWN)
from repro_torch.serving.metrics import ServingStats
from repro_torch.serving.workload import Request


def _fault_path_refusal(cfg: ModelConfig) -> Optional[str]:
    """Why the fault path is not served for ``cfg``, or None.  Each case
    is the reference's: its streams differ after a lost stage."""
    mixers = {cfg.layer_kind(i).mixer for i in range(cfg.n_layers)}
    if mixers & {MIXER_MAMBA, MIXER_RWKV}:
        return ("recurrent (Mamba, RWKV) models: a delta replay cannot "
                "rebuild a lost stage's state")
    if cfg.sliding_window:
        return ("sliding-window models: the Eq. 10 merge restores rows by "
                "position, and a ring that has wrapped holds positions at "
                "other rows")
    if MIXER_CROSS in mixers or any(k.extra_cross for k in cfg.pattern):
        return ("cross-attention models: the Eq. 10 merge restores a "
                "memory's rows only below each slot's token horizon, and the "
                "replay rebuilds self-attention rows only")
    return None


def memory_rows(cfg: ModelConfig, max_seq: int) -> Optional[int]:
    """Rows of a request's memory: its cross caches' length, or None for
    a model with no cross layer."""
    for i in range(cfg.n_layers):
        shapes = layer_shapes(cfg, i, 1, max_seq)
        if "cross" in shapes:
            return shapes["cross"]["k"][2]
        if cfg.layer_kind(i).mixer == MIXER_CROSS:
            return shapes["mixer"]["k"][2]
    return None


def _faults_refused(why: str):
    return NotImplementedError(
        f"the fault path (emergency refactor and replay) is not served for "
        f"{why}, and the reference's streams differ after one; see "
        "ROADMAP.md, section 3, known quirks of the reference")


def balanced_boundaries(n_layers: int, n_stages: int) -> list[int]:
    """Balanced stage starts: remainder layers spread one-per-stage across
    the leading stages."""
    n = max(1, min(n_stages, n_layers))
    base, rem = divmod(n_layers, n)
    out = [0]
    for i in range(n - 1):
        out.append(out[-1] + base + (1 if i < rem else 0))
    return out


@dataclass
class KVCacheConfig:
    """KV-cache layout: ``paged=False`` keeps dense ``max_batch x max_seq``
    rows; paged mode uses per-layer block pools and per-slot block tables
    and needs an attention-only pattern and ``max_seq % block_size == 0``
    (so the paged logical view has a dense cache's shape)."""
    paged: bool = False
    block_size: int = 16
    # physical blocks in the pool; 0 = the dense footprint plus the null
    n_blocks: int = 0
    # paged decode: False gathers the logical view and runs the dense
    # decode kernel; True runs the block-table-walk kernel
    paged_kernel: bool = False


@dataclass
class PrefillConfig:
    """Prefill scheduling: ``buckets`` pads prompts to pow2 buckets.

    ``chunk`` > 0 arms chunked prefill: each admitted prompt is split into
    ``chunk``-token pieces (a power of two >= 16; the final partial piece
    pads to its own pow2 bucket), and at most ``budget`` bucketed prompt
    tokens (0: one chunk) run per tick, round-robin across mid-prefill
    slots, while decode slots keep emitting.  Architectures that cannot
    chunk exactly (non-attention mixers, windows, a non-f32 cache) warn and
    prefill whole prompts, as the reference does."""
    buckets: bool = True
    chunk: int = 0          # tokens per prefill chunk (0: whole prompt)
    budget: int = 0         # bucketed prompt tokens per tick (0: chunk)


class EngineConfig:
    """Scalar knobs plus the typed ``kv`` and ``prefill`` sub-configs.

    The JAX package's ``scan_threshold`` has no counterpart (layers run in a
    Python loop), and its deprecated flat keyword forms are not accepted;
    the flat names stay readable as properties."""

    def __init__(self, max_batch: int = 8, max_seq: int = 256,
                 cache_dtype: str = "float32", eos_token: int = -1,
                 control_interval: float = 1.0, fused_decode: bool = True,
                 warm_profiles: tuple[int, ...] = (),
                 snapshot_interval: int = 0,
                 admission: Optional[AdmissionConfig] = None,
                 kv: Optional[KVCacheConfig] = None,
                 prefill: Optional[PrefillConfig] = None):
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.eos_token = eos_token               # -1: run to max_new_tokens
        self.control_interval = control_interval  # controller cadence (sim s)
        self.fused_decode = fused_decode         # single-program decode tick
        # stage counts whose programs are built and run once at start, so
        # refactoring between them is a cache hit
        self.warm_profiles = warm_profiles
        # Eq. 10 snapshot cadence in decode ticks (0: off): every interval-th
        # tick the caches are copied into a twin allocated at construction,
        # with each slot's committed length as its validity horizon
        self.snapshot_interval = snapshot_interval
        # overload protection (serving/admission.py); None keeps the
        # unbounded FIFO
        self.admission = admission
        self.kv = kv if kv is not None else KVCacheConfig()
        self.prefill = prefill if prefill is not None else PrefillConfig()
        c = self.prefill.chunk
        if c:
            if c < 16 or (c & (c - 1)):
                raise ValueError(
                    f"prefill chunk must be a power of two >= 16, got {c}")
            if self.max_seq % c:
                raise ValueError(
                    f"max_seq ({self.max_seq}) must be a multiple of the "
                    f"prefill chunk ({c}) so chunk starts never cross the "
                    "prompt bucket (bit-exactness invariant)")

    @property
    def paged(self) -> bool:
        return self.kv.paged

    @property
    def block_size(self) -> int:
        return self.kv.block_size

    @property
    def n_blocks(self) -> int:
        return self.kv.n_blocks

    @property
    def paged_kernel(self) -> bool:
        return self.kv.paged_kernel

    @property
    def prefill_buckets(self) -> bool:
        return self.prefill.buckets


@dataclass(frozen=True)
class SubmitResult:
    """Verdict of ``submit``: truthy iff the request was enqueued."""
    accepted: bool
    reason: str
    queue_depth: int

    def __bool__(self) -> bool:
        return self.accepted


@dataclass(frozen=True)
class TickReport:
    """What one ``step`` did."""
    now: float
    decoded: int           # tokens emitted by decode slots this tick
    prefill_tokens: int    # bucketed prompt tokens pumped through chunks
    prefilling: int        # slots mid-prefill after the tick
    admitted: int          # requests assigned to slots this tick
    completed: int         # requests finished this tick
    queue_depth: int
    recoveries: int        # emergency recoveries performed this tick


@dataclass
class Slot:
    request: Optional[Request] = None
    pos: int = 0                     # valid cache length
    generated: list = field(default_factory=list)
    done: bool = True
    budget: int = 0                  # token budget clamped to fit max_seq
    prompt: Optional[np.ndarray] = None  # admitted prompt (replay source)


class FlexPipeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, boundaries: list[int],
                 ecfg: Optional[EngineConfig] = None, device=None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.ecfg = ecfg if ecfg is not None else EngineConfig()
        self.boundaries = list(boundaries)
        self.stats = ServingStats()
        self.refactor_events: list[dict] = []
        self.cache_dtype = torch_dtype(self.ecfg.cache_dtype)
        self.allocator: Optional[BlockAllocator] = None
        self.block_tables: Optional[np.ndarray] = None
        self._slot_blocks: list[list[int]] = []
        self._snap_tables: Optional[np.ndarray] = None
        self._max_blocks = 0
        if self.ecfg.paged:
            if not can_page(cfg):
                raise ValueError("paged KV needs an attention-only, "
                                 "non-windowed pattern")
            if not self.ecfg.fused_decode:
                raise ValueError("paged KV requires fused_decode")
            if self.ecfg.max_seq % self.ecfg.block_size:
                raise ValueError("max_seq must be a multiple of block_size "
                                 "(bit-exactness)")
            bs = self.ecfg.block_size
            self._max_blocks = self.ecfg.max_seq // bs
            if self.ecfg.n_blocks <= 0:
                self.ecfg.kv.n_blocks = \
                    1 + self.ecfg.max_batch * self._max_blocks
            self.allocator = BlockAllocator(self.ecfg.n_blocks, bs)
            self.block_tables = np.zeros(
                (self.ecfg.max_batch, self._max_blocks), np.int32)
            self._slot_blocks = [[] for _ in range(self.ecfg.max_batch)]
        # canonical state: the per-layer cache list
        self.caches = self._init_caches()
        self._memory_len = memory_rows(cfg, self.ecfg.max_seq)
        self.slots = [Slot() for _ in range(self.ecfg.max_batch)]
        # with an AdmissionConfig the queue IS the bounded EDF queue (list-
        # compatible for len and append); without one, an unbounded FIFO
        self.admission: Optional[AdmissionQueue] = None
        if self.ecfg.admission is not None:
            self.admission = AdmissionQueue(self.ecfg.admission,
                                            stats=self.stats)
            self.queue = self.admission
        else:
            self.queue: list[Request] = []
        self.executors = ExecutorCache(
            cfg, params, max_seq=self.ecfg.max_seq,
            cache_dtype=self.cache_dtype,
            prefill_buckets=self.ecfg.prefill_buckets,
            paged=self.ecfg.paged, paged_kernel=self.ecfg.paged_kernel)
        self._fused = None
        if self.ecfg.fused_decode:
            self._fused, _ = self.executors.fused_decode(tuple(self.boundaries))
        # chunked prefill: armed when asked for AND the architecture chunks
        # exactly (attention only, no window, f32 cache)
        self._chunk = 0
        self._prefill_rr = 0          # round-robin cursor over prefill slots
        if self.ecfg.prefill.chunk:
            if self.executors.can_chunk:
                self._chunk = self.ecfg.prefill.chunk
            else:
                warnings.warn(
                    "prefill.chunk requested but this architecture cannot "
                    "chunk bit-exactly (needs attention-only mixers, no "
                    "sliding window, float32 cache); falling back to "
                    "whole-prompt prefill", stacklevel=2)
        # fault-tolerance state (armed by attach_faults)
        self.faults = None               # FaultInjector
        self.fault_policy = None         # FaultPolicy
        self.health = None               # StageHealthMonitor
        self.recovery_events: list[dict] = []
        self.failed_requests: list[Request] = []
        self._no_fault_path = _fault_path_refusal(cfg)
        # the Eq. 10 snapshot: a zeroed twin of the live caches, allocated
        # once here and refilled in place every snapshot_interval ticks
        self._snap_caches = (self._init_caches()
                             if self.ecfg.snapshot_interval else None)
        self._snapshot: Optional[CacheSnapshot] = None
        self._snap_rids: list = []
        self._dead: set[int] = set()
        self._slowdowns: dict[int, tuple[float, float]] = {}
        self._tick_count = 0
        if self.ecfg.warm_profiles:
            self.warmup(self.ecfg.warm_profiles)

    # ------------------------------------------------------------------
    def _init_caches(self, layers=None) -> list:
        if self.ecfg.paged:
            return init_paged_cache(self.cfg, self.ecfg.n_blocks,
                                    self.ecfg.block_size, self.cache_dtype,
                                    device=self.device, layers=layers)
        return init_cache(self.cfg, self.ecfg.max_batch, self.ecfg.max_seq,
                          self.cache_dtype, device=self.device, layers=layers)

    def _scratch_caches(self, layers: range, batch: int, seq: int) -> list:
        """Dummy caches for warm-up runs of ``layers``: one ``(batch, Kh,
        seq, hd)`` pair (one ``batch``-row recurrent state for a Mamba or
        RWKV layer), or a pool of the null block alone when paged, shared
        by every layer of the same cache shape.  Warming a configuration
        (also inside a cold ``refactor()``) so never allocates on the scale
        of the live cache."""
        if self.ecfg.paged:
            one = init_paged_cache(self.cfg, 1, self.ecfg.block_size,
                                   self.cache_dtype, device=self.device,
                                   layers=range(1))
            return one * len(layers)
        shared: dict = {}
        out = []
        for i in layers:
            key = tuple((part, tuple(leaves.items())) for part, leaves
                        in layer_shapes(self.cfg, i, batch, seq).items())
            if key not in shared:
                shared[key] = init_cache(self.cfg, batch, seq,
                                         self.cache_dtype, device=self.device,
                                         layers=range(i, i + 1))[0]
            out.append(shared[key])
        return out

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a host wait: CUDA copies go
        through pinned memory, asynchronously on the current stream."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _tables_dev(self) -> Optional[torch.Tensor]:
        """This tick's copy of the block tables on the device (paged)."""
        if not self.ecfg.paged:
            return None
        return self._upload(self.block_tables)

    def _stage_ranges(self) -> list[tuple[int, int]]:
        return stage_ranges(self.cfg, self.boundaries)

    @property
    def stage_caches(self) -> list[list]:
        """Per-stage re-view of the per-layer caches (zero-copy slicing)."""
        return group_by_stage(self.caches, self.boundaries)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            # repro: noqa[CUDA102] -- warmup's end only, never the tick
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def warmup(self, stage_counts: tuple[int, ...] = ()) -> dict:
        """Build the kernels, then build and run once the programs of the
        current configuration and of each stage count in ``stage_counts``,
        on small dummy caches (the live caches are never touched).  After
        it, refactoring between these configurations builds nothing."""
        t0 = time.perf_counter()
        builds0 = self.executors.builds
        if self.device.type == "cuda":
            build.load_all()
        keys = [tuple(self.boundaries)]
        for n in stage_counts:
            k = tuple(self._boundaries_for(n))
            if k not in keys:
                keys.append(k)
        for k in keys:
            if self.ecfg.fused_decode:
                prog, _ = self.executors.fused_decode(k)
                self._compile_fused(prog)
            else:
                self._compile_stages(stage_ranges(self.cfg, k))
            self._warm_prefill(list(k))
        self._sync()
        return {"configs": len(keys), "t": time.perf_counter() - t0,
                "new_traces": self.executors.builds - builds0}

    def _dummy_tick_inputs(self):
        """Zero inputs of one tick at position 0, uploaded as a live tick
        uploads them, for a one-row scratch cache."""
        B = self.ecfg.max_batch
        tok = self._upload(np.zeros((B, 1), np.int64))
        pos = self._upload(np.zeros((B,), np.int64))
        # one all-null table column: dummy writes land in the null block
        wt = (self._upload(np.zeros((B, 1), np.int32))
              if self.ecfg.paged else None)
        return tok, pos, wt

    def _compile_fused(self, prog) -> None:
        """Run one throwaway tick on scratch caches, so the first live tick
        after a refactor pays no build or first-launch cost."""
        tok, pos, wt = self._dummy_tick_inputs()
        scratch = self._scratch_caches(range(self.cfg.n_layers),
                                       self.ecfg.max_batch, 1)
        nxt, _ = prog.step(scratch, tok, pos, wt)
        # repro: noqa[CUDA102] -- the throwaway warm-up tick's own sync
        nxt.cpu()

    def _compile_stages(self, ranges) -> None:
        """Build and run once the per-stage decode programs (unfused)."""
        B = self.ecfg.max_batch
        _, pos, _ = self._dummy_tick_inputs()
        x = torch.zeros((B, 1, self.cfg.d_model),
                        dtype=self.params["embed"].dtype, device=self.device)
        for lo, hi in ranges:
            fn, _ = self.executors.stage_decode(lo, hi)
            fn(self.params["blocks"][lo:hi], x,
               self._scratch_caches(range(lo, hi), B, 1), pos)

    def _warm_prefill(self, boundaries: list[int]) -> None:
        """Run a configuration's stage-prefill programs once at the smallest
        bucket on scratch caches (bucketable archs only)."""
        if not self.executors.can_bucket:
            return
        S0 = self.executors.prefill_bucket(1)
        ranges = stage_ranges(self.cfg, boundaries)
        out = self._upload(np.zeros((1, S0), np.int64))
        slot_ix = (self._upload(np.zeros(
            (1, blocks_for(S0, self.ecfg.block_size)), np.int32))
            if self.ecfg.paged else 0)
        for si, (lo, hi) in enumerate(ranges):
            fn, _ = self.executors.stage_prefill(
                lo, hi, first=(si == 0), last=(si == len(ranges) - 1))
            out, _ = fn(self.params["blocks"][lo:hi],
                        self.executors.head_params, out,
                        self._scratch_caches(range(lo, hi), 1, S0), slot_ix,
                        1)

    def refactor(self, new_boundaries: list[int]) -> dict:
        """Inflight refactoring: re-group stage boundaries (Eq. 10).

        In-flight requests keep their slots and positions; per-layer cache
        tensors are untouched (zero-copy re-view).  The target's decode
        program comes from the executor cache; one that is new or has never
        run is built and run once here on small scratch caches, so the
        decode loop never pays for it mid-stream."""
        t0 = time.perf_counter()
        old = list(self.boundaries)
        builds0 = self.executors.builds
        self.boundaries = list(new_boundaries)
        hit = True
        if self.ecfg.fused_decode:
            self._fused, registered = self.executors.fused_decode(
                tuple(self.boundaries))
            hit = registered and self._fused.warm
            if not self._fused.warm:
                self._compile_fused(self._fused)
        else:
            missed = []
            for lo, hi in self._stage_ranges():
                _, h = self.executors.stage_decode(lo, hi)
                hit = hit and h
                if not h:
                    missed.append((lo, hi))
            if missed:
                self._compile_stages(missed)
        ev = {"t": time.perf_counter() - t0, "from": old,
              "to": list(new_boundaries),
              "inflight": sum(1 for s in self.slots if not s.done),
              "compile_cache_hit": hit,
              "new_traces": self.executors.builds - builds0}
        self.refactor_events.append(ev)
        return ev

    # ------------------------------------------------------------------
    # Fault tolerance: detection, emergency refactor, replay
    # ------------------------------------------------------------------
    def attach_faults(self, injector=None, policy=None, monitor=None) -> None:
        """Arm the fault stack (serving/faults.py): a FaultInjector that
        schedules preemption, OOM, comm and slowdown events, a FaultPolicy
        for request timeout, retry and degradation, and a
        StageHealthMonitor whose heartbeats and tick watchdog detect them.

        Recurrent (Mamba, RWKV) and sliding-window models take the request
        policy only: a delta replay rebuilds neither a lost stage's state nor a
        wrapped ring, and the reference's streams differ after one
        (ROADMAP.md, section 3)."""
        if self._no_fault_path and (injector is not None
                                    or monitor is not None):
            raise _faults_refused(self._no_fault_path)
        self.faults = injector
        self.fault_policy = policy
        self.health = monitor
        if monitor is not None:
            monitor.reset(len(self.boundaries), 0.0)

    def _maybe_snapshot(self) -> None:
        """Every snapshot_interval-th tick, copy the caches into the twin
        with each slot's committed length as its validity horizon."""
        iv = self.ecfg.snapshot_interval
        if not iv:
            return
        self._tick_count += 1
        if self._tick_count % iv:
            return
        pos = np.array([0 if s.done else s.pos for s in self.slots],
                       np.int64)
        if not pos.any():
            return
        self._snapshot = snapshot(self.caches, pos, out=self._snap_caches)
        self._snap_rids = [s.request.rid if (not s.done and s.request)
                           else None for s in self.slots]
        # paged: the snapshot-time tables map each slot's valid tokens to
        # physical blocks; allocation is append-only while a slot lives, so
        # they are a prefix of the live tables for a slot whose rid matches
        self._snap_tables = (self.block_tables.copy()
                             if self.ecfg.paged else None)

    def fault_step(self, now: float) -> list[dict]:
        """Pre-tick fault handling: poll injected events, beat surviving
        stages, and run detection and emergency recovery."""
        recs: list[dict] = []
        if self.faults is None and not self._dead:
            return recs
        if self.faults is not None:
            for ev in self.faults.poll(now):
                n_stages = len(self.boundaries)
                self.stats.bump("faults_injected")
                self.stats.fault_log.append((now, ev.kind, ev.detail))
                if ev.kind in (PREEMPT_STAGE, OOM):
                    self.stats.bump("preemptions" if ev.kind == PREEMPT_STAGE
                                    else "oom_events")
                    self._dead.add(ev.stage % n_stages)
                elif ev.kind == COMM_TRANSIENT:
                    # the tick is retransmitted; no state is lost
                    self.stats.bump("comm_errors")
                elif ev.kind == SLOWDOWN:
                    self.stats.bump("slowdowns")
                    self._slowdowns[ev.stage % n_stages] = (
                        now + ev.duration, ev.factor)
        if not self._dead:
            return recs
        # dead stages miss their heartbeat window; with no monitor the
        # dispatch failure itself is the detector
        if self.health is not None:
            for s in range(len(self.boundaries)):
                if s not in self._dead:
                    self.health.heartbeat(s, now)
            detected = [s for s in self.health.dead_stages(now)
                        if s in self._dead]
        else:
            detected = sorted(self._dead)
        if detected:
            recs.append(self._on_stage_failure(detected, now,
                                               reason="preemption"))
        return recs

    def health_step(self, now: float, tick_wall_s: float) -> Optional[dict]:
        """Post-tick watchdog: observe the decode tick's wall time (scaled by
        any injected slowdown) and migrate away from a straggling stage once
        the patience threshold trips."""
        if self.health is None:
            return None
        slow = [(s, f) for s, (until, f) in self._slowdowns.items()
                if until > now]
        factor = max((f for _, f in slow), default=1.0)
        verdict = self.health.observe_tick(tick_wall_s * factor)
        if verdict == "straggler" and slow:
            return self._migrate_from_straggler(slow[0][0], now)
        return None

    def _migrate_from_straggler(self, stage: int, now: float) -> dict:
        """Graceful migration: the straggler is still reachable, so its KV
        moves with the refactor (a zero-copy re-view); nothing is replayed
        and the streams stay bit-identical."""
        t0 = time.perf_counter()
        n_new = max(len(self.boundaries) - 1, 1)
        ev = self.refactor(self._boundaries_for(n_new))
        ev["emergency"] = True
        ev["reason"] = "straggler"
        self._slowdowns.clear()
        if self.health is not None:
            self.health.reset(len(self.boundaries), now)
        rec = {"t": now, "kind": "graceful_migration", "stage": stage,
               "reason": "straggler", "recovery_s": time.perf_counter() - t0,
               "refactor": ev, "replayed_ticks": 0,
               "compile_cache_hit": ev["compile_cache_hit"],
               "new_traces": ev["new_traces"]}
        self.stats.bump("graceful_migrations")
        self.stats.record_recovery(rec["recovery_s"], t=now,
                                   kind="graceful_migration")
        self.recovery_events.append(rec)
        return rec

    def _on_stage_failure(self, stages: list[int], now: float,
                          reason: str = "preemption") -> dict:
        """Emergency refactor after a stage is lost with its KV.

        Detect, refactor, restore, replay: the lost stages' caches are
        zeroed in place (that memory is gone; zeros, not ``torch.empty``,
        because flash reads masked rows of a partly masked tile and
        multiplies them by an exact 0, so they must be finite), the
        boundaries re-partition onto the surviving stage count (a warm
        profile means no builds), committed rows come back from the latest
        Eq. 10 snapshot, and only the tokens decoded since it are replayed.
        A slot the snapshot does not cover replays its whole history.  No
        committed token is lost: the text lives on the host, in the
        slots."""
        if self._no_fault_path:
            raise _faults_refused(self._no_fault_path)
        t0 = time.perf_counter()
        B = self.ecfg.max_batch
        ranges = self._stage_ranges()
        stages = sorted({min(max(s, 0), len(ranges) - 1) for s in stages})
        lost_layers = [li for s in stages for li in range(*ranges[s])]
        for li in lost_layers:
            for leaves in self.caches[li].values():
                for t in leaves.values():
                    t.zero_()
        n_new = max(len(ranges) - len(stages), 1)
        nb = self._boundaries_for(n_new)
        was_warm = self.executors.is_warm(nb)
        ev = self.refactor(nb)
        ev["emergency"] = True
        ev["reason"] = reason
        # Eq. 10 restore: rows below valid[i] from the snapshot; newer rows
        # keep the live value (surviving stages) or the zeros just written
        # (lost stages, rebuilt by the replay below)
        valid = np.zeros(B, np.int64)
        if self._snapshot is not None:
            snap_pos = np.asarray(self._snapshot.valid_len)
            for i, s in enumerate(self.slots):
                if not s.done and s.request is not None \
                        and i < len(self._snap_rids) \
                        and self._snap_rids[i] == s.request.rid:
                    valid[i] = min(int(snap_pos[i]), s.pos)
            if valid.any():
                snap = CacheSnapshot(self._snapshot.per_layer, valid)
                if self.ecfg.paged:
                    # block-granular: each covered slot's horizon through
                    # the snapshot-time tables, per physical block
                    bv = block_validity(self._snap_tables, valid,
                                        self.ecfg.block_size,
                                        self.ecfg.n_blocks)
                    merge_paged_with_mask(snap, self.caches, bv)
                else:
                    live_len = int(max(s.pos for s in self.slots
                                       if not s.done))
                    merge_with_mask(snap, self.caches, live_len)
        # per live request: (replay start, committed rows, prompt rows)
        spans = {s.request.rid: (int(valid[i]), s.pos, len(s.prompt))
                 for i, s in enumerate(self.slots)
                 if not s.done and s.request is not None}
        replayed = self._replay(valid)
        dt = time.perf_counter() - t0
        rec = {"t": now, "kind": "emergency_refactor", "reason": reason,
               "stages_lost": stages, "layers_lost": lost_layers,
               "recovery_s": dt, "refactor": ev, "was_warm": was_warm,
               "replayed_ticks": replayed, "replay_spans": spans,
               "compile_cache_hit": ev["compile_cache_hit"],
               "new_traces": ev["new_traces"]}
        self.stats.bump("emergency_refactors")
        self.stats.bump("replayed_ticks", replayed)
        self.stats.record_recovery(dt, t=now, kind="emergency_refactor",
                                   detail=reason)
        self.recovery_events.append(rec)
        self._dead.clear()
        self._slowdowns.clear()
        if self.health is not None:
            self.health.reset(len(self.boundaries), now)
        return rec

    def _replay(self, valid: np.ndarray) -> int:
        """Rebuild lost rows through the decode program: slot i replays its
        committed tokens at positions [valid[i], pos), the delta since the
        snapshot, or its whole history when valid[i] == 0.  The same tokens
        at the same positions through the same program rebuild a covered
        slot's rows exactly; sampled ids are discarded.  A mid-prefill slot's
        history is the prompt prefix its cursor has committed; a slot with
        no row yet is skipped (its row-0 write is overwritten by chunk 0)."""
        active = [i for i, s in enumerate(self.slots)
                  if not s.done and s.pos > 0]
        if not active:
            return 0
        B = self.ecfg.max_batch
        hist = {}
        for i in active:
            s = self.slots[i]
            if s.generated:
                h = np.concatenate([np.asarray(s.prompt, dtype=np.int64),
                                    np.asarray(s.generated[:-1],
                                               dtype=np.int64)])
            else:
                h = np.asarray(s.prompt[:s.pos], dtype=np.int64)
            assert len(h) == s.pos, "history must cover committed rows"
            hist[i] = h
        cursor = {i: int(valid[i]) for i in active}
        ticks = 0
        # replay allocates no blocks (rebuilt rows land in blocks the slots
        # own), so one upload of the live tables serves every tick
        tables = self._tables_dev()
        while any(cursor[i] < self.slots[i].pos for i in active):
            tok = np.zeros((B, 1), np.int64)
            pos = np.zeros((B,), np.int64)
            for i in active:
                # caught-up slots rewrite their last row, to the same bits
                p = min(cursor[i], self.slots[i].pos - 1)
                tok[i, 0] = hist[i][p]
                pos[i] = p
            if self._fused is not None:
                self._fused.step(self.caches, self._upload(tok),
                                 self._upload(pos), tables)
            else:
                self._decode_unfused(self._upload(tok), self._upload(pos))
            for i in active:
                cursor[i] = min(cursor[i] + 1, self.slots[i].pos)
            ticks += 1
        return ticks

    def _apply_fault_policy(self, now: float) -> None:
        """Request-level timeout, retry and degradation (FaultPolicy)."""
        pol = self.fault_policy
        if pol is None:
            return
        for si, s in enumerate(self.slots):
            if s.done or s.request is None:
                continue
            req = s.request
            started = req.start if req.start >= 0 else now
            if now - started <= pol.timeout_s:
                continue
            # abort this attempt; its partial output is discarded
            s.done = True
            s.request = None
            s.generated = []
            s.pos = 0
            self._free_slot_blocks(si)
            req.attempts += 1
            self.stats.bump("timeouts")
            if pol.should_retry(req.attempts):
                self.stats.bump("retries")
                req.retry_at = now + pol.backoff(req.attempts)
                req.enqueued_at = now     # per-attempt queue accounting
                if pol.degrade_last_attempt \
                        and pol.is_last_attempt(req.attempts):
                    req.max_new_tokens = pol.degraded_budget(
                        req.max_new_tokens)
                    req.degraded = True
                    self.stats.bump("degraded")
                self.queue.append(req)
            else:
                req.failed = True
                req.fail_reason = f"timeout after {req.attempts} attempts"
                self.stats.bump("request_failures")
                self.failed_requests.append(req)

    # ------------------------------------------------------------------
    def submit(self, req: Request, now: Optional[float] = None) -> SubmitResult:
        """Enqueue a request.  With admission control armed this is the
        bounded fast-fail point: a full queue rejects at once, before any
        prefill work is spent (the 503 path)."""
        t = req.arrival if now is None else now
        if self.admission is not None:
            verdict = self.admission.submit(req, t)
            reason = (ADMITTED if verdict == ADMITTED
                      else (req.fail_reason or REJECTED))
            return SubmitResult(verdict == ADMITTED, reason, len(self.queue))
        req.enqueued_at = t
        self.queue.append(req)
        return SubmitResult(True, ADMITTED, len(self.queue))

    @property
    def rejected_requests(self) -> list[Request]:
        return self.admission.rejected if self.admission is not None else []

    @property
    def shed_requests(self) -> list[Request]:
        return self.admission.shed if self.admission is not None else []

    def kv_used_frac(self) -> float:
        """KV capacity committed by active requests, which the admission
        watermarks gate on: the pool's occupancy when paged, committed slot
        rows over all rows when dense."""
        if self.ecfg.paged:
            return self.allocator.occupancy()
        used = sum(s.pos for s in self.slots if not s.done)
        return used / float(self.ecfg.max_batch * self.ecfg.max_seq)

    # -- paged block lifecycle -----------------------------------------
    def _free_slot_blocks(self, i: int) -> None:
        """Return slot i's blocks to the pool and null its table row."""
        if not self.ecfg.paged:
            return
        if self._slot_blocks[i]:
            self.allocator.free(self._slot_blocks[i])
            self._slot_blocks[i] = []
        self.block_tables[i, :] = NULL_BLOCK

    def _alloc_for_slot(self, i: int, n: int) -> bool:
        """Append n physical blocks to slot i's table (all-or-nothing)."""
        ids = self.allocator.alloc(n)
        if ids is None:
            return False
        base = len(self._slot_blocks[i])
        self.block_tables[i, base:base + n] = ids
        self._slot_blocks[i].extend(ids)
        return True

    def _block_need(self, req: Request) -> int:
        """Blocks a request needs at admission: its truncated prompt plus
        the first decode write."""
        plen = (len(req.prompt_tokens) if hasattr(req, "prompt_tokens")
                else req.prompt_len)
        S = min(plen, max(1, self.ecfg.max_seq - req.max_new_tokens - 1))
        return blocks_for(S + 1, self.ecfg.block_size)

    def _pick_victim(self) -> int:
        """Preemption victim: the lowest-priority live slot, then the one
        holding most blocks, then the highest index (deterministic)."""
        live = [i for i, s in enumerate(self.slots) if not s.done]
        return max(live, key=lambda i: (
            getattr(self.slots[i].request, "priority", PRIO_STANDARD)
            if self.slots[i].request is not None else PRIO_STANDARD,
            len(self._slot_blocks[i]), i))

    def _ensure_decode_blocks(self, now: float) -> None:
        """Grow each active slot's table to cover this tick's write; on pool
        exhaustion preempt a victim (greedy decode regenerates the same
        text when it is readmitted)."""
        for i, s in enumerate(self.slots):
            if s.done:
                continue
            if s.pos // self.ecfg.block_size < len(self._slot_blocks[i]):
                continue
            while not self._alloc_for_slot(i, 1):
                victim = self._pick_victim()
                self._preempt_slot(victim, now)
                if victim == i:
                    break

    def _preempt_slot(self, i: int, now: float) -> None:
        s = self.slots[i]
        req = s.request
        self._free_slot_blocks(i)
        s.done = True
        s.request = None
        s.generated = []
        s.pos = 0
        s.prompt = None
        self.stats.bump("paged_preemptions")
        if req is not None:
            req.enqueued_at = now
            req.retry_at = now
            self.queue.append(req)

    def block_stats(self) -> dict:
        """Pool occupancy (paged mode only)."""
        if not self.ecfg.paged:
            return {}
        live = sum(s.pos for s in self.slots if not s.done)
        used = self.allocator.n_used
        return {"used_blocks": used, "free_blocks": self.allocator.n_free,
                "occupancy": self.allocator.occupancy(),
                "fragmentation": fragmentation(live, used,
                                               self.ecfg.block_size)}

    # ------------------------------------------------------------------
    def _admit(self, now: float) -> int:
        """Fill free slots from the queue; returns the number of requests
        assigned.  With chunked prefill a slot is only assigned here (its
        chunks run in ``_prefill_step``); otherwise the whole prompt
        prefills here."""
        admitted = 0
        for slot_id, slot in enumerate(self.slots):
            if not slot.done or not len(self.queue):
                continue
            if self.admission is not None:
                fits = ((lambda r: self.allocator.can_alloc(
                    self._block_need(r))) if self.ecfg.paged else None)
                req = self.admission.pop_admissible(now, self.kv_used_frac(),
                                                    fits=fits)
                if req is None:
                    break
                # brownout: shrink the token budget by priority class
                f = self.admission.budget_factor(req.priority)
                if f < 1.0:
                    req.max_new_tokens = max(int(req.max_new_tokens * f), 1)
                    req.degraded = True
                    self.stats.bump("brownout_degraded")
            else:
                # requeued requests wait out their retry time
                j = next((k for k, r in enumerate(self.queue)
                          if r.retry_at <= now), None)
                if j is None:
                    break
                if self.ecfg.paged and not self.allocator.can_alloc(
                        self._block_need(self.queue[j])):
                    break              # wait for completions to free blocks
                req = self.queue.pop(j)
            req.start = now
            # per-attempt queue wait, from THIS attempt's enqueue time
            since = req.enqueued_at if req.enqueued_at >= 0 else req.arrival
            req.queue_wait = max(now - since, 0.0)
            if self._chunk:
                if self._assign_slot(slot_id, req, now):
                    admitted += 1
            else:
                self._prefill_into_slot(slot_id, req, now)
                admitted += 1
        return admitted

    def _truncate_prompt(self, req: Request) -> tuple[np.ndarray, int]:
        """Admitted prompt and clamped decode budget: the prompt truncates
        (keeping >= 1 token) so prompt + generated tokens fit max_seq."""
        prompt = np.asarray(req.prompt_tokens) \
            if hasattr(req, "prompt_tokens") \
            else np.arange(req.prompt_len) % self.cfg.vocab_size
        prompt = prompt[: max(1, self.ecfg.max_seq - req.max_new_tokens - 1)]
        budget = min(req.max_new_tokens,
                     self.ecfg.max_seq - int(prompt.shape[0]) - 1)
        return prompt, budget

    def _finish(self, i: int, now: float) -> None:
        s = self.slots[i]
        req = s.request
        req.finish = now
        req.output = list(s.generated)
        self.stats.record(now, req.latency, req.met_slo,
                          queue_s=req.queue_wait,
                          ttft_s=req.first_token - req.arrival)
        s.done = True
        s.request = None
        self._free_slot_blocks(i)

    def _assign_slot(self, slot_id: int, req: Request, now: float) -> bool:
        """Chunked admission: bind the request to the slot with its prefill
        cursor at 0; no model work happens here.  ``slot.pos`` is the cursor
        (it always counts committed rows), and ``generated == []`` marks the
        slot as mid-prefill."""
        prompt, budget = self._truncate_prompt(req)
        S = int(prompt.shape[0])
        if self.ecfg.paged:
            # every block of the prompt and the first decode write up
            # front: chunk writes and parked decode writes stay in the
            # slot's own blocks
            if not self._alloc_for_slot(
                    slot_id, blocks_for(S + 1, self.ecfg.block_size)):
                req.enqueued_at = now       # pool raced empty: requeue
                req.retry_at = now
                self.queue.append(req)
                return False
        slot = self.slots[slot_id]
        slot.request = req
        slot.prompt = prompt.astype(np.int64)
        slot.pos = 0
        slot.generated = []
        slot.budget = budget
        slot.done = False
        return True

    def _prefill_step(self, now: float) -> int:
        """Run pending prefill chunks round-robin across mid-prefill slots,
        spending at most ``prefill.budget`` bucketed prompt tokens (default
        one chunk); the decode tick after it runs every slot that has a
        token.  Returns the bucketed tokens spent."""
        if not self._chunk:
            return 0
        pending = [i for i, s in enumerate(self.slots)
                   if not s.done and not s.generated]
        if not pending:
            return 0
        budget = self.ecfg.prefill.budget or self._chunk
        # rotate the first slot so equal prompts share the budget fairly
        start = self._prefill_rr % len(pending)
        ring = pending[start:] + pending[:start]
        self._prefill_rr += 1
        spent = 0
        while ring and spent < budget:
            i = ring.pop(0)
            spent += self._prefill_chunk_into(i, now)
            s = self.slots[i]
            if not s.done and not s.generated:
                ring.append(i)         # more chunks pending: back of line
        return spent

    def _prefill_chunk_into(self, slot_id: int, now: float) -> int:
        """Run ONE chunk for the slot: commit prompt rows [pos, pos + L)
        through every stage's chunk program.  The final chunk samples the
        first token (TTFT is stamped here) and turns the slot to decode; a
        request whose budget is already spent finishes at once, as with
        whole-prompt prefill.  Returns the chunk's bucketed length."""
        s = self.slots[slot_id]
        req = s.request
        S = len(s.prompt)
        c0 = s.pos
        L = min(self._chunk, S - c0)
        Lb = self.executors.chunk_bucket(L, self._chunk)
        Sp = self.executors.prefill_bucket(S)
        final = c0 + L >= S
        toks = np.zeros((1, Lb), np.int64)
        toks[0, :L] = s.prompt[c0:c0 + L]
        out = self._upload(toks)
        slot_ix = (self._upload(self.block_tables[slot_id:slot_id + 1])
                   if self.ecfg.paged else slot_id)
        ranges = self._stage_ranges()
        for si, (lo, hi) in enumerate(ranges):
            fn, _ = self.executors.chunk_prefill(
                lo, hi, first=(si == 0), last=(si == len(ranges) - 1),
                sample=final, chunk_len=Lb, kv_extent=Sp)
            out, _ = fn(self.params["blocks"][lo:hi],
                        self.executors.head_params, out, self.caches[lo:hi],
                        slot_ix, c0, S - 1 - c0)
        s.pos = c0 + L
        self.stats.bump("prefill_chunks")
        if final:
            # repro: noqa[CUDA102] -- the final chunk's one-token sync
            first = int(out.cpu()[0])
            req.first_token = now          # TTFT: this chunk
            s.generated = [first]
            eos = self.ecfg.eos_token
            if s.budget <= 1 or (eos >= 0 and first == eos):
                self._finish(slot_id, now)
        return Lb

    def _request_memory(self, req: Request) -> Optional[torch.Tensor]:
        """The request's cross-attention memory on the engine's device, in
        the params' dtype, or None (no memory, or no cross layer to read
        it).  Moved once and kept on the request."""
        m = getattr(req, "memory", None)
        if m is None or self._memory_len is None:
            return None
        dt = self.params["embed"].dtype
        if not (torch.is_tensor(m) and m.device == self.device
                and m.dtype == dt):
            if not torch.is_tensor(m):
                m = torch.from_numpy(np.array(m, np.float32))   # a copy
            m = m.to(device=self.device, dtype=dt)
            req.memory = m
        want = (1, self._memory_len, self.cfg.d_model)
        if tuple(m.shape) != want:
            raise ValueError(f"request {req.rid}: memory of shape "
                             f"{tuple(m.shape)}, the cross caches take "
                             f"{want}")
        return m

    def _prefill_into_slot(self, slot_id: int, req: Request,
                           now: float = 0.0) -> None:
        prompt, budget = self._truncate_prompt(req)
        S = int(prompt.shape[0])
        if self.ecfg.paged:
            # blocks for the prompt + the first decode write; bucket
            # padding beyond them lands in the null block
            if not self._alloc_for_slot(
                    slot_id, blocks_for(S + 1, self.ecfg.block_size)):
                req.enqueued_at = now       # pool raced empty: requeue
                req.retry_at = now
                self.queue.append(req)
                return
        Sp = self.executors.prefill_bucket(S)
        toks = np.zeros((1, Sp), np.int64)
        toks[0, :S] = prompt
        memory = self._request_memory(req)
        out = self._upload(toks)
        slot_ix = (self._upload(self.block_tables[slot_id:slot_id + 1])
                   if self.ecfg.paged else slot_id)
        ranges = self._stage_ranges()
        for si, (lo, hi) in enumerate(ranges):
            fn, _ = self.executors.stage_prefill(
                lo, hi, first=(si == 0), last=(si == len(ranges) - 1))
            out, _ = fn(self.params["blocks"][lo:hi],
                        self.executors.head_params, out, self.caches[lo:hi],
                        slot_ix, S, memory)
        slot = self.slots[slot_id]
        slot.request = req
        slot.pos = S
        slot.prompt = prompt.astype(np.int64)
        slot.budget = budget
        # repro: noqa[CUDA102] -- the prefill's one-token sync
        first = int(out.cpu()[0])
        req.first_token = now
        slot.generated = [first]
        slot.done = False
        eos = self.ecfg.eos_token
        if budget <= 1 or (eos >= 0 and first == eos):
            self._finish(slot_id, now)

    # ------------------------------------------------------------------
    def decode_step(self, now: float) -> int:
        """One decode tick for all active slots; returns #active."""
        B = self.ecfg.max_batch
        if self.ecfg.paged:
            # grow tail blocks before reading the active mask: a slot the
            # pool cannot grow is preempted and skips this tick
            self._ensure_decode_blocks(now)
        active = np.array([not s.done and len(s.generated) > 0
                           for s in self.slots])
        n_active = int(active.sum())
        if not n_active:
            return 0
        tok = np.zeros((B, 1), np.int64)
        pos = np.zeros((B,), np.int64)
        if self._chunk:
            # the tick writes a row for EVERY slot: park a mid-prefill
            # slot's write on its next chunk's first row, which that chunk
            # overwrites (row 0 would clobber a committed chunk 0)
            for i, s in enumerate(self.slots):
                if not s.done and not s.generated:
                    pos[i] = s.pos
        for i in np.nonzero(active)[0]:
            s = self.slots[i]
            tok[i, 0] = s.generated[-1]
            pos[i] = s.pos
        tok_d = self._upload(tok)
        pos_d = self._upload(pos)
        if self._fused is not None:
            nxt_d, _ = self._fused.step(self.caches, tok_d, pos_d,
                                        self._tables_dev())
            # repro: noqa[CUDA102] -- THE per-tick sync: B int32 ids
            nxt = nxt_d.cpu().numpy()
        else:
            nxt = self._decode_unfused(tok_d, pos_d)
        gen = np.array([len(s.generated) for s in self.slots])
        lim = np.array([s.budget if s.request else 0 for s in self.slots])
        eos = self.ecfg.eos_token
        hit_eos = (eos >= 0) & (nxt == eos)
        finished = active & ((gen + 1 >= lim) | hit_eos)
        for i in np.nonzero(active)[0]:
            s = self.slots[i]
            s.generated.append(int(nxt[i]))
            s.pos += 1
        for i in np.nonzero(finished)[0]:
            self._finish(int(i), now)
        if self.ecfg.paged:
            bsst = self.block_stats()
            self.stats.record_blocks(now, bsst["used_blocks"],
                                     bsst["free_blocks"],
                                     bsst["fragmentation"])
        self._maybe_snapshot()
        return n_active

    def _decode_unfused(self, tok: torch.Tensor,
                        pos: torch.Tensor) -> np.ndarray:
        """Per-stage decode loop; the argmax runs on the device, so only the
        B int32 ids reach the host, as in the fused tick."""
        x = embed_tokens(self.cfg, self.params, tok, pos0=pos)
        for lo, hi in self._stage_ranges():
            fn, _ = self.executors.stage_decode(lo, hi)
            x, _ = fn(self.params["blocks"][lo:hi], x, self.caches[lo:hi],
                      pos)
        logits = lm_head(self.cfg, self.params, x)[:, -1, :]
        # repro: noqa[CUDA102] -- the unfused tick's one sync: B int32 ids
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    # ------------------------------------------------------------------
    def step(self, now: float) -> TickReport:
        """One engine tick: fault policy, admission maintenance, slot fill,
        fault detection and recovery, prefill chunks, then decode."""
        completed0 = self.stats.completed
        self._apply_fault_policy(now)
        if self.admission is not None:
            # shed dead queued work even while slots are full, then advance
            # the brownout controller on saturation
            self.admission.expire(now)
            self.admission.update(now)
        admitted = self._admit(now)
        recs = self.fault_step(now)
        prefill_tokens = self._prefill_step(now)
        t_tick = time.perf_counter()
        decoded = self.decode_step(now)   # ends in the tick's host sync
        self.health_step(now, time.perf_counter() - t_tick)
        return TickReport(
            now=now, decoded=decoded, prefill_tokens=prefill_tokens,
            prefilling=sum(1 for s in self.slots
                           if not s.done and not s.generated),
            admitted=admitted, completed=self.stats.completed - completed0,
            queue_depth=len(self.queue), recoveries=len(recs))

    def run(self, requests: list[Request], controller=None,
            time_per_tick: float = 0.05) -> ServingStats:
        """Trace-driven loop in simulated time until every request ends;
        ``controller`` (a ``FlexPipeController``) may refactor."""
        pending = sorted(requests, key=lambda r: r.arrival)
        if self.admission is not None and self.admission.cost.auto:
            # simulated time: a prefill costs one tick (chunked: one tick
            # per budget of prompt tokens) and decode one tick per token
            self.admission.cost.seed_from_tick(
                time_per_tick,
                prefill_tokens_per_tick=(
                    (self.ecfg.prefill.budget or self._chunk)
                    if self._chunk else 0))
        now = 0.0
        last_ctl = 0.0
        i = 0
        while i < len(pending) or len(self.queue) or \
                any(not s.done for s in self.slots):
            while i < len(pending) and pending[i].arrival <= now:
                self.submit(pending[i], now=pending[i].arrival)
                if controller is not None:
                    controller.on_request(pending[i].arrival)
                i += 1
            self.step(now)
            if controller is not None and \
                    now - last_ctl >= self.ecfg.control_interval:
                last_ctl = now
                sat = self.admission.saturation() \
                    if self.admission is not None else 0.0
                # the partition and migration estimate are not used: the
                # engine refactors to balanced boundaries, as the reference
                d, _ = controller.control_step(now, len(self.queue),
                                               saturation=sat)
                if d.changed and d.target.stages <= self.cfg.n_layers:
                    nb = self._boundaries_for(d.target.stages)
                    if nb != self.boundaries:
                        self.refactor(nb)
            self.stats.queue_samples.append((now, len(self.queue)))
            if self.admission is not None:
                self.stats.record_saturation(now,
                                             self.admission.saturation())
            now += time_per_tick
        return self.stats

    def _boundaries_for(self, n_stages: int) -> list[int]:
        return balanced_boundaries(self.cfg.n_layers, n_stages)
