"""FlexPipe serving engine on PyTorch: the data plane with live refactoring.

Ports the dense and paged serving path of ``repro/serving/engine.py``, for
attention models and, dense only, RWKV-6.  The model is cut into pipeline
stages at ``boundaries``; a ``refactor()`` re-groups the stage boundaries
between decode ticks without dropping a request, and greedy streams across
it are bit-identical to an uninterrupted run.

Hot path: admission prefills a whole prompt stage by stage, writing its KV
rows in place into the slot (dense rows, or blocks through the slot's
table).  Attention prompts are padded to a pow2 bucket; recurrent (RWKV)
prompts run at their exact length, from a zeroed slot state.  A decode
tick is one fused program: embed, every stage, lm_head and an argmax on
the device; the only per-tick sync is the copy of B int32 ids to the host
(plus the first token of each prefill).
Caches are preallocated tensors written in place (JAX donates them).

A refactor only re-views the per-layer cache list under new stage
ownership (no device traffic) and swaps in the configuration's decode
program from the executor cache.  ``refactor()`` reports
``compile_cache_hit`` (the program existed and had run) and ``new_traces``
(programs built during the call).  In eager PyTorch every configuration's
program runs the same per-layer loop, so a refactor changes no code that
executes: it re-groups bookkeeping, and the refactor checks prove that slot
and cache state survive the re-grouping (see executor_cache.py).

Not ported yet (see ROADMAP.md) and raising ``NotImplementedError``:
admission control (``EngineConfig(admission=...)``), chunked prefill
(``PrefillConfig(chunk>0)``), snapshots and the fault path
(``snapshot_interval``, ``attach_faults``) and a controller in ``run``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import torch_dtype
from repro_torch.kernels import build
from repro_torch.models.kvcache import (NULL_BLOCK, BlockAllocator,
                                        blocks_for, can_page,
                                        fragmentation, group_by_stage,
                                        init_cache, init_paged_cache)
from repro_torch.models.model import embed_tokens, lm_head
from repro_torch.serving.executor_cache import ExecutorCache, stage_ranges
from repro_torch.serving.metrics import ServingStats
from repro_torch.serving.workload import Request

ADMITTED = "admitted"
PRIO_STANDARD = 1


def _todo(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see ROADMAP.md, "
        f"section 1, item '{item}'")


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
    ``chunk`` > 0 (chunked prefill) is not ported yet."""
    buckets: bool = True
    chunk: int = 0


class EngineConfig:
    """Scalar knobs plus the typed ``kv`` and ``prefill`` sub-configs.

    The JAX package's ``scan_threshold`` has no counterpart (layers run in a
    Python loop), and its deprecated flat keyword forms are not accepted;
    the flat names stay readable as properties."""

    def __init__(self, max_batch: int = 8, max_seq: int = 256,
                 cache_dtype: str = "float32", eos_token: int = -1,
                 fused_decode: bool = True,
                 warm_profiles: tuple[int, ...] = (),
                 snapshot_interval: int = 0, admission=None,
                 kv: Optional[KVCacheConfig] = None,
                 prefill: Optional[PrefillConfig] = None):
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.eos_token = eos_token               # -1: run to max_new_tokens
        self.fused_decode = fused_decode         # single-program decode tick
        # stage counts whose programs are built and run once at start, so
        # refactoring between them is a cache hit
        self.warm_profiles = warm_profiles
        self.snapshot_interval = snapshot_interval
        self.admission = admission
        self.kv = kv if kv is not None else KVCacheConfig()
        self.prefill = prefill if prefill is not None else PrefillConfig()
        if admission is not None:
            raise _todo("admission control (EngineConfig(admission=...))",
                        "Admission control")
        if self.prefill.chunk:
            raise _todo("chunked prefill (PrefillConfig(chunk>0))",
                        "Chunked prefill")
        if snapshot_interval:
            raise _todo("Eq. 10 snapshots (snapshot_interval>0)",
                        "Fault path")

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
    prefill_tokens: int    # chunked prefill tokens (0 until it is ported)
    prefilling: int        # slots mid-prefill after the tick
    admitted: int          # requests assigned to slots this tick
    completed: int         # requests finished this tick
    queue_depth: int
    recoveries: int        # fault recoveries (0 until the fault path)


@dataclass
class Slot:
    request: Optional[Request] = None
    pos: int = 0                     # valid cache length
    generated: list = field(default_factory=list)
    done: bool = True
    budget: int = 0                  # token budget clamped to fit max_seq
    prompt: Optional[np.ndarray] = None


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
        self.slots = [Slot() for _ in range(self.ecfg.max_batch)]
        self.queue: list[Request] = []
        self.executors = ExecutorCache(
            cfg, params, max_seq=self.ecfg.max_seq,
            prefill_buckets=self.ecfg.prefill_buckets,
            paged=self.ecfg.paged, paged_kernel=self.ecfg.paged_kernel)
        self._fused = None
        if self.ecfg.fused_decode:
            self._fused, _ = self.executors.fused_decode(tuple(self.boundaries))
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

    def _scratch_caches(self, n_layers: int, batch: int, seq: int) -> list:
        """Dummy caches for warm-up runs: one ``(batch, Kh, seq, hd)`` pair
        (one ``batch``-row recurrent state for RWKV), or a pool of the null
        block alone when paged, shared by all ``n_layers`` layers (every
        ported pattern has one layer kind).  Warming a configuration (also
        inside a cold ``refactor()``) so never allocates on the scale of the
        live cache."""
        if self.ecfg.paged:
            one = init_paged_cache(self.cfg, 1, self.ecfg.block_size,
                                   self.cache_dtype, device=self.device,
                                   layers=range(1))
        else:
            one = init_cache(self.cfg, batch, seq, self.cache_dtype,
                             device=self.device, layers=range(1))
        return one * n_layers

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
        scratch = self._scratch_caches(self.cfg.n_layers,
                                       self.ecfg.max_batch, 1)
        nxt, _ = prog.step(scratch, tok, pos, wt)
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
               self._scratch_caches(hi - lo, B, 1), pos)

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
                        self._scratch_caches(hi - lo, 1, S0), slot_ix, 1)

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

    def attach_faults(self, injector=None, policy=None, monitor=None):
        raise _todo("the fault path (attach_faults)", "Fault path")

    # ------------------------------------------------------------------
    def submit(self, req: Request, now: Optional[float] = None) -> SubmitResult:
        """Enqueue a request (unbounded FIFO)."""
        req.enqueued_at = req.arrival if now is None else now
        self.queue.append(req)
        return SubmitResult(True, ADMITTED, len(self.queue))

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
        """Fill free slots from the FIFO queue, prefilling each prompt;
        returns the number of requests assigned."""
        admitted = 0
        for slot_id, slot in enumerate(self.slots):
            if not slot.done or not self.queue:
                continue
            # requeued requests wait out their retry time
            j = next((k for k, r in enumerate(self.queue)
                      if r.retry_at <= now), None)
            if j is None:
                break
            if self.ecfg.paged and not self.allocator.can_alloc(
                    self._block_need(self.queue[j])):
                break                  # wait for completions to free blocks
            req = self.queue.pop(j)
            req.start = now
            since = req.enqueued_at if req.enqueued_at >= 0 else req.arrival
            req.queue_wait = max(now - since, 0.0)
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
                          ttft_s=req.first_token - req.arrival)
        s.done = True
        s.request = None
        self._free_slot_blocks(i)

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
        out = self._upload(toks)
        slot_ix = (self._upload(self.block_tables[slot_id:slot_id + 1])
                   if self.ecfg.paged else slot_id)
        ranges = self._stage_ranges()
        for si, (lo, hi) in enumerate(ranges):
            fn, _ = self.executors.stage_prefill(
                lo, hi, first=(si == 0), last=(si == len(ranges) - 1))
            out, _ = fn(self.params["blocks"][lo:hi],
                        self.executors.head_params, out, self.caches[lo:hi],
                        slot_ix, S)
        slot = self.slots[slot_id]
        slot.request = req
        slot.pos = S
        slot.prompt = prompt.astype(np.int64)
        slot.budget = budget
        first = int(out.cpu()[0])        # the prefill's one-token sync
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
        for i in np.nonzero(active)[0]:
            s = self.slots[i]
            tok[i, 0] = s.generated[-1]
            pos[i] = s.pos
        tok_d = self._upload(tok)
        pos_d = self._upload(pos)
        if self._fused is not None:
            nxt_d, _ = self._fused.step(self.caches, tok_d, pos_d,
                                        self._tables_dev())
            nxt = nxt_d.cpu().numpy()    # THE per-tick sync: B int32 ids
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
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    # ------------------------------------------------------------------
    def step(self, now: float) -> TickReport:
        """One engine tick: fill free slots (prefill), then decode."""
        completed0 = self.stats.completed
        admitted = self._admit(now)
        decoded = self.decode_step(now)
        return TickReport(
            now=now, decoded=decoded, prefill_tokens=0,
            prefilling=sum(1 for s in self.slots
                           if not s.done and not s.generated),
            admitted=admitted, completed=self.stats.completed - completed0,
            queue_depth=len(self.queue), recoveries=0)

    def run(self, requests: list[Request], controller=None,
            time_per_tick: float = 0.05) -> ServingStats:
        """Trace-driven loop in simulated time until every request ends."""
        if controller is not None:
            raise _todo("controller-driven refactoring (run(controller=))",
                        "Controller and CLI")
        pending = sorted(requests, key=lambda r: r.arrival)
        now = 0.0
        i = 0
        while i < len(pending) or self.queue or \
                any(not s.done for s in self.slots):
            while i < len(pending) and pending[i].arrival <= now:
                self.submit(pending[i], now=pending[i].arrival)
                i += 1
            self.step(now)
            self.stats.queue_samples.append((now, len(self.queue)))
            now += time_per_tick
        return self.stats

    def _boundaries_for(self, n_stages: int) -> list[int]:
        return balanced_boundaries(self.cfg.n_layers, n_stages)
