"""Fault tolerance: a step watchdog and a checkpoint-restart supervisor.

Ports ``StepWatchdog`` and ``TrainSupervisor`` of
``repro/training/fault_tolerance.py``.  The runbook: detect a failure (an
exception from the step, or the watchdog's 'failed' verdict on a step that
outran its timeout), restore the latest checkpoint, and replay the data
pipeline from the checkpointed step (its batches are seeded by step, so the
replay is exact).  ``elastic_mesh`` lays the largest (pod, data, model)
mesh over the surviving ranks: the model axis (the plan's S x T x R) stays
whole, and data parallelism shrinks.

Straggler detection: a step slower than ``straggler_factor`` times the
median for ``patience`` steps in a row is flagged.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.launch.mesh import Mesh


@dataclass
class StepWatchdog:
    timeout_s: float = 300.0
    straggler_factor: float = 2.0
    patience: int = 5
    _times: list = field(default_factory=list)
    _slow_streak: int = 0

    def observe(self, step_time: float) -> str:
        """Returns 'ok' | 'straggler' | 'failed'."""
        if step_time > self.timeout_s:
            return "failed"
        self._times.append(step_time)
        if len(self._times) > 50:
            del self._times[:25]
        med = float(np.median(self._times))
        if len(self._times) >= 5 and step_time > self.straggler_factor * med:
            self._slow_streak += 1
        else:
            self._slow_streak = 0
        return "straggler" if self._slow_streak >= self.patience else "ok"


def elastic_mesh(n_devices: int, model_axis: int = 16, pods: int = 1,
                 device=None) -> Mesh:
    """The largest valid (pod, data, model) mesh over the first
    ``n_devices`` ranks of the world (the survivors).  The model axis stays
    intact (the pipeline and tensor structure is fixed by the plan) and
    data parallelism shrinks; the trainer then splits or cuts the global
    batch.  A rank past the mesh takes part in making its groups only."""
    per_pod = n_devices // pods
    data = per_pod // model_axis
    if data < 1:
        raise ValueError(f"cannot build mesh: {n_devices} devices")
    shape = (pods, data, model_axis) if pods > 1 else (data, model_axis)
    names = ("pod", "data", "model") if pods > 1 else ("data", "model")
    return Mesh(names, shape, device)


@dataclass
class TrainSupervisor:
    """Checkpoint-restart loop: run steps, checkpoint every k, recover on a
    failure by restoring (used by launch/train_pipeline.py and tested with
    injected faults)."""
    ckpt_dir: str
    ckpt_every: int = 50
    watchdog: StepWatchdog = field(default_factory=StepWatchdog)
    failures_seen: int = 0
    restarts: int = 0

    def _recover(self, restore_fn) -> tuple:
        """One recovery path for both detection modes (an exception and the
        watchdog's 'failed' verdict): every failure is also a restart."""
        self.failures_seen += 1
        self.restarts += 1
        return restore_fn()

    def run(self, *, n_steps: int, step_fn, state, save_fn, restore_fn,
            inject_fault_at: int | None = None) -> tuple:
        """Supervised loop.  step_fn(state, step) -> state;
        save_fn(state, step); restore_fn() -> (state, step)."""
        step = 0
        while step < n_steps:
            t0 = time.perf_counter()
            try:
                if inject_fault_at is not None and step == inject_fault_at:
                    inject_fault_at = None
                    raise RuntimeError("injected node failure")
                state = step_fn(state, step)
            except RuntimeError:
                state, step = self._recover(restore_fn)
                continue
            verdict = self.watchdog.observe(time.perf_counter() - t0)
            if verdict == "failed":
                state, step = self._recover(restore_fn)
                continue
            step += 1
            if step % self.ckpt_every == 0 or step == n_steps:
                save_fn(state, step)
        return state, step
