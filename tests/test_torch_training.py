"""repro_torch's training substrate against the JAX package: the optimizer,
checkpoints (read across the two packages bit for bit), compression, the
fault-tolerant supervisor (with the real train step: a fault and a restore
end with the uninterrupted run's params, bit for bit) and the data pipeline
(the JAX package's arrays, bit for bit); and the two launchers, run
in-process on the CPU.  Mirrors tests/test_training.py.
"""
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st
from jax_compile import np_params

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.configs.base import get_arch as jax_arch
from repro.parallel.pipeline import stack_params as jax_stack_params
from repro.configs.base import PipelinePlan as JPlan
from repro.training import checkpoint as jckpt
from repro.training import compression as jcomp
from repro.training import optimizer as jopt
from repro_torch.configs.base import PipelinePlan, ShapeConfig, get_arch
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as train_launcher
from repro_torch.launch import train_pipeline
from repro_torch.parallel.pipeline import build_train_step, stack_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.compression import (ErrorFeedback, topk_compress,
                                              topk_decompress)
from repro_torch.training.fault_tolerance import StepWatchdog, TrainSupervisor
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            adamw_update, init_opt_state,
                                            schedule)
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)


class TestOptimizer:
    def test_loss_decreases_on_quadratic(self):
        p = {"w": torch.tensor([5.0, -3.0])}
        st_ = init_opt_state(p)
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0)
        for _ in range(200):
            g = {"w": 2 * p["w"]}
            p, st_, _ = adamw_update(cfg, p, g, st_)
        assert float(p["w"].abs().max()) < 0.1

    def test_clip_caps_update(self):
        p = {"w": torch.zeros(4)}
        cfg = AdamWConfig(lr=1.0, clip_norm=1e-3, warmup_steps=0,
                          weight_decay=0.0)
        _, _, m = adamw_update(cfg, p, {"w": torch.full((4,), 1e6)},
                               init_opt_state(p))
        assert float(m["grad_norm"]) > 1.0

    def test_schedule_warmup_then_decay(self):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
        assert float(schedule(cfg, 5)) < float(schedule(cfg, 10))
        assert float(schedule(cfg, 90)) < float(schedule(cfg, 20))

    def test_schedule_equals_reference(self):
        cfg = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
        jcfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
        for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
            got = schedule(cfg, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                float(got), float(jopt.schedule(jcfg, jnp.int32(s))),
                rtol=1e-6)

    def test_adamw_equals_reference(self):
        """Three steps on a small tree (a dict, a list, a bf16 leaf): params,
        moments, step counter, grad norm and lr against the reference's."""
        rng = np.random.default_rng(0)
        tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
                "b": [rng.standard_normal(5).astype(np.float32),
                      rng.standard_normal((2, 2)).astype(np.float32)]}
        cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
        jp = jax.tree.map(jnp.asarray, tree)
        js = jopt.init_opt_state(jp)
        tp = tree_map(torch.from_numpy, tree)
        ts = init_opt_state(tp)
        for i in range(3):
            g = tree_map(lambda x: (rng.standard_normal(x.shape) * (i + 1))
                         .astype(np.float32), tree)
            jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**cfg), jp,
                                           jax.tree.map(jnp.asarray, g), js)
            tp, ts, tm = adamw_update(AdamWConfig(**cfg), tp,
                                      tree_map(torch.from_numpy, g), ts)
            for k in ("grad_norm", "lr"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-6)
        assert ts.step.dtype == torch.int32 and int(ts.step) == 3
        for a, b in zip(jax.tree.leaves((jp, js.m, js.v)),
                        tree_leaves((tp, ts.m, ts.v))):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)


class TestCheckpoint:
    def test_roundtrip_bitwise(self):
        tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                "b": [torch.ones(5, dtype=torch.bfloat16),
                      torch.tensor(3, dtype=torch.int32)]}
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, tree, step=7, meta={"x": 1})
            out, step, meta = ckpt.restore(d, tree)
            assert step == 7 and meta == {"x": 1}
            for a, b in zip(tree_leaves(tree), tree_leaves(out)):
                assert a.dtype == b.dtype and torch.equal(a, b)

    def test_corruption_detected(self):
        tree = {"a": torch.ones(8)}
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, tree, step=1)
            leaf = os.path.join(d, "step_00000001", "leaf_00000.npy")
            arr = np.load(leaf)
            arr[0] = 42.0
            np.save(leaf, arr)
            with pytest.raises(IOError):
                ckpt.restore(d, tree)

    def test_gc_keeps_latest(self):
        tree = {"a": torch.ones(4)}
        with tempfile.TemporaryDirectory() as d:
            for s in range(6):
                ckpt.save(d, tree, step=s)
            assert ckpt.latest_step(d) == 5
            dirs = [x for x in os.listdir(d) if x.startswith("step_")]
            assert len(dirs) == 3

    @staticmethod
    def _trees(arch="qwen1.5-0.5b"):
        """The same stacked params and an optimizer state after a few fake
        updates, in both packages (one bf16 leaf)."""
        jcfg = jax_arch(arch).smoke_config
        cfg = get_arch(arch).smoke_config
        jp = jax.tree.map(jnp.asarray, np_params(cfg, 3))
        jp["final_norm"]["scale"] = jp["final_norm"]["scale"].astype(
            jnp.bfloat16)
        js = jax_stack_params(jcfg, JPlan(microbatches=1), jp)
        rng = np.random.default_rng(1)
        m = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), js)
        v = jax.tree.map(lambda x: jnp.asarray(
            rng.random(x.shape).astype(np.float32)), js)
        jstate = (js, jopt.OptState(jnp.asarray(7, jnp.int32), m, v))
        np_state = jax.tree.map(np.asarray, jstate)
        tp = stack_params(cfg, PipelinePlan(), params_from_numpy(
            jax.tree.map(np.asarray, jp), "cpu", dtype=None))
        tstate = (tp, OptState(torch.tensor(7, dtype=torch.int32),
                               *params_from_numpy([np_state[1].m,
                                                   np_state[1].v], "cpu")))
        return jstate, tstate

    def test_reference_checkpoint_restored_by_port(self):
        jstate, tstate = self._trees()
        like = tree_map(torch.zeros_like, tstate)
        with tempfile.TemporaryDirectory() as d:
            jckpt.save(d, jstate, step=11, meta={"from": "jax"})
            out, step, meta = ckpt.restore(d, like)
        assert step == 11 and meta == {"from": "jax"}
        assert isinstance(out[1], OptState) and int(out[1].step) == 7
        assert out[0]["final_norm"]["scale"].dtype == torch.bfloat16
        for a, b in zip(jax.tree.leaves(jstate), tree_leaves(out)):
            want = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                              else a)
            assert np.array_equal(tree_to_numpy(b), want)

    def test_port_checkpoint_restored_by_reference(self):
        jstate, tstate = self._trees()
        like = jax.tree.map(jnp.zeros_like, jstate)
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, tstate, step=4)
            out, step, _ = jckpt.restore(d, like)
            files = {f: open(os.path.join(d, "step_00000004", f), "rb").read()
                     for f in os.listdir(os.path.join(d, "step_00000004"))
                     if f.endswith(".npy")}
            jckpt.save(d, jstate, step=5)
            same = all(open(os.path.join(d, "step_00000005", f), "rb").read()
                       == data for f, data in files.items())
        assert step == 4 and int(out[1].step) == 7
        for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(jstate)):
            assert a.dtype == b.dtype
            assert np.array_equal(np.asarray(a.astype(jnp.float32)),
                                  np.asarray(b.astype(jnp.float32)))
        assert same, "the two packages wrote different leaf files"


class TestCompression:
    @settings(max_examples=10, deadline=None)
    @given(frac=st.sampled_from([0.1, 0.5, 1.0]))
    def test_topk_roundtrip_preserves_largest(self, frac):
        g = torch.from_numpy(np.random.default_rng(0).normal(size=64))
        vals, idx, shape = topk_compress(g, frac)
        out = topk_decompress(vals, idx, shape)
        k = max(int(64 * frac), 1)
        top = torch.argsort(-g.abs())[:k]
        np.testing.assert_allclose(out[top].numpy(), g[top].numpy(),
                                   rtol=1e-6)

    def test_topk_equals_reference(self):
        g = np.random.default_rng(1).normal(size=(8, 12)).astype(np.float32)
        vals, idx, shape = topk_compress(torch.from_numpy(g), 0.25)
        jv, ji, jshape = jcomp.topk_compress(jnp.asarray(g), 0.25)
        assert shape == tuple(jshape)
        assert np.array_equal(idx.numpy(), np.asarray(ji))
        assert np.array_equal(vals.numpy(), np.asarray(jv))
        assert np.array_equal(
            topk_decompress(vals, idx, shape).numpy(),
            np.asarray(jcomp.topk_decompress(jv, ji, jshape)))

    def test_error_feedback_accumulates(self):
        ef = ErrorFeedback()
        g = {"w": torch.tensor([1.0, 0.4])}
        rounded = ef.apply(g, torch.round)
        # the residual carries the rounding error forward
        total = rounded["w"] + ef.residual["w"]
        np.testing.assert_allclose(total.numpy(), g["w"].numpy())


def _int_supervisor(d, sup, n_steps, step_fn, inject=None):
    def save(state, step):
        ckpt.save(d, {"s": torch.tensor(state)}, step=step)

    def restore():
        out, step, _ = ckpt.restore(d, {"s": torch.tensor(0)})
        return int(out["s"]), step

    save(0, 0)
    return sup.run(n_steps=n_steps, step_fn=step_fn, state=0, save_fn=save,
                   restore_fn=restore, inject_fault_at=inject)


class TestFaultTolerance:
    def test_supervisor_recovers_from_injected_fault(self):
        with tempfile.TemporaryDirectory() as d:
            sup = TrainSupervisor(ckpt_dir=d, ckpt_every=5)
            log = []

            def step_fn(state, step):
                log.append(step)
                return state + 1

            state, step = _int_supervisor(d, sup, 20, step_fn, inject=12)
            assert step == 20 and sup.restarts == 1
            assert state == 20                      # replay is exact
            assert log == list(range(12)) + list(range(10, 20))

    def test_supervisor_counts_watchdog_timeout_as_restart(self):
        # the watchdog's 'failed' verdict (a timeout, no exception) takes
        # the same recovery path as a raised fault
        with tempfile.TemporaryDirectory() as d:
            sup = TrainSupervisor(ckpt_dir=d, ckpt_every=5,
                                  watchdog=StepWatchdog(timeout_s=0.05))
            hung = [True]

            def step_fn(state, step):
                if step == 7 and hung[0]:
                    hung[0] = False
                    time.sleep(0.06)        # exceeds timeout_s -> 'failed'
                return state + 1

            state, step = _int_supervisor(d, sup, 10, step_fn)
            assert step == 10 and state == 10
            assert sup.failures_seen == 1 and sup.restarts == 1

    def test_watchdog_flags_stragglers(self):
        w = StepWatchdog(straggler_factor=2.0, patience=3)
        for _ in range(10):
            assert w.observe(1.0) == "ok"
        assert w.observe(5.0) == "ok"
        assert w.observe(5.0) == "ok"
        assert w.observe(5.0) == "straggler"

    def test_supervised_training_equals_uninterrupted_bitwise(self):
        """The one-rank train step under the supervisor, a checkpoint every
        3 steps and a fault at step 7: the restore from step 6 and the
        replay end with the uninterrupted run's params, optimizer state and
        losses, bit for bit (the CPU is deterministic)."""
        cfg = get_arch("qwen1.5-0.5b").smoke_config
        plan = PipelinePlan(microbatches=2)
        data = TokenPipeline(DataConfig(cfg.vocab_size, 16, 8, seed=0))
        step, _ = build_train_step(cfg, plan, None,
                                   ShapeConfig("t", 16, 8, "train"),
                                   AdamWConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=10),
                                   param_dtype=torch.float32)
        init = np_params(cfg)

        def fresh():
            p = stack_params(cfg, plan, params_from_numpy(init, "cpu"))
            return p, init_opt_state(p)

        def batch(i):
            return {k: torch.from_numpy(v) for k, v in data.batch(i).items()}

        p, o = fresh()
        ref_losses = []
        for i in range(10):
            p, o, m = step(p, o, batch(i))
            ref_losses.append(float(m["loss"]))
        losses = {}

        def one_step(state, i):
            q, s = state
            q, s, m = step(q, s, batch(i))
            losses[i] = float(m["loss"])
            return q, s

        with tempfile.TemporaryDirectory() as d:
            sup = TrainSupervisor(ckpt_dir=d, ckpt_every=3)
            start = fresh()
            (q, s), n = sup.run(
                n_steps=10, step_fn=one_step, state=start,
                save_fn=lambda st, i: ckpt.save(d, st, step=i),
                restore_fn=lambda: ckpt.restore(d, start)[:2],
                inject_fault_at=7)
        assert n == 10 and sup.restarts == 1
        assert [losses[i] for i in range(10)] == ref_losses
        for a, b in zip(tree_leaves((p, o)), tree_leaves((q, s))):
            assert torch.equal(a, b)


class TestDataPipeline:
    def test_deterministic_replay(self):
        p = TokenPipeline(DataConfig(vocab_size=64, seq_len=8, global_batch=4))
        a = p.batch(step=3)
        b = p.batch(step=3)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_rank_sharding_disjoint_rng(self):
        p = TokenPipeline(DataConfig(vocab_size=64, seq_len=8, global_batch=4))
        a = p.batch(step=0, rank=0, n_ranks=2)
        b = p.batch(step=0, rank=1, n_ranks=2)
        assert a["tokens"].shape[0] == 2
        assert not np.array_equal(a["tokens"], b["tokens"])

    @pytest.mark.parametrize("vocab,seq,batch,seed", [
        (512, 16, 8, 0), (151_936, 32, 4, 3), (64, 8, 6, 1)])
    def test_equals_reference_bitwise(self, vocab, seq, batch, seed):
        mine = TokenPipeline(DataConfig(vocab, seq, batch, seed=seed))
        theirs = JTokenPipeline(JDataConfig(vocab, seq, batch, seed=seed))
        for step, rank, n_ranks in ((0, 0, 1), (5, 0, 1), (2, 1, 2)):
            a = mine.batch(step, rank, n_ranks)
            b = theirs.batch(step, rank, n_ranks)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k])


class TestLaunchers:
    def test_train_launcher(self, capsys):
        train_launcher.main(["--arch", "qwen1.5-0.5b", "--steps", "3",
                             "--device", "cpu"])
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("step    0 loss") and out[-1] == "done"
        assert [line.split()[1] for line in out[:-1]] == ["0", "2"]

    def test_train_launcher_rwkv_checkpoints(self, tmp_path, capsys):
        train_launcher.main(["--arch", "rwkv6-1.6b", "--steps", "26",
                             "--seq", "8", "--batch", "2", "--device", "cpu",
                             "--ckpt", str(tmp_path)])
        assert capsys.readouterr().out.splitlines()[-1] == "done"
        assert ckpt.latest_step(str(tmp_path)) == 25

    def test_train_pipeline_launcher(self, tmp_path, capfd):
        # 8 rank processes (S = 2 x T = 2 on a (2, 4) mesh) print to fd 1
        res = train_pipeline.main(["--steps", "30", "--device", "cpu",
                                   "--ckpt", str(tmp_path)])
        out = capfd.readouterr().out
        assert out.splitlines()[-1] == "OK"
        assert "restored from checkpoint at step 0" in out
        assert res["step"] == 30 and res["restarts"] == 1
        assert len(res["losses"]) == 30 + 15      # the replay of 15 steps
