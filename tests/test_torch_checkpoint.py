"""The port's CheckpointManager: atomic step directories, the async writer,
restore paths, and checkpoints of the JAX package restored into the port.

The single-process tests of tests/test_checkpoint.py, ported to trees of
tensors: newest-complete selection, torn-write tolerance, retention GC, the
bf16 widening round trip, restore into a re-laid-out template, and writer
failures re-raised on the caller's thread.  Then interop: a reduced
qwen2-0.5b train state saved by ``repro``'s ``CheckpointManager`` restores
into the port leaf for leaf, and the next step's loss matches the JAX run's
(rtol 1e-5: the same fp32 step on both sides, as tests/test_torch_train.py
holds it).
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models.params import leaves


def _state(scale: float = 1.0) -> dict:
    return {
        "params": {
            "w": torch.arange(12, dtype=torch.float32).reshape(3, 4) * scale,
            "b": torch.ones(4) * scale,
        },
        "opt": {"m": torch.zeros(3, 4),
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _assert_trees_equal(a, b) -> None:
    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys()
    for path, x in la.items():
        assert x.dtype == lb[path].dtype, path
        assert torch.equal(x, lb[path]), path


class TestRoundTrip:
    def test_sync_save_restore(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        state = _state()
        mgr.save(3, state)
        _assert_trees_equal(mgr.restore(3, _state(scale=0.0)), state)

    def test_async_save_then_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=True)
        state = _state(scale=2.0)
        mgr.save(1, state)
        mgr.wait()
        assert mgr.all_steps() == [1]
        _assert_trees_equal(mgr.restore(1, _state(scale=0.0)), state)

    def test_restore_waits_for_inflight_write(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=True)
        state = _state(scale=3.0)
        mgr.save(4, state)
        step, tree = mgr.restore_latest(_state(scale=0.0))
        assert step == 4
        _assert_trees_equal(tree, state)

    def test_meta_json_round_trip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        mgr.save(2, _state(), meta={"loss": 1.25})
        with open(tmp_path / "step_00000002" / "meta.json") as f:
            assert json.load(f) == {"step": 2, "loss": 1.25}

    def test_resave_same_step_overwrites_atomically(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        mgr.save(1, _state(scale=1.0))
        mgr.save(1, _state(scale=5.0))
        _assert_trees_equal(mgr.restore(1, _state(scale=0.0)),
                            _state(scale=5.0))

    def test_keys_are_the_references_flattened_paths(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        mgr.save(1, _state())
        with np.load(tmp_path / "step_00000001" / "shard_0.npz") as z:
            assert sorted(z.files) == ["opt/m", "opt/step", "params/b",
                                       "params/w"]


class TestSelectionAndRetention:
    def test_restore_latest_picks_newest_complete(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        for step, scale in ((1, 1.0), (5, 5.0), (3, 3.0)):
            mgr.save(step, _state(scale=scale))
        step, tree = mgr.restore_latest(_state(scale=0.0))
        assert step == 5
        _assert_trees_equal(tree, _state(scale=5.0))

    def test_incomplete_step_is_invisible(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        mgr.save(2, _state(scale=2.0))
        torn = tmp_path / "step_00000009"
        torn.mkdir()
        np.savez(torn / "shard_0.npz", x=np.zeros(1))   # no meta.json
        assert mgr.all_steps() == [2]
        assert mgr.latest_step() == 2

    def test_empty_directory_restores_nothing(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        assert mgr.latest_step() is None
        assert mgr.restore_latest(_state()) is None

    def test_gc_keeps_newest_k(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
        for step in (1, 2, 3, 4):
            mgr.save(step, _state(scale=float(step)))
        assert mgr.all_steps() == [3, 4]
        assert not os.path.isdir(tmp_path / "step_00000001")
        _assert_trees_equal(mgr.restore(3, _state(scale=0.0)),
                            _state(scale=3.0))


class TestDtypeAndRelayout:
    def test_bf16_widens_to_f32_and_recasts_on_restore(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        mgr.save(1, {"w": torch.tensor([1.0, 2.5, -3.0], dtype=torch.bfloat16)})
        with np.load(tmp_path / "step_00000001" / "shard_0.npz") as shard:
            assert shard["w"].dtype == np.float32       # stored widened...
        got = mgr.restore(1, {"w": torch.zeros(3, dtype=torch.bfloat16)})
        assert got["w"].dtype == torch.bfloat16          # ...restored re-cast
        assert got["w"].float().tolist() == [1.0, 2.5, -3.0]

    def test_restore_into_differently_typed_like(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        mgr.save(1, {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)})
        got = mgr.restore(1, {"w": torch.zeros(3, 2, dtype=torch.bfloat16)})
        assert got["w"].shape == (3, 2) and got["w"].dtype == torch.bfloat16
        assert got["w"].float().ravel().tolist() == list(range(6))

    def test_restore_missing_leaf_fails_loudly(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        mgr.save(1, {"w": torch.ones(2)})
        with pytest.raises(KeyError):
            mgr.restore(1, {"w": torch.zeros(2), "extra": torch.zeros(1)})

    def test_bf16_round_trip_through_resharded_restore(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        vals = torch.linspace(-2, 2, 24).to(torch.bfloat16)
        mgr.save(1, {"w": vals.reshape(4, 6)})
        got = mgr.restore(1, {"w": torch.zeros(2, 12, dtype=torch.bfloat16)})
        assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (2, 12)
        assert torch.equal(got["w"].ravel(), vals)

    def test_torn_tmp_next_to_complete_older_step(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        mgr.save(4, _state(scale=4.0))
        torn = tmp_path / "step_00000006.tmp0"
        torn.mkdir()
        np.savez(torn / "shard_0.npz", **{"params/w": np.zeros((3, 4))})
        (torn / "meta.json").write_text('{"step": 6}')
        assert mgr.all_steps() == [4]
        step, tree = mgr.restore_latest(_state(scale=0.0))
        assert step == 4
        _assert_trees_equal(tree, _state(scale=4.0))


class TestAsyncFailureSurfacing:
    def _failing_mgr(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=True)

        def boom(step, tmp):
            raise OSError(f"disk full writing step {step}")

        mgr.fault_hook = boom
        return mgr

    def test_wait_reraises_writer_failure(self, tmp_path):
        mgr = self._failing_mgr(tmp_path)
        mgr.save(2, _state())
        with pytest.raises(RuntimeError, match="async checkpoint write "
                                               "failed"):
            mgr.wait()
        mgr.fault_hook = None          # the error is consumed
        mgr.save(4, _state())
        mgr.wait()
        assert mgr.all_steps() == [4]

    def test_next_save_reraises_writer_failure(self, tmp_path):
        mgr = self._failing_mgr(tmp_path)
        mgr.save(2, _state())
        with pytest.raises(RuntimeError, match="async checkpoint write"):
            mgr.save(4, _state())

    def test_restore_latest_reraises_writer_failure(self, tmp_path):
        mgr = self._failing_mgr(tmp_path)
        mgr.save(2, _state())
        with pytest.raises(RuntimeError, match="async checkpoint write"):
            mgr.restore_latest(_state())

    def test_failed_write_leaves_no_visible_step(self, tmp_path):
        mgr = self._failing_mgr(tmp_path)
        mgr.save(2, _state())
        with pytest.raises(RuntimeError):
            mgr.wait()
        assert mgr.all_steps() == []
        assert any(".tmp" in p.name for p in tmp_path.iterdir())

    def test_sync_write_failure_raises_inline(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)

        def boom(step, tmp):
            raise OSError("no space")

        mgr.fault_hook = boom
        with pytest.raises(OSError):
            mgr.save(2, _state())


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A reduced qwen2-0.5b train state (fp32 weights, master copy and
    moments, after one JAX step) saved by ``repro``'s manager restores into
    the port's state template leaf for leaf, and the next step's loss
    equals the JAX run's to the fp32 step tolerance."""
    import jax

    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.configs import get_config as jget_config
    from repro.configs import reduce_for_smoke as jreduce
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import make_batch as jmake_batch
    from repro.models import build_model as jbuild_model
    from repro.optim import adamw as jadamw
    from repro.optim import schedules as jschedules
    from repro.parallel import steps as jsteps
    from repro_torch import interop
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, schedules
    from repro_torch.parallel import steps

    jcfg = jreduce(jget_config("qwen2-0.5b"))
    cfg = reduce_for_smoke(get_config("qwen2-0.5b"))
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    sched = dict(peak=1e-3, warmup=0, total=10)
    jstep = jax.jit(jsteps.make_train_step(
        jmodel, jadamw.AdamWConfig(), jschedules.make_schedule("cosine",
                                                               **sched)))
    jstate = jsteps.init_train_state(jmodel, jadamw.AdamWConfig(),
                                     jax.random.PRNGKey(0))
    jdata = JDataConfig(vocab_size=512, seq_len=16, global_batch=4)
    jstate, _ = jstep(jstate, jmake_batch(jdata, 0))
    JManager(str(tmp_path), async_write=False).save(1, jstate)

    like = steps.init_train_state(model, adamw.AdamWConfig(), 5,
                                  device="cpu")
    step, state = CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 1
    want = interop.train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                        device="cpu")
    _assert_trees_equal(state, want)
    assert int(state["opt"]["step"]) == 1
    assert state["opt"]["master"]["embed"].dtype == torch.float32

    _, jm = jstep(jstate, jmake_batch(jdata, 1))
    step_fn = steps.make_train_step(model, adamw.AdamWConfig(),
                                    schedules.make_schedule("cosine", **sched))
    _, m = step_fn(state, make_batch(DataConfig(vocab_size=512, seq_len=16,
                                                global_batch=4), 1,
                                     device="cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
