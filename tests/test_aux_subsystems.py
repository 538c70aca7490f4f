"""Tests for the auxiliary subsystems: profiling timers and checkpoint/resume."""

import os

import numpy as np
import jax.numpy as jnp

from graphik_tpu.utils import checkpoint, profiling


def test_stage_timer_accumulates():
    t = profiling.StageTimer()
    with t.stage("a"):
        x = jnp.arange(8) * 2.0
        t.sync(x)
    with t.stage("a"):
        pass
    with t.stage("b", sync_result=jnp.ones((4,))):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2
    assert s["b"]["count"] == 1
    assert s["a"]["total_s"] >= s["a"]["last_s"] >= 0.0
    t.reset()
    assert t.summary() == {}


def test_global_timer():
    profiling.reset()
    with profiling.timed("stage1"):
        pass
    assert profiling.global_summary()["stage1"]["count"] == 1


def test_device_trace_noop():
    with profiling.device_trace(None):
        x = 1
    assert x == 1


def test_device_trace_writes_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        profiling.fence(jnp.arange(4.0) * 2.0)
    assert list(tmp_path.rglob("*.xplane.pb"))


def test_device_trace_raises_when_profiler_fails(tmp_path, monkeypatch):
    import jax
    import pytest

    def broken(log_dir):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(jax.profiler, "start_trace", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with profiling.device_trace(str(tmp_path)):
            pass


def test_checkpoint_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "ck", "sweep.npz")
    state = {
        "cursor": np.asarray(17),
        "metrics": {"success": np.asarray([1.0, 0.0, 1.0]),
                    "e_pos": np.asarray([[1e-4, 2e-4]])},
        "q_last": np.arange(12.0).reshape(2, 6),
    }
    checkpoint.save_checkpoint(path, state, meta={"seed": 3, "config": "ur10"})
    loaded, meta = checkpoint.load_checkpoint(path)
    assert meta == {"seed": 3, "config": "ur10"}
    assert int(loaded["cursor"]) == 17
    np.testing.assert_array_equal(loaded["q_last"], state["q_last"])
    np.testing.assert_array_equal(
        loaded["metrics"]["success"], state["metrics"]["success"]
    )


def test_checkpoint_reserved_savez_name(tmp_path):
    # "file" is np.savez's positional parameter; the direct zip writer must
    # accept it as a state key anyway.
    path = os.path.join(tmp_path, "f.npz")
    checkpoint.save_checkpoint(path, {"file": np.asarray(5)}, {})
    st, _ = checkpoint.load_checkpoint(path)
    assert int(st["file"]) == 5


def test_checkpoint_rejects_separator_keys(tmp_path):
    import pytest

    path = os.path.join(tmp_path, "g.npz")
    with pytest.raises(ValueError, match="reserved"):
        checkpoint.save_checkpoint(path, {"a/b": np.asarray(1)}, {})


def test_checkpoint_atomic_overwrite(tmp_path):
    path = os.path.join(tmp_path, "c.npz")
    checkpoint.save_checkpoint(path, {"v": np.asarray(1)}, {"gen": 1})
    checkpoint.save_checkpoint(path, {"v": np.asarray(2)}, {"gen": 2})
    st, meta = checkpoint.load_checkpoint(path)
    assert int(st["v"]) == 2 and meta["gen"] == 2
    # no stray temp files
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
