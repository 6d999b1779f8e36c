"""``dicp_tpu_torch.utils`` and ``dicp_tpu_torch.visualization`` against the
JAX package's: the mirrors of tests/test_utils.py's benchmark and
visualization cases on tensors, ``trace`` writing a TensorBoard trace on the
CPU, ``benchmark`` refusing an untimed warm-up, and the exported names (JAX's
less its TPU clock)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dicp_tpu.utils as jutils  # noqa: E402

import dicp_tpu_torch.utils as tutils  # noqa: E402
from dicp_tpu_torch.utils import (benchmark, load_odometry_state,  # noqa: E402
                                  save_odometry_state, trace)

TPU_CLOCK = ("chained_rate", "device_timing_is_trustworthy")


def test_utils_names_are_jax_less_the_tpu_clock():
    assert tutils.__all__ == [n for n in jutils.__all__ if n not in TPU_CLOCK]
    for name in tutils.__all__:
        assert callable(getattr(tutils, name))


def test_benchmark_helper():
    stats = benchmark(lambda: torch.ones((64, 64)).sum(), n=3)
    assert stats["n"] == 3
    assert stats["mean_s"] > 0 and stats["min_s"] > 0 and stats["compile_s"] > 0
    assert stats["min_s"] <= stats["mean_s"]
    # force_wallclock is JAX's signature: accepted, changes nothing
    assert benchmark(lambda: torch.ones(3), n=2, force_wallclock=True)["n"] == 2


def test_benchmark_refuses_an_untimed_warmup():
    with pytest.raises(ValueError, match="warmup"):
        benchmark(lambda: torch.ones(3), warmup=0)


def test_trace_writes_a_tensorboard_trace(tmp_path):
    x = torch.randn(256, 256, dtype=torch.float64)
    with trace(str(tmp_path)):
        (x @ x).sum()
    files = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert files and all(p.name.endswith(".pt.trace.json") for p in files)
    assert sum(p.stat().st_size for p in files) > 0
    assert "aten::mm" in "".join(p.read_text() for p in files)


def test_checkpoint_roundtrip_through_utils(tmp_path):
    path = os.path.join(tmp_path, "odo.npz")
    poses = np.tile(np.eye(4), (5, 1, 1))
    save_odometry_state(path, poses, step=7)
    state = load_odometry_state(path)
    np.testing.assert_array_equal(state["poses"], poses)
    assert int(state["step"]) == 7


def test_visualization_saves(tmp_path, source_np, target_np):
    pytest.importorskip("matplotlib")
    from dicp_tpu_torch.visualization import plot_map, plot_overlay

    p1 = os.path.join(tmp_path, "overlay.png")
    src = torch.as_tensor(source_np[:, :3]).requires_grad_(True)
    plot_overlay(src, torch.as_tensor(target_np[:, :3]), file_name=p1)
    assert os.path.getsize(p1) > 0

    p2 = os.path.join(tmp_path, "map.png")
    plot_map(source_np[:, :3], file_name=p2)
    assert os.path.getsize(p2) > 0
