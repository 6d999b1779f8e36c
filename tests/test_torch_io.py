"""The port's copy of the host-side runtime (``dicp_tpu_torch.io``): the cases
of ``tests/test_io.py`` on the port (.bin I/O, the voxel hash grid, the
range filter, the prefetching dataset), the C++ path and the numpy fallback
each, plus the same outputs as ``dicp_tpu.io`` on the same inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dicp_tpu.io as jio  # noqa: E402

from dicp_tpu_torch.config import ICPConfig  # noqa: E402
from dicp_tpu_torch.io import (ScanDataset, load_bin, native_available,  # noqa: E402
                               preprocess_scan, range_filter, save_bin,
                               voxel_downsample_host)
from dicp_tpu_torch.io import native as native_mod  # noqa: E402
from dicp_tpu_torch.registration import register_jit  # noqa: E402


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-30, 30, size=(20000, 3)).astype(np.float32)
    intensity = rng.uniform(0, 1, size=(20000, 1)).astype(np.float32)
    return np.hstack([pts, intensity])


def _numpy_only(monkeypatch):
    """Force the numpy fallback regardless of toolchain."""
    monkeypatch.setattr(native_mod, "_load_lib", lambda: None)


def test_native_builds():
    """g++ is in the image; the shared library must build and load, from the
    repository root's native/ (three directories above the port's module)."""
    assert native_available(), "native library failed to build/load"
    assert native_mod._NATIVE_DIR == jio.native._NATIVE_DIR


def test_bin_roundtrip(tmp_path, cloud):
    path = str(tmp_path / "scan.bin")
    save_bin(path, cloud)
    np.testing.assert_array_equal(load_bin(path, stride=4), cloud)
    np.testing.assert_array_equal(jio.load_bin(path, stride=4), cloud)


def test_voxel_native_matches_numpy(cloud, monkeypatch):
    got_native = voxel_downsample_host(cloud, 2.0, return_weight=True)
    ref = jio.voxel_downsample_host(cloud, 2.0, return_weight=True)
    _numpy_only(monkeypatch)
    got_numpy = voxel_downsample_host(cloud, 2.0, return_weight=True)
    # same cells, same order (first occurrence), same centroids
    np.testing.assert_allclose(got_native[0], got_numpy[0], atol=1e-5)
    np.testing.assert_array_equal(got_native[1], got_numpy[1])
    assert got_native[0].shape[0] < cloud.shape[0]
    for a, b in zip(got_native, ref):
        np.testing.assert_array_equal(a, b)


def test_voxel_averages_cells():
    pts = np.array([[0.1, 0.1, 0.1], [0.3, 0.3, 0.3],   # same cell (voxel=1)
                    [5.0, 5.0, 5.0]], np.float32)
    cent, w = voxel_downsample_host(pts, 1.0, return_weight=True)
    assert cent.shape == (2, 3)
    np.testing.assert_allclose(cent[0], [0.2, 0.2, 0.2], atol=1e-6)
    np.testing.assert_array_equal(w, [2.0, 1.0])


def test_range_filter(cloud, monkeypatch):
    got_native = range_filter(cloud, 5.0, 25.0)
    r = np.linalg.norm(got_native[:, :3].astype(np.float64), axis=-1)
    assert np.all((r >= 5.0 - 1e-4) & (r <= 25.0 + 1e-4))
    _numpy_only(monkeypatch)
    got_numpy = range_filter(cloud, 5.0, 25.0)
    np.testing.assert_array_equal(got_native, got_numpy)


def test_preprocess_pads_and_weights(cloud):
    pts, w = preprocess_scan(cloud, max_points=30000, voxel=2.0)
    assert pts.shape == (30000, 4) and w.shape == (30000,)
    n_real = int(np.sum(w > 0))
    assert 0 < n_real < 30000
    assert np.all(pts[n_real:] == 0.0)
    ref = jio.preprocess_scan(cloud, max_points=30000, voxel=2.0)
    np.testing.assert_array_equal(pts, ref[0])
    np.testing.assert_array_equal(w, ref[1])


def test_dataset_prefetch(tmp_path, cloud):
    for i in range(6):
        save_bin(str(tmp_path / f"{i:03d}.bin"), cloud[i * 100:(i + 1) * 100])
    ds = ScanDataset.from_dir(str(tmp_path), max_points=128, voxel=None,
                              workers=2, prefetch=3)
    scans = list(ds)
    assert len(scans) == 6
    for pts, w in scans:
        assert pts.shape == (128, 4)
        assert int(np.sum(w)) == 100
    batches = list(ds.batches(2))
    assert len(batches) == 3
    assert batches[0][0].shape == (2, 128, 4)
    # prefetch=0 still yields every scan
    assert len(list(ScanDataset.from_dir(str(tmp_path), max_points=128, prefetch=0))) == 6


def test_dataset_feeds_solver(tmp_path, target_np, source_np):
    """End to end: scans from disk through the loader into the solver."""
    np.save(str(tmp_path / "000.npy"), source_np.astype(np.float32))
    ds = ScanDataset.from_dir(str(tmp_path), max_points=80)
    pts, w = next(iter(ds))
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=50,
                    tolerance=1e-10, dim=2, trim_dist=5.0,
                    loss_name="huber", loss_metric=1.0)
    res = register_jit(torch.as_tensor(pts[None, :, :3], dtype=torch.float64),
                       torch.as_tensor(target_np[None]),
                       torch.eye(4, dtype=torch.float64)[None],
                       torch.as_tensor(w[None], dtype=torch.float64), cfg=cfg)
    assert bool(res.converged[0])


def test_preprocess_subsamples_evenly():
    """Oversized scans are stride-subsampled, not head-truncated."""
    pts = np.zeros((1000, 3), np.float32)
    pts[:, 0] = np.arange(1000)  # ordered along x
    out, w = preprocess_scan(pts, max_points=100)
    assert out.shape == (100, 3)
    assert out[:, 0].max() > 900 and out[:, 0].min() < 100
    assert np.all(w == 1.0)


def test_voxel_downsample_host_extent_guard():
    """Clouds spanning more than 2**21 cells per axis would alias hash keys;
    they raise instead."""
    pts = np.zeros((2, 3), np.float32)
    pts[1, 0] = (1 << 21) * 0.1 + 1.0  # > 2**21 cells apart at voxel=0.1
    with pytest.raises(ValueError, match="2\\*\\*21"):
        voxel_downsample_host(pts, 0.1)
    out = voxel_downsample_host(np.array([[0.0, 0, 0], [1e4, 0, 0]], np.float32), 0.1)
    assert out.shape[0] == 2
