"""The port's four examples (``dicp_tpu_torch.examples``): each imports
without JAX, their scene generators equal their JAX twins' in
``examples/``, and the large-cloud demo runs its checks on the CPU at a
small size.  The odometry, serving and SLAM demos take longer than 10 s on
the CPU at their sizes (the SLAM demo's smallest circuit, one lap, also
misses its refined-ATE check: one closure at the lap's end); they run on
the card in chip_smoke.py's phase 22."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dicp_tpu_torch.examples import (large_cloud_demo, odometry_demo,  # noqa: E402
                                     slam_demo)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("large_cloud_demo", "odometry_demo", "serving_demo", "slam_demo")


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_without_jax(name):
    code = (f"import sys, dicp_tpu_torch.examples.{name} as m\n"
            "assert callable(m.main)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'dicp_tpu', 'benchmarks'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_scene_generators_equal_the_jax_examples():
    jl, jo, js = (_jax_example(n) for n in ("large_cloud_demo", "odometry_demo", "slam_demo"))
    np.testing.assert_array_equal(large_cloud_demo.make_scene(), jl.make_scene())
    np.testing.assert_array_equal(odometry_demo.make_scene(np.random.default_rng(0)),
                                  jo.make_scene(np.random.default_rng(0)))
    np.testing.assert_array_equal(slam_demo.make_world(), js.make_world())
    scans, poses, T0 = slam_demo.make_scans(1, dtype=np.float64)
    j_scans, j_poses, j_T0 = js.make_scans(1)
    assert len(scans) == len(j_scans) == 33
    for a, b in zip(scans, j_scans):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(poses, j_poses)
    np.testing.assert_array_equal(T0, j_T0)


def test_large_cloud_demo_checks_pass_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(large_cloud_demo, "N", 6000)
    out = large_cloud_demo.main("cpu")
    assert out["transform_err"] < 1e-3 and out["certified_pct"] > 99.0
    text = capsys.readouterr().out
    assert "registered 6000 vs 6000" in text and "certified-exact" in text
