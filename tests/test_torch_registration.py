"""Parity of the PyTorch port's solver and API with the JAX package: the
reference contracts (transform error <= 1e-10 on the reference pair,
batch == serial, ragged/empty/weighted inputs), pt2pt and symmetric ICP, the
kernel tier end to end, gradients through the loop, and the rule that the
port never imports JAX.  Same numpy inputs through both, f64 on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dicp_tpu import se3 as jse3  # noqa: E402
from dicp_tpu.api import ICP as JICP  # noqa: E402
from dicp_tpu.config import ICPConfig as JConfig  # noqa: E402
from dicp_tpu.registration import register_jit as jregister  # noqa: E402

from dicp_tpu_torch import ICP, ICPConfig, register, se3  # noqa: E402
from dicp_tpu_torch.api import batch_size_handling  # noqa: E402
from dicp_tpu_torch.ICP import ICP as ICP_shim  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HUBER = {"name": "huber", "metric": 1.0}
XI_REF = [1.0, 1.0, 0.0, 0.0, 0.0, 0.1]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _truth():
    """The reference tests' ground truth, inv(vec2tran([1, 1, 0, 0, 0, 0.1]))."""
    return se3.tran_inv(se3.vec2tran(torch.tensor(XI_REF, dtype=torch.float64)))


def _err(T_a, T_b):
    """|tran2vec(T_a T_b^-1)| per batch element."""
    T_a, T_b = _t(T_a).double(), _t(T_b).double()
    return torch.linalg.vector_norm(se3.tran2vec(T_a @ torch.linalg.inv(T_b)), dim=-1)


def _moved(scene, xi):
    """Scene (n, 6) moved by vec2tran(xi): (points, normals, T)."""
    T = np.asarray(jse3.vec2tran(jnp.asarray(xi)))
    return scene[:, :3] @ T[:3, :3].T + T[:3, 3], scene[:, 3:6] @ T[:3, :3].T, T


# ---------------------------------------------------------------- reference pair

@pytest.mark.parametrize("driver", ["scan", "while"])
def test_reference_pair_matches_jax(source_np, target_np, driver):
    """pt2pl, dim 2, trim 5, huber: T against JAX and against the truth within
    1e-10; sliced histories and stats equal to the JAX driver's."""
    kw = dict(icp_type="pt2pl", differentiable=(driver == "scan"), max_iterations=100,
              tolerance=1e-10)
    call = dict(trim_dist=5.0, loss_fn=HUBER, dim=2)
    res_j = JICP(**kw).icp(jnp.asarray(source_np[:, :3]), jnp.asarray(target_np),
                           jnp.eye(4), **call)
    res_t = ICP(**kw, device="cpu").icp(source_np[:, :3], target_np, np.eye(4), **call)
    np.testing.assert_allclose(res_t["T"].numpy(), np.asarray(res_j["T"]), rtol=0, atol=1e-10)
    assert float(_err(_truth(), res_t["T"][0])) < 1e-10
    for key in ("costs", "deltas", "weights"):
        assert res_t[key].shape == np.asarray(res_j[key]).shape, key
        np.testing.assert_allclose(res_t[key].numpy(), np.asarray(res_j[key]),
                                   rtol=1e-9, atol=1e-12, err_msg=key)
    for key in ("converged", "iterations", "matched_ratio"):
        np.testing.assert_array_equal(res_t["stats"][key].numpy(),
                                      np.asarray(res_j["stats"][key]), err_msg=key)
    np.testing.assert_allclose(res_t["pc"][0].numpy(), target_np[:, :3], atol=1e-5)


def test_results_dict_contract(source_np, target_np):
    res = ICP_shim(icp_type="pt2pl", max_iterations=25, tolerance=1e-8).icp(
        _t(source_np[:, :3]), _t(target_np), torch.eye(4, dtype=torch.float64),
        trim_dist=5.0, loss_fn=HUBER, dim=2)
    assert set(res) == {"pc", "T", "costs", "deltas", "weights", "stats"}
    assert set(res["stats"]) == {"converged", "iterations", "matched_ratio"}
    it, n = res["deltas"].shape[1], source_np.shape[0]
    assert res["pc"].shape == (1, n, 3) and res["T"].shape == (1, 4, 4)
    assert res["deltas"].shape == (1, it, 6, 1) and res["weights"].shape == (1, it, n, 1)
    assert res["costs"].shape == (1, it, 1)
    assert bool(res["stats"]["converged"][0]) and 1 <= it <= 25
    assert not res["costs"].requires_grad and not res["stats"]["iterations"].requires_grad


@pytest.mark.parametrize("icp_type", ["pt2pt", "symmetric"])
def test_pt2pt_and_symmetric_match_jax(planes_scene, icp_type):
    """Full 6-DOF scene: T against JAX within 1e-10, and against the truth."""
    pts, nrm, T_st = _moved(planes_scene, [0.3, -0.2, 0.1, 0.04, -0.02, 0.05])
    cols = 3 if icp_type == "pt2pt" else 6
    source = np.hstack([pts, nrm])[None, :, :cols]
    target = planes_scene[None, :, :cols]
    kw = dict(icp_type=icp_type, differentiable=False, max_iterations=60, tolerance=1e-12,
              dim=3, trim_dist=2.0, loss_name="huber", loss_metric=1.0)
    res_j = jregister(jnp.asarray(source), jnp.asarray(target), jnp.eye(4)[None], None,
                      cfg=JConfig(**kw))
    res_t = register(_t(source), _t(target), torch.eye(4, dtype=torch.float64)[None],
                     None, ICPConfig(**kw))
    np.testing.assert_allclose(res_t.T.numpy(), np.asarray(res_j.T), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(res_t.iterations.numpy(), np.asarray(res_j.iterations))
    assert float(_err(np.linalg.inv(T_st), res_t.T[0])) < 1e-9


def test_kernel_tier_slice_matches_jax(planes_scene):
    """The slice on its kernel tier: JAX runs the Pallas kernel (interpret
    mode), the port the kernel's plain version; T within 1e-9."""
    pts, _, T_st = _moved(planes_scene, [0.2, -0.1, 0.15, 0.03, -0.02, 0.04])
    kw = dict(icp_type="pt2pl", differentiable=False, max_iterations=40, tolerance=1e-10,
              dim=3, trim_dist=2.0, loss_name="huber", loss_metric=0.5, nn_method="pallas")
    res_j = jregister(jnp.asarray(pts[None]), jnp.asarray(planes_scene[None]),
                      jnp.eye(4)[None], None, cfg=JConfig(**kw))
    res_t = register(_t(pts[None]), _t(planes_scene[None]),
                     torch.eye(4, dtype=torch.float64)[None], None, ICPConfig(**kw))
    np.testing.assert_allclose(res_t.T.numpy(), np.asarray(res_j.T), rtol=0, atol=1e-9)
    assert float(_err(np.linalg.inv(T_st), res_t.T[0])) < 1e-9


@pytest.mark.parametrize("P", [300, 9000])
def test_normal_equations_and_damping_match_jax(P):
    """Both the flat and the two-level chunked accumulation (P > 4096), and
    the relative damping in both dtypes, within 1e-12 relative."""
    from dicp_tpu import registration as jreg
    from dicp_tpu_torch import registration as treg

    rng = np.random.default_rng(P)
    J, r = rng.normal(size=(2, P, 6)), rng.normal(size=(2, P))
    A_t, b_t = treg._normal_equations(_t(J), _t(r))
    A_j, b_j = jreg._normal_equations(jnp.asarray(J), jnp.asarray(r))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-12, atol=1e-9)
    for dtype, np_dtype in ((torch.float64, np.float64), (torch.float32, np.float32)):
        A = np.asarray(A_j).astype(np_dtype)
        for cfg_kw in ({}, {"tikhonov": 1e-9}):
            d_t = treg._damping(ICPConfig(**cfg_kw), _t(A).to(dtype))
            d_j = jreg._damping(JConfig(**cfg_kw), jnp.asarray(A))
            np.testing.assert_allclose(np.broadcast_to(d_t.numpy(), (2, 1, 1)),
                                       np.broadcast_to(np.asarray(d_j), (2, 1, 1)),
                                       rtol=1e-6)


# ---------------------------------------------------------------- solver properties

def _three_pairs(source_np, target_np):
    rng = np.random.default_rng(42)
    sources = [np.vstack([source_np[:50, :3], rng.random((1, 3)) * 1000]),
               source_np[:, :3], source_np[:55, :3]]
    targets = [target_np[:55], target_np, target_np[:60]]
    return sources, targets


def test_ragged_batch_equals_serial_and_jax(source_np, target_np):
    """Ragged list batch == per-cloud serial solves (T and matched ratio),
    and == the JAX package's ragged batch."""
    sources, targets = _three_pairs(source_np, target_np)
    kw = dict(icp_type="pt2pl", differentiable=True, max_iterations=25, tolerance=1e-8)
    solver = ICP(**kw, device="cpu")
    serial = [solver.icp(s, t, np.eye(4), trim_dist=5.0, loss_fn=HUBER, dim=2)
              for s, t in zip(sources, targets)]
    batch = solver.icp(sources, targets, np.stack([np.eye(4)] * 3), trim_dist=5.0,
                       loss_fn=HUBER, dim=2)
    T_serial = torch.cat([r["T"] for r in serial])
    assert float(_err(T_serial, batch["T"]).max()) < 1e-8
    ratio_serial = torch.cat([r["stats"]["matched_ratio"] for r in serial])
    assert float(torch.linalg.norm(ratio_serial - batch["stats"]["matched_ratio"])) < 1e-8
    res_j = JICP(**kw).icp([jnp.asarray(s) for s in sources],
                           [jnp.asarray(t) for t in targets], jnp.eye(4),
                           trim_dist=5.0, loss_fn=HUBER, dim=2)
    np.testing.assert_allclose(batch["T"].numpy(), np.asarray(res_j["T"]), rtol=0, atol=1e-10)


def test_batch_chunk_equals_unchunked(source_np, target_np):
    sources, targets = _three_pairs(source_np, target_np)
    src, tgt, _, w = batch_size_handling(sources, targets, device="cpu")
    ti = torch.eye(4, dtype=torch.float64).expand(3, 4, 4)
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                    tolerance=1e-10, dim=2, trim_dist=5.0, loss_name="huber")
    whole = register(src, tgt, ti, w, cfg)
    chunked = register(src, tgt, ti, w, cfg.with_(batch_chunk=2))
    for a, b, name in zip(whole, chunked, whole._fields):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-12, err_msg=name)


def test_zero_inputs_return_T_init(source_np, target_np):
    solver = ICP(icp_type="pt2pl", max_iterations=25, tolerance=1e-8, device="cpu")
    for s, t in ((source_np, []), ([], target_np), ([], [])):
        res = solver.icp(s, t, np.eye(4), trim_dist=5.0, dim=2)
        assert float(torch.linalg.norm(res["T"][0] - torch.eye(4))) < 1e-8
    T_stack = np.stack([np.eye(4)] * 3)
    res = solver.icp([_t(source_np), [], []], [[], _t(target_np), []], T_stack,
                     trim_dist=5.0, dim=2)
    np.testing.assert_allclose(res["T"].numpy(), T_stack, atol=1e-8)
    # batched T_init through the phony path comes back unchanged
    t1 = se3.vec2tran(torch.tensor([0.1, 0.2, 0, 0, 0, 0.3])).numpy()
    ti = np.stack([np.eye(4), t1]).astype(np.float32)
    res = ICP(icp_type="pt2pl", max_iterations=10, tolerance=1e-8,
              device="cpu").icp([], [], ti, dim=2)
    np.testing.assert_allclose(res["T"].numpy(), ti, atol=1e-6)


def test_weight_inputs(source_np, target_np):
    """weight=None == ones; zero-weighted junk points change nothing; list
    weights batch == serial."""
    rng = np.random.default_rng(7)
    sources = [source_np[:, :3], source_np[:, :3],
               np.vstack([source_np[:, :3], rng.random((10, 3))])]
    weights = [None, np.ones(source_np.shape[0]),
               np.hstack([np.ones(source_np.shape[0]), np.zeros(10)])]
    solver = ICP(icp_type="pt2pl", max_iterations=25, tolerance=1e-8, device="cpu")
    call = dict(trim_dist=5.0, loss_fn=HUBER, dim=2)
    serial = torch.cat([solver.icp(s, target_np, np.eye(4), weight=w, **call)["T"]
                        for s, w in zip(sources, weights)])
    batch = solver.icp(sources, [target_np] * 3, np.stack([np.eye(4)] * 3),
                       weight=weights, **call)["T"]
    assert float(torch.linalg.norm(batch - serial)) < 1e-8
    assert float(torch.linalg.norm(serial[0] - serial[2])) < 1e-8


def test_padded_source_and_const_iter(source_np, target_np):
    solver = ICP(icp_type="pt2pt", differentiable=False, max_iterations=25, tolerance=1e-8,
                 device="cpu")
    solver.source_zeroes_are_pad = True
    src = source_np[:50, :3]
    T_a = solver.icp(src, target_np[:55], np.eye(4), dim=2)["T"]
    T_b = solver.icp(np.vstack([src, np.zeros((20, 3))]), target_np[:55], np.eye(4),
                     dim=2)["T"]
    assert float(_err(T_a, T_b)) < 1e-8
    solver = ICP(icp_type="pt2pl", max_iterations=12, tolerance=1e-8, device="cpu")
    solver.const_iter = True
    res = solver.icp(source_np[:, :3], target_np, np.eye(4), trim_dist=5.0,
                     loss_fn=HUBER, dim=2)
    assert res["deltas"].shape[1] == 12 and float(res["stats"]["iterations"][0]) == 12.0


def test_negative_coordinate_ragged_targets(source_np, target_np):
    """Ragged targets repeat their last row (never a far or origin sentinel):
    an all-negative scene still recovers the shift-conjugated truth."""
    shift = np.array([-60.0, -60.0, 0.0])
    src = source_np[:, :3] + shift
    tgt = np.hstack([target_np[:, :3] + shift, target_np[:, 3:6]])
    _, tgt_b, _, _ = batch_size_handling([src[:51], src], [tgt[:55], tgt], device="cpu")
    np.testing.assert_array_equal(tgt_b[0, 55:].numpy(), np.repeat(tgt[54:55], 10, 0))
    res = ICP(icp_type="pt2pl", differentiable=False, max_iterations=50,
              tolerance=1e-10, device="cpu").icp([src[:51], src], [tgt[:55], tgt], np.eye(4),
                                   trim_dist=5.0, loss_fn=HUBER, dim=2)
    tr = torch.eye(4, dtype=torch.float64)
    tr[:3, 3] = _t(shift)
    t_true = tr @ _truth() @ se3.tran_inv(tr)
    assert float(_err(t_true, res["T"][1])) < 1e-6


def test_input_errors(source_np, target_np):
    src3 = np.stack([source_np[:, :3]] * 3)
    with pytest.raises(ValueError, match="batch length"):
        batch_size_handling(src3, [target_np, target_np], device="cpu")
    with pytest.raises(ValueError, match="weight"):
        batch_size_handling([source_np[:, :3]] * 2, [target_np] * 2, weight=[np.ones(65)],
                            device="cpu")
    with pytest.raises(ValueError, match="rows"):
        batch_size_handling(src3, np.stack([target_np] * 3), weight=np.ones((2, 65)),
                            device="cpu")
    with pytest.raises(ValueError, match="pt2pl requires target normals"):
        ICP(icp_type="pt2pl", device="cpu").icp(source_np[:, :3], target_np[:, :3], np.eye(4))
    with pytest.raises(ValueError, match="dim"):
        ICP(device="cpu").icp(source_np[:, :3], target_np, np.eye(4), dim=4)
    with pytest.raises(ValueError, match="different devices"):
        batch_size_handling(_t(source_np[:, :3]), torch.zeros(65, 6, device="meta"))
    with pytest.raises(ValueError, match="asked for"):
        ICP(device="meta").icp(_t(source_np[:, :3]), _t(target_np), np.eye(4))
    # the cluster tier is ported (nn_method='cluster', and auto at m >= 16384);
    # fused_small=True is accepted as in JAX, and on a cluster-tier problem
    # the gate is false and the loop runs
    res = ICP(icp_type="pt2pt", max_iterations=3, device="cpu", fused_small=True,
              differentiable=False, driver="while", collect_histories=False).icp(
        np.zeros((1100, 3)), np.ones((16384, 3)), np.eye(4))
    assert res["T"].shape == (1, 4, 4) and bool(torch.isfinite(res["T"]).all())


def test_numpy_inputs_follow_the_solver_device(source_np, target_np):
    """Numpy inputs go to ICP(device=...), the card by default (without one
    that raises: there is no CPU continuation); device="cpu" puts them on the
    CPU; tensors keep theirs."""
    src, tgt, ti, w = batch_size_handling(source_np[:, :3], target_np, np.eye(4),
                                          device="cpu")
    assert {x.device.type for x in (src, tgt, ti, w)} == {"cpu"}
    res = ICP(device="cpu", max_iterations=3).icp(source_np[:, :3], target_np, np.eye(4))
    assert res["T"].device.type == "cpu"
    if torch.cuda.is_available():
        src, _, _, _ = batch_size_handling(source_np[:, :3], target_np, np.eye(4))
        assert src.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            batch_size_handling(source_np[:, :3], target_np, np.eye(4))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ICP().icp(source_np[:, :3], target_np, np.eye(4))
    src, tgt, ti, w = batch_size_handling(torch.zeros(5, 3, device="meta"),
                                          torch.zeros(6, 6, device="meta"), np.eye(4))
    assert {x.device.type for x in (src, tgt, ti, w)} == {"meta"}


# ---------------------------------------------------------------- gradients and options

def test_scan_driver_gradient_finite_and_nonzero(source_np, target_np):
    """Autograd of sum(T) through the loop reaches both clouds, finite and
    non-zero, at an exact fixed point (residuals exactly 0.0)."""
    src = _t(source_np[:, :3]).requires_grad_(True)
    tgt = _t(target_np).requires_grad_(True)
    solver = ICP(icp_type="pt2pl", differentiable=True, max_iterations=25, tolerance=1e-8)
    res = solver.icp(src, tgt, torch.eye(4, dtype=torch.float64), trim_dist=5.0,
                     loss_fn=HUBER, dim=2)
    gs, gt = torch.autograd.grad(res["T"].sum(), (src, tgt))
    for g in (gs, gt):
        assert torch.isfinite(g).all() and bool((g != 0).any())


def test_remat_lu_and_histories_off_match(source_np, target_np):
    """remat recomputes each iteration in the backward pass (same T, same
    gradient); the LU solve agrees with the closed form; histories off keep
    T and the final weights/costs."""
    src0 = _t(source_np[None, :, :3])
    tgt = _t(target_np[None])
    ti = torch.eye(4, dtype=torch.float64)[None]
    cfg = ICPConfig(icp_type="pt2pl", max_iterations=25, tolerance=1e-8, dim=2,
                    trim_dist=5.0, loss_name="huber")
    outs = []
    for c in (cfg, cfg.with_(remat=True)):
        src = src0.clone().requires_grad_(True)
        res = register(src, tgt, ti, None, c)
        outs.append((res.T.detach(), torch.autograd.grad(res.T.sum(), src)[0]))
    assert torch.equal(outs[0][0], outs[1][0])
    np.testing.assert_allclose(outs[1][1].numpy(), outs[0][1].numpy(), rtol=0, atol=1e-12)

    full = register(src0, tgt, ti, None, cfg)
    lu = register(src0, tgt, ti, None, cfg.with_(solve_method="lu"))
    np.testing.assert_allclose(lu.T.numpy(), full.T.numpy(), rtol=0, atol=1e-10)
    slim = register(src0, tgt, ti, None, cfg.with_(collect_histories=False))
    assert torch.equal(slim.T, full.T) and torch.equal(slim.iterations, full.iterations)
    k = int(full.iterations.max()) - 1
    assert slim.weights.shape[1] == 1 and slim.costs.shape[1] == 1
    assert torch.equal(slim.weights[:, 0], full.weights[:, k])
    assert torch.equal(slim.costs[:, 0], full.costs[:, k])


def test_port_never_imports_jax():
    """In a fresh interpreter: import the port, run a small solve on each
    tier, the normals on both large-cloud paths and a small stream_odometry
    (with the odometry, SVD-ICP, pipeline, io and voxel modules imported),
    then a small scan_to_map_odometry (with sgd_icp and mapping imported)
    and a small GICP and pyramid solve (with gicp, multiscale and slam
    imported), then a map-sharded solve in a world of one gloo rank (with
    parallel imported), and find neither jax nor the JAX package in
    sys.modules."""
    code = (
        "import sys, numpy as np\n"
        "import dicp_tpu_torch\n"
        "from dicp_tpu_torch import ICP\n"
        "scan = np.load('tests/data/points_scan.npy')\n"
        "mp = np.load('tests/data/points_map.npy')\n"
        "import dicp_tpu_torch.ops.normals, dicp_tpu_torch.ops.cluster_search\n"
        "for method in ('dense', 'pallas', 'cluster'):\n"
        "    res = ICP(icp_type='pt2pl', nn_method=method, max_iterations=20,\n"
        "              tolerance=1e-8, device='cpu').icp(scan[:, :3], mp, np.eye(4), trim_dist=5.0,\n"
        "                                  loss_fn={'name': 'huber', 'metric': 1.0}, dim=2)\n"
        "    assert res['T'].shape == (1, 4, 4)\n"
        "import torch\n"
        "pts = torch.as_tensor(mp[:, :3])\n"
        "for method in ('weighted', 'cluster'):\n"
        "    assert dicp_tpu_torch.estimate_normals(pts, method=method).shape == (65, 3)\n"
        "import dicp_tpu_torch.odometry, dicp_tpu_torch.svd_icp, dicp_tpu_torch.pipeline\n"
        "import dicp_tpu_torch.io, dicp_tpu_torch.ops.voxel\n"
        "scans = [mp, mp + [0.05, 0.02, 0, 0, 0, 0], mp + [0.1, 0.04, 0, 0, 0, 0]]\n"
        "odo = dicp_tpu_torch.stream_odometry(((s, None) for s in scans),\n"
        "    dicp_tpu_torch.ICPConfig(max_iterations=10, dim=2), window=2, device='cpu')\n"
        "assert odo.poses.shape == (3, 4, 4)\n"
        "import dicp_tpu_torch.sgd_icp, dicp_tpu_torch.mapping\n"
        "s2m = dicp_tpu_torch.scan_to_map_odometry(((s, None) for s in scans),\n"
        "    dicp_tpu_torch.ICPConfig(icp_type='pt2pt', max_iterations=10,\n"
        "                             collect_histories=False), capacity=256, device='cpu')\n"
        "assert s2m.poses.shape == (3, 4, 4) and s2m.converged.shape == (3,)\n"
        "import dicp_tpu_torch.gicp, dicp_tpu_torch.multiscale, dicp_tpu_torch.slam\n"
        "src = torch.as_tensor(mp[None, :, :3]); eye = torch.eye(4, dtype=src.dtype)[None]\n"
        "g = dicp_tpu_torch.register_gicp(src, src, eye, max_iterations=3)\n"
        "assert g.T.shape == (1, 4, 4)\n"
        "ms = dicp_tpu_torch.register_multiscale(src, torch.as_tensor(mp[None]), eye, None,\n"
        "    dicp_tpu_torch.ICPConfig(max_iterations=5, dim=2, collect_histories=False),\n"
        "    (dicp_tpu_torch.ScaleLevel(0.5, 32, 32, 3, 1e-4), dicp_tpu_torch.ScaleLevel(0.0)))\n"
        "assert ms.level_T.shape == (2, 1, 4, 4)\n"
        "import dicp_tpu_torch.parallel, torch.distributed as dist\n"
        "from dicp_tpu_torch.parallel import make_mesh, register_map_sharded\n"
        "mesh = make_mesh((1, 1), devices='cpu')\n"
        "r = register_map_sharded(mesh, scan[:, :3], mp, cfg=dicp_tpu_torch.ICPConfig(\n"
        "    max_iterations=20, tolerance=1e-8, dim=2, trim_dist=5.0))\n"
        "assert r.T.shape == (4, 4) and bool(r.converged) and dist.get_backend() == 'gloo'\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dicp_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
