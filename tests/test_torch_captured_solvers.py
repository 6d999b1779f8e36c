"""The Anderson, mapping, SLAM and SVD-ICP programs that run captured on
the card: ``register_anderson_jit``, ``map_merge``,
``map_step`` (``gn``), ``slam._closure_solve``, ``slam._make_anchor``,
``slam._edge_residual_norms`` and ``pt2pt_svd_icp`` (``svd_icp._svd_icp_impl``).

On the CPU each runs uncaptured, its early-exit loops the device-loop
bodies (a masked body over a state held in tensors, run by
``jit.device_while`` in a host loop; chip_smoke.py phase 24 holds the
captured programs to these on the card).  Held here, in f64, to JAX's
compiled programs (T within 1e-10; iterations, convergence and matched
ratio equal; maps as ``tests/test_torch_mapping.py`` holds them) and to the
port's eager forms bit for bit: the solves of ``map_step`` and
``_closure_solve`` on ``register``'s host loop, and, for SVD-ICP, the
unmasked loop the masked body replaced.  Each batch holds an element that
never converges; one more masked body changes no bit; the loops' iteration
counts are 0-dim int32 tensors.  Sizes stay small: 150-point batches,
four 1,500-point scans, a 2,048-row map.

Weighted normals of sparse scans differ between JAX's eager and jitted
calls on near-degenerate points (``tests/test_torch_mapping.py``), so the
map and anchor cases hand the port JAX's jitted normals."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import mapping as jm  # noqa: E402
from dicp_tpu import se3 as jse3  # noqa: E402
from dicp_tpu import slam as js  # noqa: E402
from dicp_tpu import svd_icp as jsvd  # noqa: E402
from dicp_tpu.anderson import register_anderson_jit as j_anderson  # noqa: E402
from dicp_tpu.config import ICPConfig as JConfig  # noqa: E402
from dicp_tpu.ops.normals import estimate_normals_weighted as j_weighted  # noqa: E402

from dicp_tpu_torch import ICPConfig, anderson, register, register_anderson  # noqa: E402
from dicp_tpu_torch import register_anderson_jit, register_jit, svd_icp  # noqa: E402
from dicp_tpu_torch import jit as jit_mod  # noqa: E402
from dicp_tpu_torch import mapping as tm  # noqa: E402
from dicp_tpu_torch import slam as ts  # noqa: E402
from dicp_tpu_torch.convert import config_from_dict  # noqa: E402
from dicp_tpu_torch.mapping import LocalMap, empty_map, map_merge, map_step  # noqa: E402

from tests.test_mapping import CFG as JCFG_MAP  # noqa: E402
from tests.test_mapping import _sequence  # noqa: E402
from tests.test_torch_mapping import _assert_maps_match  # noqa: E402

# the second pair starts far off and gets too few iterations to converge
MOTIONS = ([0.01, -0.01, 0.02, 0.002, -0.001, 0.003], [1.5, -1.0, 1.0, 0.5, -0.4, 0.6])
MAX_ITERATIONS = 6
CAP, N_SCAN, VOXEL = 2048, 1500, 0.25
_J_WEIGHTED = jax.jit(j_weighted)


def _assert_bit_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _closure_vars(fn) -> dict:
    """The variables a closure (a loop body) reads from its enclosing call."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def _one_more(seen: list):
    """A device_while that runs one more body after the flag has fallen and
    keeps the body's closure (its state, iteration counter and flag)."""
    def run(flag, body):
        while bool(flag):
            body()
        body()
        seen.append(_closure_vars(body))
    return run


@pytest.fixture(scope="module")
def batch():
    """(source (2, 150, 6), target (2, 150, 6), T_init (2, 4, 4)) f64: three
    planes of 50 points with their normals, moved by MOTIONS."""
    rng = np.random.default_rng(7)
    normals = np.eye(3)[[2, 0, 1]]
    pts = []
    for k in range(3):
        uv = rng.uniform(-5, 5, size=(50, 2))
        basis = np.eye(3)[[i for i in range(3) if normals[k][i] == 0]]
        pts.append(uv @ basis + normals[k] * (2.0 + k))
    scene = np.hstack([np.vstack(pts), np.repeat(normals, 50, axis=0)])
    sources, targets = [], []
    for xi in MOTIONS:
        T = np.asarray(jse3.vec2tran(jnp.asarray(xi)))
        sources.append(np.hstack([scene[:, :3] @ T[:3, :3].T + T[:3, 3],
                                  scene[:, 3:] @ T[:3, :3].T]))
        targets.append(scene)
    return np.stack(sources), np.stack(targets), np.stack([np.eye(4)] * len(MOTIONS))


def _tensors(batch):
    return tuple(torch.as_tensor(a) for a in batch)


# --- Anderson ---------------------------------------------------------------

AA_CASES = {
    "dense-pt2pl": dict(nn_method="dense", icp_type="pt2pl"),
    "dense-pt2pt": dict(nn_method="dense", icp_type="pt2pt"),
    "tiled-pt2pl": dict(nn_method="pallas", icp_type="pt2pl"),
    "cluster-pt2pl": dict(nn_method="cluster", icp_type="pt2pl", cluster_group=16,
                          cluster_probes=4),
}


def _aa_config(kw):
    return dict(differentiable=False, max_iterations=MAX_ITERATIONS, tolerance=1e-9, dim=3,
                trim_dist=3.0, loss_name="huber", loss_metric=1.0, collect_histories=False,
                **kw)


@pytest.mark.parametrize("case", list(AA_CASES))
def test_anderson_matches_jax_and_every_entry(batch, case):
    """register_anderson_jit against JAX's compiled program; the port's
    register_anderson, register and register_jit with anderson_m = 3 (the
    routes a captured solve takes) give its bits."""
    kw = _aa_config(AA_CASES[case])
    ref = j_anderson(*(jnp.asarray(a) for a in batch), None, JConfig(**kw), 3)
    cfg = ICPConfig(**kw)
    got = register_anderson_jit(*_tensors(batch), None, cfg, 3)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=0, atol=1e-10)
    for name in ("iterations", "converged", "matched_ratio"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert got.converged.tolist() == [True, False]
    assert float(got.iterations[1]) == MAX_ITERATIONS > float(got.iterations[0])
    _assert_bit_equal(register_anderson(*_tensors(batch), None, cfg, 3), got)
    cfg3 = cfg.with_(anderson_m=3)
    for entry in (register, register_jit):
        _assert_bit_equal(entry(*_tensors(batch), None, cfg3), got)


def test_anderson_extra_masked_body_changes_no_bit(batch, monkeypatch):
    """One more body after the flag fell leaves every output as it was; the
    loop's counter is a 0-dim int32 tensor holding the executed count."""
    cfg = ICPConfig(**_aa_config(AA_CASES["dense-pt2pl"]))
    plain = register_anderson(*_tensors(batch), None, cfg, 3)
    seen = []
    monkeypatch.setattr(anderson, "device_while", _one_more(seen))
    _assert_bit_equal(register_anderson(*_tensors(batch), None, cfg, 3), plain)
    (state,) = seen
    it, flag = state["it"], state["flag"]
    assert it.dtype == torch.int32 and it.dim() == 0 and int(it) == MAX_ITERATIONS
    assert flag.dtype == torch.bool and not bool(flag)


def test_anderson_singular_history_continues_as_jax():
    """A history whose Gram matrix is singular: JAX's solve returns what LU
    gives and the loop runs on; the port's solve_ex(check_errors=False)
    does the same (torch.linalg.solve raised here), in f32 as the tiled
    tier runs it."""
    scan = np.load("tests/data/points_scan.npy")
    mp = np.load("tests/data/points_map.npy")
    rng = np.random.default_rng(1)
    src = np.stack([scan[:, :3], scan[:, :3] + rng.normal(scale=0.3, size=scan[:, :3].shape)])
    src, tgt = src.astype(np.float32), np.stack([mp, mp]).astype(np.float32)
    ti = np.stack([np.eye(4)] * 2).astype(np.float32)
    kw = dict(differentiable=False, max_iterations=40, tolerance=1e-10, trim_dist=5.0,
              loss_name="huber", collect_histories=False, icp_type="pt2pl", dim=2,
              nn_method="pallas")
    ref = j_anderson(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ti), None, JConfig(**kw), 3)
    got = register_anderson(torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(ti),
                            None, ICPConfig(**kw), 3)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=0, atol=1e-5)
    for name in ("iterations", "converged"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)


# --- SVD-ICP ----------------------------------------------------------------

def _svd_unmasked(source, target, max_iterations, tolerance, differentiable):
    """The loop the masked body replaced: a step per iteration, exit on the
    host once every element has converged (early exit only)."""
    dtype = source.dtype
    N, n = source.shape[:2]
    weight = torch.ones((N, n), dtype=dtype)
    C, r = torch.eye(3, dtype=dtype).expand(N, 3, 3), torch.zeros((N, 3), dtype=dtype)
    converged = torch.zeros((N,), dtype=torch.bool)
    iters = torch.zeros((N,), dtype=torch.int32)
    for it in range(max_iterations):
        if not differentiable and bool(torch.all(converged)):
            break
        ps_t = torch.einsum("nij,npj->npi", C, source) + r[:, None, :]
        nn_t = svd_icp.knn.hard_nn(ps_t, target)
        dC, dr = svd_icp._kabsch(ps_t, nn_t, weight)
        C_new = dC @ C
        r_new = torch.einsum("nij,nj->ni", dC, r) + dr
        ps_new = torch.einsum("nij,npj->npi", C_new, source) + r_new[:, None, :]
        below = torch.sum(weight * torch.sum((ps_new - nn_t) ** 2, dim=-1), dim=-1) < tolerance
        iters = torch.where(below & ~converged, torch.full_like(iters, it + 1), iters)
        C = torch.where(converged[:, None, None], C, C_new)
        r = torch.where(converged[:, None], r, r_new)
        converged = converged | below
    iters = torch.where(converged, iters, torch.full_like(iters, max_iterations))
    return svd_icp.se3._homogeneous(C, r), converged, iters


@pytest.mark.parametrize("differentiable", [False, True])
def test_svd_icp_matches_jax_and_the_unmasked_loop(batch, differentiable):
    src, tgt = batch[0][..., :3], batch[1][..., :3]
    kw = dict(max_iterations=MAX_ITERATIONS, tolerance=1e-20, differentiable=differentiable)
    ref = jsvd.pt2pt_svd_icp(jnp.asarray(src), jnp.asarray(tgt), **kw)
    got = svd_icp.pt2pt_svd_icp(torch.as_tensor(src), torch.as_tensor(tgt), device="cpu", **kw)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=0, atol=1e-10)
    for name in ("iterations", "converged"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert got.converged.tolist() == [True, False]
    T, converged, iters = _svd_unmasked(torch.as_tensor(src), torch.as_tensor(tgt),
                                        MAX_ITERATIONS, 1e-20, differentiable)
    assert torch.equal(got.T, T) and torch.equal(got.converged, converged)
    assert torch.equal(got.iterations, iters)


def test_svd_icp_extra_masked_body_changes_no_bit(batch, monkeypatch):
    src, tgt = (torch.as_tensor(a[..., :3]) for a in batch[:2])
    kw = dict(max_iterations=MAX_ITERATIONS, tolerance=1e-20, differentiable=False)
    plain = svd_icp.pt2pt_svd_icp(src, tgt, device="cpu", **kw)
    seen = []
    monkeypatch.setattr(svd_icp, "device_while", _one_more(seen))
    _assert_bit_equal(svd_icp.pt2pt_svd_icp(src, tgt, device="cpu", **kw), plain)
    (state,) = seen
    it = state["it"]
    assert it.dtype == torch.int32 and it.dim() == 0 and int(it) == MAX_ITERATIONS


# --- the fused voxel map ------------------------------------------------------

JCFG = JCFG_MAP.with_(nn_method="cluster")
CFG = config_from_dict(dataclasses.asdict(JCFG))


@pytest.fixture
def jax_normals(monkeypatch):
    """The port's merge and anchors take JAX's jitted weighted normals."""
    def weighted(pts):
        return torch.as_tensor(np.array(_J_WEIGHTED(jnp.asarray(pts.numpy()))))
    monkeypatch.setattr(tm, "estimate_normals_weighted", weighted)
    monkeypatch.setattr(ts, "estimate_normals_weighted", weighted)


@pytest.fixture(scope="module")
def seq():
    scans, poses = _sequence(4, n=N_SCAN)
    return scans, np.array(poses)


def _to_port(m) -> LocalMap:
    return LocalMap(*(torch.as_tensor(np.array(a)) for a in m))


@pytest.fixture(scope="module")
def seed_maps(seq):
    """JAX's map of scans 0 and 1, and the JAX map_step of scan 2 from it
    (converging, and cut at 2 iterations: not merged)."""
    scans, poses = seq
    m = jm.empty_map(CAP, jnp.float64)
    for s in scans[:2]:
        m = jm.map_merge(m, jnp.asarray(s), VOXEL, with_normals=True, mode="mean")
    t_pred = poses[2].copy()
    t_pred[:3, 3] += [0.02, -0.01, 0.005]
    steps = {its: jm.map_step(m, jnp.asarray(scans[2]), jnp.asarray(t_pred), None,
                              JCFG.with_(max_iterations=its), VOXEL, merge_mode="mean")
             for its in (JCFG.max_iterations, 2)}
    return (jax.tree_util.tree_map(np.asarray, m), t_pred,
            {k: jax.tree_util.tree_map(np.asarray, v) for k, v in steps.items()})


def test_map_merge_matches_jax_and_the_function(seq, seed_maps, jax_normals):
    scans, _ = seq
    m_ref = seed_maps[0]
    mt = empty_map(CAP, torch.float64)
    for s in scans[:2]:
        got = map_merge(mt, torch.as_tensor(s), VOXEL, with_normals=True, mode="mean")
        _assert_bit_equal(map_merge.fn(mt, torch.as_tensor(s), VOXEL, True, "mean"), got)
        mt = got
    _assert_maps_match(mt, m_ref)


@pytest.mark.parametrize("its", [JCFG.max_iterations, 2])
def test_map_step_matches_jax_and_the_eager_loop(seq, seed_maps, jax_normals, monkeypatch, its):
    """map_step with gn: its solve is the device-loop body (what a capture
    takes), against JAX's program and against the step on register's host
    loop.  Cut at 2 iterations the solve does not converge and the map is
    kept (its step advances)."""
    scans, _ = seq
    m_ref, t_pred, steps = seed_maps
    ref = steps[its]
    args = (_to_port(m_ref), torch.as_tensor(scans[2]), torch.as_tensor(t_pred), None,
            CFG.with_(max_iterations=its), VOXEL)
    pose, ok, it, m1 = got = map_step(*args, merge_mode="mean")
    assert bool(ok) == bool(ref[1]) == (its > 2)
    assert float(it) == float(ref[2])
    np.testing.assert_allclose(pose.numpy(), ref[0], rtol=0, atol=1e-10)
    # XLA fuses the normals inside the jitted step otherwise than in the
    # jitted normals alone (tests/test_torch_mapping.py::test_map_step_matches_jax)
    _assert_maps_match(m1, ref[3], atol_m2=1e-10)
    if its == 2:
        assert all(torch.equal(a, b) for a, b in zip(m1[:4], args[0][:4]))
    monkeypatch.setattr(tm, "_register_program", register)
    eager = map_step(*args, merge_mode="mean")
    for a, b in zip(jax.tree_util.tree_leaves(eager), jax.tree_util.tree_leaves(got)):
        assert torch.equal(a, b)


# --- SLAM's programs ----------------------------------------------------------

def test_make_anchor_matches_jax(seq, jax_normals):
    scans, poses = seq
    ref = np.asarray(js._make_anchor(jnp.asarray(scans[1]), jnp.asarray(poses[1]), True))
    got = ts._make_anchor(torch.as_tensor(scans[1]), torch.as_tensor(poses[1]), True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)
    assert torch.equal(ts._make_anchor.fn(torch.as_tensor(scans[1]), torch.as_tensor(poses[1]),
                                          True), got)


@pytest.mark.parametrize("coarse_its", [JCFG.max_iterations, 1])
def test_closure_solve_matches_jax_and_the_eager_loop(seq, monkeypatch, coarse_its):
    """Scan 3 against scan 0's anchor from a drifted prediction, both stages
    through the device-loop body; cut at one coarse iteration the attempt
    does not converge."""
    scans, poses = seq
    anchor = js._make_anchor(jnp.asarray(scans[0]), jnp.asarray(poses[0]), True)
    t_pred = poses[3].copy()
    t_pred[:3, 3] += [0.1, -0.08, 0.0]
    cfg_c = JCFG.with_(trim_dist=JCFG.trim_dist * 4.0, max_iterations=coarse_its)
    cfg_t = JCFG
    ref = js._closure_solve(anchor, jnp.asarray(poses[0]), jnp.asarray(scans[3]),
                            jnp.asarray(t_pred), cfg_c, cfg_t)
    args = (torch.as_tensor(np.array(anchor)), torch.as_tensor(poses[0]),
            torch.as_tensor(scans[3]), torch.as_tensor(t_pred),
            config_from_dict(dataclasses.asdict(cfg_c)),
            config_from_dict(dataclasses.asdict(cfg_t)))
    got = ts._closure_solve(*args)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-10)
    assert bool(got[1]) == bool(ref[1]) == (coarse_its > 1)
    assert float(got[2]) == float(ref[2])
    monkeypatch.setattr(ts, "_register_program", register)
    eager = ts._closure_solve(*args)
    assert all(torch.equal(a, b) for a, b in zip(eager, got))


def test_edge_residual_norms_matches_jax():
    rng = np.random.default_rng(5)
    poses = np.array(jse3.vec2tran(jnp.asarray(rng.normal(scale=0.3, size=(9, 6)))))
    t_meas = np.array(jse3.vec2tran(jnp.asarray(rng.normal(scale=0.3, size=(12, 6)))))
    ei = np.concatenate([np.arange(8), [0, 2, 4, 1]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, 9), [5, 7, 8, 6]]).astype(np.int32)
    ref = np.asarray(js._edge_residual_norms(*(jnp.asarray(a) for a in (poses, ei, ej, t_meas))))
    got = ts._edge_residual_norms(*(torch.as_tensor(a) for a in (poses, ei, ej, t_meas)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)


# --- what runs captured -------------------------------------------------------

def test_these_entry_points_are_jit_programs():
    """register_anderson_jit, map_merge, map_step, SLAM's three programs and
    _svd_icp_impl are jit programs (captured on a CUDA tensor), and so are
    odometry's and the dense pose graph's programs, register_gicp_jit and
    register_sgd_jit; a solve is host-driven only for Gumbel noise from an
    explicit uniform object (a seed draws JAX's threefry streams on the
    device)."""
    from dicp_tpu_torch import gicp, odometry, sgd_icp

    for fn in (register_anderson_jit, map_merge, map_step, ts._closure_solve, ts._make_anchor,
               ts._edge_residual_norms, svd_icp._svd_icp_impl, odometry._odometry_program,
               odometry._pose_graph_program, gicp.register_gicp_jit, sgd_icp.register_sgd_jit):
        assert isinstance(fn, jit_mod._Jitted), fn
    assert register_anderson_jit is not register_anderson
    assert gicp.register_gicp_jit is not gicp.register_gicp
    assert sgd_icp.register_sgd_jit is not sgd_icp.register_sgd
    host_driven = tm.map_step.fn.__globals__["_register_program"].__globals__["host_driven"]
    assert not host_driven(ICPConfig(differentiable=False, anderson_m=3,
                                     collect_histories=False))
    gumbel = ICPConfig(differentiable=True, use_gumbel=True)

    class Explicit:
        def uniform(self, pair_ids, iteration, chunk, shape, dtype, device):
            return torch.zeros(shape, dtype=dtype, device=device)

    assert host_driven(gumbel, Explicit()) and not host_driven(gumbel, 7)
