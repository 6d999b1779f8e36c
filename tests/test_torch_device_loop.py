"""The device-decided solve loop (``registration._run_device_loop``, the
counterpart of JAX's ``_run_while``) that ``register_jit`` captures as a CUDA
graph WHILE node on the card.  On the CPU the same body runs in a host loop:
held here to JAX's ``register_jit`` in f64 (T within 1e-10; iterations,
convergence and matched ratio equal) and to the port's eager ``register``
bit for bit in every field, on the dense, tiled and cluster tiers, pt2pt,
pt2pl and symmetric, histories on and off, ``const_iter``, and a batch whose
second element never converges within ``max_iterations``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dicp_tpu import se3 as jse3  # noqa: E402
from dicp_tpu.config import ICPConfig as JConfig  # noqa: E402
from dicp_tpu.registration import register_jit as jregister  # noqa: E402

from dicp_tpu_torch import ICPConfig, register, register_jit  # noqa: E402
from dicp_tpu_torch import registration  # noqa: E402

# the second pair starts far off and gets too few iterations to converge
MOTIONS = ([0.01, -0.01, 0.02, 0.002, -0.001, 0.003], [1.5, -1.0, 1.0, 0.5, -0.4, 0.6])
MAX_ITERATIONS = 5

CASES = {
    "dense-pt2pl-histories": dict(nn_method="dense", icp_type="pt2pl"),
    "dense-symmetric-histories": dict(nn_method="dense", icp_type="symmetric"),
    "dense-pt2pt-no-histories": dict(nn_method="dense", icp_type="pt2pt",
                                     collect_histories=False),
    "dense-pt2pl-const-iter": dict(nn_method="dense", icp_type="pt2pl", const_iter=True),
    "tiled-pt2pl-no-histories": dict(nn_method="pallas", icp_type="pt2pl",
                                     collect_histories=False),
    "cluster-pt2pt-histories": dict(nn_method="cluster", icp_type="pt2pt", cluster_group=16,
                                    cluster_probes=4),
    "cluster-pt2pl-no-histories": dict(nn_method="cluster", icp_type="pt2pl",
                                       cluster_group=16, cluster_probes=4,
                                       collect_histories=False),
}


def _config(kw):
    return dict(differentiable=False, max_iterations=MAX_ITERATIONS, tolerance=1e-9, dim=3,
                trim_dist=3.0, loss_name="huber", loss_metric=1.0, **kw)


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


def _port(fn, batch, cfg):
    src, tgt, ti = (torch.as_tensor(a) for a in batch)
    return fn(src, tgt, ti, None, cfg)


def _assert_bit_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("case", list(CASES))
def test_device_loop_matches_jax_and_the_eager_loop(batch, case):
    kw = _config(CASES[case])
    res_j = jregister(*(jnp.asarray(a) for a in batch), None, cfg=JConfig(**kw))
    res_d = _port(register_jit, batch, ICPConfig(**kw))
    res_e = _port(register, batch, ICPConfig(**kw))
    np.testing.assert_allclose(res_d.T.numpy(), np.asarray(res_j.T), rtol=0, atol=1e-10)
    for name in ("iterations", "converged", "matched_ratio"):
        np.testing.assert_array_equal(getattr(res_d, name).numpy(),
                                      np.asarray(getattr(res_j, name)), err_msg=name)
    _assert_bit_equal(res_d, res_e)
    if not kw.get("const_iter"):
        # the batch holds a converged element and one cut at max_iterations
        assert res_d.converged.tolist() == [True, False]
        assert res_d.iterations[1] == MAX_ITERATIONS > res_d.iterations[0]


@pytest.mark.parametrize("case", ["dense-pt2pl-histories", "cluster-pt2pt-histories",
                                  "dense-pt2pt-no-histories"])
def test_extra_masked_body_changes_no_bit(batch, case, monkeypatch):
    """One more body after the flag has fallen (every element converged or
    cut at max_iterations) leaves every output bit as it was: the body
    applies where(flag, new, old) to every field, where an unmasked step
    could move C (sqrt(1e-10) - 1e-5 need not be 0 in floating point)."""
    cfg = ICPConfig(**_config(CASES[case]))
    plain = _port(register_jit, batch, cfg)
    extra = []

    def one_more(flag, body):
        while bool(flag):
            body()
        body()
        extra.append(bool(flag))

    monkeypatch.setattr(registration, "device_while", one_more)
    _assert_bit_equal(_port(register_jit, batch, cfg), plain)
    assert extra == [False]


def test_device_loop_iteration_count_is_a_tensor(batch):
    """The executed count leaves the loop as a 0-dim int32 device tensor,
    the length the JAX while driver pads histories to."""
    kw = _config(CASES["dense-pt2pl-histories"])
    cfg = ICPConfig(**kw)
    src, tgt, ti = (torch.as_tensor(a) for a in batch)
    s, t, w, C, r = registration._preprocess(cfg, src, tgt, ti, None)
    corr = registration._make_corr_fn(cfg, s, t, C, r)
    carry, deltas, weights, costs, it = registration._run_device_loop(cfg, s, t, w, C, r, corr)
    assert it.dtype == torch.int32 and it.dim() == 0 and int(it) == MAX_ITERATIONS
    assert deltas.shape == (MAX_ITERATIONS, 2, 6) and weights.shape[:2] == (MAX_ITERATIONS, 2)
    # the input pose is not written through: the state has storage of its own
    assert torch.equal(ti, torch.as_tensor(batch[2]))
