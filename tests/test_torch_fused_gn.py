"""Parity of the port's whole-solve path (``fused_small=True``, K4's plain
version on the CPU) with the JAX package, in f32.

* Against JAX's ``register(fused_small=True)``, which runs the Pallas kernel
  in interpret mode, in two configurations: T to 1e-5, iterations and
  convergence equal, weights to 1e-5 / 1e-4.  The point sums round in
  another order than Pallas's, so this is not bit-exact.
* Against JAX's XLA while driver (``fused_small=False``) over the loss zoo,
  prior weights, padding and the reference pair, at ``tests/test_fused_gn.py``'s
  tolerances.
* The gate's truth table against JAX's ``fused_eligible``, and the rule that
  CPU tensors never launch the kernel.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dicp_tpu.config import ICPConfig as JConfig  # noqa: E402
from dicp_tpu.ops.fused_gn import fused_eligible as jfused_eligible  # noqa: E402
from dicp_tpu.registration import register as jregister_eager  # noqa: E402
from dicp_tpu.registration import register_jit as jregister  # noqa: E402

from dicp_tpu_torch import ICPConfig, register, se3  # noqa: E402
from dicp_tpu_torch import registration as treg  # noqa: E402
from dicp_tpu_torch.ops import fused_gn  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BASE = dict(differentiable=False, driver="while", collect_histories=False,
            max_iterations=40, tolerance=1e-5, nn_method="dense")


def _make_batch(B, n, m, dim, normals, seed=0):
    """tests/test_fused_gn.py's scene: each target is a permuted exact
    transform of its source plus far outliers, so every query has a unique
    exact match and convergence is decisive.  f32 numpy."""
    rng = np.random.RandomState(seed)
    src = rng.uniform(-2.0, 2.0, (B, n, 3))
    if dim == 2:
        src[..., 2] = 0.0
    th = rng.uniform(-0.15, 0.15, B)
    tgt_pts = []
    for b in range(B):
        c, s = np.cos(th[b]), np.sin(th[b])
        C = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        t = np.array([0.1 * rng.randn(), 0.1 * rng.randn(), 0.0])
        pts = np.concatenate([src[b][rng.permutation(n)], rng.uniform(50.0, 60.0, (m - n, 3))])
        tgt_pts.append(pts @ C.T + t)
    tgt = np.stack(tgt_pts)
    if normals:
        nrm = rng.randn(B, m, 3)
        if dim == 2:
            nrm[..., 2] = 0.0
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
        tgt = np.concatenate([tgt, nrm], axis=-1)
    return src.astype(np.float32), tgt.astype(np.float32)


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the port's calls of the whole-solve wrapper."""
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return fused_gn.fused_gn_solve(*args)

    monkeypatch.setattr(treg, "fused_gn_solve", spy)
    return calls


def _port(src, tgt, cfg_kw, weight=None):
    ti = torch.eye(4, dtype=torch.float32).expand(len(src), 4, 4)
    w = None if weight is None else torch.as_tensor(weight)
    return register(torch.as_tensor(src), torch.as_tensor(tgt), ti, w, ICPConfig(**cfg_kw))


def _jax(src, tgt, cfg_kw, weight=None, eager=False):
    ti = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (len(src), 4, 4))
    w = None if weight is None else jnp.asarray(weight)
    call = jregister_eager if eager else jregister
    return call(jnp.asarray(src), jnp.asarray(tgt), ti, w, cfg=JConfig(**cfg_kw))


def _compare(res_t, res_j, tol=1e-5):
    """tests/test_fused_gn.py::_compare's tolerances."""
    np.testing.assert_allclose(res_t.T.numpy(), np.asarray(res_j.T), atol=tol, rtol=0)
    np.testing.assert_allclose(res_t.pc.numpy(), np.asarray(res_j.pc), atol=10 * tol, rtol=0)
    np.testing.assert_array_equal(res_t.converged.numpy(), np.asarray(res_j.converged))
    np.testing.assert_array_equal(res_t.iterations.numpy(), np.asarray(res_j.iterations))
    np.testing.assert_allclose(res_t.matched_ratio.numpy(), np.asarray(res_j.matched_ratio),
                               atol=1e-6)
    np.testing.assert_allclose(res_t.weights.numpy(), np.asarray(res_j.weights),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(res_t.costs.numpy(), np.asarray(res_j.costs),
                               atol=1e-5, rtol=1e-3)
    assert res_t.deltas.shape == np.asarray(res_j.deltas).shape
    assert res_t.T.dtype == torch.float32


@pytest.mark.parametrize("case", [
    dict(B=9, n=65, m=65, dim=2, normals=True, seed=1,
         cfg=dict(icp_type="pt2pl", loss_name="huber", loss_metric=1.0, trim_dist=5.0)),
    dict(B=8, n=40, m=48, dim=3, normals=False, seed=2,
         cfg=dict(icp_type="pt2pt", loss_name="cauchy", loss_metric=2.0)),
], ids=["pt2pl_dim2_huber_trim", "pt2pt_dim3_cauchy"])
def test_fused_matches_jax_pallas_interpret(case, fused_calls):
    """The port's fused path (plain version) against JAX's Pallas kernel in
    interpret mode, both with fused_small=True."""
    src, tgt = _make_batch(case["B"], case["n"], case["m"], case["dim"], case["normals"],
                           case["seed"])
    kw = {**BASE, "dim": case["dim"], "fused_small": True, **case["cfg"]}
    res_t = _port(src, tgt, kw)
    assert len(fused_calls) == 1
    res_j = _jax(src, tgt, kw, eager=True)
    _compare(res_t, res_j)
    assert bool(res_t.converged.all())


_ZOO = [dict(icp_type=t, dim=d, differentiable=True, loss_name=loss,
             loss_metric=2.0 if loss else 1.0, trim_dist=4.0, seed=17, B=3, n=48, m=64)
        for loss in ("huber", "cauchy", "welsch", "gm", "trim", None)
        for t, d in (("pt2pl", 3), ("pt2pt", 2))]
_CASES = _ZOO + [
    dict(icp_type="pt2pl", dim=3, seed=3, B=4, n=33, m=57),
    dict(icp_type="pt2pt", dim=2, trim_dist=3.0, seed=4, B=5, n=40, m=40, prior=True),
    dict(icp_type="pt2pl", dim=2, differentiable=True, loss_name="huber", loss_metric=1.0,
         trim_dist=5.0, seed=6, B=6, n=50, m=50),
    dict(icp_type="pt2pl", dim=2, loss_name="huber", seed=7, B=5, n=30, m=30),
    dict(icp_type="pt2pt", dim=2, differentiable=True, loss_name="trim", loss_metric=2.0,
         tanh_steepness=2.0, seed=9, B=4, n=40, m=40),
]


def _case_id(c):
    return (f"{c['icp_type']}-dim{c['dim']}-{c.get('loss_name')}"
            f"-{'soft' if c.get('differentiable') else 'hard'}-B{c['B']}"
            + ("-prior" if c.get("prior") else "") + f"-s{c['seed']}")


@pytest.mark.parametrize("case", _CASES, ids=[_case_id(c) for c in _CASES])
def test_fused_matches_jax_while_driver(case, fused_calls):
    """The loss zoo with smooth weights, no loss, hard trim with zero prior
    weights, soft weights under the while driver, B = 5 (Pallas pads the
    tile of 8), the trim loss at a non-default steepness: the port's fused
    path against JAX's XLA while driver."""
    c = dict(case)
    B, n, m, seed = c.pop("B"), c.pop("n"), c.pop("m"), c.pop("seed")
    prior = c.pop("prior", False)
    src, tgt = _make_batch(B, n, m, c["dim"], c["icp_type"] == "pt2pl", seed)
    weight = None
    if prior:
        weight = (np.random.RandomState(5).rand(B, n) > 0.2).astype(np.float32)
    kw = {**BASE, **c}
    res_t = _port(src, tgt, {**kw, "fused_small": True}, weight)
    assert len(fused_calls) == 1
    res_j = _jax(src, tgt, {**kw, "fused_small": False}, weight)
    _compare(res_t, res_j)


def test_reference_pair_accuracy(source_np, target_np, fused_calls):
    """The fused path recovers the reference pair's transform in f32, as the
    JAX while driver does (tolerance 3e-5 as in tests/test_fused_gn.py)."""
    src = np.repeat(source_np[None, :, :3], 8, axis=0).astype(np.float32)
    tgt = np.repeat(target_np[None], 8, axis=0).astype(np.float32)
    kw = {**BASE, "icp_type": "pt2pl", "dim": 2, "loss_name": "huber", "loss_metric": 1.0,
          "trim_dist": 5.0, "max_iterations": 60}
    res_t = _port(src, tgt, {**kw, "fused_small": True})
    res_j = _jax(src, tgt, {**kw, "fused_small": False})
    _compare(res_t, res_j, tol=3e-5)
    truth = se3.tran_inv(se3.vec2tran(torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1],
                                                   dtype=torch.float64)))
    err = se3.tran2vec(truth @ torch.linalg.inv(res_t.T[0].double()))
    assert float(torch.linalg.vector_norm(err)) < 1e-5
    assert len(fused_calls) == 1


def test_batch_equals_serial(fused_calls):
    """Each element leaves its own loop when it converges: a batch gives each
    element's serial result exactly."""
    src, tgt = _make_batch(6, 50, 60, 3, True, 11)
    kw = {**BASE, "icp_type": "pt2pl", "dim": 3, "loss_name": "cauchy", "loss_metric": 1.0,
          "fused_small": True}
    whole = _port(src, tgt, kw)
    assert len(set(whole.iterations.tolist())) > 1  # elements converge apart
    for b in range(len(src)):
        solo = _port(src[b:b + 1], tgt[b:b + 1], kw)
        for name in ("T", "iterations", "converged", "matched_ratio", "weights", "costs"):
            assert torch.equal(getattr(solo, name)[0], getattr(whole, name)[b]), (b, name)


@pytest.mark.parametrize("variant", [
    dict(), dict(fused_small=None), dict(fused_small=False), dict(collect_histories=True),
    dict(driver="scan", differentiable=True), dict(driver="auto", differentiable=True),
    dict(const_iter=True), dict(icp_type="symmetric"), dict(nn_method="cluster"),
    dict(nn_method="pallas"), dict(n=300), dict(m=513), dict(n=256, m=512),
    dict(dtype="float64"),
], ids=lambda v: "-".join(f"{k}={v[k]}" for k in v) or "eligible")
def test_gate_truth_table(variant):
    """fused_eligible against JAX's on the same configuration and shapes
    (JAX's PRNG-key case cannot arise in the port: its config rejects the
    Gumbel paths that carry a key)."""
    v = dict(variant)
    n, m = v.pop("n", 16), v.pop("m", 16)
    dtype = v.pop("dtype", "float32")
    kw = {**BASE, "icp_type": "pt2pl", "fused_small": True, **v}
    src = np.zeros((2, n, 6 if kw["icp_type"] == "symmetric" else 3), dtype)
    tgt = np.zeros((2, m, 6), dtype)
    got = fused_gn.fused_eligible(ICPConfig(**kw), torch.as_tensor(src), torch.as_tensor(tgt))
    want = jfused_eligible(JConfig(**kw), jnp.asarray(src), jnp.asarray(tgt), None)
    assert got == bool(want)
    assert got == (variant == {} or variant == {"n": 256, "m": 512})


def test_cpu_tensors_never_launch(fused_calls):
    """CPU tensors take the plain version and leave the launch count alone;
    the wrapper checks its inputs."""
    src, tgt = _make_batch(3, 20, 24, 3, True, 21)
    before = fused_gn.launches
    kw = {**BASE, "icp_type": "pt2pl", "dim": 3, "loss_name": "huber", "fused_small": True}
    res = _port(src, tgt, kw)
    assert fused_gn.launches == before and len(fused_calls) == 1
    cfg = ICPConfig(**kw)
    args = (torch.as_tensor(src), torch.as_tensor(tgt), torch.ones(3, 20),
            torch.eye(3).expand(3, 3, 3), torch.zeros(3, 3))
    out = fused_gn.fused_gn_solve(*args, cfg)
    plain = fused_gn.fused_gn_solve_plain(*args, cfg)
    assert fused_gn.launches == before
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert torch.equal(out[0], res.T[:, :3, :3])
    with pytest.raises(ValueError, match="target"):
        fused_gn.fused_gn_solve(args[0], args[1][..., :3], *args[2:], cfg)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_gn.fused_gn_solve(*(a.to("meta") for a in args), cfg)
