"""The port's Generalized-ICP (``dicp_tpu_torch.gicp``) against the JAX
package's, f64 on the CPU.

The contracts of ``tests/test_gicp.py`` run on the port alone, on the same
saddle scene.  The parity cases feed the same numpy inputs through both
packages: ``_mahalanobis_ne`` flat and chunked, ``register_gicp`` on both
drivers (a clean pair, and a noisy one with outliers, a trim gate and prior
weights, where the cost is not 0) and the gradients of ``register_gicp_ift``
into the clouds, the weights and the target's normals against ``jax.grad``."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import gicp as jg  # noqa: E402

from dicp_tpu_torch import se3  # noqa: E402
from dicp_tpu_torch.config import ICPConfig  # noqa: E402
from dicp_tpu_torch.gicp import (_mahalanobis_ne, register_gicp, register_gicp_ift,  # noqa: E402
                                 register_gicp_jit)
from dicp_tpu_torch.ops.normals import estimate_normals  # noqa: E402
from dicp_tpu_torch.registration import register  # noqa: E402

from tests.test_gicp import XI, _pair  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several worker
    processes that share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.array(a))


def _tpair(xi, n=600, seed=11):
    """tests/test_gicp.py's pair as port tensors: (source, target, T_init, T_true)."""
    S, Tg, Ti, T_true = _pair(xi, n, seed)
    return _t(S), _t(Tg), _t(Ti), T_true


def _close_to_eye(T, T_true, atol):
    np.testing.assert_allclose(T.detach().numpy() @ T_true, np.eye(4), atol=atol)


# --- tests/test_gicp.py on the port -------------------------------------------

def test_exact_recovery_estimated_normals():
    S, Tg, Ti, T_true = _tpair(XI)
    res = register_gicp(S, Tg, Ti, max_iterations=60, tolerance=1e-12)
    _close_to_eye(res.T[0], T_true, 1e-10)
    assert bool(res.converged[0]) and float(res.cost[0]) < 1e-20


def test_provided_normals_and_6col_target():
    S, Tg, Ti, T_true = _tpair(XI)
    Tg6 = torch.cat([Tg, estimate_normals(Tg)], dim=-1)
    res = register_gicp(S, Tg6, Ti, source_normals=estimate_normals(S), max_iterations=60,
                        tolerance=1e-12)
    _close_to_eye(res.T[0], T_true, 1e-10)


def test_epsilon_one_is_point_to_point():
    """epsilon = 1 gives Sigma = 2 I: the pt2pt GN step and fixed point."""
    S, Tg, Ti, _ = _tpair(XI)
    res_g = register_gicp(S, Tg, Ti, epsilon=1.0, max_iterations=80, tolerance=1e-12)
    cfg = ICPConfig(icp_type="pt2pt", differentiable=False, driver="while",
                    max_iterations=80, tolerance=1e-12, dim=3, trim_dist=100.0,
                    loss_name="huber", loss_metric=1e9, collect_histories=False)
    res_p = register(S, Tg, Ti, None, cfg)
    np.testing.assert_allclose(res_g.T[0].numpy(), res_p.T[0].numpy(), atol=1e-12)


def test_trim_gate_rejects_outliers():
    S, Tg, Ti, T_true = _tpair(XI)
    out = torch.as_tensor(np.random.default_rng(0).uniform(40, 50, size=(1, 40, 3)))
    res = register_gicp(torch.cat([S, out], dim=1), Tg, Ti, trim_dist=2.0,
                        max_iterations=60, tolerance=1e-12)
    _close_to_eye(res.T[0], T_true, 1e-9)


def test_prior_weights():
    """Zero-weight rows are exact no-ops."""
    S, Tg, Ti, T_true = _tpair(XI)
    n = S.shape[1]
    S_bad = S.clone()
    S_bad[:, n // 2:, :] += 5.0
    w = torch.ones((1, n), dtype=torch.float64)
    w[:, n // 2:] = 0.0
    res = register_gicp(S_bad, Tg, Ti, w, max_iterations=60, tolerance=1e-12)
    _close_to_eye(res.T[0], T_true, 1e-9)


def test_scan_matches_while():
    S, Tg, Ti, _ = _tpair(XI)
    r_w = register_gicp(S, Tg, Ti, max_iterations=40, tolerance=1e-12)
    r_s = register_gicp(S, Tg, Ti, max_iterations=40, tolerance=1e-12, differentiable=True)
    np.testing.assert_allclose(r_s.T.numpy(), r_w.T.numpy(), atol=1e-12)
    assert float(r_s.iterations[0]) == float(r_w.iterations[0])
    assert register_gicp_jit is not register_gicp
    r_j = register_gicp_jit(S, Tg, Ti, max_iterations=40, tolerance=1e-12)
    assert all(torch.equal(a, b) for a, b in zip(r_j, r_w))


def test_batched_independent():
    S0, Tg, Ti, T0 = _tpair(XI)
    S1, _, _, T1 = _tpair([-0.15, 0.2, -0.08, -0.03, 0.05, -0.06])
    res = register_gicp(torch.cat([S0, S1]), torch.cat([Tg, Tg]), torch.cat([Ti, Ti]),
                        max_iterations=60, tolerance=1e-12)
    _close_to_eye(res.T[0], T0, 1e-9)
    _close_to_eye(res.T[1], T1, 1e-9)
    solo = register_gicp(S1, Tg, Ti, max_iterations=60, tolerance=1e-12)
    np.testing.assert_allclose(res.T[1].numpy(), solo.T[0].numpy(), atol=1e-12)


def test_gradients():
    S, Tg, Ti, _ = _tpair(XI, n=200)
    S.requires_grad_(True)
    torch.sum(register_gicp(S, Tg, Ti, max_iterations=10, tolerance=1e-12,
                            differentiable=True).T).backward()
    g = S.grad.numpy()
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0


def test_ift_forward_matches_while():
    S, Tg, Ti, _ = _tpair(XI, n=300)
    r_ift = register_gicp_ift(S, Tg, Ti, max_iterations=60, tolerance=1e-13)
    r_w = register_gicp(S, Tg, Ti, max_iterations=60, tolerance=1e-13)
    np.testing.assert_array_equal(r_ift.T.numpy(), r_w.T.numpy())
    assert bool(r_ift.converged[0])


def test_ift_gradients_match_unrolled():
    """One 6x6 adjoint solve equals reverse mode through every iteration at
    a tight fixed point."""
    S, Tg, Ti, _ = _tpair(XI, n=300)
    a = S.clone().requires_grad_(True)
    torch.sum(register_gicp_ift(a, Tg, Ti, max_iterations=60, tolerance=1e-13).T).backward()
    b = S.clone().requires_grad_(True)
    torch.sum(register_gicp(b, Tg, Ti, max_iterations=25, tolerance=1e-13,
                            differentiable=True).T).backward()
    g_ift, g_unr = a.grad.numpy(), b.grad.numpy()
    assert np.all(np.isfinite(g_ift)) and np.abs(g_ift).max() > 0
    np.testing.assert_allclose(g_ift, g_unr, rtol=0, atol=2e-6 * np.abs(g_unr).max())


@pytest.mark.parametrize("arg", ["target", "weight"])
def test_ift_gradients_into_target_and_weight(arg):
    S, Tg, Ti, _ = _tpair(XI, n=200)
    w = torch.ones((1, 200), dtype=torch.float64)
    x = (Tg if arg == "target" else w).clone().requires_grad_(True)
    kw = dict(max_iterations=60, tolerance=1e-13)
    res = (register_gicp_ift(S, x, Ti, w, **kw) if arg == "target"
           else register_gicp_ift(S, Tg, Ti, x, **kw))
    torch.sum(res.T).backward()
    g = x.grad.numpy()
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0, arg


def test_validation():
    with pytest.raises(ValueError, match="batched"):
        register_gicp(torch.zeros((8, 3)), torch.zeros((8, 3)), torch.eye(4))
    with pytest.raises(ValueError, match="batched"):
        register_gicp_ift(torch.zeros((8, 3)), torch.zeros((8, 3)), torch.eye(4))


def test_f32_realistic_radius_no_nan():
    """Points at ~50 m radius in f32: the rotation block of H scales with
    n r^2 against the translation block's n; the equilibrated solve keeps
    the step finite."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(-50, 50, size=(800, 2))
    z = 0.02 * (xy[:, 0] ** 2 - xy[:, 1] ** 2) / 50.0
    scene = np.column_stack([xy, z]).astype(np.float32)
    xi = torch.tensor([0.3, -0.2, 0.1, 0.004, -0.003, 0.006], dtype=torch.float64)
    T_true = se3.vec2tran(xi).numpy()
    src = (scene.astype(np.float64) @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    res = register_gicp(torch.as_tensor(src[None]), torch.as_tensor(scene[None]),
                        torch.eye(4, dtype=torch.float32)[None], max_iterations=60,
                        tolerance=1e-7)
    T = res.T[0].double()
    assert bool(torch.all(torch.isfinite(T)))
    err = se3.tran2vec(T @ torch.as_tensor(T_true))
    assert float(torch.linalg.vector_norm(err)) < 5e-4, err


def test_all_trimmed_no_nan():
    """A gate that rejects every correspondence leaves T_init, finite."""
    S, Tg, Ti, _ = _tpair(XI, n=200)
    res = register_gicp(S.float(), Tg.float(), Ti.float(), trim_dist=1e-9, max_iterations=10,
                        tolerance=1e-7)
    T = res.T[0].numpy()
    assert np.all(np.isfinite(T))
    np.testing.assert_allclose(T, Ti[0].float().numpy(), atol=1e-5)


def test_mahalanobis_ne_chunked_matches_flat():
    rng = np.random.default_rng(7)
    n = 5000
    J = torch.as_tensor(rng.standard_normal((n, 3, 6)))
    A = rng.standard_normal((n, 3, 3))
    M = torch.as_tensor(np.einsum("nij,nkj->nik", A, A) + 3 * np.eye(3))
    r = torch.as_tensor(rng.standard_normal((n, 3)))
    w = torch.as_tensor(rng.uniform(0, 1, n))
    H1, g1, Mr1 = _mahalanobis_ne(J, M, r, w, chunk=512)
    H2, g2, Mr2 = _mahalanobis_ne(J, M, r, w, chunk=10**9)
    np.testing.assert_allclose(H1.numpy(), H2.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-12)
    np.testing.assert_allclose(Mr1.numpy(), Mr2.numpy(), rtol=1e-12)


# --- parity with the JAX package ----------------------------------------------

@pytest.mark.parametrize("n, chunk", [(600, 4096), (5000, 512)])
def test_mahalanobis_ne_matches_jax(n, chunk):
    """The flat sum (n <= chunk) and the padded two-level sum, against JAX."""
    rng = np.random.default_rng(n)
    J = rng.standard_normal((n, 3, 6))
    A = rng.standard_normal((n, 3, 3))
    M = np.einsum("nij,nkj->nik", A, A) + 3 * np.eye(3)
    r = rng.standard_normal((n, 3))
    w = rng.uniform(0, 1, n)
    got = _mahalanobis_ne(*map(torch.as_tensor, (J, M, r, w)), chunk=chunk)
    ref = jg._mahalanobis_ne(*map(jnp.asarray, (J, M, r, w)), chunk=chunk)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)


def _noisy_case():
    """Two saddle pairs with sensor noise, 20 outliers, prior weights and a
    trim gate: a cost that is not 0 and weights that matter."""
    rng = np.random.default_rng(5)
    srcs, tgts = [], []
    for b, xi in enumerate((XI, [-0.1, 0.12, -0.05, -0.03, 0.04, -0.05])):
        S, Tg, _, _ = _pair(xi, n=250, seed=11 + b)
        S = np.asarray(S)[0] + rng.normal(scale=0.01, size=(250, 3))
        S[:20] += rng.uniform(5, 8, size=(20, 3))
        srcs.append(S)
        tgts.append(np.asarray(Tg)[0])
    w = rng.uniform(0.5, 1.5, size=(2, 250))
    return np.stack(srcs), np.stack(tgts), np.broadcast_to(np.eye(4), (2, 4, 4)).copy(), w


@pytest.mark.parametrize("case", ["clean", "noisy"])
@pytest.mark.parametrize("differentiable", [False, True])
def test_register_gicp_matches_jax(case, differentiable):
    """T within 1e-10, iterations and convergence equal, cost within 1e-12,
    on both drivers."""
    if case == "clean":
        S, Tg, Ti, _ = _pair(XI, n=300)
        S, Tg, Ti, w = np.asarray(S), np.asarray(Tg), np.asarray(Ti), None
        kw = dict(max_iterations=60, tolerance=1e-12)
    else:
        S, Tg, Ti, w = _noisy_case()
        kw = dict(max_iterations=30, tolerance=1e-10, trim_dist=1.0, epsilon=2e-3)
    ref = jg.register_gicp_jit(jnp.asarray(S), jnp.asarray(Tg), jnp.asarray(Ti),
                               None if w is None else jnp.asarray(w),
                               differentiable=differentiable, **kw)
    got = register_gicp(_t(S), _t(Tg), _t(Ti), None if w is None else _t(w),
                        differentiable=differentiable, **kw)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=0, atol=1e-12)
    if case == "noisy":
        assert np.all(np.asarray(ref.cost) > 1e-6)


def test_register_gicp_ift_gradients_match_jax():
    """Gradients of sum(T) into the source (through its estimated normals
    too), the target points, the target's given normals and the weights,
    against jax.grad, within 1e-8."""
    from dicp_tpu.ops.normals import estimate_normals as j_normals

    S, Tg, Ti, w = _noisy_case()
    tgt_n = np.asarray(j_normals(jnp.asarray(Tg)))
    kw = dict(max_iterations=60, tolerance=1e-12, trim_dist=1.0)

    def fj(s, t, tn, ww):
        t6 = jnp.concatenate([t, tn], axis=-1)
        return jnp.sum(jg.register_gicp_ift(s, t6, jnp.asarray(Ti), ww, **kw).T)

    args = (S, Tg, tgt_n, w)
    # jitted: the eager custom-VJP backward dispatches op by op (4x slower)
    ref = jax.jit(jax.grad(fj, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, args))
    xs = [_t(a).requires_grad_(True) for a in args]
    s, t, tn, ww = xs
    torch.sum(register_gicp_ift(s, torch.cat([t, tn], dim=-1), _t(Ti), ww, **kw).T).backward()
    for x, g in zip(xs, ref):
        g = np.asarray(g)
        assert np.all(np.isfinite(g)) and np.abs(g).max() > 0
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0, atol=1e-8)


DTYPES = (np.float32, np.float64)


@pytest.mark.parametrize("fn", ["register_gicp", "register_gicp_ift"])
@pytest.mark.parametrize("dtypes", list(itertools.product(DTYPES, repeat=4)),
                         ids=lambda d: "-".join(np.dtype(t).name[-2:] for t in d))
def test_mixed_dtypes_follow_jax(fn, dtypes):
    """Source, target, weight and T_init in f32 or f64: where JAX's solve
    loop raises (a target or weight wider than the source widens the pose
    it carries), the port raises a TypeError naming the wider inputs; where
    JAX returns, the port returns T in the same dtype within 1e-10 (an f64
    source) or 1e-5 (f32 solves on both sides)."""
    ds, dtg, dw, di = dtypes
    S, Tg, Ti, _ = _pair(XI, n=60)
    S, Tg, Ti = np.asarray(S)[0].astype(ds)[None], np.asarray(Tg)[0].astype(dtg)[None], \
        np.asarray(Ti)[0].astype(di)[None]
    w = np.ones(S.shape[:-1], dw)
    kw = dict(max_iterations=30, tolerance=1e-7)
    try:
        ref = getattr(jg, fn)(jnp.asarray(S), jnp.asarray(Tg), jnp.asarray(Ti), jnp.asarray(w),
                              **kw)
    except TypeError:
        ref = None
    port = globals()[fn]
    if ref is None:
        wider = [what for what, d in (("target", dtg), ("weight", dw))
                 if np.promote_types(d, ds) != ds]
        with pytest.raises(TypeError) as info:
            port(_t(S), _t(Tg), _t(Ti), _t(w), **kw)
        assert all(what in str(info.value) for what in wider)
        return
    got = port(_t(S), _t(Tg), _t(Ti), _t(w), **kw)
    assert got.T.dtype == _t(S).dtype
    np.testing.assert_allclose(got.T.detach().numpy(), np.asarray(ref.T), rtol=0,
                               atol=1e-10 if ds == np.float64 else 1e-5)
