"""The port's stochastic mini-batch ICP (``dicp_tpu_torch.sgd_icp``) against
the JAX package's, f64 on the CPU.

The contracts of ``tests/test_sgd_icp.py`` run on the port with an int
seed; the parity cases give the port JAX's key (as key data or its int
seed, drawn by the port itself) or serve JAX's own draws,
``randint(fold_in(key, it), (k,), 0, n)``, through the sampler protocol
(:class:`JaxSampler`), and hold the port to JAX on the same numpy inputs.
Each JAX reference is computed once per module, on 1,500-point scenes with
at most 40 iterations."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import se3 as jse3  # noqa: E402
from dicp_tpu import sgd_icp as jsgd  # noqa: E402

from dicp_tpu_torch import se3  # noqa: E402
from dicp_tpu_torch import sgd_icp as tsgd  # noqa: E402
from dicp_tpu_torch.sgd_icp import SeededSampler, register_sgd, register_sgd_jit  # noqa: E402

from tests.test_sgd_icp import XI, _scene  # noqa: E402

XI2 = [-0.1, 0.12, -0.06, -0.02, 0.04, -0.05]


class JaxSampler:
    """JAX's mini-batch draws through the port's sampler protocol: element i
    of the batch draws ``randint(fold_in(keys[i], it), (k,), 0, n)``, as
    ``dicp_tpu.sgd_icp._solve_one`` does with its per-element keys."""

    def __init__(self, keys):
        self.keys = keys
        self.calls = 0

    def indices(self, pair_ids, iteration, k, n, device):
        self.calls += 1
        draws = [np.asarray(jax.random.randint(jax.random.fold_in(self.keys[int(i)], iteration),
                                               (k,), 0, n)) for i in pair_ids]
        return torch.as_tensor(np.stack(draws), device=device)


def _np_pair(xi=XI, n=4000, seed=5):
    scene = _scene(n, seed)
    T_true = np.asarray(jse3.vec2tran(jnp.asarray(np.asarray(xi, np.float64))))
    src = scene @ T_true[:3, :3].T + T_true[:3, 3]
    return src[None], scene[None], np.eye(4)[None], T_true


def _pair(xi=XI, n=4000, seed=5):
    src, tgt, ti, T_true = _np_pair(xi, n, seed)
    return torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(ti), T_true


def _err(T, T_true):
    T = torch.as_tensor(np.array(T, np.float64)) @ torch.as_tensor(T_true)
    return float(torch.linalg.vector_norm(se3.tran2vec(T)))



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several worker
    processes that share the host's cores, where more threads per worker
    only share the same cores and slow the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# --- tests/test_sgd_icp.py on the port --------------------------------------

def test_gn_recovers_pose():
    S, Tg, Ti, T_true = _pair()
    res = register_sgd(S, Tg, Ti, 0, minibatch=512, iterations=60, tolerance=1e-8)
    assert bool(res.converged[0])
    assert _err(res.T[0], T_true) < 1e-4, _err(res.T[0], T_true)


def test_sgd_and_adam_converge():
    """The paper's first-order rules on its objective (pt2pt) drive the pose
    error to ~1e-9 in a few hundred iterations."""
    S, Tg, Ti, T_true = _pair()
    for opt, lr, tol in [("sgd", 0.3, 1e-6), ("adam", 0.05, 1e-6)]:
        res = register_sgd(S, Tg, Ti, 1, icp_type="pt2pt", minibatch=512, iterations=300,
                           optimizer=opt, lr=lr, lr_decay=0.02, tolerance=0.0)
        assert _err(res.T[0], T_true) < tol, (opt, _err(res.T[0], T_true))


def test_pt2pt_mode():
    S, Tg, Ti, T_true = _pair()
    res = register_sgd(S, Tg, Ti, 2, icp_type="pt2pt", minibatch=512, iterations=120,
                       tolerance=1e-8)
    assert _err(res.T[0], T_true) < 1e-3, _err(res.T[0], T_true)


def test_trim_rejects_outliers():
    S, Tg, Ti, T_true = _pair()
    out = torch.as_tensor(np.random.default_rng(0).uniform(30, 40, size=(1, 200, 3)))
    res = register_sgd(torch.cat([S, out], dim=1), Tg, Ti, 3, minibatch=512, iterations=80,
                       trim_dist=2.0, tolerance=1e-8)
    assert _err(res.T[0], T_true) < 1e-4, _err(res.T[0], T_true)


def test_zero_weight_rows_are_noops():
    S, Tg, Ti, T_true = _pair()
    n = S.shape[1]
    S_bad = S.clone()
    S_bad[:, n // 2:, :] += 7.0
    w = torch.ones((1, n), dtype=torch.float64)
    w[:, n // 2:] = 0.0
    res = register_sgd(S_bad, Tg, Ti, 4, weight=w, minibatch=512, iterations=80,
                       tolerance=1e-8)
    assert _err(res.T[0], T_true) < 1e-4, _err(res.T[0], T_true)


def test_deterministic_under_key():
    S, Tg, Ti, T_true = _pair(n=1500)
    a = register_sgd(S, Tg, Ti, 7, minibatch=256, iterations=40)
    b = register_sgd(S, Tg, Ti, 7, minibatch=256, iterations=40)
    assert torch.equal(a.T, b.T)
    c = register_sgd(S, Tg, Ti, 8, minibatch=256, iterations=40)
    assert not torch.equal(a.T, c.T)
    assert _err(c.T[0], T_true) < 1e-3
    # a torch.Generator is read once for a seed: two equal generators agree
    g = [register_sgd(S, Tg, Ti, torch.Generator().manual_seed(5), minibatch=256,
                      iterations=40).T for _ in range(2)]
    assert torch.equal(g[0], g[1])


def test_batch_equals_serial_with_element_keys():
    S0, Tg, Ti, _ = _pair(n=1500)
    S1, _, _, _ = _pair(XI2, n=1500)
    keys = [9, 10]
    batch = register_sgd(torch.cat([S0, S1]), torch.cat([Tg, Tg]), torch.cat([Ti, Ti]), keys,
                         minibatch=256, iterations=40)
    solo1 = register_sgd(S1, Tg, Ti, keys[1:], minibatch=256, iterations=40)
    np.testing.assert_allclose(batch.T[1].numpy(), solo1.T[0].numpy(), rtol=0, atol=1e-12)
    # an int seed is one key split N ways (JAX's per-element keys): element 0
    # of its batch lands on the pose of the sequence's element 0
    single = register_sgd(torch.cat([S0, S1]), torch.cat([Tg, Tg]), torch.cat([Ti, Ti]), 9,
                          minibatch=256, iterations=40)
    np.testing.assert_allclose(single.T[0].numpy(), batch.T[0].numpy(), rtol=0, atol=1e-12)


def test_gradients_finite_nonzero():
    S, Tg, Ti, _ = _pair(n=800)
    S = S.clone().requires_grad_(True)
    loss = torch.sum(register_sgd(S, Tg, Ti, 11, minibatch=128, iterations=15,
                                  differentiable=True).T)
    (g,) = torch.autograd.grad(loss, S)
    assert torch.all(torch.isfinite(g)) and float(g.abs().max()) > 0


def test_validation():
    S, Tg, Ti, _ = _pair(n=100)
    with pytest.raises(ValueError, match="batched"):
        register_sgd(S[0], Tg, Ti, 0)
    with pytest.raises(ValueError, match="icp_type"):
        register_sgd(S, Tg, Ti, 0, icp_type="symmetric")
    with pytest.raises(ValueError, match="optimizer"):
        register_sgd(S, Tg, Ti, 0, optimizer="lbfgs")
    with pytest.raises(ValueError, match="nn_method"):
        register_sgd(S, Tg, Ti, 0, nn_method="pallas")
    with pytest.raises(ValueError, match="key"):
        register_sgd(S, Tg, Ti, [0, 1, 2])
    with pytest.raises(ValueError, match="key"):
        register_sgd(S, Tg, Ti, None)


def test_cluster_backend_matches_dense():
    """Cluster-index correspondences (certified + fix-up) select the same
    neighbours as the dense argmin, so the gn trajectory lands on the same
    pose; 'auto' picks cluster at m >= 16384."""
    S, Tg, Ti, T_true = _pair(n=3000)
    d = register_sgd(S, Tg, Ti, 5, minibatch=256, iterations=40, nn_method="dense",
                     tolerance=1e-8)
    c = register_sgd(S, Tg, Ti, 5, minibatch=256, iterations=40, nn_method="cluster",
                     tolerance=1e-8)
    np.testing.assert_allclose(c.T.numpy(), d.T.numpy(), rtol=0, atol=1e-9)
    assert _err(c.T[0], T_true) < 1e-4


# --- parity with the JAX package --------------------------------------------

N_PAR = 1500
KEY = 3


def _moved_pose():
    """A pose off the truth, so that the residuals and weights are live."""
    return np.asarray(jse3.vec2tran(jnp.asarray([0.02, -0.01, 0.015, 0.01, 0.005, -0.02])))


@pytest.fixture(scope="module")
def par_pair():
    return _np_pair(n=N_PAR)


def _jax_nn(tgt):
    return jsgd._dense_nn_fn(jnp.asarray(tgt))


@pytest.mark.parametrize("icp_type, trim, loss", [
    ("pt2pl", None, "huber"), ("pt2pl", 0.05, None), ("pt2pt", 0.05, "huber"),
    ("pt2pt", None, None)])
def test_minibatch_system_matches_jax(par_pair, icp_type, trim, loss):
    src, tgt, _, T_true = par_pair
    rng = np.random.default_rng(0)
    idx = rng.integers(0, N_PAR, 256)
    nrm = np.asarray(jsgd.estimate_normals(jnp.asarray(tgt[0]), k=16))
    weight = rng.uniform(0.5, 1.0, N_PAR)
    T = np.linalg.inv(T_true) @ _moved_pose()
    kw = dict(icp_type=icp_type, loss_name=loss, loss_metric=0.05, trim_dist=trim,
              differentiable=False)
    Hj, gj, cj = jsgd._minibatch_system(
        jnp.asarray(T), jnp.asarray(idx), jnp.asarray(src[0]), jnp.asarray(tgt[0]),
        jnp.asarray(nrm), jnp.asarray(weight), _jax_nn(tgt[0]), **kw)
    Ht, gt, ct = tsgd._minibatch_system(
        torch.as_tensor(T)[None], torch.as_tensor(idx)[None], torch.as_tensor(src),
        torch.as_tensor(tgt), torch.as_tensor(nrm)[None], torch.as_tensor(weight)[None],
        tsgd._dense_nn_fn(torch.as_tensor(tgt)), **kw)
    assert float(cj) > 0
    np.testing.assert_allclose(Ht[0].numpy(), np.asarray(Hj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(gt[0].numpy(), np.asarray(gj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ct[0].numpy(), np.asarray(cj), rtol=0, atol=1e-12)


@pytest.mark.parametrize("optimizer", ["gn", "sgd", "adam"])
def test_step_delta_matches_jax(optimizer):
    rng = np.random.default_rng(1)
    A = rng.normal(size=(6, 6))
    H = A @ A.T + 0.1 * np.eye(6)
    g, m1, m2 = rng.normal(size=6), rng.normal(size=6), rng.uniform(0.1, 1.0, 6)
    kw = dict(optimizer=optimizer, lr=0.1, lr_decay=0.05, b1=0.9, b2=0.999)
    dj, m1j, m2j = jsgd._step_delta(jnp.asarray(H), jnp.asarray(g), jnp.asarray(m1),
                                    jnp.asarray(m2), jnp.asarray(3.0), dt=jnp.float64, **kw)
    dt_, m1t, m2t = tsgd._step_delta(torch.as_tensor(H)[None], torch.as_tensor(g)[None],
                                     torch.as_tensor(m1)[None], torch.as_tensor(m2)[None],
                                     3.0, dt=torch.float64, **kw)
    for a, b in ((dt_, dj), (m1t, m1j), (m2t, m2j)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_adam_step_f32_takes_the_nearest_sqrt():
    """The f32 'adam' step on the CPU equals the same arithmetic with an
    IEEE sqrt (numpy's, as the card's) bit for bit: torch's CPU sqrt leaves
    some results an ulp off, and _sqrt_rn moves them to the nearest float,
    keeping sqrt's gradient."""
    rng = np.random.default_rng(2)
    g, m1 = rng.normal(size=(4000, 6)).astype(np.float32), rng.normal(size=(4000, 6))
    m1, m2 = m1.astype(np.float32), (rng.uniform(size=(4000, 6)) + 0.1).astype(np.float32)
    sched = tsgd._schedule(40, optimizer="adam", lr=0.05, lr_decay=0.02, b1=0.9, b2=0.999,
                           dt=torch.float32)
    H = torch.zeros((4000, 6, 6))
    for it in (0, 39):
        got = tsgd._step_delta(H, torch.as_tensor(g), torch.as_tensor(m1), torch.as_tensor(m2),
                               None, optimizer="adam", lr=None, lr_decay=None, b1=0.9,
                               b2=0.999, dt=torch.float32, sched=sched[it])
        lr_t, c1, c2 = (np.float32(v) for v in sched[it].tolist())
        m1n = np.float32(0.9) * m1 + np.float32(1.0 - 0.9) * g
        m2n = np.float32(0.999) * m2 + np.float32(1.0 - 0.999) * g * g
        want = -lr_t * (m1n / c1) / (np.sqrt(m2n / c2) + np.float32(1e-8))
        np.testing.assert_array_equal(got[0].numpy(), want)
    x = torch.as_tensor(rng.uniform(0.0, 10.0, 100_000).astype(np.float32))
    x = torch.cat([x, torch.tensor([0.0, float("inf"), float("nan"), 1e-45, 3.4e38])])
    np.testing.assert_array_equal(tsgd._sqrt_rn(x).numpy(), np.sqrt(x.numpy()))
    leaf = x[:100].clone().requires_grad_(True)
    (a,) = torch.autograd.grad(tsgd._sqrt_rn(leaf).sum(), leaf)
    (b,) = torch.autograd.grad(torch.sqrt(leaf).sum(), leaf)
    assert torch.equal(a, b)


# (name, register_sgd keywords): the dense and the cluster backend (16 of 24
# groups probed), the paper's rules on pt2pt
PARITY = {
    "gn dense pt2pl": dict(tolerance=1e-8),
    "gn cluster pt2pl": dict(tolerance=1e-8, nn_method="cluster", cluster_group=64),
    "adam pt2pt": dict(icp_type="pt2pt", optimizer="adam", lr=0.05, tolerance=0.0),
    "sgd pt2pt trim": dict(icp_type="pt2pt", optimizer="sgd", lr=0.3, trim_dist=0.5,
                           tolerance=1e-7, patience=2),
}


@pytest.fixture(scope="module")
def jax_solves(par_pair):
    src, tgt, ti, _ = par_pair
    out = {}
    for name, kw in PARITY.items():
        res = jsgd.register_sgd(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ti),
                                jax.random.key(KEY), minibatch=256, iterations=40, **kw)
        out[name] = jax.tree_util.tree_map(np.asarray, res)
    return out


# the forms of JAX's key KEY given to register_sgd: its draws served through
# the sampler protocol, its key data, its int seed
KEY_FORMS = ("sampler", "key data", "int seed")


def _key_form(form):
    return {"sampler": lambda: JaxSampler(jax.random.split(jax.random.key(KEY), 1)),
            "key data": lambda: np.asarray(jax.random.key_data(jax.random.key(KEY))),
            "int seed": lambda: KEY}[form]()


@pytest.mark.parametrize("name, form", [(name, form) for form in KEY_FORMS for name in PARITY],
                         ids=[name if form == "sampler" else f"{name}-{form}"
                              for form in KEY_FORMS for name in PARITY])
def test_register_sgd_matches_jax(par_pair, jax_solves, name, form):
    """JAX's draws through the sampler (_per_element_keys, N = 1), or JAX's
    key as key data or as its int seed, drawn by the port itself: T within
    1e-10, iterations and convergence equal, cost within 1e-12.  JAX runs
    every iteration; the port stops once every element has converged, and
    the results agree."""
    src, tgt, ti, _ = par_pair
    ref = jax_solves[name]
    key = _key_form(form)
    res = register_sgd(torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(ti),
                       key, minibatch=256, iterations=40, **PARITY[name])
    np.testing.assert_allclose(res.T.numpy(), ref.T, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(res.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(res.converged.numpy(), ref.converged)
    np.testing.assert_allclose(res.cost.numpy(), ref.cost, rtol=0, atol=1e-12)
    if form == "sampler":
        # every iteration is drawn ahead, once (the loop reads those it runs)
        assert key.calls == 40


def test_batch_equals_serial_with_jax_streams(par_pair):
    """Per-element streams: element 1 of a two-element batch equals the
    one-element solve on the same stream (1e-12), with JAX's split keys."""
    src, tgt, ti, _ = par_pair
    src1 = _np_pair(XI2, n=N_PAR)[0]
    keys = jax.random.split(jax.random.key(9), 2)
    S = torch.as_tensor(np.concatenate([src, src1]))
    batch = register_sgd(S, torch.as_tensor(np.concatenate([tgt, tgt])),
                         torch.as_tensor(np.concatenate([ti, ti])), JaxSampler(keys),
                         minibatch=256, iterations=40)
    solo = register_sgd(S[1:], torch.as_tensor(tgt), torch.as_tensor(ti),
                        [JaxSampler(keys[1:])], minibatch=256, iterations=40)
    np.testing.assert_allclose(batch.T[1].numpy(), solo.T[0].numpy(), rtol=0, atol=1e-12)
    assert torch.equal(batch.iterations[1:], solo.iterations)


def test_batch_equals_serial_with_key_arrays(par_pair):
    """An (N, 2) key array (JAX's split keys) and the single key split N
    ways give the same batch, whose element 1 equals the one-element solve
    on its key within 1e-12; the batch equals JAX's draws served through the
    sampler protocol bit for bit."""
    src, tgt, ti, _ = par_pair
    src1 = _np_pair(XI2, n=N_PAR)[0]
    keys = jax.random.split(jax.random.key(9), 2)
    data = np.asarray(jax.random.key_data(keys))
    S = torch.as_tensor(np.concatenate([src, src1]))
    Tg = torch.as_tensor(np.concatenate([tgt, tgt]))
    Ti = torch.as_tensor(np.concatenate([ti, ti]))
    kw = dict(minibatch=256, iterations=40)
    batch = register_sgd(S, Tg, Ti, data, **kw)
    split = register_sgd(S, Tg, Ti, 9, **kw)
    solo = register_sgd(S[1:], torch.as_tensor(tgt), torch.as_tensor(ti), data[1:], **kw)
    served = register_sgd(S, Tg, Ti, JaxSampler(keys), **kw)
    for a, b in zip(batch, split):
        assert torch.equal(a, b)
    for a, b in zip(batch, served):
        assert torch.equal(a, b)
    np.testing.assert_allclose(batch.T[1].numpy(), solo.T[0].numpy(), rtol=0, atol=1e-12)
    assert torch.equal(batch.iterations[1:], solo.iterations)


def test_register_sgd_jit_takes_a_key_as_element_keys(par_pair):
    """register_sgd_jit's host work turns a key into an SGDPlan of (N, 2)
    element keys (no indices drawn): every seed and key-data form shares one
    cache key, and the call equals register_sgd bit for bit."""
    src, tgt, ti, _ = par_pair
    args = (torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(ti))
    kw = dict(minibatch=256, iterations=40, optimizer="adam", lr=0.05, icp_type="pt2pt")
    plan = register_sgd_jit._bind(args + (KEY,), kw)[0].arguments["key"]
    assert plan.indices is None and plan.keys.shape == (1, 2) and plan.schedule.shape == (40, 3)
    keys = {register_sgd_jit.cache_key(*args, key, **kw)
            for key in (1, KEY, _key_form("key data"), torch.Generator().manual_seed(2))}
    assert len(keys) == 1
    for a, b in zip(register_sgd_jit(*args, KEY, **kw), register_sgd(*args, KEY, **kw)):
        assert torch.equal(a, b)


def test_gradient_matches_jax(par_pair):
    """register_sgd(differentiable=True): d sum(T) / d source against
    jax.grad within 1e-8 (gradient through the gathered points, the smooth
    weights and the solves; the indices carry none)."""
    src, tgt, ti, _ = _np_pair(n=800)
    kw = dict(minibatch=128, iterations=15, differentiable=True, trim_dist=1.0)
    key = jax.random.key(11)

    def loss(a):
        return jnp.sum(jsgd.register_sgd(a, jnp.asarray(tgt), jnp.asarray(ti), key, **kw).T)

    gj = np.asarray(jax.grad(loss)(jnp.asarray(src)))
    S = torch.as_tensor(src).requires_grad_(True)
    res = register_sgd(S, torch.as_tensor(tgt), torch.as_tensor(ti),
                       JaxSampler(jax.random.split(key, 1)), **kw)
    (gt,) = torch.autograd.grad(torch.sum(res.T), S)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-8)


def test_seeded_sampler_streams():
    """The port's source: draws in [0, n) of the asked shape, a stream per
    (element, iteration), fold_in giving another source, all reproducible."""
    s = SeededSampler(4)
    a = s.indices([0, 1], 0, 64, 10, torch.device("cpu"))
    assert a.shape == (2, 64) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < 10
    assert not torch.equal(a[0], a[1])
    assert torch.equal(a, SeededSampler(4).indices([0, 1], 0, 64, 10, torch.device("cpu")))
    assert not torch.equal(a, s.indices([0, 1], 1, 64, 10, torch.device("cpu")))
    assert not torch.equal(a, s.fold_in(2).indices([0, 1], 0, 64, 10, torch.device("cpu")))
    assert torch.equal(s.fold_in(2).indices([1], 3, 8, 10, torch.device("cpu")),
                       SeededSampler(4).fold_in(2).indices([1], 3, 8, 10, torch.device("cpu")))
