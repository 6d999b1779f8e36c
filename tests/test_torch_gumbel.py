"""Parity of the port's Gumbel soft nearest neighbour with the JAX package,
f64 on the CPU: ``knn.gumbel_nn`` (dense and streamed) and the Gumbel solve
(``register``, ``ICP.icp`` on ragged targets) against JAX's, with JAX's own
uniform draws injected through the port's noise protocol, so the two differ
only by rounding (tolerance 1e-10).  The port's own streams (a seed or a
``torch.Generator``: JAX's threefry streams, ``tests/test_torch_threefry.py``
holds them to JAX's draws) are held to batch_chunk == unchunked and first
rows == a smaller batch, bit for bit.  Mirrors ``tests/test_nn.py:99-141``
and ``tests/test_icp_inputs.py:253-283``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import knn as jknn  # noqa: E402
from dicp_tpu.api import ICP as JICP  # noqa: E402
from dicp_tpu.api import batch_size_handling as jbatch  # noqa: E402
from dicp_tpu.config import ICPConfig as JConfig  # noqa: E402
from dicp_tpu.ops.fused_gn import fused_eligible as jfused_eligible  # noqa: E402
from dicp_tpu.registration import register as jregister  # noqa: E402

from dicp_tpu_torch import ICP, ICPConfig, register  # noqa: E402
from dicp_tpu_torch import knn as tknn  # noqa: E402
from dicp_tpu_torch.api import batch_size_handling  # noqa: E402
from dicp_tpu_torch.ops.fused_gn import fused_eligible  # noqa: E402

HUBER = {"name": "huber", "metric": 1.0}


class JaxNoise:
    """The port's noise protocol serving JAX's draws: the stream of pair i,
    iteration it and chunk c is uniform(fold_in(fold_in(fold_in(key, i),
    it), c)), as dicp_tpu derives it (registration.py:598, :367-372,
    knn.py:124)."""

    def __init__(self, key):
        self.key = key

    def _draw(self, k, iteration, chunk, shape):
        if iteration is not None:
            k = jax.random.fold_in(k, iteration)
        if chunk is not None:
            k = jax.random.fold_in(k, chunk)
        return np.array(jax.random.uniform(k, shape, dtype=jnp.float64))

    def uniform(self, pair_ids, iteration, chunk, shape, dtype, device):
        if pair_ids is None:
            u = self._draw(self.key, iteration, chunk, tuple(shape))
        else:
            u = np.stack([self._draw(jax.random.fold_in(self.key, i), iteration, chunk,
                                     tuple(shape[1:])) for i in pair_ids])
        return torch.as_tensor(u, dtype=dtype, device=device)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(a, b, atol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def _live(g):
    g = np.asarray(g)
    assert np.all(np.isfinite(g)) and np.any(g != 0)
    return g


# ---------------------------------------------------------------- gumbel_nn

@pytest.mark.parametrize("chunk", [None, 8])
def test_gumbel_nn_and_gradients_match_jax(chunk):
    """Dense (chunk None) and streamed (5 chunks, the last padded) soft
    neighbours and the gradients of sum(out^2) w.r.t. queries and targets,
    against JAX with its own draws injected."""
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(2, 7, 3)), rng.normal(size=(2, 33, 6))
    key = jax.random.PRNGKey(3)

    def jloss(a, b):
        return jnp.sum(jknn.gumbel_nn(a, b, key, tau=0.5, chunk=chunk) ** 2)

    out_j = jknn.gumbel_nn(jnp.asarray(x), jnp.asarray(y), key, tau=0.5, chunk=chunk)
    gx_j, gy_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    out_t = tknn.gumbel_nn(xt, yt, JaxNoise(key), tau=0.5, chunk=chunk)
    gx_t, gy_t = torch.autograd.grad((out_t ** 2).sum(), (xt, yt))
    _close(out_t.detach().numpy(), out_j)
    _close(_live(gx_t.numpy()), gx_j)
    _close(_live(gy_t.numpy()), gy_j)


def test_gumbel_auto_streaming_matches_jax():
    """Above 4096^2 entries per element the auto path streams, with JAX's
    chunk rule max(128, min(m, 4096^2 // n)) and a padded last chunk."""
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(4100, 3)), rng.normal(size=(4100, 3))
    key = jax.random.PRNGKey(5)
    out_j = jknn.gumbel_nn(jnp.asarray(x), jnp.asarray(y), key, tau=0.5)
    out_t = tknn.gumbel_nn(_t(x), _t(y), JaxNoise(key), tau=0.5)
    _close(out_t.numpy(), out_j)


def test_gumbel_streaming_matches_hard_nn_when_separated():
    """tests/test_nn.py:99-141 on the port's own draws: in the separated
    regime (lattice targets, tau 1e-3) dense and streamed Gumbel NN equal
    hard NN; the streamed path passes finite nonzero gradients to queries and
    targets; batched, non-divisible chunks stay inside the targets' box."""
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(40, 3)))
    lattice = rng.normal(size=(100, 3)) * 0.01 + rng.integers(-5, 5, size=(100, 3)) * 30.0
    y = _t(np.concatenate([lattice, rng.normal(size=(100, 3))], axis=-1))
    hard = tknn.hard_nn(x, y)
    dense = tknn.gumbel_nn(x, y, 0, tau=1e-3)
    stream = tknn.gumbel_nn(x, y, 0, tau=1e-3, chunk=32)
    _close(dense.numpy(), hard.numpy(), 1e-6)
    _close(stream.numpy(), hard.numpy(), 1e-6)

    xs = _t(rng.normal(size=(40, 3))).requires_grad_(True)
    ys = _t(rng.normal(size=(100, 6))).requires_grad_(True)
    gx, gy = torch.autograd.grad((tknn.gumbel_nn(xs, ys, 0, tau=0.5, chunk=32) ** 2).sum(),
                                 (xs, ys))
    _live(gx.numpy()), _live(gy.numpy())

    yb = _t(rng.normal(size=(2, 33, 6)))
    outb = tknn.gumbel_nn(_t(rng.normal(size=(2, 7, 3))), yb, 0, tau=0.5, chunk=8)
    assert outb.shape == (2, 7, 6) and bool(torch.isfinite(outb).all())
    lo, hi = yb.amin(dim=-2, keepdim=True), yb.amax(dim=-2, keepdim=True)
    assert bool((outb >= lo - 1e-9).all()) and bool((outb <= hi + 1e-9).all())


def test_noise_sources():
    """A seed and a torch.Generator give the threefry source, whose
    per-stream draws repeat, differ between streams, are JAX's for the
    seed's PRNGKey, leave torch's global generator untouched, and take
    their dtype; anything else is refused."""
    state = torch.get_rng_state()
    noise = tknn.gumbel_noise(11)
    assert isinstance(noise, tknn.ThreefryNoise)
    a = noise.uniform([0, 1], 3, None, (2, 4, 5), torch.float64, torch.device("cpu"))
    want = JaxNoise(jax.random.PRNGKey(11)).uniform([0, 1], 3, None, (2, 4, 5), torch.float64,
                                                     "cpu")
    assert torch.equal(a, want)
    b = tknn.gumbel_noise(11).uniform([1], 3, None, (1, 4, 5), torch.float64, "cpu")
    assert torch.equal(a[1:], b) and not torch.equal(a[0], a[1])
    assert not torch.equal(noise.uniform(None, 3, 0, (4, 5), torch.float64, "cpu"),
                           noise.uniform(None, 3, 1, (4, 5), torch.float64, "cpu"))
    assert bool(((a >= 0) & (a < 1)).all()) and a.dtype == torch.float64
    gen = torch.Generator().manual_seed(4)
    c = tknn.gumbel_noise(gen).uniform(None, None, None, (3,), torch.float32, "cpu")
    d = tknn.gumbel_noise(torch.Generator().manual_seed(4)).uniform(None, None, None, (3,),
                                                                     torch.float32, "cpu")
    assert torch.equal(c, d) and c.dtype == torch.float32
    assert torch.equal(torch.get_rng_state(), state)
    jn = JaxNoise(jax.random.PRNGKey(0))
    assert tknn.gumbel_noise(jn) is jn
    with pytest.raises(TypeError, match="uniform"):
        tknn.gumbel_noise("seed")


# ---------------------------------------------------------------- the solve

@pytest.mark.parametrize("case", ["pt2pl const_iter", "pt2pt early exit"])
def test_register_gumbel_matches_jax(source_np, target_np, case):
    """register(use_gumbel=True) against JAX's with JAX's streams injected:
    T within 1e-10, the same iteration counts."""
    if case.startswith("pt2pl"):
        kw = dict(icp_type="pt2pl", dim=2, const_iter=True, max_iterations=5,
                  trim_dist=5.0, loss_name="huber")
        tgt = np.stack([target_np] * 3)
    else:
        kw = dict(icp_type="pt2pt", dim=3, max_iterations=8, tolerance=1e-3,
                  gumbel_tau=0.5)
        tgt = np.stack([target_np[:, :3]] * 3)
    src = np.stack([source_np[:, :3] + o for o in (0.0, 0.05, -0.05)])
    ti = np.stack([np.eye(4)] * 3)
    key = jax.random.key(7)
    cfg = dict(differentiable=True, use_gumbel=True, **kw)
    res_j = jregister(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ti), cfg=JConfig(**cfg),
                      key=key)
    res_t = register(_t(src), _t(tgt), _t(ti), cfg=ICPConfig(**cfg), key=JaxNoise(key))
    _close(res_t.T.numpy(), res_j.T)
    np.testing.assert_array_equal(res_t.iterations.numpy(), np.asarray(res_j.iterations))
    assert bool(torch.isfinite(res_t.T).all())


def test_gumbel_solve_gradient_matches_jax(source_np, target_np):
    """Autograd through the unrolled Gumbel solve equals jax.grad with the
    same draws (soft correspondences: the query gets gradient too)."""
    src = source_np[None, :, :3]
    tgt, ti = target_np[None], np.eye(4)[None]
    cfg = dict(icp_type="pt2pl", dim=2, differentiable=True, use_gumbel=True,
               const_iter=True, max_iterations=3, trim_dist=5.0, loss_name="huber")
    key = jax.random.key(2)
    g_j = jax.grad(lambda s: jnp.sum(jregister(s, jnp.asarray(tgt), jnp.asarray(ti),
                                               cfg=JConfig(**cfg), key=key).T))(jnp.asarray(src))
    s = _t(src).requires_grad_(True)
    (g_t,) = torch.autograd.grad(
        register(s, _t(tgt), _t(ti), cfg=ICPConfig(**cfg), key=JaxNoise(key)).T.sum(), s)
    _close(_live(g_t.numpy()), g_j)


@pytest.mark.parametrize("key", [5, "generator"])
def test_gumbel_batch_chunk_and_prefix_are_bitwise(source_np, target_np, key):
    """One stream per GLOBAL batch element and iteration: batch_chunk equals
    the unchunked solve, and a 2-batch equals the first two rows of the
    4-batch, bit for bit (tests/test_icp_inputs.py:253-283)."""
    src = _t(np.stack([source_np[:, :3] + o for o in (0.0, 0.02, -0.03, 0.04)]))
    tgt, ti = _t(np.stack([target_np] * 4)), _t(np.stack([np.eye(4)] * 4))
    cfg = ICPConfig(icp_type="pt2pl", max_iterations=6, tolerance=1e-10, differentiable=True,
                    use_gumbel=True, dim=2, const_iter=True)

    def source():
        return torch.Generator().manual_seed(9) if key == "generator" else key

    full = register(src, tgt, ti, cfg=cfg, key=source())
    chunked = register(src, tgt, ti, cfg=cfg.with_(batch_chunk=3), key=source())
    first2 = register(src[:2], tgt[:2], ti[:2], cfg=cfg, key=source())
    for name, a, b, c in zip(full._fields, full, chunked, first2):
        assert torch.equal(a, b), name
        assert torch.equal(a[:2], c), name
    remat = register(src, tgt, ti, cfg=cfg.with_(remat=True), key=source())
    assert torch.equal(remat.T, full.T)


def test_icp_ragged_targets_take_the_far_sentinel(source_np, target_np):
    """ICP.icp with Gumbel NN on ragged targets: the pads are JAX's far
    sentinel (max |source| + 1) * target_pad_val in every column, and the
    solve equals JAX's with the same draws."""
    sources = [source_np[:50, :3], source_np[:, :3]]
    targets = [target_np[:55], target_np]
    _, tgt_t, _, _ = batch_size_handling(sources, targets, device="cpu", soft_nn=True,
                                         target_pad_val=1000.0)
    _, tgt_j, _, _ = jbatch([jnp.asarray(s) for s in sources],
                            [jnp.asarray(t) for t in targets], soft_nn=True)
    np.testing.assert_array_equal(tgt_t.numpy(), np.asarray(tgt_j))
    assert float(tgt_t[0, 55:].min()) > 1000.0 * float(np.abs(source_np[:, :3]).max())
    kw = dict(icp_type="pt2pl", differentiable=True, max_iterations=4, tolerance=1e-12)
    key = jax.random.key(1)
    solver = ICP(**kw, device="cpu")
    solver.use_gumbel = solver.nn.use_gumbel = True
    res_t = solver.icp(sources, targets, np.eye(4), trim_dist=5.0, loss_fn=HUBER, dim=2,
                       key=JaxNoise(key))
    jsolver = JICP(**kw)
    jsolver.use_gumbel = jsolver.nn.use_gumbel = True
    res_j = jsolver.icp([jnp.asarray(s) for s in sources], [jnp.asarray(t) for t in targets],
                        jnp.eye(4), trim_dist=5.0, loss_fn=HUBER, dim=2, key=key)
    _close(res_t["T"].numpy(), res_j["T"])
    assert bool(torch.isfinite(res_t["T"]).all())


def test_gumbel_needs_a_key_and_bypasses_k4(source_np, target_np):
    """Like JAX: a Gumbel solve without a noise source raises ValueError; a
    hard-NN config ignores the key; K4's gate is off whenever a key is
    given."""
    src, tgt, ti = _t(source_np[None, :, :3]), _t(target_np[None]), _t(np.eye(4)[None])
    cfg = dict(icp_type="pt2pl", differentiable=True, use_gumbel=True, dim=2)
    with pytest.raises(ValueError, match="key"):
        jregister(jnp.asarray(src.numpy()), jnp.asarray(tgt.numpy()), jnp.asarray(ti.numpy()),
                  cfg=JConfig(**cfg))
    with pytest.raises(ValueError, match="key"):
        register(src, tgt, ti, cfg=ICPConfig(**cfg))
    with pytest.raises(ValueError, match="key"):
        tknn.find_nn(src[0], tgt[0], use_gumbel=True)
    hard = ICPConfig(icp_type="pt2pl", differentiable=False, use_gumbel=True, dim=2,
                     max_iterations=10)
    assert torch.equal(register(src, tgt, ti, cfg=hard, key=3).T,
                       register(src, tgt, ti, cfg=hard).T)
    gate = dict(icp_type="pt2pl", differentiable=False, driver="while",
                collect_histories=False, fused_small=True, nn_method="dense")
    s32, t32 = src.float(), tgt.float()
    for key in (None, 1):
        want = jfused_eligible(JConfig(**gate), jnp.asarray(s32.numpy()),
                               jnp.asarray(t32.numpy()),
                               None if key is None else jax.random.key(key))
        assert fused_eligible(ICPConfig(**gate), s32, t32, key) == want == (key is None)
