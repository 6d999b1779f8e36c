"""Parity of the port's score-form 1-NN (``dicp_tpu_torch.benchmarks.exp_knn``,
kernels K6/K7) with the Pallas kernels it replaces (``benchmarks/exp_knn.py``
``nn_v1``/``nn_v2``), which run here on the CPU inside
``pltpu.force_tpu_interpret_mode()``.  Same numpy inputs through both.

The plain versions fix the score's summation order, ((x0 a0 + x1 a1) +
x2 a2) + |y|^2; XLA's 8-wide dot may order it otherwise, so against JAX the
indices agree except at f32 near-ties: a flip is accepted where the two
candidates' true (f64) squared distances differ by less than ``check``'s
bound 64 eps R^2, and the scores agree within the same bound."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from benchmarks import exp_knn as jexp  # noqa: E402

from dicp_tpu_torch.benchmarks import exp_knn as texp  # noqa: E402

TQ, TM = 64, 256


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _case(name):
    rng = np.random.default_rng(10)
    if name == "ragged":  # 3 query tiles x 3 target tiles, both ragged
        return (rng.uniform(-50, 50, (150, 3)).astype(np.float32),
                rng.uniform(-50, 50, (700, 3)).astype(np.float32))
    if name == "duplicated targets":  # every minimum tied across two tiles
        base = rng.uniform(-50, 50, (200, 3)).astype(np.float32)
        x = base[:100] + rng.normal(scale=1e-2, size=(100, 3)).astype(np.float32)
        return x, np.concatenate([base, base, base[:50]])
    return rng.uniform(-50, 50, (100, 3)), rng.uniform(-50, 50, (300, 3))  # f64


def _tie_tol(x, y):
    r2 = max(np.abs(x).max(), np.abs(y).max()) ** 2
    return 64 * np.finfo(np.float32).eps * r2


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("case", ["ragged", "duplicated targets", "f64"])
def test_plain_matches_pallas_interpret(case, variant):
    x, y = _case(case)
    with pltpu.force_tpu_interpret_mode():
        idx_j, s_j = getattr(jexp, f"nn_{variant}")(jnp.asarray(x), jnp.asarray(y), tq=TQ, tm=TM)
    idx_j, s_j = np.asarray(idx_j), np.asarray(s_j)
    idx_t, s_t = getattr(texp, f"nn_{variant}_plain")(_t(x), _t(y), tq=TQ, tm=TM)
    assert idx_t.dtype == torch.int32 and s_t.dtype == torch.float32
    assert idx_t.shape == s_t.shape == (len(x),)
    idx_t, s_t = idx_t.numpy(), s_t.numpy()
    tol = _tie_tol(x, y)
    d2 = np.sum((np.float64(x)[:, None] - np.float64(y)[None]) ** 2, axis=-1)
    rows = np.nonzero(idx_t != idx_j)[0]
    assert np.all(np.abs(d2[rows, idx_t[rows]] - d2[rows, idx_j[rows]]) < tol)
    assert len(rows) <= len(x) // 50
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=tol)
    if case == "duplicated targets":  # a tie goes to the first copy
        assert np.all(idx_t < 200) and np.all(idx_j < 200)


@pytest.mark.parametrize("tm", [1, 7, 64, 256])
def test_split_reduction_equals_single_tile_carry(tm):
    """v1's partials reduced in tile order with a strict '<' equal one tile
    holding every column, bit for bit, and so does v2's streamed carry:
    the first global argmin, ties included."""
    rng = np.random.default_rng(11)
    base = np.round(rng.uniform(-20, 20, (120, 3)), 1)
    x, y = _t(rng.uniform(-20, 20, (90, 3))), _t(np.concatenate([base, base[::-1], base[:17]]))
    one = texp.nn_v1_plain(x, y, tm=1024)
    for got in (texp.nn_v1_plain(x, y, tq=8, tm=tm), texp.nn_v2_plain(x, y, tq=8, tm=tm)):
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
    x8, y8, _ = texp._packed(x, y, 1024)
    s = texp._tile_min(x8, y8, 0, 1024)
    assert torch.equal(s[1], one[0]) and torch.equal(s[0], one[1])
    ref = torch.argmin(torch.cdist(x.double(), y.double()), dim=1)
    assert int((one[0] == ref).sum()) >= 88


def test_check_main_and_variants_on_cpu(capsys):
    """The harness imports and runs on the CPU at a tiny size: ``check``
    accepts every variant against the f64 argmin and rejects a wrong index;
    each of the seven rows runs on CPU tensors; ``main`` needs the card."""
    rng = np.random.default_rng(12)
    x = _t(rng.uniform(-50, 50, (70, 3)).astype(np.float32))
    y = _t(rng.uniform(-50, 50, (300, 3)).astype(np.float32))
    assert len(texp.VARIANTS) == 7 and [n for n, _ in texp.CHECKED] == ["v0", "v1", "v2"]
    for name, fn in texp.CHECKED + texp.VARIANTS:
        assert texp.check(name, fn, x, y), name
    assert not texp.check("wrong", lambda a, b: (torch.zeros(len(a), dtype=torch.int32),
                                                 None), x, y)
    assert "REAL ERROR" in capsys.readouterr().out
    assert texp.nn_v1.launches == texp.nn_v2.launches == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            texp.main(check_n=8, time_n=8)


def test_wrappers_route_and_check():
    """A device other than cpu or cuda raises; so do bad shapes, dtypes,
    empty targets, split devices and non-positive tiles.  n = 0 gives empty
    results."""
    for fn in (texp.nn_v1, texp.nn_v2):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(torch.zeros(5, 3, device="meta"), torch.zeros(5, 3, device="meta"))
        with pytest.raises(ValueError, match=r"\(n, 3\)"):
            fn(torch.zeros(5, 2), torch.zeros(5, 3))
        with pytest.raises(TypeError, match="floating point"):
            fn(torch.zeros(5, 3, dtype=torch.int64), torch.zeros(5, 3))
        with pytest.raises(ValueError, match="at least one target"):
            fn(torch.zeros(5, 3), torch.zeros(0, 3))
        with pytest.raises(ValueError, match="positive"):
            fn(torch.zeros(5, 3), torch.zeros(5, 3), tm=0)
        idx, s = fn(torch.zeros(0, 3), torch.ones(4, 3))
        assert idx.shape == s.shape == (0,)
