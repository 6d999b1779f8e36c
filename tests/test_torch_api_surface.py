"""The port's call surface against the JAX package's: ``batch_size_handling``
takes JAX's positional order, the port exports ``config_from_yaml`` and the
``*_jit`` names (aliases of their eager functions: PyTorch runs eagerly),
and every name of ``dicp_tpu.__all__`` is either exported by the port or on
the list of names still to be ported, which ROADMAP.md mirrors."""

import dataclasses
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dicp_tpu  # noqa: E402
from dicp_tpu.api import batch_size_handling as jbatch  # noqa: E402
from dicp_tpu.config import config_from_yaml as j_config_from_yaml  # noqa: E402

import dicp_tpu_torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# dicp_tpu's public names that come with later slices (ROADMAP.md, Queue 1):
# none is left, so the check below asserts that the port covers dicp_tpu.__all__
STILL_TO_PORT = {}


def test_batch_size_handling_positional_order_matches_jax():
    """Ragged 6-column sources with the fifth positional argument 500.0: JAX
    reads it as target_pad_val (3-column sources out), and so must the port."""
    rng = np.random.default_rng(3)
    sources = [rng.normal(size=(5, 6)), rng.normal(size=(3, 6))]
    targets = [rng.normal(size=(7, 6)), rng.normal(size=(4, 6))]
    out_j = jbatch([jnp.asarray(s) for s in sources], [jnp.asarray(t) for t in targets],
                   None, None, 500.0)
    out_t = dicp_tpu_torch.batch_size_handling([torch.as_tensor(s) for s in sources],
                                               [torch.as_tensor(t) for t in targets],
                                               None, None, 500.0)
    assert out_t[0].shape == (2, 5, 3) and out_t[2] is None and out_j[2] is None
    for a, b in zip(out_t, out_j):
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # soft NN: the positional pad value scales the far sentinel as in JAX
    soft_j = jbatch([jnp.asarray(s) for s in sources], [jnp.asarray(t) for t in targets],
                    None, None, 500.0, False, True)
    soft_t = dicp_tpu_torch.batch_size_handling([torch.as_tensor(s) for s in sources],
                                                [torch.as_tensor(t) for t in targets],
                                                None, None, 500.0, False, True)
    np.testing.assert_allclose(soft_t[1].numpy(), np.asarray(soft_j[1]), rtol=1e-15, atol=0)


def test_config_from_yaml_is_exported_and_matches_jax():
    for kw in ({}, {"icp_type": "pt2pt", "max_iterations": 7, "tolerance": 1e-5,
                    "differentiable": False}):
        cfg_t = dicp_tpu_torch.config_from_yaml(None, **kw)
        cfg_j = j_config_from_yaml(None, **kw)
        assert isinstance(cfg_t, dicp_tpu_torch.ICPConfig)
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)


@pytest.mark.parametrize("name, eager, cfg_kw", [
    ("register_jit", "register", dict(differentiable=True)),
    ("register_ift_jit", "register_ift", dict(differentiable=True, collect_histories=False)),
    ("register_anderson_jit", "register_anderson",
     dict(differentiable=False, collect_histories=False)),
])
def test_jit_names_equal_their_eager_functions(source_np, target_np, name, eager, cfg_kw):
    jit_fn, eager_fn = getattr(dicp_tpu_torch, name), getattr(dicp_tpu_torch, eager)
    assert name in dicp_tpu_torch.__all__ and callable(jit_fn)
    cfg = dicp_tpu_torch.ICPConfig(icp_type="pt2pl", max_iterations=30, tolerance=1e-10,
                                   dim=2, trim_dist=5.0, loss_name="huber", **cfg_kw)
    src = torch.as_tensor(source_np[None, :, :3])
    tgt = torch.as_tensor(target_np[None])
    ti = torch.eye(4, dtype=torch.float64)[None]
    res_jit = jit_fn(src, tgt, ti, None, cfg=cfg)
    res_eager = eager_fn(src, tgt, ti, None, cfg=cfg)
    for a, b, field in zip(res_jit, res_eager, res_jit._fields):
        assert torch.equal(a, b), field
    # the reference pair's truth, inv(vec2tran([1, 1, 0, 0, 0, 0.1]))
    xi = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=torch.float64)
    T_true = dicp_tpu_torch.se3.tran_inv(dicp_tpu_torch.se3.vec2tran(xi))
    assert float((res_jit.T[0] - T_true).abs().max()) < 1e-8


def test_every_jax_public_name_is_exported_or_listed_as_to_come():
    ported = set(dicp_tpu_torch.__all__)
    listed = set(STILL_TO_PORT)
    assert not ported & listed, "a ported name is still listed as to come"
    assert set(dicp_tpu.__all__) <= ported | listed
    # the port's own order follows dicp_tpu.__all__
    shared = [n for n in dicp_tpu.__all__ if n in ported]
    assert [n for n in dicp_tpu_torch.__all__ if n in shared] == shared
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    missing = [n for n in sorted(listed) if f"`{n}`" not in roadmap]
    assert not missing, f"ROADMAP.md does not name {missing}"


def test_utils_names_match_jax_less_the_tpu_clock():
    """``dicp_tpu_torch.utils.__all__`` is ``dicp_tpu.utils.__all__`` in order
    without the TPU clock (``chained_rate``, ``device_timing_is_trustworthy``:
    the port times with CUDA events), and each helper takes JAX's parameters."""
    import dicp_tpu.utils as jutils

    import dicp_tpu_torch.utils as tutils

    clock = {"chained_rate", "device_timing_is_trustworthy"}
    assert clock <= set(jutils.__all__)
    assert tutils.__all__ == [n for n in jutils.__all__ if n not in clock]
    for name in tutils.__all__:
        assert (list(inspect.signature(getattr(tutils, name)).parameters)
                == list(inspect.signature(getattr(jutils, name)).parameters)), name


def test_parallel_names_match_jax():
    """``dicp_tpu_torch.parallel.__all__`` is ``dicp_tpu.parallel.__all__`` in
    order, and each function and multihost helper takes JAX's parameters,
    but for the mesh axis that ring_nn takes as a process group and the
    device choice that the initializing helpers add last."""
    import dicp_tpu.parallel as jpar
    import dicp_tpu.parallel.multihost as jmh

    import dicp_tpu_torch.parallel as tpar
    import dicp_tpu_torch.parallel.multihost as tmh

    assert tpar.__all__ == jpar.__all__
    assert tpar.MapShardedResult._fields == jpar.MapShardedResult._fields
    pairs = [(getattr(jpar, n), getattr(tpar, n)) for n in jpar.__all__ if n != "MapShardedResult"]
    pairs += [(getattr(jmh, n), getattr(tmh, n)) for n in (
        "initialize_distributed", "make_pod_mesh", "host_local_batch", "process_local_slice")]
    for j, t in pairs:
        pj = list(inspect.signature(j).parameters)
        pt = list(inspect.signature(t).parameters)
        if j.__name__ == "ring_nn":
            pj[pj.index("axis")] = "group"
        assert pt[:len(pj)] == pj and set(pt[len(pj):]) <= {"device", "devices"}, j.__name__
