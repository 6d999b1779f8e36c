"""The collectives of ``dicp_tpu_torch.parallel``: the cases of
``tests/test_parallel_hlo.py``, read from ``parallel._comm``'s counter (every
collective of the package goes through it, keyed by kind, group size and
elements) where JAX reads the compiled HLO.

Each case runs in a world of 8 gloo ranks (``tests/_torch_world.py``) and
also holds the port's result to JAX's on the same f64 inputs (T within
1e-10, gradients within 1e-8 relative)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import parallel as jp  # noqa: E402
from dicp_tpu.config import ICPConfig as JICPConfig  # noqa: E402
from dicp_tpu.registration import register_jit as j_register  # noqa: E402

from dicp_tpu_torch.convert import config_from_dict  # noqa: E402

from tests._torch_world import World  # noqa: E402
from tests.test_parallel_hlo import CFG as JCFG  # noqa: E402

CFG = config_from_dict(dataclasses.asdict(JCFG))
K = 8


@pytest.fixture(scope="module")
def world():
    w = World(K)
    yield w
    w.close()


def _jcfg(cfg):
    return JICPConfig(**dataclasses.asdict(cfg))


def _one(results, key):
    """The value every rank returned under ``key`` (collective counts
    included: the ranks run the same program)."""
    for r in results[1:]:
        np.testing.assert_equal(r[key], results[0][key])
    return results[0][key]


def _map(world, source, target, cfg, **kw):
    res = world.run("map_sharded", (1, K), source=np.asarray(source), target=np.asarray(target),
                    cfg=cfg, **kw)
    return {key: _one(res, key) for key in res[0]}


def test_batch_sharding_no_data_collectives(world, source_np, target_np):
    """The batch-parallel solve runs NO collective on any rank (JAX keeps one
    scalar all-reduce of the global convergence test; each rank's loop here
    stops on its own rows)."""
    src = np.stack([source_np[:, :3]] * K)
    tgt = np.stack([target_np] * K)
    ti = np.stack([np.eye(4)] * K)
    res = world.run("batch_sharded", (K, 1), source=src, target=tgt, T_init=ti, cfg=CFG)
    assert all(r["counts"] == [] for r in res), [r["counts"] for r in res]
    T = np.concatenate([r["T"] for r in res])
    ref = j_register(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ti), None, cfg=JCFG)
    np.testing.assert_allclose(T, np.asarray(ref.T), atol=1e-10)


def _jmap_fn(cfg, source, target, target_sharded=False):
    fn = jp.sharding.map_sharded_fn(jp.make_mesh((1, K)), _jcfg(cfg), axis="map",
                                    target_sharded=target_sharded)
    T, _, it, _ = fn(jnp.asarray(source), jnp.ones(source.shape[0]), jnp.asarray(target),
                     jnp.eye(4))
    return np.asarray(T), int(it)


def test_map_sharding_single_fused_psum(world, source_np, target_np):
    """One all-reduce per Gauss-Newton step, of the normal equations only
    ((k, k) + (k,) + the cost: 13 elements at dim 2, at most 43), plus the
    final cost pass; nothing else."""
    src = source_np[:64, :3]
    res = _map(world, src, target_np, CFG, weight=np.ones(64))
    it = res["iterations"]
    assert dict(res["counts_fwd"]) == {("all_reduce", K, 13): it + 1}, res["counts_fwd"]
    assert all(numel <= 43 for (_, _, numel), _ in res["counts_fwd"])
    T_j, it_j = _jmap_fn(CFG, src, target_np)
    np.testing.assert_allclose(res["T"], T_j, atol=1e-10)
    assert it == it_j


def test_ring_sharding_ppermute_only_for_map_shards(world, source_np, target_np):
    """The ring: the same one all-reduce per step, and K - 1 shifts per
    correspondence pass (at most K per step), each of one target shard
    (m/K rows), never the full map."""
    src, tgt = source_np[:64, :3], target_np[:64]
    res = _map(world, src, tgt, CFG, weight=np.ones(64), entry="register_ring_sharded")
    it = res["iterations"]
    counts = dict(res["counts_fwd"])
    assert counts == {("all_reduce", K, 13): it + 1,
                      ("ring_shift", K, (64 // K) * 6): (K - 1) * (it + 1)}, counts
    T_j, _ = _jmap_fn(CFG, src, tgt, target_sharded=True)
    np.testing.assert_allclose(res["T"], T_j, atol=1e-10)


def test_map_sharding_cluster_no_extra_collectives(world, source_np, target_np):
    """The cluster tier is rank-local compute: still ONE all-reduce per step,
    which with the certificate gate carries the gated and ungated equations
    and the certified count (2 x 13 + 1 elements, at most 87)."""
    cfg = CFG.with_(nn_method="cluster", cluster_group=16, cluster_probes=8)
    src = source_np[:64, :3]
    res = _map(world, src, target_np, cfg, weight=np.ones(64))
    it = res["iterations"]
    assert dict(res["counts_fwd"]) == {("all_reduce", K, 27): it + 1}, res["counts_fwd"]
    assert all(numel <= 87 for (_, _, numel), _ in res["counts_fwd"])
    T_j, it_j = _jmap_fn(cfg, src, target_np)
    np.testing.assert_allclose(res["T"], T_j, atol=1e-10)
    assert it == it_j


def test_map_sharded_ift_backward_constant_collectives(world, source_np, target_np):
    """The IFT backward adds a CONSTANT number of all-reduces (the (k, k)
    Jacobian, the target's cotangent, the source's), never one per
    iteration, and no shift: doubling max_iterations leaves it unchanged."""
    cfg = CFG.with_(differentiable=True, driver="auto", max_iterations=25)
    src = source_np[:64, :3]
    added = {}
    for iters in (25, 50):
        res = _map(world, src, target_np, cfg.with_(max_iterations=iters),
                   entry="register_map_sharded_ift", grad_wrt=("source",))
        bwd = dict(res["counts_bwd"])
        assert all(kind == "all_reduce" for kind, _, _ in bwd), bwd
        assert dict(res["counts_fwd"]) == {("all_reduce", K, 13): res["iterations"] + 1}
        added[iters] = sum(bwd.values())
        assert 0 < added[iters] <= 8, bwd
        mesh, tgt = jp.make_mesh((1, K)), jnp.asarray(target_np)
        jcfg = _jcfg(cfg.with_(max_iterations=iters))
        g_j = jax.jit(jax.grad(lambda s: jnp.sum(
            jp.register_map_sharded_ift(mesh, s, tgt, cfg=jcfg).T)))(jnp.asarray(src))
        g = res["grads"]["source"]
        assert np.abs(g - np.asarray(g_j)).max() < 1e-8 * np.abs(np.asarray(g_j)).max()
    assert added[25] == added[50], added
