"""``dicp_tpu_torch.parallel`` against ``dicp_tpu.parallel``: the cases of
``tests/test_parallel.py``, f64 on the CPU.

The port runs in a world of 8 gloo ranks (``tests/_torch_world.py``), each an
OS process that calls the entry point SPMD with the same global arguments;
the JAX side runs in this process on the suite's 8 virtual devices, on the
same meshes.  Beside each JAX contract, run on the port:

* T within 1e-10 of JAX's on the same inputs, and the same on every rank;
* gradients (source, target, weight; unrolled and IFT) within 1e-8 relative
  of ``jax.grad``'s, the same on every rank, and IFT against unrolled within
  JAX's 1e-5;
* ``ring_nn`` equal to ``hard_nn`` (atol 0) and to JAX's ``ring_nn`` rows,
  and its gradient into the target shards (the reverse ring) within 1e-10
  of ``jax.grad``'s;
* the ring-sharded solve's gradients into the source, the sharded target
  and the weight within 1e-8 relative of ``jax.grad``'s, padded or not;
* the map-sharded and ring Hessian-vector products on 1 and 2 ranks of
  the map axis within 1e-8 relative of JAX's, host loop and fixed trip;
  the sharded IFT refusing a second derivative, as JAX's does.

``test_multihost_single_process_fallbacks`` lives in
``tests/test_torch_multihost.py`` with the multi-process recipe."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import parallel as jp  # noqa: E402
from dicp_tpu.config import ICPConfig as JICPConfig  # noqa: E402
from dicp_tpu.ops import cluster_knn as j_cluster_knn  # noqa: E402
from dicp_tpu.registration import register_jit as j_register  # noqa: E402

from dicp_tpu_torch import se3  # noqa: E402
from dicp_tpu_torch.config import ICPConfig  # noqa: E402
from dicp_tpu_torch.convert import config_from_dict  # noqa: E402
from dicp_tpu_torch.knn import hard_nn  # noqa: E402
from dicp_tpu_torch.ops import cluster_knn as port_cluster_knn  # noqa: E402
from dicp_tpu_torch.registration import register  # noqa: E402

from tests._torch_world import World  # noqa: E402
from tests.test_parallel import CFG as JCFG  # noqa: E402

CFG = config_from_dict(dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def world():
    w = World(8)
    yield w
    w.close()


def _jcfg(cfg: ICPConfig) -> JICPConfig:
    return JICPConfig(**dataclasses.asdict(cfg))


def _t_true():
    xi = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=torch.float64)
    return se3.tran_inv(se3.vec2tran(xi)).numpy()


def _err(T_a, T_b) -> float:
    d = torch.as_tensor(np.asarray(T_a)) @ torch.linalg.inv(torch.as_tensor(np.asarray(T_b)))
    return float(torch.linalg.vector_norm(se3.tran2vec(d)))


def _same_on_ranks(results, key="T"):
    """The one value every rank returned under ``key``."""
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])
    return results[0][key]


def _map(world, shape, source, target, cfg, **kw):
    res = world.run("map_sharded", shape, source=np.asarray(source), target=np.asarray(target),
                    cfg=cfg, **kw)
    for r in res[1:]:
        assert r["converged"] == res[0]["converged"] and r["iterations"] == res[0]["iterations"]
    return res[0] | {"T": _same_on_ranks(res)}, res


def _jmap(shape, source, target, cfg, entry="register_map_sharded", **kw):
    res = getattr(jp, entry)(jp.make_mesh(shape), jnp.asarray(source), jnp.asarray(target),
                             cfg=_jcfg(cfg), **kw)
    return np.asarray(res.T), int(res.iterations)


def _batch(world, shape, source, target, T_init, cfg):
    """The batch-sharded rows of every rank, assembled in global order."""
    res = world.run("batch_sharded", shape, source=source, target=target, T_init=T_init, cfg=cfg)
    out = {}
    for key in ("T", "matched_ratio", "converged", "iterations"):
        rows = np.concatenate([r[key] for r in res])
        order = np.argsort(np.concatenate([r["rows"] for r in res]))
        out[key] = rows[order]
    assert all(r["counts"] == [] for r in res), "the batch-sharded solve ran a collective"
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _jgrad(fn, argnums=0):
    """jax.grad under jit: eagerly, the sharded IFT backward dispatches its
    shard_map op by op (~80 s a call here against ~3 s compiled)."""
    return jax.jit(jax.grad(fn, argnums=argnums))


def _grads_all_ranks(res, names):
    for r in res[1:]:
        for name in names:
            np.testing.assert_array_equal(r["grads"][name], res[0]["grads"][name])
    return [res[0]["grads"][name] for name in names]


def test_requires_8_devices(world):
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    info = world.run("world_info", (1, 8))
    assert [i["rank"] for i in info] == list(range(8))
    assert all(i["world"] == 8 and i["backend"] == "gloo" and i["mesh"] == (1, 8)
               for i in info)


def test_batch_sharded_equals_single_device(world, source_np, target_np):
    src = np.stack([source_np[:, :3]] * 8)
    tgt = np.stack([target_np] * 8)
    ti = np.stack([np.eye(4)] * 8)
    sharded = _batch(world, (8, 1), src, tgt, ti, CFG)
    single = register(torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(ti), None,
                      CFG)
    np.testing.assert_allclose(sharded["T"], single.T.numpy(), atol=1e-12)
    np.testing.assert_allclose(sharded["matched_ratio"], single.matched_ratio.numpy(),
                               atol=1e-12)
    ref = j_register(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ti), None, cfg=JCFG)
    np.testing.assert_allclose(sharded["T"], np.asarray(ref.T), atol=1e-10)


def test_batch_sharded_heterogeneous(world, target_np):
    """Different per-element inputs stay independent across ranks."""
    srcs, T_trues = [], []
    for i in range(8):
        xi = np.zeros(6)
        xi[5] = 0.02 * i
        T = se3.vec2tran(torch.as_tensor(xi)).numpy()
        srcs.append(target_np[:, :3] @ T[:3, :3].T + T[:3, 3])
        T_trues.append(np.linalg.inv(T))
    src, tgt = np.stack(srcs), np.stack([target_np] * 8)
    ti = np.stack([np.eye(4)] * 8)
    res = _batch(world, (8, 1), src, tgt, ti, CFG)
    for i in range(8):
        assert _err(T_trues[i], res["T"][i]) < 1e-6, i
    ref = jp.register_batch_sharded(jp.make_mesh((8, 1)), jnp.asarray(src), jnp.asarray(tgt),
                                    jnp.asarray(ti), cfg=JCFG)
    np.testing.assert_allclose(res["T"], np.asarray(ref.T), atol=1e-10)


def test_batch_sharded_gumbel_streams_follow_the_global_batch(world, source_np, target_np):
    """With Gumbel NN each rank's rows draw from the streams of their GLOBAL
    batch index: the rows equal one unsharded solve with the same seed."""
    cfg = CFG.with_(use_gumbel=True, max_iterations=10)
    src = np.stack([source_np[:, :3] + 0.01 * i for i in range(8)])
    tgt = np.stack([target_np] * 8)
    ti = np.stack([np.eye(4)] * 8)
    res = world.run("batch_sharded", (8, 1), source=src, target=tgt, T_init=ti, cfg=cfg, key=7)
    T = np.concatenate([r["T"] for r in res])
    ref = register(torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(ti), None, cfg,
                   key=7)
    np.testing.assert_array_equal(T, ref.T.numpy())
    assert not np.array_equal(T[0], T[1])


def test_map_sharded_matches_dense(world, source_np, target_np):
    """All-reduced normal equations == the dense single-device solve."""
    res, _ = _map(world, (1, 8), source_np[:, :3], target_np, CFG)
    dense = register(torch.as_tensor(source_np[None, :, :3]), torch.as_tensor(target_np[None]),
                     torch.eye(4, dtype=torch.float64)[None], None, CFG)
    assert _err(dense.T[0].numpy(), res["T"]) < 1e-10
    assert res["converged"]
    assert _err(_t_true(), res["T"]) < 1e-7
    T_j, it_j = _jmap((1, 8), source_np[:, :3], target_np, CFG)
    np.testing.assert_allclose(res["T"], T_j, atol=1e-10)
    assert res["iterations"] == it_j


def test_map_sharded_nondiff_early_exit(world, source_np, target_np):
    cfg = CFG.with_(differentiable=False)
    res, _ = _map(world, (1, 8), source_np[:, :3], target_np, cfg)
    assert res["converged"]
    assert res["iterations"] < 25
    assert _err(_t_true(), res["T"]) < 1e-7
    T_j, it_j = _jmap((1, 8), source_np[:, :3], target_np, cfg)
    np.testing.assert_allclose(res["T"], T_j, atol=1e-10)
    assert res["iterations"] == it_j


def _perturbed_pair(source_np):
    """The pair with planar noise on the source and prior weights: its fixed
    point has nonzero residuals, so the weight gradient is not rounding
    noise (on the exact-fit pair it is identically zero)."""
    rng = np.random.default_rng(11)
    src = source_np[:, :3] + rng.normal(scale=2e-2, size=(65, 3)) * [1, 1, 0]
    return src, rng.uniform(0.5, 1.5, (src.shape[0],))


def test_map_sharded_gradient(world, source_np, target_np):
    """Gradients flow through the all-reduced solve (training path): finite,
    nonzero, equal on every rank and to jax.grad's; on the perturbed pair
    into the source, the target and the weight."""
    cfg = CFG.with_(max_iterations=10)
    mesh = jp.make_mesh((1, 8))
    _, res = _map(world, (1, 8), source_np[:, :3], target_np, cfg, grad_wrt=("source",))
    (g,) = _grads_all_ranks(res, ("source",))
    assert np.all(np.isfinite(g)) and np.any(g != 0)
    g_j = _jgrad(lambda s: jnp.sum(jp.register_map_sharded(
        mesh, s, jnp.asarray(target_np), cfg=_jcfg(cfg)).T))(jnp.asarray(source_np[:, :3]))
    assert _rel(g, g_j) < 1e-8

    src, w = _perturbed_pair(source_np)
    names = ("source", "target", "weight")
    _, res = _map(world, (1, 8), src, target_np, cfg, weight=w, grad_wrt=names)
    theirs = _jgrad(lambda s, t, w_: jnp.sum(jp.register_map_sharded(
        mesh, s, t, weight=w_, cfg=_jcfg(cfg)).T), (0, 1, 2))(
        jnp.asarray(src), jnp.asarray(target_np), jnp.asarray(w))
    for a, b, name in zip(_grads_all_ranks(res, names), theirs, names):
        assert _rel(a, b) < 1e-8, (name, _rel(a, b))


def test_map_sharded_pt2pt(world, source_np, target_np):
    cfg = CFG.with_(icp_type="pt2pt", max_iterations=40)
    res, _ = _map(world, (1, 8), source_np[:, :3], target_np[:, :3], cfg)
    assert _err(_t_true(), res["T"]) < 1e-6
    T_j, _ = _jmap((1, 8), source_np[:, :3], target_np[:, :3], cfg)
    np.testing.assert_allclose(res["T"], T_j, atol=1e-10)


def test_mesh_2d_both_axes(world, source_np, target_np):
    """4x2 mesh: four batch rows, each a map-sharded solve over two ranks."""
    res, _ = _map(world, (4, 2), source_np[:, :3], target_np, CFG)
    assert _err(_t_true(), res["T"]) < 1e-7
    T_j, _ = _jmap((4, 2), source_np[:, :3], target_np, CFG)
    np.testing.assert_allclose(res["T"], T_j, atol=1e-10)


def test_ring_nn_matches_replicated(world, source_np, target_np):
    """ring_nn over sharded targets == hard NN over the replicated target,
    and == JAX's ring_nn; its gradient into the target shards (K - 1 = 7
    reverse shifts of one shard, the transpose of JAX's ppermute) within
    1e-10 of jax.grad's."""
    from jax.sharding import PartitionSpec as P

    x, y = source_np[:64, :3], target_np[:64]       # 8 queries and 8 targets per rank
    probe = np.random.default_rng(3).uniform(-1.0, 1.0, size=y.shape)
    res = world.run("ring_nn", (1, 8), x=x, y=y, probe=probe)
    got = np.concatenate([r["rows"] for r in res])
    want = hard_nn(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, want, atol=0)
    fn = jax.jit(jax.shard_map(lambda xs, ys: jp.ring_nn(xs, ys, "map"), mesh=jp.make_mesh((1, 8)),
                               in_specs=(P("map"), P("map")), out_specs=P("map")))
    np.testing.assert_array_equal(got, np.asarray(fn(jnp.asarray(x), jnp.asarray(y))))
    grad = np.concatenate([r["grad"] for r in res])
    g_j = jax.jit(jax.grad(lambda ys: jnp.sum(fn(jnp.asarray(x), ys) * probe)))(jnp.asarray(y))
    assert np.abs(grad).max() > 0 and _rel(grad, g_j) < 1e-10, _rel(grad, g_j)
    assert all(r["counts_bwd"] == [(("ring_shift_reverse", 8, 8 * 6), 7)] for r in res), \
        res[0]["counts_bwd"]


def _ring_gradients(world, shape, src, tgt, cfg, w):
    """The ring-sharded solve's gradients of sum(T) into the source, the
    target and the weight (the same on every rank), each against
    jax.grad's (under jax.jit) within 1e-8 relative, finite and nonzero;
    the backward's reverse shifts: K - 1 per iteration's ring call."""
    names = ("source", "target", "weight")
    res, ranks = _map(world, shape, src, tgt, cfg, weight=w, grad_wrt=names,
                      entry="register_ring_sharded")
    mesh = jp.make_mesh(shape)
    theirs = _jgrad(lambda s, t, w_: jnp.sum(jp.register_ring_sharded(
        mesh, s, t, weight=w_, cfg=_jcfg(cfg)).T), (0, 1, 2))(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    for a, b, name in zip(_grads_all_ranks(ranks, names), theirs, names):
        assert a.shape == b.shape and np.all(np.isfinite(a)) and np.abs(a).max() > 0, name
        assert _rel(a, b) < 1e-8, (name, _rel(a, b))
    k = shape[1]
    for r in ranks:
        shifts = {key: n for key, n in r["counts_bwd"] if key[0] == "ring_shift_reverse"}
        assert shifts == {("ring_shift_reverse", k, (-(-tgt.shape[0] // k)) * tgt.shape[1]):
                          (k - 1) * res["iterations"]}, shifts


def test_ring_sharded_registration(world, source_np, target_np):
    """Source AND target sharded: the truth, and the map-sharded result;
    differentiated (the perturbed pair, 10 iterations), the gradients into
    the source, the sharded target (points and normals; 7 sentinel rows pad
    it to 72) and the weight equal jax.grad's within 1e-8 relative."""
    res, _ = _map(world, (1, 8), source_np[:, :3], target_np, CFG,
                  entry="register_ring_sharded")
    assert res["converged"]
    assert _err(_t_true(), res["T"]) < 1e-7
    dense, _ = _map(world, (1, 8), source_np[:, :3], target_np, CFG)
    assert _err(dense["T"], res["T"]) < 1e-10
    T_j, _ = _jmap((1, 8), source_np[:, :3], target_np, CFG, entry="register_ring_sharded")
    np.testing.assert_allclose(res["T"], T_j, atol=1e-10)

    src, w = _perturbed_pair(source_np)
    _ring_gradients(world, (1, 8), src, target_np, CFG.with_(max_iterations=10), w)


def test_ring_sharded_pt2pt_and_padding(world, source_np, target_np):
    """65 % 4 != 0: source zero pads and target sentinel rows."""
    cfg = CFG.with_(icp_type="pt2pt", max_iterations=40)
    res, _ = _map(world, (2, 4), source_np[:, :3], target_np[:, :3], cfg,
                  entry="register_ring_sharded")
    assert _err(_t_true(), res["T"]) < 1e-6
    T_j, _ = _jmap((2, 4), source_np[:, :3], target_np[:, :3], cfg,
                   entry="register_ring_sharded")
    np.testing.assert_allclose(res["T"], T_j, atol=1e-10)


def test_ring_sharded_gradient_pt2pt_padded(world, source_np, target_np):
    """The same inputs on the (2, 4) mesh (three sentinel target rows and
    three zero-weight source pads on each ring of 4), perturbed, pt2pt:
    the gradients into the source, the target and the weight equal
    jax.grad's within 1e-8 relative; the pads' share is dropped."""
    src, w = _perturbed_pair(source_np)
    _ring_gradients(world, (2, 4), src, target_np[:, :3],
                    CFG.with_(icp_type="pt2pt", max_iterations=10), w)


def test_map_sharded_nondefault_axis(world, source_np, target_np):
    """The all-reduce and the ring run on the axis asked for: all 8 ranks on
    'batch'."""
    for entry in ("register_map_sharded", "register_ring_sharded"):
        res, _ = _map(world, (8, 1), source_np[:, :3], target_np, CFG, entry=entry,
                      axis="batch")
        assert _err(_t_true(), res["T"]) < 1e-7, entry
        assert ("all_reduce", 8, 13) in dict(res["counts_fwd"]), res["counts_fwd"]
        T_j, _ = _jmap((8, 1), source_np[:, :3], target_np, CFG, entry=entry, axis="batch")
        np.testing.assert_allclose(res["T"], T_j, atol=1e-10)


def test_map_sharded_symmetric(world, planes_scene):
    """Map-sharded symmetric ICP against the dense single-device solve."""
    cfg = ICPConfig(icp_type="symmetric", differentiable=False, max_iterations=60,
                    tolerance=1e-12, dim=3, trim_dist=2.0, loss_name="huber", loss_metric=1.0)
    xi = np.array([0.2, -0.1, 0.15, 0.03, -0.02, 0.04])
    T_st = se3.vec2tran(torch.as_tensor(xi)).numpy()
    src6 = np.hstack([planes_scene[:, :3] @ T_st[:3, :3].T + T_st[:3, 3],
                      planes_scene[:, 3:6] @ T_st[:3, :3].T])
    res, _ = _map(world, (1, 8), src6, planes_scene, cfg)
    dense = register(torch.as_tensor(src6[None]), torch.as_tensor(planes_scene[None]),
                     torch.eye(4, dtype=torch.float64)[None], None, cfg)
    assert _err(dense.T[0].numpy(), res["T"]) < 1e-10
    assert _err(np.linalg.inv(T_st), res["T"]) < 1e-8
    assert res["converged"]
    T_j, _ = _jmap((1, 8), src6, planes_scene, cfg)
    np.testing.assert_allclose(res["T"], T_j, atol=1e-10)

    # a 3-column source is a clear error, on every rank, before any collective
    err = world.run("map_sharded", (1, 8), source=src6[:, :3], target=planes_scene, cfg=cfg,
                    expect_error=True)
    assert all("6-column" in r["error"] for r in err)


def test_map_sharded_cluster_matches_dense(world, source_np, target_np):
    """The cluster tier (index over the replicated target on every rank,
    queries rank-local) matches the dense tier exactly."""
    base = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=50, tolerance=1e-10,
                     dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0)
    cluster = base.with_(nn_method="cluster", cluster_group=16, cluster_probes=8)
    res_d, _ = _map(world, (1, 8), source_np[:, :3], target_np, base.with_(nn_method="dense"))
    res_c, _ = _map(world, (1, 8), source_np[:, :3], target_np, cluster)
    np.testing.assert_allclose(res_c["T"], res_d["T"], atol=1e-12)
    assert _err(_t_true(), res_c["T"]) < 1e-7
    T_j, it_j = _jmap((1, 8), source_np[:, :3], target_np, cluster)
    np.testing.assert_allclose(res_c["T"], T_j, atol=1e-10)
    assert res_c["iterations"] == it_j


def test_map_sharded_fused_parity(world, source_np, target_np):
    """cfg.sharded_fused=True (K2's plain version on CPU tensors) reproduces
    the group-scan path exactly: pose, convergence and iteration count."""
    base = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=50, tolerance=1e-10,
                     dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0,
                     nn_method="cluster", cluster_group=16, cluster_probes=8)
    res_x, _ = _map(world, (1, 8), source_np[:, :3], target_np, base.with_(sharded_fused=False))
    res_f, _ = _map(world, (1, 8), source_np[:, :3], target_np, base.with_(sharded_fused=True))
    np.testing.assert_allclose(res_f["T"], res_x["T"], atol=1e-12)
    assert res_f["iterations"] == res_x["iterations"]
    assert res_f["converged"] == res_x["converged"]
    T_j, it_j = _jmap((1, 8), source_np[:, :3], target_np, base.with_(sharded_fused=False))
    np.testing.assert_allclose(res_f["T"], T_j, atol=1e-10)
    assert res_f["iterations"] == it_j


def _certified(cluster_knn, shard, target, cfg: ICPConfig):
    """The queries that the map-sharded solve's first search certifies on
    one shard at T_init = I, by ``cluster_knn`` (JAX's module or the
    port's): the index over the target, the query order at T_init,
    cluster_nn with the solve's probes, backend and fix-up budget."""
    index = cluster_knn.build_cluster_index(target, cfg.cluster_group)
    _, _, cert = cluster_knn.cluster_nn(
        index, shard, probes=cfg.cluster_probes, use_pallas=False, fused=cfg.sharded_fused,
        order=cluster_knn.query_order(index, shard),
        fixup=cfg.resolved_cluster_fixup(shard.shape[0]))
    return cert.sum()


def test_map_sharded_cluster_certificates_on_four_ranks(world, source_np, target_np):
    """The cluster tier on 4 'map' ranks (a (2, 4) mesh) against JAX's
    (1, 4) mesh, on a pair that one rank and four certify differently (a
    fix-up budget of 2; each rank sorts and blocks its own queries): each
    rank's certified count at T_init (its solve's first search) equals what
    JAX's shard_map body certifies on the same shard, and the converged T
    is within 1e-10 of JAX's register_map_sharded_ift's forward (on these
    inputs register_map_sharded's solve).  The sharded IFT gradient's
    cosine with JAX's is printed: the port searches the backward's cluster
    tier in the forward's query order, JAX re-sorts at theta* (ROADMAP,
    Queue 3's deviations)."""
    cfg = CFG.with_(max_iterations=50, tolerance=1e-10, nn_method="cluster", cluster_group=8,
                    cluster_probes=3, cluster_fixup=2)
    src = _perturbed_pair(source_np)[0][:64]
    res, ranks = _map(world, (2, 4), src, target_np, cfg, entry="register_map_sharded_ift",
                      grad_wrt=("source",), certified=True)
    count = jax.jit(lambda t, q: _certified(j_cluster_knn, q, t, cfg))
    want = [int(count(jnp.asarray(target_np[:, :3]), jnp.asarray(shard)))
            for shard in np.split(src, 4)]
    got = {r["coordinate"]: r["certified"][0] for r in ranks}
    assert all(r["certified"][0] == want[r["coordinate"]] for r in ranks), (got, want)
    one = int(_certified(port_cluster_knn, torch.as_tensor(src), torch.as_tensor(target_np[:, :3]),
                         cfg))
    assert one != sum(want), (one, want)
    assert res["converged"]
    mesh, jcfg = jp.make_mesh((1, 4), devices=jax.devices()[:4]), _jcfg(cfg)
    (_, T_j), g_j = jax.jit(jax.value_and_grad(
        lambda s: (lambda r: (jnp.sum(r.T), r.T))(jp.register_map_sharded_ift(
            mesh, s, jnp.asarray(target_np), cfg=jcfg)), has_aux=True))(jnp.asarray(src))
    np.testing.assert_allclose(res["T"], np.asarray(T_j), atol=1e-10)
    (g,) = _grads_all_ranks(ranks, ("source",))
    g_j = np.asarray(g_j)
    cos = float(np.sum(g * g_j) / (np.linalg.norm(g) * np.linalg.norm(g_j)))
    assert _rel(g, g_j) < 1e-8, (cos, _rel(g, g_j))
    print(f"certified at T_init by rank coordinate: port {dict(sorted(got.items()))}, JAX "
          f"{want}, one rank {one}; IFT gradient cosine with JAX's {cos:.9f}, "
          f"|g - g_jax| / |g_jax| {_rel(g, g_j):.3e}")


def test_map_sharded_ift_gradients_match_unrolled(world, source_np, target_np):
    """The IFT backward against the unrolled one within 1e-5 for source,
    target and weight (JAX's contract), and each against jax.grad's within
    1e-8 relative, on a perturbed pair whose fixed point has nonzero
    residuals."""
    cfg = CFG.with_(max_iterations=80, tolerance=1e-14)
    src, w = _perturbed_pair(source_np)
    probe = np.linspace(0.5, 1.5, 16).reshape(4, 4)
    names = ("source", "target", "weight")
    kw = dict(weight=w, grad_wrt=names, probe=probe)
    res_i, all_i = _map(world, (1, 8), src, target_np, cfg, entry="register_map_sharded_ift",
                        **kw)
    res_u, all_u = _map(world, (1, 8), src, target_np, cfg, **kw)
    assert res_i["converged"]
    assert _err(res_i["T"], res_u["T"]) < 1e-9
    g_i, g_u = _grads_all_ranks(all_i, names), _grads_all_ranks(all_u, names)
    for a, b, name in zip(g_i, g_u, names):
        assert _rel(a, b) < 1e-5, name

    mesh, jcfg, jprobe = jp.make_mesh((1, 8)), _jcfg(cfg), jnp.asarray(probe)
    args = (jnp.asarray(src), jnp.asarray(target_np), jnp.asarray(w))
    for ours, fn in ((g_i, jp.register_map_sharded_ift), (g_u, jp.register_map_sharded)):
        theirs = _jgrad(lambda s, t, w_, fn=fn: jnp.sum(
            fn(mesh, s, t, weight=w_, cfg=jcfg).T * jprobe), (0, 1, 2))(*args)
        for a, b, name in zip(ours, theirs, names):
            assert _rel(a, b) < 1e-8, (fn.__name__, name, _rel(a, b))


def test_map_sharded_ift_pt2pt(world, source_np, target_np):
    """The same contract for the pt2pt residual (3-vector errors)."""
    cfg = CFG.with_(icp_type="pt2pt", max_iterations=60, tolerance=1e-12)
    src, tgt = source_np[:, :3], target_np[:, :3]
    res_i, all_i = _map(world, (1, 8), src, tgt, cfg, entry="register_map_sharded_ift",
                        grad_wrt=("source",))
    _, all_u = _map(world, (1, 8), src, tgt, cfg, grad_wrt=("source",))
    assert res_i["converged"]
    assert _err(_t_true(), res_i["T"]) < 1e-6
    (g_i,), (g_u,) = _grads_all_ranks(all_i, ("source",)), _grads_all_ranks(all_u, ("source",))
    assert _rel(g_i, g_u) < 1e-5

    mesh, jcfg, t = jp.make_mesh((1, 8)), _jcfg(cfg), jnp.asarray(tgt)
    g_j = _jgrad(lambda s: jnp.sum(jp.register_map_sharded_ift(mesh, s, t, cfg=jcfg).T))(
        jnp.asarray(src))
    assert _rel(g_i, g_j) < 1e-8


HVP_NAMES = ("source", "target", "weight")


@pytest.mark.parametrize("entry,shape", [(e, s) for e in ("register_map_sharded",
                                                           "register_ring_sharded")
                                         for s in ((8, 1), (4, 2))])
def test_map_sharded_and_ring_hvp(world, source_np, target_np, entry, shape):
    """Second derivatives through the all-reduced and the ring solve, on 1
    and 2 ranks of the map axis: the Hessian-vector product (the gradient
    of sum_i <grad_i sum(T), v_i> over source, target and weight), on the
    host loop and on the fixed trip of its capture, the same on every rank
    and within 1e-8 relative of JAX's on a (1, k) mesh (jax.jit of jax.jvp
    of jax.grad: forward over reverse, the same HVP at a third of the
    compile time).  The second backward's collectives: on the ring of 2,
    K - 1 reverse shifts and K - 1 forward gathers (the transpose of the
    reverse ring) per step's ring call."""
    cfg = CFG.with_(max_iterations=4)
    src, w = _perturbed_pair(source_np)
    rng = np.random.default_rng(5)
    v = {name: rng.normal(size=a.shape) for name, a in zip(HVP_NAMES, (src, target_np, w))}
    k = shape[1]
    mesh, jcfg = jp.make_mesh((1, k), devices=jax.devices()[:k]), _jcfg(cfg)
    grad = jax.grad(lambda s, t, w_: jnp.sum(getattr(jp, entry)(
        mesh, s, t, weight=w_, cfg=jcfg).T), (0, 1, 2))
    theirs = jax.jit(lambda *a: jax.jvp(grad, a, tuple(jnp.asarray(v[n]) for n in HVP_NAMES))[1])(
        jnp.asarray(src), jnp.asarray(target_np), jnp.asarray(w))
    for trip in (False, True):
        res, ranks = _map(world, shape, src, target_np, cfg, weight=w, grad_wrt=HVP_NAMES,
                          hvp=v, entry=entry, fixed_trip=trip)
        for r in ranks[1:]:
            for name in HVP_NAMES:
                np.testing.assert_array_equal(r["hvp"][name], ranks[0]["hvp"][name])
        for name, b in zip(HVP_NAMES, theirs):
            a = ranks[0]["hvp"][name]
            assert np.all(np.isfinite(a)) and np.abs(a).max() > 0, (name, trip)
            assert _rel(a, b) < 1e-8, (name, trip, _rel(a, b))
        steps = cfg.max_iterations if trip else res["iterations"]
        shifts = {key[0]: n for key, n in ranks[0]["counts_hvp"] if key[0].startswith("ring")}
        want = ({"ring_shift_reverse": steps, "ring_shift_gather": steps}
                if entry == "register_ring_sharded" and k == 2 else {})
        assert shifts == want, (trip, shifts)


def test_map_sharded_ift_refuses_a_double_backward(world, source_np, target_np):
    """register_map_sharded_ift is differentiable once, as JAX's is: under
    create_graph=True its backward raises on every rank (before any
    collective), naming the unrolled solve; JAX's second derivative raises
    when it is traced (reverse mode through its forward's while loop)."""
    cfg = CFG.with_(max_iterations=10)
    names = ("source", "target")
    v = {"source": np.ones((65, 3)), "target": np.ones(target_np.shape)}
    res = world.run("map_sharded", (4, 2), source=source_np[:, :3], target=target_np, cfg=cfg,
                    entry="register_map_sharded_ift", grad_wrt=names, hvp=v,
                    expect_error=True)
    assert all("differentiable once" in r["error"] and "register_map_sharded" in r["error"]
               for r in res), res[0]
    mesh = jp.make_mesh((1, 2), devices=jax.devices()[:2])
    grad = jax.grad(lambda t: jnp.sum(jp.register_map_sharded_ift(
        mesh, jnp.asarray(source_np[:, :3]), t, cfg=_jcfg(cfg)).T))
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        jax.jit(jax.grad(lambda t: jnp.sum(grad(t))))(jnp.asarray(target_np))


def test_map_sharded_dim2_matches_dense(world, source_np, target_np):
    """dim=2 z zeroing applies in the sharded wrapper too: noisy-z planar
    scans solve to register()'s pose."""
    rng = np.random.default_rng(2)
    src = np.asarray(source_np[:, :3]).copy()
    src[:, 2] = rng.normal(scale=0.05, size=src.shape[0])
    tgt = np.asarray(target_np).copy()
    tgt[:, 2] = rng.normal(scale=0.05, size=tgt.shape[0])
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, driver="while", max_iterations=50,
                    tolerance=1e-12, dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0,
                    nn_method="dense")
    res, _ = _map(world, (1, 8), src, tgt, cfg)
    ref = register(torch.as_tensor(src)[None], torch.as_tensor(tgt)[None],
                   torch.eye(4, dtype=torch.float64)[None], None, cfg)
    np.testing.assert_allclose(res["T"], ref.T[0].numpy(), atol=1e-9)
    T_j, _ = _jmap((1, 8), src, tgt, cfg)
    np.testing.assert_allclose(res["T"], T_j, atol=1e-10)
