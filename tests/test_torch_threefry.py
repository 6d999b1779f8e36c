"""The port's Gumbel noise on JAX's own threefry2x32 streams, against JAX on
the CPU: the block function, ``PRNGKey``'s key words, ``fold_in`` and
``jax.random.uniform``'s bits, f32 and f64, on the dense and the streamed
shapes (``knn.ThreefryNoise``); a Gumbel solve keyed by an int seed
against JAX's solve keyed by ``PRNGKey`` of that seed, with no draws
injected; ``register_jit`` against ``register``; which keys drive the loop
from the host.  Bit for bit where the arithmetic is integer; the solve
within ``test_torch_gumbel.py``'s 1e-10."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

from dicp_tpu import knn as jknn  # noqa: E402
from dicp_tpu.api import ICP as JICP  # noqa: E402
from dicp_tpu.config import ICPConfig as JConfig  # noqa: E402
from dicp_tpu.registration import register as jregister  # noqa: E402

from dicp_tpu_torch import ICP, ICPConfig, register, register_jit  # noqa: E402
from dicp_tpu_torch import knn as tknn  # noqa: E402
from dicp_tpu_torch.registration import host_driven  # noqa: E402

HUBER = {"name": "huber", "metric": 1.0}


class Explicit:
    """An explicit noise source (the protocol's method), drawing uniform
    zeros: the kind of object that drives the loop from the host."""

    def uniform(self, pair_ids, iteration, chunk, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint64)


def _jax_draw(key, pair, it, chunk, shape, dtype):
    k = key if pair is None else jax.random.fold_in(key, pair)
    if it is not None:
        k = jax.random.fold_in(k, it)
    if chunk is not None:
        k = jax.random.fold_in(k, chunk)
    return np.asarray(jax.random.uniform(k, shape, dtype=dtype))


# ---------------------------------------------------------------- the stream

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry_block_matches_jax(seed):
    """The 20-round block of random key words over random count words,
    and fold_in of random data, equal JAX's primitive and fold_in."""
    rng = np.random.default_rng(seed)
    k = _u32(rng, 2)
    x = _u32(rng, (2, 257))
    want = jprng.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(x[0]),
                                     jnp.asarray(x[1]))
    got = tknn.threefry2x32(int(k[0]), int(k[1]), torch.as_tensor(x[0].view(np.int32)),
                            torch.as_tensor(x[1].view(np.int32)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy().view(np.uint32))
    data = int(_u32(rng, ())) if seed else 0
    want_key = np.asarray(jax.random.fold_in(jnp.asarray(k), data))
    got_key = tknn.fold_in(int(k[0]), int(k[1]), data)
    np.testing.assert_array_equal(want_key, [int(w) & 0xFFFFFFFF for w in got_key])


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**32 + 5, 2**40 + 3, 2**63 - 1])
def test_seed_words_are_prngkey(seed):
    """An int seed gives PRNGKey(seed)'s key data (64-bit seeds: the high
    and the low word, as JAX splits them with x64 on)."""
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert tknn.seed_words(seed) == tuple(int(w) for w in want)
    key = tknn.key_data(seed, "cpu")
    assert key.dtype == torch.int32 and key.numpy().view(np.uint32).tolist() == want.tolist()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("path", ["dense", "streamed"])
@pytest.mark.parametrize("it_kind", ["int", "tensor"])
def test_draws_equal_jax_uniform(dtype, path, it_kind):
    """uniform(pair_ids, it, chunk, shape) equals jax.random.uniform(
    fold_in(fold_in(fold_in(PRNGKey(s), i), it), c), shape[1:]) for each
    pair i, bit for bit: dense (n, m) blocks (no chunk) and streamed
    (n, chunk) blocks, with ``it`` an int or the device loop's 0-dim int32
    counter; ids with a repeated tail (a chunked batch's padding)."""
    s, it, ids = 11, 3, [4, 5, 6, 6]
    chunk, block = (None, (9, 33)) if path == "dense" else (2, (9, 16))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.stack([_jax_draw(jax.random.PRNGKey(s), i, it, chunk, block, jdt) for i in ids])
    it_arg = it if it_kind == "int" else torch.tensor(it, dtype=torch.int32)
    got = tknn.gumbel_noise(s).uniform(ids, it_arg, chunk, (len(ids),) + block, tdt, "cpu")
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert bool(((got >= 0) & (got < 1)).all())


@pytest.mark.parametrize("chunk", [None, 5])
def test_one_stream_over_the_whole_shape(chunk):
    """Without pair ids and iteration (``find_nn``'s batched call) the draw
    is jax.random.uniform(key, shape) over the whole shape, the chunk
    folded in where given."""
    key = jax.random.PRNGKey(3)
    shape = (2, 7, 13)
    want = _jax_draw(key, None, None, chunk, shape, jnp.float64)
    got = tknn.gumbel_noise(np.asarray(key)).uniform(None, None, chunk, shape, torch.float64,
                                                     "cpu")
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_key_forms_and_index_runs():
    """An int, JAX's (2,) uint32 key data as an array or a tensor, and the
    int32 key tensor draw the same stream; a Generator is read once for a
    seed (equal generators, equal draws; torch's global generator
    untouched); pair ids of any pattern become their runs on the device."""
    state = torch.get_rng_state()
    draws = [tknn.gumbel_noise(k).uniform([0, 2], 1, None, (2, 3, 4), torch.float32, "cpu")
             for k in (9, np.asarray(jax.random.PRNGKey(9)),
                       torch.as_tensor(np.asarray(jax.random.PRNGKey(9)).view(np.int32).copy()),
                       tknn.key_data(9, "cpu"))]
    for d in draws[1:]:
        assert torch.equal(d, draws[0])
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    assert torch.equal(tknn.gumbel_noise(g1).uniform(None, None, None, (5,), torch.float64,
                                                     "cpu"),
                       tknn.gumbel_noise(g2).uniform(None, None, None, (5,), torch.float64,
                                                     "cpu"))
    assert torch.equal(torch.get_rng_state(), state)
    for ids in ([3], [0, 1, 2], [5, 5, 5], [2, 3, 3, 9, 10, 1], list(range(7)) + [6] * 3):
        assert tknn._index_tensor(ids, "cpu").tolist() == ids
    with pytest.raises(TypeError, match="key data"):
        tknn.gumbel_noise(np.zeros(3, np.uint32))


# ---------------------------------------------------------------- the solve

@pytest.mark.parametrize("case", ["pt2pl const_iter", "pt2pt early exit"])
def test_register_with_a_seed_matches_jax_prngkey(source_np, target_np, case):
    """register(use_gumbel=True, key=s) against JAX's register(key=PRNGKey(s))
    with nothing injected: T within 1e-10, the same iteration counts, at
    B = 3 in f64."""
    if case.startswith("pt2pl"):
        kw = dict(icp_type="pt2pl", dim=2, const_iter=True, max_iterations=5,
                  trim_dist=5.0, loss_name="huber")
        tgt = np.stack([target_np] * 3)
    else:
        kw = dict(icp_type="pt2pt", dim=3, max_iterations=8, tolerance=1e-3, gumbel_tau=0.5)
        tgt = np.stack([target_np[:, :3]] * 3)
    src = np.stack([source_np[:, :3] + o for o in (0.0, 0.05, -0.05)])
    ti = np.stack([np.eye(4)] * 3)
    cfg = dict(differentiable=True, use_gumbel=True, **kw)
    res_j = jregister(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ti), cfg=JConfig(**cfg),
                      key=jax.random.PRNGKey(7))
    res_t = register(torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(ti),
                     cfg=ICPConfig(**cfg), key=7)
    np.testing.assert_allclose(res_t.T.numpy(), np.asarray(res_j.T), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(res_t.iterations.numpy(), np.asarray(res_j.iterations))


def test_icp_and_find_nn_with_a_seed_match_jax(source_np, target_np):
    """ICP.icp(key=s) against JAX's ICP.icp(key=PRNGKey(s)) on ragged
    targets (T within 1e-10), and the nn shim's default seed 0 against JAX's
    default key(0) (the soft neighbours within 1e-10)."""
    sources = [source_np[:50, :3], source_np[:, :3]]
    targets = [target_np[:55], target_np]
    kw = dict(icp_type="pt2pl", differentiable=True, max_iterations=4, tolerance=1e-12)
    solver = ICP(**kw, device="cpu")
    solver.use_gumbel = solver.nn.use_gumbel = True
    res_t = solver.icp(sources, targets, np.eye(4), trim_dist=5.0, loss_fn=HUBER, dim=2, key=5)
    jsolver = JICP(**kw)
    jsolver.use_gumbel = jsolver.nn.use_gumbel = True
    res_j = jsolver.icp([jnp.asarray(s) for s in sources], [jnp.asarray(t) for t in targets],
                        jnp.eye(4), trim_dist=5.0, loss_fn=HUBER, dim=2,
                        key=jax.random.PRNGKey(5))
    np.testing.assert_allclose(res_t["T"].numpy(), np.asarray(res_j["T"]), rtol=0, atol=1e-10)

    from dicp_tpu.nn import nn as jnn
    from dicp_tpu_torch.nn import nn as tnn

    x, y = source_np[:20, :3], target_np[:40]
    out_j = jnn(tau=0.5).find_nn(jnp.asarray(x), jnp.asarray(y))
    out_t = tnn(tau=0.5).find_nn(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0, atol=1e-10)


def test_streamed_gumbel_nn_with_a_key_matches_jax():
    """The streamed soft neighbour (5 chunks, the last padded) keyed by JAX's
    key data equals JAX's with that key, batched (one stream over the
    batch's (2, n, chunk) blocks)."""
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=(2, 7, 3)), rng.normal(size=(2, 33, 6))
    key = jax.random.PRNGKey(6)
    out_j = jknn.gumbel_nn(jnp.asarray(x), jnp.asarray(y), key, tau=0.5, chunk=8)
    out_t = tknn.gumbel_nn(torch.as_tensor(x), torch.as_tensor(y), np.asarray(key), tau=0.5,
                           chunk=8)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0, atol=1e-10)


@pytest.mark.parametrize("key", [3, "key data", "generator"])
def test_register_jit_equals_register(source_np, target_np, key):
    """register_jit on the CPU (the device-loop body in a host loop, the
    draw at the loop's int32 counter) equals register (the host loop) bit
    for bit in every field, batch_chunk included."""
    src = torch.as_tensor(np.stack([source_np[:, :3] + o for o in (0.0, 0.02, -0.03)]))
    tgt = torch.as_tensor(np.stack([target_np] * 3))
    ti = torch.as_tensor(np.stack([np.eye(4)] * 3))
    cfg = ICPConfig(icp_type="pt2pl", max_iterations=6, tolerance=1e-9, differentiable=True,
                    use_gumbel=True, dim=2, trim_dist=5.0, batch_chunk=2)

    def source():
        if key == "generator":
            return torch.Generator().manual_seed(9)
        return np.asarray(jax.random.PRNGKey(3)) if key == "key data" else key

    eager = register(src, tgt, ti, cfg=cfg, key=source())
    jitted = register_jit(src, tgt, ti, cfg=cfg, key=source())
    for name, a, b in zip(eager._fields, eager, jitted):
        assert torch.equal(a, b), name


def test_host_driven_only_for_explicit_sources():
    """Only an explicit uniform object drives the loop from the host; an int,
    a Generator, key data and the threefry source itself draw on the
    device.  A hard-NN config never does."""
    gumbel = ICPConfig(differentiable=True, use_gumbel=True)
    assert host_driven(gumbel, Explicit())
    assert tknn.gumbel_noise(Explicit()).__class__ is Explicit
    for key in (7, torch.Generator().manual_seed(1), np.asarray(jax.random.PRNGKey(1)),
                tknn.key_data(1, "cpu"), tknn.ThreefryNoise(1)):
        assert not host_driven(gumbel, key)
    assert not host_driven(ICPConfig(differentiable=False, use_gumbel=True), Explicit())


# ---------------------------------------------------------------- the kernel D1

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("it,chunk", [(3, None), (0, 11), (-1, 2**32 - 1), (None, 4)])
def test_d1_plain_in_its_wrapper_layout_equals_jax(dtype, it, chunk):
    """D1's plain version driven through the kernel wrapper's arguments:
    the (N, 1) pair key words, a 0-dim int32 counter (or none), a chunk,
    the block shape and the dtype; row i equals jax.random.uniform(
    fold_in(fold_in(fold_in(PRNGKey(s), i), it), c), block) bit for bit,
    counters whose uint32 patterns are negative int32 included."""
    s, ids, block = 13, [0, 4, 4, 9], (5, 17)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    k1, k2 = tknn.ThreefryNoise(s).pair_keys(ids, "cpu")
    counter = None if it is None else torch.tensor(tknn._i32(it), dtype=torch.int32)
    got = tknn.threefry_uniform(k1, k2, counter, chunk, block, tdt)
    it_j = None if it is None else it & 0xFFFFFFFF
    want = np.stack([_jax_draw(jax.random.PRNGKey(s), i, it_j, chunk, block, jdt) for i in ids])
    assert got.shape == (len(ids),) + block and got.dtype == tdt
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_d1_count_words_past_two_to_the_32():
    """The partitionable layout's two count words: element j of a block is
    threefry2x32 over (j >> 32, j mod 2**32), which a count past 2**31
    splits (the plain version's int64 path, the kernel's 64-bit index), as
    JAX's primitive sees them; at j near 2**31 and 2**32."""
    rng = np.random.default_rng(4)
    k = _u32(rng, 2)
    j = np.concatenate([np.arange(2**31 - 3, 2**31 + 3), np.arange(2**32 - 3, 2**32 + 3)])
    hi, lo = (j >> 32).astype(np.uint32), (j & 0xFFFFFFFF).astype(np.uint32)
    want = jprng.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(hi),
                                     jnp.asarray(lo))
    count = torch.as_tensor(j.astype(np.int64))
    got = tknn.threefry2x32(int(k[0]), int(k[1]), (count >> 32).to(torch.int32),
                            count.to(torch.int32))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy().view(np.uint32))


def test_d1_wrapper_routes_cpu_to_plain():
    """A CPU tensor takes the plain version; another device raises."""
    k1, k2 = tknn.ThreefryNoise(2).pair_keys([1, 2], "cpu")
    assert torch.equal(tknn.threefry_uniform(k1, k2, 5, 3, (4, 6), torch.float32),
                       tknn.threefry_uniform_plain(k1, k2, 5, 3, (4, 6), torch.float32))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tknn.threefry_uniform(k1.to("meta"), k2.to("meta"), None, None, (3,), torch.float32)


# ---------------------------------------------------------------- one key per pyramid

@pytest.mark.parametrize("seed", [0, 11, 2**40 + 3])
def test_split_equals_jax_random_split(seed):
    """knn.split(key, L) equals jax.random.split(PRNGKey(s), L)'s key data bit
    for bit (JAX's partitionable layout: key i is fold_in(key, i))."""
    assert jax.config.jax_threefry_partitionable
    for num in (1, 2, 3, 5):
        want = np.asarray(jax.random.key_data(jax.random.split(jax.random.PRNGKey(seed), num)))
        got = np.stack([k.numpy().view(np.uint32) for k in tknn.split(seed, num, "cpu")])
        np.testing.assert_array_equal(got, want)


def test_register_multiscale_with_one_key_matches_jax():
    """register_multiscale(key=s) against JAX's register_multiscale with
    PRNGKey(s), the key split across two levels on both sides: level poses
    within 1e-10 and the same iterations; a list of per-level sources is
    still taken as it is, and an explicit uniform object alone is refused."""
    import dataclasses

    from dicp_tpu import multiscale as jms

    from dicp_tpu_torch.convert import config_from_dict
    from dicp_tpu_torch.multiscale import ScaleLevel, register_multiscale
    from tests.test_multiscale import _CFG as JCFG
    from tests.test_multiscale import _pair

    src, tgt, _ = _pair([0.1, -0.05, 0.1, 0.03, -0.02, 0.05])
    cfg_kw = dict(differentiable=True, use_gumbel=True, driver="scan", max_iterations=6,
                  tolerance=1e-12)
    levels = (ScaleLevel(0.8, 96, 96, 4, 1e-5, trim_dist=20.0), ScaleLevel(0.0, 0, 0, 4, 1e-12))
    Ti = np.eye(4)[None]
    ref = jms.register_multiscale(jnp.asarray(src[None]), jnp.asarray(tgt[None]),
                                  jnp.asarray(Ti), None, cfg=JCFG.with_(**cfg_kw),
                                  levels=tuple(jms.ScaleLevel(*lv) for lv in levels),
                                  key=jax.random.PRNGKey(11))
    cfg = config_from_dict(dataclasses.asdict(JCFG)).with_(**cfg_kw)
    args = (torch.as_tensor(src[None]), torch.as_tensor(tgt[None]), torch.as_tensor(Ti), None,
            cfg, levels)
    got = register_multiscale(*args, key=11)
    np.testing.assert_allclose(got.level_T.numpy(), np.asarray(ref.level_T), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(got.level_iterations.numpy(),
                                  np.asarray(ref.level_iterations))
    per_level = register_multiscale(*args, key=list(tknn.split(11, 2, "cpu")))
    assert torch.equal(per_level.level_T, got.level_T)
    with pytest.raises(TypeError, match="split"):
        register_multiscale(*args, key=Explicit())
