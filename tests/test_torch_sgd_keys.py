"""JAX's ``randint`` draws and key forms in the port: ``knn.threefry_randint``
(the kernel D2's plain version on the CPU), the host's ``fold_in`` and
``knn.element_keys`` (JAX's per-element keys of a batch), against
``jax.random`` bit for bit.  The solves on these keys are held to the JAX
package in ``tests/test_torch_sgd_icp.py`` and ``tests/test_torch_mapping.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from dicp_tpu_torch import knn, sgd_icp  # noqa: E402
from dicp_tpu_torch.sgd_icp import SGDPlan  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words_tensor(key_data):
    """(R, 2) uint32 key data -> the (R,) int32 tensors of its two words."""
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2).view(np.int32)
    return torch.as_tensor(kd[:, 0].copy()), torch.as_tensor(kd[:, 1].copy())


# --- the draw: jax.random.randint's bits ---------------------------------------

SPANS = [1, 10, 1000, 65537, 100003, 2**31 - 1]


@pytest.mark.parametrize("n", SPANS)
def test_randint_plain_matches_jax(n):
    """threefry_randint_plain == randint(fold_in(key, it), (k,), 0, n), int64,
    bit for bit: int seeds (PRNGKey, past 2**32 too), iterations past 2**31
    as uint32 and a device-style 0-dim int32 counter, a typed key passed as
    its key data, several rows at once."""
    for seed, it in ((0, 0), (7, 3), (2**40 + 5, 17), (123456789, 2**31 + 3)):
        ref = np.asarray(jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(seed), it),
                                            (512,), 0, n))
        assert ref.dtype == np.int64
        k1, k2 = _words_tensor(knn.seed_words(seed))
        got = knn.threefry_randint_plain(k1, k2, it, 512, n)
        assert got.dtype == torch.int64 and got.shape == (1, 512)
        np.testing.assert_array_equal(got[0].numpy(), ref)
        counter = torch.tensor(knn._i32(it), dtype=torch.int32)
        assert torch.equal(knn.threefry_randint(k1, k2, counter, 512, n), got)
    keys = jax.random.split(jax.random.key(11), 3)            # typed keys
    k1, k2 = _words_tensor(jax.random.key_data(keys))
    got = knn.threefry_randint(k1, k2, 5, 300, n)
    for r in range(3):
        ref = jax.random.randint(jax.random.fold_in(keys[r], 5), (300,), 0, n)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(ref))


def test_randint_span_edges_and_routing():
    """A span n <= 0 draws 0, as JAX does; no fold without an iteration;
    spans of 2**31 and more are refused; a tensor off the CPU and the card
    is refused."""
    k1, k2 = _words_tensor(knn.seed_words(3))
    for n in (0, -4):
        ref = jax.random.randint(jax.random.PRNGKey(3), (64,), 0, n)
        got = knn.threefry_randint(k1, k2, None, 64, n)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
        assert not got.any()
    with pytest.raises(ValueError, match="2\\*\\*31"):
        knn.threefry_randint(k1, k2, 0, 8, 2**31)
    with pytest.raises(ValueError, match="cpu or cuda"):
        knn.threefry_randint(k1.to("meta"), k2.to("meta"), 0, 8, 10)


def test_host_fold_in_equals_jax():
    for seed, data in ((0, 0), (7, 1), (2**33 + 9, 2**32 - 1), (5, 123456)):
        ref = jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        assert knn.fold_in_words(*knn.seed_words(seed), data) == tuple(int(w) for w in ref)


def test_element_keys_are_jax_per_element_keys():
    """element_keys: an int seed, a typed key's data and a CPU tensor of it
    are split N ways; (N, 2) data is used as it is; a sequence gives one key
    each; a Generator is read once; explicit sources give None."""
    N = 3
    want = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(7), N)))

    def words(t):
        return t.numpy().view(np.uint32)

    for key in (7, np.asarray(jax.random.key_data(jax.random.key(7))),
                torch.as_tensor(np.asarray(jax.random.key_data(jax.random.key(7))).view(np.int32)),
                want, list(want)):
        got = knn.element_keys(key, N, CPU)
        assert got.dtype == torch.int32 and got.shape == (N, 2)
        np.testing.assert_array_equal(words(got), want)
    seeds = knn.element_keys([4, 9], 2, CPU)
    np.testing.assert_array_equal(words(seeds), np.stack(
        [np.asarray(jax.random.key_data(jax.random.key(s))) for s in (4, 9)]))
    gens = [knn.element_keys(torch.Generator().manual_seed(5), 2, CPU) for _ in range(2)]
    assert torch.equal(gens[0], gens[1])
    for source in (sgd_icp.SeededSampler(1), [sgd_icp.SeededSampler(1)] * 2, None,
                   SGDPlan(None, None, gens[0])):
        assert knn.element_keys(source, 2, CPU) is None
