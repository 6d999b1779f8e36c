"""Nearest-neighbour correspondence search: the counterpart of
``dicp_tpu/knn.py``, hard NN and Gumbel soft NN.

Hard NN: squared distances -> first argmin -> gather of the full target rows
(normals ride along).  The index is an integer computed without gradient, so
gradient reaches the target only through :func:`gather_rows`, and the query
gets none through the selection.

Two tiers:

* dense: one (..., n, m) distance matrix in the matmul form
  |x|^2 + |y|^2 - 2 x.y^T, plain PyTorch (XLA computed it outside any kernel);
* tiled: :mod:`dicp_tpu_torch.ops.tiled_knn`, the hand-written CUDA kernel K1
  for CUDA tensors and its plain version for CPU tensors.

Gumbel soft NN (:func:`gumbel_nn`): softmax((-d^2 + Gumbel noise) / tau)
@ targets, a convex combination through which gradient reaches the query
and every target row; plain PyTorch, as the JAX package leaves it to XLA.
Dense up to ``DENSE_MAX_ENTRIES`` distance entries per batch element, else
an online softmax over target chunks that never holds the (n, m) logits.

Random draws.  The noise comes from a source with JAX's stream structure
as a method,

    uniform(pair_ids, iteration, chunk, shape, dtype, device) -> Tensor

returning U[0, 1) draws of ``shape``.  ``pair_ids`` (global batch indices,
one per leading row of ``shape``, or None for one stream over the whole
shape), ``iteration`` (None outside a solve; an int, or the device loop's
0-dim int32 counter) and ``chunk`` (the streaming chunk's index, None on the
dense path) name the stream, as JAX derives it with ``fold_in(key, i)``,
``fold_in(key, it)`` and ``fold_in(key, chunk)``.  A draw that depends only
on its own stream makes a chunked batch equal the unchunked one, and a
batch's first rows equal a smaller batch, bit for bit.

:class:`ThreefryNoise` is the port's source: JAX's own threefry2x32
streams, computed as plain integer arithmetic on the tensors' device from a
key tensor, so a seed ``s`` draws the bits of ``jax.random.PRNGKey(s)`` and
no host value enters a draw (a solve that draws it can be captured).  Any
other object with a ``uniform`` method is used as it is, on the host's
schedule (:func:`host_driven`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dicp_tpu_torch.config import DENSE_MAX_ENTRIES
from dicp_tpu_torch.jit import records
from dicp_tpu_torch.ops import _build, launch_counts, tiled_knn

# Launches of the draw kernels D1 and D2 (csrc/threefry.cu) that ran at
# once; a captured launch counts on the card (ops.launch_counts).
threefry_launches = 0
randint_launches = 0


def pairwise_sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., n, 3) x (..., m, 3) -> (..., n, m), clipped at 0.

    The cross term is a matmul: on a GPU it must run in full f32 (TF32 off),
    the twin of the TPU's bf16 trap (dicp_tpu/knn.py:45-48).  Without an
    autograd graph to record, the exact product 2 xy is subtracted and the
    clip done in place, in one (n, m) buffer: the same bits."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    xy = x @ y.transpose(-1, -2)
    if records((x, y)):
        return torch.clamp(x2 + y2.transpose(-1, -2) - 2.0 * xy, min=0.0)
    d2 = x2 + y2.transpose(-1, -2)
    return d2.sub_(xy, alpha=2.0).clamp_(min=0.0)


def nn_indices(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """First argmin over dense distances: (..., n, 3), (..., m, >=3) -> (..., n) int32."""
    with torch.no_grad():
        d2 = pairwise_sq_dist(x.detach(), y[..., :3].detach())
        return torch.argmin(d2, dim=-1).to(torch.int32)


def gather_rows(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather full target rows (..., m, c) at (..., n) -> (..., n, c);
    differentiable in ``y`` (scatter-add in reverse)."""
    index = idx.long()[..., None].expand(idx.shape + (y.shape[-1],))
    return torch.gather(y, -2, index)


def hard_nn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Hard 1-NN: (..., n, 3) queries, (..., m, 3/6) targets -> (..., n, 3/6)."""
    return gather_rows(y, nn_indices(x, y))


# ---- JAX's threefry2x32 streams on the device ------------------------------
#
# Words are uint32 bit patterns held in int32 tensors: adds wrap modulo
# 2**32 and left shifts drop the high bits, on the CPU and on the card
# alike; a logical right shift is an arithmetic one masked to its width.
# The code follows jax/_src/prng.py (threefry2x32's unrolled rounds,
# threefry_seed, threefry_fold_in, the partitionable random_bits) and
# jax/_src/random.py::_uniform.

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _i32(word: int) -> int:
    """The uint32 ``word`` as the int32 value of its bit pattern."""
    word = int(word) & _M32
    return word - (1 << 32) if word >= (1 << 31) else word


def _word_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.tensor(_i32(x), dtype=torch.int32)


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) of key words (k1, k2) over the
    count words (x1, x2): broadcasting int32 tensors of uint32 bit patterns
    (or ints, taken as uint32); returns the two output words, int32
    tensors of the broadcast shape, updated in place round by round: five
    elementwise passes a round, in two buffers and one more."""
    k1, k2, x1, x2 = map(_word_tensor, (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    v0, v1 = (t.contiguous() for t in torch.broadcast_tensors(x1 + ks[0], x2 + ks[1]))
    low = torch.empty_like(v1)
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            v0 += v1
            # v1 rotated left: its top ``rot`` bits moved down (an arithmetic
            # shift masked to a logical one) plus v1 * 2**rot, which wraps
            # as v1 << rot does; the two have no bit in common
            torch.bitwise_right_shift(v1, 32 - rot, out=low)
            low &= (1 << rot) - 1
            low.add_(v1, alpha=1 << rot)
            v1, low = low, v1
            v1 ^= v0
        v0 += ks[(i + 1) % 3]
        v1 += ks[(i + 2) % 3] + (i + 1)
    return v0, v1


def seed_words(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s key data: the seed's high and low 32
    bits (threefry_seed of a 64-bit integer)."""
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32


def fold_in(k1, k2, data):
    """``jax.random.fold_in``: the key (k1, k2) hashed with the count
    (0, data); ``data`` an int or an integer tensor, taken as uint32."""
    if torch.is_tensor(data):
        data = data.to(torch.int32)
    return threefry2x32(k1, k2, 0, data)


def _index_tensor(ids: Sequence[int], device) -> torch.Tensor:
    """``ids`` as an integer tensor built on ``device`` by aranges,
    one per run of consecutive or repeated ids (a host list copied to the
    card would be a host copy, which a capture refuses)."""
    ids = [int(i) for i in ids]
    parts, lo = [], 0
    while lo < len(ids):
        step = 1 if lo + 1 < len(ids) and ids[lo + 1] == ids[lo] + 1 else 0
        hi = lo + 1
        while hi < len(ids) and ids[hi] == ids[hi - 1] + step:
            hi += 1
        parts.append(torch.arange(hi - lo, device=device) * step + ids[lo])
        lo = hi
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _uniform_from_bits(b1: torch.Tensor, b2: torch.Tensor, dtype) -> torch.Tensor:
    """``jax.random.uniform``'s floats in [0, 1) from the two output words:
    the mantissa's bits OR'ed into 1.0's exponent, minus 1.0 (the scale by
    maxval - minval = 1, the shift by minval = 0 and the max with 0 are exact
    on these values).  f32 takes the high 23 bits of b1 ^ b2, f64 the high
    52 bits of b1 << 32 | b2."""
    if dtype == torch.float32:
        b1 ^= b2
        b1 >>= 9
        b1 &= 0x7FFFFF
        b1 |= 0x3F800000
        return b1.view(torch.float32) - 1.0
    if dtype == torch.float64:
        hi = b1.to(torch.int64) & _M32
        lo = b2.to(torch.int64) & _M32
        bits = (hi << 20) | (lo >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    raise TypeError(f"Gumbel noise is drawn in float32 or float64, not {dtype}")


def threefry_uniform_plain(k1: torch.Tensor, k2: torch.Tensor, iteration, chunk,
                           block: Sequence[int], dtype) -> torch.Tensor:
    """The plain version of the draw kernel D1 (:func:`threefry_uniform`):
    int32 elementwise passes on any device."""
    if iteration is not None:
        k1, k2 = fold_in(k1, k2, iteration)
    if chunk is not None:
        k1, k2 = fold_in(k1, k2, chunk)
    block = tuple(block)
    size = math.prod(block)
    device = k1.device
    if size < 2**31:
        hi, lo = 0, torch.arange(size, dtype=torch.int32, device=device)
    else:   # the count's two words (a narrowing cast keeps the low 32 bits)
        count = torch.arange(size, dtype=torch.int64, device=device)
        hi, lo = (count >> 32).to(torch.int32), count.to(torch.int32)
    b1, b2 = threefry2x32(k1.reshape(-1, 1), k2.reshape(-1, 1), hi, lo)
    return _uniform_from_bits(b1, b2, dtype).reshape((k1.numel(),) + block)


@functools.lru_cache(maxsize=None)
def _threefry_kernel():
    fn = _build.load("threefry").threefry_uniform_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_uint, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_words(name: str, k1, k2, iteration):
    """The draw kernels' key words (k1, k2) as contiguous int32 rows, their
    count, and ``iteration`` as the device int32 they read (an int becomes
    one by a fill: no host copy) or None."""
    device = k1.device
    k1 = k1.reshape(-1).to(torch.int32).contiguous()
    k2 = k2.reshape(-1).to(torch.int32).contiguous()
    rows = k1.numel()
    if rows > 65535 or k2.numel() != rows:
        raise ValueError(f"{name} takes up to 65535 rows of key words, got "
                         f"{rows} and {k2.numel()}")
    if iteration is not None:
        iteration = (iteration.to(torch.int32).reshape(()) if torch.is_tensor(iteration)
                     else torch.full((), _i32(iteration), dtype=torch.int32, device=device))
        if iteration.device != device:
            raise ValueError(f"the iteration lies on {iteration.device}, the keys on {device}")
    return k1, k2, rows, iteration


def _threefry_uniform_cuda(k1, k2, iteration, chunk, block, dtype) -> torch.Tensor:
    global threefry_launches
    device = k1.device
    block = tuple(block)
    size = math.prod(block)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Gumbel noise is drawn in float32 or float64, not {dtype}")
    k1, k2, rows, iteration = _launch_words("threefry_uniform", k1, k2, iteration)
    out = torch.empty((rows,) + block, dtype=dtype, device=device)
    err = _threefry_kernel()(k1.data_ptr(), k2.data_ptr(), rows,
                             None if iteration is None else iteration.data_ptr(),
                             int(chunk is not None), 0 if chunk is None else int(chunk) & _M32,
                             size, int(dtype == torch.float64), out.data_ptr(), device.index,
                             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry_uniform kernel launch failed: CUDA error {err}")
    threefry_launches += launch_counts.count("threefry_uniform", device)
    return out


def threefry_uniform(k1: torch.Tensor, k2: torch.Tensor, iteration, chunk,
                     block: Sequence[int], dtype) -> torch.Tensor:
    """U[0, 1) draws of shape (rows,) + ``block``: row r is
    ``jax.random.uniform(key_r, block)`` for the key words (k1[r], k2[r])
    (int32 tensors of R elements, uint32 bit patterns) folded with
    ``iteration`` (None, an int or a 0-dim int32 tensor, read on the device)
    and then ``chunk`` (None or an int), each where given, with the
    partitionable counter layout.  A CUDA tensor launches the kernel D1
    (``csrc/threefry.cu``) or raises; a CPU tensor takes
    :func:`threefry_uniform_plain`."""
    if k1.device.type == "cpu":
        return threefry_uniform_plain(k1, k2, iteration, chunk, block, dtype)
    if k1.device.type == "cuda":
        return _threefry_uniform_cuda(k1, k2, iteration, chunk, block, dtype)
    raise ValueError(f"threefry draws run on cpu or cuda tensors, got {k1.device}")


# ---- jax.random.randint's draws (D2) ----------------------------------------
#
# With x64 on, randint(key, (k,), 0, n) draws int64: _split(key) gives
# fold_in(key, 0) and fold_in(key, 1) (the partitionable layout), each draws
# k 64-bit words b1 << 32 | b2 at the counts (0, j), and
# idx = ((hi mod n) * ((2**32 mod n)**2 mod n) + lo mod n) mod n
# (jax/_src/random.py::_randint; a span n <= 0 draws 0).

RANDINT_MAX_SPAN = 2**31 - 1


def _block_words(k1: int, k2: int, x1: int, x2: int) -> Tuple[int, int]:
    """:func:`threefry2x32` of one block on Python ints (uint32 words): the
    host's key arithmetic, free of any device op."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    v0, v1 = (x1 + k1) & _M32, (x2 + k2) & _M32
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            v0 = (v0 + v1) & _M32
            v1 = ((v1 << rot) & _M32 | v1 >> (32 - rot)) ^ v0
        v0 = (v0 + ks[(i + 1) % 3]) & _M32
        v1 = (v1 + ks[(i + 2) % 3] + i + 1) & _M32
    return v0, v1


def fold_in_words(k1: int, k2: int, data: int) -> Tuple[int, int]:
    """:func:`fold_in` on the host: the key words (k1, k2) hashed with
    ``data`` (taken as uint32)."""
    return _block_words(int(k1) & _M32, int(k2) & _M32, 0, int(data) & _M32)


def _span(n: int) -> int:
    n = int(n)
    if n > RANDINT_MAX_SPAN:
        raise ValueError(f"threefry_randint draws from spans below 2**31, got {n}")
    return max(n, 1)


def threefry_randint_plain(k1: torch.Tensor, k2: torch.Tensor, iteration, k: int,
                           n: int) -> torch.Tensor:
    """The plain version of the draw kernel D2 (:func:`threefry_randint`):
    int32 elementwise passes on any device, int64 for the modulus (values
    below 2**62: every factor is below 2**31)."""
    span = _span(n)
    if iteration is not None:
        k1, k2 = fold_in(k1, k2, iteration)
    k1, k2 = k1.reshape(-1, 1), k2.reshape(-1, 1)
    count = torch.arange(int(k), dtype=torch.int32, device=k1.device)
    r32 = 2**32 % span
    mods = []
    for half in (0, 1):      # the high 64 bits, then the low
        b1, b2 = threefry2x32(*fold_in(k1, k2, half), 0, count)
        w1, w2 = b1.to(torch.int64) & _M32, b2.to(torch.int64) & _M32
        mods.append((w1 % span * r32 + w2) % span)
    return (mods[0] * (r32 * r32 % span) + mods[1]) % span


@functools.lru_cache(maxsize=None)
def _randint_kernel():
    fn = _build.load("threefry").threefry_randint_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _threefry_randint_cuda(k1, k2, iteration, k, n) -> torch.Tensor:
    global randint_launches
    device = k1.device
    span = _span(n)
    k1, k2, rows, iteration = _launch_words("threefry_randint", k1, k2, iteration)
    out = torch.empty((rows, int(k)), dtype=torch.int64, device=device)
    err = _randint_kernel()(k1.data_ptr(), k2.data_ptr(), rows,
                            None if iteration is None else iteration.data_ptr(), int(k), span,
                            out.data_ptr(), device.index,
                            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry_randint kernel launch failed: CUDA error {err}")
    randint_launches += launch_counts.count("threefry_randint", device)
    return out


def threefry_randint(k1: torch.Tensor, k2: torch.Tensor, iteration, k: int,
                     n: int) -> torch.Tensor:
    """(rows, k) int64 draws in [0, n): row r is ``jax.random.randint(
    fold_in(key_r, iteration), (k,), 0, n)`` with x64 on, for the key words
    (k1[r], k2[r]) (int32 tensors of R elements, uint32 bit patterns) and
    ``iteration`` (None: no fold; an int, or a 0-dim int32 tensor read on
    the device).  ``n`` below 2**31; n <= 0 draws 0, as JAX does.  A CUDA
    tensor launches the kernel D2 (``csrc/threefry.cu``) or raises; a CPU
    tensor takes :func:`threefry_randint_plain`."""
    if k1.device.type == "cpu":
        return threefry_randint_plain(k1, k2, iteration, k, n)
    if k1.device.type == "cuda":
        return _threefry_randint_cuda(k1, k2, iteration, k, n)
    raise ValueError(f"threefry draws run on cpu or cuda tensors, got {k1.device}")


# ---- JAX's key forms ---------------------------------------------------------
#
# The one resolver of what a key given to the port means: an int seed is
# jax.random.PRNGKey(seed), a torch.Generator is read once for such a seed,
# (2,) integer key data (jax.random.key_data(k), or a tensor) is one key;
# for a batch, (N, 2) key data is N keys and a sequence of N single keys one
# each.  Gumbel's noise (ThreefryNoise, split) and SGD-ICP's element keys
# (element_keys) read keys only through these functions.

def _key_array(key):
    """Integer key data given on the host (a tensor or an array) as a numpy
    array; None for anything else."""
    if torch.is_tensor(key) or hasattr(key, "__array__"):
        arr = np.asarray(key.cpu() if torch.is_tensor(key) else key)
        if arr.dtype.kind in "ui":
            return arr
    return None


def _host_words(key) -> Optional[Tuple[int, int]]:
    """The two threefry key words of one key given on the host: an int seed
    (``PRNGKey(seed)``), a ``torch.Generator`` (read once for a seed) or
    (2,) integer key data; None for anything else."""
    if isinstance(key, bool):
        return None
    if isinstance(key, torch.Generator):
        key = int(torch.randint(0, 2**62, (1,), generator=key, device=key.device))
    if isinstance(key, int):
        return seed_words(key)
    arr = _key_array(key)
    if arr is not None and arr.shape == (2,):
        return tuple(int(w) & _M32 for w in arr.tolist())
    return None


def _words(key) -> Tuple[int, int]:
    """:func:`_host_words` of ``key``, which must be one key."""
    words = _host_words(key)
    if words is None:
        raise TypeError("Gumbel NN takes its noise from an int seed, a torch.Generator, (2,) "
                        "uint32 key data or an object with a uniform(pair_ids, iteration, "
                        f"chunk, shape, dtype, device) method, got {type(key).__name__}")
    return words


def key_data(key, device) -> torch.Tensor:
    """``key`` (see :class:`ThreefryNoise`) as the (2,) int32 tensor of its
    key words' bit patterns on ``device``, built there by fills (no host
    copy); a (2,) int32 tensor already on ``device`` is returned as it is."""
    device = torch.device(device)
    if (torch.is_tensor(key) and key.shape == (2,) and key.dtype == torch.int32
            and key.device == device):
        return key
    return torch.stack([torch.full((), _i32(w), dtype=torch.int32, device=device)
                        for w in _words(key)])


def _filled(rows, device) -> torch.Tensor:
    """The (len(rows), 2) int32 tensor of the key words ``rows`` on
    ``device``, one fill per row (the int64 whose little-endian int32 halves
    are the two words): no host copy."""
    out = torch.empty((len(rows),), dtype=torch.int64, device=device)
    for i, (a, b) in enumerate(rows):
        out[i].fill_((int(a) & _M32) | (_i32(b) << 32))
    return out.view(torch.int32).reshape(len(rows), 2)


def element_keys(key, N: int, device) -> Optional[torch.Tensor]:
    """The (N, 2) int32 key words (uint32 bit patterns) of the N elements
    of a batch, on ``device``, as ``dicp_tpu.sgd_icp._per_element_keys``
    derives them: one key (an int seed, a Generator, (2,) key data) split N
    ways (``jax.random.split``: key i is ``fold_in(key, i)``), (N, 2) key
    data used as it is, a sequence of N single keys one each.  Keys given
    on the host are folded there (:func:`fold_in_words`) and filled in (no
    host copy); key data already on a CUDA device stays there.  None for
    anything that is not a key form."""
    device = torch.device(device)
    if torch.is_tensor(key) and key.device.type != "cpu":
        words = key if key.dtype == torch.int32 else key.to(torch.int64).to(torch.int32)
        if tuple(key.shape) == (N, 2):
            return words.to(device)
        if tuple(key.shape) == (2,):
            words = words.to(device)
            k1, k2 = fold_in(words[0], words[1],
                             torch.arange(N, dtype=torch.int32, device=device))
            return torch.stack([k1, k2], dim=1)
        raise ValueError(f"key data must have shape (2,) or ({N}, 2); got {tuple(key.shape)}")
    if isinstance(key, (list, tuple)):
        rows = [_host_words(k) for k in key]
        if len(rows) != N or any(r is None for r in rows):
            return None
    elif (one := _host_words(key)) is not None:
        rows = [fold_in_words(*one, i) for i in range(N)]
    else:
        arr = _key_array(key)
        if arr is None or arr.shape != (N, 2):
            return None
        rows = arr.tolist()
    return _filled(rows, device)


def split(key, num: int, device) -> Tuple[torch.Tensor, ...]:
    """``jax.random.split(key, num)`` with the partitionable counter layout:
    key i is the threefry block of ``key`` over the count words (0, i),
    which is ``fold_in(key, i)`` (:func:`element_keys` of one key).
    ``key``: one key, as :class:`ThreefryNoise` takes it; returns ``num``
    (2,) int32 key tensors on ``device``."""
    if not (torch.is_tensor(key) and key.device.type != "cpu" and tuple(key.shape) == (2,)):
        key = np.array(_words(key), dtype=np.uint32)     # one key (a Generator read once)
    return tuple(element_keys(key, num, device).unbind(0))


class ThreefryNoise:
    """The port's Gumbel noise source: JAX's threefry2x32 streams.

    The stream of (pair i, iteration it, chunk c) is ``jax.random.uniform(
    fold_in(fold_in(fold_in(key, i), it), c), shape)`` (the folds of absent
    names skipped), with the partitionable counter layout: each row's
    counter runs over its own block alone.  The draw is integer arithmetic
    on the key words and, in a device loop, its counter: nothing is read
    from the host.  ``key``: an int seed, a ``torch.Generator``, (2,)
    uint32 key data, or the (2,) int32 tensor of :func:`key_data` (a
    program's input, used on its device as it is)."""

    def __init__(self, key):
        if torch.is_tensor(key) and key.shape == (2,) and key.dtype == torch.int32:
            self.key, self.words = key, None
        else:
            self.key, self.words = None, _words(key)
        self._pairs: dict = {}

    def _key(self, device):
        if self.key is not None:
            key = self.key.to(device)
            return key[0], key[1]
        return tuple(torch.full((), _i32(w), dtype=torch.int32, device=device)
                     for w in self.words)

    def pair_keys(self, pair_ids: Sequence[int], device):
        """The (len(pair_ids), 1) key words of the pairs' streams,
        ``fold_in(key, i)``, computed once per (ids, device) and kept: a
        solve calls this before its loop, so that the loop body folds in
        only its iteration."""
        name = (tuple(int(i) for i in pair_ids), str(torch.device(device)))
        if name not in self._pairs:
            k1, k2 = fold_in(*self._key(device), _index_tensor(pair_ids, device))
            self._pairs[name] = (k1[:, None], k2[:, None])
        return self._pairs[name]

    def uniform(self, pair_ids, iteration, chunk, shape, dtype, device) -> torch.Tensor:
        shape = tuple(shape)
        if pair_ids is not None:
            (k1, k2), block = self.pair_keys(pair_ids, device), shape[1:]
        else:
            k1, k2 = self._key(device)
            block = shape
        return threefry_uniform(k1, k2, iteration, chunk, block, dtype).reshape(shape)


def host_driven(key) -> bool:
    """Whether noise from ``key`` is drawn on the host's schedule: an object
    with its own ``uniform`` method other than :class:`ThreefryNoise`.  A
    solve that draws such noise cannot be captured."""
    return callable(getattr(key, "uniform", None)) and not isinstance(key, ThreefryNoise)


def gumbel_noise(key):
    """A noise source from ``key``: an int seed, a ``torch.Generator`` or
    (2,) key data (-> :class:`ThreefryNoise`, JAX's streams of that key),
    or an object with a ``uniform`` method, as is."""
    if callable(getattr(key, "uniform", None)):
        return key
    return ThreefryNoise(key)


def gumbel_nn(x: torch.Tensor, y: torch.Tensor, key, tau: float = 0.1, eps: float = 1e-10,
              chunk: Optional[int] = None, pair_ids: Optional[Sequence[int]] = None,
              iteration: Optional[int] = None) -> torch.Tensor:
    """Gumbel-softmax soft 1-NN: (..., n, 3) queries, (..., m, 3|6) targets
    -> (..., n, 3|6) = softmax((-d^2 + g) / tau) @ y with g = -log(-log(u +
    eps) + eps), u ~ U[0, 1) from ``key`` (see :func:`gumbel_noise`).

    Above ``DENSE_MAX_ENTRIES`` distance entries per batch element, or with
    ``chunk`` given, the softmax streams over target chunks of ``chunk``
    (auto: max(128, min(m, DENSE_MAX_ENTRIES // n))) and each chunk draws
    from its own stream.  ``pair_ids`` and ``iteration`` name the streams of
    a solve (one per batch row of ``x``)."""
    noise = gumbel_noise(key)
    n, m = x.shape[-2], y.shape[-2]
    if chunk is None and n * m <= DENSE_MAX_ENTRIES:
        d2 = pairwise_sq_dist(x, y[..., :3])
        logits = -d2
        u = noise.uniform(pair_ids, iteration, None, logits.shape, logits.dtype, logits.device)
        g = -torch.log(-torch.log(u + eps) + eps)
        probs = torch.softmax((logits + g) / tau, dim=-1)
        return torch.einsum("...nm,...mc->...nc", probs, y)
    if chunk is None:
        chunk = max(128, min(m, DENSE_MAX_ENTRIES // max(n, 1)))
    return _gumbel_nn_stream(x, y, noise, tau, eps, chunk, pair_ids, iteration)


def _gumbel_nn_stream(x, y, noise, tau, eps, chunk, pair_ids, iteration):
    """Online-softmax Gumbel NN over target chunks: O(n * chunk) live memory.
    The last chunk's padded columns are masked to -inf; the running max and
    denominator are rescaled into each new max's frame."""
    m, c = y.shape[-2], y.shape[-1]
    nchunks = -(-m // chunk)
    pad = nchunks * chunk - m
    y_pad = torch.cat([y, y.new_zeros(y.shape[:-2] + (pad, c))], dim=-2) if pad else y
    qshape = x.shape[:-1]                     # (..., n)
    run_max = x.new_full(qshape, -torch.inf)
    run_den = x.new_zeros(qshape)
    run_num = x.new_zeros(qshape + (c,))
    for i in range(nchunks):
        yc = y_pad[..., i * chunk:(i + 1) * chunk, :]
        d2 = pairwise_sq_dist(x, yc[..., :3])              # (..., n, chunk)
        u = noise.uniform(pair_ids, iteration, i, d2.shape, d2.dtype, d2.device)
        s = (-d2 - torch.log(-torch.log(u + eps) + eps)) / tau
        col = torch.arange(chunk, device=x.device) + i * chunk
        s = torch.where(col < m, s, torch.full_like(s, -torch.inf))
        new_max = torch.maximum(run_max, torch.amax(s, dim=-1))
        corr = torch.exp(run_max - new_max)
        p = torch.exp(s - new_max[..., None])
        run_den = run_den * corr + torch.sum(p, dim=-1)
        run_num = run_num * corr[..., None] + torch.einsum("...nm,...mc->...nc", p, yc)
        run_max = new_max
    return run_num / run_den[..., None]


def _handle_dimensions(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize to (N, n, 3) queries and (N, m, 3/6) targets.

    Accepts (n, 3/6), (3/6, n), (N, n, 3/6), (N, 3/6, n) with the reference's
    transpose heuristic, including its documented 3x3 ambiguity (a 3x3 input
    is read as transposed)."""
    x_use = x[None] if x.dim() == 2 else x
    if x_use.shape[-2] == 3 or (x_use.shape[-2] == 6 and x_use.shape[-2] < x_use.shape[-1]):
        x_use = x_use[:, :3, :].transpose(-1, -2)
    x_use = x_use[..., :3]
    if x_use.shape[-1] != 3:
        raise ValueError("x must have 3 coordinate columns")

    y_use = y[None] if y.dim() == 2 else y
    if y_use.shape[-2] == 3 or (y_use.shape[-2] == 6 and y_use.shape[-2] < y_use.shape[-1]):
        y_use = y_use.transpose(-1, -2)
    if y_use.shape[-1] not in (3, 6):
        raise ValueError("y must have 3 or 6 columns")
    return x_use, y_use


def find_nn_normalized(x: torch.Tensor, y: torch.Tensor,
                       use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Hard 1-NN on already-normalized (..., n, 3) / (..., m, 3|6) inputs.

    Solver-internal: skips :func:`_handle_dimensions`, whose heuristic misreads
    n == 3 or m == 3 clouds.  ``use_pallas`` picks the tiled tier (the name is
    kept from the JAX package); None picks it above ``DENSE_MAX_ENTRIES``
    distance entries on either device."""
    n, m = x.shape[-2], y.shape[-2]
    if use_pallas is None:
        use_pallas = n * m > DENSE_MAX_ENTRIES
    if use_pallas:
        # the index carries no gradient: compute it on detached inputs, and
        # let only the gather carry tangents into the target
        with torch.no_grad():
            idx = tiled_knn.nn_indices(x.detach(), y[..., :3].detach())
        return gather_rows(y, idx)
    return hard_nn(x, y)


def find_nn(x: torch.Tensor, y: torch.Tensor, differentiable: bool = True,
            use_gumbel: bool = False, key=None, tau: float = 0.1, eps: float = 1e-10,
            use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Public NN entry point (shape-normalizing): Gumbel soft NN when
    ``differentiable and use_gumbel`` (``key`` required, see
    :func:`gumbel_noise`), hard NN otherwise."""
    x_use, y_use = _handle_dimensions(x, y)
    if differentiable and use_gumbel:
        if key is None:
            raise ValueError("Gumbel NN needs an explicit noise source (key): an int seed, "
                             "a torch.Generator or an object with a uniform method")
        return gumbel_nn(x_use, y_use, key, tau=tau, eps=eps)
    return find_nn_normalized(x_use, y_use, use_pallas)
