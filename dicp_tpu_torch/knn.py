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

Random draws.  torch and JAX streams differ, so the noise comes from an
explicit source, any object with JAX's stream structure as a method

    uniform(pair_ids, iteration, chunk, shape, dtype, device) -> Tensor

returning U[0, 1) draws of ``shape``.  ``pair_ids`` (global batch indices,
one per leading row of ``shape``, or None for one stream over the whole
shape), ``iteration`` (None outside a solve) and ``chunk`` (the streaming
chunk's index, None on the dense path) name the stream, as JAX derives it
with ``fold_in(key, i)``, ``fold_in(key, it)`` and ``fold_in(key, chunk)``.
A draw that depends only on its own stream makes a chunked batch equal the
unchunked one, and a batch's first rows equal a smaller batch, bit for bit.
:class:`SeededNoise` is the port's source (a seed or a ``torch.Generator``,
drawing on the tensors' device, never from torch's global generator); a
test can pass an object that returns JAX's own draws.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import torch

from dicp_tpu_torch.config import DENSE_MAX_ENTRIES
from dicp_tpu_torch.ops import tiled_knn


def pairwise_sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., n, 3) x (..., m, 3) -> (..., n, m), clipped at 0.

    The cross term is a matmul: on a GPU it must run in full f32 (TF32 off),
    the twin of the TPU's bf16 trap (dicp_tpu/knn.py:45-48)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    xy = x @ y.transpose(-1, -2)
    return torch.clamp(x2 + y2.transpose(-1, -2) - 2.0 * xy, min=0.0)


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


class SeededNoise:
    """The port's Gumbel noise source: every stream (pair, iteration, chunk)
    draws from its own ``torch.Generator``, seeded from a hash of the base
    seed and the stream's name and created on the tensors' device.  A
    ``torch.Generator`` given as the base is read once for the seed."""

    def __init__(self, seed):
        if isinstance(seed, torch.Generator):
            seed = int(torch.randint(0, 2**62, (1,), generator=seed, device=seed.device))
        self.seed = int(seed)

    def _stream(self, path, shape, dtype, device) -> torch.Tensor:
        digest = hashlib.blake2b(repr((self.seed,) + path).encode(), digest_size=8).digest()
        gen = torch.Generator(device=device)
        gen.manual_seed(int.from_bytes(digest, "little") >> 1)
        return torch.rand(shape, generator=gen, dtype=dtype, device=device)

    def uniform(self, pair_ids, iteration, chunk, shape, dtype, device) -> torch.Tensor:
        if pair_ids is None:
            return self._stream((None, iteration, chunk), tuple(shape), dtype, device)
        return torch.stack([self._stream((int(i), iteration, chunk), tuple(shape[1:]),
                                         dtype, device) for i in pair_ids])


def gumbel_noise(key):
    """A noise source from ``key``: an int seed or a ``torch.Generator`` (->
    :class:`SeededNoise`), or an object with a ``uniform`` method, as is."""
    if isinstance(key, (int, torch.Generator)) and not isinstance(key, bool):
        return SeededNoise(key)
    if callable(getattr(key, "uniform", None)):
        return key
    raise TypeError("Gumbel NN takes its noise from an int seed, a torch.Generator or an "
                    f"object with a uniform(pair_ids, iteration, chunk, shape, dtype, device) "
                    f"method, got {type(key).__name__}")


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
