"""Nearest-neighbour correspondence search: the counterpart of
``dicp_tpu/knn.py`` (hard NN; Gumbel soft NN is not ported yet).

Hard NN: squared distances -> first argmin -> gather of the full target rows
(normals ride along).  The index is an integer computed without gradient, so
gradient reaches the target only through :func:`gather_rows`, and the query
gets none through the selection.

Two tiers:

* dense: one (..., n, m) distance matrix in the matmul form
  |x|^2 + |y|^2 - 2 x.y^T, plain PyTorch (XLA computed it outside any kernel);
* tiled: :mod:`dicp_tpu_torch.ops.tiled_knn`, the hand-written CUDA kernel K1
  for CUDA tensors and its plain version for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
            use_gumbel: bool = False, use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Public NN entry point (shape-normalizing), hard NN only."""
    x_use, y_use = _handle_dimensions(x, y)
    if differentiable and use_gumbel:
        raise NotImplementedError("Gumbel soft nearest neighbour is not ported to "
                                  "dicp_tpu_torch yet (ROADMAP.md Queue 1 item 2)")
    return find_nn_normalized(x_use, y_use, use_pallas)
