"""The one place in :mod:`dicp_tpu_torch.parallel` that calls a collective.

Three functions carry every collective of the package, on a
``torch.distributed`` process group (one axis of a ``DeviceMesh``):

* :func:`psum`: ``all_reduce`` SUM in the forward and the identity in the
  backward.  This is JAX's ``psum`` under ``shard_map`` with a replicated
  output: every rank computes the same loss from the same reduced value, so
  each rank's cotangent of its own summand is the cotangent of the sum.
  (``torch.distributed.nn.functional.all_reduce`` all-reduces the gradient
  once more, which multiplies it by the group size here.)
* :func:`replicated`: the identity in the forward and an ``all_reduce`` SUM
  of the gradient in the backward.  Applied to a global input that every
  rank passes whole and each rank slices (or uses whole), it completes the
  per-rank partial gradients into JAX's gradient of the global array on
  every rank.
* :func:`ring_shift`: send to the next rank of the group and receive from the
  previous one.  Forward only: a gradient through it raises.

:func:`psum_many` reduces several summands as ONE flat buffer (``torch.cat``
of the flattened parts, one ``all_reduce``, then split): the counterpart of
the tuple that JAX psums at once.

Each collective adds one to ``counts[(kind, group size, elements)]`` where it
is launched, and nowhere else; tests and the chip smoke run read it as they
read the kernels' launch counters (:func:`reset_counts` sets them to 0).
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence

import torch
import torch.distributed as dist

# Collectives launched by this process: (kind, group size, elements) -> count.
counts: Counter = Counter()


def reset_counts() -> None:
    counts.clear()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    counts[("all_reduce", dist.get_world_size(group), out.numel())] += 1
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        size = dist.get_world_size(group)
        rank = dist.get_rank(group)
        send = x.detach().contiguous()
        recv = torch.empty_like(send)
        counts[("ring_shift", size, send.numel())] += 1
        ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (rank + 1) % size),
                          group),
               dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (rank - 1) % size),
                          group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError("ring_shift is forward-only: no gradient flows through the ring "
                           "(register_map_sharded differentiates the replicated-target solve)")


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks; the backward passes the cotangent
    through unchanged."""
    return _PSum.apply(x, group)


def psum_many(parts: Sequence[torch.Tensor], group) -> list:
    """:func:`psum` of several tensors of one dtype in one ``all_reduce``."""
    flat = psum(torch.cat([p.reshape(-1) for p in parts]), group)
    return [f.reshape(p.shape) for f, p in zip(torch.split(flat, [p.numel() for p in parts]),
                                                parts)]


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; the backward sums the cotangent over the group."""
    return _Replicated.apply(x, group)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """The previous rank's ``x`` (each rank sends its own to the next); at
    group size 1 ``x`` itself, with nothing sent."""
    if dist.get_world_size(group) == 1:
        return x
    return _RingShift.apply(x, group)
