"""The one place in :mod:`dicp_tpu_torch.parallel` that calls a collective.

Three functions carry every collective of the package, on a
``torch.distributed`` process group (one axis of a ``DeviceMesh``):

* :func:`psum`: ``all_reduce`` SUM in the forward and the identity in the
  backward (through :func:`replicated`, so that a double backward sums the
  cotangent that the identity's output receives).  This is JAX's ``psum``
  under ``shard_map`` with a replicated output: every rank computes the
  same loss from the same reduced value, so each rank's cotangent of its
  own summand is the cotangent of the sum.
  (``torch.distributed.nn.functional.all_reduce`` all-reduces the gradient
  once more, which multiplies it by the group size here.)
* :func:`replicated`: the identity in the forward and an ``all_reduce`` SUM
  of the gradient in the backward (through :func:`psum`).  Each of the two
  is the other's transpose, JAX's ``pvary`` and ``psum``: so a double
  backward, and any higher order, sums where JAX's transposes sum.
  Applied to a global input that every
  rank passes whole and each rank slices (or uses whole), it completes the
  per-rank partial gradients into JAX's gradient of the global array on
  every rank.
* :func:`ring_shift`: send to the next rank of the group and receive from the
  previous one (``reverse``: to the previous, from the next), outside
  autograd: the ring's backward, the reverse shifts, is
  ``sharding._Ring``'s, and the backward of that (a double backward), the
  forward shifts again, ``sharding._RingScatter``'s.  The reverse shifts
  count under the kind ``"ring_shift_reverse"``, the double backward's
  forward shifts under ``"ring_shift_gather"``.

:func:`psum_many` reduces several summands as ONE flat buffer (``torch.cat``
of the flattened parts, one ``all_reduce``, then split): the counterpart of
the tuple that JAX psums at once.

Each collective adds one to ``counts[(kind, group size, elements)]`` where it
is launched, and nowhere else.  A collective made while its stream is
captured (a program of :mod:`dicp_tpu_torch.jit`) runs at each replay, and
in a loop body at each iteration run, where no Python runs: it is counted on
the card instead, by an add captured beside it on a device counter of its
key (:func:`ops.launch_counts.count_keyed`).  :func:`collectives` is the
host count plus the device count; tests and the chip smoke run read it as
they read the kernels' launch counters (:func:`reset_counts` sets both to
0).
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from dicp_tpu_torch.ops import launch_counts

# Collectives launched by this process outside a capture:
# (kind, group size, elements) -> count.
counts: Counter = Counter()


def reset_counts() -> None:
    counts.clear()
    launch_counts.reset_keyed()


def collectives() -> Counter:
    """Every collective launched since :func:`reset_counts`: the host
    count plus those that captured programs ran (a host wait where any
    program was captured)."""
    return counts + Counter(launch_counts.read_keyed())


def _count(kind: str, group, x: torch.Tensor) -> None:
    key = (kind, dist.get_world_size(group), x.numel())
    if launch_counts.count_keyed(key, x.device):
        counts[key] += 1


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    _count("all_reduce", group, out)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        # the replicated cotangent enters this rank's summand: through
        # replicated, whose backward sums what a double backward sends back
        return replicated(grad, ctx.group), None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # through psum, whose backward is replicated again: each is the
        # other's transpose, at every order
        return psum(grad, ctx.group), None


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


def ring_shift(x: torch.Tensor, group, reverse: bool = False,
               kind: Optional[str] = None) -> torch.Tensor:
    """The previous rank's ``x`` (each rank sends its own to the next), or
    with ``reverse`` the next rank's (each sends to the previous); at group
    size 1 ``x`` itself, with nothing sent.  The result carries no
    gradient.  Counted under ``kind``, by default ``"ring_shift"`` or
    ``"ring_shift_reverse"``."""
    size = dist.get_world_size(group)
    if size == 1:
        return x
    rank = dist.get_rank(group)
    step = -1 if reverse else 1
    send = x.detach().contiguous()
    recv = torch.empty_like(send)
    _count(kind or ("ring_shift_reverse" if reverse else "ring_shift"), group, send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (rank + step) % size),
                      group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (rank - step) % size),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv
