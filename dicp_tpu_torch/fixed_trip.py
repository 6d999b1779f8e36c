"""JAX's differentiable scan driver as autograd steps that a capture can
record: the machinery that ``registration``, ``gicp``, ``sgd_icp`` and
``parallel.sharding`` share.

JAX differentiates a solve through a ``lax.scan`` of a fixed number of
steps, each skipped (its carry passed through) where every batch element has
converged.  The port's solves run an early-exit loop instead: a host loop
uncaptured, a CUDA graph WHILE node under capture (:func:`jit.device_while`),
whose body is captured once and rewrites its state in place.  Autograd
cannot record such a body: it would record the one captured iteration.  So
a captured solve on which autograd records takes :func:`run`, a fixed trip
of :class:`Step` autograd Functions:

* the forward of a step and its recomputing backward are each a run-once
  node (:func:`jit.device_if`), skipped where the step's flag does not hold,
  so the program neither reads the host nor launches a skipped step's work;
* the forward saves its input carry and what the step's search found (the
  int32 hard-NN indices and, where the solve gates them, the validity
  gate), nothing of the step's own graph; the backward recomputes the step
  from them with grad enabled, without searching again (the search carries
  no gradient), and takes its VJP;
* a skipped step passes the carry's cotangent through, as the VJP of JAX's
  ``lax.cond`` does, and gives none to the inputs;
* the recomputing VJP is itself an autograd Function (:class:`_VJP`), whose
  backward is the VJP of that recomputation, again a run-once node under the
  step's flag, and so on at any order: a double backward
  (``create_graph=True``) differentiates the trip as ``jax.grad`` of
  ``jax.grad`` differentiates the scan, and a skipped step still passes
  cotangents through and launches nothing.

A solve describes its step with a :class:`Trip` and runs the trip with
:func:`run`.  A step that must run a collective (the map-sharded solve's
all-reduce: CUDA refuses NCCL's kernels inside a conditional node's body)
is split at it: each part is a :class:`Trip` of its own, applied by
:func:`step` under the one flag of the step, and the collective between
them is a plain autograd op, run in every step, skipped or not, forward and
backward.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from dicp_tpu_torch.jit import device_if


class Trip:
    """What every step of one fixed trip shares.

    ``n_inputs`` leading tensors are the step's inputs (the clouds, the
    weights), read by every step and differentiable; the carry follows, its
    ``n_grad`` leading fields differentiable.  ``passthrough`` lists the
    differentiable fields that a step returns unchanged: they carry a
    gradient only where their own input does (every other one does where
    anything differentiable flows into the step)."""

    n_inputs: int
    n_grad: int
    passthrough: Tuple[int, ...] = ()

    def found(self, inputs) -> List[Optional[torch.Tensor]]:
        """Buffers, made before the step, for what its search returns (None
        for a part the search returns as None)."""
        return []

    def search(self, *query):
        """The step's search, without gradient: a tuple of tensors (or None)."""
        raise NotImplementedError

    def step(self, inputs, carry, it, search) -> Tuple[tuple, tuple]:
        """(the new carry, the step's other outputs) from ``inputs`` and
        ``carry`` at the executed-step counter ``it``, calling ``search``
        where :meth:`search` would be called."""
        raise NotImplementedError

    def skipped(self, inputs, carry) -> tuple:
        """The other outputs of a skipped step."""
        return ()


def when(run: Optional[torch.Tensor], body: Callable[[], None]) -> None:
    """``body()`` where the 0-dim bool ``run`` holds (a run-once node under
    capture); always where ``run`` is None."""
    if run is None:
        body()
    else:
        device_if(run, body)


class Step(torch.autograd.Function):
    """One step of :func:`run` (the module docstring)."""

    @staticmethod
    def forward(ctx, trip: Trip, it, run, *tensors):
        k, g = trip.n_inputs, trip.n_grad
        inputs, fields = tensors[:k], tensors[k:]
        found = trip.found(inputs)
        # the skip branch's values, overwritten where the step runs
        outs = [f.clone() for f in fields] + list(trip.skipped(inputs, fields))

        def search(*query):
            got = trip.search(*query)
            for buf, part in zip(found, got):
                if buf is not None:
                    buf.copy_(part)
            return got

        def body():
            new, other = trip.step(inputs, fields, it, search)
            for dst, val in zip(outs, (*new, *other)):
                dst.copy_(val)

        when(run, body)
        ctx.trip, ctx.it, ctx.run, ctx.found = trip, it, run, tuple(found)
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        need = ctx.needs_input_grad[3:]
        flows = any(need[:k + g])
        ctx.mark_non_differentiable(*(
            out for i, out in enumerate(outs)
            if i >= g or not (need[k + i] if i in trip.passthrough else flows)))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cotangents):
        trip = ctx.trip
        k, g = trip.n_inputs, trip.n_grad
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[3:3 + k + g]
        wanted = tuple(i for i in range(k + g) if need[i])
        grads = [None] * len(saved)
        if not wanted:
            return (None, None, None, *grads)
        fixed = tuple(f.detach() for f in saved[k + g:])

        def new_carry(*leaves):
            new, _ = trip.step(leaves[:k], (*leaves[k:], *fixed), ctx.it, lambda *q: ctx.found)
            return new[:g]

        # a skipped step passes each carry field's cotangent through: field
        # i - k's is argument (k + g) + (i - k)
        through = {p: g + i for p, i in enumerate(wanted) if i >= k}
        spec = _Spec(new_carry, k + g, wanted, through, ctx.run, frozenset(wanted))
        for i, grad in zip(wanted, _VJP.apply(spec, *saved[:k + g], *cotangents[:g])):
            grads[i] = grad
        return (None, None, None, *grads)


class _Spec(NamedTuple):
    """A recomputing VJP node (:class:`_VJP`): the arguments are ``n``
    primals, then the cotangents of ``f(*primals)``'s outputs; the node
    returns the gradients of the primals at ``wanted``.  Where ``run``
    (None: always) does not hold, output p is the argument ``through[p]``
    (a cotangent passed through), or zero where p is not in ``through``.
    ``req``: the primals that are leaves requiring grad when ``f`` runs
    (``wanted`` and those an inner order differentiates)."""

    f: Callable
    n: int
    wanted: Tuple[int, ...]
    through: dict
    run: Optional[torch.Tensor]
    req: frozenset

    def grads(self, primals, cotangents, create_graph: bool) -> tuple:
        """The VJP of ``f`` at ``primals`` (leaves, ``req`` requiring grad):
        the gradients at ``wanted`` (None where none flows)."""
        outs = self.f(*primals)
        roots = [(o, c) for o, c in zip(outs, cotangents)
                 if c is not None and o is not None and o.requires_grad]
        if not roots:
            return (None,) * len(self.wanted)
        return torch.autograd.grad([o for o, _ in roots], [primals[i] for i in self.wanted],
                                   [c for _, c in roots], allow_unused=True,
                                   create_graph=create_graph)

    def vjp(self, wanted: Tuple[int, ...], n_args: int) -> "_Spec":
        """The node of this node's own VJP over its ``n_args`` arguments,
        returning their gradients at ``wanted``: it recomputes this VJP with
        create_graph and differentiates that.  Where skipped, an argument
        that output p passed through gets p's cotangent (argument
        ``n_args + p``), every other argument zero."""
        inner = self
        passed = {j: p for p, j in self.through.items()}
        return _Spec(lambda *args: inner.grads(args[:inner.n], args[inner.n:], True), n_args,
                     wanted, {q: n_args + passed[j] for q, j in enumerate(wanted) if j in passed},
                     self.run, frozenset(wanted) | self.req)


class _VJP(torch.autograd.Function):
    """The gradients of a :class:`_Spec`, recomputed in a run-once node;
    differentiable at any order: its backward is the :class:`_VJP` of its
    own recomputation (:meth:`_Spec.vjp`), under the same flag, so a skipped
    step passes cotangents through, and launches nothing, at every order."""

    @staticmethod
    def forward(ctx, spec: _Spec, *args):
        grads = [args[spec.through[p]].clone()
                 if p in spec.through and args[spec.through[p]] is not None
                 else torch.zeros_like(args[i]) for p, i in enumerate(spec.wanted)]

        def body():
            with torch.enable_grad():
                primals = [None if x is None else x.detach().requires_grad_(i in spec.req)
                           for i, x in enumerate(args[:spec.n])]
                got = spec.grads(primals, args[spec.n:], create_graph=False)
            for buf, grad in zip(grads, got):
                if grad is None:
                    buf.zero_()
                else:
                    buf.copy_(grad)

        when(spec.run, body)
        ctx.spec = spec
        ctx.save_for_backward(*args)
        ctx.set_materialize_grads(False)
        return tuple(grads)

    @staticmethod
    def backward(ctx, *cotangents):
        args = ctx.saved_tensors
        wanted = tuple(i for i, need in enumerate(ctx.needs_input_grad[1:]) if need)
        grads = [None] * len(args)
        if wanted:
            for i, grad in zip(wanted, _VJP.apply(ctx.spec.vjp(wanted, len(args)), *args,
                                                  *cotangents)):
                grads[i] = grad
        return (None, *grads)


def step(trip: Trip, it, run: Optional[torch.Tensor], inputs: Sequence[torch.Tensor],
         carry: Sequence[torch.Tensor]) -> Tuple[tuple, tuple]:
    """One :class:`Step` of ``trip`` at the executed-step counter ``it``,
    run where the 0-dim bool ``run`` holds (always where it is None):
    (the new carry, the step's other outputs)."""
    carry = tuple(carry)
    outs = Step.apply(trip, it, run, *inputs, *carry)
    return tuple(outs[:len(carry)]), tuple(outs[len(carry):])


def run(trip: Trip, steps: int, inputs: Sequence[torch.Tensor], carry: Sequence[torch.Tensor],
        go: Optional[Callable[[tuple], torch.Tensor]]):
    """``steps`` :class:`Step` s from ``carry``; step k runs where
    ``go(carry)`` (a 0-dim bool) holds, every step where ``go`` is None.
    Returns (the final carry, each step's other outputs, the executed-step
    count as a 0-dim int32 tensor, which is also each step's ``it``)."""
    inputs, carry = tuple(inputs), tuple(carry)
    it = torch.zeros((), dtype=torch.int32, device=inputs[0].device)
    others = []
    for _ in range(steps):
        flag = None if go is None else go(carry)
        carry, other = step(trip, it, flag, inputs, carry)
        others.append(other)
        it = it + 1 if flag is None else it + flag.to(torch.int32)
    return carry, others, it
