"""Captured device programs: the port's counterpart of ``jax.jit``.

``jit(fn, static_argnames=...)`` returns a callable with ``fn``'s signature.
On the card it runs ``fn`` as a CUDA graph, a fixed-shape device program
enqueued whole, as XLA runs a jitted function:

* The cache key is the static arguments (which must be hashable, as an
  ``ICPConfig`` is), the nesting of the other arguments, and each tensor's
  shape, dtype, device and ``requires_grad``; any other value is part of the
  key as it is.
* On a miss ``fn`` runs once eagerly on the caller's stream (this pays the
  kernels' first-use build and fills the caching allocator), then is
  captured into a ``torch.cuda.CUDAGraph`` over static copies of its tensor
  inputs, and the eager call's outputs are returned.  A miss synchronises
  with the host.
* On a hit the inputs are copied into the static buffers on the current
  stream, the graph is replayed there, and the outputs are returned as
  clones, on-stream device copies, so the next replay cannot overwrite a
  result the caller still holds.  Nothing waits for the device.
* At most ``CACHE_SIZE`` programs are kept per function, least recently
  used first out.  :func:`programs` lists them with the bytes of their
  private memory pools.  A program pair (below) that leaves the cache while
  a call of it can still be differentiated keeps its graphs and pools until
  the last such call is gone (its autograd graph freed), so its
  ``.backward()`` still replays.

``fn`` runs eagerly, uncaptured: on tensors that lie on no CUDA device (the
CPU, where the tests run); where ``eager_if(arguments)`` says so (the
host-driven paths: Gumbel noise from an explicit ``uniform`` object); inside
a capture (a jitted function called by another's program is part of it);
and inside :func:`disable_jit`, as inside ``jax.disable_jit()``.  A capture
that fails raises: there is no eager fallback on the card.

A call whose tensor input requires grad, with grad mode on, runs a program
pair, the counterpart of ``jax.grad`` over ``jax.jit(f)``.  A key's first
such call runs ``fn`` eagerly (autograd records it as it would without
``jit``), so traffic whose shapes never repeat, as a batch of scans of
varying size, costs what the eager solve costs and captures nothing.  From
its second call (the last ``SEEN_SIZE`` keys are remembered) the key
(which holds ``requires_grad`` and the grad mode) has a program pair: the
miss warms ``fn`` up forward and backward on static leaf copies of the
inputs, then captures
the forward under ``torch.enable_grad()`` and, right after it and in the
same memory pool, the backward: ``torch.autograd.grad`` of the
differentiable outputs with respect to the static inputs that require grad,
from static cotangent buffers (``torch.cuda.make_graphed_callables``' scheme,
written here because both captures need the program in :data:`_capturing`,
for the fixed trip's run-once nodes that autograd runs on a thread of its
own, and the loops' body pool).  Each call replays the forward and returns
clones of its outputs, attached by one autograd Function
(:class:`_Replayed`) to the caller's own input tensors, so gradients flow
on into whatever produced them; ``.backward()`` then copies the cotangents
in (zero where an output got none) and replays the backward.  Outputs that
are not floating point, or did not require grad in the capture, carry no
gradient.  What it costs: the pair's pool holds the forward's saved tensors
for the backward (the backward is captured with ``retain_graph``, so a
retained second ``.backward()`` replays it again), and each call clones its
inputs.  The static buffers hold one call at a time: where another call of
the same program has replayed its forward since, a backward first replays
the forward on its own saved inputs (a loss over two registrations of one
shape pays one more forward).  A double backward (``create_graph=True``)
through a program pair computes the call's VJP as a call of its own,
:func:`_vjp_call` (the function run again on the call's saved inputs, then
``torch.autograd.grad`` with ``create_graph``), jitted per function
(:attr:`_Jitted.vjp`): eager at its key's first sighting and a program pair
from its second, whose own double backward recurses, as
``jax.grad(jax.grad(jax.jit(f)))`` differentiates at any order.

A forward and its backward are also captured into one program, the
counterpart of ``jax.jit(jax.grad(f))``, by calling ``torch.autograd.grad``
inside ``fn`` (``bench.fwdbwd_jit``, ``bench.unrolled_jit``); and a
Hessian-vector product, by calling it twice, the first with
``create_graph=True``.  Either way a
solve on which autograd records inside a capture (``register``, GICP,
SGD-ICP) takes the fixed trip of JAX's scan driver
(:mod:`dicp_tpu_torch.fixed_trip`): one run-once node per step in the
forward and one in the backward, which autograd runs on a thread of its
own on the capturing stream; so the program reads nothing on the host.

``prepare(arguments)`` runs on the host before every call, eager or not,
and may replace arguments in the bound ``arguments`` dict: SGD-ICP draws
its mini-batch indices there from a host-seeded source, and a Gumbel
solve's seed becomes a key tensor there, so that the program receives them
as tensors and the source never enters the cache key.

Programs are captured in ``torch.cuda.graph``'s ``"thread_local"`` error
mode, not its default ``"global"``: c10d's watchdog thread queries CUDA
events while a program with a NCCL collective is captured, which the
``"global"`` mode refuses.

Loops whose exit the device decides are written with :func:`device_while`.
Under capture it becomes a CUDA graph conditional WHILE node
(``csrc/graph_while.cu``): the body graph runs while a flag tensor, which
the body itself rewrites, holds True.  Uncaptured, the same body runs in a
host loop that reads the flag once per iteration.

Kernel launch counts.  A replay runs no Python, so the wrappers of the
hand-written kernels count a captured launch on the card, beside the launch
(:mod:`dicp_tpu_torch.ops.launch_counts`, whose counters a capture makes
first): it counts once per replay, or once per iteration that a loop body
runs.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import inspect
import threading
import weakref
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from dicp_tpu_torch.ops import launch_counts

CACHE_SIZE = 4
SEEN_SIZE = 64   # grad keys remembered per function: a pair is captured at the second call

_local = threading.local()
# device index -> the program being captured there: read by device_while on
# any thread, since autograd runs a captured backward on a thread of its own
_capturing: dict = {}
_live: "collections.OrderedDict[int, _Program]" = collections.OrderedDict()
_jitted: "weakref.WeakSet[_Jitted]" = weakref.WeakSet()
# program pairs that live calls may still replay (id -> the number of such
# calls, _PairReplays), those of them out of the cache, and programs whose
# release waits for a running capture to end (a release frees graphs and pools);
# reentrant: a collection inside a locked block may run _let_go
_held_lock = threading.RLock()
_holders: dict = {}
_retired: set = set()
_released_later: list = []


# ---- the WHILE node ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from dicp_tpu_torch.ops import _build

    lib = _build.load("graph_while")
    lib.graph_while_begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_ulonglong)]
    lib.graph_while_set.argtypes = [ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p]
    lib.graph_while_end.argtypes = [ctypes.c_void_p]
    for f in (lib.graph_while_begin, lib.graph_while_set, lib.graph_while_end):
        f.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err == -1:
        raise RuntimeError(f"{what}: the stream is not capturing")
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


_streams: dict = {}


def _stream(device: torch.device, role: str) -> torch.cuda.Stream:
    """A stream of this module per (device, role): ``capture`` for the
    captures, ``body`` for the loop bodies.  Made outside any capture, with
    cuBLAS's per-stream workspace allocated on it there (it would otherwise
    be taken from a graph's pool during the capture)."""
    key = (device.index, role)
    if key not in _streams:
        s = torch.cuda.Stream(device)
        with torch.cuda.stream(s):
            for dt in (torch.float32, torch.float64):
                a = torch.zeros((2, 4, 4), dtype=dt, device=device)
                torch.bmm(a, a)
        s.synchronize()
        _streams[key] = s
    return _streams[key]


def capturing(x: Optional[torch.Tensor] = None) -> bool:
    """Whether the current stream (of ``x``'s device, when given) is being
    captured."""
    if x is not None and x.device.type != "cuda":
        return False
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def device_while(flag: torch.Tensor, body: Callable[[], None]) -> None:
    """Run ``body()`` while the 0-dim bool tensor ``flag`` holds True.

    ``body`` updates its state in place, ``flag`` included; it must stay
    exact when the flag is False at its start (it is then a no-op).  Under
    capture this is one WHILE node: the body is captured once, on a stream
    of its own, into the node's body graph, and its allocations come from a
    memory pool of the program.  Uncaptured, a host loop reads the flag once
    per iteration."""
    if not capturing(flag):
        while bool(flag):
            body()
        return
    dev = flag.device
    prog = _capturing.get(dev.index)
    if prog is None:
        raise RuntimeError("device_while under a capture that jit did not begin")
    lib = _lib()
    outer = torch.cuda.current_stream(dev)
    side = prog.body_stream
    handle = ctypes.c_ulonglong(0)
    # the node depends on everything the capture holds so far: no event
    _check(lib.graph_while_begin(outer.cuda_stream, side.cuda_stream, flag.data_ptr(),
                                 ctypes.byref(handle)), "graph_while_begin")
    with torch.cuda.stream(side):
        torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, prog.body_pool)
        prog.body_pool_refs += 1   # each begin takes a reference on the pool
        try:
            body()
            _check(lib.graph_while_set(handle.value, flag.data_ptr(), side.cuda_stream),
                   "graph_while_set")
        finally:
            torch._C._cuda_endAllocateToPool(dev.index, prog.body_pool)
            end = lib.graph_while_end(side.cuda_stream)
    _check(end, "graph_while_end")


def device_if(flag: torch.Tensor, body: Callable[[], None]) -> None:
    """Run ``body()`` once where the 0-dim bool tensor ``flag`` holds True:
    a :func:`device_while` whose body clears a copy of the flag (under
    capture a conditional node, uncaptured a host check).  CUDA refuses
    NCCL's kernels inside a conditional node's body: ``body`` runs no
    collective."""
    once = flag.clone()

    def run_once():
        body()
        once.fill_(False)

    device_while(once, run_once)


# ---- programs ------------------------------------------------------------

class ProgramInfo(NamedTuple):
    name: str
    key: tuple
    pool_bytes: int
    replays: int


class _Program:
    """One captured graph, its static inputs and outputs, and its loops'
    memory pool."""

    def __init__(self, name: str, key: tuple, device: torch.device):
        self.name, self.key, self.device = name, key, device
        self.graph = torch.cuda.CUDAGraph()
        self.body_pool = torch.cuda.graph_pool_handle()
        self.body_pool_refs = 0
        self.body_stream = _stream(device, "body")
        self.inputs: List[torch.Tensor] = []
        self.out_leaves: list = []
        self.out_spec = None
        self.pool_bytes = 0
        self.replays = 0
        # a program pair's backward: its graph, the static cotangents of the
        # differentiable outputs (diff_out), the static gradients of the
        # inputs that require grad (grad_in)
        self.bwd_graph: Optional[torch.cuda.CUDAGraph] = None
        self.diff_out: List[int] = []
        self.grad_in: List[int] = []
        self.cotangents: List[torch.Tensor] = []
        self.grads: list = []
        self.generation = 0   # forward replays so far

    def release(self) -> None:
        self.inputs, self.out_leaves, self.cotangents, self.grads = [], [], [], []
        if self.bwd_graph is not None:
            self.bwd_graph.reset()
        self.graph.reset()
        for _ in range(self.body_pool_refs):
            torch._C._cuda_releasePool(self.device.index, self.body_pool)
        self.body_pool_refs = 0


@contextlib.contextmanager
def _capture_of(prog: _Program):
    """The block captures ``prog``: its kernels' device counters exist, and
    device_while finds it (on any thread); a failure releases it."""
    launch_counts.prepare(prog.device)
    _capturing[prog.device.index] = prog
    try:
        yield
    except BaseException:
        prog.release()
        raise
    finally:
        _capturing.pop(prog.device.index, None)


def _retire(prog) -> None:
    """``prog`` leaves its function's cache: released now, or, while a call
    of it can still be differentiated, when the last such call is gone."""
    with _held_lock:
        if _holders.get(id(prog)):
            _retired.add(id(prog))
            return
    _release_safely(prog)


def _let_go(prog) -> None:
    """A differentiable call of ``prog`` is gone (its autograd graph freed)."""
    with _held_lock:
        _holders[id(prog)] -= 1
        if _holders[id(prog)]:
            return
        del _holders[id(prog)]
        if id(prog) not in _retired:
            return
        _retired.discard(id(prog))
    _release_safely(prog)


def _release_safely(prog) -> None:
    """Release ``prog``, or, where a capture is running (a finalizer may run
    inside one), at the next cache insertion or :func:`clear_caches` after
    it (:func:`_release_later`)."""
    with _held_lock:
        _released_later.append(prog)
    _release_later()


def _release_later() -> None:
    if _capturing or capturing():
        return
    with _held_lock:
        progs = _released_later[:]
        del _released_later[:]
    for prog in progs:
        prog.release()


def _pools(prog: _Program) -> list:
    return [prog.graph.pool()] + ([prog.body_pool] if prog.body_pool_refs else [])


def _pool_bytes(pools) -> int:
    """Bytes of the segments that belong to ``pools`` (memory pool ids)."""
    ids = {tuple(p) for p in pools}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in ids)


def clear_caches() -> None:
    """Drop the programs of every jitted function (:meth:`_Jitted.cache_clear`)."""
    for fn in list(_jitted):
        fn.cache_clear()
    _release_later()


def programs() -> List[ProgramInfo]:
    """The cached programs of every jitted function, oldest first."""
    return [ProgramInfo(p.name, p.key, p.pool_bytes, p.replays) for p in _live.values()]


@contextlib.contextmanager
def disable_jit():
    """Within the block, on this thread, every jitted function runs its
    function eagerly (``jax.disable_jit``'s counterpart)."""
    outer = getattr(_local, "disabled", False)
    _local.disabled = True
    try:
        yield
    finally:
        _local.disabled = outer


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _on_card(tensors) -> bool:
    """Whether a call on these tensors runs on the card."""
    return any(x.device.type == "cuda" for x in tensors)


def records(tensors) -> bool:
    """Whether autograd records a call on these tensors (None entries are
    absent arguments)."""
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in tensors)


class _Replayed(torch.autograd.Function):
    """One call of a program pair: ``pair.forward(inputs)`` gives its
    outputs, attached to the caller's ``inputs``; the backward returns
    ``pair.backward(cotangents)``, the gradients of the inputs (None where
    one needs none), or under create_graph ``pair.vjp(inputs, cotangents)``.

    ``pair`` holds the replays (:class:`_PairReplays` on the card; any
    object with ``forward``, ``backward``, ``vjp``, ``generation`` and
    ``lock``, so that eager stand-ins can drive this on the CPU).
    ``forward`` writes one set of static buffers and counts its calls in
    ``generation``: the Function saves its inputs and the generation of its
    replay, and where another forward has replayed since, its backward
    replays the forward on its own inputs first."""

    @staticmethod
    def forward(ctx, pair, diff_out, *inputs):
        outs = pair.forward(inputs)
        ctx.pair, ctx.generation = pair, pair.generation
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*(o for i, o in enumerate(outs) if i not in diff_out))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cotangents):
        pair, inputs = ctx.pair, ctx.saved_tensors
        if torch.is_grad_enabled():
            # a double backward: the gradients as a differentiable call
            return (None, None, *pair.vjp(inputs, cotangents))
        with pair.lock:
            if pair.generation != ctx.generation:
                pair.forward(inputs)   # another call's forward holds the buffers
                ctx.generation = pair.generation
            grads = pair.backward(cotangents)
        return (None, None, *grads)


class _PairReplays:
    """The replays of a program pair (:class:`_Program` with a backward
    graph), for one call's :class:`_Replayed`.  While it lives (as long as
    the call's autograd graph) it holds the program: a program that leaves
    the cache is released only when its last holder is gone."""

    def __init__(self, prog: "_Program", lock, vjp_of: "_CallOf"):
        self.prog, self.lock, self.vjp_of = prog, lock, vjp_of
        with _held_lock:
            _holders[id(prog)] = _holders.get(id(prog), 0) + 1
        weakref.finalize(self, _let_go, prog).atexit = False

    @property
    def generation(self) -> int:
        return self.prog.generation

    def forward(self, inputs) -> list:
        prog = self.prog
        with torch.no_grad():
            for buf, x in zip(prog.inputs, inputs):
                buf.copy_(x)
        prog.graph.replay()
        prog.replays += 1
        prog.generation += 1
        return [x.detach().clone() for x in prog.out_leaves if _is_tensor(x)]

    def backward(self, cotangents) -> list:
        prog = self.prog
        for buf, i in zip(prog.cotangents, prog.diff_out):
            if cotangents[i] is None:
                buf.zero_()
            else:
                buf.copy_(cotangents[i])
        prog.bwd_graph.replay()
        grads = [None] * len(prog.inputs)
        for i, g in zip(prog.grad_in, prog.grads):
            grads[i] = None if g is None else g.clone()
        return grads

    def vjp(self, inputs, cotangents) -> list:
        """The gradients of ``inputs`` as a differentiable call (a double
        backward): :func:`_vjp_call` through the function's VJP program."""
        of = self.vjp_of
        got = iter(of.jitted.vjp(of, list(inputs),
                                 [cotangents[i] for i in self.prog.diff_out]))
        return [next(got) if x.requires_grad else None for x in inputs]


class _CallOf:
    """The static argument of a VJP program (:func:`_vjp_call`): a call of
    ``jitted`` with the key ``key``, its arguments with the tensors left
    out, and its differentiable outputs (``diff_out``, indices among the
    tensor outputs).  Equal for the calls of one key, so that they share
    one VJP program."""

    def __init__(self, jitted: "_Jitted", key: tuple, bound, leaves, spec, diff_out):
        self.jitted, self.key, self.spec, self.diff_out = jitted, key, spec, tuple(diff_out)
        self.arguments = collections.OrderedDict(
            (k, v if k in jitted.static else None) for k, v in bound.arguments.items())
        self.leaves = [None if _is_tensor(x) else x for x in leaves]
        self.tensor_at = [i for i, x in enumerate(leaves) if _is_tensor(x)]

    def __eq__(self, other) -> bool:
        return (isinstance(other, _CallOf) and other.jitted is self.jitted
                and other.key == self.key)

    def __hash__(self) -> int:
        return hash((id(self.jitted), self.key))

    def call(self, inputs):
        """The call's function on the tensors ``inputs``."""
        leaves = list(self.leaves)
        for i, x in zip(self.tensor_at, inputs):
            leaves[i] = x
        arguments = collections.OrderedDict(self.arguments)
        arguments.update(pytree.tree_unflatten(leaves, self.spec))
        bound = inspect.BoundArguments(self.jitted.signature, arguments)
        return self.jitted.fn(*bound.args, **bound.kwargs)


def _vjp_call(of: _CallOf, inputs: list, cotangents: list) -> list:
    """The VJP of the call ``of`` at the tensors ``inputs``: the gradients
    of those that require grad (None where none flows) from the cotangents
    of its differentiable outputs (None: none), with create_graph, so that
    it is differentiable once more.  Jitted per function
    (:meth:`_Jitted.vjp`): a double backward through a program pair is
    this call, eager at its key's first sighting and a program pair of its
    own from the second, and so on at every order."""
    with torch.enable_grad():
        out = [o for o in pytree.tree_leaves(of.call(inputs)) if _is_tensor(o)]
    wrt = [x for x in inputs if x.requires_grad]
    roots = [(out[i], c) for i, c in zip(of.diff_out, cotangents)
             if c is not None and out[i].requires_grad]
    if not roots:
        return [None] * len(wrt)
    grads = torch.autograd.grad([o for o, _ in roots], wrt, [c for _, c in roots],
                                allow_unused=True, create_graph=True)
    # contiguous: a program pair's static cotangent takes its output's
    # strides, and a gradient may come out transposed, where a loss's
    # cotangent comes dense; the backward's bits follow the layout
    return [None if g is None else g.contiguous() for g in grads]


class _Jitted:
    def __init__(self, fn, static_argnames, eager_if, name, prepare):
        self.fn = fn
        self.static = tuple(static_argnames)
        self.eager_if = eager_if
        self.prepare = prepare
        self.name = name or getattr(fn, "__name__", "fn")
        self.signature = inspect.signature(fn)
        self.cache: "collections.OrderedDict[tuple, _Program]" = collections.OrderedDict()
        self.seen: "collections.OrderedDict[tuple, None]" = collections.OrderedDict()
        self.lock = threading.RLock()
        self._vjp: Optional[_Jitted] = None
        functools.update_wrapper(self, fn)
        _jitted.add(self)

    @property
    def vjp(self) -> "_Jitted":
        """:func:`_vjp_call` jitted for this function's calls: the double
        backward of its program pairs."""
        with self.lock:
            if self._vjp is None:
                self._vjp = _Jitted(_vjp_call, ("of",), None, f"{self.name}.vjp", None)
            return self._vjp

    def _bind(self, args, kwargs):
        bound = self.signature.bind(*args, **kwargs)
        bound.apply_defaults()
        if self.prepare is not None:
            self.prepare(bound.arguments)
        dynamic = {k: v for k, v in bound.arguments.items() if k not in self.static}
        leaves, spec = pytree.tree_flatten(dynamic)
        return bound, leaves, spec

    def _eager_reason(self, bound, leaves) -> Optional[str]:
        if getattr(_local, "disabled", False):
            return "disable_jit"
        tensors = [x for x in leaves if _is_tensor(x)]
        if self.eager_if is not None and self.eager_if(bound.arguments):
            return "eager_if"
        if not _on_card(tensors):
            return "no CUDA tensor"
        if capturing():
            return "inside a capture"
        return None

    def _key(self, bound, leaves, spec) -> tuple:
        tensors = [x for x in leaves if _is_tensor(x)]
        return (tuple(bound.arguments[k] for k in self.static), str(spec),
                tuple((tuple(x.shape), x.dtype, x.device, x.requires_grad) if _is_tensor(x)
                      else ("value", x) for x in leaves), records(tensors))

    def cache_key(self, *args, **kwargs) -> tuple:
        """The key of a call with these arguments in the cache."""
        return self._key(*self._bind(args, kwargs))

    def eager_reason(self, *args, **kwargs) -> Optional[str]:
        """Why a call with these arguments runs ``fn`` eagerly, or None where
        it runs a captured program (a differentiable call from its key's
        second call on)."""
        bound, leaves, _ = self._bind(args, kwargs)
        return self._eager_reason(bound, leaves)

    def __call__(self, *args, **kwargs):
        bound, leaves, spec = self._bind(args, kwargs)
        if self._eager_reason(bound, leaves) is not None:
            return self.fn(*bound.args, **bound.kwargs)
        tensors = [x for x in leaves if _is_tensor(x)]
        devices = {x.device for x in tensors}
        if len(devices) > 1:
            raise ValueError(f"inputs lie on different devices: {sorted(map(str, devices))}")
        key = self._key(bound, leaves, spec)
        with self.lock:
            grad = key[-1]   # autograd records the call: a program pair
            prog = self.cache.get(key)
            if prog is None and grad and key not in self.seen:
                self.seen[key] = None   # first sighting: eager, nothing captured
                while len(self.seen) > SEEN_SIZE:
                    self.seen.popitem(last=False)
                return self.fn(*bound.args, **bound.kwargs)
            if prog is None and grad:
                prog = self._capture_pair(key, devices.pop(), bound, leaves, spec)
                self._insert(key, prog)
            elif prog is None:
                return self._miss(key, devices.pop(), bound, leaves, spec)
            self.cache.move_to_end(key)
            if grad and prog.bwd_graph is not None:
                return self._replay_pair(prog, tensors,
                                         _CallOf(self, key, bound, leaves, spec, prog.diff_out))
            return self._replay(prog, tensors)

    def _replay(self, prog: _Program, tensors):
        with torch.no_grad():
            for buf, x in zip(prog.inputs, tensors):
                buf.copy_(x)
        prog.graph.replay()
        prog.replays += 1
        leaves = [x.clone() if _is_tensor(x) else x for x in prog.out_leaves]
        return pytree.tree_unflatten(leaves, prog.out_spec)

    def _replay_pair(self, prog: _Program, tensors, vjp_of: _CallOf):
        outs = iter(_Replayed.apply(_PairReplays(prog, self.lock, vjp_of), prog.diff_out,
                                    *tensors))
        leaves = [next(outs) if _is_tensor(x) else x for x in prog.out_leaves]
        return pytree.tree_unflatten(leaves, prog.out_spec)

    def _miss(self, key, device, bound, leaves, spec):
        out = self.fn(*bound.args, **bound.kwargs)   # warm-up: builds, allocator
        self._insert(key, self._capture(key, device, bound, leaves, spec))
        return out

    def _static_call(self, prog: _Program, bound, leaves, spec, grad: bool):
        """The bound arguments of ``fn`` on static copies of the tensor
        leaves (leaves that require grad where the caller's do and ``grad``),
        which become ``prog.inputs``."""
        statics = [torch.empty_like(x, memory_format=torch.contiguous_format)
                   .copy_(x.detach()).requires_grad_(grad and x.requires_grad)
                   if _is_tensor(x) else x for x in leaves]
        prog.inputs = [x for x in statics if _is_tensor(x)]
        call = collections.OrderedDict(bound.arguments)
        call.update(pytree.tree_unflatten(statics, spec))
        return inspect.BoundArguments(self.signature, call)

    def _capture(self, key, device, bound, leaves, spec) -> _Program:
        prog = _Program(self.name, key, device)
        cbound = self._static_call(prog, bound, leaves, spec, grad=False)
        with _capture_of(prog):
            with torch.cuda.graph(prog.graph, stream=_stream(device, "capture"),
                                  capture_error_mode="thread_local"):
                captured = self.fn(*cbound.args, **cbound.kwargs)
        prog.out_leaves, prog.out_spec = pytree.tree_flatten(captured)
        prog.pool_bytes = _pool_bytes(_pools(prog))
        return prog

    def _capture_pair(self, key, device, bound, leaves, spec) -> _Program:
        """A program pair (the module docstring): warm-up, the forward's
        capture, then the backward's, in the forward's pool."""
        prog = _Program(self.name, key, device)
        cbound = self._static_call(prog, bound, leaves, spec, grad=True)
        wrt = [x for x in prog.inputs if x.requires_grad]

        def differentiable(out):
            return [i for i, x in enumerate(o for o in out if _is_tensor(o))
                    if x.requires_grad and x.is_floating_point()]

        def backward(outs, cotangents, **kw):
            return torch.autograd.grad(outs, wrt, cotangents, allow_unused=True, **kw)

        # warm-up, forward and backward: builds, the allocator, cuBLAS's
        # workspace of autograd's thread
        with torch.enable_grad():
            out = pytree.tree_leaves(self.fn(*cbound.args, **cbound.kwargs))
        tensors = [o for o in out if _is_tensor(o)]
        diff = differentiable(out)
        if diff:
            backward([tensors[i] for i in diff], [torch.zeros_like(tensors[i]) for i in diff])
        del out, tensors
        stream = _stream(device, "capture")
        with _capture_of(prog):
            with torch.cuda.graph(prog.graph, stream=stream, capture_error_mode="thread_local"):
                with torch.enable_grad():
                    captured = self.fn(*cbound.args, **cbound.kwargs)
            prog.out_leaves, prog.out_spec = pytree.tree_flatten(captured)
            prog.diff_out = differentiable(prog.out_leaves)
            if prog.diff_out:
                tensors = [o for o in prog.out_leaves if _is_tensor(o)]
                outs = [tensors[i] for i in prog.diff_out]
                prog.cotangents = [torch.zeros_like(o) for o in outs]
                prog.grad_in = [i for i, x in enumerate(prog.inputs) if x.requires_grad]
                prog.bwd_graph = torch.cuda.CUDAGraph()
                # retain_graph: the saved tensors stay for a second backward
                with torch.cuda.graph(prog.bwd_graph, pool=prog.graph.pool(), stream=stream,
                                      capture_error_mode="thread_local"):
                    prog.grads = list(backward(outs, prog.cotangents, retain_graph=True))
        prog.pool_bytes = _pool_bytes(_pools(prog))
        return prog

    def _insert(self, key, prog) -> None:
        self.cache[key] = prog
        _live[id(prog)] = prog
        while len(self.cache) > CACHE_SIZE:
            _, old = self.cache.popitem(last=False)
            _live.pop(id(old), None)
            _retire(old)
        _release_later()

    def cache_clear(self) -> None:
        """Drop every program of this function (a program pair's once no
        call of it can be differentiated) and forget the keys seen."""
        with self.lock:
            for prog in self.cache.values():
                _live.pop(id(prog), None)
                _retire(prog)
            self.cache.clear()
            self.seen.clear()
        if self._vjp is not None:
            self._vjp.cache_clear()


def jit(fn, *, static_argnames: Sequence[str] = (),
        eager_if: Optional[Callable[[dict], bool]] = None, name: Optional[str] = None,
        prepare: Optional[Callable[[dict], None]] = None):
    """``fn`` as a captured device program on the card (see the module
    docstring).  ``eager_if(arguments)``: calls to run eagerly; ``name``:
    the programs' name in :func:`programs`; ``prepare(arguments)``: host
    work that rewrites the bound arguments before each call."""
    return _Jitted(fn, static_argnames, eager_if, name, prepare)
