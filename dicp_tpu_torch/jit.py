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
  private memory pools.

``fn`` runs eagerly, uncaptured: on tensors that lie on no CUDA device (the
CPU, where the tests run); when an input requires grad while grad mode is on
(a captured forward cannot feed a backward taken later, outside the
program, so ``register_jit(s).T.sum().backward()`` is the backward of ``fn``
itself); where ``eager_if(arguments)`` says so (the host-driven paths:
Gumbel noise from an explicit ``uniform`` object); and inside
:func:`disable_jit`, as inside
``jax.disable_jit()``.  A capture that fails raises: there is no eager
fallback on the card.

A forward and its backward are captured together, the counterpart of
``jax.jit(jax.grad(f))``, by calling ``torch.autograd.grad`` inside ``fn``
(``bench.fwdbwd_jit``, ``bench.unrolled_jit``).  A solve on which autograd
records inside a capture (through ``register``, ``register_jit`` or
``ICP.icp``) takes the fixed trip of JAX's scan driver
(``registration._run_fixed_trip``): one run-once node per step in the
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

_local = threading.local()
# device index -> the program being captured there: read by device_while on
# any thread, since autograd runs a captured backward on a thread of its own
_capturing: dict = {}
_live: "collections.OrderedDict[int, _Program]" = collections.OrderedDict()
_jitted: "weakref.WeakSet[_Jitted]" = weakref.WeakSet()


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

    def release(self) -> None:
        self.inputs, self.out_leaves = [], []
        self.graph.reset()
        for _ in range(self.body_pool_refs):
            torch._C._cuda_releasePool(self.device.index, self.body_pool)
        self.body_pool_refs = 0


def _pool_bytes(pools) -> int:
    """Bytes of the segments that belong to ``pools`` (memory pool ids)."""
    ids = {tuple(p) for p in pools}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in ids)


def clear_caches() -> None:
    """Drop the programs of every jitted function (:meth:`_Jitted.cache_clear`)."""
    for fn in list(_jitted):
        fn.cache_clear()


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


class _Jitted:
    def __init__(self, fn, static_argnames, eager_if, name, prepare):
        self.fn = fn
        self.static = tuple(static_argnames)
        self.eager_if = eager_if
        self.prepare = prepare
        self.name = name or getattr(fn, "__name__", "fn")
        self.signature = inspect.signature(fn)
        self.cache: "collections.OrderedDict[tuple, _Program]" = collections.OrderedDict()
        self.lock = threading.Lock()
        functools.update_wrapper(self, fn)
        _jitted.add(self)

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
        if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
            return "an input requires grad"
        if self.eager_if is not None and self.eager_if(bound.arguments):
            return "eager_if"
        if not any(x.device.type == "cuda" for x in tensors):
            return "no CUDA tensor"
        return None

    def _key(self, bound, leaves, spec) -> tuple:
        return (tuple(bound.arguments[k] for k in self.static), str(spec),
                tuple((tuple(x.shape), x.dtype, x.device, x.requires_grad) if _is_tensor(x)
                      else ("value", x) for x in leaves))

    def cache_key(self, *args, **kwargs) -> tuple:
        """The key of a call with these arguments in the cache."""
        return self._key(*self._bind(args, kwargs))

    def eager_reason(self, *args, **kwargs) -> Optional[str]:
        """Why a call with these arguments runs ``fn`` eagerly, or None where
        it runs a captured program."""
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
            prog = self.cache.get(key)
            if prog is not None:
                self.cache.move_to_end(key)
                return self._replay(prog, tensors)
            return self._miss(key, devices.pop(), bound, leaves, spec)

    def _replay(self, prog: _Program, tensors):
        for buf, x in zip(prog.inputs, tensors):
            buf.copy_(x)
        prog.graph.replay()
        prog.replays += 1
        leaves = [x.clone() if _is_tensor(x) else x for x in prog.out_leaves]
        return pytree.tree_unflatten(leaves, prog.out_spec)

    def _miss(self, key, device, bound, leaves, spec):
        out = self.fn(*bound.args, **bound.kwargs)   # warm-up: builds, allocator
        self._insert(key, self._capture(key, device, bound, leaves, spec))
        return out

    def _capture(self, key, device, bound, leaves, spec) -> _Program:
        prog = _Program(self.name, key, device)
        statics = [torch.empty_like(x, memory_format=torch.contiguous_format).copy_(x)
                   if _is_tensor(x) else x for x in leaves]
        prog.inputs = [x for x in statics if _is_tensor(x)]
        call = collections.OrderedDict(bound.arguments)
        call.update(pytree.tree_unflatten(statics, spec))
        cbound = inspect.BoundArguments(self.signature, call)
        launch_counts.prepare(device)
        _capturing[device.index] = prog
        try:
            with torch.cuda.graph(prog.graph, stream=_stream(device, "capture"),
                                  capture_error_mode="thread_local"):
                captured = self.fn(*cbound.args, **cbound.kwargs)
        except BaseException:
            prog.release()
            raise
        finally:
            _capturing.pop(device.index, None)
        prog.out_leaves, prog.out_spec = pytree.tree_flatten(captured)
        pools = [prog.graph.pool()] + ([prog.body_pool] if prog.body_pool_refs else [])
        prog.pool_bytes = _pool_bytes(pools)
        return prog

    def _insert(self, key, prog) -> None:
        self.cache[key] = prog
        _live[id(prog)] = prog
        while len(self.cache) > CACHE_SIZE:
            _, old = self.cache.popitem(last=False)
            _live.pop(id(old), None)
            old.release()

    def cache_clear(self) -> None:
        """Drop every program of this function."""
        with self.lock:
            for prog in self.cache.values():
                _live.pop(id(prog), None)
                prog.release()
            self.cache.clear()


def jit(fn, *, static_argnames: Sequence[str] = (),
        eager_if: Optional[Callable[[dict], bool]] = None, name: Optional[str] = None,
        prepare: Optional[Callable[[dict], None]] = None):
    """``fn`` as a captured device program on the card (see the module
    docstring).  ``eager_if(arguments)``: calls to run eagerly; ``name``:
    the programs' name in :func:`programs`; ``prepare(arguments)``: host
    work that rewrites the bound arguments before each call."""
    return _Jitted(fn, static_argnames, eager_if, name, prepare)
