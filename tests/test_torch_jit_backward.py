"""``.backward()`` through a jitted call: ``jit``'s program pair (the
counterpart of ``jax.grad`` over ``jax.jit(f)``), driven on the CPU.

A program pair's graphs exist only on the card (chip_smoke.py phase 28
holds them to ``disable_jit()`` there).  Here each test hands a jitted
function a pair whose two graphs rerun its function eagerly
(:func:`_eager_pair`): the forward on the static inputs, overwriting one
set of static buffers and one autograd graph as a replay does, the backward
from the static cotangents on the last forward's graph.  What runs is the
port's own bookkeeping: the call's cache hit, ``_PairReplays`` and the
autograd Function ``_Replayed``.  Gradients equal plain autograd through
``register_ift`` and ``register``; two forwards before their backwards
replay the stale one's forward again; ``retain_graph`` works; a double
backward differentiates the call again, to the third order; outputs that carry no gradient get none; a key's first
call runs eagerly, and a pair that leaves the cache still replays for the
calls that hold it and is released after them."""

import gc
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402

from dicp_tpu_torch import ICPConfig, bench, register, register_ift  # noqa: E402
from dicp_tpu_torch import ift, registration  # noqa: E402
from dicp_tpu_torch import jit as jit_mod  # noqa: E402

CFG = ICPConfig(icp_type="pt2pl", differentiable=True, max_iterations=8, tolerance=1e-6,
                dim=2, trim_dist=5.0, loss_name="huber", collect_histories=False)
PROBE = torch.as_tensor(np.linspace(0.5, 1.5, 16).reshape(4, 4))


class _EagerGraph:
    def __init__(self, run):
        self.replay = run


def _released():
    raise RuntimeError("replay without a preceding successful capture")


def _eager_pair(jitted, *args):
    """Put into ``jitted``'s cache, under the key of a call on ``args``, a
    program pair whose graphs rerun the function eagerly.  Returns the
    program (its ``forwards`` count the forward replays)."""
    bound, leaves, spec = jitted._bind(args, {})
    prog = _eager_program(jitted, bound, leaves, spec)
    jitted.cache[jitted._key(bound, leaves, spec)] = prog
    return prog


def _eager_program(jitted, bound, leaves, spec):
    """A program pair of ``jitted`` on the bound call whose graphs rerun the
    function eagerly; its ``release()`` leaves graphs that raise as a reset
    CUDA graph does."""
    statics = [x.detach().clone().requires_grad_(x.requires_grad) if torch.is_tensor(x) else x
               for x in leaves]
    call = dict(bound.arguments)
    call.update(pytree.tree_unflatten(statics, spec))
    last = {}

    def run():
        with torch.enable_grad():
            out = jitted.fn(**call)
        last["outs"] = [o for o in pytree.tree_leaves(out) if torch.is_tensor(o)]
        return out

    out_leaves, out_spec = pytree.tree_flatten(run())
    tensors = [o for o in out_leaves if torch.is_tensor(o)]
    diff = [i for i, o in enumerate(tensors) if o.requires_grad and o.is_floating_point()]
    inputs = [x for x in statics if torch.is_tensor(x)]
    grad_in = [i for i, x in enumerate(inputs) if x.requires_grad]
    prog = types.SimpleNamespace(
        inputs=inputs, out_spec=out_spec, diff_out=diff, grad_in=grad_in, replays=0,
        generation=0, forwards=0, released=False,
        out_leaves=[o.detach().clone() if torch.is_tensor(o) else o for o in out_leaves],
        cotangents=[torch.zeros_like(tensors[i]) for i in diff],
        grads=[torch.zeros_like(inputs[i]) for i in grad_in])

    def forward():
        prog.forwards += 1
        statics_out = [o for o in prog.out_leaves if torch.is_tensor(o)]
        run()
        for dst, src in zip(statics_out, last["outs"]):
            dst.copy_(src.detach())

    def backward():
        got = torch.autograd.grad([last["outs"][i] for i in diff],
                                  [inputs[i] for i in grad_in], prog.cotangents,
                                  retain_graph=True, allow_unused=True)
        prog.grads = [None if g is None else g for g in got]

    def release():
        prog.released = True
        prog.graph = prog.bwd_graph = _EagerGraph(_released)

    prog.graph, prog.bwd_graph = _EagerGraph(forward), _EagerGraph(backward)
    prog.release = release
    return prog


@pytest.fixture
def on_card(monkeypatch):
    """Calls on CPU tensors take the card's path (a cache hit replays)."""
    monkeypatch.setattr(jit_mod, "_on_card", lambda tensors: True)
    yield
    for fn in (registration._register_captured, ift.register_ift_jit):
        fn.cache_clear()


def _inputs(source_np, target_np, B=2):
    src = torch.as_tensor(np.stack([source_np[:, :3] + 0.02 * k for k in range(B)]))
    tgt = torch.as_tensor(np.stack([target_np] * B))
    ti = torch.eye(4, dtype=torch.float64).expand(B, 4, 4).contiguous()
    return src, tgt, ti


def _leaves(*xs):
    return [x.clone().requires_grad_(True) for x in xs]


ENTRIES = {
    "register_ift_jit": (ift.register_ift_jit, register_ift,
                         bench.head_config().with_(max_iterations=30)),
    "register_jit": (registration._register_captured, register, CFG),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_gradients_equal_plain_autograd(source_np, target_np, entry, on_card):
    """Fresh inputs through a non-leaf (gradient flows on into what made
    them): values and the gradients into source, target and T_init equal
    plain autograd through the function, bit for bit."""
    jitted, fn, cfg = ENTRIES[entry]
    src, tgt, ti = _inputs(source_np, target_np)
    prog = _eager_pair(jitted, *_leaves(src, tgt, ti), None, cfg)
    grads = []
    for call in (jitted, fn):
        base = _leaves(src, tgt, ti)
        res = call(*(2.0 * x for x in base), None, cfg)
        value = torch.sum(res.T * PROBE) + 0.01 * torch.sum(res.pc)
        grads.append((res, torch.autograd.grad(value, base)))
    (got, g_got), (want, g_want) = grads
    for name, a, b in zip(want._fields, want, got):
        assert torch.equal(a.detach(), b.detach()), name
    for name, a, b in zip(("source", "target", "T_init"), g_want, g_got):
        assert torch.equal(a, b), name
    assert bool((g_got[0] != 0).any())
    assert prog.forwards == 1 and prog.generation == 1


def test_interleaved_forwards_replay_the_stale_one(source_np, target_np, on_card):
    """A loss over two calls of one program: the backward of the call whose
    forward is no longer in the buffers replays it first, and both
    gradients equal plain autograd; backwards in either order."""
    jitted, fn, cfg = ENTRIES["register_jit"]
    src, tgt, ti = _inputs(source_np, target_np)
    src_b = src + 0.03
    prog = _eager_pair(jitted, *_leaves(src), tgt, ti, None, cfg)

    def grads(call, order):
        a, b = _leaves(src), _leaves(src_b)
        ra = call(a[0], tgt, ti, None, cfg)
        rb = call(b[0], tgt, ti, None, cfg)
        if order == "together":
            return torch.autograd.grad(torch.sum(ra.T * PROBE) + 3.0 * torch.sum(rb.T), a + b)
        first = torch.autograd.grad(torch.sum(ra.T * PROBE), a)   # a's buffers are stale
        return first + torch.autograd.grad(3.0 * torch.sum(rb.T), b)

    for order, forwards in (("together", 3), ("a first", 4)):
        before = prog.forwards
        got, want = grads(jitted, order), grads(fn, order)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), order
        assert prog.forwards - before == forwards, order


def test_retain_graph_and_double_backward(source_np, target_np, on_card, monkeypatch):
    """A second .backward() with retain_graph replays the backward again
    (after another call's forward, the forward first); the gradients add up
    as plain autograd's do.  A double backward (create_graph=True) is the
    call's VJP as a jitted call of its own (``jit._vjp_call``), eager at
    its key's first sighting and a program pair from its second: the first,
    second and third derivatives equal plain autograd's bit for bit, in
    three rounds (each order's VJP eager, then through its pair)."""
    jitted, fn, cfg = ENTRIES["register_jit"]
    src, tgt, ti = _inputs(source_np, target_np)
    prog = _eager_pair(jitted, *_leaves(src), tgt, ti, None, cfg)
    results = []
    for call in (jitted, fn):
        (s,) = _leaves(src)
        loss = torch.sum(call(s, tgt, ti, None, cfg).T * PROBE)
        loss.backward(retain_graph=True)
        once = s.grad.clone()
        call(*_leaves(src + 0.05), tgt, ti, None, cfg)     # another forward in between
        loss.backward()
        results.append((once, s.grad))
    assert torch.equal(results[0][0], results[1][0])
    assert torch.equal(results[0][1], results[1][1])
    assert torch.equal(results[0][1], 2 * results[0][0])
    assert prog.forwards == 3

    pairs = []

    def capture_pair(self, key, device, bound, leaves, spec):
        pairs.append(self.name)
        return _eager_program(self, bound, leaves, spec)

    monkeypatch.setattr(jit_mod._Jitted, "_capture_pair", capture_pair)
    rng = np.random.default_rng(4)
    v, u = (torch.as_tensor(rng.normal(size=src.shape)) for _ in range(2))

    def orders(call):
        (s,) = _leaves(src)
        (g,) = torch.autograd.grad(torch.sum(call(s, tgt, ti, None, cfg).T * PROBE), s,
                                   create_graph=True)
        (h,) = torch.autograd.grad(torch.sum(g * v), s, create_graph=True)
        (t,) = torch.autograd.grad(torch.sum(h * u), s)
        return g.detach(), h.detach(), t

    want = orders(fn)
    assert all(bool((w != 0).any()) and bool(torch.isfinite(w).all()) for w in want)
    for turn in range(3):
        got = orders(jitted)
        for order, (a, b) in enumerate(zip(got, want), 1):
            assert torch.equal(a, b), (turn, order)
    assert pairs == ["register_jit.vjp", "register_jit.vjp.vjp"]
    assert prog.forwards == 6 and len(jitted.vjp.cache) == 1 and len(jitted.vjp.vjp.cache) == 1


def test_outputs_without_gradient(source_np, target_np, on_card):
    """Outputs that are not floating point or did not require grad in the
    capture carry no gradient; a missing cotangent is zero."""
    jitted, _, cfg = ENTRIES["register_jit"]
    src, tgt, ti = _inputs(source_np, target_np)
    _eager_pair(jitted, *_leaves(src), tgt, ti, None, cfg)
    (s,) = _leaves(src)
    res = jitted(s, tgt, ti, None, cfg)
    for name in ("converged", "iterations", "matched_ratio", "costs", "weights", "deltas"):
        assert not getattr(res, name).requires_grad, name
    assert res.T.requires_grad and res.pc.requires_grad
    (g,) = torch.autograd.grad(res.T.sum(), s)     # pc's cotangent is missing
    (s2,) = _leaves(src)
    (want,) = torch.autograd.grad(register(s2, tgt, ti, None, cfg).T.sum(), s2)
    assert torch.equal(g, want)


def test_a_pair_out_of_the_cache_replays_until_its_calls_are_gone(source_np, target_np,
                                                                   on_card, monkeypatch):
    """A loss over CACHE_SIZE + 1 calls of different shapes, each its key's
    second call (the first runs eagerly and captures nothing): capturing
    the last pair drops the first from the cache, yet the first call's
    backward still replays it, and every gradient equals plain autograd.
    The dropped pair is released once the loss's graph is gone."""
    jitted, fn, cfg = ENTRIES["register_jit"]
    n = jit_mod.CACHE_SIZE + 1
    src, tgt, ti = _inputs(source_np, target_np, B=n)
    progs = []

    def capture_pair(key, device, bound, leaves, spec):
        progs.append(_eager_program(jitted, bound, leaves, spec))
        return progs[-1]

    monkeypatch.setattr(jitted, "_capture_pair", capture_pair)

    def grads(call):
        leaves, value = _leaves(*(src[:b] for b in range(1, n + 1))), 0.0
        for b, x in enumerate(leaves, 1):
            args = (x, tgt[:b], ti[:b], None, cfg)
            if call is jitted:
                call(*args)                    # first sighting: eager
                assert len(progs) == b - 1
            value = value + b * torch.sum(call(*args).T * PROBE)
        return value, leaves

    value, leaves = grads(jitted)
    assert len(progs) == n and len(jitted.cache) == jit_mod.CACHE_SIZE
    assert all(p is not progs[0] for p in jitted.cache.values())
    assert id(progs[0]) in jit_mod._retired and not progs[0].released
    got = torch.autograd.grad(value, leaves)
    want_value, want_leaves = grads(fn)
    want = torch.autograd.grad(want_value, want_leaves)
    assert torch.equal(value.detach(), want_value.detach())
    assert all(torch.equal(a, b) and bool((a != 0).any()) for a, b in zip(got, want))
    assert all(p.forwards == 1 for p in progs)
    del value
    gc.collect()
    assert progs[0].released and not any(p.released for p in progs[1:])
    assert id(progs[0]) not in jit_mod._holders and id(progs[0]) not in jit_mod._retired


def test_grad_calls_run_a_program_on_the_card(source_np, target_np, monkeypatch):
    """On the card's path a call whose input requires grad is no longer
    eager; it keys apart from the same call under no_grad; inside a capture
    it runs its function."""
    src, tgt, ti = _inputs(source_np, target_np)
    (s,) = _leaves(src)
    program = registration._register_captured
    assert program.eager_reason(s, tgt, ti, None, CFG) == "no CUDA tensor"
    monkeypatch.setattr(jit_mod, "_on_card", lambda tensors: True)
    assert program.eager_reason(s, tgt, ti, None, CFG) is None
    key = program.cache_key(s, tgt, ti, None, CFG)
    with torch.no_grad():
        assert program.eager_reason(s, tgt, ti, None, CFG) is None
        assert program.cache_key(s, tgt, ti, None, CFG) != key
    # a jitted call inside another's capture is part of that program
    monkeypatch.setattr(jit_mod, "capturing", lambda x=None: True)
    assert program.eager_reason(s, tgt, ti, None, CFG) == "inside a capture"
