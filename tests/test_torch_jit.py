"""``dicp_tpu_torch.jit``, the port's counterpart of ``jax.jit``, and the
entry points that run through it (``register_jit``, ``register_ift_jit``,
``ICP.icp``, the captured headline unit and the pipeline's window solve).

On the CPU every call runs eagerly: captured programs exist only on the card
(chip_smoke.py phase 23 holds them to the eager port there).  These tests
pin what the CPU can show: the cache key, when a call runs eagerly, the
cache's hits, misses and evictions (with the capture stubbed), the host loop
of ``device_while``, gradients through ``register_jit``, and that each entry
point gives what its eager function gives, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dicp_tpu_torch import ICP, ICPConfig, bench, pipeline, register, register_ift  # noqa: E402
from dicp_tpu_torch import register_ift_jit, register_jit, se3  # noqa: E402
from dicp_tpu_torch import jit as jit_mod  # noqa: E402
from dicp_tpu_torch import mapping, registration  # noqa: E402
from dicp_tpu_torch.registration import slice_histories  # noqa: E402

CFG = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30, tolerance=1e-10,
                dim=2, trim_dist=5.0, loss_name="huber")


def _pair(source_np, target_np, batch=1, dtype=torch.float64):
    src = torch.as_tensor(np.stack([source_np[:, :3]] * batch), dtype=dtype)
    tgt = torch.as_tensor(np.stack([target_np] * batch), dtype=dtype)
    return src, tgt, torch.eye(4, dtype=dtype).expand(batch, 4, 4)


def _assert_bit_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


PROGRAM = registration._register_captured   # the jitted object behind register_jit


def test_cache_key_follows_shape_dtype_device_cfg_and_requires_grad(source_np, target_np):
    src, tgt, ti = _pair(source_np, target_np)
    key = PROGRAM.cache_key(src, tgt, ti, None, CFG)
    assert PROGRAM.cache_key(src.clone(), tgt.clone(), ti, cfg=CFG) == key
    others = [
        PROGRAM.cache_key(*_pair(source_np, target_np, batch=2), None, CFG),
        PROGRAM.cache_key(*_pair(source_np, target_np, dtype=torch.float32), None, CFG),
        PROGRAM.cache_key(src.to("meta"), tgt.to("meta"), ti.to("meta"), None, CFG),
        PROGRAM.cache_key(src, tgt, ti, None, CFG.with_(max_iterations=31)),
        PROGRAM.cache_key(src.clone().requires_grad_(True), tgt, ti, None, CFG),
        PROGRAM.cache_key(src, tgt, ti, torch.ones(1, src.shape[1], dtype=src.dtype), CFG),
    ]
    assert len({key, *others}) == 1 + len(others)


def test_register_jit_keys_on_the_noise_source_only_where_it_is_drawn(source_np, target_np):
    """Outside Gumbel a solve ignores ``key``: register_jit drops it before
    the call (``prepare``), so a new key object or seed never captures a new
    program.  A Gumbel solve's int seed, Generator or key data enters as a
    (2,) key tensor, an input like the clouds: every such key shares one
    program; an explicit ``uniform`` object runs eagerly."""
    src, tgt, ti = _pair(source_np, target_np)
    plain = PROGRAM.cache_key(src, tgt, ti, None, CFG)
    for key in (7, torch.Generator().manual_seed(3), [1, 2], object()):
        assert PROGRAM.cache_key(src, tgt, ti, None, CFG, key) == plain
    gumbel = CFG.with_(differentiable=True, use_gumbel=True)
    keys = {PROGRAM.cache_key(src, tgt, ti, None, gumbel, key)
            for key in (7, 8, torch.Generator().manual_seed(3), np.array([0, 9], np.uint32))}
    assert len(keys) == 1 and keys != {PROGRAM.cache_key(src, tgt, ti, None, gumbel)}

    class Explicit:
        def uniform(self, pair_ids, iteration, chunk, shape, dtype, device):
            return torch.zeros(shape, dtype=dtype, device=device)

    assert PROGRAM.eager_reason(src, tgt, ti, None, gumbel, Explicit()) == "eager_if"


def test_eager_reasons(source_np, target_np):
    src, tgt, ti = _pair(source_np, target_np)
    assert PROGRAM.eager_reason(src, tgt, ti, None, CFG) == "no CUDA tensor"
    grad_src = src.clone().requires_grad_(True)
    # an input that requires grad runs a program pair on the card: only the
    # CPU keeps it eager
    assert PROGRAM.eager_reason(grad_src, tgt, ti, None, CFG) == "no CUDA tensor"
    with torch.no_grad():
        assert PROGRAM.eager_reason(grad_src, tgt, ti, None, CFG) == "no CUDA tensor"
    # a Gumbel solve's seed draws on the device: eager here only for the CPU
    gumbel = CFG.with_(differentiable=True, use_gumbel=True)
    assert PROGRAM.eager_reason(src, tgt, ti, None, gumbel, 7) == "no CUDA tensor"
    # the Anderson driver's loop is a device loop: only the CPU keeps it eager
    anderson = CFG.with_(anderson_m=4, collect_histories=False)
    assert PROGRAM.eager_reason(src, tgt, ti, None, anderson) == "no CUDA tensor"
    # SGD's mini-batch indices are drawn before the call: map_step(solver="sgd")
    # is a device program too, and its source is not part of the cache key
    m = mapping.empty_map(8, torch.float64)
    pose = torch.eye(4, dtype=torch.float64)
    for solver in ("sgd", "gn"):
        assert mapping.map_step.eager_reason(m, src[0], pose, None, CFG, 0.5,
                                             solver=solver, key=7) == "no CUDA tensor"
    keys = {mapping.map_step.cache_key(m, src[0], pose, None, CFG, 0.5, solver="sgd", key=k,
                                       sgd_iterations=3) for k in (7, 8)}
    assert len(keys) == 1


def test_cache_hits_misses_and_evicts_least_recent(monkeypatch):
    """With the capture stubbed: a repeat call replays, a new key misses
    (runs the function, then captures), and the least recently used program
    is released beyond CACHE_SIZE."""

    class Program:
        def __init__(self, key):
            self.key, self.released = key, False

        def release(self):
            self.released = True

    captured, replayed = [], []
    monkeypatch.setattr(jit_mod._Jitted, "_eager_reason", lambda self, bound, leaves: None)
    monkeypatch.setattr(jit_mod._Jitted, "_capture",
                        lambda self, key, *a: captured.append(Program(key)) or captured[-1])
    monkeypatch.setattr(jit_mod._Jitted, "_replay",
                        lambda self, prog, tensors: replayed.append(prog) or "replayed")
    monkeypatch.setattr(jit_mod, "CACHE_SIZE", 2)
    double = jit_mod.jit(lambda x, scale=2: x * scale, static_argnames=("scale",))
    try:
        x3, x4 = torch.ones(3), torch.ones(4)
        assert torch.equal(double(x3), 2 * x3) and len(captured) == 1   # a miss runs fn
        assert double(x3) == "replayed" and replayed == [captured[0]]
        assert torch.equal(double(x4), 2 * x4) and len(captured) == 2
        assert double(x3) == "replayed"                    # x3 is now the most recent
        assert torch.equal(double(x3, scale=3), 3 * x3) and len(captured) == 3
        assert [p.released for p in captured] == [False, True, False]
        assert len(double.cache) == 2
    finally:
        double.cache_clear()
        for p in captured:
            jit_mod._live.pop(id(p), None)
    assert all(p.released for p in captured)


def test_device_while_runs_a_host_loop_off_the_card():
    flag = torch.tensor(True)
    count = torch.zeros((), dtype=torch.int32)
    seen = []

    def body():
        seen.append(int(count))
        count.add_(1)
        flag.copy_(count < 4)

    jit_mod.device_while(flag, body)
    assert seen == [0, 1, 2, 3] and int(count) == 4
    jit_mod.device_while(flag, body)                    # the flag is False: no body
    assert seen == [0, 1, 2, 3]


def test_launch_counts_count_a_captured_launch_on_the_device(monkeypatch):
    """A wrapper's launch counts on the host (count returns 1) where it runs
    at once; under capture count enqueues +1 on the kernel's device counter
    and returns 0, so each replay of the launch counts.  With the capture
    stubbed and the counters on the CPU."""
    from dicp_tpu_torch.ops import launch_counts

    monkeypatch.setattr(launch_counts, "_counters", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    cpu = torch.device("cpu")
    assert launch_counts.count("tiled_nn", cpu) == 1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="prepare"):
        launch_counts.count("tiled_nn", cpu)
    launch_counts.prepare(cpu)
    assert [launch_counts.count("tiled_nn", cpu) for _ in range(3)] == [0, 0, 0]
    assert launch_counts.count("cluster_topk", cpu) == 0
    assert launch_counts.read("tiled_nn") == 3 and launch_counts.read("cluster_topk") == 1
    assert launch_counts.read("fused_gn") == 0
    launch_counts.reset()
    assert all(launch_counts.read(k) == 0 for k in launch_counts.KERNELS)


def test_gradient_through_register_jit_is_registers(source_np, target_np):
    """An input that requires grad runs register itself: the gradient of
    sum(T) equals register's bit for bit."""
    src, tgt, ti = _pair(source_np, target_np)
    cfg = CFG.with_(differentiable=True, max_iterations=12)
    grads = []
    for fn in (register_jit, register):
        s = src.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(s, tgt, ti, None, cfg).T.sum(), s)[0])
    assert torch.equal(*grads) and bool((grads[0] != 0).any())


def test_icp_through_register_jit_gives_what_it_gave(source_np, target_np):
    """ICP.icp runs register_jit: on the reference pair its results equal
    the eager register's (histories sliced) bit for bit, within 1e-10 of the
    truth."""
    solver = ICP(icp_type="pt2pl", differentiable=False, max_iterations=100,
                 tolerance=1e-10, device="cpu")
    res = solver.icp(source_np[:, :3], target_np, np.eye(4), trim_dist=5.0,
                     loss_fn={"name": "huber", "metric": 1.0}, dim=2)
    cfg = solver._call_cfg(5.0, {"name": "huber", "metric": 1.0}, 2)
    eager = slice_histories(register(*_pair(source_np, target_np), None, cfg))
    for field in ("pc", "T", "costs", "deltas", "weights"):
        assert torch.equal(res[field], getattr(eager, field)), field
    for field in ("converged", "iterations", "matched_ratio"):
        assert torch.equal(res["stats"][field], getattr(eager, field)), field
    truth = se3.tran_inv(se3.vec2tran(torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1],
                                                   dtype=torch.float64)))
    assert float((res["T"][0] - truth).abs().max()) < 1e-10


def test_ift_jit_and_captured_unit_equal_eager_off_the_card(source_np, target_np):
    src, tgt, ti = _pair(source_np, target_np, batch=2)
    cfg = bench.head_config().with_(max_iterations=30)
    _assert_bit_equal(register_ift_jit(src, tgt, ti, None, cfg),
                      register_ift(src, tgt, ti, None, cfg))
    got = bench.fwdbwd_jit(src, tgt, ti, cfg)
    want = bench.fwdbwd(register_ift, cfg, src, tgt, ti)
    _assert_bit_equal(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert bool((got[2] != 0).any())


def test_window_solve_equals_register(planes_scene):
    """The pipeline's window solve (the jitted program; eager on the CPU)
    gives register's transforms, convergence and iterations bit for bit."""
    rng = np.random.default_rng(5)
    scans = tuple(torch.as_tensor(planes_scene[:200] + rng.normal(scale=0.01, size=(200, 6)))
                  for _ in range(4))
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=20,
                    tolerance=1e-9)
    t_init = torch.eye(4, dtype=torch.float64)
    T, conv, iters = pipeline._window_solve(scans, None, t_init, cfg, 3)
    src = torch.stack(scans[1:])[..., :3]
    res = register(src, torch.stack(scans[:-1]), t_init.expand(3, 4, 4), None, cfg)
    assert torch.equal(T, res.T) and torch.equal(conv, res.converged)
    assert torch.equal(iters, res.iterations)
