"""The port's bench entry and suite against the JAX package's: the suite's
generators bit-equal to ``benchmarks/bench_suite.py``'s and
``benchmarks/exp_sgd.py``'s; the headline's timed unit (``register_ift``
forward and the gradient of sum(T) into the sources) within 1e-8 relative
of ``jax.grad`` of ``dicp_tpu.ift.register_ift`` under bench.py's
configuration in f64 on the CPU; its gates; ``bench.main``'s last line; the
suite's names and rows against those read from the JAX sources; and the
two reference-pair rows run on the CPU."""

import ast
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import bench_suite as jsuite  # noqa: E402
from benchmarks import exp_sgd as jexp_sgd  # noqa: E402
from dicp_tpu.config import ICPConfig as JConfig  # noqa: E402
from dicp_tpu.ift import register_ift as j_register_ift  # noqa: E402

from dicp_tpu_torch import bench  # noqa: E402
from dicp_tpu_torch.benchmarks import bench_suite, exp_sgd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SOURCES = [os.path.join(REPO, "benchmarks", f)
               for f in ("bench_suite.py", "exp_gicp.py", "exp_sgd.py", "exp_multiscale.py")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several worker
    processes that share the host's cores, where more threads per worker
    only share the same cores and slow the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name, args", [
    ("_pair", ()), ("_pair", (np.float64,)), ("_make_scene", ()), ("_make_scene", (60_000,)),
    ("_batch_inputs", (4,)),
    ("_wavy_sequence", (12, 60_000, (0.06, 0.03, 0.01, 0.004, 0.002, 0.015))),
])
def test_suite_generators_bit_equal_to_jax(name, args):
    got = getattr(bench_suite, name)(*args, **({"device": "cpu"} if name == "_batch_inputs"
                                               else {}))
    ref = getattr(jsuite, name)(*args)
    if name == "_wavy_sequence":
        assert len(got[0]) == len(ref[0]) and all(map(_bits, got[0], ref[0]))
        got, ref = got[1:], ref[1:]
    if name == "_make_scene":
        got, ref = (got,), (ref,)
    for a, b in zip(got, ref):
        assert _bits(a.numpy() if isinstance(a, torch.Tensor) else a, b)


def test_exp_sgd_scene_bit_equal_to_jax():
    assert _bits(exp_sgd._scene(20_000), jexp_sgd._scene(20_000))


def _head_inputs(B):
    src, tgt, ti = bench.reference_batch(B, dtype=torch.float64, device="cpu")
    return src, tgt, ti


def test_headline_unit_matches_jax_f64():
    """bench.fwdbwd at B = 4 in f64 on the CPU against jax.jit(jax.grad) of
    JAX's register_ift under bench.py's configuration: T and the source
    gradient within 1e-8 relative."""
    src, tgt, ti = _head_inputs(4)
    res, value, grad = bench.fwdbwd(bench.register_ift, bench.head_config(), src, tgt, ti)
    cfg = JConfig(**bench.HEAD)
    s, t, i = (jnp.asarray(a.numpy()) for a in (src, tgt, ti))
    T_j = jax.jit(lambda x: j_register_ift(x, t, i, None, cfg).T)(s)
    g_j = jax.jit(jax.grad(lambda x: jnp.sum(j_register_ift(x, t, i, None, cfg).T)))(s)
    for got, ref in ((res.T.detach().numpy(), np.asarray(T_j)), (grad.numpy(), np.asarray(g_j))):
        assert np.all(np.isfinite(ref)) and np.abs(ref).max() > 0
        assert np.abs(got - ref).max() <= 1e-8 * np.abs(ref).max()
    assert float(value) == pytest.approx(float(np.sum(np.asarray(T_j))), rel=1e-12)


def test_headline_gates_pass_on_the_cpu():
    out = bench.gates(*_head_inputs(4))
    assert out["cosine"] > bench.TOL_COSINE
    assert bool(torch.isfinite(out["grad_ift"]).all()) and bool(torch.isfinite(
        out["grad_unrolled"]).all())


def test_bench_main_prints_bench_py_line(capsys):
    line = bench.main(device="cpu")
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == line
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    with open(os.path.join(REPO, "bench.py")) as f:
        jax_bench = f.read()
    assert f'"metric": "{line["metric"]}"' in jax_bench
    assert line["metric"] == bench.METRIC and line["unit"] == "registrations/s/chip"
    assert f"BASELINE_REG_PER_S = {bench.BASELINE_REG_PER_S}" in jax_bench
    assert line["vs_baseline"] == round(line["value"] / 1293.0, 2)


def _pattern(node, loops):
    """A regex for the name expression of an ``_emit`` call in JAX's source."""
    if isinstance(node, ast.Constant):
        return re.escape(node.value)
    if isinstance(node, ast.JoinedStr):
        return "".join(re.escape(v.value) if isinstance(v, ast.Constant) else r"[\w.]+"
                       for v in node.values)
    if isinstance(node, ast.BinOp):
        return _pattern(node.left, loops) + _pattern(node.right, loops)
    if isinstance(node, ast.IfExp):
        return f"(?:{_pattern(node.body, loops)}|{_pattern(node.orelse, loops)})"
    if isinstance(node, ast.Name):
        return "(?:" + "|".join(re.escape(v) for v in loops[node.id]) + ")"
    raise AssertionError(ast.dump(node))


def _jax_rows():
    """(ALL's names, one regex per _emit call site) read from JAX's sources;
    a bare name as the row is resolved through the for loop that binds it."""
    names, patterns = None, []
    for path in JAX_SOURCES:
        tree = ast.parse(open(path).read())
        for fn in ast.walk(tree):
            if isinstance(fn, ast.Assign) and getattr(fn.targets[0], "id", None) == "ALL":
                names = [k.value for k in fn.value.keys]
            if not isinstance(fn, ast.FunctionDef):
                continue
            assigns = {a.targets[0].id: a.value for a in ast.walk(fn)
                       if isinstance(a, ast.Assign) and isinstance(a.targets[0], ast.Name)}
            loops = {}
            for loop in ast.walk(fn):
                if not (isinstance(loop, ast.For) and isinstance(loop.target, ast.Tuple)):
                    continue
                seq = assigns.get(getattr(loop.iter, "id", None), loop.iter)
                for pos, tgt in enumerate(loop.target.elts):
                    vals = [e.elts[pos].value for e in getattr(seq, "elts", [])
                            if isinstance(e, ast.Tuple) and isinstance(e.elts[pos], ast.Constant)
                            and isinstance(e.elts[pos].value, str)]
                    if vals:
                        loops[tgt.id] = vals
            for call in ast.walk(fn):
                if isinstance(call, ast.Call) and getattr(call.func, "id", None) == "_emit":
                    patterns.append(_pattern(call.args[0], loops))
    return names, patterns


def test_suite_names_and_rows_match_jax_sources():
    names, patterns = _jax_rows()
    assert list(bench_suite.ALL) == names == list(bench_suite.ROWS)
    rows = sorted(bench_suite.ROW_NAMES)
    for p in patterns:
        assert any(re.fullmatch(p, r) for r in rows), f"no port row for JAX's {p}"
    for r in rows:
        assert any(re.fullmatch(p, r) for p in patterns), f"{r} is no JAX row"
    # JAX's four files hold 32 _emit call sites (and four definitions)
    assert len(patterns) == 32


@pytest.mark.parametrize("name", ["svd_pair", "pt2pl_pair"])
def test_reference_pair_rows_run_on_the_cpu(name, capsys):
    rows = bench_suite.ALL[name]("cpu")
    out = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert out == rows and [r["name"] for r in rows] == [name]
    row = rows[0]
    assert row["unit"] == "ms/pair" and row["value"] > 0 and row["clock"] == "host (cpu)"
    assert row["transform_err"] < bench_suite.TOL_POSE and row["reps"] == bench_suite.REPS
    assert row["spread_ms"][0] <= row["median_ms"] <= row["spread_ms"][1]
