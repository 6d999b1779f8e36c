"""A world of gloo ranks on the CPU for the tests of ``dicp_tpu_torch.parallel``:
the counterpart of ``tests/_mp_worker.py``.

:class:`World` starts ``size`` processes (``python -m tests._torch_world``),
each of which sets one intra-op thread, joins the world through the port's own
``initialize_distributed(device="cpu")`` from ``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK``, and then serves jobs.  A job is a function of this
module (named in :data:`JOBS`), numpy keyword arguments and a mesh shape; every
rank runs it SPMD on a ``make_mesh(shape, devices="cpu")`` mesh (built once
per shape) and returns numpy results, and :meth:`World.run` returns every
rank's.  Each job has a timeout; :meth:`World.close` tears the world down.
The ranks import only torch, numpy and ``dicp_tpu_torch``; each job's result
holds the collectives that ``parallel._comm`` counted while it ran.
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import subprocess
import sys
import tempfile
import threading
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """``size`` gloo ranks on this host; ``local_world_size`` ranks per
    simulated host (torchrun's ``LOCAL_WORLD_SIZE``, default all)."""

    def __init__(self, size: int = 8, local_world_size: int = None, timeout: float = 120.0):
        self.size, self.timeout = size, timeout
        port = _free_port()
        lws = size if local_world_size is None else local_world_size
        self.procs, self.logs, self.results = [], [], []
        for rank in range(size):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(size), RANK=str(rank), LOCAL_RANK=str(rank % lws),
                       LOCAL_WORLD_SIZE=str(lws), OMP_NUM_THREADS="1")
            log = tempfile.TemporaryFile()
            proc = subprocess.Popen([sys.executable, "-m", "tests._torch_world"], cwd=REPO,
                                    env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                    stderr=log)
            results = queue.Queue()
            threading.Thread(target=self._read, args=(proc.stdout, results),
                             daemon=True).start()
            self.procs.append(proc)
            self.logs.append(log)
            self.results.append(results)

    @staticmethod
    def _read(stream, results):
        try:
            while True:
                results.put(pickle.load(stream))
        except (EOFError, OSError, pickle.UnpicklingError) as exc:
            results.put(("exited", repr(exc)))

    def _log_tail(self, rank: int) -> str:
        log = self.logs[rank]
        log.seek(0)
        return log.read().decode(errors="replace")[-4000:]

    def run(self, job: str, mesh_shape=None, timeout: float = None, **kwargs) -> list:
        """Every rank's result of ``JOBS[job](mesh, **kwargs)``."""
        msg = pickle.dumps((job, None if mesh_shape is None else tuple(mesh_shape), kwargs))
        for proc in self.procs:
            proc.stdin.write(msg)
            proc.stdin.flush()
        out = []
        for rank, results in enumerate(self.results):
            try:
                status, value = results.get(timeout=timeout or self.timeout)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"rank {rank} gave no result for {job}:\n"
                                   + self._log_tail(rank)) from None
            if status != "ok":
                self.close()
                raise RuntimeError(f"rank {rank} failed in {job}: {value}\n"
                                   + self._log_tail(rank))
            out.append(value)
        return out

    def close(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                try:
                    proc.stdin.write(pickle.dumps(None))
                    proc.stdin.close()
                except OSError:
                    pass
        for proc in self.procs:
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for log in self.logs:
            log.close()
        self.procs = []


# --- jobs (run on every rank) ---------------------------------------------------

def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def _counts():
    from dicp_tpu_torch.parallel import _comm

    return sorted(_comm.counts.items())


def _graph(edges_i, edges_j, t_meas, info):
    import torch

    from dicp_tpu_torch.odometry import PoseGraph

    return PoseGraph(torch.as_tensor(edges_i), torch.as_tensor(edges_j),
                     torch.as_tensor(t_meas), torch.as_tensor(info))


def job_world_info(mesh):
    import torch.distributed as dist

    return {"world": dist.get_world_size(), "rank": dist.get_rank(),
            "backend": dist.get_backend(), "mesh": tuple(mesh.shape)}


def job_map_sharded(mesh, source, target, cfg, T_init=None, weight=None, axis="map",
                    entry="register_map_sharded", grad_wrt=(), probe=None, expect_error=False):
    """One map-sharded, ring-sharded or IFT solve; with ``grad_wrt`` the
    gradient of sum(T * probe) with respect to the named inputs, and the
    collectives of the forward and of the backward apart.  With
    ``expect_error`` the ValueError or RuntimeError that every rank raises
    alike, as {"error": message}."""
    try:
        return _map_sharded(mesh, source, target, cfg, T_init, weight, axis, entry, grad_wrt,
                            probe)
    except (ValueError, RuntimeError) as exc:
        if expect_error:
            return {"error": str(exc)}
        raise


def _map_sharded(mesh, source, target, cfg, T_init, weight, axis, entry, grad_wrt, probe):
    import torch

    from dicp_tpu_torch import parallel
    from dicp_tpu_torch.parallel import _comm

    inputs = {"source": torch.as_tensor(source), "target": torch.as_tensor(target),
              "weight": None if weight is None else torch.as_tensor(weight)}
    for name in grad_wrt:
        inputs[name] = inputs[name].clone().requires_grad_(True)
    res = getattr(parallel, entry)(mesh, inputs["source"], inputs["target"],
                                   None if T_init is None else torch.as_tensor(T_init),
                                   inputs["weight"], cfg=cfg, axis=axis)
    out = {"T": _np(res.T), "converged": bool(res.converged),
           "iterations": int(res.iterations), "cost": float(res.cost),
           "counts_fwd": _counts()}
    if grad_wrt:
        _comm.reset_counts()
        loss = torch.sum(res.T * (1.0 if probe is None else torch.as_tensor(probe)))
        grads = torch.autograd.grad(loss, [inputs[name] for name in grad_wrt])
        out["grads"] = {name: _np(g) for name, g in zip(grad_wrt, grads)}
        out["counts_bwd"] = _counts()
    return out


def job_batch_sharded(mesh, source, target, T_init, cfg, weight=None, key=None):
    """This rank's rows of a batch-sharded solve and their global indices."""
    import torch

    from dicp_tpu_torch.parallel import register_batch_sharded
    from dicp_tpu_torch.parallel.sharding import _axis

    res = register_batch_sharded(mesh, torch.as_tensor(source), torch.as_tensor(target),
                                 torch.as_tensor(T_init),
                                 None if weight is None else torch.as_tensor(weight), cfg, key)
    _, rank, size = _axis(mesh, "batch")
    per = source.shape[0] // size
    return {"rows": list(range(rank * per, (rank + 1) * per)), "T": _np(res.T),
            "matched_ratio": _np(res.matched_ratio), "converged": _np(res.converged),
            "iterations": _np(res.iterations), "counts": _counts()}


def job_ring_nn(mesh, x, y, axis="map"):
    """ring_nn of this rank's query rows against the ring of target shards."""
    import torch

    from dicp_tpu_torch.parallel import ring_nn
    from dicp_tpu_torch.parallel.sharding import _axis

    group, rank, size = _axis(mesh, axis)
    nx, ny = x.shape[0] // size, y.shape[0] // size
    got = ring_nn(torch.as_tensor(x[rank * nx:(rank + 1) * nx]),
                  torch.as_tensor(y[rank * ny:(rank + 1) * ny]), group)
    return {"rows": _np(got), "counts": _counts()}


def job_pose_graph(mesh, poses, edges_i, edges_j, t_meas, info, iterations, axis="map",
                   pod_map_per_host=None):
    """The partitioned pose-graph solve, on ``make_pod_mesh(pod_map_per_host)``
    when that is given."""
    import torch

    from dicp_tpu_torch.parallel import pose_graph_optimize_partitioned
    from dicp_tpu_torch.parallel.multihost import make_pod_mesh

    if pod_map_per_host is not None:
        mesh = make_pod_mesh(pod_map_per_host, devices="cpu")
    out = pose_graph_optimize_partitioned(torch.as_tensor(poses),
                                          _graph(edges_i, edges_j, t_meas, info), mesh,
                                          iterations=iterations, axis=axis)
    return {"poses": _np(out), "counts": _counts()}


def job_refine_robust(mesh, poses, edges_i, edges_j, t_meas, info, iterations):
    import torch

    from dicp_tpu_torch.slam import refine_robust

    out = refine_robust(torch.as_tensor(poses), _graph(edges_i, edges_j, t_meas, info),
                        mesh=mesh, iterations=iterations)
    return {"poses": _np(out), "counts": _counts()}


def job_slam_static(mesh, scan, copies, cfg, slam_kw):
    """slam_odometry(mesh=...) over ``copies`` views of one scan (a resting
    sensor: every revisit closes), with the partitioned back end's calls
    recorded."""
    from dicp_tpu_torch import slam

    calls = []
    solve = slam.pose_graph_optimize_partitioned

    def spy(poses, graph, mesh_, **kw):
        calls.append(mesh_ is mesh)
        return solve(poses, graph, mesh_, **kw)

    slam.pose_graph_optimize_partitioned = spy
    try:
        res = slam.slam_odometry(((scan, None) for _ in range(copies)), cfg, mesh=mesh,
                                 device="cpu", **slam_kw)
    finally:
        slam.pose_graph_optimize_partitioned = solve
    return {"poses": _np(res.poses), "poses_front": _np(res.poses_front),
            "closures": len(res.closures), "calls": calls, "counts": _counts()}


def job_pod_recipe(mesh, map_per_host, source, target, T_init, cfg):
    """The multi-process recipe: initialize_distributed (idempotent here),
    make_pod_mesh, process_local_slice, host_local_batch, the batch-sharded
    solve; this rank's rows of the result, and an explicit all-reduce over
    the batch axis."""
    import torch
    import torch.distributed as dist

    from dicp_tpu_torch.parallel import _comm, register_batch_sharded
    from dicp_tpu_torch.parallel.multihost import (host_local_batch, initialize_distributed,
                                                   make_pod_mesh, process_local_slice)
    from dicp_tpu_torch.parallel.sharding import _axis

    distributed = initialize_distributed(device="cpu")
    pod = make_pod_mesh(map_per_host=map_per_host, devices="cpu")
    B = source.shape[0]
    sl = process_local_slice(B)
    src, tgt, ti = host_local_batch(pod, source[sl], target[sl], T_init[sl])
    res = register_batch_sharded(pod, src, tgt, ti, cfg=cfg)
    solve_counts = _counts()
    group, rank, size = _axis(pod, "batch")
    per = B // size
    local = torch.ones((B // size,), dtype=torch.float32)
    total = float(_comm.psum(torch.sum(local), group))
    return {"distributed": distributed, "world": dist.get_world_size(),
            "shape": tuple(pod.shape), "names": pod.mesh_dim_names, "slice": (sl.start, sl.stop),
            "global_shape": tuple(src.shape), "rows": list(range(rank * per, (rank + 1) * per)),
            "T": _np(res.T), "converged": _np(res.converged), "solve_counts": solve_counts,
            "psum": total}


JOBS = {name[4:]: fn for name, fn in globals().items() if name.startswith("job_")}


def _rank_main() -> None:
    results = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)            # stray prints go to the rank's log, not the results
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from dicp_tpu_torch.parallel import _comm, make_mesh
    from dicp_tpu_torch.parallel.multihost import initialize_distributed

    if not initialize_distributed(device="cpu"):
        raise RuntimeError("the test world resolved to one process")
    meshes = {}
    jobs = sys.stdin.buffer
    while True:
        try:
            job = pickle.load(jobs)
        except EOFError:
            break
        if job is None:
            break
        name, shape, kwargs = job
        try:
            mesh = None
            if shape is not None:
                if shape not in meshes:
                    meshes[shape] = make_mesh(shape, devices="cpu")
                mesh = meshes[shape]
            _comm.reset_counts()
            msg = ("ok", JOBS[name](mesh, **kwargs))
        except Exception:  # reported to the test, which fails with it
            msg = ("error", traceback.format_exc())
        pickle.dump(msg, results)
        results.flush()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main()
