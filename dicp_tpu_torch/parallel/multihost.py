"""Multi-process execution: initialization, host-aware meshes and host-local
data placement; the counterpart of ``dicp_tpu/parallel/multihost.py``.

Every process drives one device.  The design rule is JAX's: the **batch**
axis spans hosts (the batch-parallel solve needs no collective, so the
slower network between hosts does not matter) and the **map** axis stays
within a host, where the per-step all-reduce of the normal equations and the
ring's shifts ride the fast links between the host's cards.

Launch recipe: ``torchrun --nnodes=H --nproc-per-node=K prog.py`` on every
host, and in the program ``initialize_distributed()`` (from torchrun's
environment) then ``make_pod_mesh()``.  Everything here works unchanged in
one process: initialization returns False and the mesh is a world of one.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dicp_tpu_torch.parallel.sharding import _axis, _device, make_mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device=None,
) -> bool:
    """Join this process to the job's default process group; returns True
    if distributed.

    Arguments left out come from torchrun's environment:
    ``coordinator_address`` ("host:port") from ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``num_processes`` from ``WORLD_SIZE``, ``process_id``
    from ``RANK``, and the card (``local_device_ids[0]``) from
    ``LOCAL_RANK``.  ``device``: None (the card, NCCL) or ``"cpu"`` (gloo).

    Returns False and initializes nothing when the job resolves to one
    process.  Idempotent: once a group exists, a second call only reports."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if num_processes is None or num_processes == 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(f"a job of {num_processes} processes needs the coordinator's "
                         "address and this process's id (MASTER_ADDR/MASTER_PORT and RANK)")
    device_type = "cuda" if device is None else torch.device(device).type
    if device_type == "cuda":
        local = (local_device_ids[0] if local_device_ids
                 else int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def _hosts() -> Tuple[int, int, int]:
    """(processes per host, hosts, this process's host) of the job, from
    torchrun's ``LOCAL_WORLD_SIZE`` (default: one host)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"{world} processes do not fill hosts of {per_host}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return per_host, world // per_host, rank // per_host


def make_pod_mesh(
    map_per_host: Optional[int] = None,
    axis_names: Tuple[str, str] = ("batch", "map"),
    devices=None,
) -> DeviceMesh:
    """Host-aware 2-D mesh: ``batch`` across hosts, ``map`` within a host.

    ``map_per_host``: a host's processes on the map axis (default: all of
    them when there are several hosts, else 1).  It must divide the host's
    process count; the remainder multiplies into the batch axis.  Ranks are
    numbered host by host, so each row of the mesh lies within one host.
    ``devices`` as for :func:`sharding.make_mesh` (one process and no group
    yet: a world of one on that device)."""
    n_local, n_hosts, _ = _hosts()
    if map_per_host is None:
        map_per_host = n_local if n_hosts > 1 else 1
    if n_local % map_per_host != 0:
        raise ValueError(f"map_per_host={map_per_host} does not divide the "
                         f"host's process count {n_local}")
    return make_mesh((n_hosts * (n_local // map_per_host), map_per_host), axis_names,
                     devices)


def host_local_batch(mesh: DeviceMesh, *arrays, axis: str = "batch"):
    """Global batch arrays from this HOST's slice of the batch
    (:func:`process_local_slice`): the counterpart of JAX's arrays assembled
    from process-local data.  The global batch is ``local batch * hosts``;
    this host's rows are filled and the others are zero, and no rank reads
    them, because the ``axis`` rows that a rank takes lie within its host's
    slice.  Local slices must have equal shapes on every host."""
    _, n_hosts, host = _hosts()
    _, _, size = _axis(mesh, axis)
    if size % n_hosts:
        raise ValueError(f"mesh axis {axis} of {size} does not span {n_hosts} hosts evenly")
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        full = a.new_zeros((a.shape[0] * n_hosts,) + tuple(a.shape[1:]))
        full[host * a.shape[0]:(host + 1) * a.shape[0]] = a
        out.append(full.to(_device(mesh)))
    return tuple(out)


def process_local_slice(n_global: int) -> slice:
    """The [start, stop) slice of a global batch this process's host should
    load (equal contiguous blocks by host)."""
    _, n_hosts, host = _hosts()
    per = n_global // n_hosts
    if per * n_hosts != n_global:
        raise ValueError(f"global batch {n_global} not divisible by {n_hosts} hosts")
    return slice(host * per, (host + 1) * per)
