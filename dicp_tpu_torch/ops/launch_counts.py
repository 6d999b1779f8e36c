"""Launch counts of the hand-written kernels inside captured CUDA graphs.

Each kernel wrapper counts its launches where it launches them.  A launch
that runs at once is counted on the host, in the wrapper's plain integer
(``tiled_knn.launches``, ``fused_gn.launches``, ``fused_search.launches``
etc.).  A launch made while its stream is being captured runs only when
the graph is replayed: once per replay, or once per iteration that a
device loop's body really runs.  There the wrapper calls :func:`count`,
which enqueues one add to the kernel's int64 counter on the card right
beside the launch: the add is captured with the launch and runs exactly as
often as it does.  A kernel's launches are its wrapper's host count plus
:func:`read` of its name.

The counters are made outside any capture by :func:`prepare`, which
:mod:`dicp_tpu_torch.jit` calls before it captures a program.

Other launches counted by a key (``parallel._comm``'s collectives, keyed
by (kind, group size, elements)) use :func:`count_keyed`: under capture a
key takes a slot of a bank of ``SLOTS`` int64 counters per device, made by
:func:`prepare` too, and :func:`read_keyed` returns the captured counts by
key.
"""

from __future__ import annotations

import torch

KERNELS = ("tiled_nn", "fused_gn", "cluster_search", "cluster_block_search", "cluster_topk",
           "threefry_uniform", "threefry_randint")

SLOTS = 256            # keyed counters per device

_counters: dict = {}   # (kernel, device index) -> 0-dim int64 tensor on that device
_banks: dict = {}      # device index -> (SLOTS,) int64 tensor on that device
_slots: dict = {}      # (device index, key) -> slot in that device's bank


def prepare(device: torch.device) -> None:
    """Make every kernel's counter and the keyed bank on ``device``
    (outside a capture)."""
    for name in KERNELS:
        if (name, device.index) not in _counters:
            _counters[name, device.index] = torch.zeros((), dtype=torch.int64, device=device)
    if device.index not in _banks:
        _banks[device.index] = torch.zeros((SLOTS,), dtype=torch.int64, device=device)


def count(name: str, device: torch.device) -> int:
    """One launch of kernel ``name`` on ``device``'s current stream.  Returns
    1, the wrapper's host increment, where the stream runs the launch at
    once; under capture enqueues +1 on the kernel's device counter and
    returns 0."""
    if not torch.cuda.is_current_stream_capturing():
        return 1
    counter = _counters.get((name, device.index))
    if counter is None:
        raise RuntimeError(f"{name} launched under a capture without a launch counter: "
                           f"call launch_counts.prepare(device) before capturing")
    counter.add_(1)
    return 0


def count_keyed(key: tuple, device: torch.device) -> int:
    """:func:`count` for a launch counted by ``key``: returns 1 where the
    stream runs it at once; under capture enqueues +1 on the key's slot of
    ``device``'s bank and returns 0."""
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        return 1
    bank = _banks.get(device.index)
    if bank is None:
        raise RuntimeError(f"{key} launched under a capture without a counter bank: call "
                           f"launch_counts.prepare(device) before capturing")
    slot = _slots.setdefault((device.index, key),
                             sum(index == device.index for index, _ in _slots))
    if slot >= SLOTS:
        raise RuntimeError(f"more than {SLOTS} keys counted under capture")
    bank.narrow(0, slot, 1).add_(1)
    return 0


def read_keyed() -> dict:
    """Captured launches run since the last :func:`reset` or
    :func:`reset_keyed`, by key, summed over devices (a host wait)."""
    out: dict = {}
    for (index, key), slot in _slots.items():
        n = int(_banks[index][slot])
        if n:
            out[key] = out.get(key, 0) + n
    return out


def reset_keyed() -> None:
    for bank in _banks.values():
        bank.zero_()


def read(name: str) -> int:
    """Captured launches of kernel ``name`` run since the last :func:`reset`,
    over every device (a host wait)."""
    return sum(int(c) for (k, _), c in _counters.items() if k == name)


def reset() -> None:
    for c in _counters.values():
        c.zero_()
    reset_keyed()
