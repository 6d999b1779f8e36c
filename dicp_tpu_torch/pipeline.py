"""Streaming odometry serving pipeline: the counterpart of
``dicp_tpu/pipeline.py``.

Scans arrive as host numpy arrays (e.g. from :class:`dicp_tpu_torch.io.ScanDataset`),
are registered window by window on the device, and the relative transforms
are composed into a trajectory.

* **One transfer per scan.**  Every host array of a scan (points, weights;
  or the packed quantized coordinates, int8 normals and the dequantisation
  constants) is packed into one pinned host buffer and crosses to the card
  in one ``non_blocking`` copy on a copy stream; the compute stream waits
  on that copy's event.  A scan's device tensor is reused as the target of
  the next pair.  The pinned buffers form a ring of ``window + 2``, and a
  buffer is refilled only after its previous copy's event has completed:
  refilling it earlier would corrupt a scan still in flight.
* **Windowed solves.**  K consecutive pairs are solved in one batched
  solve, :func:`_window_solve`: the stack (and the dequantisation), the
  solve and its early exit are one captured program on the card
  (:func:`dicp_tpu_torch.jit.jit`, whose loop is a CUDA graph WHILE node),
  as JAX jits all three.  A ragged tail is padded by repeating the last
  scan and sliced off.
* **Warm start.**  The seed of the next window is the last solved relative
  transform, kept as a device tensor; the next replay's static input takes
  it by an on-stream copy.

As in JAX, windows stay in flight: a replay is enqueued without a host
wait, so the host reads and uploads the next window's scans while the card
solves this one.  The feed loop's only waits are the upload ring's, before
a pinned buffer is refilled, and the caller's own fetches.  Per-pair
results equal those of one batched solve (the solver's batch == serial
invariant).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dicp_tpu_torch.api import _resolve_device
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.jit import jit
from dicp_tpu_torch.odometry import OdometryResult, compose_chain
from dicp_tpu_torch.registration import _register_program

_ALIGN = 16  # bytes: every array of a packed scan starts on this boundary
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _view_dtype(dt: np.dtype) -> torch.dtype:
    # uint16 is viewed as int16 (PyTorch has almost no uint16 arithmetic);
    # dequantize_scan widens it back to its unsigned value
    if dt == np.uint16:
        return torch.int16
    return torch.from_numpy(np.empty((0,), dt)).dtype


class _Uploader:
    """Packs the host arrays of one scan into one buffer and moves it to
    ``device`` in one copy; returns a tensor view of each array there.

    On the card the buffers are pinned and the copies run on their own
    stream, ring of ``slots`` buffers with an event each; on the CPU the
    packed buffer is the result."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.ring: List[list] = [[None, None] for _ in range(slots)]
        self.turn = 0
        if device.type == "cuda":
            self.compute = torch.cuda.current_stream(device)
            self.copy = torch.cuda.Stream(device)

    def __call__(self, arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
        arrays = [np.ascontiguousarray(a) for a in arrays]
        offsets, total = [], 0
        for a in arrays:
            offsets.append(total)
            total += -(-a.nbytes // _ALIGN) * _ALIGN
        if self.device.type == "cuda":
            packed = self._to_card(arrays, offsets, total)
        else:
            packed = torch.empty((total,), dtype=torch.uint8)
            self._fill(packed.numpy(), arrays, offsets)
        return [packed[o:o + a.nbytes].view(_view_dtype(a.dtype)).view(a.shape)
                for a, o in zip(arrays, offsets)]

    @staticmethod
    def _fill(buf: np.ndarray, arrays, offsets) -> None:
        for a, o in zip(arrays, offsets):
            buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)

    def _to_card(self, arrays, offsets, total: int) -> torch.Tensor:
        slot = self.ring[self.turn % len(self.ring)]
        self.turn += 1
        host, event = slot
        if event is not None:
            event.synchronize()  # its last copy has left the buffer
        if host is None or host.numel() < total:
            host = torch.empty((total,), dtype=torch.uint8, pin_memory=True)
        self._fill(host.numpy(), arrays, offsets)
        event = torch.cuda.Event()
        with torch.cuda.stream(self.copy):
            dev = host[:total].to(self.device, non_blocking=True)
            event.record(self.copy)
        self.compute.wait_event(event)
        # allocated on the copy stream, read on the compute stream
        dev.record_stream(self.compute)
        slot[0], slot[1] = host, event
        return dev


def _window_program(scans: Tuple[torch.Tensor, ...],
                    weights: Optional[Tuple[torch.Tensor, ...]],
                    t_init: torch.Tensor, cfg: ICPConfig, n_pairs: int,
                    deq: Optional[Tuple[torch.Tensor, ...]] = None):
    """Solve the n_pairs consecutive pairs of a (n_pairs+1)-scan window in
    one batched solve.  ``t_init`` (4, 4) seeds every pair of the window.
    With ``deq``, each scan is a tuple of packed quantized arrays and
    ``deq`` holds its (3, 3) [lo; step; tile] (:func:`dequantize_scan`)."""
    if deq is not None:
        pts = torch.stack([dequantize_scan(qt, d) for qt, d in zip(scans, deq)])
    else:
        pts = torch.stack(scans)                                  # (K+1, n, c)
    w = None if weights is None else torch.stack(weights[1:])     # (K, n)
    src = pts[1:, :, :3]
    tgt = pts[:-1]
    ti = t_init.to(pts.dtype).expand(n_pairs, 4, 4)
    res = _register_program(src, tgt, ti, w, cfg)
    return res.T, res.converged, res.iterations


# one captured program per (window, scan shape, quantize, cfg), as JAX jits
# the window solve
_window_solve = jit(_window_program, static_argnames=("cfg", "n_pairs"),
                    name="window_solve")


def stream_registrations(
    scans: Iterable[Tuple[np.ndarray, Optional[np.ndarray]]],
    cfg: ICPConfig = ICPConfig(),
    window: int = 8,
    warm_start: bool = True,
    quantize: bool = False,
    device=None,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Register consecutive scan pairs from a stream, window at a time.

    ``scans`` yields (points (n, c), weight (n,) or None) numpy pairs (e.g. a
    :class:`dicp_tpu_torch.io.ScanDataset`); every scan must share one
    shape, and either every scan or none has weights.  Yields (rel_T
    (k, 4, 4), converged (k,), iterations (k,)) device tensors per window.
    ``device`` defaults to the card; ``"cpu"`` runs on the CPU.

    ``warm_start`` (the constant-velocity prior): seed each window with the
    latest solved relative transform instead of the identity.

    A ragged tail (< window pairs) is padded by repeating the last scan;
    pad pairs are self-registrations and are sliced off before yielding.

    ``quantize``: each scan ships as fixed-point coordinates relative to its
    own bounding box, a 16x16 xy tile id plus uint16 in-tile coordinates
    packed into one (n, 4) uint16 array (8 bytes per point instead of 12),
    int8 normals for 6-column scans, and a (3, 3) f32 [lo; step; tile]
    (:func:`_quantize_host`, run in a prefetch thread), dequantised on the
    device before the solve.  Weightless streams (``weight=None``) skip the
    weight transfer; the caller then replaces zero-row pads by real rows,
    since pads at the origin act as real points.
    """
    device = _resolve_device(device)
    upload = _Uploader(device, slots=window + 2)
    dev_scans: List = []
    dev_w: List[torch.Tensor] = []
    dev_deq: List[torch.Tensor] = []
    t_seed = torch.eye(4, dtype=torch.float32, device=device)
    no_w = None

    def flush():
        nonlocal t_seed
        k = len(dev_scans) - 1
        pad = window - k
        s = tuple(dev_scans) + (dev_scans[-1],) * pad
        w = None if no_w else tuple(dev_w) + (dev_w[-1],) * pad
        dq = (tuple(dev_deq) + (dev_deq[-1],) * pad) if quantize else None
        T, conv, iters = _window_solve(s, w, t_seed, cfg, window, dq)
        if warm_start:
            t_seed = T[k - 1]   # stays on the device
        return T[:k], conv[:k], iters[:k]

    def prep(item):
        """Per-scan host work (the quantize math runs here, in the prefetch
        thread, overlapped with the solves)."""
        pts_np, w_np = item
        if not quantize:
            return (pts_np,), None, w_np
        return _quantize_host(pts_np) + (w_np,)

    items = map(prep, iter(scans))
    if quantize:
        items = _prefetched(items, depth=3)

    for parts_np, deq_np, w_np in items:
        if no_w is None:
            no_w = w_np is None
        elif no_w != (w_np is None):
            raise ValueError("all scans must consistently have or omit weights")
        arrays = list(parts_np) + ([] if deq_np is None else [deq_np])
        views = upload(arrays + ([] if no_w else [w_np]))
        if quantize:
            dev_scans.append(tuple(views[:len(parts_np)]))
            dev_deq.append(views[len(parts_np)])
        else:
            dev_scans.append(views[0])
        if not no_w:
            dev_w.append(views[-1])
        if len(dev_scans) == window + 1:
            out = flush()
            # the last scan seeds the next window (target of its first pair)
            dev_scans = dev_scans[-1:]
            dev_w = dev_w[-1:]
            dev_deq = dev_deq[-1:]
            yield out
    if len(dev_scans) >= 2:
        yield flush()


def dequantize_scan(qt: Tuple[torch.Tensor, ...], d: torch.Tensor) -> torch.Tensor:
    """Device side of the quantized transfer.  ``qt`` = ((n, 4) uint16 [qx qy
    qz tile-id], or the same bits as int16 [, (n, 3) int8 normals]); ``d`` =
    (3, 3) f32 [lo; step; tile] from :func:`_quantize_host`.  Returns (n, 3)
    or (n, 6) f32 points.

    The bits are those of JAX's pipeline on the CPU, which runs this inside
    its jitted window solve, where XLA fuses the expression and contracts
    its multiply-adds: the coordinates are fma(tile_id, tile, fma(q, step,
    lo)), the normals the int8 values times the f32 reciprocal of 127 (XLA's
    rewrite of the division) over sqrt(fma(n2, n2, fma(n1, n1, n0 * n0))).
    Each fused multiply-add is evaluated by :func:`_fma`."""
    arr = qt[0].to(torch.int32) & 0xFFFF   # widened: the unsigned 16-bit value
    q, tid = arr[:, :3].to(torch.float32), arr[:, 3]
    zero = torch.zeros_like(tid, dtype=torch.float32)
    tiles = torch.stack([(tid >> 4).to(torch.float32), (tid & 15).to(torch.float32), zero],
                        dim=-1)
    tile = torch.stack([d[2, 0], d[2, 1], torch.zeros_like(d[2, 0])])
    xyz = _fma(tiles, tile, _fma(q, d[1], d[0]))
    if len(qt) == 2:        # int8 normals (6-column scans)
        nrm = qt[1].to(torch.float32) * _INV_127
        sq = _fma(nrm[:, 2], nrm[:, 2], _fma(nrm[:, 1], nrm[:, 1], nrm[:, 0] * nrm[:, 0]))
        norm = torch.sqrt(sq.to(torch.float64)).to(torch.float32)[:, None]
        return torch.cat([xyz, nrm / torch.clamp(norm, min=1e-6)], dim=-1)
    return xyz


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of f32 tensors, rounded once to f32 like a fused
    multiply-add, for any finite operands.  The product of two f32 values is
    exact in f64.  The f64 sum is rounded to odd (its rounding error, from
    TwoSum, moves an even last bit one step toward the exact sum), and an
    f64 value rounded to odd rounds to f32 as the exact sum would: 53 bits
    leave the two guard bits that this needs.  (The f64 square root of an
    f32 value likewise rounds to the correctly rounded f32 one.)"""
    p, c = a.to(torch.float64) * b.to(torch.float64), c.to(torch.float64)
    s = p + c
    v = s - c
    err = (p - v) + (c - (s - v))          # TwoSum: s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where(even & (err != 0) & torch.isfinite(s), torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _quantize_host(pts_np: np.ndarray):
    """Host side of the quantized transfer: ((q uint16 (n, 4)[, n int8]),
    deq (3, 3) f32); see :func:`stream_registrations` ``quantize``."""
    full = np.asarray(pts_np, np.float32)
    xyz = full[:, :3]
    lo = xyz.min(axis=0)
    ext = np.maximum(xyz.max(axis=0) - lo, 1e-9)
    tile = np.array([ext[0] / 16.0, ext[1] / 16.0, 0.0], np.float32)
    tx = np.clip((xyz[:, 0] - lo[0]) // tile[0], 0, 15)
    ty = np.clip((xyz[:, 1] - lo[1]) // tile[1], 0, 15)
    tid = (tx.astype(np.uint8) << 4) | ty.astype(np.uint8)
    step = np.array([tile[0] / 65535.0, tile[1] / 65535.0,
                     ext[2] / 65535.0], np.float32)
    rel = xyz - lo
    rel[:, 0] -= tx * tile[0]
    rel[:, 1] -= ty * tile[1]
    q = np.clip(np.rint(rel / step), 0, 65535).astype(np.uint16)
    arr = np.concatenate([q, tid[:, None].astype(np.uint16)], axis=1)
    parts = [arr]
    if full.shape[1] >= 6:       # normals ride as int8 (0.45 deg step)
        parts.append(np.clip(np.rint(full[:, 3:6] * 127.0),
                             -127, 127).astype(np.int8))
    return tuple(parts), np.stack([lo, step, tile]).astype(np.float32)


def _prefetched(it, depth: int = 3):
    """Run an iterator in a daemon thread with a bounded queue (numpy
    releases the GIL on array math, so host prep overlaps the solves)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def feed():
        try:
            for x in it:
                q.put(x)
            q.put(_END)
        except BaseException as e:   # surface errors in the consumer
            q.put(e)

    threading.Thread(target=feed, daemon=True).start()
    while True:
        x = q.get()
        if x is _END:
            return
        if isinstance(x, BaseException):
            raise x
        yield x


def stream_odometry(
    scans: Iterable[Tuple[np.ndarray, Optional[np.ndarray]]],
    cfg: ICPConfig = ICPConfig(),
    window: int = 8,
    warm_start: bool = True,
    quantize: bool = False,
    device=None,
) -> OdometryResult:
    """Run the streaming pipeline to completion and compose the trajectory
    (device tensors; nothing is fetched to the host here)."""
    rels, convs, iters = [], [], []
    for T, c, it in stream_registrations(scans, cfg, window, warm_start, quantize,
                                         device):
        rels.append(T)
        convs.append(c)
        iters.append(it)
    if not rels:
        raise ValueError("stream_odometry needs at least two scans")
    rel = torch.cat(rels)
    return OdometryResult(poses=compose_chain(rel), rel_transforms=rel,
                          converged=torch.cat(convs), iterations=torch.cat(iters))
