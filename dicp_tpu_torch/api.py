"""Drop-in user API: the ``ICP`` class and ragged-input batch handling, the
counterpart of ``dicp_tpu/api.py``.

Semantics reproduced from the JAX package:

* ragged sources zero-padded with zero weights;
* ragged targets padded by repeating the cloud's last row, so a hard-NN
  pad never changes a result; with soft NN (Gumbel) by a far sentinel,
  ``(max |source| + 1) * target_pad_val``, whose softmax mass is ~0 where a
  repeated row would get a real share;
* empty/None clouds become phony single-point clouds with zero weight, which
  makes every Gauss-Newton step a no-op and returns ``T_init``;
* optional per-point prior weights, lists allowed, None meaning ones.

Devices: tensors keep the device they are on, and tensors on different
devices raise.  Numpy arrays and lists go to the device of the tensor inputs
if there are any, else to the ``ICP(device=...)`` device.  That defaults to
the card (``cuda``): without a CUDA device a call with only numpy or list
inputs raises, and CPU use asks for it with ``device="cpu"``.
Padding is built with differentiable ops, so gradients reach every original
list element.
"""

from __future__ import annotations

import numpy as np
import torch

from dicp_tpu_torch.config import ICPConfig, config_from_yaml, load_yaml_config
from dicp_tpu_torch.registration import ICPResult, register, slice_histories


def _is_empty(x) -> bool:
    return x is None or (hasattr(x, "__len__") and len(x) == 0)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from _tensors(item)


def _resolve_device(requested, *inputs) -> torch.device:
    """The one device of the tensor inputs, else ``requested`` (default the
    card; without a CUDA device that raises: there is no CPU continuation)."""
    found = {t.device for t in _tensors(inputs)}
    if len(found) > 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, found))}")
    if not found:
        if requested is not None:
            return torch.device(requested)
        if not torch.cuda.is_available():
            raise RuntimeError("dicp_tpu_torch runs numpy and list inputs on the card "
                               "by default, and no CUDA device is available: pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    (device,) = found
    if requested is not None:
        want = torch.device(requested)
        if want.type != device.type or want.index not in (None, device.index):
            raise ValueError(f"inputs lie on {device} but the solver was asked "
                             f"for {want}")
    return device


def _dtype_of(x) -> torch.dtype:
    return x.dtype if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x)).dtype


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    """Tensors keep their device (cast to ``dtype``); the rest go to ``device``."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _result_dtype(target_list) -> torch.dtype:
    for t in target_list:
        if not _is_empty(t):
            return _dtype_of(t)
    return torch.float32


def batch_size_handling(source, target, T_init=None, weight=None,
                        target_pad_val: float = 1000.0, keep_source_normals: bool = False,
                        soft_nn: bool = False, device=None):
    """Normalize (possibly ragged) inputs to dense batched tensors.

    Returns (source (N, n, 3|6), target (N, m, 3|6), T_init (N, 4, 4) or
    None, weight (N, n)), all on one device (see the module docstring).  The
    weight is not pt2pt-expanded here; the functional core does that.
    ``keep_source_normals`` keeps 6-column sources (symmetric ICP);
    ``soft_nn`` pads ragged targets with the far sentinel scaled by
    ``target_pad_val`` instead of repeated rows.  The positional order is the
    JAX package's; ``device`` (see the module docstring) comes last."""
    device = _resolve_device(device, source, target, T_init, weight)
    src_cols = 6 if keep_source_normals else 3
    # phony path: entire source or target missing -> T_init unchanged
    if _is_empty(source) or _is_empty(target):
        dt = torch.float32
        if T_init is None:
            ti = torch.eye(4, dtype=dt, device=device)[None]
        else:
            ti = _normalize_T(T_init, dt, device)
        # phony clouds sized to the T_init batch, so a batched T_init passes
        N = ti.shape[0]
        src = torch.zeros((N, 1, src_cols), dtype=dt, device=device)
        tgt = torch.zeros((N, 1, 6), dtype=dt, device=device)
        w = torch.zeros((N, 1), dtype=dt, device=device)
        return src, tgt, ti, w

    # mixed list/dense inputs: lift the dense side to a list
    is_list_src = isinstance(source, (list, tuple))
    is_list_tgt = isinstance(target, (list, tuple))
    if is_list_src != is_list_tgt:
        if is_list_src:
            t = _as_tensor(target, device)
            if t.dim() == 2:
                target = [t] * len(source)          # one shared target cloud
            elif t.dim() == 3:
                target = [t[i] for i in range(t.shape[0])]
            else:
                raise ValueError("target must be (m x 3/6) or (N x m x 3/6) or list")
        else:
            s = _as_tensor(source, device)
            if s.dim() == 2:
                source = [s] * len(target)          # one shared source cloud
                if weight is not None and _as_tensor(weight, device).dim() == 1:
                    weight = [weight] * len(target)
            elif s.dim() == 3:
                source = [s[i] for i in range(s.shape[0])]
                if weight is not None and _as_tensor(weight, device).dim() == 2:
                    weight = [weight[i] for i in range(len(source))]
            else:
                raise ValueError("source must be (n x 3/6) or (N x n x 3/6) or list")

    is_list = isinstance(source, (list, tuple))
    # batch lengths agree, or fail here with a clear message
    if is_list and len(source) != len(target):
        raise ValueError(
            f"source and target batch lengths disagree: {len(source)} source "
            f"clouds vs {len(target)} target clouds")
    if weight is not None:
        if is_list:
            if len(source) != len(weight):
                raise ValueError(f"weight batch length {len(weight)} != source "
                                 f"batch length {len(source)}")
        else:
            n_w = _as_tensor(weight, device).shape[0]
            n_s = _as_tensor(source, device).shape[0]
            if n_s != n_w:
                raise ValueError(f"weight has {n_w} rows but source has {n_s}")

    if is_list:
        dt = _result_dtype(target)
        n_max = max(max((len(s) if not _is_empty(s) else 1) for s in source), 1)
        src_rows, w_rows = [], []
        for i, s in enumerate(source):
            if _is_empty(s):
                src_rows.append(torch.zeros((n_max, src_cols), dtype=dt, device=device))
                w_rows.append(torch.zeros((n_max,), dtype=dt, device=device))
                continue
            s = _as_tensor(s, device, dt)
            if s.dim() != 2 or s.shape[1] not in (3, 6):
                raise ValueError("source list must contain (n x 3/6) tensors")
            if keep_source_normals and s.shape[1] != 6:
                raise ValueError("symmetric ICP requires 6-column sources "
                                 "(coordinates + normals); got shape "
                                 f"{tuple(s.shape)}")
            ni = s.shape[0]
            src_rows.append(torch.cat(
                [s[:, :src_cols], s.new_zeros((n_max - ni, src_cols))], dim=0))
            if weight is not None and weight[i] is not None:
                wi = _as_tensor(weight[i], device, dt)
                if wi.shape[0] != ni:
                    raise ValueError(
                        f"weight[{i}] has {wi.shape[0]} rows but source[{i}] "
                        f"has {ni}: per-cloud weights must align row-wise")
            else:
                wi = torch.ones((ni,), dtype=dt, device=device)
            w_rows.append(torch.cat([wi, wi.new_zeros((n_max - ni,))]))
        src = torch.stack(src_rows)
        w = torch.stack(w_rows)

        tgt_dim = next((_as_tensor(t, device).shape[1] for t in target
                        if not _is_empty(t)), 6)
        m_max = max(max((len(t) if not _is_empty(t) else 1) for t in target), 1)
        # the soft-NN sentinel, far outside every cloud even where all
        # coordinates are <= 0
        pad_val = (torch.max(torch.abs(src)) + 1.0) * target_pad_val if soft_nn else None
        tgt_rows, empty_rows = [], []
        for i, t in enumerate(target):
            if _is_empty(t):
                tgt_rows.append(torch.zeros((m_max, tgt_dim), dtype=dt, device=device))
                empty_rows.append(i)
                continue
            t = _as_tensor(t, device, dt)
            if t.dim() != 2 or t.shape[1] != tgt_dim:
                raise ValueError("target list must contain (m x 3/6) tensors with a "
                                 "consistent number of columns")
            if soft_nn:
                pad = pad_val * t.new_ones((m_max - t.shape[0], tgt_dim))
            else:
                pad = t[-1:].expand(m_max - t.shape[0], tgt_dim)
            tgt_rows.append(torch.cat([t, pad], dim=0))
        tgt = torch.stack(tgt_rows)
        if empty_rows:
            keep = torch.ones(len(target), dtype=torch.bool, device=device)
            keep[empty_rows] = False
            w = torch.where(keep[:, None], w, torch.zeros_like(w))
    else:
        s = _as_tensor(source, device)
        dt = s.dtype
        if keep_source_normals and s.shape[-1] != 6:
            raise ValueError("symmetric ICP requires 6-column sources "
                             "(coordinates + normals); got shape "
                             f"{tuple(s.shape)}")
        if s.dim() == 2 and s.shape[1] in (3, 6):
            src = s[None, :, :src_cols]
        elif s.dim() == 3 and s.shape[2] in (3, 6):
            src = s[:, :, :src_cols]
        else:
            raise ValueError("source must be (n x 3/6) or (N x n x 3/6) or list len(N)")
        if weight is None:
            w = torch.ones(src.shape[:2], dtype=dt, device=device)
        else:
            w = _as_tensor(weight, device, dt)
            if w.dim() == 1:
                w = w[None]

        t = _as_tensor(target, device, dt)
        if t.dim() == 2 and t.shape[1] in (3, 6):
            tgt = t[None]
        elif t.dim() == 3 and t.shape[2] in (3, 6):
            tgt = t
        else:
            raise ValueError("target must be (m x 3/6) or (N x m x 3/6) or list len(N)")
        if tgt.shape[0] != src.shape[0]:
            tgt = tgt.expand((src.shape[0],) + tgt.shape[1:])

    ti = None if T_init is None else _normalize_T(T_init, dt, device)
    return src, tgt, ti, w


def _normalize_T(T_init, dtype, device) -> torch.Tensor:
    """T_init to (N, 4, 4)."""
    if isinstance(T_init, (list, tuple)):
        return torch.stack([_as_tensor(t, device, dtype) for t in T_init])
    t = _as_tensor(T_init, device, dtype)
    if t.shape == (4, 4):
        return t[None]
    if t.dim() == 3 and t.shape[1:] == (4, 4):
        return t
    raise ValueError("T_init must be (4 x 4) or (N x 4 x 4) or list len(N) (4 x 4)")


class ICP:
    """Drop-in equivalent of the reference ICP class.

    Constructor signature and YAML schema match; ``icp()`` returns the
    results-dict contract (keys pc/T/costs/deltas/weights/stats) with torch
    tensors, histories sliced to the executed iteration count.  Autograd
    reaches the inputs through the returned ``T`` and ``pc``.
    """

    def __init__(self, config_path=None, icp_type="pt2pl", max_iterations=100,
                 tolerance=1e-12, differentiable=True, device=None, **solver_kwargs):
        """``device``: where numpy/list inputs go when no tensor input fixes
        it (default the card, ``cuda``; ``"cpu"`` for the CPU).
        ``solver_kwargs``: :class:`ICPConfig` fields with no reference
        counterpart (e.g. ``nn_method``, ``batch_chunk``,
        ``collect_histories``)."""
        self.device = device
        self._base_cfg = config_from_yaml(
            config_path, icp_type=icp_type, max_iterations=max_iterations,
            tolerance=tolerance, differentiable=differentiable).with_(**solver_kwargs)
        self.config = load_yaml_config(config_path)  # raw-dict attribute parity
        # mutable attributes for reference-style attribute pokes
        self.icp_type = icp_type
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.diff = differentiable
        self.const_iter = self._base_cfg.const_iter
        self.verbose = self._base_cfg.verbose
        self.target_pad_val = self._base_cfg.target_pad_val
        self.source_zeroes_are_pad = self._base_cfg.source_zeroes_are_pad
        self.match_ratio_thresh = self._base_cfg.match_ratio_thresh
        self.use_gumbel = self._base_cfg.use_gumbel
        self.gumbel_eps = self._base_cfg.gumbel_eps
        self.gumbel_tau = self._base_cfg.gumbel_tau
        from dicp_tpu_torch.nn import nn as _nn_cls

        self.nn = _nn_cls(differentiable=differentiable, use_gumbel=self.use_gumbel,
                          eps=self.gumbel_eps, tau=self.gumbel_tau)

    def _call_cfg(self, trim_dist, loss_fn, dim) -> ICPConfig:
        # a poke of icp.nn.use_gumbel/eps/tau changes the solve, as in the reference
        nn = getattr(self, "nn", None)
        return self._base_cfg.with_(
            icp_type=self.icp_type,
            max_iterations=self.max_iterations,
            tolerance=self.tolerance,
            differentiable=self.diff,
            const_iter=self.const_iter,
            verbose=self.verbose,
            target_pad_val=float(self.target_pad_val),
            source_zeroes_are_pad=self.source_zeroes_are_pad,
            match_ratio_thresh=self.match_ratio_thresh,
            use_gumbel=getattr(nn, "use_gumbel", self.use_gumbel),
            gumbel_eps=float(getattr(nn, "eps", self.gumbel_eps)),
            gumbel_tau=float(getattr(nn, "tau", self.gumbel_tau)),
            dim=dim,
            trim_dist=None if trim_dist is None else float(trim_dist),
            loss_name=None if loss_fn is None else loss_fn["name"],
            loss_metric=1.0 if loss_fn is None else float(loss_fn["metric"]),
        )

    def icp(self, source, target, T_init, weight=None, trim_dist=None,
            loss_fn=None, dim=3, key=None):
        return self.dICP(source, target, T_init, weight, trim_dist, loss_fn, dim, key)

    def dICP(self, source, target, T_init, weight=None, trim_dist=None,
             loss_fn=None, dim=3, key=None):
        """Main entry point.  ``icp_type='symmetric'`` requires 6-column
        sources.  ``key``: the Gumbel noise source (an int seed, a
        ``torch.Generator`` or an object with a ``uniform`` method; see
        :func:`dicp_tpu_torch.knn.gumbel_noise`), required with Gumbel NN."""
        if dim not in (2, 3):
            raise ValueError("dim must be 2 or 3")
        cfg = self._call_cfg(trim_dist, loss_fn, dim)
        src, tgt, ti, w = batch_size_handling(
            source, target, T_init, weight,
            keep_source_normals=(self.icp_type == "symmetric"), device=self.device,
            target_pad_val=cfg.target_pad_val,
            soft_nn=(cfg.differentiable and cfg.use_gumbel))
        N = src.shape[0]
        if ti is None:
            ti = torch.eye(4, dtype=src.dtype, device=src.device).expand(N, 4, 4)
        elif ti.shape[0] == 1 and N > 1:
            ti = ti.expand(N, 4, 4)  # one T_init shared by the batch
        result = slice_histories(register(src, tgt, ti.to(src.dtype), w, cfg=cfg, key=key))
        if self.verbose:
            print(f"ICP converged in {int(torch.max(result.iterations))} iterations")
            print(f"Final del_T_ts: {float(torch.linalg.norm(result.deltas[:, -1]))}")
        return _to_results_dict(result)


def _to_results_dict(result: ICPResult) -> dict:
    """Results-dict contract of the reference."""
    return {
        "pc": result.pc,
        "T": result.T,
        "costs": result.costs,
        "deltas": result.deltas,
        "weights": result.weights,
        "stats": {
            "converged": result.converged,
            "iterations": result.iterations,
            "matched_ratio": result.matched_ratio,
        },
    }
