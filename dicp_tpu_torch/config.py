"""Configuration of the PyTorch port: the counterpart of ``dicp_tpu/config.py``.

:class:`ICPConfig` has the JAX class's fields, defaults, validation and
``with_``, so a JAX config carries across unchanged
(:func:`dicp_tpu_torch.convert.config_from_dict`).  What differs:

* ``resolved_nn_method`` keys on the tensors' device; CPU and CUDA use the same
  table: dense up to 4096^2 distance entries, then the cluster tier for
  targets of m >= 16384 points and the tiled kernel tier below.  JAX's auto
  also picks the cluster tier for any size above the dense tier on a CPU
  (``dicp_tpu/config.py:197``); the port does not, so parity tests of the
  cluster tier pass ``nn_method='cluster'`` to both packages.  On the CPU the
  kernel tiers run the kernels' plain versions.
* ``cluster_group``, ``cluster_probes`` and ``cluster_fixup`` configure the
  cluster tier as in JAX (:meth:`ICPConfig.resolved_cluster_fixup`).
* ``use_gumbel`` selects Gumbel soft NN (:func:`dicp_tpu_torch.knn.gumbel_nn`)
  as in JAX; its noise comes from the explicit source that ``register`` and
  ``ICP.icp`` take as ``key``.  ``fused_small`` gates the whole-solve kernel K4
  (:func:`dicp_tpu_torch.ops.fused_gn.fused_eligible`; auto stays off, as in
  JAX) and ``anderson_m > 0`` selects the Anderson driver
  (:mod:`dicp_tpu_torch.anderson`), with JAX's validation.
* ``scan_unroll`` is accepted and inert: it tunes ``lax.scan``, which eager
  PyTorch does not have.  ``sharded_fused`` selects the cluster tier's search
  in the map-sharded solve (:mod:`dicp_tpu_torch.parallel.sharding`), as in
  JAX: None gives ``cluster_nn``'s own choice (K2 on CUDA queries), False the
  group scan.  ``driver`` is validated and selects no loop: one early-exit loop gives the
  results of both JAX drivers (see :mod:`dicp_tpu_torch.registration`).
  :meth:`ICPConfig.resolved_driver` is read by K4's gate and by the
  Anderson validation, as in JAX.
* The YAML loader imports ``yaml`` only when a file is given; with no file the
  built-in defaults below are used.  They equal
  ``dicp_tpu/configs/dicp_config.yaml``, which a test holds them to.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch

# Above this many distance entries per batch element the correspondence
# search leaves the dense tier (dicp_tpu/knn.py:35).
DENSE_MAX_ENTRIES = 4096 * 4096
# Targets at least this large go to the cluster tier (dicp_tpu/config.py:197).
CLUSTER_MIN_TARGETS = 16384

# The reference YAML schema with its shipped values.
DEFAULT_YAML = {
    "dICP": {
        "parameters": {
            "tanh_steepness": 5.0,
            "target_pad_val": 1000,
            "source_zeroes_are_pad": False,
            "const_iter": False,
        },
        "functionality": {
            "gumbel": False,
            "gumbel_eps": 1.0e-10,
            "gumbel_tau": 0.1,
        },
        "logging": {
            "verbose": False,
            "matched_ratio_thresh": 0.0,
        },
    }
}


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Static solver configuration; field semantics as in ``dicp_tpu``."""

    icp_type: str = "pt2pl"  # 'pt2pl' | 'pt2pt' | 'symmetric'
    max_iterations: int = 100
    tolerance: float = 1e-12
    differentiable: bool = True

    # per-call options of the reference icp() signature
    dim: int = 3
    trim_dist: Optional[float] = None
    loss_name: Optional[str] = None  # one of losses.VALID_LOSSES
    loss_metric: float = 1.0

    # YAML-sourced parameters
    tanh_steepness: float = 5.0
    target_pad_val: float = 1000.0
    source_zeroes_are_pad: bool = False
    const_iter: bool = False
    use_gumbel: bool = False
    gumbel_eps: float = 1e-10
    gumbel_tau: float = 0.1
    verbose: bool = False
    match_ratio_thresh: float = 0.0

    # solver knobs with no reference counterpart
    tikhonov: Optional[float] = None
    driver: str = "auto"  # 'auto' | 'scan' | 'while'; one loop serves all
    remat: bool = False   # recompute each iteration in the backward pass
    collect_histories: bool = True
    use_pallas_nn: Optional[bool] = None  # legacy: True -> 'pallas', False -> 'dense'
    # 'dense' (n, m) distance matrix | 'pallas' tiled 1-NN kernel (K1) |
    # 'cluster' Hilbert cluster index (K2), built once per solve | 'auto'
    nn_method: str = "auto"
    cluster_group: int = 128    # points per cluster group
    cluster_probes: int = 32    # groups searched per block of 128 queries
    # uncertified cluster queries brute-forced per iteration; None = auto
    # (n/64 clamped to [256, 4096]), 0 = off
    cluster_fixup: Optional[int] = None
    batch_chunk: Optional[int] = None  # solve the batch in chunks of this size
    # the whole-solve kernel K4 (ops/fused_gn): True forces it where eligible,
    # None (auto) and False leave it off
    fused_small: Optional[bool] = None
    solve_method: str = "closed"  # 'closed' (Cramer/Schur) | 'lu'
    scan_unroll: int = 1          # inert: no lax.scan in eager PyTorch
    anderson_m: int = 0           # > 0: Anderson-accelerated driver (anderson.py)
    anderson_cap: float = 5.0
    sharded_fused: Optional[bool] = None  # the map-sharded solve's cluster search

    def __post_init__(self):
        if self.icp_type not in ("pt2pt", "pt2pl", "symmetric"):
            raise ValueError(
                f"icp_type must be pt2pt|pt2pl|symmetric, got {self.icp_type}")
        if self.dim not in (2, 3):
            raise ValueError("dim must be 2 or 3")
        if self.loss_name is not None:
            from dicp_tpu_torch.losses import VALID_LOSSES

            if self.loss_name not in VALID_LOSSES:
                raise ValueError(f"loss_name must be one of {VALID_LOSSES}, "
                                 f"got {self.loss_name}")
        if self.driver not in ("auto", "scan", "while"):
            raise ValueError(f"driver must be auto|scan|while, got {self.driver}")
        if self.nn_method not in ("auto", "dense", "pallas", "cluster"):
            raise ValueError(f"nn_method must be auto|dense|pallas|cluster, "
                             f"got {self.nn_method}")
        if self.solve_method not in ("closed", "lu"):
            raise ValueError(f"solve_method must be closed|lu, got {self.solve_method}")
        if self.anderson_m < 0:
            raise ValueError(f"anderson_m must be >= 0, got {self.anderson_m}")
        if self.anderson_m > 0 and self.collect_histories:
            raise ValueError("anderson_m > 0 requires collect_histories="
                             "False: the accelerated iterate sequence has no "
                             "reference-contract per-iteration histories")
        if self.anderson_m > 0 and self.const_iter:
            raise ValueError("anderson_m > 0 is an early-exit acceleration; "
                             "const_iter (fixed trip count) contradicts it")
        if self.anderson_m > 0 and self.use_gumbel and self.differentiable:
            raise ValueError("anderson_m > 0 requires a deterministic "
                             "correspondence backend (Gumbel soft-NN "
                             "resamples every evaluation)")
        if (self.anderson_m > 0 and self.differentiable
                and self.resolved_driver() == "scan"):
            raise ValueError(
                "anderson_m > 0 replaces the unrolled driver with the Anderson "
                "driver, which autograd does not flow through; for gradients use "
                "dicp_tpu_torch.ift (IFT backward, driver='while'), or drop "
                "anderson_m for unrolled gradients")

    def resolved_driver(self) -> str:
        """JAX's driver rule: 'scan' (unrolled, differentiable) or 'while'
        (early exit).  One loop serves both here; K4's gate reads it."""
        if self.driver != "auto":
            return self.driver
        return "scan" if self.differentiable else "while"

    def resolved_nn_method(self, n: int, m: int, device) -> str:
        """Correspondence tier for n queries against m targets on ``device``.

        The CPU and CUDA use the same table; on the CPU the kernel tiers run
        the kernels' plain versions."""
        device = torch.device(device)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"dicp_tpu_torch runs on cpu or cuda, got {device}")
        if self.nn_method != "auto":
            return self.nn_method
        if self.use_pallas_nn is not None:
            return "pallas" if self.use_pallas_nn else "dense"
        if n * m <= DENSE_MAX_ENTRIES:
            return "dense"
        if m >= CLUSTER_MIN_TARGETS:
            return "cluster"
        return "pallas"

    def resolved_cluster_fixup(self, n: int) -> int:
        """Concrete uncertified-query brute-force budget for n queries."""
        if self.cluster_fixup is not None:
            return min(int(self.cluster_fixup), n)
        return min(min(4096, max(256, n // 64)), n)

    def with_(self, **kw) -> "ICPConfig":
        return dataclasses.replace(self, **kw)


def load_yaml_config(config_path: Optional[str] = None) -> dict:
    """The reference YAML schema as a dict: the file at ``config_path``, or a
    copy of the built-in defaults when it is None."""
    if config_path is None:
        return copy.deepcopy(DEFAULT_YAML)
    import yaml

    with open(config_path, "r") as f:
        return yaml.safe_load(f)


def config_from_yaml(
    config_path: Optional[str] = None,
    icp_type: str = "pt2pl",
    max_iterations: int = 100,
    tolerance: float = 1e-12,
    differentiable: bool = True,
) -> ICPConfig:
    """Build an :class:`ICPConfig` the way the reference constructor does: the
    YAML supplies the parameter/functionality/logging blocks, the arguments
    the rest."""
    raw = load_yaml_config(config_path)["dICP"]
    params = raw["parameters"]
    func = raw["functionality"]
    logging = raw["logging"]
    return ICPConfig(
        icp_type=icp_type,
        max_iterations=max_iterations,
        tolerance=tolerance,
        differentiable=differentiable,
        tanh_steepness=params["tanh_steepness"],
        target_pad_val=params["target_pad_val"],
        source_zeroes_are_pad=params["source_zeroes_are_pad"],
        const_iter=params["const_iter"],
        use_gumbel=func["gumbel"],
        gumbel_eps=func["gumbel_eps"],
        gumbel_tau=func["gumbel_tau"],
        verbose=logging["verbose"],
        match_ratio_thresh=logging["matched_ratio_thresh"],
    )
