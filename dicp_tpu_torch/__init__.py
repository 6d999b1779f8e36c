"""dicp_tpu_torch: the PyTorch and CUDA port of ``dicp_tpu``.

Batched differentiable Gauss-Newton ICP with the call surface and results
of the JAX package, running on the CPU or on an NVIDIA Hopper GPU.  The
correspondence search's tiled tier (``csrc/tiled_nn.cu``) and cluster tier
(``csrc/cluster_search.cu``, ``csrc/cluster_topk.cu``) and the whole-solve
small-pair kernel (``csrc/fused_gn.cu``) are CUDA kernels written by hand,
built with ``nvcc`` at first use on a CUDA tensor; so are the score-form
1-NN kernels of the A/B (``csrc/score_nn.cu``).

* :mod:`dicp_tpu_torch.api` / :mod:`dicp_tpu_torch.ICP`: the drop-in ``ICP``
  class and ragged-input batch handling.
* :mod:`dicp_tpu_torch.registration`: the functional core, :func:`register`
  (``register_jit``, like the other ``*_jit`` names, is an alias of its
  eager function: PyTorch runs eagerly).
* :mod:`dicp_tpu_torch.ift`: :func:`register_ift`, implicit-function-theorem
  gradients through the fixed point.
* :mod:`dicp_tpu_torch.anderson`: :func:`register_anderson`, the
  Anderson-accelerated driver.
* :mod:`dicp_tpu_torch.ops.fused_gn`: the whole-solve kernel K4
  (``fused_small=True``).
* :mod:`dicp_tpu_torch.knn`, :mod:`dicp_tpu_torch.ops.tiled_knn`: hard 1-NN,
  dense and tiled, and Gumbel soft NN with an explicit noise source.
* :mod:`dicp_tpu_torch.ops.cluster_knn`, :mod:`dicp_tpu_torch.ops.cluster_search`:
  the Hilbert cluster index and its certified 1-NN and k-NN searches.
* :mod:`dicp_tpu_torch.ops.normals`: PCA surface normals.
* :mod:`dicp_tpu_torch.svd_icp`: :func:`pt2pt_svd_icp`, closed-form (Kabsch)
  pt2pt ICP.
* :mod:`dicp_tpu_torch.odometry`: chained scan-to-scan odometry, ATE, the
  pose graph and checkpoint/resume (:mod:`dicp_tpu_torch.utils.checkpoint`).
* :mod:`dicp_tpu_torch.pipeline`: the streaming serving loop over raw scans
  (:func:`stream_registrations`, :func:`stream_odometry`), fed by
  :mod:`dicp_tpu_torch.io` (``ScanDataset``, ``.bin`` I/O and host
  preprocessing over the shared ``native/`` runtime).
* :mod:`dicp_tpu_torch.ops.voxel`: fixed-shape voxel-grid downsampling.
* :mod:`dicp_tpu_torch.sgd_icp`: :func:`register_sgd`, stochastic
  mini-batch ICP with an explicit mini-batch source.
* :mod:`dicp_tpu_torch.mapping`: scan-to-map odometry against a fused voxel
  map (:func:`scan_to_map_odometry`, :func:`map_step`, :func:`map_merge`).
* :mod:`dicp_tpu_torch.slam`: closed-loop SLAM, the scan-to-map front end
  with keyframe loop closures and a robust pose graph (:func:`slam_odometry`).
* :mod:`dicp_tpu_torch.gicp`: plane-to-plane Generalized-ICP
  (:func:`register_gicp`, :func:`register_gicp_ift`).
* :mod:`dicp_tpu_torch.multiscale`: coarse-to-fine registration over a voxel
  pyramid (:func:`register_multiscale`).
* :mod:`dicp_tpu_torch.parallel`: batch-, map- and ring-sharded ICP, the
  sharded IFT and the Schur-partitioned pose graph on ``torch.distributed``
  (a ``DeviceMesh`` of dims ``("batch", "map")``), with the multihost
  helpers in :mod:`dicp_tpu_torch.parallel.multihost`.
* :mod:`dicp_tpu_torch.convert`: configs and arrays carried across from the
  JAX package.
* :mod:`dicp_tpu_torch.benchmarks.exp_knn`: the exact 1-NN kernels' A/B on
  the card (``python -m dicp_tpu_torch.benchmarks.exp_knn``).
* :mod:`dicp_tpu_torch.bench`: bench.py's headline on the card
  (``python -m dicp_tpu_torch.bench``); :mod:`dicp_tpu_torch.benchmarks.bench_suite`
  with ``exp_gicp``, ``exp_sgd`` and ``exp_multiscale``: the JAX suite's rows.
* :mod:`dicp_tpu_torch.examples`: the four demos
  (``python -m dicp_tpu_torch.examples.<name>``).
* :mod:`dicp_tpu_torch.utils` (``benchmark``, ``trace`` on ``torch.profiler``,
  the odometry checkpoint) and :mod:`dicp_tpu_torch.visualization`.

This package imports neither ``jax`` nor ``dicp_tpu``.
"""

from dicp_tpu_torch.anderson import register_anderson, register_anderson_jit
from dicp_tpu_torch.api import ICP, batch_size_handling
from dicp_tpu_torch.config import ICPConfig, config_from_yaml
from dicp_tpu_torch.gicp import GICPResult, register_gicp, register_gicp_ift, register_gicp_jit
from dicp_tpu_torch.ops.cluster_knn import (build_cluster_index, cluster_knn,
                                            cluster_nn, cluster_nn_verified)
from dicp_tpu_torch.ops.normals import estimate_normals, estimate_normals_weighted
from dicp_tpu_torch.ift import register_ift, register_ift_jit
from dicp_tpu_torch.mapping import (LocalMap, empty_map, map_merge, map_step, map_target,
                                    scan_to_map_odometry)
from dicp_tpu_torch.multiscale import MultiscaleResult, ScaleLevel, register_multiscale
from dicp_tpu_torch.pipeline import stream_odometry, stream_registrations
from dicp_tpu_torch.registration import ICPResult, register, register_jit
from dicp_tpu_torch.sgd_icp import SGDICPResult, register_sgd, register_sgd_jit
from dicp_tpu_torch.slam import (Closure, SlamResult, build_pose_graph, rebuild_map,
                                 refine_robust, slam_odometry)
from dicp_tpu_torch.svd_icp import pt2pt_svd_icp

__version__ = "0.1.0"

# In the order of ``dicp_tpu.__all__``, every name of which the port exports.
__all__ = ["ICP", "ICPConfig", "ICPResult", "batch_size_handling",
           "build_cluster_index", "cluster_knn", "cluster_nn", "cluster_nn_verified",
           "config_from_yaml", "estimate_normals", "estimate_normals_weighted",
           "pt2pt_svd_icp", "GICPResult", "register_gicp", "register_gicp_ift",
           "register_gicp_jit", "LocalMap", "empty_map", "map_merge", "map_step", "map_target",
           "scan_to_map_odometry", "MultiscaleResult", "ScaleLevel", "register",
           "register_multiscale", "register_anderson", "register_anderson_jit",
           "register_ift", "register_ift_jit", "register_jit", "SGDICPResult", "register_sgd",
           "register_sgd_jit", "Closure", "SlamResult", "build_pose_graph", "rebuild_map",
           "refine_robust", "slam_odometry", "stream_odometry", "stream_registrations",
           "__version__"]
