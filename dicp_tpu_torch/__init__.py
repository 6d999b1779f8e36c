"""dicp_tpu_torch: the PyTorch and CUDA port of ``dicp_tpu``.

Batched differentiable Gauss-Newton ICP with the call surface and results
of the JAX package, running on the CPU or on an NVIDIA Hopper GPU.  The
correspondence search's tiled tier is a CUDA kernel written by hand
(``csrc/tiled_nn.cu``), built with ``nvcc`` at first use on a CUDA tensor.

* :mod:`dicp_tpu_torch.api` / :mod:`dicp_tpu_torch.ICP`: the drop-in ``ICP``
  class and ragged-input batch handling.
* :mod:`dicp_tpu_torch.registration`: the functional core, :func:`register`.
* :mod:`dicp_tpu_torch.knn`, :mod:`dicp_tpu_torch.ops.tiled_knn`: hard 1-NN,
  dense and tiled.
* :mod:`dicp_tpu_torch.convert`: configs and arrays carried across from the
  JAX package.

This package imports neither ``jax`` nor ``dicp_tpu``.
"""

from dicp_tpu_torch.api import ICP, batch_size_handling
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.registration import ICPResult, register

__version__ = "0.1.0"

__all__ = ["ICP", "ICPConfig", "ICPResult", "batch_size_handling", "register",
           "__version__"]
