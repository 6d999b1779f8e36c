"""Compat shim: the class-based NN interface of ``dICP.nn.nn`` on top of the
functional :mod:`dicp_tpu_torch.knn` (mirrors ``dicp_tpu/nn.py``).

The reference class defaults to ``use_gumbel=True``, and so does this one.
Gumbel noise comes from an explicit source (:func:`knn.gumbel_noise`):
``find_nn`` takes one as ``key``, or uses the seed 0 so drop-in calls work
and repeat (the JAX shim's default is ``jax.random.key(0)``, whose draws
differ from torch's)."""

from __future__ import annotations

from dicp_tpu_torch import knn as _knn


class nn:
    def __init__(self, differentiable: bool = True, use_gumbel: bool = True,
                 eps: float = 1e-20, tau: float = 0.1):
        self.differentiable = differentiable
        self.use_gumbel = use_gumbel
        self.eps = eps
        self.tau = tau

    def find_nn(self, x, y, key=None):
        if self.differentiable and self.use_gumbel and key is None:
            key = 0
        return _knn.find_nn(x, y, differentiable=self.differentiable,
                            use_gumbel=self.use_gumbel, key=key, tau=self.tau,
                            eps=self.eps)
