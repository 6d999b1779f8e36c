"""Compat shim: the class-based NN interface of ``dICP.nn.nn`` on top of the
functional :mod:`dicp_tpu_torch.knn` (mirrors ``dicp_tpu/nn.py``).

The reference class defaults to ``use_gumbel=True``; Gumbel soft NN is not
ported yet, so ``find_nn`` raises for it and serves hard NN otherwise."""

from __future__ import annotations

from dicp_tpu_torch import knn as _knn


class nn:
    def __init__(self, differentiable: bool = True, use_gumbel: bool = True,
                 eps: float = 1e-20, tau: float = 0.1):
        self.differentiable = differentiable
        self.use_gumbel = use_gumbel
        self.eps = eps
        self.tau = tau

    def find_nn(self, x, y):
        return _knn.find_nn(x, y, differentiable=self.differentiable,
                            use_gumbel=self.use_gumbel)
