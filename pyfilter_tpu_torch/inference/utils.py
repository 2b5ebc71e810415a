"""Inference utilities: the weighted multivariate-normal fit and its
quasi-random form.

Counterpart of ``pyfilter_tpu/inference/utils.py``.
"""

from __future__ import annotations

import torch

from ..distributions import MultivariateNormal, robust_cholesky
from .qmc import EngineContainer


def calc_mean_chol(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """Weighted mean and Cholesky factor of the covariance of samples ``x``
    ``(B, D)`` under normalized weights ``w`` ``(B,)``; the square root of the
    diagonal where the covariance is not positive definite."""
    mean = w @ x
    centered = x - mean
    cov = (w[:, None] * centered).T @ centered
    return mean, robust_cholesky(cov)


class QuasiMultivariateNormal(MultivariateNormal):
    """MVN sampled by inverting scrambled Sobol points:
    ``loc + L ndtri(p)``. The engine draws on the host, so each sample costs
    one host-to-device copy; ``generator`` is not used."""

    def __init__(self, quasi_engine: EngineContainer, loc: torch.Tensor, scale_tril: torch.Tensor):
        super().__init__(loc, scale_tril)
        self.quasi_engine = quasi_engine

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        eps = torch.special.ndtri(self.quasi_engine.sample(shape[:-1]).to(self.loc.dtype))
        return self.loc + torch.einsum("...ij,...j->...i", self.scale_tril, eps)


def construct_mvn(x: torch.Tensor, w: torch.Tensor, scale: float = 1.0,
                  quasi_engine: EngineContainer | None = None) -> MultivariateNormal:
    """MVN fitted to weighted samples, its Cholesky factor scaled by
    ``scale``; sampled from ``quasi_engine`` when one is given."""
    mean, chol = calc_mean_chol(x, w)
    if quasi_engine is None:
        return MultivariateNormal(mean, scale * chol)
    return QuasiMultivariateNormal(quasi_engine, mean, scale * chol)
