"""Inference utilities: the weighted multivariate-normal fit.

Counterpart of ``pyfilter_tpu/inference/utils.py`` (without the quasi-random
MVN).
"""

from __future__ import annotations

import torch

from ..distributions import MultivariateNormal, robust_cholesky


def calc_mean_chol(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """Weighted mean and Cholesky factor of the covariance of samples ``x``
    ``(B, D)`` under normalized weights ``w`` ``(B,)``; the square root of the
    diagonal where the covariance is not positive definite."""
    mean = w @ x
    centered = x - mean
    cov = (w[:, None] * centered).T @ centered
    return mean, robust_cholesky(cov)


def construct_mvn(x: torch.Tensor, w: torch.Tensor, scale: float = 1.0) -> MultivariateNormal:
    """MVN fitted to weighted samples, its Cholesky factor scaled by ``scale``."""
    mean, chol = calc_mean_chol(x, w)
    return MultivariateNormal(mean, scale * chol)
