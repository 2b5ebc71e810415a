"""Multivariate normal distribution and the Cholesky with a fallback.

Counterpart of ``pyfilter_tpu/distributions/mvn.py``, parameterised by
``(loc, scale_tril)`` (the form the SMC² proposal builds), or built from a
covariance or a precision matrix, each factored once at construction. As in
the JAX package, a factor that fails is NaN rather than an error: the
factorisations report failure in ``info`` (``cholesky_ex``), which is read on
the device, never on the host.
"""

from __future__ import annotations

import math

import torch

from . import constraints
from .base import Distribution

_LOG_2PI = math.log(2.0 * math.pi)


def robust_cholesky(cov: torch.Tensor, jitter: float = 1e-9) -> torch.Tensor:
    """Cholesky factor of ``cov + jitter * I``, or the square root of the
    diagonal where that fails, as the JAX package does. ``cholesky_ex``
    reports a failure in ``info`` instead of raising, and ``torch.where``
    picks the fallback on the device, so a failed fit costs no host sync."""
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    chol, info = torch.linalg.cholesky_ex(cov + jitter * eye)
    bad = (info != 0) | torch.isnan(chol).any(dim=(-2, -1))
    diag_fallback = torch.sqrt(torch.clamp(cov * eye, min=0.0) * eye + jitter * eye)
    return torch.where(bad[..., None, None], diag_fallback, chol)


def _cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``a``, NaN where ``a`` is not positive
    definite (``jnp.linalg.cholesky``'s result there), with no host sync."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[..., None, None], math.nan, chol)


class MultivariateNormal(Distribution):
    arg_names = ("loc", "scale_tril")

    def __init__(self, loc: torch.Tensor, scale_tril: torch.Tensor | None = None,
                 covariance_matrix: torch.Tensor | None = None, precision_matrix: torch.Tensor | None = None):
        if sum(a is not None for a in (scale_tril, covariance_matrix, precision_matrix)) != 1:
            raise ValueError("exactly one of scale_tril / covariance_matrix / precision_matrix")
        if covariance_matrix is not None:
            scale_tril = _cholesky_or_nan(covariance_matrix)
        elif precision_matrix is not None:
            prec_chol = _cholesky_or_nan(precision_matrix)
            eye = torch.eye(prec_chol.shape[-1], dtype=prec_chol.dtype, device=prec_chol.device)
            scale_tril = _cholesky_or_nan(torch.cholesky_solve(eye.expand(prec_chol.shape), prec_chol))
        self.loc = loc
        self.scale_tril = scale_tril

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.loc.shape[:-1], self.scale_tril.shape[:-2]))

    @property
    def event_shape(self):
        return tuple(self.loc.shape[-1:])

    @property
    def support(self):
        return constraints.real_vector

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + torch.einsum("...ij,...j->...i", self.scale_tril, eps)

    def log_prob(self, value):
        d = self.event_shape[0]
        diff = value - self.loc
        tril = self.scale_tril.expand(diff.shape[:-1] + self.scale_tril.shape[-2:])
        z = torch.linalg.solve_triangular(tril, diff.unsqueeze(-1), upper=False).squeeze(-1)
        maha = torch.sum(torch.square(z), dim=-1)
        log_det = torch.sum(torch.log(torch.diagonal(self.scale_tril, dim1=-2, dim2=-1)), dim=-1)
        return -0.5 * (maha + d * _LOG_2PI) - log_det

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape + self.event_shape)

    @property
    def variance(self):
        var = torch.sum(torch.square(self.scale_tril), dim=-1)
        return var.expand(self.batch_shape + self.event_shape)

    def entropy(self):
        d = self.event_shape[0]
        log_det = torch.sum(torch.log(torch.diagonal(self.scale_tril, dim1=-2, dim2=-1)), dim=-1)
        return 0.5 * d * (1.0 + _LOG_2PI) + log_det
