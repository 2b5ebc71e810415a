"""KDE jittering kernels for online parameter rejuvenation.

Counterpart of ``pyfilter_tpu/inference/sequential/kernels/jittering.py``:
Gaussian kernel moves on the stacked unconstrained parameters ``(K, D)``,
with the bandwidth ``1.59 * ESS^{-1/3}`` and the IQR-robust variance floor.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ....constants import EPS
from ....utils import draws_of, get_ess


def silverman(n: int, ess) -> torch.Tensor:
    """Silverman's KDE factor."""
    return (ess * (n + 2) / 4.0) ** (-1.0 / (n + 4))


def scott(n: int, ess) -> torch.Tensor:
    """Scott's KDE factor."""
    return 1.059 * ess ** (-1.0 / (n + 4))


def robust_var(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor = None) -> torch.Tensor:
    """Robust variance ``min(IQR/1.349, sigma)^2`` per column of the samples
    ``x`` ``(B, D)`` under normalized weights ``w`` ``(B,)``. The quartile rows
    are the first whose cumulative weight lies nearest 0.25 and 0.75, after a
    stable sort (ties keep their order, as ``jnp.argsort`` keeps them)."""
    sort_idx = torch.argsort(x, dim=0, stable=True)
    sorted_x = torch.take_along_dim(x, sort_idx, dim=0)
    cum_w = torch.cumsum(w[sort_idx], dim=0)

    low = torch.argmin(torch.abs(cum_w - 0.25), dim=0)
    high = torch.argmin(torch.abs(cum_w - 0.75), dim=0)

    cols = torch.arange(x.shape[-1], device=x.device)
    iqr2 = torch.square((sorted_x[high, cols] - sorted_x[low, cols]) / 1.349)

    if mean is None:
        mean = torch.sum(w[:, None] * x, dim=0)
    var = torch.sum(w[:, None] * torch.square(x - mean), dim=0)
    return torch.where(iqr2 <= var, iqr2, var)


def _bandwidth_factor(w: torch.Tensor) -> torch.Tensor:
    ess = get_ess(w, normalized=True)
    return torch.clamp(1.59 * ess ** (-1.0 / 3), EPS, 1.0 - EPS)


def _standard_normal(generator, like: torch.Tensor) -> torch.Tensor:
    """The jitter's standard normals, ``like``'s shape (lanes leading), dtype
    and device."""
    with draws_of(lanes=like.shape[:1]):
        return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class JitterKernel:
    """Base jittering kernel: subclasses implement :meth:`fit`, the kernel's
    ``(mean, scale)`` for the resampled particles."""

    std_threshold: float = EPS

    def fit(self, x: torch.Tensor, w: torch.Tensor, indices: torch.Tensor) -> tuple:
        raise NotImplementedError

    def jitter(self, generator, x: torch.Tensor, w: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """Jittered values ``mean + max(scale, std_threshold) * eps``."""
        if indices.shape[0] != x.shape[0]:
            raise ValueError(
                f"Shape of `indices` is not congruent with `x`: {indices.shape[0]} != {x.shape[0]}"
            )
        mean, scale = self.fit(x, w, indices)
        std = torch.clamp(scale, min=self.std_threshold)
        return mean + std * _standard_normal(generator, mean)


@dataclasses.dataclass(frozen=True)
class ShrinkingKernel(JitterKernel):
    """Flury–Shephard shrinking kernel: means shrunk toward the weighted mean
    by ``beta = sqrt(1 - bw^2)``."""

    def fit(self, x, w, indices):
        bw = _bandwidth_factor(w)
        mean = torch.sum(w[:, None] * x, dim=0)
        var = robust_var(x, w, mean)
        beta = torch.sqrt(1.0 - torch.square(bw))
        means = (mean + beta * (x - mean))[indices.long()]
        return means, bw * torch.sqrt(var)


@dataclasses.dataclass(frozen=True)
class NonShrinkingKernel(ShrinkingKernel):
    """The resampled values themselves as the kernel means."""

    def fit(self, x, w, indices):
        bw = _bandwidth_factor(w)
        var = robust_var(x, w)
        return x[indices.long()], bw * torch.sqrt(var)


@dataclasses.dataclass(frozen=True)
class LiuWestShrinkage(ShrinkingKernel):
    """Liu–West shrinkage with ``a = 0.98``."""

    a: float = 0.98

    def fit(self, x, w, indices):
        mean = torch.sum(w[:, None] * x, dim=0)
        var = robust_var(x, w, mean)
        values = (x * self.a + (1.0 - self.a) * mean)[indices.long()]
        bw = math.sqrt(1.0 - self.a**2.0)
        return values, bw * torch.sqrt(var)


@dataclasses.dataclass(frozen=True)
class ConstantKernel(ShrinkingKernel):
    """Constant bandwidth ``scale``, from the original NESS paper."""

    scale: float = 1e-2

    def fit(self, x, w, indices):
        return x[indices.long()], x.new_tensor(self.scale)
