"""Concrete distributions: ``Normal`` (the SISR main path), ``LogNormal``
and ``Exponential`` (the SMC² path's priors) and ``Uniform`` (the Lorenz
model's priors), each with ``cdf``, ``icdf`` (the quasi-random start inverts
them), ``mean`` and ``variance``; ``Gamma`` and ``InverseGamma`` (the nutria
model's variance priors), with ``cdf`` but no ``icdf``.

Counterpart of ``pyfilter_tpu/distributions/core.py``.
"""

from __future__ import annotations

import math

import torch

from . import constraints
from .base import Distribution

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class Normal(Distribution):
    arg_names = ("loc", "scale")

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.loc.shape, self.scale.shape))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * torch.square(z) - torch.log(self.scale) - _LOG_SQRT_2PI

    def cdf(self, value):
        return torch.special.ndtr((value - self.loc) / self.scale)

    def icdf(self, q):
        return self.loc + self.scale * torch.special.ndtri(q)

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape)

    @property
    def variance(self):
        return torch.square(self.scale).expand(self.batch_shape)


class LogNormal(Distribution):
    arg_names = ("loc", "scale")

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.loc.shape, self.scale.shape))

    @property
    def support(self):
        return constraints.positive

    def sample(self, generator, sample_shape=()):
        return torch.exp(Normal(self.loc, self.scale).sample(generator, sample_shape))

    def log_prob(self, value):
        log_v = torch.log(value)
        return Normal(self.loc, self.scale).log_prob(log_v) - log_v

    def cdf(self, value):
        return torch.special.ndtr((torch.log(value) - self.loc) / self.scale)

    def icdf(self, q):
        return torch.exp(self.loc + self.scale * torch.special.ndtri(q))

    @property
    def mean(self):
        return torch.exp(self.loc + 0.5 * torch.square(self.scale)).expand(self.batch_shape)

    @property
    def variance(self):
        s2 = torch.square(self.scale)
        return ((torch.exp(s2) - 1.0) * torch.exp(2.0 * self.loc + s2)).expand(self.batch_shape)


class Exponential(Distribution):
    arg_names = ("rate",)

    def __init__(self, rate: torch.Tensor):
        self.rate = rate

    @property
    def batch_shape(self):
        return tuple(self.rate.shape)

    @property
    def support(self):
        return constraints.positive

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        e = torch.empty(shape, dtype=self.rate.dtype, device=self.rate.device).exponential_(generator=generator)
        return e / self.rate

    def log_prob(self, value):
        return torch.log(self.rate) - self.rate * value

    def cdf(self, value):
        return -torch.expm1(-self.rate * value)

    def icdf(self, q):
        return -torch.log1p(-q) / self.rate

    @property
    def mean(self):
        return (1.0 / self.rate).expand(self.batch_shape)

    @property
    def variance(self):
        return (1.0 / torch.square(self.rate)).expand(self.batch_shape)


class Uniform(Distribution):
    arg_names = ("low", "high")

    def __init__(self, low: torch.Tensor, high: torch.Tensor):
        self.low = low
        self.high = high

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.low.shape, self.high.shape))

    @property
    def support(self):
        return constraints.Interval(self.low, self.high)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        u = torch.rand(shape, generator=generator, dtype=self.low.dtype, device=self.low.device)
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        """``-log(high - low)`` on the closed interval, ``-inf`` outside."""
        inside = (value >= self.low) & (value <= self.high)
        lp = -torch.log(self.high - self.low) + torch.zeros_like(value)
        return torch.where(inside, lp, -math.inf)

    def cdf(self, value):
        return torch.clamp((value - self.low) / (self.high - self.low), 0.0, 1.0)

    def icdf(self, q):
        return self.low + (self.high - self.low) * q

    @property
    def mean(self):
        return ((self.low + self.high) / 2.0).expand(self.batch_shape)

    @property
    def variance(self):
        return (torch.square(self.high - self.low) / 12.0).expand(self.batch_shape)


def _gamma_draw(generator, concentration: torch.Tensor, shape) -> torch.Tensor:
    """Standard Gamma(``concentration``, 1) draws of ``shape``."""
    return torch._standard_gamma(concentration.expand(shape).contiguous(), generator=generator)


class Gamma(Distribution):
    arg_names = ("concentration", "rate")

    def __init__(self, concentration: torch.Tensor, rate: torch.Tensor):
        self.concentration = concentration
        self.rate = rate

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.concentration.shape, self.rate.shape))

    @property
    def support(self):
        return constraints.positive

    def sample(self, generator, sample_shape=()):
        return _gamma_draw(generator, self.concentration, tuple(sample_shape) + self.batch_shape) / self.rate

    def log_prob(self, value):
        a, b = self.concentration, self.rate
        return a * torch.log(b) + (a - 1.0) * torch.log(value) - b * value - torch.lgamma(a)

    def cdf(self, value):
        return torch.special.gammainc(self.concentration, self.rate * value)

    @property
    def mean(self):
        return (self.concentration / self.rate).expand(self.batch_shape)

    @property
    def variance(self):
        return (self.concentration / torch.square(self.rate)).expand(self.batch_shape)


class InverseGamma(Distribution):
    """``1 / G`` for ``G ~ Gamma(concentration, rate)``."""

    arg_names = ("concentration", "rate")

    def __init__(self, concentration: torch.Tensor, rate: torch.Tensor):
        self.concentration = concentration
        self.rate = rate

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.concentration.shape, self.rate.shape))

    @property
    def support(self):
        return constraints.positive

    def sample(self, generator, sample_shape=()):
        return self.rate / _gamma_draw(generator, self.concentration, tuple(sample_shape) + self.batch_shape)

    def log_prob(self, value):
        a, b = self.concentration, self.rate
        return a * torch.log(b) - (a + 1.0) * torch.log(value) - b / value - torch.lgamma(a)

    def cdf(self, value):
        return 1.0 - torch.special.gammainc(self.concentration, self.rate / value)

    @property
    def mean(self):
        a = self.concentration
        return torch.where(a > 1.0, self.rate / (a - 1.0), math.nan).expand(self.batch_shape)

    @property
    def variance(self):
        a = self.concentration
        v = torch.square(self.rate) / (torch.square(a - 1.0) * (a - 2.0))
        return torch.where(a > 2.0, v, math.nan).expand(self.batch_shape)
