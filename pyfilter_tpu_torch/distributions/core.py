"""Concrete distributions, in the JAX package's order: ``Normal``,
``LogNormal``, ``Uniform``, ``Exponential``, ``Gamma``, ``InverseGamma``,
``Beta``, ``StudentT``, ``Laplace``, ``Cauchy``, ``Weibull``, ``HalfNormal``,
``HalfCauchy``, ``Gumbel``, ``Logistic``, ``Chi2``, ``TruncatedNormal``,
``Categorical``, ``Poisson``, ``Bernoulli``, ``Binomial``,
``NegativeBinomial`` and ``Delta``; each with ``log_prob``, ``cdf`` and
``icdf`` where the JAX class has them, ``mean``, ``variance``, ``support``
and ``has_icdf``.

Counterpart of ``pyfilter_tpu/distributions/core.py``: the same formulas
(the logit forms of the binary and count families, the JAX package's clamps
and masks), so both packages' densities agree to float32 rounding where the
value is closed-form in ``exp``/``log``, and to the special functions'
(``lgamma``, ``gammainc``, ``ndtri``) last bits elsewhere. The samplers draw
from an explicit ``torch.Generator``: the gamma families through
``torch._standard_gamma``, the Poisson and binomial families through
``torch.poisson`` / ``torch.binomial``, the rest by transforming normals,
uniforms or unit exponentials; ``TruncatedNormal`` inverts uniforms in
float64, in the tail of its bounds whose normal cdf values keep their
precision. The normal cdf is taken in float64 (``_ndtr``).
Parameters given as numbers become tensors on the device of the tensor
parameters (float32 on the CPU when none is a tensor).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import constraints
from .base import Distribution

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _tensors(*values):
    """The parameters as tensors: numbers take the dtype and device of the
    first floating tensor among ``values`` (float32 on the CPU if none)."""
    like = next((v for v in values if isinstance(v, torch.Tensor) and v.is_floating_point()), None)
    dtype = torch.float32 if like is None else like.dtype
    device = None if like is None else like.device
    return tuple(v if isinstance(v, torch.Tensor) else torch.as_tensor(v, dtype=dtype, device=device) for v in values)


def _bshape(*args) -> tuple:
    return tuple(torch.broadcast_shapes(*(a.shape for a in args)))


def _broadcast(x: torch.Tensor, batch_shape) -> torch.Tensor:
    """``x + zeros(batch_shape)`` without the allocation."""
    return torch.broadcast_to(x, torch.broadcast_shapes(x.shape, tuple(batch_shape)))


def _ndtr(x: torch.Tensor) -> torch.Tensor:
    """The standard normal cdf, taken in float64 for a float32 ``x``:
    torch's float32 ``ndtr`` loses the lower tail (``ndtr(-5)`` 4% high,
    ``ndtr(-7)`` 0), where the JAX package's keeps its relative precision."""
    if x.dtype == torch.float32:
        return torch.special.ndtr(x.double()).float()
    return torch.special.ndtr(x)


def _unit_exponential(shape, like: torch.Tensor, generator) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype, device=like.device).exponential_(generator=generator)


class Normal(Distribution):
    arg_names = ("loc", "scale")
    has_icdf = True

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
        return _ndtr((value - self.loc) / self.scale)

    def icdf(self, q):
        return self.loc + self.scale * torch.special.ndtri(q)

    def entropy(self):
        return _broadcast(0.5 + _LOG_SQRT_2PI + torch.log(self.scale), self.batch_shape)

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape)

    @property
    def variance(self):
        return torch.square(self.scale).expand(self.batch_shape)


class LogNormal(Distribution):
    arg_names = ("loc", "scale")
    has_icdf = True

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
        return _ndtr((torch.log(value) - self.loc) / self.scale)

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
    has_icdf = True

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
    has_icdf = True

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


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class Beta(Distribution):
    arg_names = ("concentration1", "concentration0")

    def __init__(self, concentration1, concentration0):
        self.concentration1, self.concentration0 = _tensors(concentration1, concentration0)

    @property
    def batch_shape(self):
        return _bshape(self.concentration1, self.concentration0)

    @property
    def support(self):
        return constraints.unit_interval

    def sample(self, generator, sample_shape=()):
        """``G1 / (G1 + G0)`` of two standard Gamma draws."""
        shape = tuple(sample_shape) + self.batch_shape
        g1 = _gamma_draw(generator, self.concentration1, shape)
        g0 = _gamma_draw(generator, self.concentration0, shape)
        return g1 / (g1 + g0)

    def log_prob(self, value):
        a, b = self.concentration1, self.concentration0
        return (a - 1.0) * torch.log(value) + (b - 1.0) * torch.log1p(-value) - _betaln(a, b)

    @property
    def mean(self):
        a, b = self.concentration1, self.concentration0
        return _broadcast(a / (a + b), self.batch_shape)

    @property
    def variance(self):
        a, b = self.concentration1, self.concentration0
        tot = a + b
        return _broadcast(a * b / (torch.square(tot) * (tot + 1.0)), self.batch_shape)


class StudentT(Distribution):
    arg_names = ("df", "loc", "scale")

    def __init__(self, df, loc=0.0, scale=1.0):
        self.df, self.loc, self.scale = _tensors(df, loc, scale)

    @property
    def batch_shape(self):
        return _bshape(self.df, self.loc, self.scale)

    def sample(self, generator, sample_shape=()):
        """``loc + scale * Z / sqrt(2 G / df)``, ``G ~ Gamma(df / 2, 1)``."""
        shape = tuple(sample_shape) + self.batch_shape
        z = torch.randn(shape, generator=generator, dtype=self.loc.dtype, device=self.loc.device)
        g = _gamma_draw(generator, self.df / 2.0, shape)
        return self.loc + self.scale * z * torch.rsqrt(2.0 * g / self.df)

    def log_prob(self, value):
        df = self.df
        z = (value - self.loc) / self.scale
        return (
            torch.lgamma((df + 1.0) / 2.0)
            - torch.lgamma(df / 2.0)
            - 0.5 * torch.log(df * math.pi)
            - torch.log(self.scale)
            - (df + 1.0) / 2.0 * torch.log1p(torch.square(z) / df)
        )

    @property
    def mean(self):
        return _broadcast(torch.where(self.df > 1, self.loc, math.nan), self.batch_shape)

    @property
    def variance(self):
        v = torch.square(self.scale) * self.df / (self.df - 2.0)
        return _broadcast(torch.where(self.df > 2, v, math.nan), self.batch_shape)


class Laplace(Distribution):
    arg_names = ("loc", "scale")
    has_icdf = True

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = _tensors(loc, scale)

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def sample(self, generator, sample_shape=()):
        """``loc + scale * (E1 - E2)`` of two unit exponentials."""
        shape = tuple(sample_shape) + self.batch_shape
        e = _unit_exponential((2,) + shape, self.loc, generator)
        return self.loc + self.scale * (e[0] - e[1])

    def log_prob(self, value):
        z = torch.abs(value - self.loc) / self.scale
        return _broadcast(-z - torch.log(2.0 * self.scale), self.batch_shape)

    def cdf(self, value):
        z = (value - self.loc) / self.scale
        return torch.where(z < 0, 0.5 * torch.exp(z), 1.0 - 0.5 * torch.exp(-z))

    def icdf(self, q):
        a = q - 0.5
        return self.loc - self.scale * torch.sign(a) * torch.log1p(-2.0 * torch.abs(a))

    @property
    def mean(self):
        return _broadcast(self.loc, self.batch_shape)

    @property
    def variance(self):
        return _broadcast(2.0 * torch.square(self.scale), self.batch_shape)


class Cauchy(Distribution):
    """Undefined mean and variance: both NaN."""

    arg_names = ("loc", "scale")
    has_icdf = True

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = _tensors(loc, scale)

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        c = torch.empty(shape, dtype=self.loc.dtype, device=self.loc.device).cauchy_(generator=generator)
        return self.loc + self.scale * c

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return _broadcast(-torch.log1p(torch.square(z)) - torch.log(math.pi * self.scale), self.batch_shape)

    def cdf(self, value):
        return torch.atan((value - self.loc) / self.scale) / math.pi + 0.5

    def icdf(self, q):
        return self.loc + self.scale * torch.tan(math.pi * (q - 0.5))

    @property
    def mean(self):
        return torch.full(self.batch_shape, math.nan, dtype=self.loc.dtype, device=self.loc.device)

    @property
    def variance(self):
        return torch.full(self.batch_shape, math.nan, dtype=self.loc.dtype, device=self.loc.device)


class Weibull(Distribution):
    """Weibull with ``scale`` and ``concentration`` (torch's parameterization)."""

    arg_names = ("scale", "concentration")
    has_icdf = True

    def __init__(self, scale, concentration):
        self.scale, self.concentration = _tensors(scale, concentration)

    @property
    def batch_shape(self):
        return _bshape(self.scale, self.concentration)

    @property
    def support(self):
        return constraints.positive

    def sample(self, generator, sample_shape=()):
        """``scale * E ** (1 / concentration)`` of a unit exponential."""
        shape = tuple(sample_shape) + self.batch_shape
        e = _unit_exponential(shape, self.scale, generator)
        return self.scale * torch.pow(e, 1.0 / self.concentration)

    def log_prob(self, value):
        lam, k = self.scale, self.concentration
        z = value / lam
        return torch.log(k / lam) + (k - 1.0) * torch.log(z) - torch.pow(z, k)

    def cdf(self, value):
        return -torch.expm1(-torch.pow(value / self.scale, self.concentration))

    def icdf(self, q):
        return self.scale * torch.pow(-torch.log1p(-q), 1.0 / self.concentration)

    @property
    def mean(self):
        k = self.concentration
        return _broadcast(self.scale * torch.exp(torch.lgamma(1.0 + 1.0 / k)), self.batch_shape)

    @property
    def variance(self):
        k = self.concentration
        m1 = torch.exp(torch.lgamma(1.0 + 1.0 / k))
        m2 = torch.exp(torch.lgamma(1.0 + 2.0 / k))
        return _broadcast(torch.square(self.scale) * (m2 - torch.square(m1)), self.batch_shape)


class HalfNormal(Distribution):
    arg_names = ("scale",)
    has_icdf = True

    def __init__(self, scale=1.0):
        (self.scale,) = _tensors(scale)

    @property
    def batch_shape(self):
        return tuple(self.scale.shape)

    @property
    def support(self):
        return constraints.positive

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        z = torch.randn(shape, generator=generator, dtype=self.scale.dtype, device=self.scale.device)
        return torch.abs(self.scale * z)

    def log_prob(self, value):
        z = value / self.scale
        return _broadcast(math.log(2.0) - 0.5 * torch.square(z) - torch.log(self.scale) - _LOG_SQRT_2PI,
                          self.batch_shape)

    def cdf(self, value):
        return 2.0 * _ndtr(value / self.scale) - 1.0

    def icdf(self, q):
        return self.scale * torch.special.ndtri(0.5 * (q + 1.0))

    @property
    def mean(self):
        return _broadcast(self.scale * math.sqrt(2.0 / math.pi), self.batch_shape)

    @property
    def variance(self):
        return _broadcast(torch.square(self.scale) * (1.0 - 2.0 / math.pi), self.batch_shape)


class HalfCauchy(Distribution):
    """Undefined mean and variance: both NaN."""

    arg_names = ("scale",)
    has_icdf = True

    def __init__(self, scale=1.0):
        (self.scale,) = _tensors(scale)

    @property
    def batch_shape(self):
        return tuple(self.scale.shape)

    @property
    def support(self):
        return constraints.positive

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        c = torch.empty(shape, dtype=self.scale.dtype, device=self.scale.device).cauchy_(generator=generator)
        return torch.abs(self.scale * c)

    def log_prob(self, value):
        z = value / self.scale
        return _broadcast(math.log(2.0 / math.pi) - torch.log1p(torch.square(z)) - torch.log(self.scale),
                          self.batch_shape)

    def cdf(self, value):
        return (2.0 / math.pi) * torch.atan(value / self.scale)

    def icdf(self, q):
        return self.scale * torch.tan(0.5 * math.pi * q)

    @property
    def mean(self):
        return torch.full(self.batch_shape, math.nan, dtype=self.scale.dtype, device=self.scale.device)

    @property
    def variance(self):
        return torch.full(self.batch_shape, math.nan, dtype=self.scale.dtype, device=self.scale.device)


class Gumbel(Distribution):
    arg_names = ("loc", "scale")
    has_icdf = True
    _EULER = 0.5772156649015329

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = _tensors(loc, scale)

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def sample(self, generator, sample_shape=()):
        """``loc - scale * log(E)`` of a unit exponential."""
        shape = tuple(sample_shape) + self.batch_shape
        return self.loc - self.scale * torch.log(_unit_exponential(shape, self.loc, generator))

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return _broadcast(-(z + torch.exp(-z)) - torch.log(self.scale), self.batch_shape)

    def cdf(self, value):
        return torch.exp(-torch.exp(-(value - self.loc) / self.scale))

    def icdf(self, q):
        return self.loc - self.scale * torch.log(-torch.log(q))

    @property
    def mean(self):
        return _broadcast(self.loc + self.scale * self._EULER, self.batch_shape)

    @property
    def variance(self):
        return _broadcast(torch.square(math.pi * self.scale) / 6.0, self.batch_shape)


class Logistic(Distribution):
    arg_names = ("loc", "scale")
    has_icdf = True

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = _tensors(loc, scale)

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def sample(self, generator, sample_shape=()):
        """``loc + scale * log(E1 / E2)``: the difference of two standard
        Gumbel draws."""
        shape = tuple(sample_shape) + self.batch_shape
        e = _unit_exponential((2,) + shape, self.loc, generator)
        return self.loc + self.scale * (torch.log(e[0]) - torch.log(e[1]))

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        # -z - 2 softplus(-z): the stable form of log(e^-z / (1 + e^-z)^2)
        return _broadcast(-z - 2.0 * F.softplus(-z) - torch.log(self.scale), self.batch_shape)

    def cdf(self, value):
        return torch.sigmoid((value - self.loc) / self.scale)

    def icdf(self, q):
        return self.loc + self.scale * (torch.log(q) - torch.log1p(-q))

    @property
    def mean(self):
        return _broadcast(self.loc, self.batch_shape)

    @property
    def variance(self):
        return _broadcast(torch.square(math.pi * self.scale) / 3.0, self.batch_shape)


class Chi2(Distribution):
    """Chi-squared with ``df`` degrees of freedom: ``Gamma(df / 2, 1 / 2)``."""

    arg_names = ("df",)

    def __init__(self, df):
        (self.df,) = _tensors(df)

    def _gamma(self) -> Gamma:
        return Gamma(self.df / 2.0, torch.full_like(self.df, 0.5))

    @property
    def batch_shape(self):
        return tuple(self.df.shape)

    @property
    def support(self):
        return constraints.positive

    def sample(self, generator, sample_shape=()):
        return self._gamma().sample(generator, sample_shape)

    def log_prob(self, value):
        return self._gamma().log_prob(value)

    def cdf(self, value):
        return self._gamma().cdf(value)

    @property
    def mean(self):
        return _broadcast(self.df, self.batch_shape)

    @property
    def variance(self):
        return _broadcast(2.0 * self.df, self.batch_shape)


def _std_normal_pdf(x):
    return torch.exp(-0.5 * torch.square(x)) / math.sqrt(2.0 * math.pi)


class TruncatedNormal(Distribution):
    """``Normal(loc, scale^2)`` truncated to ``[low, high]`` (either bound may
    be infinite)."""

    arg_names = ("loc", "scale", "low", "high")
    has_icdf = True

    def __init__(self, loc=0.0, scale=1.0, low=-math.inf, high=math.inf):
        self.loc, self.scale, self.low, self.high = _tensors(loc, scale, low, high)

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale, self.low, self.high)

    @property
    def support(self):
        return constraints.Interval(self.low, self.high)

    def _std_bounds(self):
        return (self.low - self.loc) / self.scale, (self.high - self.loc) / self.scale

    def sample(self, generator, sample_shape=()):
        """Inverse cdf at uniforms, in float64 and in the lower tail: where
        both standardized bounds lie above 0 the draw is ``-z`` of the
        mirrored bounds ``(-b, -a)``, so the cdf values it inverts are small
        and keep their precision far out (``1 - ndtr(10)`` is 0 in float64,
        ``ndtr(-10)`` is not)."""
        shape = tuple(sample_shape) + self.batch_shape
        a, b = self._std_bounds()
        flip = a > 0
        lo, hi = torch.where(flip, -b, a), torch.where(flip, -a, b)
        c_lo, c_hi = torch.special.ndtr(lo.double()), torch.special.ndtr(hi.double())
        u = torch.rand(shape, generator=generator, dtype=self.loc.dtype, device=self.loc.device)
        z = torch.special.ndtri(c_lo + u.double() * (c_hi - c_lo)).to(self.loc.dtype)
        # inside the open interval, as jax.random.truncated_normal clips
        inf = torch.full_like(lo, math.inf)
        z = torch.minimum(torch.maximum(z, torch.nextafter(lo, inf)), torch.nextafter(hi, -inf))
        return self.loc + self.scale * torch.where(flip, -z, z)

    def _log_z(self):
        a, b = self._std_bounds()
        return torch.log(_ndtr(b) - _ndtr(a))

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        in_support = (value >= self.low) & (value <= self.high)
        lp = -0.5 * torch.square(z) - torch.log(self.scale) - _LOG_SQRT_2PI - self._log_z()
        return torch.where(in_support, lp, -math.inf)

    def cdf(self, value):
        a, b = self._std_bounds()
        ca = _ndtr(a)
        raw = (_ndtr((value - self.loc) / self.scale) - ca) / (_ndtr(b) - ca)
        return torch.clamp(raw, 0.0, 1.0)

    def icdf(self, q):
        a, b = self._std_bounds()
        ca, cb = _ndtr(a), _ndtr(b)
        return self.loc + self.scale * torch.special.ndtri(ca + q * (cb - ca))

    @property
    def mean(self):
        a, b = self._std_bounds()
        z = _ndtr(b) - _ndtr(a)
        return _broadcast(self.loc + self.scale * (_std_normal_pdf(a) - _std_normal_pdf(b)) / z, self.batch_shape)

    @property
    def variance(self):
        a, b = self._std_bounds()
        z = _ndtr(b) - _ndtr(a)
        pa, pb = _std_normal_pdf(a), _std_normal_pdf(b)
        # x phi(x) -> 0 as x -> +-inf: mask the indeterminate inf * 0 products
        apa = torch.where(torch.isfinite(a), a * pa, 0.0)
        bpb = torch.where(torch.isfinite(b), b * pb, 0.0)
        frac = (apa - bpb) / z
        return _broadcast(torch.square(self.scale) * (1.0 + frac - torch.square((pa - pb) / z)), self.batch_shape)


class Categorical(Distribution):
    """Categorical over the last axis of ``logits`` or ``probs``; draws by
    Gumbel-max from the generator's unit exponentials."""

    arg_names = ("logits",)

    def __init__(self, logits=None, probs=None):
        if (logits is None) == (probs is None):
            raise ValueError("exactly one of logits or probs must be given")
        if probs is not None:
            logits = torch.log(_tensors(probs)[0])
        (self.logits,) = _tensors(logits)

    @property
    def batch_shape(self):
        return tuple(self.logits.shape[:-1])

    @property
    def num_categories(self):
        return self.logits.shape[-1]

    @property
    def probs(self):
        return torch.softmax(self.logits, dim=-1)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape + (self.num_categories,)
        noise = _unit_exponential(shape, self.logits, generator)
        return torch.argmax(self.logits - torch.log(noise), dim=-1).to(torch.int32)

    def log_prob(self, value):
        logp = torch.log_softmax(self.logits, dim=-1)
        value = torch.as_tensor(value, device=logp.device).long()
        logp = logp.expand(tuple(torch.broadcast_shapes(value.shape, self.batch_shape)) + logp.shape[-1:])
        return torch.gather(logp, -1, value.expand(logp.shape[:-1]).unsqueeze(-1)).squeeze(-1)

    @property
    def mean(self):
        k = torch.arange(self.num_categories, dtype=self.logits.dtype, device=self.logits.device)
        return torch.sum(self.probs * k, dim=-1)

    @property
    def variance(self):
        k = torch.arange(self.num_categories, dtype=self.logits.dtype, device=self.logits.device)
        return torch.sum(self.probs * torch.square(k - self.mean[..., None]), dim=-1)


class Poisson(Distribution):
    """Poisson counts with intensity ``rate``; draws in the rate's float
    dtype (``torch.poisson``)."""

    arg_names = ("rate",)

    def __init__(self, rate):
        (self.rate,) = _tensors(rate)

    @property
    def batch_shape(self):
        return tuple(self.rate.shape)

    @property
    def support(self):
        return constraints.nonnegative

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return torch.poisson(self.rate.expand(shape).contiguous(), generator=generator)

    def log_prob(self, value):
        return torch.xlogy(value, self.rate) - self.rate - torch.lgamma(value + 1.0)

    def cdf(self, value):
        # P(X <= k) = Q(floor(k) + 1, rate), the regularized upper incomplete gamma
        return torch.special.gammaincc(torch.floor(value) + 1.0, self.rate)

    @property
    def mean(self):
        return _broadcast(self.rate, self.batch_shape)

    @property
    def variance(self):
        return _broadcast(self.rate, self.batch_shape)


def _resolve_logits(logits, probs):
    if (logits is None) == (probs is None):
        raise ValueError("exactly one of logits or probs must be given")
    if probs is not None:
        (probs,) = _tensors(probs)
        return torch.log(probs) - torch.log1p(-probs)
    return _tensors(logits)[0]


class Bernoulli(Distribution):
    """Bernoulli in {0, 1} from ``logits`` or ``probs``; ``log_prob`` in the
    softplus form of the logits, stable at extreme logits. Float draws."""

    arg_names = ("logits",)

    def __init__(self, logits=None, probs=None):
        self.logits = _resolve_logits(logits, probs)

    @property
    def batch_shape(self):
        return tuple(self.logits.shape)

    @property
    def support(self):
        return constraints.Interval(0.0, 1.0)

    @property
    def probs(self):
        return torch.sigmoid(self.logits)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return torch.bernoulli(self.probs.expand(shape).contiguous(), generator=generator)

    def log_prob(self, value):
        l = self.logits
        return -value * F.softplus(-l) - (1.0 - value) * F.softplus(l)

    @property
    def mean(self):
        return _broadcast(self.probs, self.batch_shape)

    @property
    def variance(self):
        p = self.probs
        return _broadcast(p * (1.0 - p), self.batch_shape)


class Binomial(Distribution):
    """Binomial counts out of ``total_count`` trials, from ``logits`` or
    ``probs``; float draws (``torch.binomial``)."""

    arg_names = ("total_count", "logits")

    def __init__(self, total_count, logits=None, probs=None):
        logits = _resolve_logits(logits, probs)
        self.total_count, self.logits = _tensors(total_count, logits)
        self.total_count = self.total_count.to(self.logits.dtype)

    @property
    def batch_shape(self):
        return _bshape(self.total_count, self.logits)

    @property
    def support(self):
        return constraints.nonnegative

    @property
    def probs(self):
        return torch.sigmoid(self.logits)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        n = self.total_count.expand(shape).contiguous()
        return torch.binomial(n, self.probs.expand(shape).contiguous(), generator=generator)

    def log_prob(self, value):
        n, l = self.total_count, self.logits
        log_comb = torch.lgamma(n + 1.0) - torch.lgamma(value + 1.0) - torch.lgamma(n - value + 1.0)
        return log_comb - value * F.softplus(-l) - (n - value) * F.softplus(l)

    @property
    def mean(self):
        return _broadcast(self.total_count * self.probs, self.batch_shape)

    @property
    def variance(self):
        p = self.probs
        return _broadcast(self.total_count * p * (1.0 - p), self.batch_shape)


class NegativeBinomial(Distribution):
    """Failures before ``total_count`` successes, torch's parameterization
    (``probs`` the success probability, mean ``r p / (1 - p)``); draws by the
    exact gamma-Poisson mixture ``Poisson(Gamma(r, 1) * exp(logits))``."""

    arg_names = ("total_count", "logits")

    def __init__(self, total_count, logits=None, probs=None):
        logits = _resolve_logits(logits, probs)
        self.total_count, self.logits = _tensors(total_count, logits)
        self.total_count = self.total_count.to(self.logits.dtype)

    @property
    def batch_shape(self):
        return _bshape(self.total_count, self.logits)

    @property
    def support(self):
        return constraints.nonnegative

    @property
    def probs(self):
        return torch.sigmoid(self.logits)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        lam = _gamma_draw(generator, self.total_count, shape) * torch.exp(self.logits)
        return torch.poisson(lam, generator=generator)

    def log_prob(self, value):
        r, l = self.total_count, self.logits
        log_comb = torch.lgamma(value + r) - torch.lgamma(r) - torch.lgamma(value + 1.0)
        return log_comb - r * F.softplus(l) - value * F.softplus(-l)

    @property
    def mean(self):
        return _broadcast(self.total_count * torch.exp(self.logits), self.batch_shape)

    @property
    def variance(self):
        return self.mean / torch.sigmoid(-self.logits)


class Delta(Distribution):
    """Point mass at ``value``, the last ``event_ndim`` axes its event."""

    arg_names = ("value",)

    def __init__(self, value, event_ndim: int = 0):
        (self.value,) = _tensors(value)
        self.event_ndim = event_ndim

    @property
    def batch_shape(self):
        s = tuple(self.value.shape)
        return s[: len(s) - self.event_ndim]

    @property
    def event_shape(self):
        s = tuple(self.value.shape)
        return s[len(s) - self.event_ndim:]

    def sample(self, generator, sample_shape=()):
        return self.value.expand(tuple(sample_shape) + tuple(self.value.shape))

    def log_prob(self, value):
        eq = value == self.value
        if self.event_ndim:
            eq = torch.all(eq.flatten(-self.event_ndim), dim=-1)
        return torch.where(eq, 0.0, -math.inf)

    @property
    def mean(self):
        return self.value

    @property
    def variance(self):
        return torch.zeros_like(self.value)
