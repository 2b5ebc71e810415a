"""Pre-built processes: ``AR``, ``RandomWalk``, ``OrnsteinUhlenbeck``,
``Verhulst`` (the volatility of the stochastic-volatility model), and the
structural time-series models ``LocalLinearTrend``, ``TrendingOU``, ``UCSV``
and ``Cyclical``.

Counterpart of ``pyfilter_tpu/timeseries/models.py``. Like the JAX package,
and unlike ``bench.py``'s torch loop, the volatility is not clamped.
Parameters are float32 tensors on the process's device (the card unless
``device="cpu"``). A number becomes a tensor filled on the device, and the
models' own constants are filled there too: a model rebuilt from new
parameter values (every step of an online score) copies nothing from the
host, and a host-to-device copy of pageable memory would wait for the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..distributions import Independent, Normal
from ..utils import resolve_device
from .process import AffineEulerMaruyama, AffineProcess


def _verhulst_drift(x, kappa, gamma, sigma):
    return kappa * (gamma - x.value) * x.value, sigma * x.value


def _verhulst_initial(kappa, gamma, sigma):
    return Normal(gamma, sigma / torch.sqrt(2.0 * kappa))


def parameter(value, device) -> torch.Tensor:
    """A model parameter: a float32 tensor on ``device``; a number is filled
    on the device, with no copy from the host."""
    if isinstance(value, (int, float, np.number)):
        return torch.full((), float(value), dtype=torch.float32, device=device)
    return torch.as_tensor(value, dtype=torch.float32, device=device)


class Verhulst(AffineEulerMaruyama):
    r"""Stochastic Verhulst (logistic) SDE, Euler–Maruyama discretised:
    ``dX = kappa (gamma - X) X dt + sigma X dW``."""

    def __init__(self, kappa, gamma, sigma, dt: float, device=None):
        device = resolve_device(device)
        params = tuple(parameter(p, device) for p in (kappa, gamma, sigma))
        increment = Normal(parameter(0.0, device), torch.sqrt(parameter(dt, device)))
        super().__init__(_verhulst_drift, params, increment, _verhulst_initial, dt=dt)


def _standard_normal(device) -> Normal:
    return Normal(parameter(0.0, device), parameter(1.0, device))


def _ar_mean_scale(x, alpha, beta, sigma):
    return alpha + beta * x.value, sigma


def _ar_initial(alpha, beta, sigma):
    return Normal(alpha, sigma)


class AR(AffineProcess):
    r"""AR(1): ``x' = alpha + beta * x + sigma * eps``; initial ``N(alpha, sigma)``."""

    def __init__(self, alpha, beta, sigma, device=None):
        device = resolve_device(device)
        params = tuple(parameter(p, device) for p in (alpha, beta, sigma))
        super().__init__(_ar_mean_scale, params, _standard_normal(device), _ar_initial)


def _rw_mean_scale(x, sigma):
    return x.value, sigma


def _rw_initial(sigma):
    return Normal(torch.zeros_like(sigma), sigma)


class RandomWalk(AffineProcess):
    """Gaussian random walk ``x' = x + sigma * eps``; initial ``N(0, sigma)``."""

    def __init__(self, sigma, device=None):
        device = resolve_device(device)
        super().__init__(_rw_mean_scale, (parameter(sigma, device),), _standard_normal(device), _rw_initial)


def _ou_factory(dt: float):
    def mean_scale(x, kappa, gamma, sigma):
        decay = torch.exp(-kappa * dt)
        return gamma + (x.value - gamma) * decay, sigma * torch.sqrt((1.0 - torch.square(decay)) / (2.0 * kappa))

    return mean_scale


def _ou_initial(kappa, gamma, sigma):
    return Normal(gamma, sigma / torch.sqrt(2.0 * kappa))


class OrnsteinUhlenbeck(AffineProcess):
    r"""The Ornstein-Uhlenbeck process, discretised exactly over ``dt``:
    ``x' = gamma + (x - gamma) e^{-kappa dt} + sigma sqrt((1 - e^{-2 kappa dt})
    / (2 kappa)) eps``; initial law the stationary ``N(gamma, sigma /
    sqrt(2 kappa))``."""

    def __init__(self, kappa, gamma, sigma, dt: float = 1.0, device=None):
        device = resolve_device(device)
        params = tuple(parameter(p, device) for p in (kappa, gamma, sigma))
        super().__init__(_ou_factory(dt), params, _standard_normal(device), _ou_initial)
        self.dt = dt


def _llt_mean_scale(x, sigma_level, sigma_slope):
    level, slope = x.value[..., 0], x.value[..., 1]
    loc = torch.stack([level + slope, slope], dim=-1)
    return loc, torch.stack(torch.broadcast_tensors(sigma_level, sigma_slope), dim=-1).expand(loc.shape)


def _llt_initial(sigma_level, sigma_slope):
    s = torch.stack(torch.broadcast_tensors(sigma_level, sigma_slope), dim=-1)
    return Independent(Normal(torch.zeros_like(s), s), 1)


def _standard_normal_2d(device) -> Independent:
    return Independent(Normal(torch.zeros(2, device=device), torch.ones(2, device=device)), 1)


class LocalLinearTrend(AffineProcess):
    r"""Local linear trend, the 2-D state ``(level, slope)``:
    ``level' = level + slope + sigma_level eps_1``, ``slope' = slope +
    sigma_slope eps_2``; initial ``N(0, diag(sigma))``. Linear-Gaussian."""

    def __init__(self, sigma_level, sigma_slope, device=None):
        device = resolve_device(device)
        params = tuple(parameter(p, device) for p in (sigma_level, sigma_slope))
        super().__init__(_llt_mean_scale, params, _standard_normal_2d(device), _llt_initial)


def _trending_ou_factory(dt: float):
    def mean_scale(x, kappa, gamma, beta, sigma):
        decay = torch.exp(-kappa * dt)
        trend = gamma + beta * x.time_index
        return trend + (x.value - trend) * decay, sigma * torch.sqrt((1.0 - torch.square(decay)) / (2.0 * kappa))

    return mean_scale


def _trending_ou_initial(kappa, gamma, beta, sigma):
    return Normal(gamma, sigma / torch.sqrt(2.0 * kappa))


class TrendingOU(AffineProcess):
    r"""Ornstein-Uhlenbeck process reverting to the moving trend ``theta_t =
    gamma + beta t``, discretised exactly over ``dt`` with the trend held at
    the current time over the step: ``x' = theta_t + (x - theta_t) e^{-kappa
    dt} + sigma sqrt((1 - e^{-2 kappa dt}) / (2 kappa)) eps``; initial
    ``N(gamma, sigma / sqrt(2 kappa))``."""

    def __init__(self, kappa, gamma, beta, sigma, dt: float = 1.0, device=None):
        device = resolve_device(device)
        params = tuple(parameter(p, device) for p in (kappa, gamma, beta, sigma))
        super().__init__(_trending_ou_factory(dt), params, _standard_normal(device), _trending_ou_initial)
        self.dt = dt


def _ucsv_mean_scale(x, sigma_volatility):
    log_vol = x.value[..., 1]
    return x.value, torch.stack([torch.exp(log_vol), sigma_volatility.expand(log_vol.shape)], dim=-1)


def _ucsv_initial(sigma_volatility):
    loc = torch.stack([torch.zeros_like(sigma_volatility)] * 2, dim=-1)
    scale = torch.stack([torch.ones_like(sigma_volatility), sigma_volatility], dim=-1)
    return Independent(Normal(loc, scale), 1)


class UCSV(AffineProcess):
    r"""Unobserved-components stochastic volatility, the 2-D state ``(level,
    log_vol)``: ``level' = level + exp(log_vol) eps_1``, ``log_vol' = log_vol
    + sigma_volatility eps_2``; initial ``level ~ N(0, 1)``, ``log_vol ~ N(0,
    sigma_volatility)``. Its diffusion depends on the state."""

    def __init__(self, sigma_volatility, device=None):
        device = resolve_device(device)
        super().__init__(_ucsv_mean_scale, (parameter(sigma_volatility, device),), _standard_normal_2d(device),
                         _ucsv_initial)


def _cyclical_mean_scale(x, rho, lamda, sigma):
    c, c_star = x.value[..., 0], x.value[..., 1]
    cos_l, sin_l = torch.cos(lamda), torch.sin(lamda)
    loc = torch.stack([rho * (c * cos_l + c_star * sin_l), rho * (-c * sin_l + c_star * cos_l)], dim=-1)
    return loc, sigma.unsqueeze(-1).expand(loc.shape)


def _cyclical_initial(rho, lamda, sigma):
    s = sigma / torch.sqrt(1.0 - torch.square(rho))
    scale = s.unsqueeze(-1).expand(tuple(s.shape) + (2,))
    return Independent(Normal(torch.zeros_like(scale), scale), 1)


class Cyclical(AffineProcess):
    r"""Harvey's stochastic cycle, a damped rotation of the 2-D state ``(c,
    c*)`` at frequency ``lamda``: ``c' = rho (c cos lamda + c* sin lamda) +
    sigma eps_1``, ``c*' = rho (-c sin lamda + c* cos lamda) + sigma eps_2``;
    initial the stationary ``N(0, sigma^2 / (1 - rho^2) I)``.
    Linear-Gaussian."""

    def __init__(self, rho, lamda, sigma, device=None):
        device = resolve_device(device)
        params = tuple(parameter(p, device) for p in (rho, lamda, sigma))
        super().__init__(_cyclical_mean_scale, params, _standard_normal_2d(device), _cyclical_initial)
