"""Pre-built processes: ``AR``, ``RandomWalk``, ``OrnsteinUhlenbeck`` and
``Verhulst`` (the volatility of the stochastic-volatility model).

Counterpart of ``pyfilter_tpu/timeseries/models.py``. Like the JAX package,
and unlike ``bench.py``'s torch loop, the volatility is not clamped.
Parameters are float32 tensors on the process's device (the card unless
``device="cpu"``).
"""

from __future__ import annotations

import torch

from ..distributions import Normal
from ..utils import resolve_device
from .process import AffineEulerMaruyama, AffineProcess


def _verhulst_drift(x, kappa, gamma, sigma):
    return kappa * (gamma - x.value) * x.value, sigma * x.value


def _verhulst_initial(kappa, gamma, sigma):
    return Normal(gamma, sigma / torch.sqrt(2.0 * kappa))


def parameter(value, device) -> torch.Tensor:
    """A model parameter: a float32 tensor on ``device``."""
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
