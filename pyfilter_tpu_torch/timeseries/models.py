"""Pre-built processes: ``Verhulst`` (the volatility of the stochastic-
volatility model).

Counterpart of ``pyfilter_tpu/timeseries/models.py``. Like the JAX package,
and unlike ``bench.py``'s torch loop, the volatility is not clamped.
"""

from __future__ import annotations

import torch

from ..distributions import Normal
from ..utils import resolve_device
from .process import AffineEulerMaruyama


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
