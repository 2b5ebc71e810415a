"""Example models: the stochastic-volatility model of the main path.

Counterpart of ``pyfilter_tpu/examples.py`` (``stochastic_volatility_model``
only in this slice).
"""

from __future__ import annotations

from . import distributions as dist
from . import timeseries as ts
from .timeseries import models
from .utils import resolve_device


def sv_observation(x, mu, nu, tau):
    """Sinh-arcsinh-skewed observation with the volatility as scale."""
    scale = x.value
    base = dist.Normal(scale.new_zeros(()), scale.new_ones(()))
    return dist.TransformedDistribution(base, [dist.SinhArcsinh(nu, tau), dist.Affine(mu, scale)])


def stochastic_volatility_model(
    kappa: float = 0.1,
    gamma: float = 1.0,
    sigma: float = 0.05,
    mu: float = 0.0,
    nu: float = 0.0,
    tau: float = 1.0,
    dt: float = 0.2,
    device=None,
):
    """Verhulst volatility + sinh-arcsinh observation, ``observe_every_step =
    1/dt``, with its parameters on ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    vol = models.Verhulst(kappa, gamma, sigma, dt=dt, device=device)
    params = tuple(models.parameter(p, device) for p in (mu, nu, tau))
    return ts.StateSpaceModel(vol, sv_observation, params, observe_every_step=int(1.0 / dt))
