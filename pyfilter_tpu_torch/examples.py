"""Example models: the sine-diffusion model of the reference README, and the
stochastic-volatility model with its prior-registering builder.

Counterpart of ``pyfilter_tpu/examples.py`` (``sine_diffusion_model``,
``stochastic_volatility_model`` and ``stochastic_volatility_builder`` only).
"""

from __future__ import annotations

import math

import torch

from . import distributions as dist
from . import timeseries as ts
from .timeseries import models
from .utils import resolve_device


def _sine_drift(x, gamma, sigma):
    return torch.sin(x.value - gamma), sigma


def sine_diffusion_model(
    gamma: float = 0.0, sigma: float = 1.0, dt: float = 0.05, obs_a: float = 1.0, obs_s: float = 0.1, device=None
):
    """Sine-drift SDE observed linearly (the reference README's flagship
    model), with its parameters on ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    gamma, sigma = (models.parameter(p, device) for p in (gamma, sigma))
    proc = ts.AffineEulerMaruyama(
        _sine_drift,
        (gamma, sigma),
        dist.Normal(models.parameter(0.0, device), models.parameter(math.sqrt(dt), device)),
        lambda g, s: dist.Normal(torch.zeros_like(g), torch.ones_like(g)),
        dt=dt,
    )
    return ts.LinearStateSpaceModel(proc, (obs_a, obs_s))


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


def stochastic_volatility_builder(context, dt: float = 0.2):
    """The stochastic-volatility model with its parameters registered on
    ``context`` under the reference notebook's priors, built on the context's
    device (so prior evaluations never move tensors between devices)."""

    def const(v):
        return models.parameter(v, context.device)

    kappa = context.named_parameter("kappa", dist.Exponential(const(10.0)))
    gamma = context.named_parameter("gamma", dist.LogNormal(const(0.0), const(1.0)))
    sigma = context.named_parameter("sigma", dist.LogNormal(const(math.log(0.05)), const(1.0)))
    vol = models.Verhulst(kappa, gamma, sigma, dt=dt, device=context.device)

    mu = context.named_parameter("mu", dist.Normal(const(0.0), const(0.5)))
    nu = context.named_parameter("nu", dist.Normal(const(0.0), const(0.15)))
    tau = context.named_parameter("tau", dist.LogNormal(const(0.0), const(0.1)))
    return ts.StateSpaceModel(vol, sv_observation, (mu, nu, tau), observe_every_step=int(1.0 / dt))
