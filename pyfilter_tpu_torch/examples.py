"""Example models: the sine-diffusion model of the reference README, the
stochastic-volatility, Lorenz-63 and nutria models, the last three with
their prior-registering builders.

Counterpart of ``pyfilter_tpu/examples.py`` (``sine_diffusion_model``,
``stochastic_volatility_model``, ``stochastic_volatility_builder``,
``lorenz63_model``, ``lorenz63_builder``, ``nutria_model`` and
``nutria_builder`` only).
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


def _lorenz_drift(x, s, r, b, sigma):
    x0, x1, x2 = x.value[..., 0], x.value[..., 1], x.value[..., 2]
    dx = -s * (x0 - x1)
    dy = r * x0 - x1 - x0 * x2
    dz = x0 * x1 - b * x2
    return torch.stack((dx, dy, dz), dim=-1), sigma


def _lorenz_initial(s, r, b, *rest):
    mean = s.new_tensor([-5.91652, -5.52332, 24.5723])
    scale = s.new_full((3,), math.sqrt(10.0))
    return dist.Normal(mean, scale).to_event(1)


def lorenz63_model(
    s=10.0, r=28.0, b=8.0 / 3.0, observe_every_step: int = 10, dt: float = 1e-2, device=None
):
    """3-D Lorenz SDE (unit diffusion, Euler–Maruyama at ``dt``) observed
    through ``0.8 * (x0, x2)`` plus noise of variance 0.1 every
    ``observe_every_step`` sub-steps (the reference's ``lorenz.ipynb``).
    ``s``, ``r``, ``b`` are numbers or tensors (one value per lane); the
    parameters live on ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    s, r, b, sigma = (models.parameter(p, device) for p in (s, r, b, 1.0))
    increment = dist.Normal(models.parameter(0.0, device), models.parameter(math.sqrt(dt), device))
    hidden = ts.AffineEulerMaruyama(
        _lorenz_drift, (s, r, b, sigma), increment.expand((3,)).to_event(1), _lorenz_initial, dt=dt, event_ndim=1
    )
    mat = models.parameter([[0.8, 0.0, 0.0], [0.0, 0.0, 0.8]], device)
    scale = models.parameter([math.sqrt(0.1)] * 2, device)
    return ts.LinearStateSpaceModel(
        hidden, (mat, torch.zeros_like(scale), scale), event_shape=(2,), observe_every_step=observe_every_step
    )


def lorenz63_builder(context, observe_every_step: int = 10):
    """The Lorenz-63 model with uniform priors on (s, r, b) registered on
    ``context`` (the reference notebook's ``build_prob_model``), built on the
    context's device."""

    def uniform(low, high):
        return dist.Uniform(models.parameter(low, context.device), models.parameter(high, context.device))

    s = context.named_parameter("s", uniform(5.0, 40.0))
    r = context.named_parameter("r", uniform(10.0, 50.0))
    b = context.named_parameter("b", uniform(1.0, 20.0))
    return lorenz63_model(s, r, b, observe_every_step=observe_every_step, device=context.device)


def _nutria_drift(x, a, b, c, sigma_e):
    exped = torch.exp(x.value)
    return x.value + a + b * exped + c * exped**2.0, sigma_e


def _nutria_initial(a, b, c, sigma_e):
    return dist.Normal(torch.zeros_like(a), torch.ones_like(a))


def nutria_model(a=0.1, b=-0.05, c=0.0, sigma_e=0.3, sigma_n=0.2, device=None):
    """The nutria log-population growth model observed linearly (the
    reference's ``nutria.ipynb``), with its parameters on ``device`` (the
    card unless ``device="cpu"``)."""
    device = resolve_device(device)
    params = tuple(models.parameter(p, device) for p in (a, b, c, sigma_e))
    increment = dist.Normal(models.parameter(0.0, device), models.parameter(1.0, device))
    hidden = ts.AffineProcess(_nutria_drift, params, increment, _nutria_initial)
    return ts.LinearStateSpaceModel(hidden, (1.0, sigma_n))


def nutria_builder(context, num_obs: int = 100):
    """The nutria model with Normal(0, 1) priors on the drift coefficients and
    ``InverseGamma(num_obs / 2, (num_obs - 2) / 10)`` priors on the two
    variances registered on ``context`` (the reference notebook's
    ``build_model``), built on the context's device."""

    def const(v):
        return models.parameter(v, context.device)

    a = context.named_parameter("a", dist.Normal(const(0.0), const(1.0)))
    b = context.named_parameter("b", dist.Normal(const(0.0), const(1.0)))
    c = context.named_parameter("c", dist.Normal(const(0.0), const(1.0)))

    alpha = num_obs / 2.0
    beta = 2.0 * (alpha - 1.0) / 10.0
    sigma_e = torch.sqrt(context.named_parameter("sigma_e", dist.InverseGamma(const(alpha), const(beta))))
    hidden = ts.AffineProcess(_nutria_drift, (a, b, c, sigma_e), dist.Normal(const(0.0), const(1.0)), _nutria_initial)
    sigma_n = torch.sqrt(context.named_parameter("sigma_n", dist.InverseGamma(const(alpha), const(beta))))
    return ts.LinearStateSpaceModel(hidden, (torch.ones_like(sigma_n), sigma_n))
