"""Variational inference and maximum likelihood through the particle filter.

Counterpart of ``pyfilter_tpu/inference/variational.py``. :func:`fit_svi` is
the reference's pyro VI bridge without pyro: a diagonal-Gaussian guide on the
unconstrained parameters, fitted by Adam on the ELBO

.. math::
    \\mathcal{L} = E_q[ \\hat\\ell(\\theta) + \\log p(\\theta) - \\log q(\\theta) ]

whose likelihood factor :math:`\\hat\\ell` is the filter's
:meth:`~pyfilter_tpu_torch.filters.ParticleFilter.smoothed_log_likelihood`
(the filter and FFBS outside the graph, the smoothed trajectories' joint
density under the parameters inside it); the ``num_elbo_samples`` draws of
:math:`\\theta` ride the filter's lane axis. :func:`fit_mle` climbs the
differentiable filter's own log-likelihood estimate (``differentiable=True``).

Adam is ``torch.optim.Adam`` (optax's defaults: betas 0.9 and 0.999, eps
1e-8). Both loops are one Python step per Adam update: PyTorch runs eagerly,
so the JAX package's ``chunk_size`` (steps per compiled scan) has no
counterpart here.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..distributions import Normal
from . import prior as prior_ops
from .context import InferenceContext, make_context


class GuideState(NamedTuple):
    loc: torch.Tensor
    log_scale: torch.Tensor


class _Guide(torch.nn.Module):
    """The diagonal-Gaussian guide: ``loc`` and ``log_scale`` as parameters."""

    def __init__(self, loc: torch.Tensor, log_scale: torch.Tensor):
        super().__init__()
        self.loc = torch.nn.Parameter(loc.detach().clone())
        self.log_scale = torch.nn.Parameter(log_scale.detach().clone())

    def state(self) -> GuideState:
        return GuideState(self.loc.detach().clone(), self.log_scale.detach().clone())


class SVIResult(NamedTuple):
    guide: GuideState
    losses: torch.Tensor
    context: InferenceContext

    def posterior(self):
        """The diagonal-Gaussian posterior over the unconstrained parameters."""
        return Normal(self.guide.loc, torch.exp(self.guide.log_scale)).to_event(1)

    def posterior_quantiles(self, context: InferenceContext = None, qs=(0.05, 0.5, 0.95)) -> dict:
        """``{name: {q: numpy array}}``: each parameter's quantiles ``qs`` on the
        constrained space (the guide is diagonal and the bijections monotone,
        so a quantile maps through them)."""
        ctx = context if context is not None else self.context
        loc, scale = self.guide.loc, torch.exp(self.guide.log_scale)
        out = {}
        for q in qs:
            z = loc + scale * torch.special.ndtri(torch.tensor(q, dtype=loc.dtype, device=loc.device))
            index = 0
            for name in ctx.parameters:
                shape = ctx.get_shape(name, constrained=False)
                numel = math.prod(shape)
                chunk = z[index : index + numel].reshape(shape)
                constrained = prior_ops.get_constrained(ctx.get_prior(name), chunk)
                out.setdefault(name, {})[q] = constrained.detach().cpu().numpy()
                index += numel
        return out


def _standard_normal(generator, shape, like: torch.Tensor) -> torch.Tensor:
    """The ELBO's reparameterisation noise, ``like``'s dtype and device."""
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _setup(filter_factory: Callable, build_model: Callable, generator, context, batch_shape: tuple):
    """The filter, the generator and the context of a fit, the context's lane
    shape set to ``batch_shape``."""
    filt = filter_factory(build_model)
    if generator is None:
        generator = torch.Generator(device=filt.device).manual_seed(0)
    ctx = context if context is not None else make_context(generator=generator, device=filt.device)
    if ctx.batch_shape is None:
        ctx.set_batch_shape(batch_shape)
    elif tuple(ctx.batch_shape) != batch_shape:
        raise ValueError(f"the context's batch shape {ctx.batch_shape} must be {batch_shape}")
    return filt, generator, ctx


def _host(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    return np.asarray(y, dtype=np.float32)


def fit_svi(
    build_model: Callable,
    y,
    filter_factory: Callable,
    generator: torch.Generator | None = None,
    num_steps: int = 500,
    num_elbo_samples: int = 4,
    learning_rate: float = 1e-2,
    context: InferenceContext = None,
    init_scale: float = 0.1,
) -> SVIResult:
    """Fit a diagonal-Gaussian guide by stochastic ELBO ascent.

    ``filter_factory(build_model)`` gives the filter whose smoothed
    log-likelihood is the likelihood factor; the fit runs on its device.
    Without a ``context`` one is made on that device, drawing its start from
    the priors with ``generator`` (seeded 0 when not given); a given context's
    lane shape must be ``(num_elbo_samples,)``. The guide starts at the mean
    of the context's lanes with scale ``init_scale``. Each step draws the
    reparameterisation noise, then the filter's and the smoother's draws,
    all from ``generator``."""
    s = int(num_elbo_samples)
    filt, generator, ctx = _setup(filter_factory, build_model, generator, context, (s,))
    filt = filt.set_batch_shape((s,)).replace(record_states=True).initialize_model(ctx)
    y = _host(y)

    theta0 = ctx.stack_parameters(constrained=False)  # (S, D)
    dim = theta0.shape[-1]
    guide = _Guide(theta0.mean(dim=0), torch.full((dim,), math.log(init_scale), dtype=theta0.dtype,
                                                  device=theta0.device))
    opt = torch.optim.Adam(guide.parameters(), lr=learning_rate)

    losses = []
    for _ in range(int(num_steps)):
        opt.zero_grad()
        eps = _standard_normal(generator, (s, dim), guide.loc)
        scale = torch.exp(guide.log_scale)
        theta = guide.loc + scale * eps  # (S, D), reparameterised
        ctx2 = ctx.unstack_parameters(theta, constrained=False)
        ll = filt.initialize_model(ctx2).smoothed_log_likelihood(generator, y)  # (S,)
        log_prior = ctx2.eval_priors(constrained=False)
        log_q = Normal(guide.loc, scale).to_event(1).log_prob(theta)
        loss = -torch.mean(ll + log_prior - log_q)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return SVIResult(guide.state(), torch.stack(losses), ctx)


class MLEResult(NamedTuple):
    theta: torch.Tensor  # (1, D) unconstrained stacked parameters
    losses: torch.Tensor
    context: InferenceContext

    def parameters(self) -> dict:
        """The fitted constrained parameter values, by name, as numpy arrays."""
        ctx = self.context.unstack_parameters(self.theta, constrained=False)
        return {n: v.detach().cpu().numpy() for n, v in ctx.get_parameters(constrained=True)}


def fit_mle(
    build_model: Callable,
    y,
    filter_factory: Callable,
    generator: torch.Generator | None = None,
    num_steps: int = 200,
    learning_rate: float = 5e-2,
    context: InferenceContext = None,
    map_estimate: bool = False,
) -> MLEResult:
    """Maximum-likelihood (with ``map_estimate``, maximum a posteriori) point
    estimate by Adam on the log-likelihood estimate of the filter that
    ``filter_factory(build_model)`` gives, run with ``differentiable=True``
    (the Ścibior–Wood correction makes its gradient unbiased for the score).
    Every step re-filters ``y`` with fresh draws from ``generator``. The
    context (made as :func:`fit_svi` makes it) has lane shape ``()``."""
    filt, generator, ctx = _setup(filter_factory, build_model, generator, context, ())
    filt = filt.replace(differentiable=True).initialize_model(ctx)
    y = _host(y)

    theta = ctx.stack_parameters(constrained=False).detach().clone().requires_grad_(True)  # (1, D)
    opt = torch.optim.Adam([theta], lr=learning_rate)
    losses = []
    for _ in range(int(num_steps)):
        opt.zero_grad()
        ctx2 = ctx.unstack_parameters(theta, constrained=False)
        obj = filt.initialize_model(ctx2).batch_filter(generator, y).log_likelihood
        if map_estimate:
            obj = obj + ctx2.eval_priors(constrained=False)
        loss = -torch.sum(obj)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return MLEResult(theta.detach().clone(), torch.stack(losses), ctx)
