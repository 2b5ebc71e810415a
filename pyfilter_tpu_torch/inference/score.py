"""Online score estimation and streaming maximum likelihood.

Counterpart of ``pyfilter_tpu/inference/score.py``. The score of the data
log-likelihood is the smoothed expectation of an additive functional
(Poyiadjis, Doucet & Singh 2011),

.. math::
    \\nabla_\\theta \\log p(y_{1:T} | \\theta)
      = E\\Big[\\sum_t \\nabla_\\theta \\log f_\\theta(x_t | x_{t-1})
                 + \\nabla_\\theta \\log g_\\theta(y_t | x_t)\\,\\Big|\\,y_{1:T}\\Big],

so :func:`online_score` runs it through PaRIS
(:func:`~pyfilter_tpu_torch.filters.particle.smoothing.paris`) with no
recorded history, and :func:`fit_mle_streaming` takes one Adam step per
window of observations from that window's score, carrying only the particle
cloud from one window to the next (recursive maximum likelihood, Poyiadjis et
al. §4).

The per-particle gradients are ``torch.func.vmap`` over particles of
``torch.func.grad`` in the stacked unconstrained parameters, through a
rebuild of the model from them, as the JAX package takes them. ``jacfwd`` of
the particles' log-density vector (``D`` forward-mode passes, the
parameters being shared and few) gives the same ``(N, D)`` matrix at about
twice the host time a call (NVIDIA H100 80GB HBM3, N = 1e5: ``chip_smoke.py``
phase 14b times both). Adam is ``torch.optim.Adam`` with optax's defaults (betas 0.9 and 0.999, eps
1e-8). PyTorch runs eagerly: the JAX package's compiled window step and scan
over windows are a Python loop here.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..filters.particle.smoothing import paris, transition_log_sup, transition_log_sup_traced
from ..timeseries import TimeseriesState
from .context import InferenceContext
from .variational import _host, _setup


def _score_functionals(ctx, build_model, theta, ev):
    """``(h_fn, h_obs_fn)``: the per-particle gradients ``(N, D)`` of ``log f``
    (each transition, sub-steps included) and of ``log g`` (each
    observation) in the stacked unconstrained parameters, at ``theta``
    ``(1, D)``. An observation with a NaN component contributes zeros, a
    decision made on the device."""
    theta = theta.detach()

    def model_at(th):
        ctx2 = ctx.unstack_parameters(th, constrained=False)
        with ctx2.no_prior_verification():
            return build_model(ctx2)

    def per_particle(log_density, *clouds) -> torch.Tensor:
        grad = torch.func.grad(lambda th, *xs: torch.sum(log_density(th, *xs)))
        return torch.func.vmap(grad, in_dims=(None,) + (0,) * len(clouds))(theta, *clouds)[:, 0, :]

    def h_fn(x_prev, x_cur, t):
        def log_f(th, xp, xc):
            return model_at(th).hidden.build_density(TimeseriesState(t - 1.0, xp, ev)).log_prob(xc)

        return per_particle(log_f, x_prev, x_cur)

    def h_obs_fn(x_cur, y_t, t):
        finite = torch.isfinite(y_t).all()
        y_safe = torch.where(torch.isnan(y_t), 0.0, y_t)

        def log_g(th, xc):
            return model_at(th).build_density(TimeseriesState(t, xc, ev)).log_prob(y_safe)

        return torch.where(finite, per_particle(log_g, x_cur), 0.0)

    return h_fn, h_obs_fn


class OnlineScoreResult(NamedTuple):
    score: torch.Tensor  # (D,) d/dθ log p(y | θ) at the context's values, unconstrained
    log_likelihood: torch.Tensor
    stats: torch.Tensor  # (N, D) final per-particle score statistics
    context: InferenceContext

    def by_parameter(self) -> dict:
        """The score's components by parameter name (unconstrained space),
        as numpy arrays."""
        host = self.score.detach().cpu().numpy()
        out, pos = {}, 0
        for name in self.context.parameters:
            n = math.prod(self.context.get_shape(name, constrained=False))
            out[name] = host[pos : pos + n]
            pos += n
        return out


def online_score(
    build_model: Callable,
    y,
    filter_factory: Callable,
    generator: torch.Generator | None = None,
    context: InferenceContext = None,
    n_tilde: int = 2,
    log_density_sup=None,
    max_rounds: int = 16,
) -> OnlineScoreResult:
    """The score ``∇_θ log p(y_{1:T} | θ)`` at the context's current values
    (unconstrained space, as ``fit_mle``'s), by PaRIS with the score
    functional, O(1) memory in T.

    ``filter_factory(build_model)`` gives the particle filter; a plain
    bootstrap SISR will do, since the gradient comes from re-evaluated
    densities, never through a resample. The context (made as ``fit_mle``
    makes it when not given) has lane shape ``()``; the filter's and the
    backward draws come from ``generator``. ``log_density_sup`` is the
    backward kernel's bound (needed for a state-dependent diffusion; see
    ``transition_log_sup``)."""
    filt, generator, ctx = _setup(filter_factory, build_model, generator, context, ())
    filt = filt.initialize_model(ctx)
    if log_density_sup is None:
        log_density_sup = transition_log_sup(filt.model)
    theta = ctx.stack_parameters(constrained=False)
    h_fn, h_obs_fn = _score_functionals(ctx, build_model, theta, filt.model.hidden.event_ndim)
    est, stats, res = paris(filt, generator, _host(y), h_fn, h_obs_fn=h_obs_fn, n_tilde=n_tilde,
                            log_density_sup=log_density_sup, max_rounds=max_rounds)
    return OnlineScoreResult(est, res.log_likelihood, stats, ctx)


class StreamingMLEResult(NamedTuple):
    theta: torch.Tensor  # (1, D) final unconstrained parameters
    theta_path: torch.Tensor  # (n_windows, D) the parameters after each window
    window_log_likelihoods: torch.Tensor  # (n_windows,)
    context: InferenceContext

    def parameters(self) -> dict:
        """The fitted constrained parameter values, by name, as numpy arrays."""
        ctx = self.context.unstack_parameters(self.theta, constrained=False)
        return {n: v.detach().cpu().numpy() for n, v in ctx.get_parameters(constrained=True)}


def fit_mle_streaming(
    build_model: Callable,
    y,
    filter_factory: Callable,
    generator: torch.Generator | None = None,
    window: int = 25,
    learning_rate: float = 2e-2,
    context: InferenceContext = None,
    n_tilde: int = 2,
    log_density_sup=None,
    max_rounds: int = 16,
) -> StreamingMLEResult:
    """Streaming maximum likelihood: one Adam ascent step per ``window``
    observations from the PaRIS score of that window, carrying only the
    particle cloud across windows (O(1) memory in T; old observations are
    never revisited). The window's score is that of its likelihood given the
    carried cloud, which the θ-filter's becomes as θ settles. Observations
    that do not fill a last window are dropped.

    The first window initialises the cloud; each later one rebuilds the
    filter at the current θ and continues from the carried cloud, its first
    observation a full ``observe_every_step`` move. With
    ``log_density_sup=None`` the backward kernel's bound follows θ
    (:func:`transition_log_sup_traced` at every window, on the device, after
    one :func:`transition_log_sup` check at θ0 on the host); an explicit
    bound must hold at every θ the fit visits. The context is made as for
    :func:`online_score`."""
    base_filt, generator, ctx = _setup(filter_factory, build_model, generator, context, ())
    filt0 = base_filt.initialize_model(ctx)
    ev = filt0.model.hidden.event_ndim
    per_theta_bound = log_density_sup is None
    if per_theta_bound:
        transition_log_sup(filt0.model)  # the homoscedasticity check at θ0

    y = _host(y)
    window = int(window)
    n_win = y.shape[0] // window
    if n_win < 1:
        raise ValueError("fewer observations than one window")

    theta = torch.nn.Parameter(ctx.stack_parameters(constrained=False).detach().clone())  # (1, D)
    opt = torch.optim.Adam([theta], lr=learning_rate)
    state = filt0.initialize(generator)
    path, lls = [], []
    for w in range(n_win):
        current = theta.detach()
        filt = base_filt.initialize_model(ctx.unstack_parameters(current, constrained=False))
        h_fn, h_obs_fn = _score_functionals(ctx, build_model, current, ev)
        bound = transition_log_sup_traced(filt.model) if per_theta_bound else log_density_sup
        score, _, res = paris(filt, generator, y[w * window : (w + 1) * window], h_fn, h_obs_fn=h_obs_fn,
                              n_tilde=n_tilde, log_density_sup=bound, max_rounds=max_rounds, initial_state=state,
                              first_step=w == 0)
        theta.grad = -score.unsqueeze(0)
        opt.step()
        state = res.latest_state
        path.append(theta.detach()[0].clone())
        lls.append(res.log_likelihood)
    return StreamingMLEResult(theta.detach().clone(), torch.stack(path), torch.stack(lls), ctx)
