"""Proposal numerics: the optimal density for linear-Gaussian observations,
the marginal observation density of the APF pre-weight, and the mode finder
of the linearized proposals.

Counterpart of ``pyfilter_tpu/filters/particle/proposals/utils.py``. A
scalar hidden state observed as a scalar takes a closed form with no linear
algebra; otherwise the precision form is built as small ``(d, d)`` systems
batched over every particle and lane, one batched op each (no loop over
particles). The float32 inverse needs TF32 off on the card for its last
digits.

:func:`find_mode` takes every particle's gradient from one
``torch.func.grad`` of the summed objective (valid because the objective is
a sum of per-particle terms) and every particle's Hessian from ``d``
``torch.func.vjp`` pull-backs of that gradient, one per row (the JAX package
takes the same symmetric matrix as ``d`` forward-mode columns): no loop over
particles. Its damped-Newton step goes through
``eigvalsh`` and ``pinv``, which on the card wait for their error status on
the host.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ....distributions import Distribution, MultivariateNormal, Normal, robust_cholesky
from ....timeseries import TimeseriesState
from ....utils import construct_diag_from_flat


def _promote_obs_matrix(a: torch.Tensor, hidden_1d: bool, obs_1d: bool) -> torch.Tensor:
    """The observation coefficient as a matrix ``(..., d_o, d_h)``."""
    if hidden_1d:
        a = a[..., None]
    if obs_1d:
        a = a[..., None, :] if a.dim() >= 1 else a.reshape(1, 1)
    return a


def _broadcast_event(v, d: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-dimension scale broadcast over the ``d`` event dims."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device) * torch.ones(d, dtype=like.dtype, device=like.device)


def find_optimal_density(y, loc, h_var_inv, o_var_inv, a, hidden_event_ndim: int, obs_event_ndim: int) -> Distribution:
    r"""Posterior of ``x`` under the prior ``N(loc, diag(1/h_var_inv))`` and
    the likelihood ``y ~ N(a x, diag(1/o_var_inv))`` (``y`` already net of
    the offset):

    .. math::
        \Sigma = (P_h + A^T P_o A)^{-1}, \quad
        \mu = \Sigma (P_h \, loc + A^T P_o \, y)
    """
    hidden_1d = hidden_event_ndim == 0
    obs_1d = obs_event_ndim == 0

    if hidden_1d and obs_1d:
        prec = h_var_inv + torch.square(a) * o_var_inv
        var = 1.0 / prec
        mean = var * (h_var_inv * loc + a * o_var_inv * y)
        return Normal(mean, torch.sqrt(var))

    a_mat = _promote_obs_matrix(a, hidden_1d, obs_1d)  # (..., d_o, d_h)
    a_t = a_mat.transpose(-2, -1)
    d_o, d_h = a_mat.shape[-2], a_mat.shape[-1]
    if not obs_1d:
        o_var_inv = _broadcast_event(o_var_inv, d_o, loc)
    if not hidden_1d:
        h_var_inv = _broadcast_event(h_var_inv, d_h, loc)
    o_prec = construct_diag_from_flat(o_var_inv, obs_event_ndim)  # (..., d_o, d_o)
    h_prec = construct_diag_from_flat(h_var_inv, hidden_event_ndim)

    prec = h_prec + a_t @ o_prec @ a_mat  # (..., d_h, d_h)
    cov = torch.linalg.inv(prec)

    loc_v = loc[..., None] if hidden_1d else loc
    t_1 = (h_prec @ loc_v[..., None])[..., 0]
    y_v = y[..., None] if obs_1d else y
    t_3 = (a_t @ (o_prec @ y_v[..., None]))[..., 0]
    mean = (cov @ (t_1 + t_3)[..., None])[..., 0]

    if hidden_1d:
        return Normal(mean[..., 0], torch.sqrt(cov[..., 0, 0]))
    return MultivariateNormal(mean, robust_cholesky(cov))


def linear_marginal_density(x_value, h_var, o_var, a, offset, hidden_event_ndim: int, obs_event_ndim: int) -> Distribution:
    """Marginal observation density ``N(offset + A x, A diag(h_var) A' +
    diag(o_var))``, the APF pre-weight for linear observations, centred on
    the current value ``x`` as the JAX package centres it."""
    hidden_1d = hidden_event_ndim == 0
    obs_1d = obs_event_ndim == 0

    if hidden_1d and obs_1d:
        o_loc = offset + a * x_value
        var = o_var + torch.square(a) * h_var
        return Normal(o_loc, torch.sqrt(var))

    a_mat = _promote_obs_matrix(a, hidden_1d, obs_1d)
    a_t = a_mat.transpose(-2, -1)
    d_o, d_h = a_mat.shape[-2], a_mat.shape[-1]
    if not obs_1d:
        o_var = _broadcast_event(o_var, d_o, x_value)
    if not hidden_1d:
        h_var = _broadcast_event(h_var, d_h, x_value)
    diag_h = construct_diag_from_flat(h_var, hidden_event_ndim)
    diag_o = construct_diag_from_flat(o_var, obs_event_ndim)
    cov = diag_o + a_mat @ diag_h @ a_t

    x_v = x_value[..., None] if hidden_1d else x_value
    o_loc = offset + (a_mat @ x_v[..., None])[..., 0]
    if obs_1d:
        return Normal(o_loc[..., 0], torch.sqrt(cov[..., 0, 0]))
    return MultivariateNormal(o_loc, robust_cholesky(cov))


def _joint_log_prob_fn(model, x_dist, base_state: TimeseriesState, y: torch.Tensor) -> Callable:
    """The summed objective ``sum_i log p(y | x_i) + log q_pred(x_i)``;
    ``x_dist`` is the predictive density of the new value (each particle's
    transition density, or a moment-matched Gaussian for the GPF variants)."""

    def objective(x_val):
        new_state = base_state.propagate_from(values=x_val)
        return torch.sum(model.build_density(new_state).log_prob(y) + x_dist.log_prob(x_val))

    return objective


def _unit_tangents(x: torch.Tensor, event_ndim: int) -> list:
    """The tangents of the per-particle forward-mode columns: all ones for a
    scalar state, else ``e_j`` on every particle for each ``j < d``."""
    if event_ndim == 0:
        return [torch.ones_like(x)]
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return [eye[j].expand(x.shape) for j in range(x.shape[-1])]


def _per_particle_hessian(grad_fn: Callable, x: torch.Tensor, event_ndim: int) -> torch.Tensor:
    """Every particle's Hessian from reverse-mode products of the gradient:
    particle ``i``'s gradient depends on ``x_i`` only, so the pull-back of
    ``e_j`` on every particle is row ``j`` of every Hessian at once. The
    Hessian is symmetric, so the rows are the JAX package's forward-mode
    columns; one linearization and ``d`` pull-backs take about a quarter of
    the host time of ``d`` forward-mode columns (``chip_smoke.hessian_cost``).
    ``(N, *batch)`` for a scalar state, ``(N, *batch, d, d)`` otherwise."""
    pull = torch.func.vjp(grad_fn, x)[1]
    rows = [pull(t)[0] for t in _unit_tangents(x, event_ndim)]
    return rows[0] if event_ndim == 0 else torch.stack(rows, dim=-2)


def _pinv_rtol(d: int, dtype) -> float:
    """``jnp.linalg.pinv``'s default cut, ``10 max(m, n) eps``
    (``torch.linalg.pinv``'s own is ten times smaller)."""
    return 10.0 * d * torch.finfo(dtype).eps


def find_mode(model, prev_state: TimeseriesState, y, init_x, init_std, num_steps: int, alpha: float,
              use_hessian: bool, x_dist: Distribution | None = None) -> Distribution:
    """A Gaussian proposal about the mode of the joint density
    ``log p(y | x) + log q(x)``, found from ``init_x``.

    Gradient mode: ``num_steps`` ascent steps of size ``alpha``; the scale
    stays ``init_std``. Hessian mode: damped-Newton steps, the Hessian
    shifted by ``max(2 lambda_min, 0)`` so the step ascends, the scale from
    the shifted inverse. Particles whose mode or scale is not finite fall
    back to ``init_x`` and ``init_std``."""
    if x_dist is None:
        x_dist = model.hidden.build_density(prev_state)
    grad_fn = torch.func.grad(_joint_log_prob_fn(model, x_dist, prev_state, y))
    event_ndim = model.hidden.event_ndim

    x = init_x
    init_std_b = torch.as_tensor(init_std, dtype=init_x.dtype, device=init_x.device).expand(init_x.shape)
    std = init_std_b
    for _ in range(num_steps):
        g = grad_fn(x)
        if not use_hessian:
            x = x + alpha * g
            continue
        h = _per_particle_hessian(grad_fn, x, event_ndim)
        if event_ndim == 0:
            cov = -1.0 / (h - torch.clamp(2.0 * h, min=0.0))
            x = x + cov * g
            std = torch.sqrt(cov)
            continue
        # torch's eigvalsh and pinv raise on a non-finite matrix where JAX's
        # give NaN: such a particle's Hessian goes in as the identity and its
        # results come out NaN, for the fallback below
        eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
        bad = ~torch.isfinite(h).all(dim=(-2, -1))[..., None, None]
        h = torch.where(bad, eye, h)
        # eigvalsh of the symmetrised matrix, as jnp.linalg.eigvalsh takes it
        lam_min = torch.linalg.eigvalsh(0.5 * (h + h.transpose(-1, -2))).amin(dim=-1)
        d_h = torch.clamp(2.0 * lam_min, min=0.0)[..., None, None] * eye
        cov = -torch.linalg.pinv(h - d_h, rtol=_pinv_rtol(h.shape[-1], h.dtype))
        cov = torch.where(bad, math.nan, cov)
        x = x + (cov @ g[..., None])[..., 0]
        std = robust_cholesky(cov)

    if use_hessian and event_ndim == 1:
        ok = torch.isfinite(x).all(dim=-1) & torch.isfinite(std).all(dim=(-2, -1))
        x = torch.where(ok[..., None], x, init_x)
        std = torch.where(ok[..., None, None], std, construct_diag_from_flat(init_std_b, 1))
        return MultivariateNormal(x, std)

    ok = torch.isfinite(x) & torch.isfinite(std)
    kernel = Normal(torch.where(ok, x, init_x), torch.where(ok, std, init_std_b))
    return kernel.to_event(1) if event_ndim == 1 else kernel
