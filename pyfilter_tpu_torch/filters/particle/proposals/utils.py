"""Proposal numerics: the optimal density for linear-Gaussian observations
and the marginal observation density of the APF pre-weight.

Counterpart of ``pyfilter_tpu/filters/particle/proposals/utils.py``
(``find_optimal_density``, ``linear_marginal_density``,
``_promote_obs_matrix``; the mode finder comes later). A scalar hidden state
observed as a scalar takes a closed form with no linear algebra; otherwise
the precision form is built as small ``(d, d)`` systems batched over every
particle and lane, one batched op each (no loop over particles). The
float32 inverse needs TF32 off on the card for its last digits.
"""

from __future__ import annotations

import torch

from ....distributions import Distribution, MultivariateNormal, Normal, robust_cholesky
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
