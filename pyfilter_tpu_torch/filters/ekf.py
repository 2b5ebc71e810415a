"""Extended Kalman filter: autodiff-linearized Gaussian filtering.

Counterpart of ``pyfilter_tpu/filters/ekf.py``. One Gaussian belief is
propagated through the model's (possibly nonlinear) transition and
observation means, with Jacobians taken by ``torch.func.jacfwd`` at the
running mean every step; state-dependent diffusion is evaluated at the mean.
Any :class:`StateSpaceModel` whose densities expose ``mean`` / ``variance``
(or a full ``covariance_matrix``) will do. A step makes no host sync: the
time index is the host's float and every factorisation reports failure on
the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..timeseries import TimeseriesState
from ._lane import lane_concat, lane_exchange, lane_resample
from ._masked import (
    density_covariance,
    filter_device,
    initial_gaussian_moments,
    masked_gaussian_update,
    observations,
    solve,
)
from .kalman import gaussian_batch_filter


class EKFState(NamedTuple):
    mean: torch.Tensor  # (d,)
    cov: torch.Tensor  # (d, d)
    log_likelihood: torch.Tensor
    time_index: float

    @property
    def x(self) -> TimeseriesState:
        return TimeseriesState(self.time_index, self.mean, 1)

    def get_mean(self):
        return self.mean

    def get_variance(self):
        return torch.diagonal(self.cov, dim1=-2, dim2=-1)

    # -- lane surgery (a leading lane axis, as in the marginal adapter's
    # results inside PMMH) --------------------------------------------------
    def exchange(self, other: "EKFState", mask) -> "EKFState":
        return lane_exchange(self, other, mask)

    def resample(self, indices, entire_history: bool = True) -> "EKFState":
        return lane_resample(self, indices)

    @staticmethod
    def lane_concat(states) -> "EKFState":
        return lane_concat(EKFState, states)


def _jacobian(fn, m):
    """``torch.func.jacfwd(fn)(m)`` in ``m``'s dtype (a 0-dim intermediate
    meeting a Python number can carry its tangent in float64)."""
    return torch.func.jacfwd(fn)(m).to(m.dtype)


def smooth_backward(m_pred, p_pred, m_f, p_f, cross):
    """The RTS backward pass shared by the EKF and UKF smoothers: ``cross[t]``
    is ``Cov(x_{t-1}, x_t)`` of the move into step ``t``, the gain ``cross
    P_pred^{-1}``. Returns ``(means (T, d), covs (T, d, d))``."""
    if m_f.shape[0] == 1:
        return m_f, p_f
    ms, ps = [m_f[-1]], [p_f[-1]]
    for t in range(m_f.shape[0] - 2, -1, -1):
        gain = solve(p_pred[t + 1], cross[t + 1].T).T
        ms.append(m_f[t] + gain @ (ms[-1] - m_pred[t + 1]))
        ps.append(p_f[t] + gain @ (ps[-1] - p_pred[t + 1]) @ gain.T)
    return torch.stack(ms[::-1]), torch.stack(ps[::-1])


class ExtendedKalmanFilter:
    """First-order EKF over a :class:`StateSpaceModel` on ``device`` (the
    card unless ``device="cpu"``; the model's).

    ``iterations > 1`` gives the iterated EKF: the measurement update is
    re-linearized at each Gauss-Newton iterate (:meth:`_correct`)."""

    def __init__(self, model, iterations: int = 1, device=None):
        if iterations < 1:
            raise ValueError("iterations must be >= 1")
        self.device = filter_device(model, device)
        self.model = model
        self.iterations = int(iterations)
        hidden = model.hidden
        self._ev = int(hidden.event_ndim)
        init = hidden.initial_distribution()
        self._d_x = int(init.event_shape[0]) if self._ev == 1 else 1
        self._d_y = int(model.event_shape[0]) if model.event_shape else 1

    # -- model probes (vector-canonical views of the densities) ---------------
    def _state(self, v, t) -> TimeseriesState:
        return TimeseriesState(t, v if self._ev == 1 else v[0], self._ev)

    def _trans_mean(self, v, t):
        return torch.atleast_1d(self.model.hidden.build_density(self._state(v, t)).mean)

    def _trans_cov(self, v, t):
        return density_covariance(self.model.hidden.build_density(self._state(v, t)), self._d_x)

    def _obs_mean(self, v, t):
        return torch.atleast_1d(self.model.build_density(self._state(v, t)).mean)

    def _obs_cov(self, v, t):
        return density_covariance(self.model.build_density(self._state(v, t)), self._d_y)

    # -- the Gaussian-step protocol of the family (GSF, IMM and the marginal
    # adapter compose over it):
    #   initialize_moments()          -> (m0, P0)
    #   predict_moments(m, P, t)      -> (m', P', aux)   # aux: smoother gain info
    #   correct_moments(m, P, y_t, t) -> (m', P', ll_t)  # masked-NaN exact
    def initialize_moments(self):
        """(m0, P0) of the initial Gaussian belief."""
        return self.initialize()[:2]

    def predict_moments(self, m, p, t):
        """One Gaussian transition of the belief moments."""
        return self._predict(m, p, t)

    def correct_moments(self, m, p, y_t, t):
        """One Gaussian measurement update; returns the step log-likelihood."""
        return self._correct(m, p, y_t, t)

    def predict_moments_cross(self, m, p, t, n_transitions: int):
        """``n_transitions`` composed transitions, and the cross-covariance
        ``Cov(x_t, x_{t+n}) = P_t F_total'`` with the chained step Jacobians
        (what every RTS-style backward gain is built from)."""
        p_start = p
        f_total = torch.eye(self._d_x, dtype=p.dtype, device=p.device)
        for _ in range(n_transitions):
            m, p, f_jac = self._predict(m, p, t)
            f_total = f_jac @ f_total
            t = t + 1.0
        return m, p, p_start @ f_total.T

    # -- filter ----------------------------------------------------------------
    def initialize(self) -> EKFState:
        m0, p0 = initial_gaussian_moments(self.model.hidden.initial_distribution(), self._d_x)
        return EKFState(m0, p0, torch.zeros((), device=m0.device), 0.0)

    def _correct(self, m_pred, p_pred, y_t, t):
        """Measurement update, iterated ``self.iterations`` times (IEKF): each
        pass is one Gauss-Newton step, re-linearizing the observation mean at
        the current iterate (Bell & Cathey 1993). The covariance uses the last
        linearization; the likelihood increment is the FIRST pass's, the
        one-step-ahead predictive density the rest of the family reports."""
        m_i = m_pred
        ll_first = None
        for _ in range(self.iterations):
            h_jac = _jacobian(lambda v: self._obs_mean(v, t), m_i)
            r = self._obs_cov(m_i, t)
            # linearized predicted observation at the iterate: h(m_i) + H_i (m_pred - m_i)
            y_hat = self._obs_mean(m_i, t) + h_jac @ (m_pred - m_i)
            k_gain, innov, ll_t, s_eff = masked_gaussian_update(
                y_t, y_hat, p_pred @ h_jac.T, h_jac @ p_pred @ h_jac.T + r
            )
            if ll_first is None:
                ll_first = ll_t
            m_i = m_pred + k_gain @ innov
        return m_i, p_pred - k_gain @ s_eff @ k_gain.T, ll_first

    def _predict(self, m, p, t):
        """One linearized transition; returns the step Jacobian for smoothing."""
        f_jac = _jacobian(lambda v: self._trans_mean(v, t), m)
        q = self._trans_cov(m, t)
        return self._trans_mean(m, t), f_jac @ p @ f_jac.T + q, f_jac

    def filter(self, y_t, state: EKFState, n_transitions: int = None) -> EKFState:
        """One predict + update move (the timing of ``KalmanFilter.filter``)."""
        y_t = torch.atleast_1d(torch.as_tensor(y_t, dtype=torch.float32, device=self.device))
        if n_transitions is None:
            n_transitions = int(self.model.observe_every_step)
        m, p, t = state.mean, state.cov, state.time_index
        for _ in range(n_transitions):
            m, p, _ = self._predict(m, p, t)
            t = t + 1.0
        m_new, p_new, ll_t = self._correct(m, p, y_t, t)
        return EKFState(m_new, p_new, state.log_likelihood + ll_t, t)

    def batch_filter(self, y):
        """Linearized Gaussian filtering over the whole sequence (time axis
        leading)."""
        return gaussian_batch_filter(self, observations(y, self.device))

    # -- smoothing --------------------------------------------------------------
    def smooth(self, y, initial_moments=None):
        """Extended RTS smoother: the backward pass reuses each step's composed
        transition Jacobian. Returns ``(means (T, d), covs (T, d, d))``.
        ``initial_moments=(m0, P0)`` overrides the prior (the Gaussian-sum
        smoother's per-component hook)."""
        y = observations(y, self.device)
        oes = int(self.model.observe_every_step)
        m, p = self.initialize_moments() if initial_moments is None else initial_moments
        t, recs = 0.0, []
        for i in range(y.shape[0]):
            m_pred, p_pred, cross = self.predict_moments_cross(m, p, t, 1 if i == 0 else oes)
            t = t + (1 if i == 0 else oes)
            m, p, _ = self._correct(m_pred, p_pred, y[i], t)
            recs.append((m_pred, p_pred, m, p, cross))
        return smooth_backward(*(torch.stack(parts) for parts in zip(*recs)))
