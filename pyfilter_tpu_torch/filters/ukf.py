"""Unscented and cubature Kalman filters: derivative-free sigma-point
Gaussian filtering.

Counterpart of ``pyfilter_tpu/filters/ukf.py``. The scaled unscented
transform (Julier & Uhlmann; van der Merwe) propagates 2d+1 sigma points
through the model's transition and observation means; the cubature filter is
its ``alpha=1, beta=0, kappa=0`` case. Both run on :class:`EKFState`.
"""

from __future__ import annotations

import torch

from ..timeseries import TimeseriesState
from ._masked import (
    cholesky_or_nan,
    density_covariance,
    filter_device,
    initial_gaussian_moments,
    masked_gaussian_update,
    observations,
    solve,
)
from .ekf import EKFState, smooth_backward
from .kalman import gaussian_batch_filter


class UnscentedKalmanFilter:
    """Sigma-point filter over a :class:`StateSpaceModel` on ``device`` (the
    card unless ``device="cpu"``; the model's), whose densities expose
    ``mean`` / ``variance`` (noise additive, evaluated at the running mean; a
    multivariate normal contributes its full ``covariance_matrix``).
    ``alpha`` / ``beta`` / ``kappa`` are the scaled transform's parameters;
    the defaults (1, 2, 0) are the classic transform with the Gaussian
    fourth-moment correction."""

    def __init__(self, model, alpha: float = 1.0, beta: float = 2.0, kappa: float = 0.0, device=None):
        self.device = filter_device(model, device)
        self.model = model
        hidden = model.hidden
        self._ev = int(hidden.event_ndim)
        init = hidden.initial_distribution()
        self._d_x = int(init.event_shape[0]) if self._ev == 1 else 1
        self._d_y = int(model.event_shape[0]) if model.event_shape else 1

        d = self._d_x
        lam = alpha * alpha * (d + kappa) - d
        self._lam = float(lam)
        # made by fills: no copy from the host (a CUDA graph may capture the construction)
        weights = lambda first, rest: torch.cat([torch.full((1,), first, device=self.device),  # noqa: E731
                                                 torch.full((2 * d,), rest, device=self.device)])
        self._wm = weights(lam / (d + lam), 1.0 / (2.0 * (d + lam)))
        self._wc = self._wm + weights(1.0 - alpha * alpha + beta, 0.0)

    # -- model probes (vectorized over a sigma-point axis) ---------------------
    def _state(self, v, t) -> TimeseriesState:
        # v: (S, d) sigma points; scalar processes see (S,)
        return TimeseriesState(t, v if self._ev == 1 else v[..., 0], self._ev)

    def _trans_mean(self, v, t):
        m = self.model.hidden.build_density(self._state(v, t)).mean
        return m if self._ev == 1 else m[..., None]

    def _trans_cov_at(self, m, t):
        return density_covariance(self.model.hidden.build_density(self._state(m[None], t)), self._d_x)

    def _obs_mean_pts(self, pts, t):
        m = self.model.build_density(self._state(pts, t)).mean
        return m[:, None] if m.dim() == 1 else m

    def _obs_cov_at(self, m, t):
        return density_covariance(self.model.build_density(self._state(m[None], t)), self._d_y)

    # -- unscented transform ----------------------------------------------------
    def _sigma_points(self, m, p):
        offsets = cholesky_or_nan((self._d_x + self._lam) * p).T  # rows are the offset vectors
        return torch.cat([m[None], m[None] + offsets, m[None] - offsets], dim=0)

    def _predict(self, m, p, t):
        pts = self._sigma_points(m, p)  # (2d+1, d)
        f_pts = self._trans_mean(pts, t)
        m_new = self._wm @ f_pts
        diff = f_pts - m_new
        p_new = (self._wc[:, None] * diff).T @ diff + self._trans_cov_at(m, t)
        # cross-covariance Cov(x_t, x_{t+1}) for the unscented RTS smoother
        cross = (self._wc[:, None] * (pts - m)).T @ diff
        return m_new, p_new, cross

    def initialize(self) -> EKFState:
        m0, p0 = initial_gaussian_moments(self.model.hidden.initial_distribution(), self._d_x)
        return EKFState(m0, p0, torch.zeros((), device=m0.device), 0.0)

    # -- the Gaussian-step protocol (ExtendedKalmanFilter.initialize_moments) --
    def initialize_moments(self):
        """(m0, P0) of the initial Gaussian belief."""
        return self.initialize()[:2]

    def predict_moments(self, m, p, t):
        """One unscented transition of the belief moments."""
        return self._predict(m, p, t)

    def correct_moments(self, m, p, y_t, t):
        """One unscented measurement update; returns the step log-likelihood."""
        return self._update(m, p, y_t, t)

    def predict_moments_cross(self, m, p, t, n_transitions: int):
        """``n_transitions`` composed transitions and the sigma-point
        cross-covariance ``Cov(x_t, x_{t+n})``, chained through the Gaussian
        identity ``C_total = C_1 P_1^{-1} C_2 ...``."""
        cross_total = None
        for _ in range(n_transitions):
            m_new, p_new, cross = self._predict(m, p, t)
            cross_total = cross if cross_total is None else cross_total @ solve(p, cross)
            m, p, t = m_new, p_new, t + 1.0
        return m, p, cross_total

    def _update(self, m, p, y_t, t):
        pts = self._sigma_points(m, p)  # (2d+1, d)
        g_pts = torch.atleast_2d(self._obs_mean_pts(pts, t))  # (2d+1, d_y)
        y_hat = self._wm @ g_pts
        diff_y = g_pts - y_hat
        s_mat = (self._wc[:, None] * diff_y).T @ diff_y + self._obs_cov_at(m, t)
        c_xy = (self._wc[:, None] * (pts - m)).T @ diff_y  # (d, d_y)
        k_gain, innov, ll_t, s_eff = masked_gaussian_update(y_t, y_hat, c_xy, s_mat)
        return m + k_gain @ innov, p - k_gain @ s_eff @ k_gain.T, ll_t

    def filter(self, y_t, state: EKFState, n_transitions: int = None) -> EKFState:
        """One unscented predict + update move (the timing of
        ``KalmanFilter.filter``)."""
        y_t = torch.atleast_1d(torch.as_tensor(y_t, dtype=torch.float32, device=self.device))
        if n_transitions is None:
            n_transitions = int(self.model.observe_every_step)
        m, p, t = state.mean, state.cov, state.time_index
        for _ in range(n_transitions):
            m, p, _ = self._predict(m, p, t)
            t = t + 1.0
        m_new, p_new, ll_t = self._update(m, p, y_t, t)
        return EKFState(m_new, p_new, state.log_likelihood + ll_t, t)

    def batch_filter(self, y):
        """Sigma-point Gaussian filtering over the whole sequence (time axis
        leading)."""
        return gaussian_batch_filter(self, observations(y, self.device))

    # -- smoothing ---------------------------------------------------------------
    def smooth(self, y, initial_moments=None):
        """Unscented RTS smoother: the backward gain comes from the sigma-point
        cross-covariance ``Cov(x_t, x_{t+1})``, no Jacobians. Returns
        ``(means (T, d), covs (T, d, d))``; ``initial_moments=(m0, P0)``
        overrides the prior (the Gaussian-sum smoother's per-component hook)."""
        y = observations(y, self.device)
        oes = int(self.model.observe_every_step)
        m, p = self.initialize_moments() if initial_moments is None else initial_moments
        t, recs = 0.0, []
        for i in range(y.shape[0]):
            m_pred, p_pred, cross = self.predict_moments_cross(m, p, t, 1 if i == 0 else oes)
            t = t + (1 if i == 0 else oes)
            m, p, _ = self._update(m_pred, p_pred, y[i], t)
            recs.append((m_pred, p_pred, m, p, cross))
        return smooth_backward(*(torch.stack(parts) for parts in zip(*recs)))


class CubatureKalmanFilter(UnscentedKalmanFilter):
    """Third-degree spherical-radial cubature filter (Arasaratnam & Haykin
    2009): 2d equally weighted points at ``m +/- sqrt(d) chol(P) e_i``, the
    unscented transform's ``alpha=1, beta=0, kappa=0`` case (the centre point
    carries zero weight)."""

    def __init__(self, model, device=None):
        super().__init__(model, alpha=1.0, beta=0.0, kappa=0.0, device=device)
