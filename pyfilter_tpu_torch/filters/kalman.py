"""Exact Kalman filter for linear-Gaussian state-space models.

Counterpart of ``pyfilter_tpu/filters/kalman.py``. The transition ``(F, b,
Q)`` is read off the process's ``mean_scale`` on the host, in float64, by
probing basis states (with a linearity and homoscedasticity check), once,
when the filter is built; so any affine parameterisation works. The API
mirrors the particle filters': ``batch_filter`` returns a
:class:`~pyfilter_tpu_torch.filters.result.FilterResult`, a Python loop over
time whose steps make no host sync.

The host probe is also why a ``KalmanFilter`` cannot be lane-batched: the
marginal adapter's ``kind="ekf"`` reduces to it exactly on a linear model.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..timeseries import TimeseriesState
from ._masked import filter_device, initial_gaussian_moments, masked_gaussian_update, observations, solve
from .result import FilterResult


class KalmanState(NamedTuple):
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


def _host(t) -> np.ndarray:
    return np.atleast_1d(torch.as_tensor(t).detach().cpu().numpy().astype(np.float64))


def _extract_affine(hidden, device):
    """Probe ``mean_scale`` at basis states to recover ``(F, b, Q)``.

    Raises if the drift is not affine or the diffusion depends on the state
    (a heteroscedastic model has no exact Kalman recursion)."""
    ev = hidden.event_ndim
    init = hidden.initial_distribution()
    d = int(init.event_shape[0]) if ev == 1 else 1

    def loc_scale(vec):
        value = torch.tensor(vec if ev == 1 else vec[0], dtype=torch.float32, device=device)
        loc, scale = hidden.mean_scale(TimeseriesState(0.0, value, ev))
        return _host(loc), _host(scale)

    b, scale0 = loc_scale(np.zeros(d))
    cols = []
    for j in range(d):
        e = np.zeros(d)
        e[j] = 1.0
        loc_j, scale_j = loc_scale(e)
        cols.append(loc_j - b)
        if not np.allclose(scale_j, scale0, rtol=1e-5, atol=1e-7):
            raise ValueError("KalmanFilter requires a state-independent diffusion scale")
    f_mat = np.stack(cols, axis=-1)

    # linearity check at a non-basis point
    probe = np.full(d, 2.0)
    loc_p, _ = loc_scale(probe)
    if not np.allclose(loc_p, b + f_mat @ probe, rtol=1e-4, atol=1e-5):
        raise ValueError("KalmanFilter requires an affine (linear) hidden drift")

    inc = hidden.increment_distribution
    inc_cov = getattr(inc, "covariance_matrix", None)
    if inc_cov is not None:
        # full MVN increment covariance, elementwise-scaled: Q = S C S
        s = np.broadcast_to(scale0, (d,))
        c = _host(inc_cov).reshape(-1, d, d)[0]
        q_mat = s[:, None] * c * s[None, :]
    else:
        q_mat = np.diag(np.square(scale0 * _host(inc.stddev)) * np.ones(d))
    as_dev = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return as_dev(f_mat), as_dev(b), as_dev(q_mat), d


class KalmanFilter:
    """Exact filter for affine-Gaussian models built from
    :class:`LinearStateSpaceModel` over any linear-affine hidden process, on
    ``device`` (the card unless ``device="cpu"``; the model's)."""

    def __init__(self, model, device=None):
        if len(model.parameters) != 3:
            raise ValueError("KalmanFilter requires LinearModel + LinearStateSpaceModel")
        hidden = model.hidden
        if not hasattr(hidden, "mean_scale") or not hasattr(hidden, "increment_distribution"):
            raise ValueError("KalmanFilter requires LinearModel + LinearStateSpaceModel")
        self.device = filter_device(model, device)
        self.model = model

        self.F, self.b, self.Q, self._d_x = _extract_affine(hidden, self.device)
        self._d_y = int(model.event_shape[0]) if model.event_shape else 1

        h = torch.as_tensor(model.parameters[0]).detach().cpu().numpy().astype(np.float64)
        d_off, r = (_host(p) for p in model.parameters[1:])
        if h.ndim == 2:
            h_mat = h
        elif h.ndim == 0:
            h_mat = (h * np.eye(self._d_x))[: self._d_y]
        elif h.shape[0] == self._d_x and self._d_y == self._d_x:
            # LinearStateSpaceModel's vector coefficients act elementwise
            h_mat = np.diag(h)
        else:
            raise ValueError("observation coefficient must be scalar, matrix, or elementwise")
        self.H = torch.tensor(h_mat, dtype=torch.float32, device=self.device)
        self.d = torch.tensor(np.broadcast_to(d_off, (self._d_y,)).copy(), dtype=torch.float32, device=self.device)
        self.R = torch.tensor(np.eye(self._d_y) * np.square(r), dtype=torch.float32, device=self.device)

        self.m0, self.P0 = initial_gaussian_moments(hidden.initial_distribution(), self._d_x)

    def initialize(self) -> KalmanState:
        zero = torch.zeros((), device=self.device)
        return KalmanState(self.m0, self.P0, zero, 0.0)

    def filter(self, y_t, state: KalmanState, n_transitions: int = None) -> KalmanState:
        """One predict + update move, ``n_transitions`` hidden steps before the
        update (``observe_every_step`` by default; the first observation uses
        one, as the particle filters do). NaN components are marginalized
        exactly; an all-NaN observation only predicts (its ``ll_t`` is 0)."""
        y_t = torch.atleast_1d(torch.as_tensor(y_t, dtype=torch.float32, device=self.device))
        if n_transitions is None:
            n_transitions = int(self.model.observe_every_step)

        m, p = state.mean, state.cov
        for _ in range(n_transitions):
            m = self.F @ m + self.b
            p = self.F @ p @ self.F.T + self.Q

        k_gain, innov, ll_t, s_eff = masked_gaussian_update(
            y_t, self.H @ m + self.d, p @ self.H.T, self.H @ p @ self.H.T + self.R
        )
        m_new = m + k_gain @ innov
        p_new = p - k_gain @ s_eff @ k_gain.T
        return KalmanState(m_new, p_new, state.log_likelihood + ll_t, state.time_index + n_transitions)

    def batch_filter(self, y) -> FilterResult:
        """Exact filtering over the whole sequence (time axis leading)."""
        return gaussian_batch_filter(self, observations(y, self.device))

    # -- smoothing ------------------------------------------------------------
    def _effective_transition(self, n: int):
        """``n`` hidden transitions composed into one affine-Gaussian step:
        ``F^n``, ``sum F^i b``, ``sum F^i Q F^i'``."""
        f_eff = torch.eye(self._d_x, dtype=self.F.dtype, device=self.device)
        b_eff = torch.zeros(self._d_x, dtype=self.F.dtype, device=self.device)
        q_eff = torch.zeros((self._d_x, self._d_x), dtype=self.F.dtype, device=self.device)
        for _ in range(int(n)):
            b_eff = self.F @ b_eff + self.b
            q_eff = self.F @ q_eff @ self.F.T + self.Q
            f_eff = self.F @ f_eff
        return f_eff, b_eff, q_eff

    def smooth(self, y):
        """Exact Rauch–Tung–Striebel smoother: the posterior marginals ``p(x_t |
        y_{1:T})`` at the observation times, as ``(means (T, d), covs (T, d,
        d))``. All-NaN observations are skipped as in :meth:`filter`."""
        y = observations(y, self.device)
        oes = int(self.model.observe_every_step)
        f1, b1, q1 = self._effective_transition(1)
        fo, bo, qo = self._effective_transition(oes)

        def forward_step(m, p, y_t, f_mat, b_vec, q_mat):
            m_pred = f_mat @ m + b_vec
            p_pred = f_mat @ p @ f_mat.T + q_mat
            k_gain, innov, _, s_eff = masked_gaussian_update(
                y_t, self.H @ m_pred + self.d, p_pred @ self.H.T, self.H @ p_pred @ self.H.T + self.R
            )
            return m_pred, p_pred, m_pred + k_gain @ innov, p_pred - k_gain @ s_eff @ k_gain.T

        recs = [forward_step(self.m0, self.P0, y[0], f1, b1, q1)]
        for t in range(1, y.shape[0]):
            recs.append(forward_step(recs[-1][2], recs[-1][3], y[t], fo, bo, qo))
        m_pred, p_pred, m_f, p_f = (torch.stack(parts) for parts in zip(*recs))
        if y.shape[0] == 1:
            return m_f, p_f

        ms, ps = [m_f[-1]], [p_f[-1]]
        for t in range(y.shape[0] - 2, -1, -1):
            # G = P_f F' P_pred^{-1}  (all covariances symmetric)
            gain = solve(p_pred[t + 1], fo @ p_f[t]).T
            ms.append(m_f[t] + gain @ (ms[-1] - m_pred[t + 1]))
            ps.append(p_f[t] + gain @ (ps[-1] - p_pred[t + 1]) @ gain.T)
        return torch.stack(ms[::-1]), torch.stack(ps[::-1])


def gaussian_batch_filter(filt, y: torch.Tensor) -> FilterResult:
    """The single-Gaussian filters' pass over ``y`` ``(T, d_y)`` on their
    device: the first observation after one transition, then one
    ``filter`` move each; the step increments as the JAX package takes them
    (differences of the running sum)."""
    state = filt.filter(y[0], filt.initialize(), n_transitions=1)
    lls, means, variances = [state.log_likelihood], [state.mean], [torch.diagonal(state.cov)]
    for t in range(1, y.shape[0]):
        new = filt.filter(y[t], state)
        lls.append(new.log_likelihood - state.log_likelihood)
        means.append(new.mean)
        variances.append(torch.diagonal(new.cov))
        state = new
    return FilterResult(
        log_likelihood=state.log_likelihood,
        step_log_likelihoods=torch.stack(lls),
        filter_means=torch.stack(means),
        filter_variances=torch.stack(variances),
        latest_state=state,
        states=None,
    )
