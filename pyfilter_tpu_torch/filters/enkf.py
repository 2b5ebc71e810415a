"""Ensemble Kalman filter: Monte-Carlo Gaussian filtering at scale.

Counterpart of ``pyfilter_tpu/filters/enkf.py``: the stochastic
(perturbed-observation) EnKF of Evensen propagates an ensemble of M states
through the model's own stochastic transition (``propagate_substeps``) and
replaces the importance weighting with a linear-Gaussian update built from
ensemble sample covariances, with Gaspari-Cohn localization and
multiplicative inflation. ``enrts_backward`` is the member-paired ensemble
RTS smoother shared with the ETKF.

Every draw comes from the caller's ``torch.Generator``: per step the
forecast's (the process's own draws), then the observation perturbation,
through :func:`_standard_normal` (the replay seam of the tests).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..timeseries import TimeseriesState
from ._lane import lane_concat, lane_exchange, lane_resample, lane_vmap_batch_filter
from ._masked import cholesky_or_nan, density_covariance, filter_device, masked_gaussian_update, observations, solve
from .result import FilterResult


def _standard_normal(generator, shape, like: torch.Tensor) -> torch.Tensor:
    """The observation perturbations' standard normals, ``like``'s dtype and
    device."""
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


class EnKFState(NamedTuple):
    ensemble: torch.Tensor  # (M, d), scalar states lifted
    log_likelihood: torch.Tensor
    time_index: float

    def get_mean(self):
        return self.ensemble.mean(dim=-2)

    def get_variance(self):
        return self.ensemble.var(dim=-2, correction=1)

    # -- lane surgery (leaves lane-leading under lane-vmapped passes) ----------
    def exchange(self, other: "EnKFState", mask) -> "EnKFState":
        return lane_exchange(self, other, mask)

    def resample(self, indices, entire_history: bool = True) -> "EnKFState":
        return lane_resample(self, indices)

    @staticmethod
    def lane_concat(states) -> "EnKFState":
        return lane_concat(EnKFState, states)


class _EnsembleBase:
    """The model boundary and the forecast shared by the stochastic and the
    square-root ensemble filters."""

    def _setup(self, model, ensemble_size, inflation, localization, batch_shape, device):
        self.device = filter_device(model, device)
        self.model = model
        self.ensemble_size = int(ensemble_size)
        self.inflation = float(inflation)
        self.localization = localization
        self.batch_shape = tuple(batch_shape)
        hidden = model.hidden
        self._ev = int(hidden.event_ndim)
        init = hidden.initial_distribution()
        self._d_x = int(init.event_shape[0]) if self._ev == 1 else 1
        self._d_y = int(model.event_shape[0]) if model.event_shape else 1

    def _state(self, ens, t) -> TimeseriesState:
        return TimeseriesState(t, ens if self._ev == 1 else ens[..., 0], self._ev)

    def _lift(self, values) -> torch.Tensor:
        v = values.to(torch.float32)
        return v if self._ev == 1 else v[..., None]

    def _obs_mean(self, ens, t) -> torch.Tensor:
        m = self.model.build_density(self._state(ens, t)).mean
        return m[:, None] if m.dim() == 1 else m  # (M, d_y)

    def _obs_cov_at(self, mean, t) -> torch.Tensor:
        """The observation noise covariance ``(d_y, d_y)`` at the state ``mean``."""
        d = self.model.build_density(self._state(mean[None], t))
        return density_covariance(d, self._d_y)

    def _members_mean(self, x) -> torch.Tensor:
        """The mean over the members (axis 0) of the whole ensemble; an
        ensemble sharded over ranks all-reduces it (``parallel.enkf``)."""
        return x.mean(dim=0)

    def _members_sum(self, t) -> torch.Tensor:
        """A sum over this process's members taken to the whole ensemble's
        (itself here; an all-reduce in ``parallel.enkf``)."""
        return t

    def initialize(self, generator) -> EnKFState:
        x0 = self.model.hidden.initial_sample(generator, (self.ensemble_size,))
        return EnKFState(self._lift(x0.value), torch.zeros((), device=self.device), 0.0)

    def _forecast(self, generator, ens, t, n_transitions: int):
        state = self.model.hidden.propagate_substeps(generator, self._state(ens, t), n_transitions)
        ens = self._lift(state.value)
        if self.inflation != 1.0:
            m = self._members_mean(ens)
            ens = m + self.inflation * (ens - m)
        return ens, state.time_index

    def _pass(self, generator, y):
        """The forward pass: per step the (forecast, analysis) pair and the
        analysis's step log-likelihood."""
        oes = int(self.model.observe_every_step)
        ens, t = self.initialize(generator).ensemble, 0.0
        out = []
        for i in range(y.shape[0]):
            fore, t = self._forecast(generator, ens, t, 1 if i == 0 else oes)
            ens, ll_t = self._analysis(generator, fore, y[i], t)
            out.append((fore, ens, ll_t, t))
        return out

    def batch_filter(self, generator, y) -> FilterResult:
        """Ensemble filtering over the whole sequence (time axis leading); the
        log-likelihood is the running sum of the Gaussian innovation densities.
        ``batch_shape=(K,)`` runs K independent ensembles over lane-batched
        model leaves (one vmap, each lane its own draws)."""
        if self.batch_shape:
            return lane_vmap_batch_filter(lambda mdl: self._lane_filter(mdl), self.model, self.batch_shape, y,
                                          generator=generator, stochastic=True)
        y = observations(y, self.device)
        steps = self._pass(generator, y)
        ll = torch.zeros((), device=self.device)
        lls = []
        for i, (_, ens, ll_t, _) in enumerate(steps):
            new = ll + ll_t
            lls.append(new if i == 0 else new - ll)
            ll = new
        anas = torch.stack([s[1] for s in steps])
        last = EnKFState(steps[-1][1], ll, steps[-1][3])
        return FilterResult(
            log_likelihood=ll,
            step_log_likelihoods=torch.stack(lls),
            filter_means=anas.mean(dim=1),
            filter_variances=anas.var(dim=1, correction=1),
            latest_state=last,
            states=None,
        )


class EnsembleKalmanFilter(_EnsembleBase):
    """Stochastic EnKF over a :class:`StateSpaceModel` on ``device`` (the card
    unless ``device="cpu"``; the model's). The observation density must
    expose ``mean`` and a noise covariance (evaluated at the ensemble mean);
    the transition only needs ``propagate``. ``inflation >= 1`` multiplies
    the forecast anomalies; ``localization`` (a :class:`Localization`) tapers
    the sample cross- and observation-space covariances."""

    def __init__(self, model, ensemble_size: int = 100, inflation: float = 1.0, localization=None,
                 batch_shape=(), device=None):
        self._setup(model, ensemble_size, inflation, localization, batch_shape, device)

    def _lane_filter(self, model):
        return type(self)(model, self.ensemble_size, self.inflation, self.localization, device=self.device)

    def _analysis(self, generator, ens, y_t, t):
        m_count = self.ensemble_size
        g = self._obs_mean(ens, t)  # (M, d_y) noise-free observation means
        g_bar = self._members_mean(g)
        b = g - g_bar
        mean_x = self._members_mean(ens)
        a = ens - mean_x
        r = self._obs_cov_at(mean_x, t)  # (d_y, d_y)
        c_yy = self._members_sum(b.T @ b) / (m_count - 1) + r
        c_xy = self._members_sum(a.T @ b) / (m_count - 1)
        if self.localization is not None:
            # Schur taper of the SAMPLE parts only: rho o (B'B/(M-1)) + R
            rho_yy = self.localization.rho_yy
            c_yy = c_yy * rho_yy + r * (1.0 - rho_yy)
            c_xy = c_xy * self.localization.rho_xy
        # the masked gain has zero columns at missing slots
        k_gain, _, ll_t, _ = masked_gaussian_update(y_t, g_bar, c_xy, c_yy)

        # perturbed observations: each member sees y + eps_i, eps_i ~ N(0, R)
        eps = _standard_normal(generator, tuple(g.shape), g) @ cholesky_or_nan(r).T
        y_safe = torch.where(torch.isnan(y_t), 0.0, y_t)
        return ens + (y_safe + eps - g) @ k_gain.T, ll_t

    def filter(self, generator, y_t, state: EnKFState, n_transitions: int = None) -> EnKFState:
        """One forecast + analysis move (the timing of ``KalmanFilter.filter``)."""
        y_t = torch.atleast_1d(torch.as_tensor(y_t, dtype=torch.float32, device=self.device))
        if n_transitions is None:
            n_transitions = int(self.model.observe_every_step)
        ens, t = self._forecast(generator, state.ensemble, state.time_index, n_transitions)
        ens, ll_t = self._analysis(generator, ens, y_t, t)
        return EnKFState(ens, state.log_likelihood + ll_t, t)

    def smooth(self, generator, y):
        """Ensemble RTS smoother (EnRTS, Raanes 2016) over the forward pass's
        (forecast, analysis) pairs: returns the smoothed ensemble ``(T, M, d)``."""
        steps = self._pass(generator, observations(y, self.device))
        fores = torch.stack([s[0] for s in steps])
        anas = torch.stack([s[1] for s in steps])
        return enrts_backward(fores, anas, self.ensemble_size)


def enrts_backward(fores, anas, m_count, rho_xx=None):
    """Member-paired ensemble RTS backward pass (Raanes 2016), shared by the
    stochastic EnKF and the ETKF/LETKF smoothers:

    ``x_t^s = x_t^a + G_t (x_{t+1}^s - x_{t+1}^f)``,
    ``G_t = Cov(x_t^a, x_{t+1}^f) Var(x_{t+1}^f)^{-1}``,

    each analysis member paired with its own forecast. Without a taper the
    solve is in the smaller space: an (M, M) ensemble-space system at M <= d
    (the (d, d) forecast covariance has rank M-1 there), the (d, d)
    state-space one at d < M. ``rho_xx`` (a state-state Gaspari-Cohn taper)
    tapers both covariances, which restores full rank, and solves in state
    space. ``fores`` / ``anas``: ``(T, M, d)``; returns ``(T, M, d)``."""
    if fores.shape[0] == 1:
        return anas
    m_eff = m_count - 1.0
    out = [anas[-1]]
    for t in range(fores.shape[0] - 2, -1, -1):
        ana_t, fore_next, smoothed_next = anas[t], fores[t + 1], out[-1]
        a = ana_t - ana_t.mean(dim=0)  # (M, d) analysis anomalies
        af = fore_next - fore_next.mean(dim=0)  # (M, d) forecast anomalies
        innov = smoothed_next - fore_next
        d = af.shape[1]
        if rho_xx is None and af.shape[0] <= d:  # M <= d
            eye_m = torch.eye(af.shape[0], dtype=af.dtype, device=af.device)
            k_mat = af @ af.T + m_eff * 1e-6 * eye_m
            out.append(ana_t + solve(k_mat, (innov @ af.T).T).T @ a)
            continue
        eye_d = torch.eye(d, dtype=af.dtype, device=af.device)
        if rho_xx is None:  # d < M: full-rank state-space solve
            c_xf = a.T @ af / m_eff
            p_f = af.T @ af / m_eff + 1e-6 * eye_d
        else:
            c_xf = rho_xx * (a.T @ af) / m_eff
            p_f = rho_xx * (af.T @ af) / m_eff + 1e-6 * eye_d
        gain = solve(p_f.T, c_xf.T).T  # C P^{-1}
        out.append(ana_t + innov @ gain.T)
    return torch.stack(out[::-1])
