"""Gaussian-sum filter: a weighted bank of EKF/UKF components.

Counterpart of ``pyfilter_tpu/filters/gsf.py``. The posterior is a
K-component Gaussian mixture (Alspach & Sorenson 1972), each component
propagated by a base Gaussian filter and re-weighted by its own innovation
likelihood; the component axis is one ``torch.func.vmap`` over the base
filter's step. The initial mixture matches the prior's moments exactly: the
components split along the top eigenvector of ``P0`` (whose sign ``eigh``
chooses) with a compensated shared covariance.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ._lane import lane_concat, lane_exchange, lane_resample, lane_vmap_batch_filter
from ._masked import filter_device, observations
from .ekf import ExtendedKalmanFilter
from .result import FilterResult
from .ukf import CubatureKalmanFilter, UnscentedKalmanFilter

#: per-component Gaussian step engines (the Gaussian-step protocol:
#: initialize_moments / predict_moments / correct_moments)
GAUSSIAN_BASES = {
    "ekf": ExtendedKalmanFilter,
    "ukf": UnscentedKalmanFilter,
    "ckf": CubatureKalmanFilter,
}


def mixture_moments(log_w, means, covs):
    """Mean and the diagonal of the covariance of a Gaussian mixture
    (weights ``exp(log_w)`` ``(K,)``, ``means`` ``(K, d)``, ``covs`` ``(K, d,
    d)``), by the law of total variance."""
    w = torch.exp(log_w)
    m_bar = w @ means
    within = w @ torch.diagonal(covs, dim1=-2, dim2=-1)
    return m_bar, within + w @ (means - m_bar) ** 2


class GSFState(NamedTuple):
    means: torch.Tensor  # (K, d)
    covs: torch.Tensor  # (K, d, d)
    log_weights: torch.Tensor  # (K,) normalized: logsumexp == 0
    log_likelihood: torch.Tensor
    time_index: float

    def get_mean(self):
        """Mixture mean: sum_k w_k m_k."""
        return torch.exp(self.log_weights) @ self.means

    def get_variance(self):
        """Diagonal of the mixture covariance (law of total variance)."""
        return mixture_moments(self.log_weights, self.means, self.covs)[1]

    def map_component(self):
        """(mean, cov) of the highest-weight component, the tracked mode."""
        k = torch.argmax(self.log_weights)
        return self.means[k], self.covs[k]

    # -- lane surgery (leaves lane-leading under the marginal adapter's vmap) --
    def exchange(self, other: "GSFState", mask) -> "GSFState":
        return lane_exchange(self, other, mask)

    def resample(self, indices, entire_history: bool = True) -> "GSFState":
        return lane_resample(self, indices)

    @staticmethod
    def lane_concat(states) -> "GSFState":
        return lane_concat(GSFState, states)


class GaussianSumFilter:
    """Bank of ``n_components`` EKF/UKF/CKF filters over a
    :class:`StateSpaceModel` on ``device`` (the card unless ``device="cpu"``;
    the model's). ``base`` picks the component filter (extra keywords pass
    to it); ``spread`` in [0, 1) is the share of the prior's top-eigenvector
    variance the component means carry at the start; ``batch_shape=(K,)``
    runs K independent banks over lane-batched model leaves (one vmap)."""

    def __init__(self, model, n_components: int = 4, base: str = "ekf", spread: float = 0.5, batch_shape=(),
                 device=None, **base_kwargs):
        if n_components < 1:
            raise ValueError("n_components must be >= 1")
        if not 0.0 <= spread < 1.0:
            raise ValueError("spread must be in [0, 1)")
        if base not in GAUSSIAN_BASES:
            raise ValueError(f"unknown base filter {base!r} (want one of {sorted(GAUSSIAN_BASES)})")
        self.device = filter_device(model, device)
        self.base = GAUSSIAN_BASES[base](model, device=self.device, **base_kwargs)
        self.base_name = base
        self._base_kwargs = base_kwargs
        self.model = model
        self.n_components = int(n_components)
        self.spread = float(spread)
        self.batch_shape = tuple(batch_shape)

    # -- init -------------------------------------------------------------------
    def initialize(self) -> GSFState:
        """The prior ``N(m0, P0)`` split into K moment-matched components
        along the top eigenvector of ``P0``: equal weights, symmetric
        standardized offsets with ``mean(a_k^2) = spread``, the shared
        covariance ``P0 - spread * lam v v'``."""
        k = self.n_components
        m0, p0 = self.base.initialize_moments()
        if k == 1:
            means, covs = m0[None], p0[None]
        else:
            lam, vecs = torch.linalg.eigh(p0)
            lam_max, v = lam[-1], vecs[:, -1]
            u = torch.linspace(-1.0, 1.0, k, device=m0.device)
            a = u * torch.sqrt(self.spread / torch.mean(u * u))
            means = m0[None] + a[:, None] * torch.sqrt(lam_max) * v[None]
            covs = (p0 - self.spread * lam_max * torch.outer(v, v)).expand((k,) + tuple(p0.shape))
        log_w = torch.full((k,), -math.log(float(k)), device=m0.device)
        return GSFState(means, covs, log_w, torch.zeros((), device=m0.device), 0.0)

    # -- one move -----------------------------------------------------------------
    def filter(self, y_t, state: GSFState, n_transitions: int = None) -> GSFState:
        """One predict + update move of the whole bank. A numerically dead
        component (NaN likelihood: a factor that failed) is demoted to weight
        -inf; when every component dies the weights stay and the step's
        increment is -inf. An all-NaN observation leaves the weights and adds
        exactly 0."""
        y_t = torch.atleast_1d(torch.as_tensor(y_t, dtype=torch.float32, device=self.device))
        if n_transitions is None:
            n_transitions = int(self.model.observe_every_step)
        means, covs, t = state.means, state.covs, state.time_index
        for _ in range(n_transitions):
            means, covs, _ = torch.func.vmap(lambda m, p: self.base.predict_moments(m, p, t))(means, covs)
            t = t + 1.0
        means, covs, ll_k = torch.func.vmap(lambda m, p: self.base.correct_moments(m, p, y_t, t))(means, covs)

        ll_k = torch.where(torch.isfinite(ll_k), ll_k, -math.inf)
        logits = state.log_weights + ll_k
        norm = torch.logsumexp(logits, dim=0)
        log_w = torch.where(torch.isfinite(norm), logits - norm, state.log_weights)
        gap = torch.isnan(y_t).all()
        step_ll = torch.where(gap, 0.0, norm)
        log_w = torch.where(gap, state.log_weights, log_w)
        return GSFState(means, covs, log_w, state.log_likelihood + step_ll, t)

    # -- whole sequence ------------------------------------------------------------
    def batch_filter(self, y) -> FilterResult:
        """Gaussian-sum filtering over the whole sequence; the recorded
        moments are the MIXTURE's (``latest_state.map_component()`` gives the
        tracked mode when the posterior is multimodal)."""
        if self.batch_shape:
            return lane_vmap_batch_filter(
                lambda mdl: GaussianSumFilter(mdl, self.n_components, self.base_name, self.spread,
                                              device=self.device, **self._base_kwargs),
                self.model, self.batch_shape, y,
            )
        y = observations(y, self.device)
        state = self.filter(y[0], self.initialize(), n_transitions=1)
        lls, moments = [state.log_likelihood], [(state.get_mean(), state.get_variance())]
        for t in range(1, y.shape[0]):
            new = self.filter(y[t], state)
            lls.append(new.log_likelihood - state.log_likelihood)
            moments.append((new.get_mean(), new.get_variance()))
            state = new
        means, variances = (torch.stack(parts) for parts in zip(*moments))
        return FilterResult(state.log_likelihood, torch.stack(lls), means, variances, state, None)

    # -- smoothing ------------------------------------------------------------------
    def smooth(self, y):
        """Gaussian-sum RTS smoother: each component runs its base filter's
        RTS smoother from its own split start (the component index is a
        global latent variable), weighted by the FINAL filtered weights.
        Returns ``(means (T, d), variances (T, d), (component means (K, T,
        d), covs (K, T, d, d), log_weights (K,)))``."""
        init = self.initialize()
        log_w = self.batch_filter(y).latest_state.log_weights
        sm_means, sm_covs = torch.func.vmap(
            lambda m0, p0: self.base.smooth(y, initial_moments=(m0, p0))
        )(init.means, init.covs)
        w = torch.exp(log_w)
        mix_mean = torch.einsum("k,ktd->td", w, sm_means)
        dev = sm_means - mix_mean[None]
        mix_var = torch.einsum("k,ktd->td", w, torch.diagonal(sm_covs, dim1=-2, dim2=-1)) + torch.einsum(
            "k,ktd->td", w, dev * dev)
        return mix_mean, mix_var, (sm_means, sm_covs, log_w)
