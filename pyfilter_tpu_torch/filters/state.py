"""Filter states.

Counterpart of ``pyfilter_tpu/filters/state.py``. Axis convention: particle
axis 0, lane axes next, event axes last; ``log_weights`` / ``prev_indices``
are ``(N, *batch)``, ``log_likelihood`` / ``mean`` / ``variance`` ``(*batch, ...)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..distributions import Distribution, MultivariateNormal, Normal
from ..timeseries import TimeseriesState
from ..utils import batched_gather, get_mean_and_variance, normalize


class ParticleFilterPrediction(NamedTuple):
    """Predicted (pre-correction) state: the possibly resampled particles, the
    carried log-weights (0 after a resample), their normalized probabilities
    and the ancestor indices used."""

    x: TimeseriesState
    log_weights: torch.Tensor
    normalized_weights: torch.Tensor
    indices: torch.Tensor

    def get_timeseries_state(self) -> TimeseriesState:
        return self.x

    def create_state_from_prediction(self, generator, model, compute_moments: bool = True,
                                     shard=None) -> "ParticleFilterCorrection":
        """Propagate the hidden process without correcting (the all-NaN skip);
        ``shard`` as :meth:`ParticleFilterCorrection.from_weighted_particles`."""
        x_new = model.hidden.propagate(generator, self.x)
        ll = torch.zeros(self.normalized_weights.shape[1:], dtype=self.normalized_weights.dtype,
                         device=self.normalized_weights.device)
        return ParticleFilterCorrection.from_weighted_particles(
            x_new, self.log_weights, ll, self.indices, compute_moments=compute_moments, shard=shard
        )

    def get_predictive_density(self, model, generator=None, approximate: bool = False) -> Distribution:
        """The hidden process's density one step ahead: exactly, the
        transition density of every particle; approximately, a Gaussian fitted
        to the weighted cloud propagated once from ``generator`` (``Normal``
        for a scalar state, ``MultivariateNormal`` from the weighted
        covariance for a vector state), with no particle axis."""
        if not approximate:
            return model.hidden.build_density(self.x)
        x_new = model.hidden.propagate(generator, self.x)
        event_ndim = model.hidden.event_ndim
        mean, cov = get_mean_and_variance(x_new.value, self.normalized_weights, event_ndim=event_ndim,
                                          covariance=True)
        if event_ndim == 0:
            return Normal(mean, torch.sqrt(cov))
        return MultivariateNormal(mean, covariance_matrix=cov)


class ParticleFilterCorrection(NamedTuple):
    """Corrected state. ``log_likelihood`` is the per-step increment
    :math:`\\log \\hat p(y_t | y_{1:t-1})`; ``mean``/``variance`` the weighted
    filter moments (zeros when the filter does not record them)."""

    x: TimeseriesState
    log_weights: torch.Tensor
    log_likelihood: torch.Tensor
    prev_indices: torch.Tensor
    mean: torch.Tensor
    variance: torch.Tensor

    @classmethod
    def from_weighted_particles(
        cls, x: TimeseriesState, log_weights, log_likelihood, prev_indices, compute_moments: bool = True, shard=None
    ):
        """The corrected state with its weighted moments; ``shard`` (a
        ``parallel`` particle shard) makes them the whole cloud's: the
        probabilities normalized over every rank's particles and each local
        weighted sum all-reduced."""
        if compute_moments:
            probs = normalize(log_weights) if shard is None else shard.normalize(log_weights)
            mean, var = get_mean_and_variance(x.value, probs, event_ndim=x.event_ndim,
                                              reduce=None if shard is None else shard.psum)
        else:
            mean = torch.zeros_like(log_likelihood)
            var = torch.zeros_like(log_likelihood)
        return cls(x, log_weights, log_likelihood, prev_indices, mean, var)

    @property
    def timeseries_state(self) -> TimeseriesState:
        return self.x

    def get_timeseries_state(self) -> TimeseriesState:
        return self.x

    def get_loglikelihood(self) -> torch.Tensor:
        return self.log_likelihood

    def get_mean(self) -> torch.Tensor:
        return self.mean

    def get_variance(self) -> torch.Tensor:
        return self.variance

    def normalized_weights(self) -> torch.Tensor:
        return normalize(self.log_weights)

    def get_covariance(self) -> torch.Tensor:
        """Weighted variance of a scalar cloud, covariance ``(*batch, d, d)``
        of a vector one."""
        ev = self.x.event_ndim
        _, cov = get_mean_and_variance(self.x.value, self.normalized_weights(), event_ndim=ev, covariance=ev == 1)
        return cov

    def predict_path(self, generator, model, num_steps: int):
        """``num_steps`` transitions and observations simulated onward from
        the corrected cloud."""
        return model.sample_states(generator, num_steps, x_0=self.x)

    # -- lane surgery (JAX filters/state.py:139-202) ---------------------------
    def resample(self, indices: torch.Tensor, lanes=None) -> "ParticleFilterCorrection":
        """Gather the LANES by ``indices`` ``(K,)``: lane axis 1 of the
        particle-indexed leaves, lane axis 0 of the per-lane log-likelihood,
        mean and variance. The particle axis is untouched. With ``lanes`` (a
        ``parallel`` lane shard) the state holds this rank's lanes and
        ``indices`` are its new lanes' global ids: the leaves are gathered
        first."""
        def take(t, dim):
            return t.index_select(dim, indices.long()) if lanes is None else lanes.take(t, indices, dim)

        return ParticleFilterCorrection(
            self.x.copy(values=take(self.x.value, 1)),
            take(self.log_weights, 1),
            take(self.log_likelihood, 0),
            take(self.prev_indices, 1),
            take(self.mean, 0),
            take(self.variance, 0),
        )

    def exchange(self, other: "ParticleFilterCorrection", mask: torch.Tensor) -> "ParticleFilterCorrection":
        """Lanes where ``mask`` ``(K,)`` is True take ``other``'s leaves."""

        def mix(mine, theirs, lead):
            m = mask.reshape((1,) * lead + tuple(mask.shape) + (1,) * (mine.dim() - lead - mask.dim()))
            return torch.where(m, theirs, mine)

        return ParticleFilterCorrection(
            self.x.copy(values=mix(self.x.value, other.x.value, 1)),
            mix(self.log_weights, other.log_weights, 1),
            mix(self.log_likelihood, other.log_likelihood, 0),
            mix(self.prev_indices, other.prev_indices, 1),
            mix(self.mean, other.mean, 0),
            mix(self.variance, other.variance, 0),
        )

    @staticmethod
    def lane_concat(states) -> "ParticleFilterCorrection":
        """Several corrections concatenated along the LANE axis (axis 1 of
        the particle-indexed leaves, axis 0 of the per-lane ones); the time
        index is the first state's."""
        s0 = states[0]
        return ParticleFilterCorrection(
            s0.x.copy(values=torch.cat([s.x.value for s in states], dim=1)),
            torch.cat([s.log_weights for s in states], dim=1),
            torch.cat([s.log_likelihood for s in states], dim=0),
            torch.cat([s.prev_indices for s in states], dim=1),
            torch.cat([s.mean for s in states], dim=0),
            torch.cat([s.variance for s in states], dim=0),
        )

    def resample_particles(self, indices: torch.Tensor) -> "ParticleFilterCorrection":
        """Gather the PARTICLE axis by ``indices`` ``(N, *batch)``: the cloud
        takes zero log-weights, ``indices`` as its ancestry and moments
        recomputed from it; the log-likelihood is kept."""
        new_x = self.x.copy(values=batched_gather(self.x.value, indices, self.x.event_ndim))
        return ParticleFilterCorrection.from_weighted_particles(
            new_x, torch.zeros_like(self.log_weights), self.log_likelihood, indices.to(self.prev_indices.dtype)
        )
