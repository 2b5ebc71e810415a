"""GPF — the Gaussian particle filter of Kotecha & Djuric.

Counterpart of ``pyfilter_tpu/filters/particle/gpf.py``. It never
resamples, so it launches no resample kernel: every step carries the cloud
into a proposal that draws from a moment-matched Gaussian predictive
(``GaussianProposal`` unless told otherwise).
"""

from __future__ import annotations

from ...utils import log_likelihood
from ..state import ParticleFilterCorrection, ParticleFilterPrediction
from .base import ParticleFilter
from .proposals import GaussianProposal


class GPF(ParticleFilter):
    def __init__(self, model, particles: int, proposal=None, **kwargs):
        super().__init__(model, particles, proposal=proposal if proposal is not None else GaussianProposal(), **kwargs)

    def predict(self, generator, state) -> ParticleFilterPrediction:
        """Pass-through: the weighted cloud as it stands."""
        return ParticleFilterPrediction(state.x, state.log_weights, state.normalized_weights(), state.prev_indices)

    def correct(self, generator, y, prediction) -> ParticleFilterCorrection:
        x_new, weights = self.proposal.sample_and_weight(generator, self.model, y, prediction)
        return ParticleFilterCorrection.from_weighted_particles(
            x_new, weights, log_likelihood(weights), prediction.indices, compute_moments=self.record_moments
        )
