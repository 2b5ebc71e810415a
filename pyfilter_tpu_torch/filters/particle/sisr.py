"""SISR — sequential importance sampling with adaptive resampling.

Counterpart of ``pyfilter_tpu/filters/particle/sisr.py`` (single lane). The
JAX package gates the resample with a scalar ``lax.cond`` on the device; here
the gate is one host-side ``if`` per observation, the one device-to-host
sync of the step, which keeps the skip semantics: on the steps whose ESS is
healthy no resampling work is launched at all. Lane batches (the JAX
package's ``resample_lanes`` branch) are not ported yet.
"""

from __future__ import annotations

import torch

from ...utils import batched_gather, get_ess, log_likelihood
from ..state import ParticleFilterCorrection, ParticleFilterPrediction
from .base import ParticleFilter


class SISR(ParticleFilter):
    def predict(self, generator, state) -> ParticleFilterPrediction:
        """ESS-gated resampling: below ``ess_threshold * N`` the cloud
        resamples and its weights reset; otherwise it passes through with
        identity ancestor indices."""
        if self.batch_shape:
            raise NotImplementedError("SISR over lane batches is not ported yet")
        normalized = state.normalized_weights()
        ess = get_ess(normalized, normalized=True)
        ts_state = state.x
        if not bool(ess < self.resample_threshold):  # the host sync of the step
            return ParticleFilterPrediction(ts_state, state.log_weights, normalized, self._identity)

        self.n_resamples += 1
        if self._use_fused_resample(ts_state.value):
            new_vals, indices = self._fused_resample(generator, normalized, ts_state.value, normalized=True)
        else:
            indices = self.resampler(generator, normalized, normalized=True)
            new_vals = batched_gather(ts_state.value, indices, ts_state.event_ndim)
        return ParticleFilterPrediction(
            ts_state.copy(values=new_vals),
            torch.zeros_like(state.log_weights),
            torch.full_like(normalized, 1.0 / self.n_particles),
            indices,
        )

    def correct(self, generator, y, prediction) -> ParticleFilterCorrection:
        """Propose, accumulate weights, estimate the per-step log-likelihood."""
        x, inc_weights = self.proposal.sample_and_weight(generator, self.model, y, prediction)
        new_weights = inc_weights + prediction.log_weights
        ll = log_likelihood(inc_weights, prediction.normalized_weights)
        return ParticleFilterCorrection.from_weighted_particles(
            x, new_weights, ll, prediction.indices, compute_moments=self.record_moments
        )
