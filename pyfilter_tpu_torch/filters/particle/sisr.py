"""SISR — sequential importance sampling with adaptive resampling.

Counterpart of ``pyfilter_tpu/filters/particle/sisr.py``. A single lane is
gated by one host-side ``if`` per observation (the JAX package's scalar
``lax.cond``), the one device-to-host sync of the step, which keeps the skip
semantics: on the steps whose ESS is healthy no resampling work is launched
at all. A lane batch resamples every lane in one fused pass (the lane kernel
on the card) and keeps the result on the lanes whose ESS is low, a per-lane
``where`` on the device with no host sync, as the JAX package's
``resample_lanes`` branch does.
"""

from __future__ import annotations

import torch

from ...tracing import span
from ..state import ParticleFilterCorrection, ParticleFilterPrediction
from .base import ParticleFilter


class SISR(ParticleFilter):
    def predict(self, generator, state) -> ParticleFilterPrediction:
        """ESS-gated resampling: below ``ess_threshold * N`` a lane resamples
        and its weights reset (to the zero-valued ancestor correction when
        ``differentiable``); otherwise it passes through with identity
        ancestor indices (never the previous step's, which the fixed-lag
        smoother would trace)."""
        normalized = self._normalize(state.log_weights)
        ess = self._ess(normalized)
        ts_state = state.x
        if self.batch_shape:
            return self._resample_lanes(generator, state, normalized, ess)
        with span("filter.gate"):
            fire = bool(ess < self.resample_threshold)  # the host sync of the step
        self.n_host_syncs += 1
        if not fire:
            return ParticleFilterPrediction(ts_state, state.log_weights, normalized, self._identity)

        self.n_resamples += 1
        new_vals, indices = self._resample(generator, normalized, ts_state)
        if self.differentiable:
            corr = self._ancestor_correction(state.log_weights, indices)
            return ParticleFilterPrediction(ts_state.copy(values=new_vals), corr, torch.softmax(corr, dim=0), indices)
        return ParticleFilterPrediction(
            ts_state.copy(values=new_vals),
            torch.zeros_like(state.log_weights),
            torch.full_like(normalized, 1.0 / self._n_total),
            indices,
        )

    def _resample(self, generator, normalized, ts_state):
        """Resampled values and ancestor indices (:meth:`_resample_cloud`)."""
        return self._resample_cloud(generator, normalized, ts_state.value, normalized=True)

    def _resample_lanes(self, generator, state, normalized, ess) -> ParticleFilterPrediction:
        """Every lane resampled at once (one fire), kept where the lane's ESS
        is below the threshold."""
        ts_state = state.x
        self.n_resamples += 1
        resampled, fresh_idx = self._resample(generator, normalized, ts_state)
        mask = ess < self.resample_threshold  # (*batch), broadcast over the particle axis
        vals_mask = mask.reshape(mask.shape + (1,) * ts_state.event_ndim)
        if self.differentiable:
            corr = self._ancestor_correction(state.log_weights, fresh_idx)
            reset_w, reset_norm = corr, torch.softmax(corr, dim=0)
        else:
            reset_w, reset_norm = 0.0, 1.0 / self._n_total
        return ParticleFilterPrediction(
            ts_state.copy(values=torch.where(vals_mask, resampled, ts_state.value)),
            torch.where(mask, reset_w, state.log_weights),
            torch.where(mask, reset_norm, normalized),
            torch.where(mask, fresh_idx, self._identity),
        )

    def correct(self, generator, y, prediction) -> ParticleFilterCorrection:
        """Propose, accumulate weights, estimate the per-step log-likelihood."""
        x, inc_weights = self.proposal.sample_and_weight(generator, self.model, y, prediction)
        new_weights = inc_weights + prediction.log_weights
        ll = self._log_likelihood(inc_weights, prediction.normalized_weights)
        return self._correction(x, new_weights, ll, prediction.indices)
