"""APF — the auxiliary particle filter of Pitt & Shephard.

Counterpart of ``pyfilter_tpu/filters/particle/apf.py``. The APF resamples
on every correction: a lane batch (SMC²'s parameter lanes) goes through
``ops.systematic_expand_lanes``, which pulls the state values AND the
pre-weights through one expansion; with ``differentiable`` both carry a
gradient back through it.
"""

from __future__ import annotations

import torch

from ..state import ParticleFilterCorrection, ParticleFilterPrediction
from .base import ParticleFilter


class APF(ParticleFilter):
    #: corrections run by every APF since the count was last set to 0 (a
    #: class-level host counter: inference rebuilds the filter on every
    #: parameter update, so an instance counter would not see the run)
    corrections = 0

    def predict(self, generator, state) -> ParticleFilterPrediction:
        """Pass-through: the APF resamples inside :meth:`correct`."""
        return ParticleFilterPrediction(state.x, state.log_weights, self._normalize(state.log_weights), self._identity)

    def correct(self, generator, y, prediction) -> ParticleFilterCorrection:
        """Pre-weight with :math:`p(y_t | E[x_t])`, resample on the combined
        weights, propose from the resampled particles and subtract the
        gathered pre-weights; the per-step log-likelihood adds the auxiliary
        normaliser."""
        ts_state = prediction.get_timeseries_state()
        pre_weights = self.proposal.pre_weight(self.model, y, ts_state)
        resample_weights = pre_weights + prediction.log_weights

        (res_vals, res_prew), indices = self._resample_cloud(generator, resample_weights,
                                                             (ts_state.value, pre_weights))
        if self.differentiable:
            corr = self._ancestor_correction(resample_weights, indices)
            resampled = ParticleFilterPrediction(ts_state.copy(values=res_vals), corr, torch.softmax(corr, dim=0),
                                                 indices)
        else:
            corr = None
            zeros = torch.zeros_like(resample_weights)
            resampled = ParticleFilterPrediction(
                ts_state.copy(values=res_vals), zeros, zeros + 1.0 / self._n_total, indices
            )

        x, inc_weights = self.proposal.sample_and_weight(generator, self.model, y, resampled)
        weights = inc_weights - res_prew
        if corr is not None:
            weights = weights + corr
        # log(sum w * exp(pre)) as the JAX package writes it (no max shift),
        # so the two packages round alike
        aux = torch.sum(prediction.normalized_weights * torch.exp(pre_weights), dim=0)
        aux_norm = torch.log(aux if self._shard is None else self._shard.psum(aux))
        ll = self._log_likelihood(weights) + aux_norm
        APF.corrections += 1
        return self._correction(x, weights, ll, indices)
