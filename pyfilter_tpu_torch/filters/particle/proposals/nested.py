"""Nested proposal of Naesseth et al.

Counterpart of ``pyfilter_tpu/filters/particle/proposals/nested.py``: draw
``num_samples`` candidates per particle from the predictive density, pick
one per particle with probability proportional to its observation
likelihood, and weight by the log mean likelihood over the nest.
"""

from __future__ import annotations

import math

import torch

from ....utils import draws_after
from .base import Proposal


class NestedProposal(Proposal):
    def __init__(self, num_samples: int = 10, pre_weight_func=None):
        super().__init__(pre_weight_func)
        self.num_samples = int(num_samples)

    def sample_and_weight(self, generator, model, y, prediction):
        from .. import base  # the Gumbel seam (base imports the proposals)

        with draws_after(1):  # the samples' axis leads the cloud's
            samples = prediction.get_predictive_density(model).sample(generator, (self.num_samples,))
        temp_state = prediction.get_timeseries_state().propagate_from(values=samples)

        # the JAX package's guard, jnp.nan_to_num(nan=-inf, posinf=-inf), maps
        # -inf on to the lowest finite float afterwards: every non-finite
        # likelihood becomes that, so a nest with none finite picks uniformly
        lowest = torch.finfo(samples.dtype).min
        log_prob = torch.nan_to_num(model.build_density(temp_state).log_prob(y), nan=lowest, posinf=lowest,
                                    neginf=lowest)
        logits = log_prob - torch.logsumexp(log_prob, dim=0, keepdim=True)
        best = base.categorical(generator, torch.movedim(logits, 0, -1))  # (N, *batch)

        idx = best[None]
        if model.hidden.event_ndim > 0:
            idx = idx[..., None]
        best_particle = torch.gather(samples, 0, idx.expand((1,) + tuple(samples.shape[1:])))[0]
        inc_weight = torch.logsumexp(log_prob, dim=0) - math.log(self.num_samples)
        return temp_state.copy(values=best_particle), inc_weight
