"""Proposal base class.

Counterpart of ``pyfilter_tpu/filters/particle/proposals/base.py``: proposals
hold no model; the model is passed to every call. ``pre_weight`` is the
APF's pre-weight at the affine conditional mean.
"""

from __future__ import annotations

import torch

from ....timeseries import TimeseriesState
from ...state import ParticleFilterPrediction


class Proposal:
    """Base proposal. Subclasses implement :meth:`sample_and_weight`."""

    def sample_and_weight(
        self, generator, model, y: torch.Tensor, prediction: ParticleFilterPrediction
    ) -> tuple[TimeseriesState, torch.Tensor]:
        """Sample new particles and their incremental log-weights."""
        raise NotImplementedError

    def pre_weight(self, model, y: torch.Tensor, x: TimeseriesState) -> torch.Tensor:
        """APF pre-weights :math:`\\log p(y_t | E[x_t | x_{t-1}])`: the
        observation density at the hidden process's affine mean step."""
        loc, _ = model.hidden.mean_scale(x)
        return model.build_density(x.propagate_from(values=loc)).log_prob(y)
