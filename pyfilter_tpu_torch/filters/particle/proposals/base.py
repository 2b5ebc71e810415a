"""Proposal base class.

Counterpart of ``pyfilter_tpu/filters/particle/proposals/base.py``: proposals
hold no model; the model is passed to every call.
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
