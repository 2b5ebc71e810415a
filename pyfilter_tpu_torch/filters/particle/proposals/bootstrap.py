"""Bootstrap proposal — propose from the transition density.

Counterpart of ``pyfilter_tpu/filters/particle/proposals/bootstrap.py``.
"""

from __future__ import annotations

from .base import Proposal


class Bootstrap(Proposal):
    """q = p(x_t | x_{t-1}); incremental weight = log p(y_t | x_t)."""

    def sample_and_weight(self, generator, model, y, prediction):
        new_x = model.hidden.propagate(generator, prediction.get_timeseries_state())
        return new_x, model.build_density(new_x).log_prob(y)
