"""Proposal base class.

Counterpart of ``pyfilter_tpu/filters/particle/proposals/base.py``: proposals
hold no model; the model is passed to every call. ``pre_weight`` is the
APF's pre-weight at the state ``pre_weight_func`` gives (the affine
conditional mean by default).
"""

from __future__ import annotations

from typing import Callable

import torch

from ....timeseries import TimeseriesState
from ...state import ParticleFilterPrediction


def _affine_pre_weight_state(hidden, state: TimeseriesState) -> TimeseriesState:
    """The state propagated to its conditional mean."""
    loc, _ = hidden.mean_scale(state)
    return state.propagate_from(values=loc)


def get_pre_weight_func(func, hidden) -> Callable:
    """The APF pre-weighting state function: ``func`` when given, else the
    affine default."""
    if func is not None:
        return func
    if hasattr(hidden, "mean_scale"):
        return _affine_pre_weight_state
    raise TypeError("no pre-defined pre-weight function for this process; pass pre_weight_func")


class Proposal:
    """Base proposal. Subclasses implement :meth:`sample_and_weight`.
    ``pre_weight_func(hidden, state) -> TimeseriesState`` sets the APF
    pre-weighting state."""

    pre_weight_func: Callable | None = None

    def __init__(self, pre_weight_func: Callable | None = None):
        self.pre_weight_func = pre_weight_func

    def sample_and_weight(
        self, generator, model, y: torch.Tensor, prediction: ParticleFilterPrediction
    ) -> tuple[TimeseriesState, torch.Tensor]:
        """Sample new particles and their incremental log-weights."""
        raise NotImplementedError

    def pre_weight(self, model, y: torch.Tensor, x: TimeseriesState) -> torch.Tensor:
        """APF pre-weights :math:`\\log p(y_t | E[x_t | x_{t-1}])`."""
        new_state = get_pre_weight_func(self.pre_weight_func, model.hidden)(model.hidden, x)
        return model.build_density(new_state).log_prob(y)

    def _weight_with_kernel(self, model, y, x_dist, x_new: TimeseriesState, kernel) -> torch.Tensor:
        """Importance weight ``log p(y|x') + log p(x'|x) - log q(x')``."""
        y_dist = model.build_density(x_new)
        return y_dist.log_prob(y) + x_dist.log_prob(x_new.value) - kernel.log_prob(x_new.value)

    def copy(self) -> "Proposal":
        return self
