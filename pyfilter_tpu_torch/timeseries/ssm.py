"""State-space model: hidden process + observation density builder.

Counterpart of ``pyfilter_tpu/timeseries/ssm.py``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..distributions import Distribution
from .process import StructuralStochasticProcess
from .state import TimeseriesState


class StateSpaceModel:
    r"""Hidden Markov process observed through ``observation_builder(x_state,
    *parameters) -> Distribution``; ``observe_every_step`` hidden sub-steps
    pass between observations."""

    def __init__(
        self,
        hidden: StructuralStochasticProcess,
        observation_builder: Callable,
        parameters: tuple = (),
        observe_every_step: int = 1,
    ):
        self.hidden = hidden
        self.observation_builder = observation_builder
        self.parameters = tuple(parameters)
        self.observe_every_step = int(observe_every_step)

    @property
    def device(self) -> torch.device:
        return self.hidden.device

    def build_density(self, x: TimeseriesState) -> Distribution:
        """Observation density p(y_t | x_t)."""
        return self.observation_builder(x, *self.parameters)

    def initial_sample(self, generator, shape=()) -> TimeseriesState:
        return self.hidden.initial_sample(generator, shape)
