"""State-space models: hidden process + observation density builder.

Counterpart of ``pyfilter_tpu/timeseries/ssm.py``: ``StateSpaceModel`` with
its ``sample_states`` (a Python loop over time), and
``LinearStateSpaceModel``, observed as ``Y = b + A X + s V``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..distributions import Distribution, Normal
from .models import parameter
from .process import StructuralStochasticProcess
from .state import StateSpacePath, TimeseriesState


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

    @property
    def event_shape(self) -> tuple:
        """The observation's event shape, read once from the density at a
        zero hidden state."""
        if getattr(self, "_event_shape", None) is None:
            init = self.hidden.initial_distribution()
            zero = torch.zeros(tuple(init.event_shape), device=self.device)
            x = TimeseriesState(0.0, zero, self.hidden.event_ndim)
            self._event_shape = tuple(self.build_density(x).event_shape)
        return self._event_shape

    def initial_sample(self, generator, shape=()) -> TimeseriesState:
        return self.hidden.initial_sample(generator, shape)

    def sample_states(self, generator, num_steps: int, x_0: TimeseriesState | None = None) -> StateSpacePath:
        """Simulate ``num_steps`` transitions and their observations from
        ``generator``; the observation of a sub-step that is not observed
        (process time not a multiple of ``observe_every_step``) is NaN."""
        x = self.hidden.initial_sample(generator) if x_0 is None else x_0
        times, xs, ys = [], [], []
        for _ in range(num_steps):
            x = self.hidden.propagate(generator, x)
            y = self.build_density(x).sample(generator)
            if x.time_index % self.observe_every_step != 0:
                y = torch.full_like(y, math.nan)
            times.append(x.time_index)
            xs.append(x.value)
            ys.append(y)
        return StateSpacePath(torch.tensor(times, dtype=torch.float32), torch.stack(xs), torch.stack(ys))


def _linear_observation(obs_event_ndim: int):
    def build(x, a, b, s):
        loc = b + torch.einsum("...ij,...j->...i", a, x.value) if a.dim() >= 2 else b + a * x.value
        return Normal(loc, s).to_event(obs_event_ndim)

    return build


class LinearStateSpaceModel(StateSpaceModel):
    r"""State-space model with linear-Gaussian observations
    :math:`Y_t = b + A X_t + s V_t`. ``parameters`` are ``(a, s)`` or
    ``(a, b, s)``, normalised to the latter (a missing offset is 0) as
    float32 tensors on the hidden process's device; ``event_shape`` is the
    observation's (``()`` or ``(d,)``)."""

    def __init__(self, hidden, parameters, event_shape=(), observe_every_step: int = 1):
        parameters = tuple(parameter(p, hidden.device) for p in parameters)
        if len(parameters) == 2:
            a, s = parameters
            parameters = (a, torch.zeros_like(s), s)
        elif len(parameters) != 3:
            raise ValueError("LinearStateSpaceModel takes (a, s) or (a, b, s)")
        self._event_shape = tuple(event_shape)
        super().__init__(hidden, _linear_observation(len(self._event_shape)), parameters, observe_every_step)
