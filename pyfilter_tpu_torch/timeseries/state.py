"""Timeseries state and sampled paths.

Counterpart of ``pyfilter_tpu/timeseries/state.py``. ``time_index`` is a
host-side Python float here: the process time advances on the host, so a
sub-step costs no device work for it. A state holding whole trajectories
(the VI bridge's) takes a tensor of times instead, shaped to broadcast
against the value's batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TimeseriesState:
    """A point-in-time state of a stochastic process: ``value`` has shape
    ``(*shape, *event)`` with ``event_ndim`` trailing event axes."""

    def __init__(self, time_index: float | torch.Tensor, value: torch.Tensor, event_ndim: int = 0):
        self.time_index = time_index if isinstance(time_index, torch.Tensor) else float(time_index)
        self.value = value
        self.event_ndim = event_ndim

    @property
    def event_shape(self) -> tuple:
        s = tuple(self.value.shape)
        return s[len(s) - self.event_ndim:]

    @property
    def batch_shape(self) -> tuple:
        s = tuple(self.value.shape)
        return s[: len(s) - self.event_ndim]

    def copy(self, values=None) -> "TimeseriesState":
        """New state at the same time index (optionally with new values)."""
        return TimeseriesState(self.time_index, self.value if values is None else values, self.event_ndim)

    def propagate_from(self, values, time_increment: float = 1.0) -> "TimeseriesState":
        """New state at ``time_index + time_increment`` with the given values."""
        return TimeseriesState(self.time_index + time_increment, values, self.event_ndim)


class StateSpacePath(NamedTuple):
    """A sampled trajectory of a state-space model: ``x`` and ``y`` stacked
    along the leading time axis, NaN observations on unobserved sub-steps;
    ``time_indexes`` ``(T,)`` on the host."""

    time_indexes: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor | None = None

    def get_paths(self):
        return self.x, self.y
