"""Joint processes: independent processes stacked into one vector-valued
process.

Counterpart of ``pyfilter_tpu/timeseries/joint.py`` (stochproc's
``joint_process``; the reference's tests join two scalar random walks into a
2-D process filtered against a 2-D Kalman oracle). Each component owns the
slice ``[start, start + size)`` of the event axis; a scalar component has
width 1.
"""

from __future__ import annotations

import torch

from ..distributions import Distribution
from .process import AffineProcess, StructuralStochasticProcess
from .state import TimeseriesState


def _slices(event_ndims_sizes) -> tuple:
    """``(start, size, event_ndim)`` of each component, in order."""
    out, start = [], 0
    for ev, size in event_ndims_sizes:
        out.append((start, size, ev))
        start += size
    return tuple(out)


class JointDistribution(Distribution):
    """Product of independent distributions over one concatenated event
    vector; ``slices`` places each component on the event axis."""

    def __init__(self, dists: tuple, slices: tuple):
        self.dists = tuple(dists)
        self.slices = tuple(slices)

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(*(tuple(d.batch_shape) for d in self.dists)))

    @property
    def event_shape(self):
        return (sum(size for _, size, _ in self.slices),)

    def _concat(self, parts, lead=()) -> torch.Tensor:
        """Component values (scalar ones widened to 1) side by side."""
        cols = []
        for p, (_, size, ev) in zip(parts, self.slices):
            p = p[..., None] if ev == 0 else p
            cols.append(p.expand(tuple(lead) + self.batch_shape + (size,)))
        return torch.cat(cols, dim=-1)

    def sample(self, generator, sample_shape=()):
        """One draw per component from ``generator``, in component order."""
        return self._concat([d.sample(generator, sample_shape) for d in self.dists], sample_shape)

    def log_prob(self, value):
        total = 0.0
        for d, (start, size, ev) in zip(self.dists, self.slices):
            v = value[..., start:start + size]
            total = total + d.log_prob(v[..., 0] if ev == 0 else v)
        return total

    @property
    def mean(self):
        return self._concat([d.mean for d in self.dists])

    @property
    def variance(self):
        return self._concat([d.variance for d in self.dists])


class JointProcess(StructuralStochasticProcess):
    """Named sub-processes stacked into one vector-valued Markov process,
    with ``mean_scale`` when every sub-process is affine (so the linear and
    linearized proposals apply to it)."""

    event_ndim = 1

    def __init__(self, **processes: StructuralStochasticProcess):
        self.names = tuple(processes)
        self.processes = tuple(processes.values())
        self._slices = _slices((p.event_ndim, 1 if p.event_ndim == 0 else p.event_shape[0]) for p in self.processes)

    @property
    def device(self) -> torch.device:
        return self.processes[0].device

    @property
    def event_shape(self):
        return (sum(size for _, size, _ in self._slices),)

    def _sub_state(self, x: TimeseriesState, i: int) -> TimeseriesState:
        start, size, ev = self._slices[i]
        v = x.value[..., start:start + size]
        return TimeseriesState(x.time_index, v[..., 0] if ev == 0 else v, ev)

    def initial_distribution(self) -> JointDistribution:
        return JointDistribution(tuple(p.initial_distribution() for p in self.processes), self._slices)

    def build_density(self, x: TimeseriesState) -> JointDistribution:
        dists = tuple(p.build_density(self._sub_state(x, i)) for i, p in enumerate(self.processes))
        return JointDistribution(dists, self._slices)

    def mean_scale(self, x: TimeseriesState) -> tuple:
        """Each affine sub-process's drift and diffusion, side by side."""
        means, scales = [], []
        batch = x.batch_shape
        for i, p in enumerate(self.processes):
            if not isinstance(p, AffineProcess):
                raise TypeError("mean_scale requires all sub-processes to be affine")
            m, s = p.mean_scale(self._sub_state(x, i))
            _, size, ev = self._slices[i]
            if ev == 0:
                m, s = m[..., None], s[..., None]
            means.append(m.expand(batch + (size,)))
            scales.append(s.expand(batch + (size,)))
        return torch.cat(means, dim=-1), torch.cat(scales, dim=-1)


def joint_process(**processes) -> JointProcess:
    """Named processes combined into one joint process."""
    return JointProcess(**processes)
