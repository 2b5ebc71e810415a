"""Stochastic processes: the structural base, affine processes, their
Euler–Maruyama discretisation and the linear-Gaussian process.

Counterpart of ``pyfilter_tpu/timeseries/process.py``. Processes are plain
objects holding their parameter tensors; every draw takes an explicit
``torch.Generator``.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import torch

from ..distributions import Distribution, Independent, Normal
from ..utils import draws_after
from .affine import affine_transform
from .state import StateSpacePath, TimeseriesState


class StructuralStochasticProcess:
    """Markov process: initial distribution + one-step transition densities."""

    event_ndim: int = 0

    @property
    def n_dim(self) -> int:
        return self.event_ndim

    def initial_distribution(self) -> Distribution:
        raise NotImplementedError

    def initial_sample(self, generator, shape: Sequence[int] = ()) -> TimeseriesState:
        """Initial state with the given sample (particle) shape; lane axes the
        initial distribution already carries are not drawn again."""
        d = self.initial_distribution()
        shape = tuple(shape)
        bs = tuple(d.batch_shape)
        if bs and shape[len(shape) - len(bs):] == bs:
            sample_shape = shape[: len(shape) - len(bs)]
        else:
            sample_shape = shape
        return TimeseriesState(0.0, d.sample(generator, sample_shape), self.event_ndim)

    def build_density(self, x: TimeseriesState) -> Distribution:
        """Transition density p(x_{t+1} | x_t)."""
        raise NotImplementedError

    def propagate(self, generator, x: TimeseriesState) -> TimeseriesState:
        """Sample x_{t+1} ~ p(. | x_t); time advances by one step."""
        return x.propagate_from(values=self.build_density(x).sample(generator), time_increment=1.0)

    def propagate_substeps(self, generator, x: TimeseriesState, n: int) -> TimeseriesState:
        """``n`` propagation steps (the ``observe_every_step`` sub-step loop)."""
        for _ in range(n):
            x = self.propagate(generator, x)
        return x

    def sample_states(self, generator, num_steps: int, x_0: TimeseriesState | None = None) -> StateSpacePath:
        """A trajectory of ``num_steps`` transitions (a Python loop over
        time), from ``x_0`` or an initial draw."""
        x = self.initial_sample(generator) if x_0 is None else x_0
        times, values = [], []
        for _ in range(num_steps):
            x = self.propagate(generator, x)
            times.append(x.time_index)
            values.append(x.value)
        return StateSpacePath(torch.tensor(times, dtype=torch.float32), torch.stack(values), None)

    def expand_initial(self, generator, shape) -> TimeseriesState:
        return self.initial_sample(generator, shape)


class AffineProcess(StructuralStochasticProcess):
    r"""Affine process :math:`X_{t+1} = f(X_t) + g(X_t) W_{t+1}`:
    ``mean_scale_fn(state, *params) -> (loc, scale)``, ``increment_distribution``
    the law of :math:`W`, ``initial_kernel(*params)`` the initial distribution."""

    def __init__(
        self,
        mean_scale_fn: Callable,
        parameters: tuple,
        increment_distribution: Distribution,
        initial_kernel: Callable,
        event_ndim: int | None = None,
    ):
        self.mean_scale_fn = mean_scale_fn
        self.parameters = tuple(parameters)
        self.increment_distribution = increment_distribution
        self.initial_kernel = initial_kernel
        self.event_ndim = len(increment_distribution.event_shape) if event_ndim is None else event_ndim

    @property
    def device(self) -> torch.device:
        return self.parameters[0].device

    def mean_scale(self, x: TimeseriesState) -> tuple:
        """Drift and diffusion evaluated at ``x``."""
        return self.mean_scale_fn(x, *self.parameters)

    def initial_distribution(self) -> Distribution:
        return self.initial_kernel(*self.parameters)

    def build_density(self, x: TimeseriesState) -> Distribution:
        loc, scale = self.mean_scale(x)
        return affine_transform(self.increment_distribution, loc, scale)

    def propagate_substeps(self, generator, x: TimeseriesState, n: int) -> TimeseriesState:
        """ONE batched draw of all ``n`` increments, then ``loc + scale * eps``
        per sub-step — law-equal to ``n`` separate ``propagate`` calls."""
        inc = self.increment_distribution
        elementwise = isinstance(inc, Normal) or (isinstance(inc, Independent) and isinstance(inc.base_dist, Normal))
        if n <= 0 or not elementwise:
            return super().propagate_substeps(generator, x, n)

        loc, scale = self.mean_scale(x)
        bs_es = tuple(inc.batch_shape) + tuple(inc.event_shape)
        target = tuple(torch.broadcast_shapes(loc.shape, scale.shape, bs_es))
        prefix = target[: len(target) - len(bs_es)]
        with draws_after(1):  # the sub-step axis leads the state's
            eps = inc.sample(generator, (n,) + prefix)

        x = x.propagate_from(values=loc + scale * eps[0], time_increment=1.0)
        for i in range(1, n):
            loc, scale = self.mean_scale(x)
            x = x.propagate_from(values=loc + scale * eps[i], time_increment=1.0)
        return x

    def copy_with(self, parameters: tuple) -> "AffineProcess":
        """The same process with new parameter tensors."""
        new = copy.copy(self)
        new.parameters = tuple(parameters)
        return new


class AffineEulerMaruyama(AffineProcess):
    r"""Euler–Maruyama discretised SDE ``x' = x + drift(x) dt + scale(x) dW``:
    ``mean_scale_fn`` returns ``(drift, scale)`` and the increment distribution
    is the law of ``dW``."""

    def __init__(self, mean_scale_fn, parameters, increment_distribution, initial_kernel, dt: float, event_ndim=None):
        super().__init__(mean_scale_fn, parameters, increment_distribution, initial_kernel, event_ndim=event_ndim)
        self.dt = dt

    def mean_scale(self, x: TimeseriesState) -> tuple:
        drift, scale = self.mean_scale_fn(x, *self.parameters)
        return x.value + drift * self.dt, scale


def _linear_mean_scale(x, a, b, sigma):
    if a.dim() >= 2:
        return b + torch.einsum("...ij,...j->...i", a, x.value), sigma
    return b + a * x.value, sigma


class LinearModel(AffineProcess):
    r"""Linear-Gaussian process ``x' = b + A x + sigma * eps``. Parameters
    ``(a, sigma)`` or ``(a, b, sigma)`` (tensors); a missing offset becomes 0."""

    def __init__(self, parameters, increment_distribution, initial_kernel, event_ndim=None):
        parameters = tuple(parameters)
        if len(parameters) == 2:
            a, sigma = parameters
            parameters = (a, torch.zeros_like(sigma), sigma)
        elif len(parameters) != 3:
            raise ValueError("LinearModel takes (a, sigma) or (a, b, sigma)")
        super().__init__(_linear_mean_scale, parameters, increment_distribution, initial_kernel, event_ndim=event_ndim)
