"""Collector callbacks appending derived series to the algorithm state.

Counterpart of ``pyfilter_tpu/inference/sequential/collectors.py``. Each
collector, registered with ``register_callback``, appends one value a step to
``state.collected[name]``: a tensor on the algorithm's device, computed with
no read to the host, so a collector adds no host sync to the step.
"""

from __future__ import annotations

from typing import Callable

import torch

from ...distributions import TransformedDistribution
from ..state import SequentialAlgorithmState

__all__ = ["Collector", "MeanCollector", "Standardizer", "ParameterPosterior"]


class Collector:
    """Appends ``f(algorithm, y, state)`` to ``state.collected[name]`` after
    every step (``y``: the observation on the algorithm's device)."""

    def __init__(self, name: str, f: Callable):
        self._name = name
        self._f = f

    @property
    def name(self) -> str:
        return self._name

    def __call__(self, algorithm, y, state: SequentialAlgorithmState):
        store = getattr(state, "collected", None)
        if store is None:
            store = {}
            state.collected = store
        store.setdefault(self._name, []).append(self._f(algorithm, y, state))


class MeanCollector(Collector):
    """The parameter-weighted mean of the lanes' filter means (the filter
    must record its moments: ``record_moments=True``, its default)."""

    @staticmethod
    def _mean(algorithm, y, state: SequentialAlgorithmState):
        latest_means = state.filter_state.latest_state.mean
        return torch.tensordot(state.normalized_weights(), latest_means, dims=([0], [0]))

    def __init__(self):
        super().__init__(name="filter_means", f=self._mean)


class Standardizer(Collector):
    """The observation pushed back through the observation density's
    bijector at every particle, averaged over the particles' and then the
    lanes' weights; needs a ``TransformedDistribution`` observation."""

    def _fun(self, algorithm, y, state: SequentialAlgorithmState):
        latest = state.filter_state.latest_state
        dist = algorithm._active_filter().model.build_density(latest.x)
        if not isinstance(dist, TransformedDistribution):
            raise NotImplementedError(f"Can't standardize for '{type(dist).__name__}'")
        y_std = dist.bijector.inverse(y)
        resid = torch.sum(latest.normalized_weights() * y_std, dim=0)
        return torch.tensordot(state.normalized_weights(), resid, dims=([0], [0]))

    def __init__(self):
        super().__init__(name="standardized", f=self._fun)


class ParameterPosterior(Collector):
    """The weighted mean of the parameter lanes (constrained by default)."""

    def _fun(self, algorithm, y, state: SequentialAlgorithmState):
        stacked = algorithm.context.stack_parameters(constrained=self._constrained)
        return state.normalized_weights() @ stacked

    def __init__(self, constrained: bool = True):
        super().__init__(name="parameter_means", f=self._fun)
        self._constrained = constrained
