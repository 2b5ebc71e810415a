"""Optimal proposal for linear-Gaussian observations.

Counterpart of ``pyfilter_tpu/filters/particle/proposals/linear.py``: the
closed-form optimal proposal when ``Y = b + A X + s V`` over an affine hidden
process.
"""

from __future__ import annotations

from ....timeseries import LinearStateSpaceModel
from .base import Proposal
from .utils import find_optimal_density, linear_marginal_density


def _check_linear_model(model):
    if not hasattr(model.hidden, "mean_scale"):
        raise ValueError("LinearGaussianObservations requires an affine hidden process")
    if len(model.parameters) != 3 or not isinstance(model, LinearStateSpaceModel):
        raise ValueError("LinearGaussianObservations requires a LinearStateSpaceModel with (a, b, s) parameters")


class LinearGaussianObservations(Proposal):
    """Conditionally optimal proposal: the affine hidden step's mean and
    scale combined with the linear observation in precision form; the
    posterior kernel is sampled and weighted with
    ``log p(y|x') + log p(x'|x) - log q(x')``."""

    def sample_and_weight(self, generator, model, y, prediction):
        _check_linear_model(model)
        x = prediction.get_timeseries_state()
        mean, scale = model.hidden.mean_scale(x)
        x_dist = model.hidden.build_density(x)
        a, b, s = model.parameters
        kernel = find_optimal_density(
            y - b, mean, scale**-2.0, s**-2.0, a, model.hidden.event_ndim, len(model.event_shape)
        )
        x_result = x.propagate_from(values=kernel.sample(generator))
        return x_result, self._weight_with_kernel(model, y, x_dist, x_result, kernel)

    def pre_weight(self, model, y, x):
        """The exact marginal ``p(y_t | x_{t-1})``, as the JAX package computes it."""
        _check_linear_model(model)
        _, h_scale = model.hidden.mean_scale(x)
        a, b, s = model.parameters
        kernel = linear_marginal_density(
            x.value, h_scale**2.0, s**2.0, a, b, model.hidden.event_ndim, len(model.event_shape)
        )
        return kernel.log_prob(y)
