"""Gaussian-approximate proposals of the Gaussian particle filter.

Counterpart of ``pyfilter_tpu/filters/particle/proposals/approximate.py``:
the cloud is collapsed into a moment-matched Gaussian predictive before the
proposal draws. Each proposal first propagates the cloud once for that
predictive, then draws its sample, from the same generator, in that order.
"""

from __future__ import annotations

from ....utils import get_mean_and_variance
from .base import Proposal
from .linear import LinearGaussianObservations, _check_linear_model
from .linearized import Linearized
from .utils import find_optimal_density


class GaussianProposal(Proposal):
    """Sample the moment-matched Gaussian approximation of the predictive
    density; weight by the observation density."""

    def sample_and_weight(self, generator, model, y, prediction):
        predictive = prediction.get_predictive_density(model, generator, approximate=True)
        x = prediction.get_timeseries_state()
        x_result = x.propagate_from(values=predictive.expand(x.batch_shape).sample(generator))
        return x_result, model.build_density(x_result).log_prob(y)


def _collapsed_mean_state(prediction, event_ndim: int):
    """The weighted cloud's mean as one pseudo-particle (a leading axis of
    1), and its variance."""
    x = prediction.get_timeseries_state()
    mean, var = get_mean_and_variance(x.value, prediction.normalized_weights, event_ndim=event_ndim)
    return x.copy(values=mean[None]), var[None]


class GaussianLinearized(Linearized):
    """:class:`Linearized` about the collapsed (moment-matched) predictive."""

    def sample_and_weight(self, generator, model, y, prediction):
        mean_state, predictive_variance = _collapsed_mean_state(prediction, model.hidden.event_ndim)
        mean, std = model.hidden.mean_scale(mean_state)
        std = (predictive_variance + std**2.0).sqrt()
        predictive = prediction.get_predictive_density(model, generator, approximate=True)
        kernel = self._find_mode(model, mean_state, y, mean, std, x_dist=predictive)

        x = prediction.get_timeseries_state()
        x_result = x.propagate_from(values=kernel.expand(x.batch_shape).sample(generator))
        return x_result, self._weight_with_kernel(model, y, predictive, x_result, kernel)


class GaussianLinear(LinearGaussianObservations):
    """:class:`LinearGaussianObservations` on the collapsed predictive."""

    def sample_and_weight(self, generator, model, y, prediction):
        _check_linear_model(model)
        mean_state, predictive_variance = _collapsed_mean_state(prediction, model.hidden.event_ndim)
        mean, scale = model.hidden.mean_scale(mean_state)
        predictive = prediction.get_predictive_density(model, generator, approximate=True)
        a, b, s = model.parameters
        kernel = find_optimal_density(
            y - b, mean, (scale**2.0 + predictive_variance) ** -1.0, s**-2.0, a, model.hidden.event_ndim,
            len(model.event_shape),
        )
        x = prediction.get_timeseries_state()
        x_result = x.propagate_from(values=kernel.expand(x.batch_shape).sample(generator))
        return x_result, self._weight_with_kernel(model, y, predictive, x_result, kernel)
