"""Local linearization of a nonlinear observation mean.

Counterpart of ``pyfilter_tpu/filters/particle/proposals/local_linearization.py``
(the reference's own is disabled; this one works). Model contract: the
observation is ``Y_t = f(X_t, *params) + s V_t`` with Gaussian noise, ``s =
model.parameters[s_index]``, over an affine hidden process. The mean is
linearized about the propagated hidden mean :math:`\\mu_t`,

.. math::
    f(x) \\approx f(\\mu) + f'(\\mu) (x - \\mu) = b + A x,

which reduces to the closed-form optimal proposal of
:class:`LinearGaussianObservations`. ``f'`` is ``linearized_f`` when given,
else forward-mode columns from ``torch.func.jvp``. The importance weight
uses the exact nonlinear observation density, so the filter stays unbiased.
"""

from __future__ import annotations

from typing import Callable

import torch

from .base import Proposal
from .utils import _unit_tangents, find_optimal_density, linear_marginal_density


def _per_particle_jacobian(fn: Callable, x: torch.Tensor, hidden_ev: int) -> torch.Tensor:
    """``d f / d x`` of every particle from ``d_h`` forward-mode products
    (particle ``i``'s observation mean depends on ``x_i`` only):
    ``(..., [d_o])`` for a scalar state, ``(..., [d_o,] d_h)`` otherwise."""
    cols = [torch.func.jvp(fn, (x,), (t,))[1] for t in _unit_tangents(x, hidden_ev)]
    return cols[0] if hidden_ev == 0 else torch.stack(cols, dim=-1)


class LocalLinearization(Proposal):
    """First-order linearization of the observation mean ``f`` about the
    propagated hidden mean, into the optimal linear-Gaussian proposal."""

    def __init__(self, f: Callable = None, linearized_f: Callable | None = None, s_index: int = -1,
                 pre_weight_func=None):
        super().__init__(pre_weight_func)
        if f is None:
            raise ValueError("LocalLinearization requires the observation mean function f")
        self.f = f
        self.linearized_f = linearized_f
        self.s_index = int(s_index)

    def _linearize(self, model, x):
        """The hidden step's mean and scale, and the linearization ``y ~
        N(offset + a x, s)`` of every particle."""
        mean, scale = model.hidden.mean_scale(x)
        mu_state = x.propagate_from(values=mean)
        params = model.parameters
        if self.linearized_f is not None:
            a = self.linearized_f(mu_state, *params)
        else:
            a = _per_particle_jacobian(lambda v: self.f(mu_state.copy(values=v), *params), mean,
                                       model.hidden.event_ndim)
        if model.hidden.event_ndim == 0 or a.dim() < 2:
            prod = a * mean
        else:
            prod = torch.einsum("...ij,...j->...i", a, mean)
        return mean, scale, a, self.f(mu_state, *params) - prod

    def sample_and_weight(self, generator, model, y, prediction):
        x = prediction.get_timeseries_state()
        mean, scale, a, offset = self._linearize(model, x)
        x_dist = model.hidden.build_density(x)
        s = model.parameters[self.s_index]
        kernel = find_optimal_density(y - offset, mean, scale**-2.0, s**-2.0, a, model.hidden.event_ndim,
                                      len(model.event_shape))
        x_result = x.propagate_from(values=kernel.sample(generator))
        return x_result, self._weight_with_kernel(model, y, x_dist, x_result, kernel)

    def pre_weight(self, model, y, x):
        mean, scale, a, offset = self._linearize(model, x)
        s = model.parameters[self.s_index]
        kernel = linear_marginal_density(mean, scale**2.0, s**2.0, a, offset, model.hidden.event_ndim,
                                         len(model.event_shape))
        return kernel.log_prob(y)
