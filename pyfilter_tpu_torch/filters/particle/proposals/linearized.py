"""Linearized proposal: find the mode of the joint density, propose from a
Gaussian about it.

Counterpart of ``pyfilter_tpu/filters/particle/proposals/linearized.py``.
The reference's two engines (functorch and legacy autograd) are one
implementation here, :func:`.utils.find_mode` on ``torch.func``;
``use_functorch`` is kept for the reference's signature.
"""

from __future__ import annotations

from .base import Proposal
from .utils import find_mode


class Linearized(Proposal):
    """The optimal proposal approximated about the mode of
    :math:`\\log p(y_t|x_t) + \\log p(x_t|x_{t-1})`, found from the
    propagated mean by ``n_steps`` gradient steps of size ``alpha``, or
    damped-Newton steps with ``use_second_order``."""

    def __init__(self, n_steps: int = 1, alpha: float = 1e-4, use_second_order: bool = False,
                 use_functorch: bool = True, pre_weight_func=None):
        super().__init__(pre_weight_func)
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        self.n_steps = int(n_steps)
        self.alpha = float(alpha)
        self.use_second_order = bool(use_second_order)
        self.use_functorch = use_functorch

    def _find_mode(self, model, state, y, init_x, init_std, x_dist=None):
        return find_mode(model, state, y, init_x=init_x, init_std=init_std, num_steps=self.n_steps,
                         alpha=self.alpha, use_hessian=self.use_second_order, x_dist=x_dist)

    def sample_and_weight(self, generator, model, y, prediction):
        if not hasattr(model.hidden, "mean_scale"):
            raise ValueError("Linearized requires an affine hidden process")
        x = prediction.get_timeseries_state()
        mean, std = model.hidden.mean_scale(x)
        x_dist = prediction.get_predictive_density(model)
        kernel = self._find_mode(model, x, y, mean, std)
        x_result = x.propagate_from(values=kernel.sample(generator))
        return x_result, self._weight_with_kernel(model, y, x_dist, x_result, kernel)
