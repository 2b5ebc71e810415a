"""Parameter view bound to a prior and a context.

Counterpart of ``pyfilter_tpu/inference/parameter.py``: a named handle over
the context's value store; the value itself is a plain tensor.
"""

from __future__ import annotations

import torch

from . import prior as prior_ops


class PriorBoundParameter:
    """Named handle ``(context, name)``: ``value``, ``prior``,
    ``get_constrained``, ``get_unconstrained``, ``eval_prior``,
    ``inverse_sample`` and ``update``."""

    def __init__(self, context, name: str):
        self._context = context
        self.name = name

    @property
    def prior(self):
        return self._context.get_prior(self.name)

    @property
    def value(self) -> torch.Tensor:
        return self._context.get_parameter(self.name)

    def get_constrained(self) -> torch.Tensor:
        return self.value

    def get_unconstrained(self) -> torch.Tensor:
        return prior_ops.get_unconstrained(self.prior, self.value)

    def eval_prior(self, constrained: bool = True) -> torch.Tensor:
        return prior_ops.eval_prior(self.prior, self.value, constrained=constrained)

    def inverse_sample(self, probs, constrained: bool = True) -> torch.Tensor:
        """The inverse cdf of the (un)constrained prior at ``probs``, returned
        on the constrained space."""
        drawn = prior_ops.inverse_sample(self.prior, probs, constrained=constrained)
        if not constrained:
            drawn = prior_ops.get_constrained(self.prior, drawn)
        return drawn

    def update(self, value, constrained: bool = True) -> None:
        self._context.update_parameter(self.name, value, constrained=constrained)

    def __repr__(self):
        return f"PriorBoundParameter({self.name!r}, value={self.value!r})"
