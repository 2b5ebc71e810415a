"""Parameter view bound to a prior and a context.

Counterpart of ``pyfilter_tpu/inference/parameter.py``: a named handle over
the context's value store; the value itself is a plain tensor.
"""

from __future__ import annotations

import torch

from . import prior as prior_ops


class PriorBoundParameter:
    """Named handle ``(context, name)``: ``value``, ``prior``,
    ``get_unconstrained``, ``eval_prior`` and ``update``."""

    def __init__(self, context, name: str):
        self._context = context
        self.name = name

    @property
    def prior(self):
        return self._context.get_prior(self.name)

    @property
    def value(self) -> torch.Tensor:
        return self._context.get_parameter(self.name)

    def get_unconstrained(self) -> torch.Tensor:
        return prior_ops.get_unconstrained(self.prior, self.value)

    def eval_prior(self, constrained: bool = True) -> torch.Tensor:
        return prior_ops.eval_prior(self.prior, self.value, constrained=constrained)

    def update(self, value, constrained: bool = True) -> None:
        self._context.update_parameter(self.name, value, constrained=constrained)

    def __repr__(self):
        return f"PriorBoundParameter({self.name!r}, value={self.value!r})"
