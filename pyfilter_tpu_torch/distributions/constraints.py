"""Support constraints of distributions and priors: ``real``,
``real_vector``, ``positive``, ``nonnegative``, ``Interval`` /
``unit_interval``, ``GreaterThan``, ``simplex`` and ``lower_cholesky``, each
with ``check`` (a boolean tensor over the value's batch axes).

Counterpart of ``pyfilter_tpu/distributions/constraints.py``, with its
tolerance in ``simplex``'s sum. ``bijectors.biject_to`` maps a constraint onto
a bijector from the unconstrained reals.
"""

from __future__ import annotations

import torch


class Constraint:
    event_dim: int = 0

    def check(self, value):
        raise NotImplementedError


class _Real(Constraint):
    def check(self, value):
        return torch.isfinite(value)

    def __repr__(self):
        return "Real()"


class _Positive(Constraint):
    def check(self, value):
        return value > 0

    def __repr__(self):
        return "Positive()"


class _Nonnegative(Constraint):
    def check(self, value):
        return value >= 0

    def __repr__(self):
        return "Nonnegative()"


class Interval(Constraint):
    """The open interval ``(low, high)``; the bounds are floats or tensors
    (a prior's own, so building its bijector reads nothing from the device)."""

    def __init__(self, low, high):
        self.low = low
        self.high = high

    def check(self, value):
        return (value > self.low) & (value < self.high)

    def __repr__(self):
        return f"Interval(low={self.low}, high={self.high})"


class GreaterThan(Constraint):
    """The open half-line ``(low, inf)``."""

    def __init__(self, low):
        self.low = low

    def check(self, value):
        return value > self.low

    def __repr__(self):
        return f"GreaterThan(low={self.low})"


class _RealVector(Constraint):
    event_dim = 1

    def check(self, value):
        return torch.all(torch.isfinite(value), dim=-1)

    def __repr__(self):
        return "RealVector()"


class _Simplex(Constraint):
    event_dim = 1

    def check(self, value):
        return torch.all(value >= 0, dim=-1) & (torch.abs(torch.sum(value, dim=-1) - 1.0) < 1e-6)

    def __repr__(self):
        return "Simplex()"


class _LowerCholesky(Constraint):
    event_dim = 2

    def check(self, value):
        diag_ok = torch.all(torch.diagonal(value, dim1=-2, dim2=-1) > 0, dim=-1)
        return diag_ok & torch.all(torch.triu(value, diagonal=1) == 0, dim=-1).all(dim=-1)

    def __repr__(self):
        return "LowerCholesky()"


real = _Real()
positive = _Positive()
nonnegative = _Nonnegative()
unit_interval = Interval(0.0, 1.0)
real_vector = _RealVector()
simplex = _Simplex()
lower_cholesky = _LowerCholesky()
