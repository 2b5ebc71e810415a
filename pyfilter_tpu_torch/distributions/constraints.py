"""Support constraints of distributions and priors: ``real``,
``real_vector``, ``positive``, ``Interval`` and ``unit_interval``.

Counterpart of ``pyfilter_tpu/distributions/constraints.py`` (the subset the
SMC² and NESS paths' priors use). ``bijectors.biject_to`` maps each onto a
bijector from the unconstrained reals.
"""

from __future__ import annotations


class Constraint:
    event_dim: int = 0


class _Real(Constraint):
    def __repr__(self):
        return "Real()"


class _Positive(Constraint):
    def __repr__(self):
        return "Positive()"


class _RealVector(Constraint):
    event_dim = 1

    def __repr__(self):
        return "RealVector()"


class Interval(Constraint):
    """The open interval ``(low, high)``; the bounds are floats or tensors
    (a prior's own, so building its bijector reads nothing from the device)."""

    def __init__(self, low, high):
        self.low = low
        self.high = high

    def __repr__(self):
        return f"Interval(low={self.low}, high={self.high})"


real = _Real()
positive = _Positive()
real_vector = _RealVector()
unit_interval = Interval(0.0, 1.0)
