"""Support constraints of distributions and priors: ``real``,
``real_vector`` and ``positive``.

Counterpart of ``pyfilter_tpu/distributions/constraints.py`` (the subset the
SMC² path's priors use). Each is a singleton that ``bijectors.biject_to``
maps onto a bijector from the unconstrained reals.
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


real = _Real()
positive = _Positive()
real_vector = _RealVector()
