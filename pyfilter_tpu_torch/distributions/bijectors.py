"""Bijectors (invertible elementwise transforms): ``Affine``, ``SinhArcsinh``,
their ``Chain``, ``Identity``, ``Exp``, ``Sigmoid``, the inverse of each
(``.inv``) and ``biject_to`` (a constraint's bijector from the unconstrained
reals).

Counterpart of ``pyfilter_tpu/distributions/bijectors.py``. The sinh-arcsinh
transform keeps the JAX package's own log/exp/sqrt formulas (``_asinh``,
``_sinh``, ``_log_cosh``) rather than ``torch.asinh`` / ``torch.cosh``, which
round differently: the two packages' observation densities then agree to
float32 rounding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import constraints


class Bijector:
    """Invertible elementwise transform (``event_dim == 0``)."""

    event_dim: int = 0

    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError

    def log_abs_det_jacobian(self, x, y):
        """log |d forward / dx| elementwise at ``x`` (``y = forward(x)``)."""
        raise NotImplementedError

    def inverse_and_ladj(self, y):
        """``(inverse(y), log_abs_det_jacobian(inverse(y), y))`` in one pass."""
        x = self.inverse(y)
        return x, self.log_abs_det_jacobian(x, y)

    @property
    def inv(self) -> "Bijector":
        return _Inverse(self)


class _Inverse(Bijector):
    def __init__(self, bijector: Bijector):
        self.bijector = bijector
        self.event_dim = bijector.event_dim

    def forward(self, x):
        return self.bijector.inverse(x)

    def inverse(self, y):
        return self.bijector.forward(y)

    def log_abs_det_jacobian(self, x, y):
        return -self.bijector.log_abs_det_jacobian(y, x)


class Identity(Bijector):
    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def log_abs_det_jacobian(self, x, y):
        return torch.zeros_like(x)


class Exp(Bijector):
    def forward(self, x):
        return torch.exp(x)

    def inverse(self, y):
        return torch.log(y)

    def log_abs_det_jacobian(self, x, y):
        return x


class Affine(Bijector):
    """y = loc + scale * x."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    def forward(self, x):
        return self.loc + self.scale * x

    def inverse(self, y):
        return (y - self.loc) / self.scale

    def log_abs_det_jacobian(self, x, y):
        scale = torch.as_tensor(self.scale, dtype=x.dtype, device=x.device)
        return torch.broadcast_to(torch.log(torch.abs(scale)), x.shape)


class Sigmoid(Bijector):
    """``y = 1 / (1 + exp(-x))``; the inverse keeps the JAX package's
    ``log(y) - log1p(-y)``, so a value on a bound maps to an infinity in both."""

    def forward(self, x):
        return torch.sigmoid(x)

    def inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def log_abs_det_jacobian(self, x, y):
        return -F.softplus(-x) - F.softplus(x)


def _asinh(x):
    # log/sqrt formulation, sign-symmetrized: the JAX package's own formula
    ax = torch.abs(x)
    return torch.sign(x) * torch.log(ax + torch.sqrt(torch.square(ax) + 1.0))


def _sinh(x):
    e = torch.exp(x)
    return 0.5 * (e - 1.0 / e)


def _log_cosh(x):
    # log((e^x + e^-x)/2) = |x| + log1p(e^{-2|x|}) - log 2, overflow-safe
    ax = torch.abs(x)
    return ax + torch.log1p(torch.exp(-2.0 * ax)) - math.log(2.0)


class SinhArcsinh(Bijector):
    """``y = sinh((arcsinh(x) + skew) * tailweight)``."""

    def __init__(self, skew, tailweight):
        self.skew = skew
        self.tailweight = tailweight

    def forward(self, x):
        return _sinh((_asinh(x) + self.skew) * self.tailweight)

    def inverse(self, y):
        return _sinh(_asinh(y) / self.tailweight - self.skew)

    def log_abs_det_jacobian(self, x, y):
        t = self.tailweight
        inner = (_asinh(x) + self.skew) * t
        return torch.log(t) + _log_cosh(inner) - 0.5 * torch.log1p(torch.square(x))

    def inverse_and_ladj(self, y):
        # (asinh(x) + skew) * tailweight == asinh(y) at x = inverse(y): one
        # asinh chain serves both the inverse and the jacobian
        t = self.tailweight
        u = _asinh(y)
        x = _sinh(u / t - self.skew)
        ladj = torch.log(t) + _log_cosh(u) - 0.5 * torch.log1p(torch.square(x))
        return x, ladj


class Chain(Bijector):
    """Composition: ``forward = parts[-1] o ... o parts[0]``."""

    def __init__(self, parts):
        self.parts = tuple(parts)
        self.event_dim = max((p.event_dim for p in self.parts), default=0)

    def forward(self, x):
        for p in self.parts:
            x = p.forward(x)
        return x

    def inverse(self, y):
        for p in reversed(self.parts):
            y = p.inverse(y)
        return y

    def log_abs_det_jacobian(self, x, y):
        total = torch.zeros_like(x)
        for p in self.parts:
            x_next = p.forward(x)
            total = total + p.log_abs_det_jacobian(x, x_next)
            x = x_next
        return total

    def inverse_and_ladj(self, y):
        # chain rule backwards: each part's jacobian at its own input
        total = None
        for p in reversed(self.parts):
            y, ladj = p.inverse_and_ladj(y)
            total = ladj if total is None else total + ladj
        if total is None:
            total = torch.zeros_like(y)
        return y, torch.broadcast_to(total, y.shape)


def biject_to(constraint: constraints.Constraint) -> Bijector:
    """Bijector from the unconstrained reals onto the support of
    ``constraint``: the identity for the reals, ``Exp`` for the positive
    half-line, ``Sigmoid`` then ``Affine(low, high - low)`` for an interval
    (the JAX package's choices)."""
    if constraint is constraints.real or constraint is constraints.real_vector:
        return Identity()
    if constraint is constraints.positive:
        return Exp()
    if isinstance(constraint, constraints.Interval):
        return Chain([Sigmoid(), Affine(constraint.low, constraint.high - constraint.low)])
    raise NotImplementedError(f"no bijector registered for constraint {constraint!r}")
