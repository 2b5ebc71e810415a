"""The distribution layer of the port (the subset the ported filters, smoothers
and SMC² use)."""

from . import constraints
from .base import Distribution
from .bijectors import Affine, Bijector, Chain, Exp, Identity, SinhArcsinh, biject_to
from .core import Exponential, LogNormal, Normal
from .independent import Independent
from .mvn import MultivariateNormal, robust_cholesky
from .transformed import TransformedDistribution

__all__ = [
    "constraints",
    "Distribution",
    "Bijector",
    "Affine",
    "Chain",
    "Exp",
    "Identity",
    "SinhArcsinh",
    "biject_to",
    "Normal",
    "LogNormal",
    "Exponential",
    "Independent",
    "MultivariateNormal",
    "robust_cholesky",
    "TransformedDistribution",
]
