"""The distribution layer of the port (the subset the SISR and SMC² paths use)."""

from . import constraints
from .base import Distribution
from .bijectors import Affine, Bijector, Chain, Exp, Identity, SinhArcsinh, biject_to
from .core import Exponential, LogNormal, Normal
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
    "MultivariateNormal",
    "robust_cholesky",
    "TransformedDistribution",
]
