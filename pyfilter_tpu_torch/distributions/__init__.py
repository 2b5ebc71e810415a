"""The distribution layer of the port (the subset the ported filters, smoothers,
SMC² and NESS use)."""

from . import constraints
from .base import Distribution
from .bijectors import Affine, Bijector, Chain, Exp, Identity, Sigmoid, SinhArcsinh, biject_to
from .core import Exponential, Gamma, InverseGamma, LogNormal, Normal, Uniform
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
    "Sigmoid",
    "SinhArcsinh",
    "biject_to",
    "Normal",
    "LogNormal",
    "Exponential",
    "Gamma",
    "InverseGamma",
    "Uniform",
    "Independent",
    "MultivariateNormal",
    "robust_cholesky",
    "TransformedDistribution",
]
