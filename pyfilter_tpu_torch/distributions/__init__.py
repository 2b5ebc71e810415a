"""The distribution layer of the port (the subset the SISR main path uses)."""

from .base import Distribution
from .bijectors import Affine, Bijector, Chain, SinhArcsinh
from .core import Normal
from .transformed import TransformedDistribution

__all__ = [
    "Distribution",
    "Bijector",
    "Affine",
    "Chain",
    "SinhArcsinh",
    "Normal",
    "TransformedDistribution",
]
