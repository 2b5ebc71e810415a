"""Rejuvenation kernels of the sequential algorithms: the PMMH kernel of
SMC², and the online jittering kernel of NESS with its KDE kernels."""

from .jittering import (
    ConstantKernel,
    JitterKernel,
    LiuWestShrinkage,
    NonShrinkingKernel,
    ShrinkingKernel,
    robust_var,
    scott,
    silverman,
)
from .mh import MHUpdate, ParticleMetropolisHastings, TooManyIncreases
from .online import OnlineKernel, OnlineUpdate

__all__ = [
    "JitterKernel",
    "ShrinkingKernel",
    "NonShrinkingKernel",
    "LiuWestShrinkage",
    "ConstantKernel",
    "robust_var",
    "silverman",
    "scott",
    "OnlineKernel",
    "OnlineUpdate",
    "ParticleMetropolisHastings",
    "MHUpdate",
    "TooManyIncreases",
]
