"""Rejuvenation kernels of the sequential algorithms (the PMMH kernel)."""

from .mh import MHUpdate, ParticleMetropolisHastings, TooManyIncreases

__all__ = ["ParticleMetropolisHastings", "TooManyIncreases", "MHUpdate"]
