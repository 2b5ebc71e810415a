"""Batch inference: particle MCMC (PMMH), density-tempered SMC and IF2."""

from . import mcmc
from .if2 import IF2, IF2Result
from .tempered import TemperedSMC, TemperedSMCResult

__all__ = ["mcmc", "IF2", "IF2Result", "TemperedSMC", "TemperedSMCResult"]
