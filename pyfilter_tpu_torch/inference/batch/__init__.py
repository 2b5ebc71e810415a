"""Batch inference: particle MCMC (PMMH)."""

from . import mcmc

__all__ = ["mcmc"]
