"""Batch inference (the MCMC pieces SMC² uses)."""

from . import mcmc

__all__ = ["mcmc"]
