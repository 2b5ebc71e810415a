"""Particle filters (SISR in this slice)."""

from . import proposals
from .base import ParticleFilter
from .sisr import SISR

__all__ = ["ParticleFilter", "SISR", "proposals"]
