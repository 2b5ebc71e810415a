"""Particle filters (SISR and the APF in this slice)."""

from . import proposals
from .apf import APF
from .base import ParticleFilter
from .sisr import SISR

__all__ = ["ParticleFilter", "SISR", "APF", "proposals"]
