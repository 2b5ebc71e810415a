"""Particle filters (SISR and the APF), their proposals and smoothers."""

from . import proposals, smoothing
from .apf import APF
from .base import ParticleFilter
from .sisr import SISR
from .smoothing import ffbsi_smooth, transition_log_sup

__all__ = ["ParticleFilter", "SISR", "APF", "proposals", "smoothing", "ffbsi_smooth", "transition_log_sup"]
