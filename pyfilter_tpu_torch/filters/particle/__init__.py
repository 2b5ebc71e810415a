"""Particle filters (SISR, the APF and the GPF), their proposals and smoothers."""

from . import proposals, smoothing
from .apf import APF
from .base import ParticleFilter, smoothed_joint_log_likelihood
from .gpf import GPF
from .sisr import SISR
from .smoothing import ffbsi_smooth, paris, transition_log_sup, transition_log_sup_traced

__all__ = ["ParticleFilter", "SISR", "APF", "GPF", "proposals", "smoothing", "ffbsi_smooth", "paris",
           "transition_log_sup", "transition_log_sup_traced", "smoothed_joint_log_likelihood"]
