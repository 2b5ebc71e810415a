"""Particle filters (SISR, the APF, the GPF and SQMC), their proposals and
smoothers, and the genealogy variance estimators."""

from . import proposals, smoothing
from .apf import APF
from .base import ParticleFilter, smoothed_joint_log_likelihood
from .gpf import GPF
from .sisr import SISR
from .sqmc import SQMC, SQMCState
from .smoothing import ffbsi_smooth, paris, transition_log_sup, transition_log_sup_traced
from .variance import (
    VarianceEstimate,
    eve_indices,
    filter_mean_variance,
    lag_ancestor_indices,
    log_likelihood_variance,
)

__all__ = ["ParticleFilter", "SISR", "APF", "GPF", "SQMC", "SQMCState", "proposals", "smoothing", "ffbsi_smooth",
           "paris", "transition_log_sup", "transition_log_sup_traced", "smoothed_joint_log_likelihood",
           "VarianceEstimate", "eve_indices", "lag_ancestor_indices", "log_likelihood_variance", "filter_mean_variance"]
