"""Filters of the port: the particle filters (SQMC among them), the block
particle filter, the Gaussian family (Kalman, EKF/IEKF, UKF/CKF, EnKF,
ETKF/LETKF, GSF, IMM and the marginal adapter), the Rao-Blackwellized PF and
the predictive diagnostics (PIT, CRPS)."""

from . import particle
from .base import BaseFilter
from .block import BlockParticleFilter, BlockPFState
from .diagnostics import crps, predictive_pit
from .ekf import EKFState, ExtendedKalmanFilter
from .enkf import EnKFState, EnsembleKalmanFilter
from .etkf import EnsembleTransformKalmanFilter, Localization, gaspari_cohn
from .gsf import GaussianSumFilter, GSFState
from .imm import IMMState, InteractingMultipleModel, MarkovSwitchingModel
from .kalman import KalmanFilter, KalmanState
from .marginal import GaussianMarginalFilter
from .particle import APF, GPF, SISR, SQMC, ParticleFilter
from .rbpf import LinearSubstructure, RaoBlackwellizedPF
from .result import FilterHistory, FilterResult
from .ukf import CubatureKalmanFilter, UnscentedKalmanFilter
from .state import ParticleFilterCorrection, ParticleFilterPrediction

# the reference's import-path aliases, as the JAX package keeps them
Prediction = ParticleFilterPrediction
Correction = ParticleFilterCorrection

__all__ = [
    "BaseFilter",
    "BlockParticleFilter",
    "BlockPFState",
    "predictive_pit",
    "crps",
    "KalmanFilter",
    "KalmanState",
    "ExtendedKalmanFilter",
    "EKFState",
    "UnscentedKalmanFilter",
    "CubatureKalmanFilter",
    "GaussianSumFilter",
    "GSFState",
    "InteractingMultipleModel",
    "IMMState",
    "MarkovSwitchingModel",
    "EnsembleKalmanFilter",
    "EnsembleTransformKalmanFilter",
    "Localization",
    "gaspari_cohn",
    "GaussianMarginalFilter",
    "EnKFState",
    "RaoBlackwellizedPF",
    "LinearSubstructure",
    "ParticleFilter",
    "SISR",
    "APF",
    "GPF",
    "SQMC",
    "FilterResult",
    "FilterHistory",
    "ParticleFilterCorrection",
    "ParticleFilterPrediction",
    "Prediction",
    "Correction",
    "particle",
]
