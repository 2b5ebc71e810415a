"""pyfilter-tpu-torch — the PyTorch/CUDA port of ``pyfilter_tpu``.

Same module layout and public names as the JAX package; inside, PyTorch
idiom: models and processes hold their parameter tensors, every random draw
takes an explicit ``torch.Generator``, and every entry point takes a
``device`` — the card unless the caller passes ``device="cpu"``. The fused
resample + gather runs in hand-written CUDA kernels for Hopper
(``ops/csrc/expand.cu`` for one lane, ``ops/csrc/expand_lanes.cu`` for lane
batches), built with ``nvcc`` at first use.

Ported so far: SISR, the APF (single lane and lane batches) and the GPF
with the bootstrap proposal, the optimal proposal for linear-Gaussian
observations, the linearized (gradient and damped-Newton mode finding),
nested and Gaussian-approximate proposals and the local linearization;
joint processes and the imputation of missing observation components;
recorded histories with exact FFBS, rejection FFBSi and fixed-lag
smoothing; PaRIS online smoothing, the online score and streaming maximum
likelihood; the single-step API (``step``, ``filter(...,
return_intermediaries=True)``, ``batch_filter_masked``); the systematic,
stratified, multinomial, residual, Metropolis and rejection resamplers; SMC² over a lane-batched APF, with a quasi-random
(Sobol) start and the adaptive distance stop; batch PMMH with random-walk
and adaptive random-walk proposals; NESS, FixedWidthNESS and their SMC²
hybrids with the KDE jitter kernels; gradients through the filter (the
differentiable SISR and APF, whose resample kernels have hand-written
backward kernels too, ``fit_mle``, the VI bridge and ``fit_svi``,
gradient-based PMMH, chain diagnostics); the AR, random-walk,
Ornstein-Uhlenbeck, local-linear-trend, trending-OU, UCSV, cyclical, linear,
Verhulst, sine-diffusion, Lorenz-63 and nutria models.
"""

__version__ = "0.1.0"

from . import convert, distributions, examples, filters, inference, ops, resampling, timeseries, utils
from .filters import APF, GPF, SISR, FilterHistory, FilterResult, ParticleFilter
from .filters.particle.proposals import (
    GaussianLinear,
    GaussianLinearized,
    GaussianProposal,
    Linearized,
    LocalLinearization,
    NestedProposal,
)
from .inference import NESS, NESSMC2, PMMH, SMC2, SMC2FW, make_context
from .timeseries import joint_process
from .utils import get_ess, log_likelihood, normalize

__all__ = [
    "convert",
    "distributions",
    "examples",
    "filters",
    "inference",
    "resampling",
    "ops",
    "timeseries",
    "utils",
    "SISR",
    "APF",
    "GPF",
    "Linearized",
    "NestedProposal",
    "GaussianProposal",
    "GaussianLinearized",
    "GaussianLinear",
    "LocalLinearization",
    "joint_process",
    "ParticleFilter",
    "FilterResult",
    "FilterHistory",
    "normalize",
    "get_ess",
    "log_likelihood",
    "make_context",
    "SMC2",
    "NESS",
    "NESSMC2",
    "SMC2FW",
    "PMMH",
]
