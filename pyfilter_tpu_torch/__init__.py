"""pyfilter-tpu-torch — the PyTorch/CUDA port of ``pyfilter_tpu``.

Same module layout and public names as the JAX package; inside, PyTorch
idiom: models and processes hold their parameter tensors, every random draw
takes an explicit ``torch.Generator``, and every entry point takes a
``device`` — the card unless the caller passes ``device="cpu"``. The fused
resample + gather runs in a hand-written CUDA kernel for Hopper
(``ops/csrc/expand.cu``), built with ``nvcc`` at first use.

This slice ports the bootstrap SISR filter on the stochastic-volatility
model (single lane).
"""

__version__ = "0.1.0"

from . import convert, distributions, examples, filters, ops, timeseries, utils
from .filters import SISR, FilterResult, ParticleFilter
from .utils import get_ess, log_likelihood, normalize

__all__ = [
    "convert",
    "distributions",
    "examples",
    "filters",
    "ops",
    "timeseries",
    "utils",
    "SISR",
    "ParticleFilter",
    "FilterResult",
    "normalize",
    "get_ess",
    "log_likelihood",
]
