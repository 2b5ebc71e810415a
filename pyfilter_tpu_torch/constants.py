"""Numeric constants of the float32 working type, and ``eps_for`` /
``eps2_for`` for any float type.

Counterpart of ``pyfilter_tpu/constants.py`` (the port runs in float32
everywhere, so the float64 constants are left out).
"""

import numpy as np
import torch

_finfo32 = np.finfo(np.float32)

INFTY = float("inf")

#: sqrt of machine epsilon for float32 — the "loose" epsilon used for damping / clamps.
EPS = float(np.sqrt(_finfo32.eps))

#: machine epsilon for float32.
EPS2 = float(_finfo32.eps)

#: largest representable float32.
MAX = float(_finfo32.max)

#: particle counts must stay below this for exact float32 indexing (the JAX
#: package carries indices as float32 inside its expansion kernel; the port
#: keeps the same limit so both packages accept the same inputs).
MAX_EXACT_INDEX = 1 << 24


def _finfo(dtype):
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).removeprefix("torch.")
    return np.finfo(np.dtype(dtype))


def eps_for(dtype) -> float:
    """sqrt(machine eps) of ``dtype`` (a torch or numpy float type), taken
    in that type as the JAX package takes it."""
    return float(np.sqrt(_finfo(dtype).eps))


def eps2_for(dtype) -> float:
    """Machine eps of ``dtype`` (a torch or numpy float type)."""
    return float(_finfo(dtype).eps)
