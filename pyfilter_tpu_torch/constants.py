"""Numeric constants of the float32 working type.

Counterpart of ``pyfilter_tpu/constants.py`` (float32 only: the port runs in
float32 everywhere).
"""

import numpy as np

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
