"""Quasi-Monte-Carlo engine: scrambled Sobol points with the reference's
post-processing.

Counterpart of ``pyfilter_tpu/inference/qmc.py``, over the reference
library's own engine, ``torch.quasirandom.SobolEngine`` (the JAX package
draws with ``scipy.stats.qmc.Sobol``, which scrambles differently). The
points are drawn and post-processed on the host in float64, then shipped to
the device as float32 in one host-to-device copy per draw.
"""

from __future__ import annotations

import math

import torch
from torch.quasirandom import SobolEngine

from ..utils import resolve_device

# float32 machine epsilon: the squeeze keeps every point strictly inside (0, 1)
_EPS2 = float(torch.finfo(torch.float32).eps)


class EngineContainer:
    """Scrambled Sobol sequence of dimension ``dim``, with an optional
    constant random shift (drawn once, at the first draw) and the squeeze
    ``0.5 + (1 - eps)(p - 0.5)`` away from 0 and 1. ``seed`` fixes both the
    scramble and the shift (random when None).

    The raw points (:meth:`_raw`) and the shift (``_rotation``) are the seam
    through which the tests feed the JAX engine's points. ``n_drawn`` counts
    the points drawn, ``n_copies`` the draws shipped to ``device``."""

    def __init__(self, dim: int, randomize: bool, seed: int | None = None, device=None):
        self.dimension = int(dim)
        self.device = resolve_device(device)
        self._engine = SobolEngine(self.dimension, scramble=True, seed=seed)
        self._randomize = randomize
        self._shift_generator = torch.Generator()
        if seed is None:
            self._shift_generator.seed()
        else:
            self._shift_generator.manual_seed(seed + 1)
        self._rotation: torch.Tensor | None = None
        self.n_drawn = 0
        self.n_copies = 0

    def _raw(self, numel: int) -> torch.Tensor:
        """The next ``numel`` points of the scrambled sequence, ``(numel, dim)``
        float64 on the host."""
        return self._engine.draw(numel, dtype=torch.float64)

    def sample(self, shape) -> torch.Tensor:
        """``prod(shape)`` points as ``(*shape, dim)`` float32 on the device."""
        shape = tuple(int(s) for s in shape)
        numel = math.prod(shape)
        probs = self._raw(numel)
        self.n_drawn += numel
        if numel == 1:
            probs = probs[0]
        if self._randomize:
            if self._rotation is None:
                self._rotation = torch.rand(self.dimension, generator=self._shift_generator, dtype=torch.float64)
            probs = torch.remainder(probs + self._rotation, 1.0)
        safe = 0.5 + (1.0 - _EPS2) * (probs - 0.5)
        self.n_copies += 1
        return safe.reshape(shape + (self.dimension,)).to(device=self.device, dtype=torch.float32)

    def rewind(self, num_points: int):
        """Step the sequence back by ``num_points`` points (the scramble is kept)."""
        num_points = int(num_points)
        if num_points <= 0:
            return
        target = self.n_drawn - num_points
        if target < 0:
            raise ValueError(f"cannot rewind {num_points} points; only {self.n_drawn} drawn")
        self._engine.reset()
        if target > 0:
            self._engine.fast_forward(target)
        self.n_drawn = target
