"""Concrete distributions: ``Normal`` (the one the main path uses).

Counterpart of ``pyfilter_tpu/distributions/core.py``.
"""

from __future__ import annotations

import math

import torch

from .base import Distribution

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class Normal(Distribution):
    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.loc.shape, self.scale.shape))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * torch.square(z) - torch.log(self.scale) - _LOG_SQRT_2PI
