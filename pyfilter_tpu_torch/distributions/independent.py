"""Independent — reinterpret trailing batch dims as event dims (``to_event``).

Counterpart of ``pyfilter_tpu/distributions/independent.py``.
"""

from __future__ import annotations

import torch

from .base import Distribution


class Independent(Distribution):
    def __init__(self, base_dist: Distribution, reinterpreted_batch_ndims: int):
        if isinstance(base_dist, Independent):
            reinterpreted_batch_ndims += base_dist.reinterpreted_batch_ndims
            base_dist = base_dist.base_dist
        self.base_dist = base_dist
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims

    @property
    def batch_shape(self):
        bs = tuple(self.base_dist.batch_shape)
        return bs[: len(bs) - self.reinterpreted_batch_ndims]

    @property
    def event_shape(self):
        bs = tuple(self.base_dist.batch_shape)
        return bs[len(bs) - self.reinterpreted_batch_ndims:] + tuple(self.base_dist.event_shape)

    @property
    def support(self):
        return self.base_dist.support

    def expand(self, batch_shape) -> "Independent":
        """The base distribution broadcast over ``batch_shape`` followed by
        the reinterpreted axes."""
        lead = tuple(self.event_shape)[: self.reinterpreted_batch_ndims]
        return Independent(self.base_dist.expand(tuple(batch_shape) + lead), self.reinterpreted_batch_ndims)

    def sample(self, generator, sample_shape=()):
        return self.base_dist.sample(generator, sample_shape)

    def log_prob(self, value):
        lp = self.base_dist.log_prob(value)
        if self.reinterpreted_batch_ndims == 0:
            return lp
        return torch.sum(lp, dim=tuple(range(-self.reinterpreted_batch_ndims, 0)))

    def cdf(self, value):
        return self.base_dist.cdf(value)

    def icdf(self, q):
        return self.base_dist.icdf(q)

    @property
    def mean(self):
        return self.base_dist.mean

    @property
    def variance(self):
        return self.base_dist.variance

    def equivalent_to(self, other) -> bool:
        return (
            type(other) is Independent
            and other.reinterpreted_batch_ndims == self.reinterpreted_batch_ndims
            and self.base_dist.equivalent_to(other.base_dist)
        )
