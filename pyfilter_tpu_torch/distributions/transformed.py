"""TransformedDistribution — a base distribution pushed through bijectors.

Counterpart of ``pyfilter_tpu/distributions/transformed.py`` (the
sinh-arcsinh observation density of the stochastic-volatility model, and the
priors pushed to the unconstrained space).
"""

from __future__ import annotations

import torch

from .base import Distribution
from .bijectors import Bijector, Chain


class TransformedDistribution(Distribution):
    def __init__(self, base_dist: Distribution, bijector):
        if isinstance(bijector, (list, tuple)):
            bijector = Chain(bijector)
        self.base_dist = base_dist
        self.bijector: Bijector = bijector

    @property
    def batch_shape(self):
        return self.base_dist.batch_shape

    @property
    def event_shape(self):
        base_event = tuple(self.base_dist.event_shape)
        extra = self.bijector.event_dim - len(base_event)
        if extra > 0:
            bs = tuple(self.base_dist.batch_shape)
            return bs[len(bs) - extra:] + base_event
        return base_event

    def sample(self, generator, sample_shape=()):
        return self.bijector.forward(self.base_dist.sample(generator, sample_shape))

    def log_prob(self, value):
        # fused inverse + jacobian; an elementwise bijector over a base with
        # event rank k gives a per-element ladj summed over the k event dims
        x, ladj = self.bijector.inverse_and_ladj(value)
        n_sum = len(self.event_shape) - self.bijector.event_dim
        if n_sum:
            ladj = torch.sum(ladj, dim=tuple(range(-n_sum, 0)))
        return self.base_dist.log_prob(x) - ladj

    def cdf(self, value):
        """Valid for increasing bijectors (every prior bijection of the port)."""
        return self.base_dist.cdf(self.bijector.inverse(value))

    def icdf(self, q):
        """Valid for increasing bijectors (every prior bijection of the port)."""
        return self.bijector.forward(self.base_dist.icdf(q))
