"""Particle filter base: particle shapes, initialisation, the fused-resample rule.

Counterpart of ``pyfilter_tpu/filters/particle/base.py``. Particles are
``(N, *batch_shape)``: particle axis 0, lane axes next. Recorded histories
and smoothing come later.
"""

from __future__ import annotations

import torch

from ...ops import systematic_counts, systematic_expand, systematic_expand_lanes
from ..base import BaseFilter
from ..state import ParticleFilterCorrection
from .proposals import Bootstrap, Proposal


class ParticleFilter(BaseFilter):
    """Particle filter with ``particles`` particles on particle axis 0 and
    ``batch_shape`` lanes after it. ``ess_threshold`` is the relative ESS
    below which the cloud resamples.

    A float32 cloud with the default ``systematic_counts`` resampler resamples
    and gathers in one pass (:meth:`_fused_resample`: ``ops.systematic_expand``
    for one lane, ``ops.systematic_expand_lanes`` for a lane batch, each a
    hand-written CUDA kernel on the card); any other resampler is used as
    given, followed by a gather."""

    def __init__(
        self,
        model,
        particles: int,
        resampling_method=systematic_counts,
        proposal: Proposal = None,
        ess_threshold: float = 0.9,
        record_moments: bool = True,
        nan_strategy: str = "skip",
        batch_shape=(),
        device=None,
    ):
        super().__init__(model, nan_strategy=nan_strategy, batch_shape=batch_shape, device=device)
        self.n_particles = int(particles)
        self.resampler = resampling_method
        self.proposal = proposal if proposal is not None else Bootstrap()
        self.ess_threshold = float(ess_threshold)
        self.record_moments = record_moments
        #: resample fires since construction (host counter; reset freely)
        self.n_resamples = 0
        self._identity_cache = None

    @property
    def _identity(self) -> torch.Tensor:
        """Identity ancestry ``(N, *batch)`` (cached per particle shape)."""
        if self._identity_cache is None or tuple(self._identity_cache.shape) != self.particles:
            ar = torch.arange(self.n_particles, dtype=torch.int32, device=self.device)
            self._identity_cache = ar.reshape((-1,) + (1,) * len(self.batch_shape)).expand(self.particles)
        return self._identity_cache

    def _use_fused_resample(self, value: torch.Tensor) -> bool:
        return value.dtype == torch.float32 and self.resampler is systematic_counts

    def resample_uniform(self, generator) -> torch.Tensor:
        """The fused systematic resample's uniforms, one per lane, drawn from
        ``generator``."""
        return torch.rand(self.batch_shape, generator=generator, device=self.device)

    def _fused_resample(self, generator, weights, values, normalized: bool = False):
        """Resample + gather ``values`` by ``weights`` in one pass: the lane
        kernel for a lane batch, the single-lane kernel otherwise."""
        u = self.resample_uniform(generator)
        expand = systematic_expand_lanes if self.batch_shape else systematic_expand
        return expand(None, weights, values, normalized=normalized, u=u)

    @property
    def particles(self) -> tuple:
        return (self.n_particles, *self.batch_shape)

    @property
    def resample_threshold(self) -> float:
        return self.ess_threshold * self.n_particles

    def increase_particles(self, factor: int) -> "ParticleFilter":
        """A filter with ``factor`` times the particles."""
        return self.replace(n_particles=int(factor * self.n_particles))

    def initialize(self, generator) -> ParticleFilterCorrection:
        """Initial cloud with zero log-weights and identity ancestry."""
        x = self.model.hidden.initial_sample(generator, self.particles)
        weights = torch.zeros(self.particles, dtype=x.value.dtype, device=self.device)
        ll = torch.zeros(self.batch_shape, dtype=x.value.dtype, device=self.device)
        return ParticleFilterCorrection.from_weighted_particles(
            x, weights, ll, self._identity, compute_moments=self.record_moments
        )
