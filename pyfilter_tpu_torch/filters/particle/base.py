"""Particle filter base: particle shapes, initialisation, the fused-resample rule.

Counterpart of ``pyfilter_tpu/filters/particle/base.py`` (single lane in
this slice: lane batches, recorded histories and smoothing come later).
"""

from __future__ import annotations

import torch

from ...ops import systematic_counts
from ..base import BaseFilter
from ..state import ParticleFilterCorrection
from .proposals import Bootstrap, Proposal


class ParticleFilter(BaseFilter):
    """Particle filter with ``particles`` particles on particle axis 0.
    ``ess_threshold`` is the relative ESS below which the cloud resamples.

    A float32 cloud with the default ``systematic_counts`` resampler resamples
    and gathers in one pass through ``ops.systematic_expand`` (the
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
        device=None,
    ):
        super().__init__(model, nan_strategy=nan_strategy, device=device)
        self.n_particles = int(particles)
        self.resampler = resampling_method
        self.proposal = proposal if proposal is not None else Bootstrap()
        self.ess_threshold = float(ess_threshold)
        self.record_moments = record_moments
        #: resample fires since construction (host counter; reset freely)
        self.n_resamples = 0
        self._identity = torch.arange(self.n_particles, dtype=torch.int32, device=self.device)

    def _use_fused_resample(self, value: torch.Tensor) -> bool:
        return value.dtype == torch.float32 and self.resampler is systematic_counts

    def resample_uniform(self, generator) -> torch.Tensor:
        """The fused systematic resample's one uniform, drawn from ``generator``."""
        return torch.rand((), generator=generator, device=self.device)

    @property
    def particles(self) -> tuple:
        return (self.n_particles,)

    @property
    def resample_threshold(self) -> float:
        return self.ess_threshold * self.n_particles

    def initialize(self, generator) -> ParticleFilterCorrection:
        """Initial cloud with zero log-weights and identity ancestry."""
        x = self.model.hidden.initial_sample(generator, self.particles)
        weights = torch.zeros(self.particles, dtype=x.value.dtype, device=self.device)
        ll = torch.zeros((), dtype=x.value.dtype, device=self.device)
        return ParticleFilterCorrection.from_weighted_particles(
            x, weights, ll, self._identity, compute_moments=self.record_moments
        )
