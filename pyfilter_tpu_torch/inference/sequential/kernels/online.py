"""Online (jitter-based) rejuvenation kernel of NESS.

Counterpart of ``pyfilter_tpu/inference/sequential/kernels/online.py`` (its
eager body; the JAX package's jitted twin computes the same thing for XLA):
stack the unconstrained parameters, resample the parameter lanes
systematically, KDE-jitter them, unstack into a new context, rebuild the
filter's model from it and reset the lane weights.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ....resampling import systematic
from ...state import SequentialAlgorithmState
from .jittering import JitterKernel, NonShrinkingKernel


class OnlineUpdate(NamedTuple):
    context: object
    filter_: object
    state: SequentialAlgorithmState


class OnlineKernel:
    """``kernel`` jitters the resampled lanes; with ``discrete`` each lane is
    jittered only with probability ``K^{-1/2}`` and otherwise keeps its
    resampled value."""

    def __init__(self, kernel: JitterKernel = None, discrete: bool = False, resampler=systematic):
        self._kernel = kernel or NonShrinkingKernel()
        self._disc = discrete
        self._resampler = resampler
        #: rejuvenations run since the count was set to 0
        self.n_rejuvenations = 0

    def jitter_mask(self, generator, k: int, like: torch.Tensor) -> torch.Tensor:
        """``discrete``'s Bernoulli(``K^{-1/2}``) draws, one per lane, as a
        ``(K, 1)`` mask of ``like``'s dtype."""
        u = torch.rand((k,), generator=generator, dtype=like.dtype, device=like.device)
        return (u < 1.0 / math.sqrt(k)).to(like.dtype)[..., None]

    def update(self, generator, context, filter_, state: SequentialAlgorithmState) -> OnlineUpdate:
        """Draws, in order from ``generator``: the lane resampler's uniform,
        the jitter's normals and, with ``discrete``, the mask's uniforms."""
        self.n_rejuvenations += 1
        lanes = state.lanes  # on a lane mesh: every lane's parameters, each rank keeping its own after
        weights = state.normalized_weights()
        stacked = lanes.gather(context.stack_parameters(constrained=False))  # (K, D)
        indices = self._resampler(generator, weights, normalized=True)

        jittered = self._kernel.jitter(generator, stacked, weights, indices)
        if self._disc:
            to_jitter = self.jitter_mask(generator, stacked.shape[0], stacked)
            jittered = (1.0 - to_jitter) * stacked[indices.long()] + to_jitter * jittered

        new_context = context.unstack_parameters(lanes.local(jittered), constrained=False)
        state.filter_state = state.filter_state.resample(lanes.local(indices), entire_history=False, lanes=lanes)
        state.w = torch.zeros_like(state.w)
        return OnlineUpdate(new_context, filter_.initialize_model(new_context), state)
