"""SMC² — Chopin et al.'s nested sequential Monte Carlo.

Counterpart of ``pyfilter_tpu/inference/sequential/smc2.py``, with the
reference library's per-step loop (``SequentialParticleAlgorithm.fit``): one
filter move over all parameter lanes per observation, then the trigger
``nonfinite(w) | ess(w) < threshold * K`` read on the host (one sync), then,
when it fires, the PMMH rejuvenation. The JAX package's in-scan
rejuvenation is XLA dispatch machinery and is not ported.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..state import SMC2State
from .base import SequentialParticleAlgorithm
from .kernels import ParticleMetropolisHastings
from .threshold import ConstantThreshold, Thresholder


class SMC2(SequentialParticleAlgorithm):
    def __init__(
        self,
        filter_,
        particles: int,
        threshold: Union[float, Thresholder] = 0.2,
        kernel=None,
        max_increases: int = 5,
        context=None,
        generator=None,
        num_steps: int = 1,
        **kwargs,
    ):
        super().__init__(filter_, particles, context=context, generator=generator, **kwargs)
        self._threshold = threshold if isinstance(threshold, Thresholder) else ConstantThreshold(threshold)
        self._kernel = ParticleMetropolisHastings(proposal=kernel, max_increases=max_increases, num_steps=num_steps)

    @property
    def kernel(self) -> ParticleMetropolisHastings:
        return self._kernel

    def initialize(self) -> SMC2State:
        state = super().initialize()
        return SMC2State(state.w, state.filter_state)

    def _step(self, y, state: SMC2State) -> SMC2State:
        """Append the observation, filter, accumulate the lane weights, and
        rejuvenate when the parameter ESS falls below the threshold or a
        weight is not finite."""
        state.append_data(y)
        state = self._filter_step(y, state)
        # the step's one host sync: the ESS and the finiteness flag together
        ess, finite = torch.stack([state.ess[-1], torch.isfinite(state.w).all().to(state.w.dtype)]).tolist()
        self.n_host_syncs += 1
        if self._chunk_trigger(state.current_iteration, [ess], [finite == 0.0]) is not None:
            state = self._do_rejuvenate(state)
        return state

    def _trigger_rows(self, t0, n):
        k = self.num_particles
        thr = np.asarray([self._threshold.get_threshold(t0 + j) * k for j in range(n)], np.float32)
        return thr, np.zeros(n, np.bool_)
