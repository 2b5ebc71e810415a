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
        distance_threshold: float = None,
        waste_free: bool = False,
        **kwargs,
    ):
        """``waste_free``: the waste-free rejuvenation (``kernels/mh.py``);
        ``particles`` must then be divisible by ``num_steps + 1``."""
        super().__init__(filter_, particles, context=context, generator=generator, **kwargs)
        self._threshold = threshold if isinstance(threshold, Thresholder) else ConstantThreshold(threshold)
        if waste_free and particles % (num_steps + 1):
            raise ValueError(f"waste_free needs particles ({particles}) divisible by num_steps + 1 ({num_steps + 1})")
        self._kernel = ParticleMetropolisHastings(proposal=kernel, max_increases=max_increases, num_steps=num_steps,
                                                  distance_threshold=distance_threshold, waste_free=waste_free)

    @property
    def kernel(self) -> ParticleMetropolisHastings:
        return self._kernel

    def initialize(self) -> SMC2State:
        state = super().initialize()
        return SMC2State(state.w, state.filter_state, lanes=state.lanes)

    def _step(self, y, y_dev, state: SMC2State) -> SMC2State:
        """Append the observation, filter, accumulate the lane weights, and
        rejuvenate when the parameter ESS falls below the threshold or a
        weight is not finite."""
        state.append_data(y)
        state = self._filter_step(y, y_dev, state)
        ess, nonfinite = self._read_trigger(state)
        threshold = np.float32(self._threshold.get_threshold(state.current_iteration) * self.num_particles)
        if nonfinite or ess < threshold:
            state = self._do_rejuvenate(state)
        return state
