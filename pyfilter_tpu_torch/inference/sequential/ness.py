"""NESS and FixedWidthNESS: online joint inference by jittering the
parameter lanes (Míguez and Crisan's nested particle filter).

Counterpart of ``pyfilter_tpu/inference/sequential/ness.py``, with the
reference library's per-step loop: before each observation's filter move the
trigger is read on the host (one sync per observation, ``n_host_syncs``) and,
when it fires, the online kernel jitters the lanes.
"""

from __future__ import annotations

from ..state import SequentialAlgorithmState
from .base import SequentialParticleAlgorithm
from .kernels import NonShrinkingKernel, OnlineKernel


class BaseOnlineAlgorithm(SequentialParticleAlgorithm):
    """Jitter-rejuvenate the parameter lanes before the filter step whenever
    :meth:`do_update_particles` fires."""

    def __init__(self, filter_, particles, kernel=None, discrete: bool = False, **kwargs):
        super().__init__(filter_, particles, **kwargs)
        self._kernel = OnlineKernel(kernel=kernel or NonShrinkingKernel(), discrete=discrete)

    @property
    def kernel(self) -> OnlineKernel:
        return self._kernel

    def do_update_particles(self, state: SequentialAlgorithmState) -> bool:
        raise NotImplementedError

    def _step(self, y, y_dev, state):
        if self.do_update_particles(state):
            state = self._do_rejuvenate(state)
        return self._filter_step(y, y_dev, state)


class NESS(BaseOnlineAlgorithm):
    """Rejuvenates when the parameter ESS has fallen below ``threshold * K``
    (not before the first step) or a lane weight is not finite."""

    def __init__(self, filter_, particles, threshold: float = 0.9, **kwargs):
        super().__init__(filter_, particles, **kwargs)
        self._threshold = threshold * particles

    def do_update_particles(self, state):
        ess, nonfinite = self._read_trigger(state)
        return nonfinite or (state.current_iteration > 0 and ess < self._threshold)


class FixedWidthNESS(BaseOnlineAlgorithm):
    """Rejuvenates before every ``block_len``-th of its own steps (counted
    from 1), or when a lane weight is not finite."""

    def __init__(self, filter_, particles, block_len: int = 125, **kwargs):
        super().__init__(filter_, particles, **kwargs)
        self._bl = int(block_len)
        self._num_iterations = 0

    def do_update_particles(self, state):
        self._num_iterations += 1
        _, nonfinite = self._read_trigger(state)
        return self._num_iterations % self._bl == 0 or nonfinite
