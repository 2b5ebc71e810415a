"""Sequential particle algorithms: the outer layer of nested SMC.

Counterpart of ``pyfilter_tpu/inference/sequential/base.py``, as the
reference library runs it: ``fit`` is a Python loop of one filter move over
all parameter lanes per observation, with the rejuvenation trigger read on
the host after each (one device-to-host sync per observation). The JAX
package's chunked scans exist only to spare XLA recompiles and TPU round
trips, and are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import BaseAlgorithm
from ..logging import DefaultLogger
from ..state import RunningFilterResult, SequentialAlgorithmState


class SequentialParticleAlgorithm(BaseAlgorithm):
    """Wires the filter's lane axis and the context's batch shape to the same
    ``num_particles`` parameter lanes."""

    #: the rejuvenation kernel (set by algorithms that have one)
    _kernel = None

    def __init__(self, filter_, num_particles: int, context=None, generator=None, record_moments: bool = True,
                 device=None):
        super().__init__(filter_, context=context, generator=generator, device=device)
        self.num_particles = int(num_particles)
        self._filter = self._filter.set_batch_shape((self.num_particles,))
        self.context.set_batch_shape((self.num_particles,))
        self.record_moments = record_moments
        #: device-to-host reads of trigger values since the count was set to 0
        self.n_host_syncs = 0

    @property
    def particles(self) -> tuple:
        return (self.num_particles,)

    def initialize(self) -> SequentialAlgorithmState:
        """Build the model from the context (registering and sampling the
        priors), then the filter's initial cloud over every lane."""
        self._filter = self._filter.initialize_model(self.context)
        self.context.initialize_parameters()
        self._filter = self._filter.initialize_model(self.context)
        init_state = self._filter.initialize(self.generator)
        zeros = torch.zeros(self.particles, device=self.device)
        return SequentialAlgorithmState(
            zeros, RunningFilterResult(init_state, zeros.clone(), record_moments=self.record_moments)
        )

    def step(self, y, state: SequentialAlgorithmState) -> SequentialAlgorithmState:
        result = self._step(y, state)
        result.bump_iteration()
        return result

    def _step(self, y, state):
        raise NotImplementedError

    def _filter_step(self, y, state: SequentialAlgorithmState):
        """One filter move over all lanes (``y`` on the host), appended into
        the state."""
        correction = self._filter.filter(
            self.generator, y, state.filter_state.latest_state, first_step=state.current_iteration == 0
        )
        state.append(correction)
        return state

    def _trigger_rows(self, t0: int, n: int):
        """Per-step trigger rows for steps ``t0 .. t0+n-1``: an ESS threshold
        vector (rejuvenate after step ``t0+j`` when ``ess < thr[j]``) and a
        boolean ``force`` schedule. Non-finite weights always trigger."""
        raise NotImplementedError

    def _chunk_trigger(self, t0: int, ess, nonfinite) -> Optional[int]:
        """First local index ``j`` such that rejuvenation must run after step
        ``t0 + j``, or None (host values)."""
        thr, force = self._trigger_rows(t0, len(ess))
        for j, (e, nf) in enumerate(zip(ess, nonfinite)):
            if nf or e < thr[j] or force[j]:
                return j
        return None

    def _do_rejuvenate(self, state):
        """Run the rejuvenation kernel and adopt what it returns."""
        update = self._kernel.update(self.generator, self.context, self._filter, state)
        self.context.absorb(update.context)
        self._filter = update.filter_
        return update.state

    def fit(self, y, logging=None) -> SequentialAlgorithmState:
        """Fit over the observations ``y`` (time axis leading; a numpy array or
        a tensor, kept on the host): one :meth:`step` per observation, then
        the end-of-data health heal — a lane that died on the last step is
        rejuvenated away, since no later trigger would see it."""
        logging = logging or DefaultLogger()
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        y = np.asarray(y, dtype=np.float32)
        with logging.initialize(self, y.shape[0]):
            state = self.initialize()
            for yt in y:
                state = self.step(yt, state)
                logging.do_log(state.current_iteration, state)
            if self._kernel is not None:
                self.n_host_syncs += 1
                if not bool(torch.isfinite(state.w).all()):
                    state = self._do_rejuvenate(state)
            return state
