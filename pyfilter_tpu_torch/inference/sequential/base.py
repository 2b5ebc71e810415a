"""Sequential particle algorithms: the outer layer of nested SMC.

Counterpart of ``pyfilter_tpu/inference/sequential/base.py``, as the
reference library runs it: ``fit`` is a Python loop of one filter move over
all parameter lanes per observation, with the rejuvenation trigger read on
the host at each (one device-to-host sync per observation). The JAX
package's chunked scans, and the chunked hybrid ``fit`` built on them, exist
only to spare XLA recompiles and TPU round trips, and are not ported.

Callbacks (:meth:`SequentialParticleAlgorithm.register_callback`, such as
the collectors of :mod:`.collectors`) run after each observation's move and
before the iteration count moves on. In the JAX package a registered
callback forces the per-step loop instead of the chunked scan; the port's
``fit`` is always the per-step loop, so there is nothing to switch.

``mesh`` (a ``DeviceMesh`` of ``parallel.make_mesh``) shards the run over
ranks, one process each, all called with the same arguments and the same
seed. Over the mesh's ``lane_axis`` each rank holds K / P of the parameter
lanes: its context, filter and state carry its own lanes, and the cross-lane
operations (the trigger's ESS, the lane resample, the proposal's fit, the
acceptance rate, the distance stop, the waste-free roots, the jitter) gather
the small lane vectors and run the one-process arithmetic on every rank.
Over ``particle_axis`` each filter's cloud shards too
(``parallel.sharding.particle_sharded_filter``). Every draw is the
one-process run's (``parallel._shards.ShardedDraws``), so a lane-sharded fit
follows the one-process fit at the same seed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ...parallel._shards import lane_shard
from ...tracing import span
from ..base import BaseAlgorithm
from ..logging import DefaultLogger
from ..state import RunningFilterResult, SequentialAlgorithmState


class SequentialParticleAlgorithm(BaseAlgorithm):
    """Wires the filter's lane axis and the context's batch shape to the same
    ``num_particles`` parameter lanes (this rank's share of them, with a
    ``mesh``: module docstring)."""

    #: the rejuvenation kernel (set by algorithms that have one)
    _kernel = None

    def __init__(self, filter_, num_particles: int, context=None, generator=None, record_moments: bool = True,
                 device=None, mesh=None, lane_axis: str = "lanes", particle_axis: str | None = None):
        super().__init__(filter_, context=context, generator=generator, device=device)
        self.num_particles = int(num_particles)
        self._lanes = lane_shard(mesh, lane_axis, self.num_particles)
        lanes = self.num_particles // self._lanes.size
        self._filter = self._place_filter(self._filter.set_batch_shape((lanes,)), mesh, particle_axis)
        self.context.set_batch_shape((lanes,))
        self.record_moments = record_moments
        #: device-to-host reads of trigger values since the count was set to 0
        self.n_host_syncs = 0
        self._callbacks: List[Callable] = []

    @staticmethod
    def _place_filter(filt, mesh, particle_axis):
        """``filt`` over this rank's shard of its particles on the mesh's
        ``particle_axis``, when it has one."""
        if mesh is None or particle_axis not in (mesh.mesh_dim_names or ()):
            return filt
        from ...parallel.sharding import particle_sharded_filter

        return particle_sharded_filter(filt, mesh, particle_axis)

    @property
    def particles(self) -> tuple:
        return (self.num_particles,)

    def initialize(self) -> SequentialAlgorithmState:
        """Build the model from the context (registering and sampling the
        priors), then the filter's initial cloud over every lane."""
        with self._draws():
            self._filter = self._filter.initialize_model(self.context)
            self.context.initialize_parameters()
            self._filter = self._filter.initialize_model(self.context)
            with self._filter._declared_draws():
                init_state = self._filter.initialize(self.generator)
        zeros = torch.zeros(self.context.batch_shape, device=self.device)
        return SequentialAlgorithmState(
            zeros, RunningFilterResult(init_state, zeros.clone(), record_moments=self.record_moments), self._lanes
        )

    def register_callback(self, callback):
        """Call ``callback(algorithm, y, state)`` after every observation's
        move, ``y`` on the device (once per callback, however often it is
        registered)."""
        if callback is None or callback in self._callbacks:
            return
        self._callbacks.append(callback)

    def step(self, y, state: SequentialAlgorithmState) -> SequentialAlgorithmState:
        """One observation's move (``y`` on the host), then the callbacks,
        which get the observation on the device: the one copy the filter
        move also reads."""
        with span("seq.step"):
            y = np.asarray(y, dtype=np.float32)
            y_dev = torch.as_tensor(y, device=self.device)
            with self._draws():
                result = self._step(y, y_dev, state)
            for cb in self._callbacks:
                cb(self, y_dev, result)
            result.bump_iteration()
            return result

    def _step(self, y, y_dev, state):
        raise NotImplementedError

    def _active_filter(self):
        """The filter that made the last move (a callback's model)."""
        return self._filter

    def _filter_step(self, y, y_dev, state: SequentialAlgorithmState):
        """One filter move over all lanes (``y`` on the host, ``y_dev`` its
        copy on the device), appended into the state."""
        correction = self._filter._filter(
            self.generator, y_dev, self._filter._nan_row(np.isnan(y)), state.filter_state.latest_state,
            first_step=state.current_iteration == 0,
        )
        state.append(correction)
        return state

    def _read_trigger(self, state: SequentialAlgorithmState) -> tuple:
        """The last parameter ESS and whether a lane weight is not finite, in
        one host read (counted in ``n_host_syncs``)."""
        with span("seq.trigger"):
            w = self._lanes.gather(state.w)  # every lane's, on a lane mesh
            ess, finite = torch.stack([state.ess[-1], torch.isfinite(w).all().to(w.dtype)]).tolist()
        self.n_host_syncs += 1
        return ess, finite == 0.0

    def _do_rejuvenate(self, state):
        """Run the rejuvenation kernel and adopt what it returns."""
        with span("seq.rejuvenate"):
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
        with span("seq.fit"), logging.initialize(self, y.shape[0]), self._draws():
            state = self.initialize()
            for yt in y:
                state = self.step(yt, state)
                logging.do_log(state.current_iteration, state)
            if self._kernel is not None:
                self.n_host_syncs += 1
                if not bool(torch.isfinite(self._lanes.gather(state.w)).all()):
                    state = self._do_rejuvenate(state)
            return state


class CombinedSequentialParticleAlgorithm(SequentialParticleAlgorithm):
    """Run one algorithm for the observations up to ``switch`` (steps 0 to
    ``switch``), then another, which takes over the first's context and
    filter. ``kwargs`` (``record_moments``, ...) apply to both stages;
    ``first_kw`` / ``second_kw`` entries override them per stage. Both stages
    draw from this algorithm's generator, on its device."""

    def __init__(
        self,
        filter_,
        num_particles: int,
        switch: int,
        first_kw: Dict[str, Any] = None,
        second_kw: Dict[str, Any] = None,
        context=None,
        generator=None,
        device=None,
        **kwargs,
    ):
        super().__init__(filter_, num_particles, context=context, generator=generator, device=device, **kwargs)
        shared = dict(kwargs, generator=self.generator, device=self.device)
        self._first = self.make_first(filter_, self.context, num_particles, **{**shared, **(first_kw or {})})
        self._second = self.make_second(filter_, self.context, num_particles, **{**shared, **(second_kw or {})})
        self._when_to_switch = int(switch)
        self._is_switched = False

    def make_first(self, filter_, context, particles, **kwargs) -> SequentialParticleAlgorithm:
        raise NotImplementedError

    def make_second(self, filter_, context, particles, **kwargs) -> SequentialParticleAlgorithm:
        raise NotImplementedError

    def do_on_switch(self, first, second, state):
        raise NotImplementedError

    def _active_filter(self):
        return (self._second if self._is_switched else self._first)._active_filter()

    def initialize(self):
        return self._first.initialize()

    def _step(self, y, y_dev, state):
        if not self._is_switched:
            if state.current_iteration <= self._when_to_switch:
                return self._first._step(y, y_dev, state)
            self._is_switched = True
            state = self.do_on_switch(self._first, self._second, state)
            self._second.context = self._first.context
            self._second.filter = self._first.filter
        return self._second._step(y, y_dev, state)
