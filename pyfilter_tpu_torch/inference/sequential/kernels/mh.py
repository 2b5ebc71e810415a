"""Particle Metropolis-Hastings rejuvenation kernel for SMC².

Counterpart of ``pyfilter_tpu/inference/sequential/kernels/mh.py``, its eager
path: resample the parameter lanes, fit the proposal MVN on the cloud before
the resample, run up to ``num_steps`` PMMH transitions over the whole
observed history (each a full re-filter), and, when the running acceptance
rate falls below the threshold, double the state-particle count and
re-filter the history once more. The acceptance rate is read on the host
once per transition. With ``distance_threshold`` the transitions also stop
early once the cloud's distance from where the rejuvenation started settles
(the JAX package's adaptive stop, after nchopin/particles): one more host
read per transition.

``waste_free`` is Dau & Chopin's (2022) waste-free rejuvenation: resample
K / (num_steps + 1) chain roots (``systematic_m``), move only those through
the transitions, on M-lane views of the context and the filter, and keep
every chain state as the new K-lane swarm — the same swarm from num_steps + 1
times fewer re-filtered lanes per transition. The JAX package runs it only
in its fused tier; the port's eager path keeps that tier's one condition
that is not about XLA: a filter that records no history.

On a lane mesh the state's ``lanes`` shard the swarm: the resample's
indices, the proposal's fit, the acceptance rate and the distance come from
every lane, gathered, and each rank keeps its own lanes of the result.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ....filters.state import ParticleFilterCorrection
from ....parallel._shards import WHOLE_LANES, LaneShard, ShardedDraws
from ....resampling import systematic, systematic_m
from ....tracing import span
from ...batch.mcmc.proposals import BaseProposal, SymmetricMH
from ...batch.mcmc.utils import run_pmmh
from ...state import RunningFilterResult, SMC2State


class TooManyIncreases(Exception):
    pass


def _all_lanes(state: ParticleFilterCorrection, lanes) -> ParticleFilterCorrection:
    """Every rank's lanes of a correction (lane axis 1 of the particle-indexed
    leaves, 0 of the per-lane ones)."""
    return ParticleFilterCorrection(
        state.x.copy(values=lanes.gather(state.x.value, 1)), lanes.gather(state.log_weights, 1),
        lanes.gather(state.log_likelihood), lanes.gather(state.prev_indices, 1), lanes.gather(state.mean),
        lanes.gather(state.variance))


class MHUpdate(NamedTuple):
    context: object
    filter_: object
    state: SMC2State


class ParticleMetropolisHastings:
    def __init__(
        self,
        num_steps: int = 1,
        proposal: BaseProposal = None,
        distance_threshold: float = None,
        acceptance_threshold: float = 0.2,
        max_increases: int = 5,
        resampler=systematic,
        waste_free: bool = False,
    ):
        self._n_steps = int(num_steps)
        self._proposal = proposal or SymmetricMH()
        self._dist_thresh = distance_threshold
        self._acceptance_threshold = acceptance_threshold
        self._max_increases = int(max_increases)
        self._increases = 0
        self._resampler = resampler
        self.waste_free = bool(waste_free)
        if self.waste_free and distance_threshold is not None:
            raise ValueError("waste_free is incompatible with distance_threshold")
        #: device-to-host reads (acceptance rates, distances) since the count
        #: was set to 0
        self.n_host_syncs = 0
        #: rejuvenations, PMMH transitions, particle doublings and
        #: rejuvenations cut short by the distance stop, since the counts were
        #: set to 0
        self.n_rejuvenations = 0
        self.n_transitions = 0
        self.n_doublings = 0
        self.n_distance_stops = 0

    @property
    def proposal(self) -> BaseProposal:
        return self._proposal

    def update(self, generator, context, filter_, state: SMC2State) -> MHUpdate:
        self.n_rejuvenations += 1
        y = state.parsed_data_host
        if self.waste_free:
            return self._waste_free_update(generator, context, filter_, state, y)
        lanes = state.lanes
        indices = lanes.local(self._resampler(generator, state.normalized_weights(), normalized=True))
        # the proposal is fitted on the cloud BEFORE the lane resample
        dist = self._proposal.build(context, state, filter_, y, generator)
        context = context.resample(indices, lanes)
        state.filter_state = state.filter_state.resample(indices, lanes=lanes)
        size = () if tuple(dist.batch_shape) else (int(state.all_weights().shape[0]),)
        old_params = None if self._dist_thresh is None else lanes.gather(context.stack_parameters(constrained=False))

        previous_distance = acceptance_rate = 0.0
        for i in range(self._n_steps):
            with span("seq.pmmh"):
                step = run_pmmh(generator, context, state, self._proposal, dist, filter_, y, size=size)
                rate = float(lanes.gather(step.accepted).float().mean())  # the transition's host sync
            context = step.context
            state.filter_state = step.filter_state
            self.n_transitions += 1
            self.n_host_syncs += 1
            acceptance_rate = (rate + i * acceptance_rate) / (i + 1)
            # abort early rather than spend transitions at a low acceptance
            if acceptance_rate < self._acceptance_threshold:
                return self._increase_states(generator, context, filter_, state)
            if old_params is None:
                continue

            # mean over parameters of the largest lane move since the start
            new_params = lanes.gather(context.stack_parameters(constrained=False))
            distance = float(torch.mean(torch.amax(torch.abs(new_params - old_params), dim=0)))
            self.n_host_syncs += 1
            if abs(distance - previous_distance) <= self._dist_thresh * previous_distance:
                if i + 1 < self._n_steps:
                    self.n_distance_stops += 1
                break
            previous_distance = distance

        state.w = state.w.new_zeros(state.w.shape)
        return MHUpdate(context, filter_.initialize_model(context), state)

    def _waste_free_update(self, generator, context, filter_, state: SMC2State, y) -> MHUpdate:
        """The waste-free rejuvenation (module docstring). The draws, in
        order: the roots' uniform, the proposal's fit, then each transition's
        (``run_pmmh``). After an abort the remaining chain positions repeat
        the last state, as the JAX package's pass-through steps do, and the
        swarm is doubled and re-filtered at K lanes."""
        if filter_.record_states or filter_.record_intermediary:
            raise ValueError("waste_free rejuvenation requires a non-recording filter")
        lanes = state.lanes
        k_total, chain_len = int(state.all_weights().shape[0]), self._n_steps + 1
        if k_total % chain_len:
            raise ValueError(
                f"waste_free needs the parameter-particle count ({k_total}) divisible by num_steps + 1 ({chain_len})"
            )
        m = k_total // chain_len
        roots = systematic_m(generator, state.normalized_weights(), m, normalized=True)
        # the proposal is fitted on the whole K-lane cloud before the resample
        dist = self._proposal.build(context, state, filter_, y, generator)
        # the M roots split over the ranks as the K lanes do
        lanes_m = lanes if lanes is WHOLE_LANES else LaneShard(lanes.group, m)
        own_roots = lanes_m.local(roots)
        ctx_m = context.resample(own_roots, lanes)
        filt_m = filter_.set_batch_shape(ctx_m.batch_shape)
        fs = RunningFilterResult(state.filter_state.latest_state.resample(own_roots, lanes),
                                 lanes.take(state.filter_state.log_likelihood, own_roots), record_moments=False)
        state_m = SMC2State(state.w.new_zeros(ctx_m.batch_shape), fs, parsed_data=state.parsed_data, lanes=lanes_m)
        size = () if tuple(dist.batch_shape) else (m,)
        thetas, latests, lls = [ctx_m.stack_parameters(constrained=False)], [fs.latest_state], [fs.log_likelihood]

        acceptance_rate, aborted = 0.0, False
        # on a lane mesh the chains' draws are sharded as the M roots are
        scope = (contextlib.nullcontext() if lanes is WHOLE_LANES
                 else ShardedDraws(getattr(filter_, "_shard", None), lanes_m))
        with scope:
            for i in range(self._n_steps):
                with span("seq.pmmh"):
                    step = run_pmmh(generator, ctx_m, state_m, self._proposal, dist, filt_m, y, size=size)
                    rate = float(lanes_m.gather(step.accepted).float().mean())  # the transition's host sync
                ctx_m = step.context
                state_m.filter_state = step.filter_state
                self.n_transitions += 1
                thetas.append(ctx_m.stack_parameters(constrained=False))
                latests.append(step.filter_state.latest_state)
                lls.append(step.filter_state.log_likelihood)
                self.n_host_syncs += 1
                acceptance_rate = (rate + i * acceptance_rate) / (i + 1)
                if acceptance_rate < self._acceptance_threshold:
                    aborted = True
                    break
        pad = chain_len - len(thetas)
        thetas, latests, lls = thetas + thetas[-1:] * pad, latests + latests[-1:] * pad, lls + lls[-1:] * pad

        # every chain state, root first: lane j * M + r is root r after j moves
        # (on a mesh: every rank's chains gathered, then this rank's lanes)
        indices = lanes.local(roots.repeat(chain_len))
        own = lanes.local(torch.arange(k_total, device=roots.device))
        thetas = torch.cat([lanes_m.gather(t) for t in thetas], dim=0).index_select(0, own)
        new_context = context.unstack_parameters(thetas, constrained=False)
        swarm = ParticleFilterCorrection.lane_concat([_all_lanes(s, lanes_m) for s in latests]).resample(own)
        new_fs = RunningFilterResult(swarm, torch.cat([lanes_m.gather(t) for t in lls], dim=0).index_select(0, own),
                                     state.filter_state.record_moments)
        for name in ("filter_means", "filter_variances"):
            rows = getattr(state.filter_state, name)
            setattr(new_fs, name, list(lanes.take(torch.stack(rows), indices, 1).unbind(0)) if rows else [])
        state.filter_state = new_fs
        if aborted:
            return self._increase_states(generator, new_context, filter_, state)
        state.w = state.w.new_zeros(state.w.shape)
        return MHUpdate(new_context, filter_.initialize_model(new_context), state)

    def _increase_states(self, generator, context, filter_, state: SMC2State) -> MHUpdate:
        """Double the state-particle count and re-filter the whole history;
        the lane weights restart from the log-likelihood gain."""
        with span("seq.double"):
            self._increases += 1
            if self._increases > self._max_increases:
                raise TooManyIncreases(f"Configuration only allows {self._max_increases}!")
            self.n_doublings += 1

            new_filter = filter_.initialize_model(context).increase_particles(2)
            new_res = new_filter.batch_filter(generator, state.parsed_data_host)
            weight = new_res.log_likelihood - state.filter_state.log_likelihood

            new_state = SMC2State(
                weight,
                RunningFilterResult.from_filter_result(new_res, record_moments=state.filter_state.record_moments),
                parsed_data=state.parsed_data,
                lanes=state.lanes,
            )
            new_state.ess = state.ess
            new_state.current_iteration = state.current_iteration
            return MHUpdate(context, new_filter, new_state)
