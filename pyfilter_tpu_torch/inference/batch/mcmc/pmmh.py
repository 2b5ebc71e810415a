"""PMMH — particle marginal Metropolis-Hastings.

Counterpart of ``pyfilter_tpu/inference/batch/mcmc/pmmh.py``, its per-sample
loop: ``num_chains`` chains ride one lane axis through the filter, and every
sample is one :func:`run_pmmh` full re-filter of the data. The JAX package's
fused chain scan (``_fit_fused``, ``chunk_size``) is XLA dispatch machinery
and is not ported. ``mesh`` shards the chains over the ranks of its
``lane_axis``, one process each, all called with the same arguments and
seed: each rank runs its own chains' re-filters, and every draw is the
one-process run's (``parallel._shards.ShardedDraws``).
"""

from __future__ import annotations

import numpy as np
import torch

from ....parallel._shards import lane_shard
from ....utils import draws_of
from ...base import BaseAlgorithm
from ...logging import TQDMWrapper
from .proposals import BaseProposal, RandomWalk
from .state import PMMHResult
from .utils import run_pmmh


def top_seeds(log_likelihoods: torch.Tensor, num_chains: int) -> torch.Tensor:
    """Indices of the ``num_chains`` largest finite log-likelihoods, largest
    first (ties: the later index first, as the JAX package's reversed stable
    argsort gives)."""
    ll = torch.where(torch.isfinite(log_likelihoods), log_likelihoods, -torch.inf)
    return torch.argsort(ll, stable=True).flip(0)[:num_chains]


class PMMH(BaseAlgorithm):
    """``num_samples`` PMMH iterations of ``num_chains`` chains (lanes of one
    filter), with ``proposal`` (a ``RandomWalk`` by default) on the
    unconstrained space.

    ``initializer``: ``"mean"`` starts every chain at the prior mean (a
    ``MONTE_CARLO_SAMPLES`` estimate); ``"seed"`` draws ``num_seeds`` prior
    samples, scores them with one ``num_seeds``-lane filter pass, and starts
    the chains at the ``num_chains`` draws of highest log-likelihood (on a
    mesh every rank scores all the seeds and keeps its own chains).

    ``mesh`` (a ``parallel.make_mesh`` mesh): each rank runs ``num_chains /
    P`` of the chains, P the size of its ``lane_axis``; the chains must
    split evenly. The result holds the rank's chains."""

    MONTE_CARLO_SAMPLES = (10_000,)

    def __init__(
        self,
        filter_,
        num_samples: int,
        num_chains: int = 4,
        proposal: BaseProposal = None,
        initializer: str = "mean",
        context=None,
        generator=None,
        num_seeds: int = 200,
        device=None,
        mesh=None,
        lane_axis: str = "lanes",
    ):
        super().__init__(filter_, context=context, generator=generator, device=device)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self._lanes = lane_shard(mesh, lane_axis, self.num_chains)
        chains = self.num_chains // self._lanes.size
        self.context.set_batch_shape((chains,))
        self._filter = self._filter.set_batch_shape((chains,))
        self._proposal = proposal or RandomWalk()
        if initializer not in ("mean", "seed"):
            raise NotImplementedError(f"`{initializer}` is not configured!")
        self._initializer = initializer
        self._num_seeds = max(int(num_seeds), self.num_chains)

    def initialize(self, y: np.ndarray) -> PMMHResult:
        """Build the model, set the chains' starting values and run the
        initial filter pass."""
        with self._draws():
            self._filter = self._filter.initialize_model(self.context)
            if self._initializer == "seed":
                self._seed_chains(y)
            else:
                for name in list(self.context.parameters):
                    prior = self.context.get_prior(name)
                    with draws_of():  # prior draws, no lanes
                        mean = prior.sample(self.generator, self.MONTE_CARLO_SAMPLES).mean(dim=0)
                    self.context.update_parameter(name, mean.expand(self.context.batch_shape + tuple(prior.event_shape)))
            self._filter = self._filter.initialize_model(self.context)
            return PMMHResult(dict(self.context.parameters), self._filter.batch_filter(self.generator, y))

    def _seed_chains(self, y: np.ndarray):
        """``initializer="seed"``: the top ``num_chains`` of ``num_seeds``
        prior draws by one filter pass's log-likelihood. Returns that pass's
        filter result."""
        n_seeds = self._num_seeds
        seed_ctx = self.context._clone_registry()
        seed_ctx.batch_shape = (n_seeds,)
        for name in list(self.context.parameters):
            with draws_of():  # every seed on every rank
                seed_ctx._value_dict[name] = self.context.get_prior(name).sample(self.generator, (n_seeds,))
        seed_filter = self._filter.set_batch_shape((n_seeds,)).initialize_model(seed_ctx)
        res = seed_filter.batch_filter(self.generator, y)
        best = self._lanes.local(top_seeds(res.log_likelihood.reshape(n_seeds), self.num_chains))
        for name, v in seed_ctx.parameters.items():
            self.context.update_parameter(name, v.index_select(0, best))
        return res

    def fit(self, y, logging=None) -> PMMHResult:
        """The chains over the observations ``y`` (time axis leading; kept on
        the host). No host sync per sample: the samples stay on the device."""
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        y = np.asarray(y, dtype=np.float32)
        with self._draws():
            state = self.initialize(y)
            logging = logging or TQDMWrapper()
            with logging.initialize(self, self.num_samples):
                kernel = self._proposal.build(self.context, state, self._filter, y, self.generator)
                for i in range(self.num_samples):
                    step = run_pmmh(self.generator, self.context, state, self._proposal, kernel, self._filter, y,
                                    mutate_kernel=True)
                    self.context.absorb(step.context)
                    state.filter_state = step.filter_state
                    kernel = step.proposal_kernel
                    self._filter = self._filter.initialize_model(self.context)
                    state.update_chain(dict(self.context.parameters))
                    logging.do_log(i, state)
        return state
