"""The ensemble Kalman filter with its members sharded over a process group.

Counterpart of ``pyfilter_tpu/parallel/enkf.py``. The EnKF couples its
members only through sample moments: the ensemble mean and the ``(d, d_y)``
and ``(d_y, d_y)`` anomaly products. So each rank carries ``M/P`` members,
runs the one-process filter's forecast and analysis on them
(``filters.enkf.EnsembleKalmanFilter``, whose member means and sums go
through the hooks this module all-reduces), and exchanges O(d * d_y) a step
by all-reduce: no gather, no resample. The localization taper applies after
the sums, to the replicated products. Each rank's draws (its initial
members, their forecasts, their observation perturbations) come from its own
generator (``spmd._rank_stream``).
"""

from __future__ import annotations

import torch

from ..filters._masked import observations
from ..filters.enkf import EnKFState, EnsembleKalmanFilter
from ..filters.result import FilterResult
from . import _comm
from .spmd import _axis, _check_model, _rank_stream

__all__ = ["spmd_enkf"]


class _ShardedEnsemble(EnsembleKalmanFilter):
    """:class:`EnsembleKalmanFilter` over this rank's ``ensemble_size / P``
    members of ``group``: member means and sums all-reduced."""

    def __init__(self, model, ensemble_size: int, inflation: float, localization, group, size: int, device):
        super().__init__(model, ensemble_size, inflation=inflation, localization=localization, device=device)
        self.group = group
        self.n_local = self.ensemble_size // size

    def _members_sum(self, t) -> torch.Tensor:
        return _comm.all_reduce(t, "sum", self.group)

    def _members_mean(self, x) -> torch.Tensor:
        return self._members_sum(x.sum(dim=0)) / self.ensemble_size

    def initialize(self, generator) -> EnKFState:
        x0 = self.model.hidden.initial_sample(generator, (self.n_local,))
        return EnKFState(self._lift(x0.value), torch.zeros((), device=self.device), 0.0)

    def moments(self, ens) -> tuple:
        """The whole ensemble's mean and variance (unbiased)."""
        m = self._members_mean(ens)
        return m, self._members_sum(torch.square(ens - m).sum(dim=0)) / (self.ensemble_size - 1)


def spmd_enkf(model, ensemble_size: int, generator, y, mesh, axis_name: str = "particles", inflation: float = 1.0,
              localization=None) -> FilterResult:
    """A whole stochastic-EnKF pass with the ``ensemble_size`` members split
    over the mesh axis ``axis_name``; every rank calls it with the same
    arguments and a ``generator`` in the same state. Communication a step:
    all-reduces of the member means and of the anomaly products, O(d * d_y),
    whatever the ensemble size. Returns the ``FilterResult`` of
    ``EnsembleKalmanFilter.batch_filter``: the log-likelihoods and the
    per-step means and variances of the whole ensemble, the same on every
    rank, and an ``EnKFState`` holding this rank's members."""
    group, size, device = _axis(mesh, axis_name, int(ensemble_size), what="ensemble_size")
    _check_model(model, device)
    filt = _ShardedEnsemble(model, int(ensemble_size), inflation, localization, group, size, device)
    steps = filt._pass(_rank_stream(generator, group), observations(y, device))
    step_lls = torch.stack([s[2] for s in steps])
    means, variances = zip(*(filt.moments(s[1]) for s in steps))
    ll = torch.sum(step_lls)
    return FilterResult(
        log_likelihood=ll,
        step_log_likelihoods=step_lls,
        filter_means=torch.stack(means),
        filter_variances=torch.stack(variances),
        latest_state=EnKFState(steps[-1][1], ll, steps[-1][3]),
        states=None,
    )
