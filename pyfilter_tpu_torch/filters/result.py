"""Filter result container and the recorded state history.

Counterpart of ``pyfilter_tpu/filters/result.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .state import ParticleFilterCorrection


class FilterHistory(NamedTuple):
    """Recorded particle states (``record_states``), time-stacked:
    ``values`` ``(T, N, *batch, *event)``, ``log_weights`` / ``prev_indices``
    ``(T, N, *batch)`` on the filter's device, ``time_indexes`` ``(T,)``
    float32 on the host (the process time is a host value)."""

    time_indexes: torch.Tensor
    values: torch.Tensor
    log_weights: torch.Tensor
    prev_indices: torch.Tensor


class FilterResult(NamedTuple):
    """Output of a full filtering pass: the total log-likelihood estimate,
    the per-step increments, the per-step weighted moments stacked over the
    leading time axis, the last filter state, with ``record_states`` the
    history, and a filter's per-step extras in ``aux``."""

    log_likelihood: torch.Tensor
    step_log_likelihoods: torch.Tensor
    filter_means: torch.Tensor
    filter_variances: torch.Tensor
    latest_state: ParticleFilterCorrection
    states: Optional[FilterHistory] = None
    #: filter-specific per-step extras, time-major with lanes second (the
    #: IMM's ``(T, K)`` regime log-probabilities), kept out of ``states``
    aux: Optional[torch.Tensor] = None

    @property
    def loglikelihood(self) -> torch.Tensor:
        return self.log_likelihood

    def resample(self, indices: torch.Tensor, entire_history: bool = True) -> "FilterResult":
        """Permute the lanes by ``indices`` ``(K,)``, the history included;
        with ``entire_history=False`` only the latest state and the
        log-likelihood."""
        idx = indices.long()
        if not entire_history:
            return self._replace(latest_state=self.latest_state.resample(idx),
                                 log_likelihood=self.log_likelihood.index_select(0, idx))
        states = self.states
        if states is not None:
            states = FilterHistory(states.time_indexes, *(h.index_select(2, idx) for h in states[1:]))
        return FilterResult(
            self.log_likelihood.index_select(0, idx),
            self.step_log_likelihoods.index_select(1, idx),
            self.filter_means.index_select(1, idx),
            self.filter_variances.index_select(1, idx),
            self.latest_state.resample(idx),
            states,
            None if self.aux is None else self.aux.index_select(1, idx),
        )

    def exchange(self, other: "FilterResult", mask: torch.Tensor) -> "FilterResult":
        """Lanes where ``mask`` ``(K,)`` is True take ``other``'s values, the
        history included."""
        lat = self.latest_state.exchange(other.latest_state, mask)

        def mix(mine, theirs, lead):
            m = mask.reshape((1,) * lead + tuple(mask.shape) + (1,) * (mine.dim() - lead - mask.dim()))
            return torch.where(m, theirs, mine)

        states = self.states
        if states is not None and other.states is not None:
            states = FilterHistory(
                states.time_indexes, *(mix(mine, theirs, 2) for mine, theirs in zip(states[1:], other.states[1:]))
            )
        return FilterResult(
            mix(self.log_likelihood, other.log_likelihood, 0),
            mix(self.step_log_likelihoods, other.step_log_likelihoods, 1),
            mix(self.filter_means, other.filter_means, 1),
            mix(self.filter_variances, other.filter_variances, 1),
            lat,
            states,
            self.aux if self.aux is None or other.aux is None else mix(self.aux, other.aux, 1),
        )
