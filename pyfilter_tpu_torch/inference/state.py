"""Algorithm state containers.

Counterpart of ``pyfilter_tpu/inference/state.py`` (without ``state_dict``):
host-level objects holding tensors, updated per observation by the
algorithms.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..filters.state import ParticleFilterCorrection
from ..utils import get_ess, normalize


class RunningFilterResult:
    """Per-lane filter record of an online algorithm: the latest corrected
    state, the running log-likelihood and, optionally, the recorded moments.
    Lane surgery assumes one lane axis."""

    def __init__(self, latest_state: ParticleFilterCorrection, log_likelihood: torch.Tensor,
                 record_moments: bool = True):
        self.latest_state = latest_state
        self.log_likelihood = log_likelihood
        self.record_moments = record_moments
        self.filter_means: List[torch.Tensor] = []
        self.filter_variances: List[torch.Tensor] = []

    @property
    def loglikelihood(self) -> torch.Tensor:
        return self.log_likelihood

    def append(self, correction: ParticleFilterCorrection):
        self.latest_state = correction
        self.log_likelihood = self.log_likelihood + correction.log_likelihood
        if self.record_moments:
            self.filter_means.append(correction.mean)
            self.filter_variances.append(correction.variance)

    def resample(self, indices: torch.Tensor, entire_history: bool = True) -> "RunningFilterResult":
        """Gather the lanes by ``indices``; with ``entire_history=False`` the
        recorded moments are carried over as they are (the online kernel's
        choice: only the latest state and log-likelihood move)."""
        idx = indices.long()
        new = RunningFilterResult(
            self.latest_state.resample(indices), self.log_likelihood.index_select(0, idx), self.record_moments
        )
        if entire_history:
            new.filter_means = [m.index_select(0, idx) for m in self.filter_means]
            new.filter_variances = [v.index_select(0, idx) for v in self.filter_variances]
        else:
            new.filter_means = list(self.filter_means)
            new.filter_variances = list(self.filter_variances)
        return new

    def exchange(self, other, mask: torch.Tensor) -> "RunningFilterResult":
        """Lanes where ``mask`` take ``other``'s latest state and
        log-likelihood (``other`` may be a ``FilterResult`` of a re-filter)."""
        new = RunningFilterResult(
            self.latest_state.exchange(other.latest_state, mask),
            torch.where(mask, other.log_likelihood, self.log_likelihood),
            self.record_moments,
        )
        new.filter_means = list(self.filter_means)
        new.filter_variances = list(self.filter_variances)
        return new

    @classmethod
    def from_filter_result(cls, result, record_moments: bool = True) -> "RunningFilterResult":
        new = cls(result.latest_state, result.log_likelihood, record_moments)
        if record_moments:
            new.filter_means = list(result.filter_means)
            new.filter_variances = list(result.filter_variances)
        return new


class AlgorithmState:
    """Base state class."""


class FilterAlgorithmState(AlgorithmState):
    """State wrapping a filter record."""

    def __init__(self, filter_state):
        self.filter_state = filter_state

    def replicate(self, filter_state) -> "FilterAlgorithmState":
        return FilterAlgorithmState(filter_state)


def scrub_lane_increment(inc: torch.Tensor) -> torch.Tensor:
    """NaN and +inf per-lane log-likelihood increments become -inf: a lane
    whose step gave non-finite evidence is a dead lane (weight 0, and it
    fires the non-finite rejuvenation trigger), not a NaN that spreads
    through the ESS and the normalisation into every lane."""
    return torch.where(torch.isnan(inc) | (inc == math.inf), -math.inf, inc)


class SequentialAlgorithmState(FilterAlgorithmState):
    """Per-lane parameter log-weights ``w``, the parameter ESS after every
    step (device scalars) and the running filter record."""

    def __init__(self, w: torch.Tensor, filter_state: RunningFilterResult):
        super().__init__(filter_state)
        self.w = w
        self.ess: List[torch.Tensor] = [get_ess(w)]
        self.current_iteration: int = 0

    def normalized_weights(self) -> torch.Tensor:
        return normalize(self.w)

    def append(self, correction: ParticleFilterCorrection):
        """Fold in one filter step: bump the lane weights by the scrubbed
        increments and record the ESS."""
        self.filter_state.append(correction)
        self.w = self.w + scrub_lane_increment(correction.log_likelihood)
        self.ess.append(get_ess(self.w))

    def bump_iteration(self):
        self.current_iteration += 1

    def replicate(self, filter_state) -> "SequentialAlgorithmState":
        return SequentialAlgorithmState(torch.zeros_like(self.w), filter_state)


class SMC2State(SequentialAlgorithmState):
    """Adds the observations seen so far, kept on the host: SMC²'s
    rejuvenation re-filters them."""

    def __init__(self, w, filter_state, parsed_data: Optional[list] = None):
        super().__init__(w, filter_state)
        self.parsed_data: List[np.ndarray] = [np.asarray(y) for y in (parsed_data or [])]

    def append_data(self, y):
        self.parsed_data.append(np.asarray(y))

    @property
    def parsed_data_host(self) -> np.ndarray:
        return np.stack(self.parsed_data, axis=0)
