"""Filter result container.

Counterpart of ``pyfilter_tpu/filters/result.py`` (without recorded state
histories in this slice).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .state import ParticleFilterCorrection


class FilterResult(NamedTuple):
    """Output of a full filtering pass: the total log-likelihood estimate,
    the per-step increments, the per-step weighted moments stacked over the
    leading time axis, and the last filter state."""

    log_likelihood: torch.Tensor
    step_log_likelihoods: torch.Tensor
    filter_means: torch.Tensor
    filter_variances: torch.Tensor
    latest_state: ParticleFilterCorrection

    @property
    def loglikelihood(self) -> torch.Tensor:
        return self.log_likelihood
