"""Algorithm state containers.

Counterpart of ``pyfilter_tpu/inference/state.py``: host-level objects
holding tensors, updated per observation by the algorithms. ``state_dict``
writes the JAX package's nested keys with numpy arrays, so a state dict of
either package loads into the other; ``load_state_dict`` puts every tensor
back on the state's own device.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..filters.state import ParticleFilterCorrection
from ..parallel._shards import WHOLE_LANES
from ..timeseries import TimeseriesState
from ..utils import get_ess, normalize


def _to_numpy(value) -> np.ndarray:
    """A tensor (on any device), a number or an array as a numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _correction_leaves(correction: ParticleFilterCorrection) -> list:
    """The correction's leaves in the JAX package's pytree order: the
    state's ``time_index`` and ``value``, then ``log_weights``,
    ``log_likelihood``, ``prev_indices``, ``mean`` and ``variance`` (its
    ``ParticleFilterCorrection`` is a NamedTuple whose ``TimeseriesState``
    flattens to ``(time_index, value)``)."""
    x = correction.x
    time_index = x.time_index if isinstance(x.time_index, torch.Tensor) else np.float32(x.time_index)
    return [time_index, x.value, *correction[1:]]


def _correction_from_leaves(leaves, like: ParticleFilterCorrection) -> ParticleFilterCorrection:
    """The inverse of :func:`_correction_leaves`: numpy (or tensor) leaves as
    a correction on ``like``'s device with ``like``'s event rank and leaf
    dtypes."""
    if len(leaves) != 7:
        raise ValueError(f"a correction has 7 leaves, the state dict {len(leaves)}")
    device = like.x.value.device
    time_index = _to_numpy(leaves[0])
    tensors = [torch.tensor(_to_numpy(leaf), device=device).to(ref.dtype)
               for leaf, ref in zip(leaves[1:], (like.x.value, *like[1:]))]
    x = TimeseriesState(float(time_index) if time_index.ndim == 0 else torch.as_tensor(time_index, device=device),
                        tensors[0], like.x.event_ndim)
    return ParticleFilterCorrection(x, *tensors[1:])


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

    def resample(self, indices: torch.Tensor, entire_history: bool = True, lanes=WHOLE_LANES) -> "RunningFilterResult":
        """Gather the lanes by ``indices``; with ``entire_history=False`` the
        recorded moments are carried over as they are (the online kernel's
        choice: only the latest state and log-likelihood move). With a
        ``parallel`` lane shard ``lanes``, this record holds the rank's lanes
        and ``indices`` are its new lanes' global ids."""
        new = RunningFilterResult(
            self.latest_state.resample(indices, lanes),
            lanes.take(self.log_likelihood, indices), self.record_moments
        )
        if entire_history and self.filter_means:
            # every step's moments in one exchange
            new.filter_means = list(lanes.take(torch.stack(self.filter_means), indices, 1).unbind(0))
            new.filter_variances = list(lanes.take(torch.stack(self.filter_variances), indices, 1).unbind(0))
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

    def state_dict(self) -> dict:
        """The running log-likelihood and the latest correction's leaves
        (:func:`_correction_leaves`), as numpy arrays."""
        return {
            "log_likelihood": _to_numpy(self.log_likelihood),
            "latest_state_leaves": [_to_numpy(leaf) for leaf in _correction_leaves(self.latest_state)],
        }

    def load_state_dict(self, state_dict: dict):
        """Adopt a state dict's log-likelihood and latest correction, on this
        record's device; a cloud of another shape raises."""
        loaded = _correction_from_leaves(state_dict["latest_state_leaves"], self.latest_state)
        if loaded.x.value.shape != self.latest_state.x.value.shape:
            raise ValueError(
                f"Seems like you're loading a different shape: "
                f"{tuple(self.latest_state.x.value.shape)} != {tuple(loaded.x.value.shape)}"
            )
        self.log_likelihood = torch.tensor(_to_numpy(state_dict["log_likelihood"]),
                                              device=self.log_likelihood.device).to(self.log_likelihood.dtype)
        self.latest_state = loaded


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
    step (device scalars) and the running filter record.

    ``lanes`` (a ``parallel`` lane shard) is the share of the lanes this
    state holds: ``w`` and the filter record are the rank's lanes, while
    :meth:`all_weights`, :meth:`normalized_weights` and the ESS are every
    lane's, the same on every rank."""

    def __init__(self, w: torch.Tensor, filter_state: RunningFilterResult, lanes=WHOLE_LANES):
        super().__init__(filter_state)
        self.w = w
        self.lanes = lanes
        self.ess: List[torch.Tensor] = [get_ess(self.all_weights())]
        self.current_iteration: int = 0

    def all_weights(self) -> torch.Tensor:
        """Every lane's log-weight."""
        return self.lanes.gather(self.w)

    def normalized_weights(self) -> torch.Tensor:
        return normalize(self.all_weights())

    def append(self, correction: ParticleFilterCorrection):
        """Fold in one filter step: bump the lane weights by the scrubbed
        increments and record the ESS."""
        self.filter_state.append(correction)
        self.w = self.w + scrub_lane_increment(correction.log_likelihood)
        self.ess.append(get_ess(self.all_weights()))

    def bump_iteration(self):
        self.current_iteration += 1

    def replicate(self, filter_state) -> "SequentialAlgorithmState":
        return SequentialAlgorithmState(torch.zeros_like(self.w), filter_state, self.lanes)

    def state_dict(self) -> dict:
        """``w``, the ESS history, the iteration and the filter record as
        numpy arrays under the JAX package's keys; with collectors
        registered, also their series under ``"collected"`` (a key the JAX
        package neither writes nor reads)."""
        res = {
            "w": _to_numpy(self.w),
            "ess": [_to_numpy(e) for e in self.ess],
            "current_iteration": self.current_iteration,
            "filter_state": self.filter_state.state_dict(),
        }
        collected = getattr(self, "collected", None)
        if collected:
            res["collected"] = {name: [_to_numpy(v) for v in rows] for name, rows in collected.items()}
        return res

    def load_state_dict(self, state_dict: dict):
        """Adopt a state dict (of either package), every tensor on this
        state's device."""
        device = self.w.device
        self.w = torch.tensor(_to_numpy(state_dict["w"]), device=device).to(self.w.dtype)
        self.ess = [torch.tensor(_to_numpy(e), device=device) for e in state_dict["ess"]]
        self.current_iteration = int(state_dict["current_iteration"])
        self.filter_state.load_state_dict(state_dict["filter_state"])
        if "collected" in state_dict:
            self.collected = {name: [torch.tensor(_to_numpy(v), device=device) for v in rows]
                              for name, rows in state_dict["collected"].items()}


class SMC2State(SequentialAlgorithmState):
    """Adds the observations seen so far, kept on the host: SMC²'s
    rejuvenation re-filters them."""

    def __init__(self, w, filter_state, parsed_data: Optional[list] = None, lanes=WHOLE_LANES):
        super().__init__(w, filter_state, lanes)
        self.parsed_data: List[np.ndarray] = [np.asarray(y) for y in (parsed_data or [])]

    def append_data(self, y):
        self.parsed_data.append(np.asarray(y))

    @property
    def parsed_data_host(self) -> np.ndarray:
        return np.stack(self.parsed_data, axis=0)

    @property
    def parsed_data_array(self) -> torch.Tensor:
        """The observations seen so far as one host tensor (the filters take
        their observations on the host)."""
        return torch.from_numpy(self.parsed_data_host)

    def state_dict(self) -> dict:
        res = super().state_dict()
        res["parsed_data"] = [np.asarray(y) for y in self.parsed_data]
        return res

    def load_state_dict(self, state_dict: dict):
        super().load_state_dict(state_dict)
        self.parsed_data = [np.asarray(y) for y in state_dict["parsed_data"]]
