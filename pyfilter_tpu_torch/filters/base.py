"""Abstract filter: the one-observation ``filter`` move and ``batch_filter``.

Counterpart of ``pyfilter_tpu/filters/base.py``. The JAX package's
``lax.scan`` over time is a Python loop here (PyTorch runs eagerly), and its
all-NaN ``lax.cond`` is decided on the host copy of the observations, so it
costs no device sync. A filter takes a model, or a model *builder* (a
callable taking an inference context) that :meth:`initialize_model` runs;
``batch_shape`` runs that many independent filters as lanes of one cloud.

``record_states=True`` records the history t = 0..T (initial state first)
into leaves preallocated on the device, one row written per step (a list
stacked at the end would double the peak: at N = 1e6 and T = 200 the leaves
take 2.4 GB). ``record_states=k`` keeps the last ``k`` states in a rolling
buffer. ``record_intermediary`` with ``observe_every_step > 1`` also records
every sub-step, which then runs one propagation at a time instead of the
batched ``propagate_substeps``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..tracing import span
from ..utils import draws_of, resolve_device, same_device
from .result import FilterHistory, FilterResult
from .state import ParticleFilterCorrection, ParticleFilterPrediction


class BaseFilter:
    """Abstract filter over a :class:`~pyfilter_tpu_torch.timeseries.StateSpaceModel`
    (or a builder of one) on ``device`` (the card unless ``device="cpu"``).
    ``nan_strategy="skip"`` propagates without correcting on an all-NaN
    observation; ``nan_strategy="impute"`` first fills the NaN components of
    a partly or wholly missing observation with the weighted predicted
    observation mean, then corrects. ``batch_shape`` lanes are independent filters whose model
    parameters carry the lane axes. ``record_states`` (``True`` or a bound
    ``k``) and ``record_intermediary`` record the history (module docstring)."""

    def __init__(
        self,
        model,
        record_states=False,
        record_intermediary: bool = False,
        nan_strategy: str = "skip",
        batch_shape=(),
        device=None,
    ):
        if nan_strategy not in ("skip", "impute"):
            raise ValueError(f"unknown nan_strategy '{nan_strategy}'")
        self.device = resolve_device(device)
        if callable(model) and not hasattr(model, "hidden"):
            self.model, self.model_builder = None, model
        else:
            self.model, self.model_builder = None, None
            self._set_model(model)
        self.record_states = record_states
        self.record_intermediary = record_intermediary
        self.nan_strategy = nan_strategy
        self.batch_shape = tuple(batch_shape)

    def _set_model(self, model):
        if not same_device(model.device, self.device):
            raise ValueError(f"the model lies on {model.device}, the filter on {self.device}")
        self.model = model

    def replace(self, **kwargs) -> "BaseFilter":
        """A shallow copy with the given attributes replaced (``model`` is
        checked against the filter's device)."""
        new = copy.copy(self)
        model = kwargs.pop("model", None)
        for name, value in kwargs.items():
            if not hasattr(self, name):
                raise TypeError(f"unknown field: {name}")
            setattr(new, name, value)
        if model is not None:
            new._set_model(model)
        return new

    def initialize_model(self, context) -> "BaseFilter":
        """A filter whose model is built from ``context`` by the builder, with
        the prior check off (every parameter update rebuilds the model)."""
        if self.model_builder is None:
            raise ValueError("filter was not constructed with a model builder")
        with context.no_prior_verification():
            model = self.model_builder(context)
        return self.replace(model=model)

    def set_batch_shape(self, batch_shape) -> "BaseFilter":
        """A filter over ``batch_shape`` parallel lanes."""
        return self.replace(batch_shape=tuple(batch_shape))

    def _declared_draws(self):
        """The layout of this filter's draws, declared to the draw mode of a
        sharded run (``utils.draws_of``): the cloud's ``(N, *batch)`` (where
        the filter has particles) and the lanes' ``batch``."""
        return draws_of(getattr(self, "particles", None), self.batch_shape)

    # -- abstract ------------------------------------------------------------
    def initialize(self, generator) -> ParticleFilterCorrection:
        raise NotImplementedError

    def predict(self, generator, state) -> ParticleFilterPrediction:
        raise NotImplementedError

    def correct(self, generator, y, prediction) -> ParticleFilterCorrection:
        raise NotImplementedError

    # -- single observation step ---------------------------------------------
    def step(self, generator, y, state, first_step: bool = False) -> ParticleFilterCorrection:
        """One filter move, :meth:`filter` (the JAX package compiles it for
        the sequential algorithms; PyTorch runs it as it stands)."""
        return self.filter(generator, y, state, first_step=first_step)

    def filter(self, generator, y, state, first_step: bool = False, return_intermediaries: bool = False):
        """One filter move: predict, ``observe_every_step - 1`` uncorrected
        sub-steps (none on the first observation, whose time is already
        aligned), then correct — or propagate only when ``y`` is all NaN.
        ``y`` is a host value (a float or a numpy array).

        ``return_intermediaries`` also returns the sub-steps, one propagation
        at a time, as ``(time_indexes, values, log_weights, indices)``
        stacked ``(n_sub, ...)`` (the time indexes on the host), or None when
        the move has no sub-step."""
        y_host = np.asarray(y, dtype=np.float32)
        y_dev = torch.as_tensor(y_host, device=self.device)
        subs = [] if return_intermediaries else None
        correction = self._filter(generator, y_dev, self._nan_row(np.isnan(y_host)), state, first_step,
                                  on_substep=None if subs is None else subs.append)
        if subs is None:
            return correction
        if not subs:
            return correction, None
        times = torch.tensor([p.x.time_index for p in subs], dtype=torch.float32)
        return correction, (times, torch.stack([p.x.value for p in subs]),
                            torch.stack([p.log_weights for p in subs]), torch.stack([p.indices for p in subs]))

    def _nan_row(self, nan_mask: np.ndarray) -> str | None:
        """What a row's NaN components ask of the step, decided on the host:
        ``"skip"`` (all NaN, skipping), ``"impute"`` (some NaN, imputing) or
        None (correct as it stands)."""
        if self.nan_strategy == "impute":
            return "impute" if nan_mask.any() else None
        return "skip" if nan_mask.all() else None

    def _impute(self, generator, y, prediction) -> torch.Tensor:
        """``y`` with its NaN components filled by the weighted mean of the
        observation density over the cloud propagated once."""
        x_new = self.model.hidden.propagate(generator, prediction.get_timeseries_state())
        obs_mean = self.model.build_density(x_new).mean  # (N, *batch, *event_y)
        w = prediction.normalized_weights
        w = w.reshape(tuple(w.shape) + (1,) * (obs_mean.dim() - w.dim()))
        return torch.where(torch.isnan(y), torch.sum(w * obs_mean, dim=0), y)

    def _filter(self, generator, y, nan_row: str | None, state, first_step: bool, on_substep=None):
        """:meth:`filter` on a device ``y`` whose NaN handling ``nan_row``
        (:meth:`_nan_row`) gives; ``on_substep(prediction)``, when given,
        sees every sub-step's prediction (one propagation at a time). Its
        draws are declared to a sharded run (:meth:`_declared_draws`)."""
        with span("filter.step"), self._declared_draws():
            n_sub = 0 if first_step else self.model.observe_every_step - 1
            with span("filter.predict"):
                prediction = self.predict(generator, state)
            if n_sub:
                with span("filter.propagate"):
                    if on_substep is None:
                        x_new = self.model.hidden.propagate_substeps(generator, prediction.x, n_sub)
                        prediction = prediction._replace(x=x_new)
                    else:
                        for _ in range(n_sub):
                            prediction = prediction._replace(x=self.model.hidden.propagate(generator, prediction.x))
                            on_substep(prediction)
            if nan_row == "skip":
                return prediction.create_state_from_prediction(
                    generator, self.model, compute_moments=getattr(self, "record_moments", True),
                    shard=getattr(self, "_shard", None)
                )
            if nan_row == "impute":
                y = self._impute(generator, y, prediction)
            with span("filter.correct"):
                return self.correct(generator, y, prediction)

    # -- full pass ------------------------------------------------------------
    def batch_filter(self, generator, y, initial_state: ParticleFilterCorrection | None = None) -> FilterResult:
        """Filter a whole observation sequence ``y`` (time axis leading).

        ``generator``: a ``torch.Generator`` on the filter's device. ``y`` is
        copied to the device once; its host copy decides the NaN handling of
        each step."""
        with span("filter.pass"):
            if isinstance(y, torch.Tensor):
                y = y.detach().cpu().numpy()
            y_host = np.asarray(y, dtype=np.float32)
            n_steps = y_host.shape[0]
            if n_steps == 0:
                raise ValueError("empty observation sequence")
            nan_mask = np.isnan(y_host.reshape(n_steps, -1))
            y_dev = torch.as_tensor(y_host, device=self.device)

            if initial_state is None:
                with self._declared_draws():
                    initial_state = self.initialize(generator)
            state = initial_state
            recorder = self._recorder(state, n_steps)
            on_substep = recorder.record_substep if recorder is not None and recorder.intermediary else None
            lls, means, variances = [], [], []
            for t in range(n_steps):
                state = self._filter(generator, y_dev[t], self._nan_row(nan_mask[t]), state, first_step=t == 0,
                                     on_substep=None if t == 0 else on_substep)
                if recorder is not None:
                    recorder.record(state)
                lls.append(state.log_likelihood)
                means.append(state.mean)
                variances.append(state.variance)

            step_lls = torch.stack(lls)
            return FilterResult(
                # each lane's steps summed along a contiguous row: the bits of a
                # lane then do not depend on how many lanes run beside it (a
                # lane-sharded run's are the one-process run's)
                log_likelihood=torch.sum(step_lls.movedim(0, -1).contiguous(), dim=-1),
                step_log_likelihoods=step_lls,
                filter_means=torch.stack(means),
                filter_variances=torch.stack(variances),
                latest_state=state,
                states=None if recorder is None else recorder.history(),
            )

    def batch_filter_masked(self, generator, y_padded, n_valid) -> FilterResult:
        """Filter the first ``n_valid`` rows of ``y_padded`` (see
        :func:`pad_observations`), as :meth:`batch_filter` of them would, on
        the same draws. The per-step log-likelihoods keep ``y_padded``'s
        length, 0 past ``n_valid``; no moments or history are kept, and a
        recording filter raises. The JAX package compiles one program per
        padded length; here the rows past ``n_valid`` are simply not run."""
        if self.record_states or self.record_intermediary:
            raise ValueError("batch_filter_masked cannot record states")
        if isinstance(y_padded, torch.Tensor):
            y_padded = y_padded.detach().cpu().numpy()
        n_valid = int(n_valid)
        if not 0 < n_valid <= len(y_padded):
            raise ValueError(f"n_valid={n_valid} outside [1, {len(y_padded)}]")
        res = self.batch_filter(generator, np.asarray(y_padded)[:n_valid])
        lls = res.step_log_likelihoods
        step_lls = torch.cat([lls, lls.new_zeros((len(y_padded) - n_valid,) + tuple(lls.shape[1:]))])
        return FilterResult(res.log_likelihood, step_lls, None, None, res.latest_state)

    def _recorder(self, state0, n_steps: int) -> "_HistoryRecorder | None":
        """The history recorder ``record_states`` asks for, holding ``state0``."""
        rs = self.record_states
        if rs is False or rs is None:
            return None
        total = n_steps + 1
        if rs is True:
            intermediary = bool(self.record_intermediary) and self.model.observe_every_step > 1 and n_steps > 1
            rows = 2 + (n_steps - 1) * self.model.observe_every_step if intermediary else total
            return _HistoryRecorder(state0, rows, intermediary=intermediary)
        if not isinstance(rs, int) or rs < 2 or rs > total:
            raise ValueError(f"record_states={rs} must be True or an int in [2, num_observations + 1]")
        if self.record_intermediary:
            raise ValueError("bounded record_states cannot record intermediaries")
        return _HistoryRecorder(state0, rs, rolling=True)


def pad_observations(y, bucket: int | None = None):
    """``y``'s time axis padded with zeros to the next power of two (or to
    ``bucket``), for :meth:`BaseFilter.batch_filter_masked`. Returns
    ``(y_padded, n_valid)``: a numpy array for a numpy ``y`` (the filters
    take their observations on the host), a tensor on ``y``'s device for a
    tensor."""
    t = y.shape[0]
    if bucket is None:
        bucket = 1 << max(t - 1, 0).bit_length()
    if bucket < t:
        raise ValueError(f"bucket {bucket} shorter than the sequence {t}")
    if isinstance(y, torch.Tensor):
        return torch.cat([y, y.new_zeros((bucket - t,) + tuple(y.shape[1:]))]), t
    y = np.asarray(y)
    out = np.zeros((bucket,) + y.shape[1:], y.dtype)
    out[:t] = y
    return out, t


class _HistoryRecorder:
    """History leaves preallocated on the device (``rows`` states), one row
    written per recorded state; ``rolling`` keeps the last ``rows`` states
    in a ring, unrolled by :meth:`history`."""

    def __init__(self, state0, rows: int, intermediary: bool = False, rolling: bool = False):
        leaves = (state0.x.value, state0.log_weights, state0.prev_indices)
        self.buffers = [torch.empty((rows,) + tuple(a.shape), dtype=a.dtype, device=a.device) for a in leaves]
        self.rows, self.intermediary, self.rolling = rows, intermediary, rolling
        self.times: list[float] = []
        self._write(state0.x.time_index, leaves)

    def _write(self, time_index: float, leaves):
        slot = len(self.times) % self.rows
        for buf, leaf in zip(self.buffers, leaves):
            buf[slot] = leaf
        self.times.append(time_index)

    def record(self, state):
        """A corrected (or propagated) state."""
        self._write(state.x.time_index, (state.x.value, state.log_weights, state.prev_indices))

    def record_substep(self, prediction):
        """A sub-step's state, with the weights and indices it carries."""
        self._write(prediction.x.time_index, (prediction.x.value, prediction.log_weights, prediction.indices))

    def history(self) -> FilterHistory:
        buffers = self.buffers
        if self.rolling:
            buffers = [torch.roll(b, -(len(self.times) % self.rows), dims=0) for b in buffers]
        return FilterHistory(torch.tensor(self.times[-self.rows:], dtype=torch.float32), *buffers)
