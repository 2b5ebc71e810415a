"""Abstract filter: the one-observation ``filter`` move and ``batch_filter``.

Counterpart of ``pyfilter_tpu/filters/base.py``. The JAX package's
``lax.scan`` over time is a Python loop here (PyTorch runs eagerly), and its
all-NaN ``lax.cond`` is decided on the host copy of the observations, so it
costs no device sync. A filter takes a model, or a model *builder* (a
callable taking an inference context) that :meth:`initialize_model` runs;
``batch_shape`` runs that many independent filters as lanes of one cloud.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..utils import resolve_device, same_device
from .result import FilterResult
from .state import ParticleFilterCorrection, ParticleFilterPrediction


class BaseFilter:
    """Abstract filter over a :class:`~pyfilter_tpu_torch.timeseries.StateSpaceModel`
    (or a builder of one) on ``device`` (the card unless ``device="cpu"``).
    ``nan_strategy="skip"`` propagates without correcting on an all-NaN
    observation. ``batch_shape`` lanes are independent filters whose model
    parameters carry the lane axes."""

    def __init__(self, model, nan_strategy: str = "skip", batch_shape=(), device=None):
        if nan_strategy != "skip":
            raise NotImplementedError("only nan_strategy='skip' is ported")
        self.device = resolve_device(device)
        if callable(model) and not hasattr(model, "hidden"):
            self.model, self.model_builder = None, model
        else:
            self.model, self.model_builder = None, None
            self._set_model(model)
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

    # -- abstract ------------------------------------------------------------
    def initialize(self, generator) -> ParticleFilterCorrection:
        raise NotImplementedError

    def predict(self, generator, state) -> ParticleFilterPrediction:
        raise NotImplementedError

    def correct(self, generator, y, prediction) -> ParticleFilterCorrection:
        raise NotImplementedError

    # -- single observation step ---------------------------------------------
    def filter(self, generator, y, state, first_step: bool = False) -> ParticleFilterCorrection:
        """One filter move: predict, ``observe_every_step - 1`` uncorrected
        sub-steps (none on the first observation, whose time is already
        aligned), then correct — or propagate only when ``y`` is all NaN.
        ``y`` is a host value (a float or a numpy array)."""
        y_host = np.asarray(y, dtype=np.float32)
        y_dev = torch.as_tensor(y_host, device=self.device)
        return self._filter(generator, y_dev, bool(np.isnan(y_host).all()), state, first_step)

    def _filter(self, generator, y, all_nan: bool, state, first_step: bool):
        n_sub = 0 if first_step else self.model.observe_every_step - 1
        prediction = self.predict(generator, state)
        if n_sub:
            x_new = self.model.hidden.propagate_substeps(generator, prediction.x, n_sub)
            prediction = prediction._replace(x=x_new)
        if all_nan:
            return prediction.create_state_from_prediction(
                generator, self.model, compute_moments=getattr(self, "record_moments", True)
            )
        return self.correct(generator, y, prediction)

    # -- full pass ------------------------------------------------------------
    def batch_filter(self, generator, y, initial_state: ParticleFilterCorrection | None = None) -> FilterResult:
        """Filter a whole observation sequence ``y`` (time axis leading).

        ``generator``: a ``torch.Generator`` on the filter's device. ``y`` is
        copied to the device once; its host copy decides the all-NaN skips."""
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        y_host = np.asarray(y, dtype=np.float32)
        n_steps = y_host.shape[0]
        if n_steps == 0:
            raise ValueError("empty observation sequence")
        all_nan = np.isnan(y_host.reshape(n_steps, -1)).all(axis=1)
        y_dev = torch.as_tensor(y_host, device=self.device)

        state = self.initialize(generator) if initial_state is None else initial_state
        lls, means, variances = [], [], []
        for t in range(n_steps):
            state = self._filter(generator, y_dev[t], bool(all_nan[t]), state, first_step=t == 0)
            lls.append(state.log_likelihood)
            means.append(state.mean)
            variances.append(state.variance)

        step_lls = torch.stack(lls)
        return FilterResult(
            log_likelihood=torch.sum(step_lls, dim=0),
            step_log_likelihoods=step_lls,
            filter_means=torch.stack(means),
            filter_variances=torch.stack(variances),
            latest_state=state,
        )
