"""Inference context: the named parameter and prior store.

Counterpart of ``pyfilter_tpu/inference/context.py``. Model builders call
``context.named_parameter(name, prior)``; the first call samples the parameter's lanes from the prior with
the context's ``torch.Generator``, on the context's ``device``. ``resample``,
``exchange`` and ``unstack_parameters`` return new contexts; algorithms
``absorb`` them into the context the user holds, so that handle always shows
the current posterior. :class:`QuasiInferenceContext` re-initializes the
parameters from scrambled Sobol points; its clones carry no engine, as in the
JAX package. ``state_dict`` writes the values and the priors' leaves as numpy
arrays under the JAX package's keys, so a checkpoint of either package loads
into the other's context; ``load_state_dict`` refuses one whose priors
disagree with this context's and puts the values on this context's device.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ..distributions import Distribution, Independent, TransformedDistribution
from ..distributions.bijectors import Bijector
from ..utils import draws_of, resolve_device
from . import prior as prior_ops
from .parameter import PriorBoundParameter
from .qmc import EngineContainer


class NotSamePriorError(Exception):
    pass


class ParameterDoesNotExist(Exception):
    pass


class BatchShapeNotSet(Exception):
    pass


class BatchShapeAlreadySet(Exception):
    pass


def _prior_leaves(obj) -> list:
    """A prior's parameter tensors in the JAX package's pytree order: a
    distribution's ``arg_names`` in order (a wrapped distribution's base,
    then its bijector), a bijector's parameters in the order it holds
    them, each leaf as a numpy array."""
    if isinstance(obj, (Independent, TransformedDistribution)):
        parts = [obj.base_dist] + ([obj.bijector] if isinstance(obj, TransformedDistribution) else [])
    elif isinstance(obj, Distribution):
        parts = [getattr(obj, name) for name in obj.arg_names]
    elif isinstance(obj, Bijector):
        parts = [v for k, v in vars(obj).items() if k != "event_dim"]
    elif isinstance(obj, (list, tuple)):
        parts = list(obj)
    else:
        return [obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj)]
    return [leaf for part in parts for leaf in _prior_leaves(part)]


class InferenceContext:
    """Parameters, their priors and the lane ``batch_shape``, on ``device``
    (the card unless ``device="cpu"``). ``generator`` draws the prior
    samples (seeded 0 when not given)."""

    _contexts = threading.local()

    def __init__(self, generator: torch.Generator | None = None, device=None):
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self._prior_dict: Dict[str, Distribution] = OrderedDict()
        self._value_dict: Dict[str, torch.Tensor] = OrderedDict()
        self._shape_dict: Dict[str, tuple] = OrderedDict()
        self._unconstrained_shape_dict: Dict[str, tuple] = OrderedDict()
        self.batch_shape: tuple | None = None
        self._verify_prior = True

    # -- context-manager stack -------------------------------------------------
    @classmethod
    def _stack(cls) -> list:
        if not hasattr(cls._contexts, "stack"):
            cls._contexts.stack = []
        return cls._contexts.stack

    def __enter__(self):
        self._stack().append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._stack().remove(self)
        return False

    @classmethod
    def get_context(cls) -> "InferenceContext":
        if cls._stack():
            return cls._stack()[-1]
        raise Exception(f"no {cls.__name__} is active — enter one with `with make_context() as ctx:`")

    # -- configuration -----------------------------------------------------------
    def set_batch_shape(self, batch_shape):
        batch_shape = tuple(batch_shape)
        if self.batch_shape is None:
            self.batch_shape = batch_shape
        elif self.batch_shape != batch_shape:
            raise BatchShapeAlreadySet(
                f"Batch shape has already been set, and is not the same: {self.batch_shape} != {batch_shape}"
            )

    # -- registration ------------------------------------------------------------
    def named_parameter(self, name: str, prior: Distribution) -> torch.Tensor:
        """Register ``prior`` under ``name`` and return the parameter's value,
        sampled from the prior on first registration. Registering another
        prior under a known name raises, unless inside
        :meth:`no_prior_verification`."""
        if self.batch_shape is None:
            raise BatchShapeNotSet("property `batch_shape` not set! Have you called `set_batch_shape`?")
        if name in self._prior_dict:
            if not self._verify_prior or self._prior_dict[name].equivalent_to(prior):
                return self._value_dict[name]
            raise NotSamePriorError(f"parameter '{name}' is already registered under a different prior")
        if tuple(prior.batch_shape) != ():
            raise ValueError("You cannot pass a batched distribution as a prior!")

        self._prior_dict[name] = prior
        with draws_of(lanes=self.batch_shape):
            self._value_dict[name] = prior.sample(self.generator, self.batch_shape)
        self._shape_dict[name] = tuple(prior.event_shape)
        self._unconstrained_shape_dict[name] = prior_ops.unconstrained_event_shape(prior)
        return self._value_dict[name]

    # -- access --------------------------------------------------------------------
    @property
    def parameters(self) -> Dict[str, torch.Tensor]:
        return self._value_dict

    def get_parameter(self, name: str) -> torch.Tensor:
        if name in self._value_dict:
            return self._value_dict[name]
        raise ParameterDoesNotExist(f"No such parameter '{name}'!")

    def get_prior(self, name: str) -> Distribution:
        return self._prior_dict.get(name, None)

    def bound_parameter(self, name: str) -> PriorBoundParameter:
        self.get_parameter(name)
        return PriorBoundParameter(self, name)

    def get_parameters(self, constrained: bool = True) -> Iterable[Tuple[str, torch.Tensor]]:
        for k, v in self._value_dict.items():
            yield k, (v if constrained else prior_ops.get_unconstrained(self._prior_dict[k], v))

    def get_shape(self, name: str, constrained: bool = True) -> tuple:
        return self._shapes(constrained)[name]

    def update_parameter(self, name: str, value, constrained: bool = True):
        value = torch.as_tensor(value, dtype=torch.float32, device=self.device)
        if not constrained:
            value = prior_ops.get_constrained(self._prior_dict[name], value)
        self._value_dict[name] = value

    # -- stack / unstack -----------------------------------------------------------
    def _shapes(self, constrained: bool) -> Dict[str, tuple]:
        return self._shape_dict if constrained else self._unconstrained_shape_dict

    def stack_parameters(self, constrained: bool = True) -> torch.Tensor:
        """All parameters flattened to ``(batch_numel, total_event_numel)``."""
        shapes = self._shapes(constrained)
        return torch.cat(
            [v.reshape(-1, math.prod(shapes[n])) for n, v in self.get_parameters(constrained)], dim=-1
        )

    def unstack_parameters(self, x: torch.Tensor, constrained: bool = True) -> "InferenceContext":
        """A new context holding the values unstacked from ``x`` (the inverse
        of :meth:`stack_parameters`)."""
        shapes = self._shapes(constrained)
        total = sum(math.prod(s) for s in shapes.values())
        if total != x.shape[-1]:
            raise ValueError(
                f"stacked vector has {x.shape[-1]} elements but the context's "
                f"registered parameters unstack to {total}"
            )
        new = self._clone_registry()
        index = 0
        for name, prior in self._prior_dict.items():
            numel = math.prod(shapes[name])
            chunk = x[..., index : index + numel].reshape(self.batch_shape + shapes[name])
            new._value_dict[name] = chunk if constrained else prior_ops.get_constrained(prior, chunk)
            index += numel
        return new

    # -- evaluation ------------------------------------------------------------------
    def initialize_parameters(self):
        """No-op: sampling happens at registration."""

    def eval_priors(self, constrained: bool = True) -> torch.Tensor:
        total = 0.0
        for name, prior in self._prior_dict.items():
            total = total + prior_ops.eval_prior(prior, self._value_dict[name], constrained=constrained)
        return total

    # -- lane surgery ------------------------------------------------------------------
    def _clone_registry(self) -> "InferenceContext":
        new = type(self).__new__(type(self))
        new.__dict__.update(self.__dict__)
        for name in ("_prior_dict", "_value_dict", "_shape_dict", "_unconstrained_shape_dict"):
            setattr(new, name, OrderedDict(getattr(self, name)))
        return new

    def resample(self, indices: torch.Tensor, lanes=None) -> "InferenceContext":
        """Gather the parameter lanes (one lane axis, dim 0) by ``indices``.
        With ``lanes`` (a ``parallel`` lane shard) the context holds this
        rank's lanes and ``indices`` are its new lanes' global ids: the values
        are gathered first."""
        if len(self.batch_shape or ()) != 1:
            raise ValueError(f"lane resampling needs a 1-D batch shape; context has {self.batch_shape}")
        new = self._clone_registry()
        for name, v in self._value_dict.items():
            new._value_dict[name] = v.index_select(0, indices.long()) if lanes is None else lanes.take(v, indices)
        new.batch_shape = (int(indices.shape[0]),)
        return new

    def exchange(self, other: "InferenceContext", mask: torch.Tensor) -> "InferenceContext":
        """Lanes where ``mask`` is True take ``other``'s values."""
        new = self._clone_registry()
        for name, v in self._value_dict.items():
            m = mask.reshape(tuple(mask.shape) + (1,) * len(self._shape_dict[name]))
            new._value_dict[name] = torch.where(m, other.get_parameter(name), v)
        return new

    # -- transforms --------------------------------------------------------------------
    def apply_fun(self, f) -> "InferenceContext":
        """A new context (:meth:`make_new`) holding ``f`` of every parameter
        value under the same priors; its batch shape is the one ``f``
        leaves, which must agree across parameters."""
        new_values = OrderedDict((k, f(v)) for k, v in self._value_dict.items())
        batch_shapes = set()
        for k, v in new_values.items():
            shape = tuple(torch.as_tensor(v).shape)
            batch_shapes.add(shape[: len(shape) - len(self._shape_dict[k])])
        if len(batch_shapes) != 1:
            raise ValueError(f"the parameter transform produced mismatched batch shapes: {sorted(batch_shapes)}")
        new = self.make_new()
        new.set_batch_shape(batch_shapes.pop())
        for k, prior in self._prior_dict.items():
            new._prior_dict[k] = prior
            new._value_dict[k] = torch.as_tensor(new_values[k], device=self.device)
            new._shape_dict[k] = self._shape_dict[k]
            new._unconstrained_shape_dict[k] = self._unconstrained_shape_dict[k]
        return new

    def copy(self) -> "InferenceContext":
        return self.apply_fun(lambda v: v)

    def make_new(self) -> "InferenceContext":
        """An empty context of this kind on this device, sharing the
        generator."""
        return InferenceContext(generator=self.generator, device=self.device)

    def absorb(self, other: "InferenceContext") -> "InferenceContext":
        """Adopt ``other``'s values in place (the same registry)."""
        if set(other._prior_dict) != set(self._prior_dict):
            raise ValueError("cannot absorb a context with different parameters")
        self._value_dict = OrderedDict(other._value_dict)
        return self

    @contextmanager
    def no_prior_verification(self):
        """Skip the prior-equivalence check while a model is rebuilt."""
        try:
            self._verify_prior = False
            yield self
        finally:
            self._verify_prior = True

    # -- checkpointing -----------------------------------------------------------------
    def state_dict(self) -> dict:
        """``{"parameters": {name: values}, "prior": {name: [leaves]}}`` as
        numpy arrays (:func:`_prior_leaves`)."""
        res = OrderedDict()
        res["parameters"] = {k: v.detach().cpu().numpy() for k, v in self._value_dict.items()}
        res["prior"] = {k: _prior_leaves(v) for k, v in self._prior_dict.items()}
        return res

    def load_state_dict(self, state_dict: dict):
        """Adopt a state dict's values, on this context's device. Raises
        ``ValueError`` when its parameters or any prior's leaves differ
        from this context's."""
        if set(self._value_dict) != set(state_dict["parameters"]):
            raise ValueError("parameter sets differ between context and state dict")
        for k, prior in self._prior_dict.items():
            mine, theirs = _prior_leaves(prior), state_dict["prior"][k]
            if len(mine) != len(theirs) or not all(
                    np.shape(a) == np.shape(b) and np.allclose(a, b) for a, b in zip(mine, theirs)):
                raise ValueError(f"checkpoint prior for '{k}' disagrees with this context's prior")
        for k in self._prior_dict:
            value = np.asarray(state_dict["parameters"][k])
            self._value_dict[k] = torch.tensor(value, device=self.device).to(self._value_dict[k].dtype)


class QuasiInferenceContext(InferenceContext):
    """A context whose :meth:`initialize_parameters` re-draws every lane by
    inverting scrambled Sobol points on the unconstrained space, one point per
    lane, parameter by parameter in registration order. ``randomize`` adds
    the engine's constant random shift; the engine's seed is drawn from
    ``generator``. The engine lives on this context only: a clone
    (``resample``, ``exchange``, ``unstack_parameters``) carries none, so a
    proposal fitted on a clone samples pseudo-randomly."""

    def __init__(self, generator: torch.Generator | None = None, device=None, randomize: bool = True):
        super().__init__(generator=generator, device=device)
        self.quasi_engine: EngineContainer | None = None
        self._randomize = randomize

    def initialize_parameters(self):
        dims = [math.prod(self._unconstrained_shape_dict[n]) for n in self._prior_dict]
        # one host read, once per fit
        seed = int(torch.randint(2**31 - 1, (), generator=self.generator, device=self.device))
        self.quasi_engine = EngineContainer(sum(dims), self._randomize, seed=seed, device=self.device)
        probs = self.quasi_engine.sample(self.batch_shape)
        index = 0
        for (name, prior), numel in zip(self._prior_dict.items(), dims):
            shape = self._unconstrained_shape_dict[name]
            p = probs[..., index : index + numel].reshape(self.batch_shape + shape)
            unconstrained = prior_ops.inverse_sample(prior, p, constrained=False)
            self._value_dict[name] = prior_ops.get_constrained(prior, unconstrained)
            index += numel

    def _clone_registry(self) -> "QuasiInferenceContext":
        new = super()._clone_registry()
        new.quasi_engine = None
        return new

    def make_new(self) -> "QuasiInferenceContext":
        return QuasiInferenceContext(generator=self.generator, device=self.device, randomize=self._randomize)


def make_context(use_quasi: bool = False, randomize: bool = True, generator: torch.Generator | None = None,
                 device=None) -> InferenceContext:
    """An inference context on ``device`` (the card unless ``device="cpu"``);
    with ``use_quasi``, a :class:`QuasiInferenceContext`."""
    if use_quasi:
        return QuasiInferenceContext(generator=generator, device=device, randomize=randomize)
    return InferenceContext(generator=generator, device=device)
