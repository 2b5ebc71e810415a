"""Gaussian marginal-likelihood adapter: exact-likelihood batch inference.

Counterpart of ``pyfilter_tpu/filters/marginal.py``. Wraps the Gaussian
filters in the model-builder / lane-batch protocol the batch algorithms
consume (``set_batch_shape``, ``initialize_model``, ``replace``,
``batch_filter(generator, y)``), so :class:`~pyfilter_tpu_torch.inference.PMMH`
and :class:`~pyfilter_tpu_torch.inference.TemperedSMC` run on exact Gaussian
likelihoods instead of particle estimates. ``kind``: ``"ekf"``, ``"ukf"``,
``"ckf"``, ``"gsf"`` or ``"imm"`` (the builder then returns a
:class:`~pyfilter_tpu_torch.filters.imm.MarkovSwitchingModel`).

Lane batching is ``torch.func.vmap`` over the model's tensor leaves
(``filters/_lane.py``). ``KalmanFilter`` reads its matrices on the host and
cannot be lane-batched; ``kind="ekf"`` reduces to it exactly on a linear
model. The JAX package's ``use_jit`` and pytree registration are XLA
machinery and are not ported.

On the card a pass is host-bound (hundreds of small operations a step, each
dispatched through the vmap), so from the second pass at a given model
structure and shapes its recursion is captured as a CUDA graph and every
later one replays it with the new leaves, initial state and observations
copied in (:meth:`GaussianMarginalFilter._graphed_pass`). The initial state
is computed eagerly every pass, outside the graph: it may read the host (the
GSF's ``eigh`` reads its error flag back; the IMM checks a concrete matrix's
rows). The key of a graph holds the model's static parts by value (Python
numbers, strings, which functions), and ``replace`` with another builder
starts with no graph; what a function closes over is part of the captured
program all the same, and must not change between passes of one builder.
"""

from __future__ import annotations

import torch

from ..utils import cuda_graph, resolve_device
from ._lane import lane_vmap_batch_filter, lane_vmap_initialize, model_leaves, rebuild, refill, state_tensors, structure
from ._masked import observations
from .gsf import GAUSSIAN_BASES, GaussianSumFilter
from .imm import InteractingMultipleModel, MarkovSwitchingModel

_KINDS = ("ekf", "ukf", "ckf", "gsf", "imm")


class GaussianMarginalFilter:
    """Model-builder filter whose ``batch_filter`` evaluates the Gaussian
    marginal likelihood of every parameter lane, on ``device`` (the card
    unless ``device="cpu"``). ``batch_filter(generator, y)`` takes the
    generator for the protocol's sake: these filters draw nothing.
    ``record_states`` / ``record_intermediary`` are always False."""

    record_states = False
    record_intermediary = False

    def __init__(self, model_builder, kind: str = "ekf", batch_shape=(), device=None, **filter_kwargs):
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {sorted(_KINDS)}")
        self.device = resolve_device(device)
        self.model_builder = model_builder
        self.kind = kind
        self.batch_shape = tuple(batch_shape)
        self.filter_kwargs = tuple(sorted(filter_kwargs.items()))
        self.model = None
        #: the passes seen and captured on the card, by structure and shapes
        #: (shared by every ``replace`` copy with the same builder)
        self._graphs = {}

    def replace(self, **kwargs) -> "GaussianMarginalFilter":
        obj = type(self)(
            kwargs.pop("model_builder", self.model_builder),
            kind=kwargs.pop("kind", self.kind),
            batch_shape=kwargs.pop("batch_shape", self.batch_shape),
            device=self.device,
        )
        obj.filter_kwargs = kwargs.pop("filter_kwargs", self.filter_kwargs)
        obj.model = kwargs.pop("model", self.model)
        if obj.model_builder is self.model_builder:
            obj._graphs = self._graphs
        if kwargs:
            raise TypeError(f"unknown fields: {sorted(kwargs)}")
        return obj

    def set_batch_shape(self, batch_shape) -> "GaussianMarginalFilter":
        batch_shape = tuple(batch_shape)
        if len(batch_shape) > 1:
            raise ValueError("GaussianMarginalFilter supports one lane axis")
        return self.replace(batch_shape=batch_shape)

    def initialize_model(self, context) -> "GaussianMarginalFilter":
        with context.no_prior_verification():
            model = self.model_builder(context)
        if self.kind == "imm":
            if not isinstance(model, MarkovSwitchingModel):
                raise TypeError(f"kind='imm' builders must return a MarkovSwitchingModel (got {type(model).__name__})")
            # the matrix and probabilities as tensors on the device: leaves of
            # the pass, copied to the card here and not inside it
            model = model._replace(**{name: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                                      for name, v in (("transition_matrix", model.transition_matrix),
                                                      ("initial_probs", model.initial_probs)) if v is not None})
        return self.replace(model=model)

    def _make(self, model):
        kw = dict(self.filter_kwargs, device=self.device)
        if self.kind in GAUSSIAN_BASES:
            return GAUSSIAN_BASES[self.kind](model, **kw)
        if self.kind == "gsf":
            return GaussianSumFilter(model, **kw)
        return InteractingMultipleModel(model, **kw)

    def batch_filter(self, generator, y):
        """One filtering pass; the result's leaves carry the lane axis
        (``log_likelihood`` has the shape ``batch_shape``)."""
        if self.model is None:
            raise ValueError("no model: call initialize_model(context) first")
        y = observations(y, self.device)
        model, batch_shape = self.model, self.batch_shape
        start = lane_vmap_initialize(self._make, model, batch_shape)
        leaves, start_leaves = model_leaves(model), state_tensors(start)

        def run(*inputs):
            leaves_, start_, y_ = inputs[:len(leaves)], inputs[len(leaves):-1], inputs[-1]
            return lane_vmap_batch_filter(self._make, rebuild(model, leaves_), batch_shape, y_,
                                          start=refill(start, start_))

        inputs = (*leaves, *start_leaves, y)
        if self.device.type != "cuda":
            return run(*inputs)
        key = (self.kind, self.filter_kwargs, batch_shape, structure(model, values=True),
               tuple((tuple(t.shape), t.dtype) for t in inputs))
        return self._graphed_pass(key, run, inputs)

    def _graphed_pass(self, key, run, inputs):
        """``run(*inputs)`` on the card: eagerly the first time ``key`` is
        seen; the second time captured as a CUDA graph (:func:`cuda_graph`,
        whose warm-up gives the result); after that the graph replayed on
        ``inputs``. Returns a result that owns its tensors."""
        entry = self._graphs.get(key)
        if entry is None:
            self._graphs[key] = "seen"
            return run(*inputs)
        if entry == "seen":
            self._graphs[key], res = cuda_graph(run, inputs, self.device)
            return res
        return _clone(entry(*inputs))


def _clone(res):
    """A filter result whose tensors are copies (the graph's outputs are
    overwritten by its next replay)."""
    copy = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731
    fields = {name: copy(v) for name, v in res._asdict().items() if name != "latest_state"}
    return res._replace(latest_state=type(res.latest_state)(*(copy(v) for v in res.latest_state)), **fields)
