"""Abstract inference algorithm (counterpart of ``pyfilter_tpu/inference/base.py``).

An algorithm holds a filter, a context and a ``torch.Generator`` for its own
moves, all on one ``device`` (the card unless ``device="cpu"``).
"""

from __future__ import annotations

import contextlib

import torch

from ..parallel._shards import WHOLE_LANES, ShardedDraws
from ..utils import resolve_device, same_device
from .context import InferenceContext
from .logging import DefaultLogger
from .state import AlgorithmState


class BaseAlgorithm:
    #: this rank's share of the parameter lanes (a ``parallel`` lane shard on
    #: a mesh), and whether :meth:`_draws` is entered
    _lanes = WHOLE_LANES
    _drawing = False

    def __init__(self, filter_, context: InferenceContext = None, generator: torch.Generator = None, device=None):
        self.device = resolve_device(device)
        self._filter = filter_
        self.context = context if context is not None else InferenceContext.get_context()
        for name, dev in (("filter", filter_.device), ("context", self.context.device)):
            if not same_device(dev, self.device):
                raise ValueError(f"the {name} lies on {dev}, the algorithm on {self.device}")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator

    @contextlib.contextmanager
    def _draws(self):
        """On a mesh, every draw inside as the one-process run's
        (``parallel._shards.ShardedDraws``); entered once however deeply the
        entry points nest."""
        shard = getattr(self._filter, "_shard", None)
        if self._drawing or (shard is None and self._lanes is WHOLE_LANES):
            yield
            return
        self._drawing = True
        try:
            with ShardedDraws(shard, None if self._lanes is WHOLE_LANES else self._lanes):
                yield
        finally:
            self._drawing = False

    @property
    def filter(self):
        return self._filter

    @filter.setter
    def filter(self, value):
        self._filter = value

    def fit(self, y, logging: DefaultLogger = None) -> AlgorithmState:
        raise NotImplementedError

    def __repr__(self):
        return str(self.__class__.__name__)
