"""Abstract inference algorithm (counterpart of ``pyfilter_tpu/inference/base.py``).

An algorithm holds a filter, a context and a ``torch.Generator`` for its own
moves, all on one ``device`` (the card unless ``device="cpu"``).
"""

from __future__ import annotations

import torch

from ..utils import resolve_device, same_device
from .context import InferenceContext
from .logging import DefaultLogger
from .state import AlgorithmState


class BaseAlgorithm:
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
