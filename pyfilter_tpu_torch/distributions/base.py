"""Distribution base class.

Counterpart of ``pyfilter_tpu/distributions/base.py``: ``sample``,
``log_prob``, ``batch_shape`` / ``event_shape``, ``support``, ``expand`` /
``to_event`` and ``equivalent_to`` (the prior check of the inference context). Parameters are
tensors, named in ``arg_names``; every draw takes an explicit
``torch.Generator`` on the parameters' device.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch

from . import constraints


class Distribution:
    #: names of the tensor parameters, in order
    arg_names: tuple = ()

    @property
    def batch_shape(self) -> tuple:
        raise NotImplementedError

    @property
    def event_shape(self) -> tuple:
        return ()

    def sample(self, generator: torch.Generator, sample_shape: Sequence[int] = ()) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def support(self) -> constraints.Constraint:
        return constraints.real

    def expand(self, batch_shape) -> "Distribution":
        """The same distribution with every parameter broadcast to
        ``batch_shape`` (each parameter keeps its trailing event axes)."""
        batch_shape = tuple(batch_shape)
        cur_batch = tuple(self.batch_shape)
        new = copy.copy(self)
        for name in self.arg_names:
            leaf = torch.as_tensor(getattr(self, name))
            extra = max(leaf.dim() - len(cur_batch), 0)
            setattr(new, name, leaf.expand(batch_shape + tuple(leaf.shape[leaf.dim() - extra:])))
        return new

    def to_event(self, reinterpreted_batch_ndims: int = 1) -> "Distribution":
        """Reinterpret the trailing ``reinterpreted_batch_ndims`` batch axes
        as event axes."""
        from .independent import Independent

        if reinterpreted_batch_ndims == 0:
            return self
        return Independent(self, reinterpreted_batch_ndims)

    def equivalent_to(self, other: "Distribution") -> bool:
        """Same class with numerically equal parameters."""
        if type(self) is not type(other):
            return False
        for name in self.arg_names:
            a = torch.as_tensor(getattr(self, name))
            b = torch.as_tensor(getattr(other, name), device=a.device)
            if a.shape != b.shape or not torch.allclose(a, b):
                return False
        return True
