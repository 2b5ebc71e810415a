"""Distribution base class.

Counterpart of ``pyfilter_tpu/distributions/base.py``: ``sample``,
``log_prob``, ``batch_shape`` / ``event_shape``. Parameters are tensors;
every draw takes an explicit ``torch.Generator`` on the parameters' device.
"""

from __future__ import annotations

from typing import Sequence

import torch


class Distribution:
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
