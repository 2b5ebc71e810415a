"""PMMH chain state (counterpart of ``pyfilter_tpu/inference/batch/mcmc/state.py``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ...state import FilterAlgorithmState


class PMMHResult(FilterAlgorithmState):
    """The vectorized chains' samples, one entry per iteration (the starting
    values first), kept on the device: ``samples[name]`` stacks to
    ``(num_samples + 1, num_chains, *event)``."""

    def __init__(self, initial_parameters: Dict[str, torch.Tensor], filter_state):
        super().__init__(filter_state)
        self.samples: Dict[str, List[torch.Tensor]] = {k: [v] for k, v in initial_parameters.items()}

    def update_chain(self, parameters: Dict[str, torch.Tensor]):
        for k, v in parameters.items():
            self.samples[k].append(v)

    def as_arrays(self) -> Dict[str, np.ndarray]:
        """The chains as numpy arrays on the host, one copy per parameter."""
        return {k: torch.stack(v).cpu().numpy() for k, v in self.samples.items()}
