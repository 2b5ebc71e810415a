"""Rejuvenation-threshold schedules (counterpart of
``pyfilter_tpu/inference/sequential/threshold.py``)."""

from __future__ import annotations

from math import exp, log
from typing import Dict, List, Tuple


class Thresholder:
    """Decides the relative-ESS threshold at which to rejuvenate."""

    def __init__(self, min_thresh: float, start_thresh: float):
        self._min = min_thresh
        self._start = start_thresh

    def _mutate_thresh(self, iteration: int, starting_threshold: float) -> float:
        raise NotImplementedError

    def get_threshold(self, iteration: int) -> float:
        return max(self._mutate_thresh(iteration, self._start), self._min)


class ConstantThreshold(Thresholder):
    def __init__(self, threshold: float):
        super().__init__(threshold, threshold)

    def _mutate_thresh(self, iteration, starting_threshold):
        return starting_threshold


class DecayingThreshold(Thresholder):
    """Exponential decay from ``start_thresh`` with the given half life, down
    to ``min_thresh``."""

    def __init__(self, min_thresh: float, start_thresh: float, half_life: int = 1_000):
        super().__init__(min_thresh, start_thresh)
        self._alpha = log(2.0) / half_life

    def _mutate_thresh(self, iteration, starting_threshold):
        return exp(-self._alpha * iteration) * starting_threshold


class IntervalThreshold(Thresholder):
    """Step-function thresholds: a ``{upper_iteration: threshold}`` table, then
    ``ending_threshold``."""

    def __init__(self, thresholds: Dict[int, float], ending_threshold: float):
        super().__init__(ending_threshold, ending_threshold)
        self._thresholds: List[Tuple[int, float]] = sorted(thresholds.items(), key=lambda u: u[0])

    def _mutate_thresh(self, iteration, starting_threshold):
        return next((u[1] for u in self._thresholds if iteration <= u[0]), self._min)
