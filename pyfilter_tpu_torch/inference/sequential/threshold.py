"""Rejuvenation-threshold schedules (counterpart of
``pyfilter_tpu/inference/sequential/threshold.py``; the constant one)."""

from __future__ import annotations


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
