"""Logging hooks (counterpart of ``pyfilter_tpu/inference/logging.py``):
``DefaultLogger`` and ``TQDMWrapper`` (a no-op without ``tqdm``, which is
not a dependency of the port)."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional


class DefaultLogger:
    """Calls ``func(iteration, state)`` every ``log_every_iteration`` steps."""

    def __init__(self, func: Optional[Callable] = None, log_every_iteration: int = 1):
        self._func = func
        self._per_iter = int(log_every_iteration)

    @contextmanager
    def initialize(self, algorithm, num_iterations: int):
        try:
            self.initialize_hook(algorithm, num_iterations)
            yield self
        finally:
            self.teardown_hook()

    def initialize_hook(self, algorithm, num_iterations: int):
        pass

    def teardown_hook(self):
        pass

    def do_log(self, iteration: int, state):
        if self._func is not None and iteration % self._per_iter == 0:
            self._func(iteration, state)


class TQDMWrapper(DefaultLogger):
    """A ``tqdm`` progress bar over the iterations; a no-op when ``tqdm`` is
    not installed."""

    def __init__(self, log_every_iteration: int = 1):
        super().__init__(func=None, log_every_iteration=log_every_iteration)
        self._tqdm = None
        self._last_iteration = 0

    def initialize_hook(self, algorithm, num_iterations: int):
        try:
            from tqdm import tqdm
        except ImportError:
            self._tqdm = None
            return
        self._tqdm = tqdm(total=num_iterations, desc=str(algorithm))
        self._last_iteration = 0

    def teardown_hook(self):
        if self._tqdm is not None:
            self._tqdm.close()
            self._tqdm = None

    def do_log(self, iteration, state):
        if self._tqdm is not None:
            self._tqdm.update(iteration - self._last_iteration)
            self._last_iteration = iteration
