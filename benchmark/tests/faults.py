"""Faults planted under the timed path, for the tests that see ``correct``
come out false: each is a context manager that patches the program."""

from __future__ import annotations

import contextlib

import torch

from pyfilter_tpu_torch.filters.particle import base as particle_base
from pyfilter_tpu_torch.filters.particle import smoothing
from pyfilter_tpu_torch.inference import state as inference_state
from pyfilter_tpu_torch.timeseries import process


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def state_unchanged():
    """Every propagation returns the state it was given (time advances)."""

    def propagate(self, generator, x):
        return x.propagate_from(values=x.value, time_increment=1.0)

    def substeps(self, generator, x, n):
        return x.propagate_from(values=x.value, time_increment=float(n))

    with _patched(process.StructuralStochasticProcess, "propagate", propagate), \
            _patched(process.AffineProcess, "propagate_substeps", substeps):
        yield


@contextlib.contextmanager
def half_left_out():
    """Half of the batch left out of each step: a propagation moves only
    the first half of the particles, the rest keep their state, and every
    mean is taken over all of them; SMC2's lane weights take the step's
    evidence on the first half of the lanes only."""
    propagate = process.StructuralStochasticProcess.propagate
    scrub = inference_state.scrub_lane_increment

    def first_half(inc):
        out = scrub(inc)
        lanes = torch.arange(out.shape[0], device=out.device) >= out.shape[0] // 2
        return torch.where(lanes, torch.zeros_like(out), out)

    def half(x, new):
        keep = torch.arange(x.value.shape[0], device=x.value.device) >= x.value.shape[0] // 2
        keep = keep.reshape((-1,) + (1,) * (x.value.dim() - 1))
        return new.propagate_from(values=torch.where(keep, x.value, new.value), time_increment=0.0)

    def moved(self, generator, x):
        return half(x, propagate(self, generator, x))

    def substeps(self, generator, x, n):
        for _ in range(n):
            x = moved(self, generator, x)
        return x

    with _patched(process.StructuralStochasticProcess, "propagate", moved), \
            _patched(process.AffineProcess, "propagate_substeps", substeps), \
            _patched(inference_state, "scrub_lane_increment", first_half):
        yield


@contextlib.contextmanager
def answer_altered(step_nats: float = 0.01, smoothed: float = 0.05):
    """Every step's log-likelihood estimate is ``step_nats`` high where the
    filters produce it, and every smoothed point ``smoothed`` high where
    the smoother gathers it."""
    log_likelihood, gather = particle_base.log_likelihood, smoothing.batched_gather

    def altered_ll(*args, **kwargs):
        return log_likelihood(*args, **kwargs) + step_nats

    def altered_gather(*args, **kwargs):
        return gather(*args, **kwargs) + smoothed

    with _patched(particle_base, "log_likelihood", altered_ll), _patched(smoothing, "batched_gather", altered_gather):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_left_out": half_left_out, "answer_altered": answer_altered}
