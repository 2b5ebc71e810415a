"""``correct`` has to come out false when the timed path is broken, and the
control (the reference in bfloat16 in the program's place) has to read
above the limits. These drive the rest of a run on the CPU, skipping the
look for a card, at the sizes and limits of ``small.py``; the readings at
the cells' own sizes on the card are in PERF.md."""

from __future__ import annotations

import pytest

from benchmark import control, run, spec
from benchmark.tests import faults, small

CELLS = list(small.SIZES)
SEEDS = (5, 6, 7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, seed):
    result = run.run_cell(small.cell(name), seed, 0.0, False, "cpu")
    assert result["correct"], result["checks"]


# the faults a one-chip cell can have (no exchange between chips to leave out)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, seed, fault):
    with faults.FAULTS[fault]():
        result = run.run_cell(small.cell(name), seed, 0.0, False, "cpu")
    assert not result["correct"], result["checks"]


def _fails(readings: dict, limits: dict) -> bool:
    """The control finishes and reads above at least one limit."""
    return "error" not in readings and any(not v <= limits[k] for k, v in readings.items())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["sv-notebook.filter-n1e7", "sv-notebook.smc2-k16384"])
def test_control_is_not_correct(name, seed):
    cell = small.cell(name)
    assert _fails(control.readings(cell, seed, "cpu"), cell.limits)


@pytest.mark.parametrize("seed", SEEDS)
def test_smoothing_control_is_not_correct_at_its_own_size(seed):
    # the control of the smoothing cell is the Kalman and RTS pair in
    # bfloat16, which costs nothing at the cell's own size and limits
    cell = spec.Cell("ar1-gauss.smooth-ffbsi-n1e5")
    assert _fails(control.readings(cell, seed, "cpu"), cell.limits)
