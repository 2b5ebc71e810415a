"""SISR's resample fires (``SISR.n_resamples``) an observation in the window."""


def read(run):
    fires = run.counters.get("fires")
    return None if fires is None or not run.observations else fires / run.observations
