"""The program's side of the AR(1) configuration: the port's linear-Gaussian
state-space model at the configuration's values."""

from __future__ import annotations


def model(pt, cfg: dict, device):
    hidden = pt.timeseries.models.AR(cfg["alpha"], cfg["beta"], cfg["sigma"], device=device)
    return pt.timeseries.LinearStateSpaceModel(hidden, (1.0, cfg["obs_sd"]))
