"""The program's side of the stochastic-volatility configuration: the
port's model and SMC2 builder at the configuration's values."""

from __future__ import annotations

import functools


def model(pt, cfg: dict, device):
    return pt.examples.stochastic_volatility_model(*(cfg[k] for k in ("kappa", "gamma", "sigma", "mu", "nu", "tau")),
                                                   dt=cfg["dt"], device=device)


def builder(pt, cfg: dict):
    """The model with the notebook's priors registered on a context."""
    return functools.partial(pt.examples.stochastic_volatility_builder, dt=cfg["dt"])
