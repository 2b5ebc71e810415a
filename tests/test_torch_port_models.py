"""The port's structural time-series models (``LocalLinearTrend``,
``TrendingOU``, ``UCSV``, ``Cyclical``) held against the JAX package's
``pyfilter_tpu/timeseries/models.py``.

On the same parameters (scalars, and one value per lane) and the same
states: the drift and diffusion of ``mean_scale``, the initial density's
log-density and the transition density's log-density, within rel 1e-5 / abs
1e-5 (one float32 expression each side). Then the JAX package's
``tests/test_timeseries.py`` checks of each model at those tests' sizes, the
port alone: LLT and the cycle filtered by the APF with the optimal proposal
against the float64 Kalman filter (its gates: log-likelihood within 1 nat,
filter means within 0.1 and 0.08), TrendingOU's reversion to its moving
trend and UCSV's volatility step and level tracking (``chip_smoke.py``'s
phase-14 checks, on the CPU here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pyfilter_tpu_torch as pt
from pyfilter_tpu.timeseries import TimeseriesState as JState
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu_torch.filters.particle.proposals import LinearGaussianObservations
from pyfilter_tpu_torch.timeseries import TimeseriesState as TState

torch.set_num_threads(1)

# name: (parameters, event dims, time index)
MODELS = {
    "LocalLinearTrend": ((0.05, 0.02), 1, 3.0),
    "TrendingOU": ((0.8, 1.0, 0.05, 0.1), 0, 7.0),
    "UCSV": ((0.05,), 1, 2.0),
    "Cyclical": ((0.9, 0.5, 0.1), 1, 5.0),
}
LANE_FACTORS = (0.9, 1.0, 1.05)


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


def _pair(name, lanes):
    """The JAX and the port's process on the same parameters: scalars, or
    three values of each, one per lane."""
    params = MODELS[name][0]
    if lanes:
        params = [np.asarray([p * f for f in LANE_FACTORS], np.float32) for p in params]
    jproc = getattr(jmodels, name)(*(jnp.asarray(p, jnp.float32) for p in params))
    tproc = getattr(pt.timeseries.models, name)(*(torch.tensor(p, dtype=torch.float32) for p in params), device="cpu")
    return jproc, tproc


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_densities_match_jax(name, lanes):
    _, ev, time_index = MODELS[name]
    jproc, tproc = _pair(name, lanes)
    shape = (64,) + ((3,) if lanes else ()) + ((2,) if ev else ())
    rng = np.random.default_rng(len(name))
    x, x_next = (rng.normal(0.5, 0.7, size=shape).astype(np.float32) for _ in range(2))
    jstate, tstate = JState(jnp.asarray(time_index), jnp.asarray(x), ev), TState(time_index, torch.tensor(x), ev)

    for a, b in zip(tproc.mean_scale(tstate), jproc.mean_scale(jstate)):
        a = torch.as_tensor(a).expand(np.broadcast_shapes(tuple(torch.as_tensor(a).shape), np.shape(b)))
        _close(a, np.broadcast_to(np.asarray(b), tuple(a.shape)))
    _close(tproc.build_density(tstate).log_prob(torch.tensor(x_next)),
           jproc.build_density(jstate).log_prob(jnp.asarray(x_next)))
    _close(tproc.initial_distribution().log_prob(torch.tensor(x)),
           jproc.initial_distribution().log_prob(jnp.asarray(x)))
    sample = tproc.initial_sample(torch.Generator().manual_seed(0), shape[: len(shape) - ev])
    assert tuple(sample.value.shape) == shape and sample.event_ndim == ev


@pytest.mark.parametrize("name", ["llt", "cyclical"])
def test_linear_models_match_the_kalman_filter(name):
    """The JAX package's tests/test_timeseries.py:233 and :280 checks: the APF
    with the optimal proposal at 1500 particles against the float64 Kalman
    filter (LLT over 60 observations, the cycle over 80)."""
    system = chip_smoke.system14(name)
    n_obs, atol = (60, 0.1) if name == "llt" else (80, 0.08)
    _, y = chip_smoke.simulate_linear(system, n_obs, 0)
    km, kll = chip_smoke.kalman_linear(y, system)
    model = chip_smoke.model14(torch, pt, name, "cpu")
    res = pt.APF(model, 1500, proposal=LinearGaussianObservations(), device="cpu").batch_filter(
        torch.Generator().manual_seed(1), y)
    assert abs(float(res.log_likelihood) - kll) < 1.0, (float(res.log_likelihood), kll)
    np.testing.assert_allclose(res.filter_means.double().numpy(), km, atol=atol)


@pytest.mark.parametrize("name", ["llt", "cyclical"])
def test_linear_models_under_bootstrap_sisr_pass_the_oracle_gate(name):
    """Phase 14(e)'s gate at 4000 particles: bootstrap SISR over 200
    observations, median relative deviation of the means and relative
    log-likelihood error below 0.1."""
    system = chip_smoke.system14(name)
    _, y = chip_smoke.simulate_linear(system, chip_smoke.MODEL14_T, 2)
    km, kll = chip_smoke.kalman_linear(y, system)
    res = pt.SISR(chip_smoke.model14(torch, pt, name, "cpu"), 4000, device="cpu").batch_filter(
        torch.Generator().manual_seed(3), y)
    dev, ll_err = chip_smoke.oracle_gate(res.filter_means.numpy(), res.log_likelihood.numpy(), km, kll)
    assert dev < chip_smoke.ORACLE_TOL and ll_err < chip_smoke.ORACLE_TOL, (dev, ll_err)


def test_trending_ou_reverts_to_its_trend():
    gap, limit = chip_smoke.trending_ou_reversion(torch, pt, "cpu", torch.Generator().manual_seed(0))
    assert gap < limit, (gap, limit)


def test_ucsv_volatility_step_and_level_tracking():
    dv_sd, rmse, ll = chip_smoke.ucsv_checks(torch, pt, "cpu", torch.Generator().manual_seed(0))
    assert dv_sd == pytest.approx(chip_smoke.UCSV_SV, rel=0.3)
    assert rmse < 0.25 and np.isfinite(ll), (rmse, ll)


def test_constants_are_filled_on_the_device():
    """A number becomes a float32 tensor of the same value (filled, no copy)."""
    p = pt.timeseries.models.parameter(0.1, "cpu")
    assert p.dtype == torch.float32 and p.shape == () and float(p) == float(np.float32(0.1))
    assert float(pt.timeseries.models.parameter(np.float32(0.7), "cpu")) == float(np.float32(0.7))
    t = torch.tensor([1.0, 2.0])
    assert pt.timeseries.models.parameter(t, "cpu") is t
