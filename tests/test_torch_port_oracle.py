"""The port alone against the exact float64 Kalman oracle (``tests/kalman.py``)
at the reference's size: the linear-Gaussian suite of the reference's
``tests/filters/test_particle.py`` as the JAX package's
``tests/test_filters.py`` runs it, N = 1500 particles, T = 100 observations
simulated from numpy seed 123, with the reference's gates: the median
relative deviation of the filter means and the relative error of the
log-likelihood below 0.1.

This file holds the AR model (every filter of the table), the batched and
missing-data runs, the all-NaN skip, ``predict_path``, the imputation of a
partly missing row and LocalLinearization on the nonlinear benchmark model;
``test_torch_port_oracle_rw2d.py`` and ``test_torch_port_oracle_joint2d.py``
hold the 2-D models. The filters and models are ``chip_smoke.py``'s phase 12
table (``oracle_filters``, ``oracle_model``), run with ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import pyfilter_tpu_torch as pt
from kalman import KalmanFilter

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RELATIVE_TOLERANCE = 0.1
SERIES_LENGTH = 100
PARTICLES = 1500
FILTERS = chip_smoke.oracle_filters(pt)
FILTERS_2D = chip_smoke.ORACLE_2D


def kalman_oracle(model_name):
    """The reference's oracle of each model (tests/test_filters.py:28-82)."""
    if model_name == "ar":
        return KalmanFilter(0.99, 1.0, 0.05**2.0, 0.15**2.0, transition_offsets=0.0, initial_state_mean=0.0,
                            initial_state_covariance=0.05**2.0)
    sigma, a = np.array([0.05, 0.1]), np.eye(2)
    return KalmanFilter(a, a, sigma**2.0 * np.eye(2), 0.15**2.0 * np.eye(2),
                        initial_state_covariance=sigma**2.0 * np.eye(2))


def make_data(kalman, missing_perc=0.0, seed=123):
    rng = np.random.default_rng(seed)
    x, y = kalman.sample(SERIES_LENGTH, rng)
    if missing_perc > 0:
        y[rng.integers(1, SERIES_LENGTH, size=int(missing_perc * SERIES_LENGTH))] = np.nan
    return x, y


def median_relative_deviation(y_true, y):
    return np.median(np.abs((y_true - y) / y_true))


def run_filter_check(model_name, filter_name, batch_shape=(), missing=0.0, particles=PARTICLES, **kwargs):
    """One run of the suite on the CPU, held to the reference's gates;
    returns the filter, its result and the observations."""
    kalman = kalman_oracle(model_name)
    _, y = make_data(kalman, missing)
    km, _, kll = kalman.filter(y)
    filt = FILTERS[filter_name](chip_smoke.oracle_model(pt, model_name, "cpu"), particles, batch_shape=batch_shape,
                                device="cpu", **kwargs)
    result = filt.batch_filter(torch.Generator().manual_seed(42), y[:, 0] if model_name == "ar" else y)
    means = result.filter_means.double().numpy()
    if means.ndim == 1 + len(batch_shape):  # scalar event
        means = means[..., None]
    km_b = km[:, None] if batch_shape else km
    ll = result.log_likelihood.double().numpy()
    assert np.all(np.abs((ll - kll) / kll) < RELATIVE_TOLERANCE), (ll, kll)
    dev = median_relative_deviation(km_b, means)
    assert dev < RELATIVE_TOLERANCE, dev
    return filt, result, y


@pytest.mark.parametrize("filter_name", sorted(FILTERS))
def test_filter_vs_kalman_ar(filter_name):
    filt, result, _ = run_filter_check("ar", filter_name)
    if filter_name.startswith("gpf"):
        assert filt.n_resamples == 0
        np.testing.assert_array_equal(result.latest_state.prev_indices.numpy(), np.arange(PARTICLES))


@pytest.mark.parametrize("filter_name", chip_smoke.ORACLE_BATCHED)
@pytest.mark.parametrize("missing", [0.0, 0.1])
def test_filter_batched_and_missing(filter_name, missing):
    filt, result, y = run_filter_check("ar", filter_name, batch_shape=(3,), missing=missing)
    assert result.log_likelihood.shape == (3,) and result.filter_means.shape == (SERIES_LENGTH, 3)
    skipped = np.isnan(y[:, 0])
    assert np.all(result.step_log_likelihoods.numpy()[skipped] == 0.0)


def test_all_nan_skip():
    """An all-NaN observation contributes zero log-likelihood and only propagates."""
    _, y = make_data(kalman_oracle("ar"))
    y[10] = np.nan
    filt = pt.SISR(chip_smoke.oracle_model(pt, "ar", "cpu"), 500, device="cpu")
    result = filt.batch_filter(torch.Generator().manual_seed(1), y[:, 0])
    assert float(result.step_log_likelihoods[10]) == 0.0
    assert np.isfinite(float(result.log_likelihood))


def test_predict_path_and_covariance():
    """``predict_path`` simulates onward from the corrected cloud, one path
    per particle; ``get_covariance`` is the weighted variance of a scalar
    cloud and the weighted covariance of a 2-D one."""
    model = chip_smoke.oracle_model(pt, "ar", "cpu")
    _, y = make_data(kalman_oracle("ar"))
    result = pt.SISR(model, 200, device="cpu").batch_filter(torch.Generator().manual_seed(2), y[:, 0])
    xs, ys = result.latest_state.predict_path(torch.Generator().manual_seed(3), model, 10).get_paths()
    assert xs.shape == ys.shape == (10, 200)
    assert torch.equal(result.latest_state.get_covariance(), result.latest_state.variance)

    _, y2 = make_data(kalman_oracle("rw2d"))
    state = pt.SISR(chip_smoke.oracle_model(pt, "rw2d", "cpu"), 200, device="cpu").batch_filter(
        torch.Generator().manual_seed(4), y2).latest_state
    cov, x, w = state.get_covariance().double().numpy(), state.x.value.double().numpy(), state.normalized_weights()
    np.testing.assert_allclose(cov, np.cov(x.T, aweights=w.double().numpy(), bias=True), rtol=1e-4, atol=1e-9)


def test_impute_strategy():
    """``nan_strategy="impute"`` on a partly missing row of the 2-D walk:
    finite log-likelihood and means, and the row still corrects."""
    _, y = make_data(kalman_oracle("rw2d"))
    y[5, 0] = np.nan
    filt = pt.SISR(chip_smoke.oracle_model(pt, "rw2d", "cpu"), 500, nan_strategy="impute", device="cpu")
    result = filt.batch_filter(torch.Generator().manual_seed(5), y)
    assert np.isfinite(float(result.log_likelihood))
    assert np.all(np.isfinite(result.filter_means.numpy()))
    assert float(result.step_log_likelihoods[5]) != 0.0


def test_local_linearization():
    """LocalLinearization (SISR and the APF, the derivative given and from
    ``torch.func.jvp``) at 1000 particles against a 20000-particle bootstrap
    SISR on the nonlinear benchmark model (the JAX package's
    tests/test_filters.py:312-347), relative log-likelihood gap 0.1."""
    model = pt.convert.ukf_benchmark_from_numpy(np.float32(np.sqrt(10.0)), np.float32(1.0), device="cpu")
    _, y = model.sample_states(torch.Generator().manual_seed(33), 60).get_paths()
    oracle = float(pt.SISR(model, 20_000, device="cpu").batch_filter(torch.Generator().manual_seed(6), y)
                   .log_likelihood)
    props = pt.filters.particle.proposals
    for derivative in (pt.convert.ukf_benchmark_mean_derivative, None):
        proposal = props.LocalLinearization(f=pt.convert.ukf_benchmark_mean, linearized_f=derivative)
        for cls in (pt.SISR, pt.APF):
            ll = float(cls(model, 1_000, proposal=proposal, device="cpu").batch_filter(
                torch.Generator().manual_seed(7), y).log_likelihood)
            assert abs(ll - oracle) / abs(oracle) < RELATIVE_TOLERANCE, (cls.__name__, derivative, ll, oracle)
