"""The port's exact Kalman filter and RTS smoother, and the masked Gaussian
update the whole family shares, held against the JAX package's
``pyfilter_tpu/filters/kalman.py`` and ``_masked.py``.

The same models are built in both packages from the same numbers, the same
observations (made with numpy from fixed seeds) go through both, and the log-
likelihood, filtered and smoothed moments agree within rel 1e-5 / abs 1e-5
(``BASELINE.md``: one float32 recursion each side). Then the JAX package's
partial-NaN cases (``tests/test_partial_nan.py``: the missing component is
marginalized exactly, the level-only filter is the oracle) and correlated-
noise oracle (``tests/test_full_covariance.py``: the float64 numpy Kalman
filter) on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from kalman import KalmanFilter as NumpyKalman
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.filters import _masked as jmasked
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu_torch.filters import _masked as tmasked

torch.set_num_threads(1)

TM = pt.timeseries.models
AR = (0.2, 0.7, 0.4, 0.25)


def close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


def ar_pair(alpha=AR[0], beta=AR[1], sigma=AR[2], obs=AR[3], oes=1):
    jssm = jts.LinearStateSpaceModel(jmodels.AR(alpha, beta, sigma), (1.0, obs), observe_every_step=oes)
    tssm = pt.convert.linear_ssm_from_numpy(TM.AR(alpha, beta, sigma, device="cpu"), 1.0, 0.0, obs,
                                           observe_every_step=oes)
    return jssm, tssm


def llt_pair(observe_slope=True):
    """LocalLinearTrend observed in both components (or the level only)."""
    jllt, tllt = jmodels.LocalLinearTrend(0.05, 0.02), TM.LocalLinearTrend(0.05, 0.02, device="cpu")
    a = np.eye(2, dtype=np.float32) if observe_slope else np.asarray([[1.0, 0.0]], np.float32)
    s = np.full(a.shape[0], 0.15, np.float32)
    jssm = jts.LinearStateSpaceModel(jllt, (jnp.asarray(a), jnp.asarray(s)), event_shape=(a.shape[0],))
    tssm = pt.convert.linear_ssm_from_numpy(tllt, a, np.zeros(a.shape[0], np.float32), s, event_shape=(a.shape[0],))
    return jssm, tssm


def ar_data(n, seed, nan_rows=()):
    """Observations of the AR model simulated in numpy (float32)."""
    rng = np.random.default_rng(seed)
    alpha, beta, sigma, obs = AR
    x, out = rng.normal(alpha, sigma), np.empty(n, np.float32)
    for t in range(n):
        x = alpha + beta * x + sigma * rng.normal()
        out[t] = x + obs * rng.normal()
    out[list(nan_rows)] = np.nan
    return out


def llt_data(n=60, seed=0):
    """Both components of the local linear trend, observed with noise 0.15."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, [0.05, 0.02])
    y = np.empty((n, 2), np.float32)
    for t in range(n):
        x = np.asarray([x[0] + x[1], x[1]]) + rng.normal(0.0, [0.05, 0.02])
        y[t] = x + 0.15 * rng.normal(size=2)
    return y


def same_result(jres, tres):
    close(tres.log_likelihood, jres.log_likelihood)
    close(tres.step_log_likelihoods, jres.step_log_likelihoods)
    close(tres.filter_means, jres.filter_means)
    close(tres.filter_variances, jres.filter_variances)


@pytest.mark.parametrize("oes", [1, 3])
@pytest.mark.parametrize("nan_rows", [(), (5, 6, 17)], ids=["observed", "gaps"])
def test_filter_and_smoother_match_jax(oes, nan_rows):
    jssm, tssm = ar_pair(oes=oes)
    y = ar_data(40, 1, nan_rows)
    jfilt, tfilt = pf.KalmanFilter(jssm), pt.KalmanFilter(tssm, device="cpu")
    for name in ("F", "b", "Q", "H", "d", "R", "m0", "P0"):
        close(getattr(tfilt, name), getattr(jfilt, name))
    same_result(jfilt.batch_filter(jnp.asarray(y)), tfilt.batch_filter(y))
    for a, b in zip(tfilt.smooth(y), jfilt.smooth(jnp.asarray(y))):
        close(a, b)
    if nan_rows:
        assert float(tfilt.batch_filter(y).step_log_likelihoods[5]) == 0.0


def test_single_step_and_state():
    jssm, tssm = ar_pair()
    jfilt, tfilt = pf.KalmanFilter(jssm), pt.KalmanFilter(tssm, device="cpu")
    js, ts_ = jfilt.initialize(), tfilt.initialize()
    for y_t, n in ((0.3, 1), (-0.2, 2), (np.nan, 1)):
        js = jfilt.filter(jnp.asarray(y_t), js, n_transitions=n)
        ts_ = tfilt.filter(torch.tensor(y_t), ts_, n_transitions=n)
        close(ts_.mean, js.mean)
        close(ts_.cov, js.cov)
        close(ts_.log_likelihood, js.log_likelihood)
        assert ts_.time_index == float(js.time_index)
    close(ts_.get_variance(), js.get_variance())
    assert ts_.x.value is ts_.mean


def test_vector_model_matches_jax():
    jssm, tssm = llt_pair()
    y = llt_data()
    y[10:20, 1] = np.nan
    y[30] = np.nan
    jfilt, tfilt = pf.KalmanFilter(jssm), pt.KalmanFilter(tssm, device="cpu")
    same_result(jfilt.batch_filter(jnp.asarray(y)), tfilt.batch_filter(y))
    for a, b in zip(tfilt.smooth(y), jfilt.smooth(jnp.asarray(y))):
        close(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_update_matches_jax(seed):
    """The shared update on random moments, with 0, 1 and every component
    missing: the gain, innovation, log-density and effective covariance."""
    rng = np.random.default_rng(seed)
    d_x, d_y = 3, 3
    a = rng.normal(size=(d_x + d_y, d_x + d_y))
    cov = (a @ a.T + np.eye(d_x + d_y)).astype(np.float32)
    c_xy, s_mat = cov[:d_x, d_x:], cov[d_x:, d_x:]
    y_hat = rng.normal(size=d_y).astype(np.float32)
    y = rng.normal(size=d_y).astype(np.float32)
    y[:seed] = np.nan
    out_j = jmasked.masked_gaussian_update(jnp.asarray(y), jnp.asarray(y_hat), jnp.asarray(c_xy), jnp.asarray(s_mat))
    out_t = tmasked.masked_gaussian_update(*(torch.tensor(v) for v in (y, y_hat, c_xy, s_mat)))
    for a_, b_ in zip(out_t, out_j):
        close(a_, b_)


def test_masked_update_all_missing_is_a_skip():
    out = tmasked.masked_gaussian_update(torch.full((2,), float("nan")), torch.zeros(2), torch.ones(3, 2),
                                         torch.eye(2))
    assert float(out[2]) == 0.0 and not out[0].any() and not out[1].any()


def test_failed_factor_is_nan_not_an_error():
    chol = tmasked.cholesky_or_nan(-torch.eye(2))
    assert torch.isnan(chol).all()
    gain, _, ll, _ = tmasked.masked_gaussian_update(torch.zeros(2), torch.ones(2), torch.ones(2, 2), -torch.eye(2))
    assert torch.isnan(ll) and torch.isnan(gain).all()


def test_density_covariance_and_initial_moments():
    """``tests/test_full_covariance.py::test_density_covariance_helper``, and
    the initial moments of a scalar and an MVN initial law, against JAX."""
    q = np.asarray([[0.30, 0.18], [0.18, 0.25]], np.float32)
    mvn_t = pt.distributions.MultivariateNormal(torch.zeros(2), covariance_matrix=torch.tensor(q))
    mvn_j = jdist.MultivariateNormal(jnp.zeros(2), covariance_matrix=jnp.asarray(q))
    close(tmasked.density_covariance(mvn_t, 2), q)
    close(tmasked.density_covariance(mvn_t, 2), jmasked.density_covariance(mvn_j, 2))
    n_t = pt.distributions.Normal(torch.zeros(3), torch.tensor([1.0, 2.0, 3.0])).to_event(1)
    close(tmasked.density_covariance(n_t, 3), np.diag([1.0, 4.0, 9.0]))
    for t_init, j_init, d in ((pt.distributions.Normal(torch.tensor(0.5), torch.tensor(2.0)),
                               jdist.Normal(0.5, 2.0), 3), (mvn_t, mvn_j, 2)):
        for a, b in zip(tmasked.initial_gaussian_moments(t_init, d), jmasked.initial_gaussian_moments(j_init, d)):
            close(a, b)


def test_non_affine_and_heteroscedastic_models_raise():
    sine = pt.examples.sine_diffusion_model(device="cpu")
    with pytest.raises(ValueError, match="affine"):
        pt.KalmanFilter(sine, device="cpu")
    hetero = pt.timeseries.AffineProcess(lambda x, s: (0.9 * x.value, s * (1.0 + x.value**2)),
                                         (torch.tensor(0.3),), pt.distributions.Normal(torch.tensor(0.0),
                                                                                       torch.tensor(1.0)),
                                         lambda s: pt.distributions.Normal(torch.tensor(0.0), s))
    with pytest.raises(ValueError, match="state-independent"):
        pt.KalmanFilter(pt.timeseries.LinearStateSpaceModel(hetero, (1.0, 0.2)), device="cpu")


def test_kalman_marginalizes_missing_component_exactly():
    """``tests/test_partial_nan.py:35``: the slope observation always missing
    equals the level-only filter."""
    y = llt_data()
    y_masked = y.copy()
    y_masked[:, 1] = np.nan
    masked = pt.KalmanFilter(llt_pair()[1], device="cpu").batch_filter(y_masked)
    oracle = pt.KalmanFilter(llt_pair(observe_slope=False)[1], device="cpu").batch_filter(y[:, :1])
    close(masked.log_likelihood, oracle.log_likelihood)
    close(masked.filter_means, oracle.filter_means, rtol=1e-4)
    close(masked.filter_variances, oracle.filter_variances, rtol=1e-4, atol=1e-6)


def test_kalman_intermittent_partial_nan():
    """``tests/test_partial_nan.py:54``: withheld slope observations grow the
    slope's posterior variance."""
    y = llt_data()
    y_masked = y.copy()
    y_masked[10:40, 1] = np.nan
    filt = pt.KalmanFilter(llt_pair()[1], device="cpu")
    full, masked = filt.batch_filter(y), filt.batch_filter(y_masked)
    assert np.isfinite(float(masked.log_likelihood))
    assert float(masked.log_likelihood) < float(full.log_likelihood) + 1e-3
    assert float(masked.filter_variances[39, 1]) > float(full.filter_variances[39, 1])
    close(masked.filter_variances[:10], full.filter_variances[:10])


def test_smoothers_accept_partial_nan():
    """``tests/test_partial_nan.py:120``: finite smoothed moments, the EKF's
    RTS smoother equal to the Kalman one on the linear model."""
    y = llt_data()
    y[20:30, 0] = np.nan
    tssm = llt_pair()[1]
    km, kc = pt.KalmanFilter(tssm, device="cpu").smooth(y)
    em, _ = pt.ExtendedKalmanFilter(tssm, device="cpu").smooth(y)
    assert torch.isfinite(km).all() and torch.isfinite(kc).all()
    close(em, km, rtol=1e-3, atol=1e-4)


A = np.array([[0.9, 0.2], [-0.1, 0.8]])
Q = np.array([[0.30, 0.18], [0.18, 0.25]])
P0 = np.array([[1.0, 0.4], [0.4, 1.0]])


def test_kalman_matches_oracle_with_correlated_q():
    """``tests/test_full_covariance.py:96``: the probed ``(F, b, Q)`` keeps an
    MVN increment's correlations and the correlated initial covariance; the
    filter meets the float64 numpy oracle, and so does the EKF."""
    dist = pt.distributions
    hidden = pt.timeseries.AffineProcess(
        lambda x, a_mat: (torch.einsum("ij,...j->...i", a_mat, x.value), torch.ones(())),
        (torch.tensor(A, dtype=torch.float32),),
        dist.MultivariateNormal(torch.zeros(2), scale_tril=torch.tensor(np.linalg.cholesky(Q), dtype=torch.float32)),
        lambda a_mat: dist.MultivariateNormal(torch.zeros(2),
                                              scale_tril=torch.tensor(np.linalg.cholesky(P0), dtype=torch.float32)),
    )
    ssm = pt.timeseries.LinearStateSpaceModel(hidden, (1.0, 0.3), event_shape=(2,))
    filt = pt.KalmanFilter(ssm, device="cpu")
    close(filt.Q, Q, atol=1e-6)
    close(filt.P0, P0, atol=1e-6)
    oracle = NumpyKalman(A, np.eye(2), Q, np.eye(2) * 0.09, initial_state_mean=np.zeros(2),
                         initial_state_covariance=P0)
    _, y = oracle.sample(50, rng=np.random.default_rng(3))
    means, _, ll = oracle.filter(y)
    res = filt.batch_filter(y.astype(np.float32))
    close(res.log_likelihood, ll, rtol=1e-4)
    close(res.filter_means, means, rtol=1e-3, atol=1e-4)
    close(pt.ExtendedKalmanFilter(ssm, device="cpu").batch_filter(y.astype(np.float32)).log_likelihood,
          res.log_likelihood)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.KalmanFilter(ar_pair()[1])
