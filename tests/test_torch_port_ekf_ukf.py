"""The port's extended (and iterated) Kalman filter, the unscented and the
cubature filters, and their RTS smoothers, held against the JAX package's
``pyfilter_tpu/filters/ekf.py`` and ``ukf.py``.

The same models in both packages (the sine diffusion of the reference
README, the nonlinear benchmark model of the unscented-filter literature, an
AR(1) observed every third step, a correlated-noise 2-D model with
multivariate-normal noise on every leg) and the same observations, made with
numpy from fixed seeds: log-likelihood, filtered and smoothed moments within
rel 1e-5 / abs 1e-5 (``BASELINE.md``; the Jacobians by ``torch.func.jacfwd``
against ``jax.jacfwd``). The benchmark model's ``cos(1.2 t)`` takes the
port's host time in float64 and the JAX package's in float32, and the model
amplifies any rounding (1e-2 nats over 30 steps of the CKF; 2.5e-4 in the
EKF's variances within 8 steps, through its ``x / 10`` Jacobian): it runs 8
steps, for the sigma-point filters only. With the port's time a float32
tensor the CKF still misses 1e-5 at 30 steps (1.4e-3 nats, 2.0e-3 in the
means: the two packages' float32 arithmetic, amplified), so the host time
stays (run this file as a script for the gaps). Then ``tests/test_full_covariance.py``'s oracle and
``tests/test_partial_nan.py``'s masked-update cases on the port.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from kalman import KalmanFilter as NumpyKalman
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import examples as jexamples
from pyfilter_tpu import timeseries as jts
from test_torch_port_kalman import ar_data, ar_pair, close, llt_data, llt_pair

torch.set_num_threads(1)

FILTERS = {
    "ekf": (lambda m: pf.ExtendedKalmanFilter(m), lambda m: pt.ExtendedKalmanFilter(m, device="cpu")),
    "iekf": (lambda m: pf.ExtendedKalmanFilter(m, iterations=3),
             lambda m: pt.ExtendedKalmanFilter(m, iterations=3, device="cpu")),
    "ukf": (lambda m: pf.UnscentedKalmanFilter(m), lambda m: pt.UnscentedKalmanFilter(m, device="cpu")),
    "ukf-scaled": (lambda m: pf.UnscentedKalmanFilter(m, alpha=0.5, beta=2.0, kappa=1.0),
                   lambda m: pt.UnscentedKalmanFilter(m, alpha=0.5, beta=2.0, kappa=1.0, device="cpu")),
    "ckf": (lambda m: pf.CubatureKalmanFilter(m), lambda m: pt.CubatureKalmanFilter(m, device="cpu")),
}
BENCH_SIGMA, BENCH_S = math.sqrt(10.0), 1.0


def sine_pair():
    return jexamples.sine_diffusion_model(gamma=0.4), pt.examples.sine_diffusion_model(gamma=0.4, device="cpu")


def bench_pair():
    """The nonlinear benchmark model (``x' = x/2 + 25 x / (1 + x^2) + 8
    cos(1.2 t) + sigma eps``, ``y = x^2 / 20 + s v``) in both packages."""
    def mean_scale(x, s_):
        v = x.value
        return v / 2.0 + 25 * v / (1 + v**2.0) + 8.0 * jnp.cos(1.2 * x.time_index), s_

    hidden = jts.AffineProcess(mean_scale, (BENCH_SIGMA,), jdist.Normal(0.0, 1.0),
                               lambda *a: jdist.Normal(0.0, math.sqrt(5.0)))
    jssm = jts.StateSpaceModel(hidden, lambda x, s_: jdist.Normal(x.value**2.0 / 20.0, s_), (BENCH_S,))
    return jssm, pt.convert.ukf_benchmark_from_numpy(np.float32(BENCH_SIGMA), np.float32(BENCH_S), device="cpu")


def sine_data(n=60, seed=0, nan_rows=()):
    """The sine diffusion (gamma 0.4, dt 0.05) simulated in numpy."""
    rng = np.random.default_rng(seed)
    x, y = rng.normal(), np.empty(n, np.float32)
    for t in range(n):
        x = x + math.sin(x - 0.4) * 0.05 + math.sqrt(0.05) * rng.normal()
        y[t] = x + 0.1 * rng.normal()
    y[list(nan_rows)] = np.nan
    return y


def bench_data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    x, y = rng.normal(0.0, math.sqrt(5.0)), np.empty(n, np.float32)
    for t in range(n):
        x = x / 2 + 25 * x / (1 + x * x) + 8 * math.cos(1.2 * t) + BENCH_SIGMA * rng.normal()
        y[t] = x * x / 20 + BENCH_S * rng.normal()
    return y


def same_result(jres, tres, rtol=1e-5, atol=1e-5):
    close(tres.log_likelihood, jres.log_likelihood, rtol, atol)
    close(tres.step_log_likelihoods, jres.step_log_likelihoods, rtol, atol)
    close(tres.filter_means, jres.filter_means, rtol, atol)
    close(tres.filter_variances, jres.filter_variances, rtol, atol)


@pytest.mark.parametrize("name,model", [(n, m) for m in ("sine", "ar-oes3") for n in sorted(FILTERS)]
                         + [(n, "benchmark") for n in ("ckf", "ukf", "ukf-scaled")])
def test_filter_matches_jax(name, model):
    if model == "sine":
        (jm, tm), y = sine_pair(), sine_data(nan_rows=(7, 8))
    elif model == "ar-oes3":
        (jm, tm), y = ar_pair(oes=3), ar_data(30, 2, nan_rows=(4,))
    else:
        (jm, tm), y = bench_pair(), bench_data()
    make_j, make_t = FILTERS[name]
    same_result(make_j(jm).batch_filter(jnp.asarray(y)), make_t(tm).batch_filter(y))


@pytest.mark.parametrize("name", ["ekf", "ukf", "ckf"])
@pytest.mark.parametrize("model", ["sine", "ar-oes3"])
def test_smoother_matches_jax(name, model):
    (jm, tm), y = (sine_pair(), sine_data(40, 3, (5,))) if model == "sine" else (ar_pair(oes=3), ar_data(25, 4))
    make_j, make_t = FILTERS[name]
    for a, b in zip(make_t(tm).smooth(y), make_j(jm).smooth(jnp.asarray(y))):
        close(a, b)
    m0, p0 = np.asarray([0.3], np.float32), np.asarray([[0.5]], np.float32)
    out_t = make_t(tm).smooth(y, initial_moments=(torch.tensor(m0), torch.tensor(p0)))
    out_j = make_j(jm).smooth(jnp.asarray(y), initial_moments=(jnp.asarray(m0), jnp.asarray(p0)))
    for a, b in zip(out_t, out_j):
        close(a, b)


@pytest.mark.parametrize("name", ["ekf", "ukf"])
def test_gaussian_step_protocol_matches_jax(name):
    """``initialize_moments``, ``predict_moments``, ``correct_moments`` and
    ``predict_moments_cross`` (the surface the GSF, IMM and Kim smoother
    compose over) at a fixed belief."""
    jm, tm = sine_pair()
    make_j, make_t = FILTERS[name]
    jf, tf = make_j(jm), make_t(tm)
    for a, b in zip(tf.initialize_moments(), jf.initialize_moments()):
        close(a, b)
    m, p = np.asarray([0.7], np.float32), np.asarray([[0.3]], np.float32)
    for n in (1, 3):
        for a, b in zip(tf.predict_moments_cross(torch.tensor(m), torch.tensor(p), 2.0, n),
                        jf.predict_moments_cross(jnp.asarray(m), jnp.asarray(p), jnp.asarray(2.0), n)):
            close(a, b)
    for a, b in zip(tf.correct_moments(torch.tensor(m), torch.tensor(p), torch.tensor([0.5]), 3.0),
                    jf.correct_moments(jnp.asarray(m), jnp.asarray(p), jnp.asarray([0.5]), jnp.asarray(3.0))):
        close(a, b)


def test_iekf_rejects_bad_iterations():
    with pytest.raises(ValueError):
        pt.ExtendedKalmanFilter(sine_pair()[1], iterations=0, device="cpu")


@pytest.mark.parametrize("name", ["ekf", "ukf", "ckf", "iekf"])
def test_equal_kalman_on_linear_model(name):
    """``tests/test_ekf.py:31`` / ``tests/test_ukf.py:31``: exact through an
    affine model."""
    tm = ar_pair()[1]
    y = ar_data(40, 0)
    exact = pt.KalmanFilter(tm, device="cpu").batch_filter(y)
    res = FILTERS[name][1](tm).batch_filter(y)
    close(res.log_likelihood, exact.log_likelihood, rtol=1e-4)
    close(res.filter_means, exact.filter_means, rtol=1e-4, atol=1e-4)


def correlated_pair():
    """``tests/test_full_covariance.py``'s 2-D model: full-covariance MVN
    noise on every leg, in both packages."""
    a_mat = np.array([[0.9, 0.2], [-0.1, 0.8]], np.float32)
    h_mat = np.array([[1.0, 0.5], [0.0, 1.0]], np.float32)
    lq, l0, lr = (np.linalg.cholesky(m).astype(np.float32) for m in (Q, P0, R))
    jhidden = jts.AffineProcess(lambda x, a_: (jnp.einsum("ij,...j->...i", a_, x.value), 1.0), (jnp.asarray(a_mat),),
                                jdist.MultivariateNormal(jnp.zeros(2), scale_tril=jnp.asarray(lq)),
                                lambda a_: jdist.MultivariateNormal(jnp.zeros(2), scale_tril=jnp.asarray(l0)))
    jssm = jts.StateSpaceModel(
        jhidden, lambda x, h_, lr_: jdist.MultivariateNormal(jnp.einsum("ij,...j->...i", h_, x.value), scale_tril=lr_),
        (jnp.asarray(h_mat), jnp.asarray(lr)))
    dist = pt.distributions
    thidden = pt.timeseries.AffineProcess(
        lambda x, a_: (torch.einsum("ij,...j->...i", a_, x.value), torch.ones(())), (torch.tensor(a_mat),),
        dist.MultivariateNormal(torch.zeros(2), scale_tril=torch.tensor(lq)),
        lambda a_: dist.MultivariateNormal(torch.zeros(2), scale_tril=torch.tensor(l0)))
    tssm = pt.timeseries.StateSpaceModel(
        thidden, lambda x, h_, lr_: dist.MultivariateNormal(torch.einsum("ij,...j->...i", h_, x.value), scale_tril=lr_),
        (torch.tensor(h_mat), torch.tensor(lr)))
    return jssm, tssm


Q = np.array([[0.30, 0.18], [0.18, 0.25]])
R = np.array([[0.20, -0.08], [-0.08, 0.10]])
P0 = np.array([[1.0, 0.4], [0.4, 1.0]])


@pytest.mark.parametrize("name", ["ekf", "ukf"])
def test_correlated_noise_matches_jax_and_the_oracle(name):
    """``tests/test_full_covariance.py:67`` / ``:82``: the full covariances
    are used exactly (the float64 numpy oracle), and the port equals JAX."""
    oracle = NumpyKalman(np.array([[0.9, 0.2], [-0.1, 0.8]]), np.array([[1.0, 0.5], [0.0, 1.0]]), Q, R,
                         initial_state_mean=np.zeros(2), initial_state_covariance=P0)
    _, y = oracle.sample(60, rng=np.random.default_rng(7))
    means, covs, ll = oracle.filter(y)
    y = y.astype(np.float32)
    jm, tm = correlated_pair()
    make_j, make_t = FILTERS[name]
    res = make_t(tm).batch_filter(y)
    close(res.log_likelihood, ll, rtol=1e-4)
    close(res.filter_means, means, rtol=1e-3, atol=1e-4)
    close(res.filter_variances, np.diagonal(covs, axis1=-2, axis2=-1), rtol=1e-3, atol=1e-5)
    same_result(make_j(jm).batch_filter(jnp.asarray(y)), res)


@pytest.mark.parametrize("name", ["ekf", "ukf"])
def test_partial_nan_matches_the_masked_kalman_filter(name):
    """``tests/test_partial_nan.py:71``: on a linear model the masked EKF and
    UKF updates reproduce the exact masked Kalman filter."""
    y = llt_data()
    y[15:45, 1] = np.nan
    tm = llt_pair()[1]
    exact = pt.KalmanFilter(tm, device="cpu").batch_filter(y)
    res = FILTERS[name][1](tm).batch_filter(y)
    close(res.log_likelihood, exact.log_likelihood, rtol=1e-3)
    close(res.filter_means, exact.filter_means, rtol=1e-3, atol=1e-4)
    same_result(FILTERS[name][0](llt_pair()[0]).batch_filter(jnp.asarray(y)), res)


def test_ckf_center_point_carries_no_weight():
    ckf = pt.CubatureKalmanFilter(sine_pair()[1], device="cpu")
    assert float(ckf._wm[0]) == 0.0 and float(ckf._wc[0]) == 0.0
    close(ckf._wm[1:], np.full(2, 0.5))


def _float32_time_mean_scale(x, sigma):
    """The benchmark model's transition with its time carried as a float32
    tensor, as the JAX package carries it (``timeseries/process.py:67``)."""
    v = x.value
    t = x.time_index if isinstance(x.time_index, torch.Tensor) else torch.tensor(x.time_index, dtype=torch.float32)
    return v / 2.0 + 25.0 * v / (1.0 + v**2.0) + 8.0 * torch.cos(1.2 * t), sigma


def time_gap(name: str, n_obs: int, float32_time: bool) -> dict:
    """The largest gap of each of the filter's outputs to the JAX package's on
    the benchmark model over ``n_obs`` steps, absolute and in units of the
    1e-5 rel/abs gate, with the port's time as the host's float64 or as a
    float32 tensor."""
    saved = pt.convert._ukf_mean_scale
    if float32_time:
        pt.convert._ukf_mean_scale = _float32_time_mean_scale
    try:
        (jm, tm), y = bench_pair(), bench_data(n_obs)
        make_j, make_t = FILTERS[name]
        jres, tres = make_j(jm).batch_filter(jnp.asarray(y)), make_t(tm).batch_filter(y)
    finally:
        pt.convert._ukf_mean_scale = saved
    out = {}
    for key in ("log_likelihood", "filter_means", "filter_variances"):
        a, b = np.asarray(getattr(jres, key), np.float64), getattr(tres, key).double().numpy()
        gap = np.abs(a - b)
        out[key] = (float(gap.max()), float(np.max(gap / (1e-5 + 1e-5 * np.abs(a)))))
    return out


if __name__ == "__main__":
    # The time-index check of ROADMAP Queue 3: the CKF (and the UKF and EKF)
    # on the benchmark model at 30 steps, the port's time as the host's
    # float64 and as a float32 tensor; a gate multiple above 1 misses 1e-5.
    #     JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_port_ekf_ukf.py
    import jax

    jax.config.update("jax_platforms", "cpu")
    for filter_name in ("ckf", "ukf", "ekf"):
        for f32 in (False, True):
            gaps = time_gap(filter_name, 30, f32)
            print(filter_name, "float32 time" if f32 else "float64 time",
                  {k: f"{v[0]:.3e} ({v[1]:.2f} x the gate)" for k, v in gaps.items()})
