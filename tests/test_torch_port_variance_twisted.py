"""The port's genealogy variance estimators and the twisted (iterated
auxiliary) particle filter, held against the JAX package's
``pyfilter_tpu/filters/particle/variance.py`` and ``twisted.py``.

The estimators run on one history the JAX package recorded (a jitted SISR
pass over three lanes, ``record_states=True``), converted with
``convert.history_from_numpy``: the ancestor maps equal, every estimate
within 1e-5 (rel and abs). The twisted pass replays the JAX run's draws
(:class:`test_torch_port_block.KeyTape`: the initial cloud through
``Normal.sample``, each step's resample uniform through ``twisted._uniform``
into the default K1 route, its normals through ``twisted._standard_normal``);
``learn_twist`` then fits on the JAX pass's own clouds. On the identity
pass's clouds the coefficients agree within rel 1e-4 and the fitted log-twist
on the cloud within 1e-5 of its largest value (measured 4e-6). On a twisted
pass's clouds the float32 normal equations are ill-conditioned (the cloud
hugs the posterior, so ``1``, ``x`` and ``x^2`` are nearly collinear), and
the two packages' summation orders move the coefficients by about 2e-3
relative; there the fitted log-twist, the quantity the next pass uses, is
held within 1e-3 of its largest value (measured 2.8e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.filters.particle import (
    eve_indices as j_eve,
    filter_mean_variance as j_fmv,
    lag_ancestor_indices as j_lag,
    log_likelihood_variance as j_llv,
    twisted as jtw,
)
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu_torch.filters.particle import twisted as ttw
from test_torch_port_block import KeyTape

from kalman import KalmanFilter as NumpyKalman

torch.set_num_threads(1)

A, B, S, O = 0.2, 0.7, 0.4, 0.3
TP = pt.filters.particle


def ar_pair(obs=O):
    return (jts.LinearStateSpaceModel(jmodels.AR(A, B, S), (1.0, obs)),
            pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.AR(A, B, S, device="cpu"), (1.0, obs)))


def ar_data(t_steps, seed, obs=O):
    rng = np.random.default_rng(seed)
    x, ys = A, []
    for _ in range(t_steps):
        x = A + B * x + S * rng.normal()
        ys.append(x + obs * rng.normal())
    return np.asarray(ys, np.float32)


# -- the variance estimators ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_history():
    """One JAX SISR history over three lanes (N = 64, T = 25, resampling at
    the default ESS gate) and the same history in the port."""
    jssm, _ = ar_pair()
    res = jax.jit(pf.SISR(jssm, 64, record_states=True, batch_shape=(3,)).batch_filter)(
        jax.random.PRNGKey(7), jnp.asarray(ar_data(25, 1)))
    h = res.states
    th = pt.convert.history_from_numpy(*(np.asarray(v) for v in h), device="cpu")
    return h, th


@pytest.mark.parametrize("lane", [None, 1], ids=["lanes", "one-lane"])
@pytest.mark.parametrize("lag", [None, 1, 6, 40])
def test_estimators_match_jax_on_one_history(jax_history, lane, lag):
    """Eve (``lag=None``) and lag ancestors, ``log_likelihood_variance`` and
    ``filter_mean_variance`` on the JAX package's history, three lanes or
    one: the maps equal, the estimates within 1e-5."""
    jh, th = jax_history
    if lane is not None:
        jh = jh._replace(**{f: getattr(jh, f)[:, :, lane] for f in ("values", "log_weights", "prev_indices")})
        th = th._replace(**{f: getattr(th, f)[:, :, lane] for f in ("values", "log_weights", "prev_indices")})
    j_anc = j_eve(jh.prev_indices) if lag is None else j_lag(jh.prev_indices, lag)
    t_anc = TP.eve_indices(th.prev_indices) if lag is None else TP.lag_ancestor_indices(th.prev_indices, lag)
    np.testing.assert_array_equal(np.asarray(j_anc), t_anc.numpy())
    for j_fn, t_fn in ((j_llv, TP.log_likelihood_variance), (j_fmv, TP.filter_mean_variance)):
        want, got = j_fn(jh, lag=lag), t_fn(th, lag=lag)
        for name in ("sigma2", "variance"):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(got.n_unique_ancestors.numpy(), np.asarray(want.n_unique_ancestors))


def test_ancestor_maps_compose_like_a_loop():
    """Eve indices are the composed parent maps; ``lag=T`` is the Eve map and
    ``lag=1`` the raw parents, lanes included."""
    rng = np.random.default_rng(0)
    prev = rng.integers(0, 8, size=(6, 8)).astype(np.int32)
    e, want = np.arange(8), []
    for s in range(6):
        e = e[prev[s]]
        want.append(e.copy())
    np.testing.assert_array_equal(TP.eve_indices(torch.from_numpy(prev)).numpy(), np.stack(want))
    lanes = torch.from_numpy(rng.integers(0, 16, size=(5, 16, 3)).astype(np.int32))
    assert torch.equal(TP.lag_ancestor_indices(lanes, 5), TP.eve_indices(lanes))
    assert torch.equal(TP.lag_ancestor_indices(lanes, 1), lanes)
    with pytest.raises(ValueError, match="lag"):
        TP.lag_ancestor_indices(lanes, 0)
    with pytest.raises(ValueError, match="record_states"):
        TP.log_likelihood_variance(pt.FilterResult(*([None] * 5)))


# -- the twisted pass ------------------------------------------------------------------------------


def _replay(monkeypatch, tape):
    """The port's seams of a twisted pass, fed ``tape``'s draws."""
    normals = tape.replay_normals(monkeypatch)
    uniforms = iter(tape.uniforms)
    monkeypatch.setattr(ttw, "_standard_normal", lambda generator, shape, like: torch.from_numpy(next(normals)))
    monkeypatch.setattr(ttw, "_uniform", lambda generator, device: torch.from_numpy(next(uniforms)))
    return normals, uniforms


def _psi_t(psi):
    return ttw.TwistCoefficients(*(torch.from_numpy(np.array(v)) for v in psi))


def test_twisted_pass_and_learn_twist_match_jax(monkeypatch):
    """The identity-twist pass, the twist learned on its clouds, the pass
    under the JAX package's learned twist and the twist learned on that
    pass's clouds, each against the JAX package on its draws."""
    jssm, tssm = ar_pair(0.15)
    y = ar_data(20, 3, 0.15)
    n, t_steps = 128, len(y)
    psi = jtw.TwistCoefficients.identity(t_steps, 1)
    for rnd in range(2):
        tape = KeyTape()
        jout = tape.record(monkeypatch, lambda: jtw.twisted_pass(jssm, n, jax.random.PRNGKey(rnd), jnp.asarray(y),
                                                                 psi))
        with monkeypatch.context() as m:
            normals, uniforms = _replay(m, tape)
            tout = ttw.twisted_pass(tssm, n, None, y, _psi_t(psi), device="cpu")
            assert next(normals, None) is None and next(uniforms, None) is None
        np.testing.assert_allclose(tout.clouds.numpy(), np.asarray(jout.clouds), rtol=1e-5, atol=1e-5)
        for name in ("log_likelihood", "step_log_likelihoods", "filter_means", "filter_variances"):
            np.testing.assert_allclose(getattr(tout.result, name).numpy(), np.asarray(getattr(jout.result, name)),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        assert tout.result.latest_state.values.shape == (n,)

        psi = jax.jit(lambda c: jtw.learn_twist(jssm, c, jnp.asarray(y)))(jout.clouds)
        t_psi = ttw.learn_twist(tssm, torch.from_numpy(np.array(jout.clouds)), y)
        if rnd == 0:
            for got, want in zip(t_psi, psi):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                           atol=1e-4 * float(np.abs(np.asarray(want)).max()))
        clouds = np.asarray(jout.clouds)[1:, :, 0]
        fitted = lambda p: np.asarray(p.a)[:, :1] * clouds**2 + np.asarray(p.b)[:, :1] * clouds + np.asarray(  # noqa
            p.c)[:, None]
        # the identity pass's clouds: within 1e-5 of the scale; the twisted pass's: 1e-3 (module docstring)
        tol = 1e-5 if rnd == 0 else 1e-3
        np.testing.assert_allclose(fitted(t_psi), fitted(psi), rtol=0.0, atol=tol * np.abs(fitted(psi)).max())


def test_twisted_pass_with_a_resampler_passed_in(monkeypatch):
    """A resampler passed in takes its own route (indices and a gather); fed
    the uniforms the default route draws, ``systematic_counts`` gives the
    same pass bit for bit."""
    _, tssm = ar_pair()
    y = ar_data(15, 4)
    psi = ttw.TwistCoefficients.identity(len(y), 1, device="cpu")
    draws = torch.rand(len(y), generator=torch.Generator().manual_seed(0))
    us = iter(draws)
    monkeypatch.setattr(ttw, "_uniform", lambda generator, device: next(us))
    default = ttw.twisted_pass(tssm, 200, torch.Generator().manual_seed(1), y, psi, device="cpu")
    us = iter(draws)
    passed = ttw.twisted_pass(tssm, 200, torch.Generator().manual_seed(1), y, psi, device="cpu",
                              resampler=lambda g, w, normalized=False: pt.ops.systematic_counts(
                                  None, w, normalized=normalized, u=next(us)))
    assert torch.equal(default.clouds, passed.clouds)
    assert torch.equal(default.result.log_likelihood, passed.result.log_likelihood)


def test_iterated_apf_collapses_the_variance_on_the_ar_oracle():
    """``tests/test_twisted.py``'s linear oracle at a small size: two
    iterations cut the replicate variance of the log-likelihood at least
    20-fold against the identity twist, the mean within 0.05 of the float64
    Kalman value."""
    obs = 0.15
    kf = NumpyKalman([[B]], [[1.0]], [[S**2]], [[obs**2]], transition_offsets=[A], initial_state_mean=[A],
                     initial_state_covariance=[[S**2]])
    _, y = kf.sample(30, rng=np.random.default_rng(3))
    _, _, ll_exact = kf.filter(y[:, 0])
    y = y[:, 0].astype(np.float32)
    _, tssm = ar_pair(obs)
    reps = 8
    psi0 = ttw.TwistCoefficients.identity(len(y), 1, device="cpu")
    lls2 = np.array([float(ttw.iterated_apf(tssm, 256, torch.Generator().manual_seed(i), y, device="cpu")
                           .log_likelihood) for i in range(reps)])
    lls0 = np.array([float(ttw.twisted_pass(tssm, 256, torch.Generator().manual_seed(i), y, psi0, device="cpu")
                           .result.log_likelihood) for i in range(reps)])
    assert np.var(lls2) < np.var(lls0) / 20.0, (np.var(lls2), np.var(lls0))
    assert abs(np.mean(lls2) - ll_exact) < 0.05
    _, psi = ttw.iterated_apf(tssm, 256, torch.Generator().manual_seed(0), y, return_psi=True, device="cpu")
    assert (psi.a[:, 0] > 0).all()


def test_twisting_validates_the_model_contract():
    """Where the JAX package raises, the port raises."""
    td = pt.distributions
    lq = torch.tensor(np.linalg.cholesky([[0.3, 0.1], [0.1, 0.2]]), dtype=torch.float32)
    hidden = pt.timeseries.AffineProcess(lambda x, a: (a * x.value, 1.0), (torch.tensor(0.9),),
                                         td.MultivariateNormal(torch.zeros(2), scale_tril=lq),
                                         lambda a: td.MultivariateNormal(torch.zeros(2), scale_tril=lq))
    ssm = pt.timeseries.LinearStateSpaceModel(hidden, (1.0, 0.2), event_shape=(2,))
    with pytest.raises(ValueError, match="Normal increments"):
        ttw.iterated_apf(ssm, 32, torch.Generator(), np.zeros((4, 2), np.float32), device="cpu")
    _, ar = ar_pair()
    sub = pt.timeseries.LinearStateSpaceModel(ar.hidden, (1.0, 0.2), observe_every_step=2)
    with pytest.raises(ValueError, match="observe_every_step"):
        ttw.twisted_pass(sub, 32, torch.Generator(), np.zeros(4, np.float32),
                         ttw.TwistCoefficients.identity(4, 1, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="Normal increments"):
        jtw.iterated_apf(jts.LinearStateSpaceModel(jts.AffineProcess(
            lambda x, a: (a * x.value, 1.0), (jnp.asarray(0.9),),
            pf.distributions.MultivariateNormal(jnp.zeros(2), scale_tril=jnp.asarray(lq.numpy())),
            lambda a: pf.distributions.MultivariateNormal(jnp.zeros(2), scale_tril=jnp.asarray(lq.numpy()))),
            (1.0, 0.2), event_shape=(2,)), 32, jax.random.PRNGKey(0), jnp.zeros((4, 2)))
