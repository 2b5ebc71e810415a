"""The port's Gaussian-sum filter and smoother and its IMM filter and Kim
smoother, held against the JAX package's ``pyfilter_tpu/filters/gsf.py`` and
``imm.py``.

The same models and observations (numpy, fixed seeds) in both packages: the
log-likelihood, the mixture (regime-marginalized) moments, the bank's weights
and per-component moments, the regime probabilities and the smoothed
moments within rel 1e-5 / abs 1e-5 (``BASELINE.md``). The IMM's per-step
regime log-probabilities are compared as probabilities: the log-probability
of a regime the data nearly rule out (e^-9 to e^-43 here) carries the
float32 rounding of the running log-likelihoods it is a difference of, up to
1e-4 in the log, which is 1e-8 in the probability. The GSF's prior split
takes the top eigenvector of ``P0`` from ``eigh``, whose sign is free; on
the CPU both packages call LAPACK for it, so the components come in the same
order. Then the JAX package's own checks on the port: a dead component is
demoted to weight -inf and a dead bank keeps its weights
(``tests/test_gsf.py:148,167``), lane batching equals a per-lane loop
(``tests/test_gsf.py:179``, ``tests/test_imm.py:122``), identical regimes
reduce to the single filter, and the argument checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.timeseries import models as jmodels
from test_torch_port_kalman import ar_data, ar_pair, close

torch.set_num_threads(1)

TM = pt.timeseries.models
OBS_STD = 0.1


def quad_pair():
    """A random walk (sd 0.05, initial sd sqrt 2) observed as ``x^2 + 0.2 v``
    (``examples/streaming_and_switching.py`` part 3's sign-ambiguous model)."""
    jrw = jts.AffineProcess(lambda x, s: (x.value, s), (0.05,), jdist.Normal(0.0, 1.0),
                            lambda s: jdist.Normal(0.0, jnp.sqrt(2.0)))
    jssm = jts.StateSpaceModel(jrw, lambda x, sc: jdist.Normal(x.value**2, sc), (0.2,))
    dist = pt.distributions
    trw = pt.timeseries.AffineProcess(lambda x, s: (x.value, s), (torch.tensor(0.05),),
                                      dist.Normal(torch.tensor(0.0), torch.tensor(1.0)),
                                      lambda s: dist.Normal(torch.zeros_like(s), torch.full_like(s, 2.0**0.5)))
    tssm = pt.timeseries.StateSpaceModel(trw, lambda x, sc: dist.Normal(x.value**2, sc), (torch.tensor(0.2),))
    return jssm, tssm


def quad_data(n=30, seed=5):
    rng = np.random.default_rng(seed)
    x, y = rng.normal(0.0, 2.0**0.5), np.empty(n, np.float32)
    for t in range(n):
        x = x + 0.05 * rng.normal()
        y[t] = x * x + 0.2 * rng.normal()
    return y


def imm_pair(sigma, beta=0.9):
    """The AR(beta, sigma) regime observed with noise OBS_STD in both packages;
    ``sigma`` a number or one value per lane."""
    jssm = jts.LinearStateSpaceModel(jmodels.AR(0.0, beta, jnp.asarray(sigma)), (1.0, OBS_STD))
    tssm = pt.convert.linear_ssm_from_numpy(TM.AR(0.0, beta, np.asarray(sigma, np.float32), device="cpu"), 1.0,
                                           0.0, OBS_STD)
    return jssm, tssm


def switching_data(seed, t_obs=60, block=15, sigmas=(0.1, 1.0), beta=0.9):
    """``tests/test_imm.py``'s Markov-switching AR(1) series."""
    rng = np.random.default_rng(seed)
    regime = (np.arange(t_obs) // block) % len(sigmas)
    x = np.zeros(t_obs, np.float32)
    prev = rng.normal(0.0, sigmas[0])
    for t in range(t_obs):
        prev = beta * prev + sigmas[regime[t]] * rng.normal()
        x[t] = prev
    return regime, (x + OBS_STD * rng.normal(size=t_obs)).astype(np.float32)


def sticky(k, stay=0.95):
    return np.full((k, k), (1.0 - stay) / (k - 1)) + np.eye(k) * (stay - (1.0 - stay) / (k - 1))


def same_result(jres, tres):
    for name in ("log_likelihood", "step_log_likelihoods", "filter_means", "filter_variances"):
        close(getattr(tres, name), getattr(jres, name))
    if jres.aux is None:
        assert tres.aux is None
    else:
        close(torch.exp(tres.aux), np.exp(np.asarray(jres.aux)))


def same_state(jstate, tstate):
    for a, b in zip(tstate, jstate):
        if isinstance(a, torch.Tensor):
            close(a, b)


@pytest.mark.parametrize("base", ["ekf", "ukf", "ckf"])
@pytest.mark.parametrize("model", ["ar", "quadratic"])
def test_gsf_matches_jax(base, model):
    (jm, tm), y = (ar_pair(), ar_data(30, 6, nan_rows=(9,))) if model == "ar" else (quad_pair(), quad_data())
    jg = pf.GaussianSumFilter(jm, n_components=3, spread=0.5, base=base)
    tg = pt.GaussianSumFilter(tm, n_components=3, spread=0.5, base=base, device="cpu")
    same_state(jg.initialize(), tg.initialize())
    jres, tres = jg.batch_filter(jnp.asarray(y)), tg.batch_filter(y)
    same_result(jres, tres)
    same_state(jres.latest_state, tres.latest_state)
    if model == "ar":
        assert float(tres.step_log_likelihoods[9]) == 0.0
    for a, b in zip(tres.latest_state.map_component(), jres.latest_state.map_component()):
        close(a, b)


def test_gsf_smoother_matches_jax():
    """``examples/streaming_and_switching.py`` part 3's smoother (4
    components, spread 0.7): mixture moments, component means and
    covariances, final weights."""
    jm, tm = quad_pair()
    y = quad_data(20, 7)
    jout = pf.GaussianSumFilter(jm, n_components=4, spread=0.7).smooth(jnp.asarray(y))
    tout = pt.GaussianSumFilter(tm, n_components=4, spread=0.7, device="cpu").smooth(y)
    close(tout[0], jout[0])
    close(tout[1], jout[1])
    for a, b in zip(tout[2], jout[2]):
        close(a, b)


def test_gsf_single_component_is_the_base_filter():
    tm = ar_pair()[1]
    y = ar_data(30, 7)
    res = pt.GaussianSumFilter(tm, n_components=1, device="cpu").batch_filter(y)
    ekf = pt.ExtendedKalmanFilter(tm, device="cpu").batch_filter(y)
    close(res.log_likelihood, ekf.log_likelihood)
    close(res.filter_means, ekf.filter_means)


def test_gsf_validates_arguments():
    tm = ar_pair()[1]
    for kwargs in ({"n_components": 0}, {"spread": 1.0}, {"base": "enkf"}):
        with pytest.raises(ValueError):
            pt.GaussianSumFilter(tm, device="cpu", **kwargs)


def test_gsf_dead_component_cannot_poison_the_bank():
    """``tests/test_gsf.py:148``: a component whose covariance lost
    positive-definiteness has a NaN likelihood (its factor fails on the
    device) and is demoted to weight -inf; the rest filter on."""
    gsf = pt.GaussianSumFilter(ar_pair()[1], n_components=3, spread=0.5, device="cpu")
    st = gsf.initialize()
    covs = st.covs.clone()
    covs[0] = -torch.eye(covs.shape[-1])
    new = gsf.filter(torch.tensor(0.3), st._replace(covs=covs))
    lw = new.log_weights.numpy()
    assert np.isneginf(lw[0]) and np.isfinite(lw[1:]).all()
    close(np.exp(lw).sum(), 1.0)
    assert np.isfinite(float(new.log_likelihood)) and torch.isfinite(new.means[1:]).all()


def test_gsf_all_components_dead_keeps_previous_weights():
    """``tests/test_gsf.py:167``: every component dead keeps the weights and
    reports the -inf increment."""
    gsf = pt.GaussianSumFilter(ar_pair()[1], n_components=2, spread=0.5, device="cpu")
    st = gsf.initialize()
    st = st._replace(covs=-torch.eye(st.covs.shape[-1]).expand(st.covs.shape))
    new = gsf.filter(torch.tensor(0.3), st)
    close(new.log_weights, st.log_weights, atol=1e-6)
    assert np.isneginf(float(new.log_likelihood))


def test_gsf_lane_batching_matches_per_lane_loop_and_jax():
    """``tests/test_gsf.py:179``: one vmap over lane-batched model leaves
    reproduces independent single-lane banks; and the JAX package's lanes."""
    betas = np.asarray([0.5, 0.7, 0.9], np.float32)
    y = ar_data(30, 8)
    jm = jts.LinearStateSpaceModel(jmodels.AR(0.2, jnp.asarray(betas), 0.4), (1.0, 0.25))
    tm = ar_pair(beta=betas)[1]
    jres = pf.GaussianSumFilter(jm, n_components=3, spread=0.5, batch_shape=(3,)).batch_filter(jnp.asarray(y))
    tres = pt.GaussianSumFilter(tm, n_components=3, spread=0.5, batch_shape=(3,), device="cpu").batch_filter(y)
    assert tuple(tres.log_likelihood.shape) == (3,) and tuple(tres.filter_means.shape[:2]) == (30, 3)
    same_result(jres, tres)
    same_state(jres.latest_state, tres.latest_state)
    for i, b in enumerate(betas):
        single = pt.GaussianSumFilter(ar_pair(beta=float(b))[1], n_components=3, spread=0.5,
                                      device="cpu").batch_filter(y)
        close(tres.log_likelihood[i], single.log_likelihood, rtol=2e-5)
        close(tres.filter_means[:, i], single.filter_means, rtol=2e-4)
    perm = tres.latest_state.resample(torch.tensor([2, 0, 1]))
    close(perm.log_likelihood, tres.latest_state.log_likelihood[[2, 0, 1]])


@pytest.mark.parametrize("base", ["ekf", "ukf"])
def test_imm_filter_and_kim_smoother_match_jax(base):
    _, y = switching_data(3)
    y[20] = np.nan
    jimm = pf.InteractingMultipleModel([imm_pair(0.1)[0], imm_pair(1.0)[0]], sticky(2), base=base)
    timm = pt.InteractingMultipleModel([imm_pair(0.1)[1], imm_pair(1.0)[1]], sticky(2), base=base, device="cpu")
    same_state(jimm.initialize(), timm.initialize())
    jres, tres = jimm.batch_filter(jnp.asarray(y)), timm.batch_filter(y)
    same_result(jres, tres)
    same_state(jres.latest_state, tres.latest_state)
    assert float(tres.step_log_likelihoods[20]) == 0.0
    assert int(tres.latest_state.most_likely_regime()) == int(jres.latest_state.most_likely_regime())
    jsm, tsm = jimm.smooth(jnp.asarray(y)), timm.smooth(y)
    for a, b in zip(tsm[:3], jsm[:3]):
        close(a, b)
    for a, b in zip(tsm[3], jsm[3]):
        close(a, b)


def test_imm_observed_every_other_step_matches_jax():
    """Two hidden sub-steps an observation: the Kim smoother's pair
    predictions compose them (``predict_moments_cross``)."""
    _, y = switching_data(4, t_obs=30)
    jm = [jts.LinearStateSpaceModel(jmodels.AR(0.0, 0.9, s), (1.0, OBS_STD), observe_every_step=2) for s in (0.1, 1.0)]
    tm = [pt.convert.linear_ssm_from_numpy(TM.AR(0.0, 0.9, s, device="cpu"), 1.0, 0.0, OBS_STD, observe_every_step=2)
          for s in (0.1, 1.0)]
    jimm, timm = pf.InteractingMultipleModel(jm, sticky(2)), pt.InteractingMultipleModel(tm, sticky(2), device="cpu")
    same_result(jimm.batch_filter(jnp.asarray(y)), timm.batch_filter(y))
    for a, b in zip(timm.smooth(y)[:3], jimm.smooth(jnp.asarray(y))[:3]):
        close(a, b)


def test_imm_identical_regimes_reduce_to_single_filter():
    y = ar_data(40, 9)
    tm = imm_pair(0.4)[1]
    single = pt.ExtendedKalmanFilter(tm, device="cpu").batch_filter(y)
    imm = pt.InteractingMultipleModel([imm_pair(0.4)[1], imm_pair(0.4)[1]], sticky(2), device="cpu").batch_filter(y)
    close(imm.log_likelihood, single.log_likelihood)
    close(imm.filter_means, single.filter_means, rtol=1e-4)
    close(imm.filter_variances, single.filter_variances, rtol=1e-4, atol=1e-7)


def test_imm_lane_batching_matches_per_lane_loop_and_jax():
    """``tests/test_imm.py:122``: lane-batched candidate leaves reproduce
    independent single-lane IMMs; and the JAX package's lanes."""
    sig = np.asarray([0.05, 0.1, 0.2], np.float32)
    _, y = switching_data(5, t_obs=40, block=20)
    jres = pf.InteractingMultipleModel([imm_pair(sig)[0], imm_pair(1.0)[0]], sticky(2),
                                       batch_shape=(3,)).batch_filter(jnp.asarray(y))
    tres = pt.InteractingMultipleModel([imm_pair(sig)[1], imm_pair(1.0)[1]], sticky(2), batch_shape=(3,),
                                       device="cpu").batch_filter(y)
    assert tuple(tres.aux.shape) == (40, 3, 2)
    same_result(jres, tres)
    for i, s in enumerate(sig):
        single = pt.InteractingMultipleModel([imm_pair(float(s))[1], imm_pair(1.0)[1]], sticky(2),
                                             device="cpu").batch_filter(y)
        close(tres.log_likelihood[i], single.log_likelihood, rtol=2e-5)
        close(tres.aux[:, i], single.aux, rtol=1e-3, atol=1e-4)
    mask = torch.tensor([True, False, True])
    mixed = tres.exchange(tres.resample(torch.tensor([1, 2, 0])), mask)
    close(mixed.aux[:, 0], tres.aux[:, 1])
    close(mixed.aux[:, 1], tres.aux[:, 1])


def test_imm_spec_equals_the_list_form_and_converts():
    _, y = switching_data(6, t_obs=40)
    models = [imm_pair(0.1)[1], imm_pair(1.0)[1]]
    spec = pt.convert.markov_switching_from_numpy(models, sticky(2).astype(np.float32))
    a = pt.InteractingMultipleModel(spec, device="cpu").batch_filter(y)
    b = pt.InteractingMultipleModel(models, sticky(2), device="cpu").batch_filter(y)
    close(a.log_likelihood, b.log_likelihood, rtol=1e-6)
    p0 = np.asarray([0.8, 0.2], np.float32)
    jres = pf.InteractingMultipleModel([imm_pair(0.1)[0], imm_pair(1.0)[0]], sticky(2),
                                       initial_probs=p0).batch_filter(jnp.asarray(y))
    spec = pt.convert.markov_switching_from_numpy(models, sticky(2), initial_probs=p0)
    same_result(jres, pt.InteractingMultipleModel(spec, device="cpu").batch_filter(y))


def test_imm_validates_arguments():
    """``tests/test_imm.py:108``: one regime, rows not summing to 1, a wrong
    shape and structurally different candidates are refused."""
    m = imm_pair(0.1)[1]
    with pytest.raises(ValueError):
        pt.InteractingMultipleModel([m], np.eye(1), device="cpu")
    with pytest.raises(ValueError):
        pt.InteractingMultipleModel([m, imm_pair(1.0)[1]], np.ones((2, 2)), device="cpu")
    with pytest.raises(ValueError):
        pt.InteractingMultipleModel([m, imm_pair(1.0)[1]], np.eye(3), device="cpu")
    other = pt.convert.linear_ssm_from_numpy(TM.RandomWalk(0.3, device="cpu"), 1.0, 0.0, OBS_STD)
    with pytest.raises(ValueError, match="structure"):
        pt.InteractingMultipleModel([m, other], sticky(2), device="cpu")
    with pytest.raises(ValueError):
        pt.InteractingMultipleModel([m, imm_pair(1.0)[1]], base="enkf", transition_matrix=sticky(2), device="cpu")
