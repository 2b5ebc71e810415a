"""The port's linearized, nested and Gaussian-approximate proposals, the mode
finder, the predictive densities, the joint process, the GPF and the
imputation of missing components, held against the JAX package on the same
inputs.

Deterministic pieces take the same numpy inputs in both packages. Sampling
is replayed: ``Normal.sample`` / ``MultivariateNormal.sample`` of both
packages become ``loc + scale * z`` (``loc + L z``) with the same standard
normals ``z``, the nest's Gumbel noise is the JAX proposal's own
(``jax.random.gumbel`` from its key, fed through the port's
``filters.particle.base.gumbel``), and the resampling uniforms are injected
(the JAX filter through a replay resampler, the port's through
``ParticleFilter.resample_uniform``).

Tolerances: rel 1e-5 / abs 5e-5 in float32 (the BASELINE.md gate); rel 1e-4
on whatever passes through a 2-D inverse, ``pinv`` or ``eigvalsh``; indices
exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.filters.particle import proposals as jprops
from pyfilter_tpu.filters.particle.proposals import local_linearization as jlocal
from pyfilter_tpu.filters.particle.proposals import utils as jputils
from pyfilter_tpu.filters.state import ParticleFilterCorrection as JCorrection
from pyfilter_tpu.filters.state import ParticleFilterPrediction as JPrediction
from pyfilter_tpu.ops import systematic_counts as j_counts
from pyfilter_tpu.timeseries import TimeseriesState as JState
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import timeseries as tts
from pyfilter_tpu_torch.filters.particle import base as tbase
from pyfilter_tpu_torch.filters.particle import proposals as tprops
from pyfilter_tpu_torch.filters.particle.proposals import local_linearization as tlocal
from pyfilter_tpu_torch.filters.particle.proposals import utils as tputils
from pyfilter_tpu_torch.filters.state import ParticleFilterPrediction as TPrediction

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 5e-5
RTOL_LINALG = 1e-4
N = 64
F32 = np.float32
SIGMA2 = np.array([0.05, 0.1], F32)
S2 = np.full(2, 0.15, F32)
UKF_SIGMA, UKF_S = math.sqrt(10.0), 1.0


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


# -- the suite's models in both packages (tests/test_filters.py:28-82, 312-330) --------------------
def _jax_model(name):
    if name == "ar":
        return jts.LinearStateSpaceModel(jmodels.AR(0.0, 0.99, 0.05), (1.0, 0.15))
    a = jnp.eye(2, dtype=jnp.float32)
    if name == "joint2d":
        joint = jts.joint_process(proc_1=jmodels.RandomWalk(0.05), proc_2=jmodels.RandomWalk(0.1))
        return jts.LinearStateSpaceModel(joint, (a, jnp.asarray(S2)), event_shape=(2,))
    if name == "rw2d":
        rw = jts.LinearModel(
            (a, jnp.asarray(SIGMA2)),
            jdist.Normal(0.0, 1.0).expand((2,)).to_event(1),
            lambda m_, _, s_: jdist.Normal(0.0, s_).expand((2,)).to_event(1),
            event_ndim=1,
        )
        return jts.LinearStateSpaceModel(rw, (a, jnp.asarray(S2)), event_shape=(2,))

    def mean_scale(x, s_):
        v = x.value
        return v / 2.0 + 25 * v / (1 + v**2.0) + 8.0 * jnp.cos(1.2 * x.time_index), s_

    hidden = jts.AffineProcess(mean_scale, (UKF_SIGMA,), jdist.Normal(0.0, 1.0),
                               lambda *a: jdist.Normal(0.0, math.sqrt(5.0)))
    return jts.StateSpaceModel(hidden, lambda x, s_: jdist.Normal(x.value**2.0 / 20.0, s_), (UKF_S,))


def _port_model(name):
    if name == "ar":
        return pt.convert.linear_ssm_from_numpy(pt.convert.ar_from_numpy(F32(0.0), F32(0.99), F32(0.05), device="cpu"),
                                                F32(1.0), F32(0.0), F32(0.15))
    if name == "rw2d":
        return pt.convert.rw2d_from_numpy(np.eye(2, dtype=F32), SIGMA2, S2, device="cpu")
    if name == "joint2d":
        return pt.convert.joint_random_walks_from_numpy(SIGMA2, np.eye(2, dtype=F32), S2, device="cpu")
    return pt.convert.ukf_benchmark_from_numpy(F32(UKF_SIGMA), F32(UKF_S), device="cpu")


def _ev(name):
    return 1 if name in ("rw2d", "joint2d") else 0


def _shape(name, lead=(N,)):
    return tuple(lead) + ((2,) if _ev(name) else ())


class _Noise:
    """Standard normals replayed in both packages: every draw at step ``t``
    is ``loc + scale * z[t]``."""

    def __init__(self, z):
        self.z, self.t = z, 0

    def patch(self, monkeypatch):
        noise = self

        def j_normal(self, key, sample_shape=()):
            return self.loc + self.scale * jnp.asarray(noise.z[noise.t])

        def j_mvn(self, key, sample_shape=()):
            return self.loc + jnp.einsum("...ij,...j->...i", self.scale_tril, jnp.asarray(noise.z[noise.t]))

        def t_normal(self, generator, sample_shape=()):
            return self.loc + self.scale * _t(noise.z[noise.t])

        def t_mvn(self, generator, sample_shape=()):
            return self.loc + torch.einsum("...ij,...j->...i", self.scale_tril, _t(noise.z[noise.t]))

        monkeypatch.setattr(jdist.Normal, "sample", j_normal)
        monkeypatch.setattr(jdist.MultivariateNormal, "sample", j_mvn)
        monkeypatch.setattr(tdist.Normal, "sample", t_normal)
        monkeypatch.setattr(tdist.MultivariateNormal, "sample", t_mvn)


def _states(name, seed, time_index=3.0):
    """The same random cloud ``(N, [2])`` as a JAX and a port state."""
    x = (np.random.default_rng(seed).normal(size=_shape(name)) * (2.0 if name == "ukf" else 0.3)).astype(F32)
    return JState(jnp.asarray(time_index), jnp.asarray(x), _ev(name)), tts.TimeseriesState(time_index, _t(x), _ev(name))


def _y(name, seed):
    y = np.random.default_rng(seed).normal(size=(2,) if _ev(name) else ())
    return np.asarray(y + (2.0 if name == "ukf" else 0.0), F32)


def _predictions(name, seed, weights=True):
    """The same prediction (cloud, log-weights, probabilities, identity) in both packages."""
    js, ts_ = _states(name, seed)
    rng = np.random.default_rng(seed + 100)
    lw = (rng.normal(size=N) if weights else np.zeros(N)).astype(F32)
    p = np.exp(lw - lw.max())
    p = (p / p.sum()).astype(F32)
    idx = np.arange(N, dtype=np.int32)
    return (JPrediction(js, jnp.asarray(lw), jnp.asarray(p), jnp.asarray(idx)),
            TPrediction(ts_, _t(lw), _t(p), _t(idx)))


def _params(d):
    """A Gaussian kernel's parameters: (loc, scale) or (loc, scale_tril)."""
    d = getattr(d, "base_dist", d)
    tril = getattr(d, "scale_tril", None)
    return [np.asarray(d.loc), np.asarray(d.scale if tril is None else tril)]


# -- the mode finder --------------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["ar", "rw2d", "ukf"])
def test_joint_log_prob_gradient_and_hessian_match_jax(name):
    """The summed objective, its gradient (``torch.func.grad``) and every
    particle's Hessian (``torch.func.vjp`` rows) at a random point."""
    js, ts_ = _states(name, 1)
    y = _y(name, 2)
    jm, tm = _jax_model(name), _port_model(name)
    jobj = jputils._joint_log_prob_fn(jm, jm.hidden.build_density(js), js, jnp.asarray(y))
    tobj = tputils._joint_log_prob_fn(tm, tm.hidden.build_density(ts_), ts_, _t(y))
    x = (np.random.default_rng(3).normal(size=_shape(name)) * 0.3).astype(F32)
    _close(tobj(_t(x)), jobj(jnp.asarray(x)))
    jgrad, tgrad = jax.grad(jobj), torch.func.grad(tobj)
    _close(tgrad(_t(x)), jgrad(jnp.asarray(x)), atol=1e-3)
    th = tputils._per_particle_hessian(tgrad, _t(x), _ev(name))
    jh = jputils._per_particle_hessian(jgrad, jnp.asarray(x), _ev(name))
    assert tuple(th.shape) == tuple(jh.shape) == ((N, 2, 2) if _ev(name) else (N,))
    _close(th, jh, atol=1e-3)


@pytest.mark.parametrize("name,use_hessian", [("ar", False), ("ar", True), ("rw2d", False), ("rw2d", True),
                                              ("ukf", True)])
def test_find_mode_matches_jax(name, use_hessian):
    """Five gradient or damped-Newton steps from the propagated mean: the
    proposal kernel's location and scale (or Cholesky factor)."""
    js, ts_ = _states(name, 4)
    y = _y(name, 5)
    jm, tm = _jax_model(name), _port_model(name)
    jmean, jstd = jm.hidden.mean_scale(js)
    tmean, tstd = tm.hidden.mean_scale(ts_)
    kw = dict(num_steps=5, alpha=1e-2, use_hessian=use_hessian)
    jk = jputils.find_mode(jm, js, jnp.asarray(y), init_x=jmean, init_std=jstd, **kw)
    tk = tputils.find_mode(tm, ts_, _t(y), init_x=tmean, init_std=tstd, **kw)
    assert type(tk).__name__ == type(jk).__name__
    rtol = RTOL_LINALG if use_hessian and _ev(name) else RTOL
    for tp, jp in zip(_params(tk), _params(jk)):
        assert tp.shape == jp.shape and np.isfinite(tp).all()
        _close(tp, jp, rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("name", ["ar", "rw2d"])
def test_find_mode_non_finite_fallback_matches_jax(name):
    """A particle whose objective overflows (a previous value of 1e38)
    keeps the linearization point and the initial scale in both packages;
    the others take their damped-Newton mode."""
    js, ts_ = _states(name, 6)
    x = np.array(js.value)
    x[5] = 1e38
    js, ts_ = JState(js.time_index, jnp.asarray(x), _ev(name)), tts.TimeseriesState(3.0, _t(x), _ev(name))
    y = _y(name, 7)
    jm, tm = _jax_model(name), _port_model(name)
    jmean, jstd = jm.hidden.mean_scale(js)
    tmean, tstd = tm.hidden.mean_scale(ts_)
    jk = jputils.find_mode(jm, js, jnp.asarray(y), init_x=jmean, init_std=jstd, num_steps=2, alpha=1e-2,
                           use_hessian=True)
    tk = tputils.find_mode(tm, ts_, _t(y), init_x=tmean, init_std=tstd, num_steps=2, alpha=1e-2, use_hessian=True)
    (tloc, tscale), (jloc, jscale) = _params(tk), _params(jk)
    np.testing.assert_array_equal(tloc[5], np.asarray(tmean)[5])
    assert np.isfinite(tscale).all() and np.isfinite(tloc[np.arange(N) != 5]).all()
    _close(tloc, jloc, rtol=RTOL_LINALG, atol=1e-4)
    _close(tscale, jscale, rtol=RTOL_LINALG, atol=1e-4)


# -- predictive densities and the joint process ------------------------------------------------------
@pytest.mark.parametrize("name", ["ar", "rw2d"])
def test_predictive_density_matches_jax(name, monkeypatch):
    """The exact predictive (the transition density of every particle) and
    the approximate one (a Gaussian fitted to the weighted cloud propagated
    once): parameters and log-densities."""
    jpred, tpred = _predictions(name, 8)
    jm, tm = _jax_model(name), _port_model(name)
    noise = _Noise((np.random.default_rng(9).normal(size=(1,) + _shape(name))).astype(F32))
    noise.patch(monkeypatch)
    v = (np.random.default_rng(10).normal(size=_shape(name)) * 0.3).astype(F32)
    for approximate in (False, True):
        jd = jpred.get_predictive_density(jm, key=jax.random.PRNGKey(0), approximate=approximate)
        td = tpred.get_predictive_density(tm, None, approximate=approximate)
        assert type(td).__name__ == type(jd).__name__
        rtol = RTOL_LINALG if approximate and _ev(name) else RTOL
        for tp, jp in zip(_params(td), _params(jd)):
            _close(tp, jp, rtol=rtol)
        _close(td.log_prob(_t(v)), jd.log_prob(jnp.asarray(v)), rtol=rtol)


def test_joint_process_matches_jax():
    """``joint_process`` of two random walks: ``build_density`` (log-density,
    mean, variance), ``mean_scale``, the initial density, and the model
    built on it against the 2-D linear random walk it equals."""
    js, ts_ = _states("joint2d", 11)
    jm, tm = _jax_model("joint2d"), _port_model("joint2d")
    jd, td = jm.hidden.build_density(js), tm.hidden.build_density(ts_)
    assert isinstance(td, tts.JointDistribution) and td.event_shape == (2,) and td.batch_shape == (N,)
    v = (np.random.default_rng(12).normal(size=(N, 2)) * 0.3).astype(F32)
    _close(td.log_prob(_t(v)), jd.log_prob(jnp.asarray(v)))
    _close(td.mean, jd.mean)
    _close(td.variance, jd.variance)
    for tp, jp in zip(tm.hidden.mean_scale(ts_), jm.hidden.mean_scale(js)):
        _close(tp, jp)
    _close(tm.hidden.initial_distribution().log_prob(_t(v)), jm.hidden.initial_distribution().log_prob(jnp.asarray(v)))
    rw = _port_model("rw2d")
    _close(td.log_prob(_t(v)), rw.hidden.build_density(ts_).log_prob(_t(v)))
    _close(tm.build_density(ts_).log_prob(_t(v[0])), jm.build_density(js).log_prob(jnp.asarray(v[0])))


def test_mvn_from_covariance_and_precision_matches_jax():
    """``MultivariateNormal`` from a covariance and from a precision matrix,
    its ``mean``, ``variance`` and ``expand``; a non-positive-definite
    covariance gives a NaN factor, as ``jnp.linalg.cholesky`` does."""
    rng = np.random.default_rng(13)
    a = rng.normal(size=(3, 3, 3)).astype(F32)
    cov = (a @ np.swapaxes(a, -1, -2) + np.eye(3, dtype=F32)).astype(F32)
    loc = rng.normal(size=(3, 3)).astype(F32)
    v = rng.normal(size=(3, 3)).astype(F32)
    for kw in ("covariance_matrix", "precision_matrix"):
        jd = jdist.MultivariateNormal(jnp.asarray(loc), **{kw: jnp.asarray(cov)})
        td = tdist.MultivariateNormal(_t(loc), **{kw: _t(cov)})
        _close(td.scale_tril, jd.scale_tril, rtol=RTOL_LINALG)
        _close(td.log_prob(_t(v)), jd.log_prob(jnp.asarray(v)), rtol=RTOL_LINALG)
        _close(td.mean, jd.mean)
        _close(td.variance, jd.variance, rtol=RTOL_LINALG)
    te = tdist.MultivariateNormal(_t(loc[:1]), _t(np.linalg.cholesky(cov[:1]))).expand((5,))
    assert te.batch_shape == (5,) and tuple(te.scale_tril.shape) == (5, 3, 3)
    bad = tdist.MultivariateNormal(_t(loc[0]), covariance_matrix=_t(-np.eye(3, dtype=F32)))
    assert torch.isnan(bad.scale_tril).all()
    with pytest.raises(ValueError):
        tdist.MultivariateNormal(_t(loc[0]))


# -- the proposals ------------------------------------------------------------------------------------
def _proposal_pairs(name):
    """(label, JAX proposal, port proposal) of the slice, for ``name``."""
    pairs = [
        ("linearized", jprops.Linearized(n_steps=5, alpha=1e-2), tprops.Linearized(n_steps=5, alpha=1e-2)),
        ("linearized2", jprops.Linearized(n_steps=5, use_second_order=True),
         tprops.Linearized(n_steps=5, use_second_order=True)),
        ("gaussian", jprops.GaussianProposal(), tprops.GaussianProposal()),
        ("glinearized", jprops.GaussianLinearized(n_steps=5, alpha=1e-2),
         tprops.GaussianLinearized(n_steps=5, alpha=1e-2)),
        ("glinearized2", jprops.GaussianLinearized(n_steps=5, use_second_order=True),
         tprops.GaussianLinearized(n_steps=5, use_second_order=True)),
        ("glinear", jprops.GaussianLinear(), tprops.GaussianLinear()),
    ]
    if name == "ar":
        f, df = (lambda x, a, b, s: b + a * x.value), (lambda x, a, b, s: a * jnp.ones_like(x.value))
        tdf = lambda x, a, b, s: a * torch.ones_like(x.value)  # noqa: E731
    else:
        f = lambda x, a, b, s: b + x.value @ a.T  # noqa: E731
        df = lambda x, a, b, s: jnp.broadcast_to(a, x.value.shape + (2,))  # noqa: E731
        tdf = lambda x, a, b, s: a.expand(tuple(x.value.shape) + (2,))  # noqa: E731
    pairs += [
        ("local-autodiff", jprops.LocalLinearization(f=f), tprops.LocalLinearization(f=f)),
        ("local-derivative", jprops.LocalLinearization(f=f, linearized_f=df),
         tprops.LocalLinearization(f=f, linearized_f=tdf)),
    ]
    return pairs


@pytest.mark.parametrize("name", ["ar", "rw2d"])
def test_proposals_sample_and_weight_match_jax(name, monkeypatch):
    """``sample_and_weight`` of every proposal of the slice on one weighted
    cloud of 64 particles, with replayed normals: the new particles and
    their incremental log-weights, and the APF pre-weight of the local
    linearization."""
    jpred, tpred = _predictions(name, 14)
    jm, tm = _jax_model(name), _port_model(name)
    y = _y(name, 15)
    noise = _Noise(np.random.default_rng(16).normal(size=(1,) + _shape(name)).astype(F32))
    noise.patch(monkeypatch)
    for label, jp, tp in _proposal_pairs(name):
        jx, jw = jp.sample_and_weight(jax.random.PRNGKey(1), jm, jnp.asarray(y), jpred)
        tx, tw = tp.sample_and_weight(None, tm, _t(y), tpred)
        assert tx.time_index == float(jx.time_index) == 4.0, label
        rtol = RTOL_LINALG if _ev(name) else RTOL
        _close(tx.value, jx.value, rtol=rtol, atol=1e-4)
        _close(tw, jw, rtol=rtol, atol=1e-3)
        if label.startswith("local"):
            _close(tp.pre_weight(tm, _t(y), tpred.x), jp.pre_weight(jm, jnp.asarray(y), jpred.x), rtol=rtol)


@pytest.mark.parametrize("name", ["ar", "rw2d"])
def test_nested_proposal_matches_jax(name, monkeypatch):
    """``NestedProposal(10)``: the nest's candidates replayed, the choice
    made by the same Gumbel noise (the JAX proposal's own): the chosen
    particles exactly, the weights ``logsumexp - log M``; then the NaN
    guard, a particle whose nest has no finite likelihood picking the first
    candidate of its Gumbel argmax over zero logits."""
    m = 10
    jpred, tpred = _predictions(name, 17)
    jm, tm = _jax_model(name), _port_model(name)
    y = _y(name, 18)
    z = np.random.default_rng(19).normal(size=(1, m) + _shape(name)).astype(F32)
    noise = _Noise(z)
    noise.patch(monkeypatch)
    key = jax.random.PRNGKey(20)
    g = np.asarray(jax.random.gumbel(jax.random.split(key)[1], (N, m), jnp.float32))
    monkeypatch.setattr(tbase, "gumbel", lambda generator, shape, like: _t(g))
    jx, jw = jprops.NestedProposal(m).sample_and_weight(key, jm, jnp.asarray(y), jpred)
    tx, tw = tprops.NestedProposal(m).sample_and_weight(None, tm, _t(y), tpred)
    np.testing.assert_array_equal(tx.value.numpy(), np.asarray(jx.value))
    _close(tw, jw)

    y_nan = np.full_like(y, np.nan)
    jx, jw = jprops.NestedProposal(m).sample_and_weight(key, jm, jnp.asarray(y_nan), jpred)
    tx, tw = tprops.NestedProposal(m).sample_and_weight(None, tm, _t(y_nan), tpred)
    np.testing.assert_array_equal(tx.value.numpy(), np.asarray(jx.value))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_local_linearization_on_the_nonlinear_model_matches_jax(monkeypatch):
    """The local linearization of ``x^2 / 20`` (the UKF benchmark model),
    with the derivative given and from ``torch.func.jvp``: the Jacobian,
    ``sample_and_weight`` and the pre-weight."""
    jpred, tpred = _predictions("ukf", 21)
    jm, tm = _jax_model("ukf"), _port_model("ukf")
    y = _y("ukf", 22)
    noise = _Noise(np.random.default_rng(23).normal(size=(1, N)).astype(F32))
    noise.patch(monkeypatch)
    x = np.asarray(jpred.x.value)
    _close(tlocal._per_particle_jacobian(lambda v: v**2.0 / 20.0, _t(x), 0),
           jlocal._per_particle_jacobian(lambda v: v**2.0 / 20.0, jnp.asarray(x), 0, 0))
    jf, jdf = (lambda x, s: x.value**2.0 / 20.0), (lambda x, s: x.value / 10.0)
    for jd, td in ((jdf, pt.convert.ukf_benchmark_mean_derivative), (None, None)):
        jp = jprops.LocalLinearization(f=jf, linearized_f=jd)
        tp = tprops.LocalLinearization(f=pt.convert.ukf_benchmark_mean, linearized_f=td)
        jx, jw = jp.sample_and_weight(jax.random.PRNGKey(2), jm, jnp.asarray(y), jpred)
        tx, tw = tp.sample_and_weight(None, tm, _t(y), tpred)
        _close(tx.value, jx.value)
        _close(tw, jw, atol=1e-4)
        _close(tp.pre_weight(tm, _t(y), tpred.x), jp.pre_weight(jm, jnp.asarray(y), jpred.x))


def test_proposal_checks():
    """The JAX package's constructor and model checks."""
    with pytest.raises(ValueError):
        tprops.Linearized(n_steps=0)
    with pytest.raises(ValueError):
        tprops.LocalLinearization()
    state = _predictions("ar", 24)[1]
    ukf = _port_model("ukf")
    with pytest.raises(ValueError):
        tprops.GaussianLinear().sample_and_weight(None, ukf, torch.tensor(0.0), state)


# -- whole filters, replayed ---------------------------------------------------------------------------
def _start(name, seed):
    """One initial cloud as a JAX and a port correction."""
    x0 = (np.random.default_rng(seed).normal(size=_shape(name)) * 0.1).astype(F32)
    jstate = JCorrection.from_weighted_particles(
        JState(jnp.asarray(0.0), jnp.asarray(x0), _ev(name)), jnp.zeros(N), jnp.zeros(()),
        jnp.arange(N, dtype=jnp.int32))
    tstate = pt.convert.correction_from_numpy(
        *(np.asarray(a) for a in (jstate.x.time_index, jstate.x.value, jstate.log_weights, jstate.log_likelihood,
                                  jstate.prev_indices, jstate.mean, jstate.variance)),
        event_ndim=_ev(name), device="cpu")
    return jstate, tstate


def _run_replayed(jfilt, tfilt, jstate, tstate, y, noise):
    """Step both filters through ``y`` with their own ``filter``, the JAX one
    eagerly; each step's means and log-likelihood increments."""
    out = {"jax": ([], []), "port": ([], [])}
    with jax.disable_jit():
        for t in range(y.shape[0]):
            noise.t = t
            jstate = jfilt.filter(jax.random.PRNGKey(t), jnp.asarray(y[t]), jstate, first_step=t == 0)
            tstate = tfilt.filter(None, y[t], tstate, first_step=t == 0)
            for key, s in (("jax", jstate), ("port", tstate)):
                out[key][0].append(np.asarray(s.mean))
                out[key][1].append(np.asarray(s.log_likelihood))
    return [np.stack(a) for a in out["jax"]], [np.stack(a) for a in out["port"]], jstate, tstate


def test_gpf_glinearized2_filter_matches_jax(monkeypatch):
    """A whole GPF with ``GaussianLinearized(n_steps=5,
    use_second_order=True)`` over 10 steps of the 2-D random walk, replayed:
    means, log-likelihoods and the final cloud; the GPF never resamples, so
    the ancestry stays the identity."""
    name, n_steps = "rw2d", 10
    rng = np.random.default_rng(25)
    y = (np.cumsum(rng.normal(size=(n_steps, 2)), axis=0) * 0.1).astype(F32)
    noise = _Noise(rng.normal(size=(n_steps,) + _shape(name)).astype(F32))
    noise.patch(monkeypatch)
    jfilt = pf.GPF(_jax_model(name), N, proposal=jprops.GaussianLinearized(n_steps=5, use_second_order=True))
    tfilt = pt.GPF(_port_model(name), N, proposal=tprops.GaussianLinearized(n_steps=5, use_second_order=True),
                   device="cpu")
    (jm, jl), (tm, tl), jstate, tstate = _run_replayed(jfilt, tfilt, *_start(name, 26), y, noise)
    assert np.isfinite(tl).all() and tfilt.n_resamples == 0
    _close(tm, jm, rtol=RTOL_LINALG, atol=1e-4)
    _close(tl, jl, rtol=RTOL_LINALG, atol=1e-4)
    _close(tstate.x.value, jstate.x.value, rtol=RTOL_LINALG, atol=1e-4)
    np.testing.assert_array_equal(tstate.prev_indices.numpy(), np.arange(N))


class _ReplaySISRT(pt.SISR):
    """The port's SISR whose fused resample takes the current step's uniform."""

    def __init__(self, *args, us, noise, **kwargs):
        super().__init__(*args, **kwargs)
        self.us, self.noise = us, noise

    def resample_uniform(self, generator):
        return torch.tensor(self.us[self.noise.t])


def test_impute_strategy_matches_jax(monkeypatch):
    """``nan_strategy="impute"`` with the bootstrap SISR on the 2-D random
    walk over 12 steps, replayed: a partly missing row is filled with the
    weighted predicted observation mean and corrected; the log-likelihoods,
    means and ancestry agree with the JAX package's."""
    name, n_steps = "rw2d", 12
    rng = np.random.default_rng(27)
    y = (np.cumsum(rng.normal(size=(n_steps, 2)), axis=0) * 0.1).astype(F32)
    y[3, 0] = y[7, 1] = np.nan
    noise = _Noise(rng.normal(size=(n_steps,) + _shape(name)).astype(F32))
    us = rng.uniform(size=n_steps).astype(F32)
    noise.patch(monkeypatch)
    jfilt = pf.SISR(_jax_model(name), N, nan_strategy="impute",
                    resampling_method=lambda key, w, normalized=False: j_counts(None, w, normalized=normalized,
                                                                                u=jnp.asarray(us[noise.t])))
    tfilt = _ReplaySISRT(_port_model(name), N, nan_strategy="impute", device="cpu", us=us, noise=noise)
    (jm, jl), (tm, tl), jstate, tstate = _run_replayed(jfilt, tfilt, *_start(name, 28), y, noise)
    assert np.isfinite(tl).all() and np.all(tl[[3, 7]] != 0.0)
    _close(tm, jm)
    _close(tl, jl)
    np.testing.assert_array_equal(tstate.prev_indices.numpy(), np.asarray(jstate.prev_indices))
    with pytest.raises(ValueError):
        pt.SISR(_port_model(name), N, nan_strategy="drop", device="cpu")
