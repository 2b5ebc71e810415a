"""The port's distribution layer in full, held against the JAX package: every
family, bijector and constraint on the same numpy inputs, the base API, the
samplers' moments, ``convert.distribution_from_numpy`` /
``bijector_from_numpy``, and the methods the ported modules lacked
(``constants.eps_for``, processes' ``n_dim`` / ``sample_states`` /
``expand_initial``, ``AffineProcess.copy_with``, ``StateSpaceModel.n_dim``,
``Proposal.copy``, ``ParticleFilterCorrection.timeseries_state``,
``PriorBoundParameter.get_constrained`` / ``inverse_sample``,
``plot.plot_chains``, ``SMC2State.parsed_data_array``).

Tolerances, by what a method computes: rel 1e-5 / abs 2e-6 where the value
is closed-form in ``exp`` / ``log`` / ``tan`` / ``atan`` (Uniform,
Exponential, Laplace, Cauchy, Gumbel, Logistic, HalfCauchy, Categorical,
Bernoulli, Delta; the log-densities, means and variances of Normal,
LogNormal, HalfNormal; Weibull's density and cdf; every bijector); rel 1e-4
/ abs 1e-5 where a special function enters (``lgamma`` / ``betaln``:
Gamma, InverseGamma, Beta, StudentT, Chi2, Poisson, Binomial,
NegativeBinomial log-densities and Weibull's moments; ``gammainc`` /
``gammaincc``: the Gamma, InverseGamma, Chi2 and Poisson cdfs; ``ndtr`` /
``ndtri``: the Normal, LogNormal and HalfNormal cdf and icdf, every
TruncatedNormal method). torch's and XLA's special functions differ by a few
ULP. Constraint checks are compared for equality. Sampling moments: the
sample mean within 4 SEM (+1e-3) of the law's, as ``tests/test_distributions.py``
holds the JAX package's samplers, and the variance within 5% (discrete and
bounded laws) or within 4 of its own SEM.
"""

import math
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import constants as jconstants
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import inference as jinf
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.distributions import bijectors as jbij
from pyfilter_tpu.distributions import constraints as jcon
from pyfilter_tpu_torch import constants as tconstants
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch.distributions import bijectors as tbij
from pyfilter_tpu_torch.distributions import constraints as tcon
from pyfilter_tpu_torch.timeseries import models as tmodels

torch.set_num_threads(1)

CLOSED = (1e-5, 2e-6)
SPECIAL = (1e-4, 1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _close(a, b, tol=CLOSED):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol[0], atol=tol[1])


F = np.float32
Case = namedtuple("Case", "name params values special")
#: each family at a batch of 3 parameter sets; ``values(rng)`` gives (5, 3)
#: points in the support; ``special``: the methods a special function enters
CASES = [
    Case("Normal", dict(loc=F([0.0, 1.0, -2.0]), scale=F([1.0, 0.5, 2.0])),
         lambda r: r.normal(0.0, 2.0, (5, 3)), {"cdf", "icdf"}),
    Case("LogNormal", dict(loc=F([0.2, -1.0, 0.5]), scale=F([0.7, 0.5, 1.2])),
         lambda r: r.lognormal(0.0, 0.8, (5, 3)), {"cdf", "icdf"}),
    Case("Uniform", dict(low=F([0.0, -1.0, 2.0]), high=F([1.0, 3.0, 5.0])),
         lambda r: np.stack([r.uniform(0, 1, 5), r.uniform(-1, 3, 5), r.uniform(2, 5, 5)], -1), set()),
    Case("Exponential", dict(rate=F([0.5, 1.7, 3.0])), lambda r: r.exponential(1.0, (5, 3)), set()),
    Case("Gamma", dict(concentration=F([0.5, 2.5, 9.0]), rate=F([1.0, 1.3, 0.5])),
         lambda r: r.gamma(2.0, 1.0, (5, 3)), {"log_prob", "cdf"}),
    Case("InverseGamma", dict(concentration=F([1.5, 2.5, 9.0]), rate=F([1.0, 1.3, 0.5])),
         lambda r: 1.0 / r.gamma(2.0, 1.0, (5, 3)), {"log_prob", "cdf"}),
    Case("Beta", dict(concentration1=F([0.5, 2.0, 5.0]), concentration0=F([0.7, 3.0, 1.5])),
         lambda r: r.beta(2.0, 2.0, (5, 3)), {"log_prob"}),
    Case("StudentT", dict(df=F([1.5, 4.0, 10.0]), loc=F([0.0, 0.3, -1.0]), scale=F([1.0, 1.5, 0.5])),
         lambda r: r.standard_t(3.0, (5, 3)), {"log_prob"}),
    Case("Laplace", dict(loc=F([0.4, 0.0, -1.0]), scale=F([1.3, 0.5, 2.0])),
         lambda r: r.laplace(0.0, 1.5, (5, 3)), set()),
    Case("Cauchy", dict(loc=F([-0.2, 0.0, 1.0]), scale=F([0.8, 1.0, 3.0])),
         lambda r: r.standard_cauchy((5, 3)), set()),
    Case("Weibull", dict(scale=F([2.0, 1.0, 0.5]), concentration=F([1.5, 0.8, 3.0])),
         lambda r: r.weibull(1.5, (5, 3)), {"mean", "variance"}),
    Case("HalfNormal", dict(scale=F([1.4, 0.5, 3.0])), lambda r: np.abs(r.normal(0.0, 1.5, (5, 3))),
         {"cdf", "icdf"}),
    Case("HalfCauchy", dict(scale=F([0.7, 1.0, 2.0])), lambda r: np.abs(r.standard_cauchy((5, 3))), set()),
    Case("Gumbel", dict(loc=F([0.3, 0.0, -2.0]), scale=F([1.2, 0.5, 2.0])),
         lambda r: r.gumbel(0.0, 1.0, (5, 3)), set()),
    Case("Logistic", dict(loc=F([-0.5, 0.0, 2.0]), scale=F([0.9, 0.3, 2.0])),
         lambda r: r.logistic(0.0, 1.0, (5, 3)), set()),
    Case("Chi2", dict(df=F([1.0, 3.5, 7.0])), lambda r: r.chisquare(3.0, (5, 3)), {"log_prob", "cdf"}),
    Case("TruncatedNormal", dict(loc=F([0.5, 1.0, 0.0]), scale=F([2.0, 0.5, 1.0]), low=F([-1.0, 0.0, -np.inf]),
                                 high=F([3.0, np.inf, 0.5])),
         lambda r: np.stack([r.uniform(-1, 3, 5), r.uniform(0, 3, 5), r.uniform(-3, 0.5, 5)], -1),
         {"log_prob", "cdf", "icdf", "mean", "variance"}),
    Case("Categorical", dict(logits=F(np.log([[0.2, 0.3, 0.5], [0.1, 0.1, 0.8], [1 / 3, 1 / 3, 1 / 3]]))),
         lambda r: r.integers(0, 3, (5, 3)), set()),
    Case("Poisson", dict(rate=F([0.5, 3.7, 20.0])), lambda r: r.poisson(4.0, (5, 3)), {"log_prob", "cdf"}),
    Case("Bernoulli", dict(logits=F([-80.0, 0.3, 50.0])), lambda r: r.integers(0, 2, (5, 3)), set()),
    Case("Binomial", dict(total_count=F([5.0, 12.0, 20.0]), logits=F([-1.0, np.log(0.4 / 0.6), 2.0])),
         lambda r: r.integers(0, 6, (5, 3)), {"log_prob"}),
    Case("NegativeBinomial", dict(total_count=F([2.0, 5.0, 10.0]), logits=F([-1.0, np.log(0.35 / 0.65), 1.0])),
         lambda r: r.poisson(4.0, (5, 3)), {"log_prob"}),
    Case("Delta", dict(value=F([1.0, 2.0, 3.0])), lambda r: np.where(r.random((5, 3)) < 0.5, [1.0, 2.0, 3.0], 0.0),
         set()),
]
METHODS = ("log_prob", "cdf", "icdf", "mean", "variance", "stddev", "entropy")


def _pair(case):
    j = getattr(jdist, case.name)(**{k: jnp.asarray(v) for k, v in case.params.items()})
    t = pt.convert.distribution_from_numpy(case.name, device="cpu", **case.params)
    return j, t


def _call(d, method, x):
    """``d.method(x)`` (or the property), or the exception type it raises."""
    try:
        if method in ("log_prob", "cdf", "icdf"):
            return np.asarray(getattr(d, method)(x))
        if method == "entropy":
            return np.asarray(d.entropy())
        return np.asarray(getattr(d, method))
    except NotImplementedError:
        return NotImplementedError


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_family_matches_jax(case, method):
    """``log_prob``, ``cdf`` and ``icdf`` at the same points, ``mean``,
    ``variance``, ``stddev`` and ``entropy``: the same values, or
    ``NotImplementedError`` from both."""
    j, t = _pair(case)
    rng = np.random.default_rng(sum(map(ord, case.name)))
    x = F(case.values(rng)) if method != "icdf" else F(rng.uniform(0.02, 0.98, (5, 3)))
    want = _call(j, method, jnp.asarray(x))
    got = _call(t, method, _t(x))
    if want is NotImplementedError:
        assert got is NotImplementedError, f"{case.name}.{method} exists in the port only"
        return
    assert got is not NotImplementedError, f"{case.name}.{method} is missing from the port"
    assert got.shape == want.shape
    _close(got, want, SPECIAL if method in case.special or (method == "stddev" and "variance" in case.special)
           else CLOSED)


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_base_api_matches_jax(case):
    """``batch_shape``, ``event_shape``, ``shape``, ``has_icdf``, the
    support's type and check, ``prob``, ``rsample``, ``expand``, ``to_event``
    and the parameters ``convert.distribution_from_numpy`` built (a round
    trip of the JAX object's own leaves)."""
    j, t = _pair(case)
    assert tuple(t.batch_shape) == tuple(j.batch_shape)
    assert tuple(t.event_shape) == tuple(j.event_shape)
    assert tuple(t.shape) == tuple(j.shape)
    assert t.has_icdf == j.has_icdf
    assert type(t.support).__name__ == type(j.support).__name__
    x = F(case.values(np.random.default_rng(1)))
    np.testing.assert_array_equal(np.asarray(t.support.check(_t(x))), np.asarray(j.support.check(jnp.asarray(x))))
    _close(t.prob(_t(x)), j.prob(jnp.asarray(x)), SPECIAL if "log_prob" in case.special else CLOSED)
    for name in j.arg_names:
        back = pt.convert.distribution_from_numpy(case.name, device="cpu",
                                                  **{n: np.asarray(getattr(j, n)) for n in j.arg_names})
        np.testing.assert_array_equal(getattr(back, name).numpy(), np.asarray(getattr(j, name)))
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    np.testing.assert_array_equal(t.rsample(g1, (2,)).numpy(), t.sample(g2, (2,)).numpy())
    assert tuple(t.expand((4, 3)).batch_shape) == tuple(j.expand((4, 3)).batch_shape) == (4, 3)
    assert tuple(t.to_event(1).event_shape) == tuple(j.to_event(1).event_shape)


def test_delta_with_event_axes_matches_jax():
    value = F([[1.0, 2.0], [3.0, 4.0]])
    j, t = jdist.Delta(jnp.asarray(value), event_ndim=1), pt.convert.distribution_from_numpy(
        "Delta", device="cpu", value=value, event_ndim=1)
    assert tuple(t.batch_shape) == (2,) and tuple(t.event_shape) == (2,)
    x = F([[1.0, 2.0], [3.0, 5.0]])
    np.testing.assert_array_equal(t.log_prob(_t(x)).numpy(), np.asarray(j.log_prob(jnp.asarray(x))))


def test_categorical_and_binary_from_probs_match_jax():
    """``probs=`` and ``logits=`` construct the same laws; extreme logits
    keep finite log-probabilities (the logit form)."""
    probs = F([0.2, 0.3, 0.5])
    for name, kw in (("Categorical", dict(probs=probs)), ("Bernoulli", dict(probs=F([0.3, 1e-6]))),
                     ("Binomial", dict(total_count=F(12.0), probs=F(0.4))),
                     ("NegativeBinomial", dict(total_count=F(5.0), probs=F(0.35)))):
        j = getattr(jdist, name)(**{k: jnp.asarray(v) for k, v in kw.items()})
        t = pt.convert.distribution_from_numpy(name, device="cpu", **kw)
        _close(t.logits, j.logits)
        _close(t.mean, j.mean)
    t = tdist.Bernoulli(logits=_t([-80.0, 80.0]))
    lp = t.log_prob(_t([0.0, 1.0])).numpy()
    assert np.isfinite(lp).all() and (lp <= 0).all()
    np.testing.assert_allclose(lp, 0.0, atol=1e-6)
    for bad in (dict(), dict(logits=_t([0.0]), probs=_t([0.5]))):
        with pytest.raises(ValueError, match="exactly one"):
            tdist.Categorical(**bad)


def test_entropies_match_jax():
    """``Normal``, ``Independent`` (summed over its reinterpreted axes) and
    ``MultivariateNormal`` entropies; ``has_icdf`` passes through
    ``Independent`` and ``TransformedDistribution``."""
    loc, scale = F([[0.0, 1.0], [2.0, -1.0]]), F([[1.0, 0.5], [2.0, 0.1]])
    jn, tn = jdist.Normal(jnp.asarray(loc), jnp.asarray(scale)), tdist.Normal(_t(loc), _t(scale))
    _close(tn.entropy(), jn.entropy())
    _close(tn.to_event(1).entropy(), jn.to_event(1).entropy())
    assert tn.to_event(1).has_icdf and not tdist.Gamma(_t(2.0), _t(1.0)).to_event(0).has_icdf
    tril = F([[1.5, 0.0], [0.3, 0.7]])
    jm = jdist.MultivariateNormal(jnp.zeros(2), scale_tril=jnp.asarray(tril))
    tm = tdist.MultivariateNormal(torch.zeros(2), scale_tril=_t(tril))
    _close(tm.entropy(), jm.entropy())
    tt = tdist.TransformedDistribution(tdist.Normal(_t(0.0), _t(1.0)), tbij.Exp())
    assert tt.has_icdf == jdist.TransformedDistribution(jdist.Normal(0.0, 1.0), jbij.Exp()).has_icdf is True


# -- sampling moments --------------------------------------------------------------------------------
#: (port law, scipy law) at ``tests/test_distributions.py``'s parameters, and
#: the one-sided and 5-sd truncations
MOMENT_CASES = [
    ("Normal", dict(loc=0.5, scale=2.0), st.norm(0.5, 2.0)),
    ("LogNormal", dict(loc=0.2, scale=0.7), st.lognorm(s=0.7, scale=np.exp(0.2))),
    ("Uniform", dict(low=-1.0, high=3.0), st.uniform(-1.0, 4.0)),
    ("Exponential", dict(rate=1.7), st.expon(scale=1 / 1.7)),
    ("Gamma", dict(concentration=2.5, rate=1.3), st.gamma(2.5, scale=1 / 1.3)),
    ("InverseGamma", dict(concentration=5.0, rate=2.0), st.invgamma(5.0, scale=2.0)),
    ("Beta", dict(concentration1=2.0, concentration0=3.0), st.beta(2.0, 3.0)),
    ("Beta", dict(concentration1=0.3, concentration0=0.4), st.beta(0.3, 0.4)),
    ("StudentT", dict(df=4.0, loc=0.3, scale=1.5), st.t(4.0, loc=0.3, scale=1.5)),
    ("Laplace", dict(loc=0.4, scale=1.3), st.laplace(0.4, 1.3)),
    ("Weibull", dict(scale=2.0, concentration=1.5), st.weibull_min(1.5, scale=2.0)),
    ("HalfNormal", dict(scale=1.4), st.halfnorm(scale=1.4)),
    ("Gumbel", dict(loc=0.3, scale=1.2), st.gumbel_r(0.3, 1.2)),
    ("Logistic", dict(loc=-0.5, scale=0.9), st.logistic(-0.5, 0.9)),
    ("Chi2", dict(df=3.5), st.chi2(3.5)),
    ("TruncatedNormal", dict(loc=0.5, scale=2.0, low=-1.0, high=3.0), st.truncnorm(-0.75, 1.25, loc=0.5, scale=2.0)),
    ("TruncatedNormal", dict(loc=1.0, scale=0.5, low=0.0, high=np.inf), st.truncnorm(-2.0, np.inf, loc=1.0, scale=0.5)),
    ("TruncatedNormal", dict(loc=0.0, scale=1.0, low=5.0, high=np.inf), st.truncnorm(5.0, np.inf)),
    ("TruncatedNormal", dict(loc=2.0, scale=0.5, low=-np.inf, high=-0.5), st.truncnorm(-np.inf, -5.0, loc=2.0,
                                                                                       scale=0.5)),
    ("Poisson", dict(rate=3.7), st.poisson(3.7)),
    ("Bernoulli", dict(probs=0.3), st.bernoulli(0.3)),
    ("Binomial", dict(total_count=12.0, probs=0.4), st.binom(12, 0.4)),
    ("NegativeBinomial", dict(total_count=5.0, probs=0.35), st.nbinom(5, 0.65)),
]


@pytest.mark.parametrize("name,params,ref", MOMENT_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(MOMENT_CASES)])
def test_sampling_moments(name, params, ref):
    """200,000 float32 draws from a CPU generator: the mean within 4 SEM
    (+1e-3) of the law's, the variance within 5% (discrete laws and the
    truncations, whose tails are bounded) or within 4 of its own SEM, every
    draw inside the support; the law's mean and variance from the port's
    formulas match scipy's (float64) except at the 5-sd truncations, where
    the JAX package's float32 formula (``ndtr(b) - ndtr(a)``) cancels."""
    d = pt.convert.distribution_from_numpy(name, device="cpu", **{k: F(v) for k, v in params.items()})
    x = d.sample(torch.Generator().manual_seed(17), (200_000,)).double().numpy()
    assert x.shape == (200_000,) and np.isfinite(x).all()
    assert d.support.check(torch.from_numpy(x).float()).all() or name in ("Bernoulli", "Beta")
    n = len(x)
    assert abs(x.mean() - ref.mean()) < 4 * ref.std() / math.sqrt(n) + 1e-3, (x.mean(), ref.mean())
    if name in ("Poisson", "Bernoulli", "Binomial", "NegativeBinomial", "TruncatedNormal"):
        np.testing.assert_allclose(x.var(), ref.var(), rtol=0.05)
    else:
        dev = (x - x.mean()) ** 2
        assert abs(dev.mean() - ref.var()) < 4 * dev.std() / math.sqrt(n) + 1e-3, (dev.mean(), ref.var())
    if not (name == "TruncatedNormal" and params["scale"] * 4 < abs(params["loc"] - params["low"])
            and np.isfinite(params["low"]) or (name == "TruncatedNormal" and params["high"] == -0.5)):
        _close(d.mean, ref.mean(), SPECIAL)
        _close(d.variance, ref.var(), (1e-4, 1e-4))


@pytest.mark.parametrize("name,scale", [("Cauchy", 0.8), ("HalfCauchy", 0.7)])
def test_heavy_tailed_medians(name, scale):
    """No moments: NaN mean and variance, and the sample median at the
    law's."""
    ref = st.cauchy(-0.2, scale) if name == "Cauchy" else st.halfcauchy(scale=scale)
    params = dict(loc=F(-0.2), scale=F(scale)) if name == "Cauchy" else dict(scale=F(scale))
    d = pt.convert.distribution_from_numpy(name, device="cpu", **params)
    assert torch.isnan(d.mean) and torch.isnan(d.variance)
    x = d.sample(torch.Generator().manual_seed(18), (200_000,)).double().numpy()
    np.testing.assert_allclose(np.median(x), ref.median(), rtol=0.02, atol=0.01)


def test_categorical_frequencies():
    probs = F([0.2, 0.3, 0.5])
    x = tdist.Categorical(probs=_t(probs)).sample(torch.Generator().manual_seed(19), (100_000,))
    assert x.dtype == torch.int32
    np.testing.assert_allclose(np.bincount(x.numpy(), minlength=3) / 100_000, probs, atol=0.01)


# -- bijectors ------------------------------------------------------------------------------------------
BIJECTORS = [
    ("Identity", {}, (-3.0, 3.0)),
    ("Exp", {}, (-3.0, 3.0)),
    ("Log", {}, (0.05, 5.0)),
    ("Softplus", {}, (-5.0, 25.0)),
    ("Sigmoid", {}, (-6.0, 6.0)),
    ("Tanh", {}, (-3.0, 3.0)),
    ("Affine", dict(loc=F(1.5), scale=F(-2.0)), (-2.0, 2.0)),
    ("Power", dict(exponent=F(2.5)), (0.1, 3.0)),
    ("Power", dict(exponent=F(-0.5)), (0.1, 3.0)),
    ("SinhArcsinh", dict(skew=F(0.5), tailweight=F(1.3)), (-3.0, 3.0)),
]


@pytest.mark.parametrize("name,params,span", BIJECTORS, ids=[f"{b[0]}-{i}" for i, b in enumerate(BIJECTORS)])
def test_bijector_matches_jax(name, params, span):
    """forward, inverse, ``log_abs_det_jacobian``, ``inverse_and_ladj`` and
    the inverse bijector ``.inv`` against the JAX package's on the same
    points, and the jacobian against the derivative of ``forward``."""
    j = getattr(jbij, name)(**{k: jnp.asarray(v) for k, v in params.items()})
    t = pt.convert.bijector_from_numpy(name, device="cpu", **params)
    x = F(np.linspace(*span, 29))
    y_j, y_t = j.forward(jnp.asarray(x)), t.forward(_t(x))
    _close(y_t, y_j)
    _close(t.inverse(y_t), j.inverse(y_j))
    _close(t.log_abs_det_jacobian(_t(x), y_t), j.log_abs_det_jacobian(jnp.asarray(x), y_j))
    xi, ladj = t.inverse_and_ladj(y_t)
    jxi, jladj = j.inverse_and_ladj(y_j)
    _close(xi, jxi)
    _close(ladj, jladj)
    _close(t.inv.forward(y_t), j.inv.forward(y_j))
    _close(t.inv.log_abs_det_jacobian(y_t, _t(x)), j.inv.log_abs_det_jacobian(y_j, jnp.asarray(x)))
    xd = torch.from_numpy(x.astype(np.float64) + 0.013)  # off 0, where |x|'s derivative is taken as 0
    deriv = torch.func.vmap(torch.func.grad(lambda v: t.forward(v)))(xd)
    _close(t.log_abs_det_jacobian(xd, t.forward(xd)), torch.log(torch.abs(deriv)), (1e-6, 1e-6))


def test_stable_inverses_match_jax_formulas():
    """``Softplus.inverse`` keeps ``y + log(-expm1(-y))`` (finite at y = 30,
    where ``log(expm1(y))`` is too) and ``Tanh.inverse`` is ``atanh`` with no
    clamp: +-inf at +-1, as in the JAX package."""
    y = F([1e-4, 0.5, 5.0, 30.0, 80.0])
    _close(tbij.Softplus().inverse(_t(y)), jbij.Softplus().inverse(jnp.asarray(y)))
    edge = F([-1.0, -0.999, 0.0, 0.999, 1.0])
    got, want = tbij.Tanh().inverse(_t(edge)).numpy(), np.asarray(jbij.Tanh().inverse(jnp.asarray(edge)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    _close(got[1:-1], want[1:-1])


# -- constraints and biject_to -------------------------------------------------------------------------
def _constraint_pairs():
    return [
        ("real", jcon.real, tcon.real, F([-1.0, 0.0, np.inf, -np.inf, np.nan, 3.0])),
        ("positive", jcon.positive, tcon.positive, F([-1.0, 0.0, 1e-30, 2.0, np.inf, np.nan])),
        ("nonnegative", jcon.nonnegative, tcon.nonnegative, F([-1e-30, 0.0, 2.0, np.nan])),
        ("unit_interval", jcon.unit_interval, tcon.unit_interval, F([-0.1, 0.0, 0.5, 1.0, 1.1])),
        ("Interval", jcon.Interval(-1.0, 2.0), tcon.Interval(-1.0, 2.0), F([-1.0, -0.99, 1.99, 2.0, 5.0])),
        ("GreaterThan", jcon.GreaterThan(2.0), tcon.GreaterThan(2.0), F([1.0, 2.0, 2.0001, np.inf])),
        ("real_vector", jcon.real_vector, tcon.real_vector, F([[0.0, 1.0], [np.nan, 1.0], [np.inf, 0.0]])),
        ("simplex", jcon.simplex, tcon.simplex,
         F([[0.2, 0.8], [0.5, 0.5000005], [0.5, 0.500002], [-0.1, 1.1], [1.0, 0.0]])),
        ("lower_cholesky", jcon.lower_cholesky, tcon.lower_cholesky,
         F([[[1.0, 0.0], [0.5, 2.0]], [[1.0, 0.1], [0.5, 2.0]], [[0.0, 0.0], [0.5, 2.0]], [[1.0, 0.0], [-3.0, 1e-3]]])),
    ]


@pytest.mark.parametrize("name,jc,tc,x", _constraint_pairs(), ids=[c[0] for c in _constraint_pairs()])
def test_constraint_check_matches_jax(name, jc, tc, x):
    """``check`` of every constraint: the same booleans (``simplex`` with the
    JAX package's 1e-6 tolerance on the sum), and the same ``event_dim``."""
    got, want = tc.check(_t(x)).numpy(), np.asarray(jc.check(jnp.asarray(x)))
    assert got.dtype == bool and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert tc.event_dim == jc.event_dim


@pytest.mark.parametrize("name,jc,tc,x", _constraint_pairs(), ids=[c[0] for c in _constraint_pairs()])
def test_biject_to_matches_jax(name, jc, tc, x):
    """The bijector each constraint maps to: the same structure and the same
    forward values and jacobians; none for ``simplex`` or ``lower_cholesky``
    in either package."""
    try:
        jb = jdist.biject_to(jc)
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            tdist.biject_to(tc)
        return
    tb = tdist.biject_to(tc)
    parts = lambda b: [type(p).__name__ for p in getattr(b, "parts", (b,))]  # noqa: E731
    assert parts(tb) == parts(jb)
    u = F(np.linspace(-4.0, 4.0, 17))
    _close(tb.forward(_t(u)), jb.forward(jnp.asarray(u)))
    _close(tb.log_abs_det_jacobian(_t(u), tb.forward(_t(u))), jb.log_abs_det_jacobian(jnp.asarray(u), jb.forward(
        jnp.asarray(u))))
    if tc.event_dim == 0:
        assert tc.check(tb.forward(_t(u))).all()


# -- the gap methods ---------------------------------------------------------------------------------
def test_eps_for_matches_jax():
    for dtype in (np.float32, np.float64, np.float16):
        assert tconstants.eps_for(dtype) == jconstants.eps_for(dtype)
        assert tconstants.eps2_for(dtype) == jconstants.eps2_for(dtype)
    assert tconstants.eps_for(torch.float32) == jconstants.eps_for(np.float32) == tconstants.EPS
    assert tconstants.eps2_for(torch.float64) == jconstants.eps2_for(np.float64)


def test_process_sample_states_and_shapes_match_jax(monkeypatch):
    """A process's ``sample_states`` on the same noise (the JAX scan run
    eagerly on a host tape), ``n_dim`` and ``expand_initial``."""
    rng = np.random.default_rng(20)
    tape = []

    def jax_normal(key, shape=(), dtype=jnp.float32):
        tape.append(rng.standard_normal(tuple(shape)).astype(np.float32))
        return jnp.asarray(tape[-1], dtype)

    jproc = jts.models.AR(0.1, 0.8, 0.4)
    tproc = tmodels.AR(0.1, 0.8, 0.4, device="cpu")
    assert tproc.n_dim == jproc.n_dim == 0
    assert tmodels.LocalLinearTrend(0.1, 0.2, device="cpu").n_dim == jts.models.LocalLinearTrend(0.1, 0.2).n_dim == 1
    init = tproc.expand_initial(torch.Generator(), (7,))
    assert tuple(init.value.shape) == tuple(jproc.expand_initial(jax.random.PRNGKey(1), (7,)).value.shape) == (7,)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal", jax_normal)
        with jax.disable_jit():
            jpath = jproc.sample_states(jax.random.PRNGKey(0), 12)
    draws = iter(tape)
    monkeypatch.setattr(tdist.Normal, "sample", lambda self, generator, sample_shape=(): self.loc + self.scale * _t(
        next(draws)).reshape(tuple(sample_shape) + tuple(self.batch_shape)))
    tpath = tproc.sample_states(torch.Generator(), 12)
    assert next(draws, None) is None and tpath.y is None and jpath.y is None
    _close(tpath.x, jpath.x)
    _close(tpath.time_indexes, jpath.time_indexes)


def test_copy_with_and_model_n_dim_match_jax():
    """``AffineProcess.copy_with`` swaps the parameter tensors (the transition
    density follows them); ``StateSpaceModel.n_dim`` is the observation's
    event rank."""
    jproc, tproc = jts.models.AR(0.0, 0.5, 0.3), tmodels.AR(0.0, 0.5, 0.3, device="cpu")
    new = (F(0.2), F(0.9), F(0.7))
    jn, tn = jproc.copy_with(tuple(jnp.asarray(p) for p in new)), tproc.copy_with(tuple(_t(p) for p in new))
    assert type(tn) is type(tproc) and tproc.parameters[1].item() == 0.5
    x = F(np.linspace(-1.0, 1.0, 5))
    jd = jn.build_density(jts.TimeseriesState(jnp.asarray(0.0), jnp.asarray(x)))
    td = tn.build_density(pt.timeseries.TimeseriesState(0.0, _t(x)))
    _close(td.log_prob(_t(x)), jd.log_prob(jnp.asarray(x)))
    jssm = jts.LinearStateSpaceModel(jproc, (1.0, 0.2))
    tssm = pt.timeseries.LinearStateSpaceModel(tproc, (1.0, 0.2))
    assert tssm.n_dim == jssm.n_dim == 0
    rw = pt.convert.rw2d_from_numpy(np.eye(2, dtype=np.float32), F([0.1, 0.2]), F([0.3, 0.3]), device="cpu")
    assert rw.n_dim == 1


def test_proposal_copy_and_correction_timeseries_state():
    """``Proposal.copy`` is the proposal itself (proposals hold no state), and
    a correction's ``timeseries_state`` is its particle state, in both
    packages."""
    from pyfilter_tpu.filters.particle import proposals as jprop
    from pyfilter_tpu_torch.filters.particle import proposals as tprop

    for j, t in ((jprop.Bootstrap(), tprop.Bootstrap()),
                 (jprop.LinearGaussianObservations(), tprop.LinearGaussianObservations())):
        assert j.copy() is j and t.copy() is t
    ssm = pt.timeseries.LinearStateSpaceModel(tmodels.AR(0.0, 0.5, 0.3, device="cpu"), (1.0, 0.2))
    state = pt.SISR(ssm, 16, device="cpu").initialize(torch.Generator().manual_seed(0))
    assert state.timeseries_state is state.x is state.get_timeseries_state()


def _zoo_contexts(k=6):
    from test_torch_port_tempered import j_build, t_build

    jctx = jinf.make_context(key=jax.random.PRNGKey(21))
    jctx.set_batch_shape((k,))
    j_build(jctx)
    tctx = tinf.make_context(device="cpu")
    tctx.set_batch_shape((k,))
    t_build(tctx)
    pt.convert.set_context_values(tctx, {n: np.asarray(v) for n, v in jctx.parameters.items()})
    return jctx, tctx


def test_prior_bound_parameter_matches_jax():
    """``get_constrained`` is the value; ``inverse_sample`` inverts the
    constrained or the unconstrained prior at the same uniforms and returns
    the constrained value."""
    jctx, tctx = _zoo_contexts()
    q = F(np.linspace(0.05, 0.95, 6))
    for name in ("beta", "sigma"):
        jp, tp = jctx.bound_parameter(name), tctx.bound_parameter(name)
        _close(tp.get_constrained(), jp.get_constrained())
        for constrained in (True, False):
            _close(tp.inverse_sample(_t(q), constrained=constrained),
                   jp.inverse_sample(jnp.asarray(q), constrained=constrained), SPECIAL)


def test_plot_chains_matches_jax():
    """``plot.plot_chains`` of one chain set: the same axes, titles and
    lines (burn-in dropped) as the JAX package's."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from pyfilter_tpu.inference import plot as jplot

    rng = np.random.default_rng(22)
    chains = {"beta": rng.normal(size=(9, 4)).astype(np.float32), "sigma": rng.normal(size=(9, 4, 2)).astype(np.float32)}
    result = type("Chains", (), {"as_arrays": lambda self: chains})()
    jfig, jaxes = jplot.plot_chains(result, num_cols=3, burn_in=2)
    tfig, taxes = tinf.plot.plot_chains(result, num_cols=3, burn_in=2)
    assert len(taxes) == len(jaxes) == 3
    for ta, ja in zip(taxes, jaxes):
        assert ta.get_title() == ja.get_title() and ta.axison == ja.axison
        assert len(ta.get_lines()) == len(ja.get_lines())
        for tl, jl in zip(ta.get_lines(), ja.get_lines()):
            np.testing.assert_array_equal(tl.get_ydata(), jl.get_ydata())
    plt.close(jfig)
    plt.close(tfig)


def test_smc2_state_parsed_data_array_matches_jax():
    from pyfilter_tpu.inference.state import SMC2State as JSMC2State

    rows = [F([0.1, 0.2]), F([0.3, -0.4]), F([np.nan, 1.0])]
    j, t = JSMC2State(jnp.zeros(3), None, rows), tinf.SMC2State(torch.zeros(3), None, rows)
    got = t.parsed_data_array
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j.parsed_data_array))


def test_convert_round_trips_and_refuses():
    """``distribution_from_numpy`` and ``bijector_from_numpy`` accept only
    known names and numeric parameters."""
    with pytest.raises(ValueError, match="no distribution"):
        pt.convert.distribution_from_numpy("Wishart", device="cpu", df=F(3.0))
    with pytest.raises(ValueError, match="no bijector"):
        pt.convert.bijector_from_numpy("Chain", device="cpu")
    with pytest.raises(TypeError):
        pt.convert.distribution_from_numpy("Normal", device="cpu", loc=torch.zeros(1), scale=F(1.0))
    d = pt.convert.distribution_from_numpy("Normal", device="cpu", loc=F([0.0, 1.0]), scale=1.5)
    assert d.loc.dtype == d.scale.dtype == torch.float32 and tuple(d.batch_shape) == (2,)
    assert pf.distributions.Normal.has_icdf and d.has_icdf


def test_normal_cdfs_keep_the_lower_tail():
    """The normal cdfs at 5 and 7 sds below the mean match the JAX package's
    relative precision (torch's float32 ``ndtr`` alone reads 4% high at -5
    and 0 at -7; the port takes it in float64)."""
    x = F([-7.0, -5.0, -3.0, 0.0, 3.0])
    for name, params, value in (("Normal", dict(loc=F(0.0), scale=F(1.0)), x),
                                ("LogNormal", dict(loc=F(0.0), scale=F(1.0)), np.exp(x).astype(F)),
                                ("TruncatedNormal", dict(loc=F(0.0), scale=F(1.0), low=F(-8.0), high=F(8.0)), x)):
        j = getattr(jdist, name)(**{k: jnp.asarray(v) for k, v in params.items()})
        t = pt.convert.distribution_from_numpy(name, device="cpu", **params)
        _close(t.cdf(_t(value)), j.cdf(jnp.asarray(value)), (1e-4, 0.0))
