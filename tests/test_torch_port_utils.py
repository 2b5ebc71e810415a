"""The PyTorch port (``pyfilter_tpu_torch``) held against the JAX package:
weight numerics, distributions, bijectors, the Verhulst sub-step block, the
numpy carry-over, and the port's device rule.

Inputs are made with numpy from fixed seeds and handed to both packages;
the port runs on the CPU (``device="cpu"``). Tolerance: 1e-6 absolute or
1e-5 relative (the BASELINE.md numerics gate) — both sides compute in
float32, and the two frameworks' exp/log/sum round differently in the last
bits.
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
from pyfilter_tpu import examples as jexamples
from pyfilter_tpu import utils as jutils
from pyfilter_tpu.timeseries import TimeseriesState as JState
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import utils as tutils
from pyfilter_tpu_torch.timeseries import TimeseriesState as TState

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL, RTOL = 1e-6, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _close(ours, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def _adversarial_lw(shape, seed):
    lw = np.random.default_rng(seed).normal(0.0, 3.0, shape).astype(np.float32)
    flat = lw.reshape(lw.shape[0], -1)
    flat[3, 0] = np.nan
    flat[5, 0] = np.inf
    if flat.shape[1] > 1:
        flat[:, 1] = -np.inf  # a dead lane: uniform backfill
    return lw


@pytest.mark.parametrize("shape", [(64,), (64, 7), (64, 3, 2)])
def test_normalize_matches_jax(shape):
    lw = _adversarial_lw(shape, 0)
    _close(tutils.normalize(_t(lw)), jutils.normalize(jnp.asarray(lw)))
    _close(tutils.normalize_log(_t(lw)), jutils.normalize_log(jnp.asarray(lw)), atol=1e-5)


@pytest.mark.parametrize("shape", [(64,), (64, 7)])
def test_ess_matches_jax(shape):
    lw = _adversarial_lw(shape, 1)
    _close(tutils.get_ess(_t(lw)), jutils.get_ess(jnp.asarray(lw)), atol=0.0)


@pytest.mark.parametrize("with_weights", [False, True])
def test_log_likelihood_matches_jax(with_weights):
    rng = np.random.default_rng(2)
    iw = rng.normal(-1.0, 2.0, (128, 5)).astype(np.float32)
    w = None
    if with_weights:
        w = rng.uniform(0.1, 1.0, (128, 5)).astype(np.float32)
        w /= w.sum(0)
    ours = tutils.log_likelihood(_t(iw), None if w is None else _t(w))
    ref = jutils.log_likelihood(jnp.asarray(iw), None if w is None else jnp.asarray(w))
    _close(ours, ref)


@pytest.mark.parametrize("event_ndim,covariance", [(0, False), (1, False), (1, True)])
def test_moments_and_gather_match_jax(event_ndim, covariance):
    rng = np.random.default_rng(3)
    shape = (256, 4) + ((3,) if event_ndim else ())
    x = rng.normal(0.0, 1.0, shape).astype(np.float32)
    probs = np.asarray(jutils.normalize(jnp.asarray(rng.normal(size=(256, 4)).astype(np.float32))))
    om, ov = tutils.get_mean_and_variance(_t(x), _t(probs), event_ndim, covariance)
    jm, jv = jutils.get_mean_and_variance(jnp.asarray(x), jnp.asarray(probs), event_ndim, covariance)
    _close(om, jm)
    _close(ov, jv)

    idx = rng.integers(0, 256, (256, 4)).astype(np.int32)
    got = tutils.batched_gather(_t(x), torch.from_numpy(idx), event_ndim)
    want = jutils.batched_gather(jnp.asarray(x), jnp.asarray(idx), event_ndim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("skew,tail", [(0.0, 1.0), (0.3, 0.7), (-0.5, 1.6)])
def test_sinh_arcsinh_inverse_and_ladj_matches_jax(skew, tail):
    y = np.random.default_rng(4).normal(0.0, 3.0, 512).astype(np.float32)
    ours = tdist.SinhArcsinh(_t(skew), _t(tail)).inverse_and_ladj(_t(y))
    ref = jdist.SinhArcsinh(skew, tail).inverse_and_ladj(jnp.asarray(y))
    for a, b in zip(ours, ref):
        _close(a, b)
    # the unfused path (default inverse + jacobian) agrees with the fused one
    b = tdist.SinhArcsinh(_t(skew), _t(tail))
    x = b.inverse(_t(y))
    _close(b.log_abs_det_jacobian(x, _t(y)), ours[1].numpy(), atol=1e-5)


def test_sv_observation_log_prob_matches_jax():
    """The stochastic-volatility observation density: Normal base through
    ``Chain([SinhArcsinh, Affine])`` with the volatility as scale."""
    rng = np.random.default_rng(5)
    vol = rng.uniform(0.5, 1.5, 1024).astype(np.float32)
    mu, nu, tau = 0.1, 0.2, 1.2
    for y in (0.0, -1.3, 2.7):
        ours = pt.examples.sv_observation(TState(0.0, _t(vol)), _t(mu), _t(nu), _t(tau)).log_prob(_t(y))
        ref = jexamples.sv_observation(JState(0.0, jnp.asarray(vol)), mu, nu, tau).log_prob(jnp.asarray(y, jnp.float32))
        _close(ours, ref)


def test_normal_log_prob_and_sample_shape():
    x = np.random.default_rng(6).normal(size=64).astype(np.float32)
    _close(tdist.Normal(_t(0.3), _t(1.7)).log_prob(_t(x)), jdist.Normal(0.3, 1.7).log_prob(jnp.asarray(x)))
    g = torch.Generator().manual_seed(0)
    s = tdist.Normal(torch.zeros(3), torch.ones(3)).sample(g, (5,))
    assert s.shape == (5, 3) and s.dtype == torch.float32


class _ReplayNormalT(tdist.Normal):
    """A Normal whose draws replay injected standard-normal numbers."""

    def __init__(self, loc, scale, z):
        super().__init__(loc, scale)
        self.z = z

    def sample(self, generator, sample_shape=()):
        assert tuple(sample_shape) + self.batch_shape == self.z.shape
        return self.loc + self.scale * _t(self.z)


class _ReplayNormalJ(jdist.Normal):
    def __init__(self, loc, scale, z):
        super().__init__(loc, scale)
        self.z = z

    def sample(self, key, sample_shape=()):
        assert tuple(sample_shape) + tuple(self.batch_shape) == self.z.shape
        return self.loc + self.scale * jnp.asarray(self.z)


@pytest.mark.parametrize("n_sub", [1, 4])
def test_verhulst_substeps_match_jax_given_eps(n_sub):
    """``propagate_substeps``: one batched draw of (n, N) increments, then
    ``loc + scale * eps[i]`` per sub-step — both packages' own code, fed the
    same increments through a replaying increment distribution."""
    rng = np.random.default_rng(7)
    n = 1000
    x0 = rng.uniform(0.6, 1.4, n).astype(np.float32)
    z = rng.normal(size=(n_sub, n)).astype(np.float32)
    kappa, gamma, sigma, dt = 0.3, 1.0, 0.2, 0.2

    jm = jexamples.stochastic_volatility_model(kappa, gamma, sigma, dt=dt).hidden
    jm.increment_distribution = _ReplayNormalJ(jm.increment_distribution.loc, jm.increment_distribution.scale, z)
    tm = pt.timeseries.models.Verhulst(kappa, gamma, sigma, dt, device="cpu")
    tm.increment_distribution = _ReplayNormalT(tm.increment_distribution.loc, tm.increment_distribution.scale, z)

    xj = jm.propagate_substeps(jax.random.PRNGKey(0), JState(jnp.asarray(0.0), jnp.asarray(x0)), n_sub)
    xt = tm.propagate_substeps(torch.Generator(), TState(0.0, _t(x0)), n_sub)
    _close(xt.value, xj.value)
    assert xt.time_index == float(xj.time_index) == float(n_sub)

    # the transition density each sub-step draws from (bootstrap propagate)
    dj = jm.build_density(JState(0.0, jnp.asarray(x0)))
    dt_ = tm.build_density(TState(0.0, _t(x0)))
    _close(dt_.loc, dj.loc)
    _close(dt_.scale, dj.scale)


def test_convert_carries_state_and_model():
    """The numpy carry-over builds the port's objects from the JAX ones' leaves."""
    jmodel = jexamples.stochastic_volatility_model(0.2, 1.1, 0.1, 0.05, 0.1, 1.3, dt=0.5)
    params = (*jmodel.hidden.parameters, *jmodel.parameters)
    tmodel = pt.convert.sv_model_from_numpy(*map(np.float32, params), dt=np.float64(jmodel.hidden.dt), device="cpu")
    assert tmodel.observe_every_step == jmodel.observe_every_step == 2
    for a, b in zip((*tmodel.hidden.parameters, *tmodel.parameters), params):
        assert float(a) == float(np.float32(b))

    jfilt = pf.SISR(jmodel, 64)
    c = jfilt.initialize(jax.random.PRNGKey(1))
    tc = pt.convert.correction_from_numpy(
        np.asarray(c.x.time_index), np.asarray(c.x.value), np.asarray(c.log_weights),
        np.asarray(c.log_likelihood), np.asarray(c.prev_indices),
        np.asarray(c.mean), np.asarray(c.variance), device="cpu",
    )
    np.testing.assert_array_equal(tc.x.value.numpy(), np.asarray(c.x.value))
    assert tc.prev_indices.dtype == torch.int32 and tc.x.time_index == 0.0
    with pytest.raises(TypeError):
        pt.convert.correction_from_numpy(0.0, c.x.value, c.log_weights, c.log_likelihood, c.prev_indices, device="cpu")


def test_entry_points_default_to_the_card():
    """Without ``device="cpu"`` every entry point asks for the card, and
    raises when there is none — never a quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.examples.stochastic_volatility_model()
    model = pt.examples.stochastic_volatility_model(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.SISR(model, 128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tutils.resolve_device(None)
    assert tutils.resolve_device("cpu") == torch.device("cpu")
    cloud = pt.SISR(model, 128, device="cpu").initialize(torch.Generator().manual_seed(0))
    assert math.isfinite(float(cloud.x.value.sum()))
