"""The port's gradients through the filter, held against the JAX package:
the Gamma and InverseGamma distributions, the Ornstein-Uhlenbeck process and
the nutria model (the models this slice's inference paths run), the
Ścibior–Wood ancestor correction, the backward of both resample-and-gather
kernels (their plain versions, which the CPU runs), and the differentiable
SISR and APF.

Replays: ``Normal.sample`` of both packages draws ``loc + scale * z`` with the
same ``z`` for the k-th call of each package (``_Tape``), and each resample's
uniform is the same in both (the port's ``resample_uniform``, the JAX filter's
replay resampler ``systematic_counts(None, w, u=...)``); the JAX side runs
eagerly under ``jax.disable_jit()``, its gradient by ``jax.grad``.

Tolerances: densities, moments and the ancestor correction's gradient rel
1e-6 (one float32 expression each side); sampled paths rel 1e-5 (the
BASELINE.md gate); the backward plain versions rel 1e-6 against ``jax.vjp``
of the JAX package's ``batched_gather`` (both sum each source's copies in
float32, in output order); the whole differentiable filters' log-likelihood
and gradient in beta rel 1e-4 (float32 sums over 12 steps in two
frameworks; the measured gaps are in CHANGES.md).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import examples as jexamples
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.ops import systematic_counts as j_counts
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu.utils import batched_gather as j_gather
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import timeseries as tts
from pyfilter_tpu_torch.ops import expand as texpand

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ALPHA, BETA, SIGMA, OBS_COEF, OBS_STD = 0.0, 0.8, 0.5, 1.0, 0.3
N, T, BETA0 = 64, 12, 0.6


def _close(a, b, rtol, atol=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    excess = np.abs(a - b) - (atol + rtol * np.abs(b))
    assert np.all(excess <= 0), f"worst excess over the tolerance {excess.max()}, max |a - b| {np.abs(a - b).max()}"


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


class _Tape:
    """Standard normals for ``Normal.sample`` of both packages: the k-th call
    of each package gets the same draw, of the shape that call asks for."""

    def __init__(self, seed: int):
        self.seed, self.calls = seed, {"jax": 0, "port": 0}

    def z(self, side, shape):
        k = self.calls[side]
        self.calls[side] += 1
        return np.random.default_rng((self.seed, k)).normal(size=shape).astype(np.float32)

    def patch(self, monkeypatch):
        tape = self

        def j_sample(self, key, sample_shape=()):
            shape = tuple(sample_shape) + tuple(jnp.broadcast_shapes(jnp.shape(self.loc), jnp.shape(self.scale)))
            return self.loc + self.scale * jnp.asarray(tape.z("jax", shape))

        def t_sample(self, generator, sample_shape=()):
            return self.loc + self.scale * torch.from_numpy(tape.z("port", tuple(sample_shape) + self.batch_shape))

        monkeypatch.setattr(jdist.Normal, "sample", j_sample)
        monkeypatch.setattr(tdist.Normal, "sample", t_sample)


# -- distributions -------------------------------------------------------------------
_GAMMA_ARGS = [(50.0, 9.8), (2.5, 1.3), (0.7, 2.0)]


@pytest.mark.parametrize("name", ["Gamma", "InverseGamma"])
@pytest.mark.parametrize("a,b", _GAMMA_ARGS)
def test_gamma_family_matches_jax(name, a, b):
    """log_prob, cdf, mean and variance on the same inputs, the positive
    support's bijector, and the sampler's mean against the JAX package's."""
    jd, td = getattr(jdist, name)(a, b), getattr(tdist, name)(torch.tensor(a), torch.tensor(b))
    x = np.random.default_rng(3).uniform(0.05, 4.0, size=64).astype(np.float64)
    # the log-density is a sum of terms that cancel (at a = 50 each is about
    # 150 and the sum about 10): rel 1e-6 of the terms' scale
    terms = abs(a * math.log(b)) + (a + 1) * np.abs(np.log(x)) + b * np.maximum(x, 1 / x) + math.lgamma(a)
    x = x.astype(np.float32)
    _close(td.log_prob(_t(x)), jd.log_prob(jnp.asarray(x)), rtol=1e-6, atol=1e-6 * terms)
    # the cdf through each framework's float32 regularised incomplete gamma:
    # at a = 50 the JAX package's lies 2.9e-6 from scipy's float64 value (the
    # port's 2.6e-8), so the two are held within 5e-6
    _close(td.cdf(_t(x)), jd.cdf(jnp.asarray(x)), rtol=0.0, atol=5e-6)
    for moment in ("mean", "variance"):
        jm, tm = np.asarray(getattr(jd, moment)), getattr(td, moment).numpy()
        assert np.isnan(jm).tolist() == np.isnan(tm).tolist()
        _close(tm[~np.isnan(tm)], jm[~np.isnan(jm)], rtol=1e-6)
    assert isinstance(tdist.biject_to(td.support), tdist.Exp)
    draws = td.sample(torch.Generator().manual_seed(0), (20000,))
    assert draws.shape == (20000,) and bool((draws > 0).all())
    jdraws = np.asarray(jd.sample(jax.random.PRNGKey(0), (20000,)))
    # the two samplers' means within 4 standard errors of each other
    se = math.sqrt(float(draws.var()) / 20000 + float(jdraws.var()) / 20000)
    assert abs(float(draws.mean()) - float(jdraws.mean())) < 4 * se


# -- models ---------------------------------------------------------------------------
def _j_ou():
    return jts.LinearStateSpaceModel(jmodels.OrnsteinUhlenbeck(0.5, 1.0, 0.1), (1.0, 0.05))


def _t_ou():
    return tts.LinearStateSpaceModel(tts.models.OrnsteinUhlenbeck(0.5, 1.0, 0.1, device="cpu"), (1.0, 0.05))


_NUTRIA = dict(a=0.1, b=-0.05, c=0.0, sigma_e=0.3, sigma_n=0.2)


@pytest.mark.parametrize("name", ["ou", "nutria"])
def test_models_match_jax(name, monkeypatch):
    """Transition, initial and observation densities on the same inputs
    (rel 1e-6), and ``sample_states`` with the same normals (rel 1e-5)."""
    if name == "ou":
        jmodel, tmodel = _j_ou(), _t_ou()
    else:
        jmodel, tmodel = jexamples.nutria_model(**_NUTRIA), pt.examples.nutria_model(**_NUTRIA, device="cpu")
    rng = np.random.default_rng(7)
    x, x_next = (rng.normal(0.5, 0.6, size=32).astype(np.float32) for _ in range(2))
    jx, tx = jts.TimeseriesState(jnp.asarray(3.0), jnp.asarray(x)), tts.TimeseriesState(3.0, _t(x))
    _close(tmodel.hidden.build_density(tx).log_prob(_t(x_next)),
           jmodel.hidden.build_density(jx).log_prob(jnp.asarray(x_next)), rtol=1e-6, atol=1e-6)
    _close(tmodel.hidden.initial_distribution().log_prob(_t(x)),
           jmodel.hidden.initial_distribution().log_prob(jnp.asarray(x)), rtol=1e-6, atol=1e-6)
    _close(tmodel.build_density(tx).log_prob(_t(x_next)),
           jmodel.build_density(jx).log_prob(jnp.asarray(x_next)), rtol=1e-6, atol=1e-6)

    _Tape(seed=1).patch(monkeypatch)
    with jax.disable_jit():
        jx_path, jy_path = jmodel.sample_states(jax.random.PRNGKey(0), 40).get_paths()
    tx_path, ty_path = tmodel.sample_states(None, 40).get_paths()
    _close(tx_path, jx_path, rtol=1e-5, atol=1e-6)
    _close(ty_path, jy_path, rtol=1e-5, atol=1e-6)


def test_nutria_builder_matches_jax():
    """The builder's priors (two InverseGamma variances) and model on the same
    parameter values: the priors with their Jacobians on the unconstrained
    space, and the densities of the built model."""
    from pyfilter_tpu import inference as jinf

    jctx = jinf.make_context(key=jax.random.PRNGKey(0))
    jctx.set_batch_shape((5,))
    jexamples.nutria_builder(jctx, num_obs=50)
    tctx = pt.inference.make_context(device="cpu")
    tctx.set_batch_shape((5,))
    pt.examples.nutria_builder(tctx, num_obs=50)
    pt.convert.set_context_values(tctx, {k: np.asarray(v) for k, v in jctx.parameters.items()})
    # the InverseGamma log-densities sum terms of about 40-55 that cancel:
    # rel 1e-6 of the terms' scale, as for the distributions above
    alpha = 25.0
    beta = 2.0 * (alpha - 1.0) / 10.0
    terms = sum(abs(alpha * math.log(beta)) + (alpha + 1) * np.abs(np.log(np.asarray(jctx.parameters[k], np.float64)))
                + beta / np.asarray(jctx.parameters[k], np.float64) + math.lgamma(alpha) for k in ("sigma_e", "sigma_n"))
    _close(tctx.eval_priors(constrained=False), jctx.eval_priors(constrained=False), rtol=1e-6, atol=1e-6 * terms)
    _close(tctx.stack_parameters(constrained=False), jctx.stack_parameters(constrained=False), rtol=1e-6, atol=1e-7)

    jm, tm = jexamples.nutria_builder(jctx, num_obs=50), pt.examples.nutria_builder(tctx, num_obs=50)
    x = np.random.default_rng(2).normal(0.5, 0.5, size=(16, 5)).astype(np.float32)
    jx, tx = jts.TimeseriesState(jnp.asarray(1.0), jnp.asarray(x)), tts.TimeseriesState(1.0, _t(x))
    _close(tm.hidden.build_density(tx).log_prob(_t(x + 0.1)),
           jm.hidden.build_density(jx).log_prob(jnp.asarray(x + 0.1)), rtol=1e-6, atol=1e-5)
    _close(tm.build_density(tx).log_prob(_t(x - 0.1)), jm.build_density(jx).log_prob(jnp.asarray(x - 0.1)),
           rtol=1e-6, atol=1e-5)


# -- the ancestor correction -----------------------------------------------------------------
@pytest.mark.parametrize("lanes", [(), (3,)])
def test_ancestor_correction_matches_jax(lanes):
    """Exactly 0 in value; its vector-Jacobian product in the log-weights (a
    -inf among them) equals ``jax.vjp`` of the JAX package's on the same
    weights and indices."""
    rng = np.random.default_rng(4)
    lw = rng.normal(size=(N, *lanes)).astype(np.float32)
    lw.reshape(N, -1)[5] = -np.inf
    idx = np.sort(rng.integers(0, N, size=(N, *lanes)), axis=0).astype(np.int32)
    idx.reshape(N, -1)[0] = 5  # one slot takes the zero-mass ancestor
    cot = rng.normal(size=(N, *lanes)).astype(np.float32)

    jfilt = pf.SISR(jts.LinearStateSpaceModel(jmodels.AR(ALPHA, BETA, SIGMA), (1.0, OBS_STD)), N)
    jval, jvjp = jax.vjp(lambda w: jfilt._ancestor_correction(w, jnp.asarray(idx)), jnp.asarray(lw))
    tfilt = pt.SISR(tts.LinearStateSpaceModel(tts.models.AR(ALPHA, BETA, SIGMA, device="cpu"), (1.0, OBS_STD)), N,
                    device="cpu")
    tw = _t(lw).requires_grad_(True)
    tval = tfilt._ancestor_correction(tw, torch.from_numpy(idx))
    assert bool((tval == 0).all()) and bool((np.asarray(jval) == 0).all())
    (tval * _t(cot)).sum().backward()
    _close(tw.grad, jvjp(jnp.asarray(cot))[0], rtol=1e-6, atol=1e-7)


# -- the backward plain versions ----------------------------------------------------------------
def _weights(n, lanes, name, rng):
    lw = rng.normal(0.0, 2.0, size=(n, *lanes)).astype(np.float32)
    flat = lw.reshape(n, -1)
    if name == "degenerate":  # one source takes every copy: one run of length n
        flat[:] = -np.inf
        flat[n // 2] = 0.0
    elif name == "zero-runs":  # two of every three sources get no copy
        flat[np.arange(n) % 3 != 0] = -np.inf
    return lw


@pytest.mark.parametrize("name", ["random", "degenerate", "zero-runs", *chip_smoke.BACKWARD_INDEX_NAMES])
@pytest.mark.parametrize("n,d", [(7, 1), (7, 2), (1000, 1), (1000, 2)])
def test_expand_backward_plain_matches_jax_vjp(n, d, name):
    """``fused_expand``'s gradient in its values (the backward's plain
    version) equals ``jax.vjp`` of ``batched_gather`` on the same indices:
    the forward's, or indices built directly (``chip_smoke.backward_indices``,
    the kinds the card's kernel is held to at its tile edges, with a tile of
    n / 8 here) fed to ``fused_expand_backward``."""
    rng = np.random.default_rng(n + d)
    if name in chip_smoke.BACKWARD_INDEX_NAMES:
        idx = chip_smoke.backward_indices(n, name, max(2, n // 8))
        g = rng.normal(size=(d, n)).astype(np.float32)
        _, vjp = jax.vjp(lambda v: j_gather(v, jnp.asarray(idx), 1), jnp.zeros((n, d), jnp.float32))
        grad = texpand.fused_expand_backward(_t(g), torch.from_numpy(idx))
        _close(grad, np.asarray(vjp(jnp.asarray(g.T))[0]).T, rtol=1e-6, atol=1e-6)
        return
    probs = torch.softmax(_t(_weights(n, (), name, rng)), dim=0)
    v2d = _t(rng.normal(size=(d, n))).requires_grad_(True)
    out, idx = texpand.fused_expand(probs, torch.tensor(0.37), v2d)
    g = rng.normal(size=(d, n)).astype(np.float32)
    (out * _t(g)).sum().backward()
    _, vjp = jax.vjp(lambda v: j_gather(v, jnp.asarray(idx.numpy()), 1), jnp.asarray(v2d.detach().numpy().T))
    _close(v2d.grad, np.asarray(vjp(jnp.asarray(g.T))[0]).T, rtol=1e-6, atol=1e-6)
    if name == "degenerate":
        assert int(torch.count_nonzero(v2d.grad[0])) == 1


@pytest.mark.parametrize("name", ["random", "degenerate", "zero-runs", "synthetic", "synthetic-shifted"])
@pytest.mark.parametrize("n,lanes,d", [(300, 4, 1), (300, 4, 3), (512, 64, 1), (512, 64, 3)])
def test_expand_lanes_backward_plain_matches_jax_vjp(n, lanes, d, name):
    """``fused_expand_lanes``'s gradient in its value planes equals
    ``jax.vjp`` of ``batched_gather`` on the same per-lane indices; lane 0
    of the "random" case is degenerate as well. The "synthetic" cases feed
    ``fused_expand_lanes_backward`` columns built directly
    (``chip_smoke.backward_lane_indices``, rotated by 5 kinds when
    "shifted")."""
    rng = np.random.default_rng(n + lanes + d)
    if name.startswith("synthetic"):
        idx = chip_smoke.backward_lane_indices(n, lanes, 5 if name.endswith("shifted") else 0)
        g = rng.normal(size=(d, n, lanes)).astype(np.float32)
        _, vjp = jax.vjp(lambda v: j_gather(v, jnp.asarray(idx), 1), jnp.zeros((n, lanes, d), jnp.float32))
        grad = texpand.fused_expand_lanes_backward(_t(g), torch.from_numpy(idx))
        _close(grad, np.moveaxis(np.asarray(vjp(jnp.asarray(np.moveaxis(g, 0, -1)))[0]), -1, 0), rtol=1e-6,
               atol=1e-6)
        return
    lw = _weights(n, (lanes,), name, rng)
    lw[:, 0] = -np.inf
    lw[n - 1, 0] = 0.0
    probs = torch.softmax(_t(lw), dim=0)
    planes = _t(rng.normal(size=(d, n, lanes))).requires_grad_(True)
    out, idx = texpand.fused_expand_lanes(probs, _t(rng.uniform(size=lanes)), planes)
    g = rng.normal(size=(d, n, lanes)).astype(np.float32)
    (out * _t(g)).sum().backward()
    vals = jnp.asarray(np.moveaxis(planes.detach().numpy(), 0, -1))  # (n, L, d)
    _, vjp = jax.vjp(lambda v: j_gather(v, jnp.asarray(idx.numpy()), 1), vals)
    _close(planes.grad, np.moveaxis(np.asarray(vjp(jnp.asarray(np.moveaxis(g, 0, -1)))[0]), -1, 0), rtol=1e-6,
           atol=1e-6)


def test_systematic_expand_carries_both_value_arrays():
    """The APF's call: values and pre-weights through one expansion, both
    with a gradient; the probabilities get none."""
    rng = np.random.default_rng(9)
    w = _t(rng.normal(size=50)).requires_grad_(True)
    x, pre = (_t(rng.normal(size=50)).requires_grad_(True) for _ in range(2))
    (rx, rpre), idx = texpand.systematic_expand(None, w, (x, pre), u=0.25)
    (rx.sum() + 3.0 * rpre.sum()).backward()
    copies = torch.bincount(idx.long(), minlength=50).float()
    assert torch.equal(x.grad, copies) and torch.equal(pre.grad, 3.0 * copies)
    assert w.grad is None


# -- the differentiable filters, replayed ------------------------------------------------------------
def _j_ssm(beta):
    return jts.LinearStateSpaceModel(jmodels.AR(ALPHA, beta, SIGMA), (OBS_COEF, OBS_STD))


def _t_ssm(beta):
    return tts.LinearStateSpaceModel(tts.models.AR(ALPHA, beta, SIGMA, device="cpu"), (OBS_COEF, OBS_STD))


@pytest.fixture(scope="module")
def y_ar():
    _, y = _t_ssm(BETA).sample_states(torch.Generator().manual_seed(0), T).get_paths()
    return y.numpy()


def _replayed_filters(cls_name, us, tape):
    """The JAX filter (replay resampler) and the port's (replayed uniform)."""
    kw = dict(ess_threshold=2.0) if cls_name == "SISR" else {}
    calls = {"jax": 0}

    def j_resampler(key, w, normalized=False):
        u = us[calls["jax"]]
        calls["jax"] += 1
        return j_counts(None, w, normalized=normalized, u=jnp.asarray(u))

    class Replay(getattr(pt, cls_name)):
        uniforms = 0

        def resample_uniform(self, generator):
            Replay.uniforms += 1
            return torch.tensor(us[Replay.uniforms - 1])

    def jax_filter(beta, flag=True):
        return getattr(pf, cls_name)(_j_ssm(beta), N, differentiable=flag, resampling_method=j_resampler, **kw)

    def port_filter(beta, flag=True):
        return Replay(_t_ssm(beta), N, differentiable=flag, device="cpu", **kw)

    return jax_filter, port_filter, calls, Replay


@pytest.mark.parametrize("cls_name", ["SISR", "APF"])
def test_differentiable_filter_matches_jax_grad(cls_name, y_ar, monkeypatch):
    """The log-likelihood and its gradient in beta on replayed draws against
    ``jax.grad`` of the JAX filter; the forward value equal with the
    correction on and off; a resample on every step."""
    us = np.random.default_rng(21).uniform(size=T).astype(np.float32)
    tape = _Tape(seed=2)
    tape.patch(monkeypatch)
    jax_filter, port_filter, calls, replay = _replayed_filters(cls_name, us, tape)

    with jax.disable_jit():
        jll, jgrad = jax.value_and_grad(
            lambda b: jax_filter(b).batch_filter(jax.random.PRNGKey(0), jnp.asarray(y_ar), use_jit=False)
            .log_likelihood)(jnp.asarray(BETA0))
    beta = torch.tensor(BETA0, requires_grad=True)
    tres = port_filter(beta).batch_filter(None, y_ar)
    tres.log_likelihood.backward()
    assert calls["jax"] == replay.uniforms == T, (calls, replay.uniforms)
    assert tape.calls["jax"] == tape.calls["port"]
    _close(tres.log_likelihood.detach(), jll, rtol=1e-5)
    _close(beta.grad, jgrad, rtol=1e-4)

    # the same draws with the correction off: the same forward value
    replay.uniforms, tape.calls["port"] = 0, 0
    off = port_filter(torch.tensor(BETA0), flag=False).batch_filter(None, y_ar).log_likelihood
    assert float(off) == float(tres.log_likelihood.detach())


def test_uncorrected_gradient_differs(y_ar, monkeypatch):
    """Without the correction the resample cuts the weights' genealogy: the
    gradient on the same draws is another number (the JAX package's too)."""
    us = np.random.default_rng(21).uniform(size=T).astype(np.float32)
    tape = _Tape(seed=2)
    tape.patch(monkeypatch)
    _, port_filter, _, replay = _replayed_filters("SISR", us, tape)
    grads = []
    for flag in (True, False):
        replay.uniforms, tape.calls["port"] = 0, 0
        beta = torch.tensor(BETA0, requires_grad=True)
        port_filter(beta, flag=flag).batch_filter(None, y_ar).log_likelihood.backward()
        grads.append(float(beta.grad))
    assert abs(grads[0] - grads[1]) > 1e-3 * abs(grads[0]), grads
