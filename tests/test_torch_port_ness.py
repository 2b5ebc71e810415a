"""The port's online parameter inference on the Lorenz-63 model, held
against the JAX package: the Uniform prior and the interval bijector, the
Lorenz builder's contexts, the robust variance and bandwidths, the KDE jitter
kernels, the online kernel, the Lorenz model and SISR over its lanes, the
rejuvenation triggers of NESS, FixedWidthNESS and the hybrids, the
end-of-data heal, and whole NESS fits.

Randomness is replayed where it can be: the JAX run's uniforms and normals
(recomputed from its keys) go into the port through the resampler argument,
``ParticleFilter.resample_uniform``, the jitter's module-level
``_standard_normal``, ``OnlineKernel.jitter_mask`` and ``Normal.sample``.

Tolerances: rel 1e-6 on the Uniform's densities, cdf and icdf and on the
Lorenz drift and mean (single float32 operations on the same inputs, abs
1e-6 of the drift's scale where its terms cancel); rel 1e-5 on the interval
bijector, the stacked contexts and prior densities, the robust variance and
the bandwidths, the jitter kernels' fits and draws, the online kernel's
jittered values and ten Euler-Maruyama sub-steps (float32 in two frameworks,
the BASELINE.md gate); indices, gathered lanes, trigger iterations exact.
SISR over 4 lanes of 64 particles for 3 observations: rel 1e-5 on the filter
means and log-likelihoods, which the chaos allows for about 3 observations
(measured: largest relative gap of the means 1.7e-7, 4.3e-7, 1.7e-6 after
observations 1, 2, 3, about 3x per observation of 10 sub-steps, as the drift
amplifies float32 rounding). A NESS fit over 4 observations with every
draw of the JAX run replayed: rejuvenation iterations exact, rel 1e-5 on the
contexts, lane weights and log-likelihoods (measured: 2.3e-7 to 3.1e-6).
Whole NESS fits with their own randomness cannot be compared fit against
fit: one observation drops the parameter ESS to about 1, the cloud freezes
near one prior draw with posterior sds below 0.01, and which draw depends on
every random number (both packages; fits differ by 10^3-10^5 pooled sds). So
the statistical test compares the two packages' distributions of posterior
means over seeds, within 4 standard errors.

Run as a script, the module fits the JAX package's NESS at the card's
full-size configuration on the CPU over the seeds given
(:func:`jax_ness_spread`).
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
from pyfilter_tpu import inference as jinf
from pyfilter_tpu import resampling as jresampling
from pyfilter_tpu.filters.state import ParticleFilterCorrection as JCorrection
from pyfilter_tpu.inference.sequential import kernels as jkernels
from pyfilter_tpu.inference.sequential.kernels import jittering as jjit
from pyfilter_tpu.inference.state import RunningFilterResult as JRunning
from pyfilter_tpu.inference.state import SequentialAlgorithmState as JSeqState
from pyfilter_tpu.timeseries import TimeseriesState as JState
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch import resampling as tresampling
from pyfilter_tpu_torch.inference.sequential import kernels as tkernels
from pyfilter_tpu_torch.inference.sequential.kernels import jittering as tjit
from pyfilter_tpu_torch.timeseries import TimeseriesState as TState

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the sizes every test that runs a JAX algorithm shares, so its compiles are shared
N, K, T = 50, 64, 30
TRUE = dict(s=10.0, r=28.0, b=8.0 / 3.0)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def lorenz_y():
    """T + 10 observed rows of the port's ``lorenz63_model().sample_states`` (seed 0)."""
    _, ys = pt.examples.lorenz63_model(device="cpu").sample_states(torch.Generator().manual_seed(0),
                                                                   10 * (T + 10)).get_paths()
    return ys[~torch.isnan(ys).any(dim=1)].numpy()


def _contexts(seed, k=K):
    """A JAX context and a port context with the Lorenz builder's priors and
    the same values (the JAX context's prior draws)."""
    jctx = jinf.make_context(key=jax.random.PRNGKey(seed))
    jctx.set_batch_shape((k,))
    jexamples.lorenz63_builder(jctx)
    tctx = tinf.make_context(device="cpu")
    tctx.set_batch_shape((k,))
    pt.examples.lorenz63_builder(tctx)
    pt.convert.set_context_values(tctx, {n: np.asarray(v) for n, v in jctx.parameters.items()})
    return jctx, tctx


# -- 1. Uniform and the interval bijector ----------------------------------------------------------
def _ulps(x, toward, k):
    out = np.float32(x)
    for _ in range(k):
        out = np.nextafter(out, np.float32(toward))
    return out


def test_uniform_and_interval_bijector_match_jax():
    low, high = 1.0, 20.0
    tu, ju = tdist.Uniform(torch.tensor(low), torch.tensor(high)), jdist.Uniform(low, high)
    values = np.asarray([low, high, _ulps(low, 0, 1), _ulps(high, 30, 1), 0.5, 25.0, 1.5, 10.25, 19.9], np.float32)
    lp = tu.log_prob(_t(values)).numpy()
    _close(lp, ju.log_prob(jnp.asarray(values)), rtol=1e-6)
    assert np.isneginf(lp[2:6]).all() and np.isfinite(lp[[0, 1, 6, 7, 8]]).all()
    _close(tu.cdf(_t(values)), ju.cdf(jnp.asarray(values)), rtol=1e-6)
    q = np.asarray([0.0, 0.1, 0.5, 0.999, 1.0], np.float32)
    _close(tu.icdf(_t(q)), ju.icdf(jnp.asarray(q)), rtol=1e-6)
    draws = tu.sample(torch.Generator().manual_seed(0), (1000,))
    assert draws.shape == (1000,) and bool(((draws >= low) & (draws < high)).all())

    tb, jb = tdist.biject_to(tu.support), jdist.biject_to(ju.support)
    assert isinstance(tb, tdist.Chain) and isinstance(tb.parts[0], tdist.Sigmoid)
    x = np.asarray([-30.0, -10.0, -1.0, 0.0, 0.5, 3.0, 10.0, 30.0], np.float32)
    y_t, y_j = tb.forward(_t(x)), jb.forward(jnp.asarray(x))
    _close(y_t, y_j)
    _close(tb.log_abs_det_jacobian(_t(x), y_t), jb.log_abs_det_jacobian(jnp.asarray(x), y_j))
    # inside, within 1, 2 and 4 ULP of each bound, and on the bounds (+-inf in both)
    y = np.asarray([2.0, 10.0, 19.0] + [_ulps(low, high, k) for k in (1, 2, 4)]
                   + [_ulps(high, low, k) for k in (1, 2, 4)] + [low, high], np.float32)
    inv_t, inv_j = tb.inverse(_t(y)).numpy(), np.asarray(jb.inverse(jnp.asarray(y)))
    _close(inv_t, inv_j)
    assert np.isneginf(inv_t[-2]) and np.isposinf(inv_t[-1])
    # the unconstrained prior's path: the inverse bijector's fused inverse and jacobian
    u = jnp.asarray(inv_j[:-2])
    c_t, ladj_t = tb.inv.inverse_and_ladj(_t(inv_j[:-2]))
    _close(c_t, jb.forward(u))
    _close(ladj_t, -jb.log_abs_det_jacobian(u, jb.forward(u)))


# -- 2. the Lorenz builder's contexts --------------------------------------------------------------
def test_lorenz_contexts_stack_and_unstack_match_jax():
    jctx, tctx = _contexts(seed=0)
    assert list(tctx.parameters) == ["s", "r", "b"]
    stacked_t, stacked_j = tctx.stack_parameters(constrained=False), jctx.stack_parameters(constrained=False)
    _close(stacked_t, stacked_j)
    _close(tctx.eval_priors(constrained=False), jctx.eval_priors(constrained=False))
    back_t = tctx.unstack_parameters(stacked_t, constrained=False)
    back_j = jctx.unstack_parameters(stacked_j, constrained=False)
    for name in tctx.parameters:
        _close(back_t.parameters[name], back_j.parameters[name])
        _close(back_t.parameters[name], tctx.parameters[name])


# -- 3. robust variance and bandwidths -------------------------------------------------------------
def _weight_cases():
    rng = np.random.default_rng(3)
    x = rng.normal(0.0, [1.0, 3.0, 0.2], (40, 3)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, 40).astype(np.float32)
    ties = rng.integers(0, 5, (16, 3)).astype(np.float32)  # tied values: the stable sort's order decides
    flat = np.full(16, 1.0 / 16, np.float32)  # cumulative sums hit 0.25 and 0.75 exactly
    # dyadic weights: exact cumulative sums, exact ties in |cum - q|
    dyadic = np.asarray([1 / 8, 1 / 4, 1 / 8, 1 / 8, 1 / 8, 1 / 8, 1 / 16, 1 / 16], np.float32)
    # ties whose order decides the quartile rows: the stable sort (rows 1, 0,
    # 2, 3, 5, 4) puts both quartiles on the value 2, so the robust variance
    # is 0; rows 1, 2, 0, 5, 3, 4 would put them on 1 and 2 (0.327)
    order = np.asarray([[1.0], [0.0], [1.0], [2.0], [3.0], [2.0]], np.float32)
    order_w = np.asarray([0.05, 0.05, 0.05, 0.05, 0.05, 0.75], np.float32)
    return [(x, w / w.sum()), (ties, flat), (ties[:8], dyadic), (x[:8], dyadic), (order, order_w)]


@pytest.mark.parametrize("case", range(5))
def test_robust_var_and_bandwidths_match_jax(case):
    x, w = _weight_cases()[case]
    if case == 4:
        assert float(tjit.robust_var(_t(x), _t(w))) == 0.0
    mean = (w[:, None] * x).sum(0).astype(np.float32)
    _close(tjit.robust_var(_t(x), _t(w)), jjit.robust_var(jnp.asarray(x), jnp.asarray(w)))
    _close(tjit.robust_var(_t(x), _t(w), _t(mean)), jjit.robust_var(jnp.asarray(x), jnp.asarray(w), jnp.asarray(mean)))
    _close(tjit._bandwidth_factor(_t(w)), jjit._bandwidth_factor(jnp.asarray(w)))
    ess = float(1.0 / np.sum(w.astype(np.float64) ** 2))
    for fn in ("silverman", "scott"):
        _close(getattr(tjit, fn)(3, torch.tensor(ess)), getattr(jjit, fn)(3, jnp.asarray(ess)))


# -- 4. the jitter kernels -------------------------------------------------------------------------
_KERNELS = {
    "shrinking": (tkernels.ShrinkingKernel(), jkernels.ShrinkingKernel()),
    "non-shrinking": (tkernels.NonShrinkingKernel(), jkernels.NonShrinkingKernel()),
    "liu-west": (tkernels.LiuWestShrinkage(a=0.97), jkernels.LiuWestShrinkage(a=0.97)),
    "constant": (tkernels.ConstantKernel(scale=0.05), jkernels.ConstantKernel(scale=0.05)),
}


@pytest.mark.parametrize("name", sorted(_KERNELS))
def test_jitter_kernels_match_jax(name, monkeypatch):
    """``fit`` on the same cloud and resample indices, then ``jitter`` with
    the JAX run's normals."""
    tk, jk = _KERNELS[name]
    rng = np.random.default_rng(4)
    x = rng.normal(0.0, [1.0, 0.5, 2.0], (K, 3)).astype(np.float32)
    w = np.exp(rng.normal(0.0, 1.0, K)).astype(np.float32)
    w /= w.sum()
    idx = np.asarray(jresampling.systematic(None, jnp.asarray(w), normalized=True, u=0.37))
    assert np.array_equal(tresampling.systematic(None, _t(w), normalized=True, u=0.37).numpy(), idx)
    (tm, ts), (jm, js) = tk.fit(_t(x), _t(w), _t(idx)), jk.fit(jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx))
    _close(tm, jm)
    _close(ts, js)

    key = jax.random.PRNGKey(5)
    z = np.asarray(jax.random.normal(key, (K, 3), jnp.float32))
    monkeypatch.setattr(tjit, "_standard_normal", lambda generator, like: _t(z))
    _close(tk.jitter(None, _t(x), _t(w), _t(idx)), jk.jitter(key, jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx)))
    with pytest.raises(ValueError, match="congruent"):
        tk.jitter(None, _t(x), _t(w), _t(idx[:-1]))
    with pytest.raises(NotImplementedError):
        tkernels.JitterKernel().fit(_t(x), _t(w), _t(idx))


# -- 5. the online kernel --------------------------------------------------------------------------
def _lane_state(seed, n=N, k=K):
    """One lane-batched Lorenz correction in both packages from the same
    numbers, inside a running record with two recorded moments."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(0.0, 8.0, (n, k, 3)).astype(np.float32)
    lw = rng.normal(size=(n, k)).astype(np.float32)
    ll = rng.normal(-40.0, 5.0, k).astype(np.float32)
    prev = rng.integers(0, n, (n, k)).astype(np.int32)
    jc = JCorrection.from_weighted_particles(JState(jnp.asarray(3.0), jnp.asarray(vals), 1), jnp.asarray(lw),
                                            jnp.asarray(ll), jnp.asarray(prev))
    tc = pt.convert.correction_from_numpy(*(np.asarray(a) for a in (
        jc.x.time_index, jc.x.value, jc.log_weights, jc.log_likelihood, jc.prev_indices, jc.mean, jc.variance
    )), event_ndim=1, device="cpu")
    moments = [rng.normal(size=(k, 3)).astype(np.float32) for _ in range(4)]
    jrun, trun = JRunning(jc, jnp.asarray(ll)), tinf.RunningFilterResult(tc, _t(ll))
    jrun.filter_means = [jnp.asarray(m) for m in moments[:2]]
    jrun.filter_variances = [jnp.asarray(m) for m in moments[2:]]
    trun.filter_means, trun.filter_variances = [_t(m) for m in moments[:2]], [_t(m) for m in moments[2:]]
    return jrun, trun, moments


@pytest.mark.parametrize("discrete", [False, True])
def test_online_kernel_update_matches_jax(discrete, monkeypatch):
    jctx, tctx = _contexts(seed=6)
    w = np.random.default_rng(7).normal(0.0, 2.0, K).astype(np.float32)
    jrun, trun, moments = _lane_state(8)
    jstate, tstate = JSeqState(jnp.asarray(w), jrun), tinf.SequentialAlgorithmState(_t(w), trun)

    key = jax.random.PRNGKey(9)
    jfilt = pf.SISR(jexamples.lorenz63_builder, N).set_batch_shape((K,))
    jupd = jkernels.OnlineKernel(discrete=discrete).update(key, jctx, jfilt, jstate)

    # the JAX update's draws, from its key schedule
    k_resample, k_jitter, k_disc = jax.random.split(key, 3)
    u = np.asarray(jax.random.uniform(k_resample, (), jnp.float32))
    z = np.asarray(jax.random.normal(k_jitter, (K, 3), jnp.float32))
    u_disc = np.asarray(jax.random.uniform(k_disc, (K,), jnp.float32))
    mask = (u_disc < 1.0 / math.sqrt(K)).astype(np.float32)[:, None]  # K = 64: p = 1/8 exactly
    assert np.array_equal(np.asarray(jax.random.bernoulli(k_disc, 1.0 / K**0.5, (K,))), mask[:, 0] == 1.0)

    indices = []

    def resampler(generator, weights, normalized=False):
        indices.append(tresampling.systematic(None, weights, normalized=normalized, u=torch.tensor(u)))
        return indices[-1]

    tkernel = tkernels.OnlineKernel(discrete=discrete, resampler=resampler)
    monkeypatch.setattr(tjit, "_standard_normal", lambda generator, like: _t(z))
    monkeypatch.setattr(tkernel, "jitter_mask", lambda generator, k, like: _t(mask))
    tfilt = pt.SISR(pt.examples.lorenz63_builder, N, device="cpu").set_batch_shape((K,))
    tupd = tkernel.update(None, tctx, tfilt, tstate)

    np.testing.assert_array_equal(indices[0].numpy(), np.asarray(jresampling.systematic(None, jnp.asarray(w), u=u)))
    if discrete:
        assert 0.0 < mask.sum() < K, "the case must jitter some lanes and keep others"
    for name in tctx.parameters:
        _close(tupd.context.parameters[name], jupd.context.parameters[name])
    _close(tupd.context.stack_parameters(constrained=False), jupd.context.stack_parameters(constrained=False))
    # the lanes move with the indices: gathers copy
    np.testing.assert_array_equal(tupd.state.filter_state.latest_state.x.value.numpy(),
                                  np.asarray(jupd.state.filter_state.latest_state.x.value))
    np.testing.assert_array_equal(tupd.state.filter_state.log_likelihood.numpy(),
                                  np.asarray(jupd.state.filter_state.log_likelihood))
    assert not tupd.state.w.any() and not np.asarray(jupd.state.w).any()
    # the moment history carried over as it was, not permuted
    for got, want in zip(tupd.state.filter_state.filter_means + tupd.state.filter_state.filter_variances, moments):
        np.testing.assert_array_equal(got.numpy(), want)
    # the rebuilt model holds the new context's values
    for value, name in zip(tupd.filter_.model.hidden.parameters[:3], ("s", "r", "b")):
        assert value is tupd.context.parameters[name]
    assert tkernel.n_rejuvenations == 1


# -- 6. the Lorenz model ---------------------------------------------------------------------------
def _lane_params(k=4):
    rng = np.random.default_rng(10)
    return [rng.uniform(lo, hi, k).astype(np.float32) for lo, hi in ((8.0, 12.0), (25.0, 31.0), (2.0, 3.5))]


def test_lorenz_drift_and_mean_scale_match_jax():
    s, r, b = _lane_params()
    x = np.random.default_rng(11).normal([0.0, 0.0, 25.0], 8.0, (32, 4, 3)).astype(np.float32)
    jdrift, _ = jexamples._lorenz_drift(JState(0.0, jnp.asarray(x), 1), jnp.asarray(s), jnp.asarray(r),
                                        jnp.asarray(b), 1.0)
    tdrift, tsigma = pt.examples._lorenz_drift(TState(0.0, _t(x), 1), _t(s), _t(r), _t(b), torch.tensor(1.0))
    scale = float(np.abs(np.asarray(jdrift)).max())
    _close(tdrift, jdrift, rtol=1e-6, atol=1e-6 * scale)
    jmodel = jexamples.lorenz63_model(jnp.asarray(s), jnp.asarray(r), jnp.asarray(b))
    tmodel = pt.examples.lorenz63_model(_t(s), _t(r), _t(b), device="cpu")
    (jloc, jsc), (tloc, tsc) = jmodel.hidden.mean_scale(JState(0.0, jnp.asarray(x), 1)), tmodel.hidden.mean_scale(
        TState(0.0, _t(x), 1))
    _close(tloc, jloc, rtol=1e-6, atol=1e-6)
    _close(tsc, jsc, rtol=1e-6)
    # the observation density and the initial law
    y = np.asarray([3.0, 20.0], np.float32)
    _close(tmodel.build_density(TState(0.0, _t(x), 1)).log_prob(_t(y)),
           jmodel.build_density(JState(0.0, jnp.asarray(x), 1)).log_prob(jnp.asarray(y)))
    t_init, j_init = tmodel.hidden.initial_distribution(), jmodel.hidden.initial_distribution()
    assert t_init.event_shape == (3,)
    _close(t_init.log_prob(_t(x[0])), j_init.log_prob(jnp.asarray(x[0])))


def _replay_normals(monkeypatch, draws):
    draws = iter(draws)

    def sample(self, generator, sample_shape=()):
        z = next(draws)
        assert z.shape == tuple(sample_shape) + tuple(self.batch_shape)
        return self.loc + self.scale * _t(z)

    monkeypatch.setattr(tdist.Normal, "sample", sample)
    return draws


def test_lorenz_substeps_match_jax(monkeypatch):
    """One observation's ten Euler-Maruyama sub-steps over (32, 4) lanes with
    the JAX run's increments."""
    s, r, b = _lane_params()
    x = np.random.default_rng(12).normal([0.0, 0.0, 25.0], 8.0, (32, 4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    jhidden = jexamples.lorenz63_model(jnp.asarray(s), jnp.asarray(r), jnp.asarray(b)).hidden
    want = jax.jit(lambda k, v: jhidden.propagate_substeps(k, JState(0.0, v, 1), 10).value)(key, jnp.asarray(x))
    draws = _replay_normals(monkeypatch, [np.asarray(jax.random.normal(key, (10, 32, 4, 3), jnp.float32))])
    thidden = pt.examples.lorenz63_model(_t(s), _t(r), _t(b), device="cpu").hidden
    got = thidden.propagate_substeps(None, TState(0.0, _t(x), 1), 10)
    assert next(draws, None) is None and got.time_index == 10.0
    _close(got.value, want)


def _jax_draws(key, n_steps, oes, shape, lanes):
    """The uniforms and standard normals a JAX SISR ``batch_filter`` (given
    an initial state, bootstrap proposal) draws from ``key``, in the order
    the port's filter takes them: per step the resampling uniforms (one per
    lane), one batched draw of the sub-steps' increments, the proposal's."""
    _, k_first, k_scan = jax.random.split(key, 3)
    normals, uniforms = [], []
    for t, k in enumerate([k_first] + list(jax.random.split(k_scan, n_steps - 1))):
        n_sub = 0 if t == 0 else oes - 1
        keys = jax.random.split(k, n_sub + 2)
        uniforms.append(np.asarray(jax.random.uniform(keys[0], lanes, jnp.float32)))
        if n_sub:
            normals.append(np.asarray(jax.random.normal(keys[1], (n_sub,) + shape, jnp.float32)))
        normals.append(np.asarray(jax.random.normal(keys[-1], shape, jnp.float32)))
    return normals, uniforms


class _ReplaySISR(pt.SISR):
    """The port's SISR, its fused lane resample taking the JAX run's uniforms."""

    def __init__(self, *args, uniforms, **kwargs):
        super().__init__(*args, **kwargs)
        self.uniforms = iter(uniforms)

    def resample_uniform(self, generator):
        return _t(next(self.uniforms))


def test_sisr_over_lorenz_lanes_matches_jax(monkeypatch):
    n, lanes, n_obs = 64, (4,), 3
    s, r, b = _lane_params()
    x0 = np.random.default_rng(14).normal([-5.9, -5.5, 24.6], 3.0, (n,) + lanes + (3,)).astype(np.float32)
    y = np.asarray([[-4.5, 19.5], [-3.0, 17.0], [-2.5, 15.5]], np.float32)
    key = jax.random.PRNGKey(15)
    normals, uniforms = _jax_draws(key, n_obs, 10, (n,) + lanes + (3,), lanes)

    ident = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], (n,) + lanes)
    jstate = JCorrection.from_weighted_particles(JState(jnp.asarray(0.0), jnp.asarray(x0), 1),
                                                 jnp.zeros((n,) + lanes), jnp.zeros(lanes), ident)
    jfilt = pf.SISR(jexamples.lorenz63_model(jnp.asarray(s), jnp.asarray(r), jnp.asarray(b)), n, batch_shape=lanes)
    jres = jfilt.batch_filter(key, jnp.asarray(y), initial_state=jstate)

    draws = _replay_normals(monkeypatch, normals)
    tfilt = _ReplaySISR(pt.examples.lorenz63_model(_t(s), _t(r), _t(b), device="cpu"), n, batch_shape=lanes,
                        device="cpu", uniforms=uniforms)
    tstate = pt.convert.correction_from_numpy(*(np.asarray(a) for a in (
        jstate.x.time_index, jstate.x.value, jstate.log_weights, jstate.log_likelihood, jstate.prev_indices,
        jstate.mean, jstate.variance)), event_ndim=1, device="cpu")
    tres = tfilt.batch_filter(None, y, initial_state=tstate)
    assert next(draws, None) is None and tfilt.n_resamples == n_obs
    assert tres.filter_means.shape == (n_obs,) + lanes + (3,)
    _close(tres.filter_means, jres.filter_means)
    _close(tres.step_log_likelihoods, jres.step_log_likelihoods)
    np.testing.assert_array_equal(tres.latest_state.prev_indices.numpy(), np.asarray(jres.latest_state.prev_indices))


# -- 7. triggers -----------------------------------------------------------------------------------
class _State:
    def __init__(self, it, ess, w, lib):
        self.current_iteration, self.ess, self.w = it, [lib(np.float32(ess))], lib(w)


def test_ness_pre_step_trigger_matches_jax():
    """NESS's check before each step on the same ESS sequence (threshold 0.9 x
    20 = 18): never before step 0, low ESS or a non-finite weight after."""
    jctx, tctx = _contexts(seed=16, k=20)
    jness = jinf.NESS(pf.SISR(jexamples.lorenz63_builder, 8), 20, context=jctx)
    tness = tinf.NESS(pt.SISR(pt.examples.lorenz63_builder, 8, device="cpu"), 20, context=tctx, device="cpu")
    w_ok, w_bad = np.zeros(20, np.float32), np.zeros(20, np.float32)
    w_bad[3] = np.nan
    seq = [(0, 5.0, w_ok), (1, 19.0, w_ok), (2, 17.9, w_ok), (3, 18.1, w_ok), (4, 18.0, w_ok), (5, 19.9, w_bad),
           (6, 2.0, w_ok), (0, 19.0, w_bad)]
    want = [jness.do_update_particles(_State(it, e, w, jnp.asarray)) for it, e, w in seq]
    got = [tness.do_update_particles(_State(it, e, w, _t)) for it, e, w in seq]
    assert got == want == [False, False, True, False, False, True, True, True]
    assert tness.n_host_syncs == len(seq)  # one read per check


def _fired(alg, y, jax_side):
    """Run ``alg.fit`` (the JAX package's per-step loop) recording the
    iterations of the second stage's (or the algorithm's own) rejuvenations
    and of the switch."""
    fired, switched = [], []
    target = getattr(alg, "_second", alg)
    rejuvenate = target._do_rejuvenate
    target._do_rejuvenate = lambda st: fired.append(st.current_iteration) or rejuvenate(st)
    if hasattr(alg, "do_on_switch"):
        on_switch = alg.do_on_switch
        alg.do_on_switch = lambda f, s, st: switched.append(st.current_iteration) or on_switch(f, s, st)
    if jax_side:
        state = alg.fit(jnp.asarray(y), logging=jinf.logging.DefaultLogger(), chunk_size=1)
    else:
        state = alg.fit(y)
    assert np.isfinite(np.asarray(state.w)).all()
    return fired, switched


@pytest.mark.parametrize("algorithm", ["FixedWidthNESS", "SMC2FW", "NESSMC2"])
def test_triggers_match_the_jax_per_step_loop(algorithm, lorenz_y):
    """FixedWidthNESS (block 10, 30 observations) and the hybrids (switch 20;
    SMC2FW's block 10; 40 observations) fire where the JAX package's per-step
    loop fires. The SMC² stage runs with threshold 0 (no PMMH move: at this
    size its default settings raise TooManyIncreases in both packages, see
    :func:`hybrid_defaults`), so the second stage's block schedule and the
    handover are what the runs compare."""
    kwargs = {"FixedWidthNESS": {"block_len": 10},
              "SMC2FW": {"switch": 20, "smc2_kw": {"threshold": 0.0}, "ness_kw": {"block_len": 10}},
              "NESSMC2": {"switch": 20, "smc2_kw": {"threshold": 0.0}}}[algorithm]
    y = lorenz_y[:T] if algorithm == "FixedWidthNESS" else lorenz_y
    jctx, tctx = _contexts(seed=17)
    jalg = getattr(jinf, algorithm)(pf.SISR(jexamples.lorenz63_builder, N), K, context=jctx,
                                    key=jax.random.PRNGKey(18), **kwargs)
    talg = getattr(tinf, algorithm)(pt.SISR(pt.examples.lorenz63_builder, N, device="cpu"), K, context=tctx,
                                    generator=torch.Generator().manual_seed(18), device="cpu", **kwargs)
    (j_fired, j_switched), (t_fired, t_switched) = _fired(jalg, y, True), _fired(talg, y, False)
    if algorithm == "NESSMC2":  # ESS-gated: the iterations follow each run's randomness
        assert len(t_fired) > 0 and len(j_fired) > 0
    else:
        assert t_fired == j_fired and len(t_fired) > 0
    assert t_switched == j_switched == ([] if algorithm == "FixedWidthNESS" else [21])
    if algorithm == "FixedWidthNESS":
        assert t_fired == [9, 19, 29]
        assert talg.n_host_syncs == T + 1  # a read before every step, one health read at the end
    elif algorithm == "SMC2FW":
        assert t_fired == [30]


def test_thresholds_and_exports_match_jax():
    """The decaying and interval schedules give the JAX package's thresholds,
    and every name the port's sequential layer exports is the JAX package's."""
    from pyfilter_tpu.inference.sequential import threshold as jth
    from pyfilter_tpu_torch.inference.sequential import threshold as tth

    iterations = [0, 1, 5, 10, 19, 20, 21, 99, 100, 101, 10_000]
    for args in ((0.1, 0.8, 10), (0.05, 0.5, 1_000)):
        want = [jth.DecayingThreshold(*args).get_threshold(i) for i in iterations]
        assert [tth.DecayingThreshold(*args).get_threshold(i) for i in iterations] == want
    table = {100: 0.5, 20: 0.7}
    want = [jth.IntervalThreshold(table, 0.1).get_threshold(i) for i in iterations]
    assert [tth.IntervalThreshold(table, 0.1).get_threshold(i) for i in iterations] == want
    algorithms = {"NESS", "FixedWidthNESS", "NESSMC2", "SMC2FW"}
    assert algorithms <= set(tinf.__all__) & set(jinf.__all__)
    assert algorithms | {"BaseOnlineAlgorithm", "CombinedSequentialParticleAlgorithm", "DecayingThreshold",
                         "IntervalThreshold"} <= set(tinf.sequential.__all__) & set(jinf.sequential.__all__)
    assert {"JitterKernel", "ShrinkingKernel", "NonShrinkingKernel", "LiuWestShrinkage", "ConstantKernel", "robust_var",
            "silverman", "scott", "OnlineKernel", "OnlineUpdate"} <= set(tkernels.__all__) & set(jkernels.__all__)


# -- 8. end-of-data heal ---------------------------------------------------------------------------
def test_ness_heals_dead_final_step(lorenz_y):
    """A last observation no lane can explain (inf) kills every lane on the
    final step; no later pre-step check sees it, so the fit's health read
    rejuvenates and the returned weights are finite (the port's counterpart
    of tests/test_inference.py::test_ness_heals_dead_final_step)."""
    y = lorenz_y[:12].copy()
    y[-1] = np.inf
    ctx = tinf.make_context(generator=torch.Generator().manual_seed(19), device="cpu")
    alg = tinf.NESS(pt.SISR(pt.examples.lorenz63_builder, N, device="cpu"), K, context=ctx,
                    generator=torch.Generator().manual_seed(20), device="cpu")
    fired = []
    rejuvenate = alg._do_rejuvenate

    def spy(st):
        fired.append((st.current_iteration, bool(torch.isfinite(st.w).all())))
        return rejuvenate(st)

    alg._do_rejuvenate = spy
    state = alg.fit(y)
    assert torch.isfinite(state.w).all() and not state.w.any()
    assert fired[-1] == (12, False) and alg.n_host_syncs == 13  # a read before every step, the health read


# -- 9. whole fits ---------------------------------------------------------------------------------
def test_ness_fit_replays_jax(lorenz_y, monkeypatch):
    """NESS(SISR(lorenz63_builder, 50), 64) over 4 observations: the JAX
    package's per-step fit, and the port's from the JAX run's initial context
    and cloud with every draw of the JAX run replayed (its keys recorded in
    order: a rejuvenation's resample uniform and jitter normals, each filter
    step's uniforms, sub-step increments and proposal normals). The
    rejuvenations fire at the same iterations; contexts, lane weights and
    log-likelihoods agree at rel 1e-5 (module docstring)."""
    y = lorenz_y[:4]
    jalg = jinf.NESS(pf.SISR(jexamples.lorenz63_builder, N), K, context=jinf.make_context(key=jax.random.PRNGKey(21)),
                     key=jax.random.PRNGKey(22))
    keys, start, fired = [], {}, {"jax": [], "port": []}
    next_key, j_initialize = jalg._next_key, jalg.initialize

    def record_key():
        keys.append(next_key())
        return keys[-1]

    def record_start():
        state = j_initialize()
        start["values"] = {n: np.asarray(v) for n, v in jalg.context.parameters.items()}
        start["cloud"] = state.filter_state.latest_state
        return state

    def spy(side, alg):
        rejuvenate = alg._do_rejuvenate
        alg._do_rejuvenate = lambda st: fired[side].append(st.current_iteration) or rejuvenate(st)

    jalg._next_key, jalg.initialize = record_key, record_start
    spy("jax", jalg)
    jstate = jalg.fit(jnp.asarray(y), logging=jinf.logging.DefaultLogger(), chunk_size=1)
    assert len(fired["jax"]) >= 2, "the replay must cover at least two rejuvenations"

    # the JAX run's draws from its keys: the context's and the cloud's, then
    # per step a rejuvenation's key when one fired before it, and the move's
    normals, uniforms, resample_u, jitter_z = [], [], [], []
    order = iter(keys[2:])
    for t in range(len(y)):
        if t in fired["jax"]:
            k_resample, k_jitter, _ = jax.random.split(next(order), 3)
            resample_u.append(np.asarray(jax.random.uniform(k_resample, (), jnp.float32)))
            jitter_z.append(np.asarray(jax.random.normal(k_jitter, (K, 3), jnp.float32)))
        n_sub = 0 if t == 0 else 9
        step_keys = jax.random.split(next(order), n_sub + 2)
        uniforms.append(np.asarray(jax.random.uniform(step_keys[0], (K,), jnp.float32)))
        if n_sub:
            normals.append(np.asarray(jax.random.normal(step_keys[1], (n_sub, N, K, 3), jnp.float32)))
        normals.append(np.asarray(jax.random.normal(step_keys[-1], (N, K, 3), jnp.float32)))
    assert next(order, None) is None

    draws = _replay_normals(monkeypatch, normals)
    step_u, jitter_u, jitter_zs = iter(uniforms), iter(resample_u), iter(jitter_z)
    monkeypatch.setattr(pt.SISR, "resample_uniform", lambda self, generator: _t(next(step_u)))
    monkeypatch.setattr(tjit, "_standard_normal", lambda generator, like: _t(next(jitter_zs)))
    talg = tinf.NESS(pt.SISR(pt.examples.lorenz63_builder, N, device="cpu"), K,
                     context=tinf.make_context(device="cpu"), device="cpu")
    talg.kernel._resampler = lambda generator, weights, normalized=False: tresampling.systematic(
        None, weights, normalized=normalized, u=_t(next(jitter_u)))
    def start_from_jax():
        talg.filter = talg.filter.initialize_model(talg.context)  # registers the priors
        pt.convert.set_context_values(talg.context, start["values"])
        talg.filter = talg.filter.initialize_model(talg.context)
        cloud = start["cloud"]
        cloud = pt.convert.correction_from_numpy(*(np.asarray(a) for a in (
            cloud.x.time_index, cloud.x.value, cloud.log_weights, cloud.log_likelihood, cloud.prev_indices,
            cloud.mean, cloud.variance)), event_ndim=1, device="cpu")
        return tinf.SequentialAlgorithmState(torch.zeros(K), tinf.RunningFilterResult(cloud, torch.zeros(K)))

    talg.initialize = start_from_jax
    spy("port", talg)
    tstate = talg.fit(y)
    assert fired["port"] == fired["jax"]
    assert all(next(it, None) is None for it in (draws, step_u, jitter_u, jitter_zs))
    _close(tstate.filter_state.log_likelihood, jstate.filter_state.log_likelihood)
    _close(tstate.w, jstate.w)
    for constrained in (False, True):
        _close(talg.context.stack_parameters(constrained=constrained),
               jalg.context.stack_parameters(constrained=constrained))
    assert talg.n_host_syncs == len(y) + 1


def _posterior(w, stacked):
    w, stacked = np.asarray(w, np.float64), np.asarray(stacked, np.float64)
    mean = w @ stacked
    return mean, np.sqrt(w @ (stacked - mean) ** 2)


def test_ness_fits_match_jax_in_distribution(lorenz_y):
    """NESS(SISR(lorenz63_builder, 50), 64) over 30 observations, 6 fits in
    each package with their own seeds: finite weights, posterior means inside
    the priors, and each parameter's mean over fits within 4 standard errors
    of the other package's (the fits themselves land on different prior
    draws; module docstring)."""
    fits = {"jax": [], "port": []}
    for seed in range(6):
        jctx = jinf.make_context(key=jax.random.PRNGKey(30 + seed))
        jstate = jinf.NESS(pf.SISR(jexamples.lorenz63_builder, N), K, context=jctx,
                           key=jax.random.PRNGKey(40 + seed)).fit(jnp.asarray(lorenz_y[:T]), chunk_size=1,
                                                                  logging=jinf.logging.DefaultLogger())
        fits["jax"].append(_posterior(jstate.normalized_weights(), jctx.stack_parameters(True))[0])
        tctx = tinf.make_context(generator=torch.Generator().manual_seed(30 + seed), device="cpu")
        talg = tinf.NESS(pt.SISR(pt.examples.lorenz63_builder, N, device="cpu"), K, context=tctx,
                         generator=torch.Generator().manual_seed(40 + seed), device="cpu")
        tstate = talg.fit(lorenz_y[:T])
        assert torch.isfinite(tstate.w).all()
        fits["port"].append(_posterior(tstate.normalized_weights(), tctx.stack_parameters(True))[0])
        assert talg.kernel.n_rejuvenations >= T // 2 and talg.n_host_syncs == T + 1
    jm, tm = np.asarray(fits["jax"]), np.asarray(fits["port"])
    lows, highs = np.asarray([5.0, 10.0, 1.0]), np.asarray([40.0, 50.0, 20.0])
    assert ((tm > lows) & (tm < highs)).all() and ((jm > lows) & (jm < highs)).all()
    se = np.sqrt(tm.var(0, ddof=1) / len(tm) + jm.var(0, ddof=1) / len(jm))
    assert (np.abs(tm.mean(0) - jm.mean(0)) < 4.0 * se).all(), (tm.mean(0), jm.mean(0), se)


# -- the JAX package at phase 9's full size ---------------------------------------------------------
def _jax_full_size_fit(seed):
    """One JAX ``NESS(SISR(lorenz63_builder, 400), 1000)`` fit (its default
    chunked ``fit``, as ``examples/lorenz_ness.py`` runs it) over
    ``chip_smoke.py``'s phase-9 observations on the CPU: wall seconds,
    whether the weights are finite, posterior mean and sd by name."""
    import time

    import chip_smoke

    jax.config.update("jax_platforms", "cpu")
    y = jnp.asarray(chip_smoke.lorenz_data(torch, pt))
    ctx = jinf.make_context(key=jax.random.PRNGKey(seed))
    alg = jinf.NESS(pf.SISR(jexamples.lorenz63_builder, chip_smoke.LORENZ_N), chip_smoke.LORENZ_K, context=ctx,
                    key=jax.random.PRNGKey(seed + 1))
    t0 = time.perf_counter()
    state = alg.fit(y, logging=jinf.logging.DefaultLogger())
    mean, sd = _posterior(state.normalized_weights(), ctx.stack_parameters(True))
    wall = time.perf_counter() - t0
    finite = bool(np.isfinite(np.asarray(state.w)).all())
    return wall, finite, dict(zip(ctx.parameters, mean.tolist())), dict(zip(ctx.parameters, sd.tolist()))


def jax_ness_spread(seeds, card_fits: int, workers: int):
    """The JAX package's NESS at phase 9's full size, one fit per seed on the
    CPU in ``workers`` processes: each fit's wall seconds, posterior and
    whether it finds the truth (``chip_smoke.finds_truth``). Then the count of
    fits that find it and the counts among ``card_fits`` card fits that a
    two-sided Fisher exact test against that count does not reject at 1%
    (``chip_smoke.NESS_FOUND_RANGE``); over the fits that find it, the mean
    and the spread between seeds of each posterior mean
    (``chip_smoke.JAX_FOUND``), and the largest gap between two of them in
    units of the larger posterior sd."""
    import itertools
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import chip_smoke
    from scipy import stats

    found = []
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        for seed, (wall, finite, mean, sd) in zip(seeds, pool.map(_jax_full_size_fit, seeds)):
            hit = chip_smoke.finds_truth(mean)
            if hit:
                found.append((mean, sd))
            print(f"jax seed {seed}: {wall:.3f} s; finite weights {finite}; finds the truth {hit}; "
                  f"posterior mean {mean}; sd {sd}", flush=True)
    n, k = len(seeds), len(found)
    allowed = [c for c in range(card_fits + 1)
               if stats.fisher_exact([[k, n - k], [c, card_fits - c]])[1] >= 0.01]
    print(f"jax: {k} of {n} fits find the truth; counts among {card_fits} card fits that a Fisher exact test "
          f"does not reject at 1%: {allowed[0]} to {allowed[-1]}")
    if k > 1:
        spread = {p: (float(np.mean([m[p] for m, _ in found])), float(np.std([m[p] for m, _ in found], ddof=1)))
                  for p in found[0][0]}
        worst = max(abs(ma[p] - mb[p]) / max(sa[p], sb[p])
                    for (ma, sa), (mb, sb) in itertools.combinations(found, 2) for p in ma)
        print(f"jax: over the {k} fits that find the truth, (mean, sd between seeds) of each posterior mean "
              f"{spread}; largest gap between two of them {worst} posterior sd")


def hybrid_defaults():
    """NESSMC2 and SMC2FW with their default SMC² stage (threshold 0.5, PMMH
    doubling the state particles when fewer than 0.2 of its moves are
    accepted, at most 5 times) in both packages, at the tests' size (N = 50,
    K = 64, switch 20, 40 observations): whether each fit completes or
    raises."""
    _, ys = pt.examples.lorenz63_model(device="cpu").sample_states(torch.Generator().manual_seed(0),
                                                                   10 * (T + 10)).get_paths()
    y = ys[~torch.isnan(ys).any(dim=1)].numpy()
    for name in ("NESSMC2", "SMC2FW"):
        runs = {"jax": lambda: getattr(jinf, name)(
                    pf.SISR(jexamples.lorenz63_builder, N), K, switch=20, context=jinf.make_context(
                        key=jax.random.PRNGKey(17)), key=jax.random.PRNGKey(18)).fit(
                    jnp.asarray(y), logging=jinf.logging.DefaultLogger(), chunk_size=1),
                "port": lambda: getattr(tinf, name)(
                    pt.SISR(pt.examples.lorenz63_builder, N, device="cpu"), K, switch=20, context=tinf.make_context(
                        generator=torch.Generator().manual_seed(17), device="cpu"),
                    generator=torch.Generator().manual_seed(18), device="cpu").fit(y)}
        for side, run in runs.items():
            try:
                run()
                print(f"{side} {name}({N}, {K}, switch=20) over {len(y)} observations: completed", flush=True)
            except (jkernels.TooManyIncreases, tkernels.TooManyIncreases) as e:
                print(f"{side} {name}({N}, {K}, switch=20) over {len(y)} observations: TooManyIncreases ({e})",
                      flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_ness.py [--card-fits 16] [--workers 4] SEED ...
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_ness.py --hybrid-defaults
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--card-fits", type=int, default=16)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--hybrid-defaults", action="store_true")
    parser.add_argument("seeds", type=int, nargs="*")
    args = parser.parse_args()
    if args.hybrid_defaults:
        jax.config.update("jax_platforms", "cpu")
        hybrid_defaults()
    if args.seeds:
        jax_ness_spread(args.seeds, args.card_fits, args.workers)
