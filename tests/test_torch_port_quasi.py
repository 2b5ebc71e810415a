"""The port's quasi-random SMC² pieces, held against the JAX package: the
distributions' ``cdf``, ``icdf``, ``mean`` and ``variance``, the inverse
sampling of the stochastic-volatility priors, the Sobol engine's
post-processing and ``rewind``, the quasi context's start and its clones,
the quasi-random MVN, one SMC² rejuvenation with the distance stop, one
whole notebook-style SMC² fit replayed draw for draw, and the posterior
plot.

The engines scramble differently (scipy's Sobol in the JAX package, torch's
``SobolEngine`` in the port), so the port's engine is fed the JAX engine's
raw points and shift through its seam (``EngineContainer._engine``, whose
``draw``/``reset``/``fast_forward`` the port calls, and ``_rotation``). The
rejuvenation replays every other draw of the JAX run, recomputed from its
keys: the lane resample's uniform, each re-filter's normals and uniforms,
the acceptance uniforms (through ``batch.mcmc.utils._uniform``). The
whole fit instead runs the JAX package eagerly (``jax.disable_jit()``) with
``jax.random.normal`` / ``uniform`` drawing from a host tape, whose draws
the port then takes in the same order.

Tolerances: the engines' points bit for bit (the same float64 operations,
one rounding to float32); rel 1e-5 with abs 1e-6 on the distributions, the
inverse samples, the quasi start, the MVN draws, and the rejuvenation's
contexts and log-likelihoods (float32 in two frameworks, the BASELINE.md
gate). The cdfs are held at abs 1e-6 because torch's float32 ``ndtr``
loses relative precision deep in the lower tail (0 where JAX gives 9.9e-10
at z = -6, 4% high at z = -5; absolute errors below 1.2e-8); ``ndtri``
agrees to one ULP, and exactly at the squeezed tails ``p = 0.5 +- 0.5(1 -
eps)`` (z = -+5.294704 in both). Transition counts, Sobol points consumed
and accept masks are exact.

Run as a script, the module fits the JAX package's notebook SMC² at the
card's full size on the CPU over the seeds given (:func:`jax_notebook_spread`).
"""

import math
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import qmc as scipy_qmc

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import examples as jexamples
from pyfilter_tpu import inference as jinf
from pyfilter_tpu.inference import prior as jprior
from pyfilter_tpu.inference.context import QuasiInferenceContext as JQuasiContext
from pyfilter_tpu.inference.qmc import EngineContainer as JEngine
from pyfilter_tpu.inference.sequential.kernels import mh as jmh
from pyfilter_tpu.inference.state import RunningFilterResult as JRunning
from pyfilter_tpu.inference.state import SMC2State as JSMC2State
from pyfilter_tpu.inference.utils import QuasiMultivariateNormal as JQMVN
from pyfilter_tpu.inference.utils import construct_mvn as j_construct_mvn
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch import resampling as tresampling
from pyfilter_tpu_torch.inference import context as tcontext
from pyfilter_tpu_torch.inference import prior as tprior
from pyfilter_tpu_torch.inference import qmc as tqmc
from pyfilter_tpu_torch.inference.batch.mcmc import utils as tmcmc_utils

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SV_NAMES = ("kappa", "gamma", "sigma", "mu", "nu", "tau")
EPS = float(np.finfo(np.float32).eps)
TAILS = (0.5 - 0.5 * (1.0 - EPS), 0.5 + 0.5 * (1.0 - EPS))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


# -- 1. distributions ------------------------------------------------------------------------------
def _f32(x):
    return np.asarray(x, np.float32)


# name: (parameters, values inside the support)
_DISTS = {
    "Normal": (dict(loc=[0.3, -1.0, 2.0], scale=1.7), [[-4.0], [0.0], [0.7], [5.0]]),
    "LogNormal": (dict(loc=[math.log(0.05), 0.0, -1.0], scale=1.0), [[1e-3], [0.05], [1.0], [8.0]]),
    "Exponential": (dict(rate=[10.0, 0.5, 2.0]), [[1e-4], [0.1], [1.0], [6.0]]),
    "Uniform": (dict(low=[-2.0, 0.0, 5.0], high=10.0), [[-1.5], [0.0], [6.0], [9.9]]),
}


@pytest.mark.parametrize("name", sorted(_DISTS))
def test_distribution_cdf_icdf_moments_match_jax(name):
    """``cdf`` over the support, ``icdf`` from the squeezed tails to the
    middle, ``mean`` and ``variance`` with lane-batched parameters."""
    params, values = _DISTS[name]
    jd = getattr(jdist, name)(**{k: jnp.asarray(_f32(v)) for k, v in params.items()})
    td = getattr(tdist, name)(**{k: _t(_f32(v)) for k, v in params.items()})
    x = _f32(values) + np.zeros((1, 3), np.float32)
    q = _f32([[TAILS[0]], [1e-3], [0.1], [0.5], [0.9], [0.999], [TAILS[1]]])
    _close(td.cdf(_t(x)), jd.cdf(jnp.asarray(x)))
    _close(td.icdf(_t(q)), jd.icdf(jnp.asarray(q)))
    assert tuple(td.mean.shape) == tuple(td.variance.shape) == (3,)
    _close(td.mean, jd.mean)
    _close(td.variance, jd.variance)


def test_independent_moments_and_inverse_match_jax():
    loc, q = _f32([0.2, -0.4]), _f32([[TAILS[0], 0.3], [0.8, TAILS[1]]])
    jd = jdist.Normal(jnp.asarray(loc), jnp.asarray(np.float32(0.5))).to_event(1)
    td = tdist.Normal(_t(loc), _t(np.float32(0.5))).to_event(1)
    _close(td.icdf(_t(q)), jd.icdf(jnp.asarray(q)))
    _close(td.cdf(_t(q)), jd.cdf(jnp.asarray(q)))
    _close(td.mean, jd.mean)
    _close(td.variance, jd.variance)


def _sv_contexts(k, seed):
    """A JAX quasi context (its engine seeded ``seed``) and a port quasi
    context, each with the stochastic-volatility builder's priors registered
    over ``k`` lanes."""
    jctx = JQuasiContext(key=jax.random.PRNGKey(seed), seed=seed)
    jctx.set_batch_shape((k,))
    jexamples.stochastic_volatility_builder(jctx)
    tctx = tinf.make_context(use_quasi=True, generator=torch.Generator().manual_seed(seed), device="cpu")
    tctx.set_batch_shape((k,))
    pt.examples.stochastic_volatility_builder(tctx)
    return jctx, tctx


@pytest.mark.parametrize("constrained", [True, False])
def test_inverse_sample_on_sv_priors_matches_jax(constrained):
    """``inverse_sample`` and ``get_numel`` of the six priors of the
    notebook's model (Exponential, LogNormal x 3, Normal x 2), and the
    unconstrained priors' ``cdf`` at those samples."""
    jctx, tctx = _sv_contexts(4, seed=1)
    q = _f32(np.linspace(0.0, 1.0, 9)[1:-1].tolist() + list(TAILS))
    for name in SV_NAMES:
        jp, tp = jctx.get_prior(name), tctx.get_prior(name)
        assert tprior.get_numel(tp, constrained) == jprior.get_numel(jp, constrained) == 1
        got = tprior.inverse_sample(tp, _t(q), constrained=constrained)
        want = jprior.inverse_sample(jp, jnp.asarray(q), constrained=constrained)
        _close(got, want)
        if not constrained:
            _close(tprior.unconstrained_prior(tp).cdf(got), jprior.unconstrained_prior(jp).cdf(want))


# -- 2. the Sobol engine ---------------------------------------------------------------------------
class _ScipySobol:
    """The JAX engine's scipy sequence behind the interface the port's
    engine calls (``draw``, ``reset``, ``fast_forward``): the seam."""

    def __init__(self, dim, seed):
        self._sobol = scipy_qmc.Sobol(dim, scramble=True, seed=seed)

    def draw(self, n, dtype=torch.float64):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # scipy's balance warning
            return torch.from_numpy(self._sobol.random(n)).to(dtype)

    def reset(self):
        self._sobol.reset()

    def fast_forward(self, n):
        self._sobol.fast_forward(n)


def _fed_engine(dim, randomize, seed, device="cpu"):
    """A port engine drawing the points of ``JEngine(dim, randomize, seed)``,
    with its shift."""
    engine = tqmc.EngineContainer(dim, randomize, seed=0, device=device)
    engine._engine = _ScipySobol(dim, seed)
    engine._rotation = torch.from_numpy(np.random.default_rng(seed + 1).uniform(size=dim))
    return engine


@pytest.mark.parametrize("randomize", [True, False])
def test_engine_post_processing_and_rewind_match_jax(randomize):
    """Draws of several shapes (the single point squeezed), a rewind and the
    draws after it: the same float32 points as the JAX engine's; then the
    port's own engine: a seed fixes it, and ``rewind`` replays its sequence."""
    je, te = JEngine(6, randomize, seed=7), _fed_engine(6, randomize, 7)
    for shape in ((5,), (1,), (3, 4), (2,)):
        got, want = te.sample(shape), np.asarray(je.sample(shape))
        assert got.dtype == torch.float32 and tuple(got.shape) == shape + (6,)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0.0 < got.min() and got.max() < 1.0
    if randomize:
        np.testing.assert_array_equal(te._rotation.numpy(), je._rotation_vector)
    for n in (7, 3):
        je.rewind(n)
        te.rewind(n)
        np.testing.assert_array_equal(te.sample((n + 2,)).numpy(), np.asarray(je.sample((n + 2,))))
    assert te.n_drawn == je._num_drawn == 24
    assert te.n_copies == 6

    a, b = tqmc.EngineContainer(6, randomize, seed=3, device="cpu"), tqmc.EngineContainer(6, randomize, seed=3,
                                                                                          device="cpu")
    first = a.sample((10,))
    np.testing.assert_array_equal(first.numpy(), b.sample((10,)).numpy())
    a.rewind(4)
    np.testing.assert_array_equal(a.sample((4,)).numpy(), first[6:].numpy())
    with pytest.raises(ValueError):
        a.rewind(11)


def _feed_context_engines(monkeypatch, seed):
    """Every engine the port's quasi contexts make draws the JAX engine's
    points for ``seed`` (the seam)."""
    monkeypatch.setattr(tcontext, "EngineContainer",
                        lambda dim, randomize, seed=None, device=None, _s=seed: _fed_engine(dim, randomize, _s,
                                                                                             device))


def test_quasi_context_start_matches_jax(monkeypatch):
    """``initialize_parameters`` over 64 lanes from the same Sobol points:
    each parameter inverted on the unconstrained space in registration
    order; then the clones (``resample``, ``exchange``,
    ``unstack_parameters``) are quasi contexts without an engine in both
    packages, while ``absorb`` keeps the held context's engine."""
    k, seed = 64, 11
    jctx, tctx = _sv_contexts(k, seed)
    _feed_context_engines(monkeypatch, seed)
    jctx.initialize_parameters()
    tctx.initialize_parameters()
    assert list(tctx.parameters) == list(jctx.parameters) == list(SV_NAMES)
    for constrained in (True, False):
        _close(tctx.stack_parameters(constrained), jctx.stack_parameters(constrained))
    assert tctx.quasi_engine.n_drawn == jctx.quasi_engine._num_drawn == k
    np.testing.assert_array_equal(tctx.quasi_engine._rotation.numpy(), jctx.quasi_engine._rotation_vector)

    idx = np.random.default_rng(12).integers(0, k, k).astype(np.int32)
    mask = np.arange(k) % 2 == 0
    t_clones = [tctx.resample(_t(idx)), tctx.exchange(tctx, _t(mask)),
                tctx.unstack_parameters(tctx.stack_parameters(False), constrained=False)]
    j_clones = [jctx.resample(jnp.asarray(idx)), jctx.exchange(jctx, jnp.asarray(mask)),
                jctx.unstack_parameters(jctx.stack_parameters(False), constrained=False)]
    for tc, jc in zip(t_clones, j_clones):
        assert type(tc) is tinf.QuasiInferenceContext and type(jc) is JQuasiContext
        assert tc.quasi_engine is None and jc.quasi_engine is None
    engine = tctx.quasi_engine
    assert tctx.absorb(t_clones[0]).quasi_engine is engine
    _close(tctx.stack_parameters(True), jctx.resample(jnp.asarray(idx)).stack_parameters(True))


def test_quasi_mvn_sample_matches_jax():
    """``QuasiMultivariateNormal`` over a single loc (``size`` draws) and
    over lane-batched locs, and ``construct_mvn`` with an engine: ``loc + L
    ndtri(p)`` on the same points; one host-to-device copy per draw."""
    rng = np.random.default_rng(13)
    d, k = 6, 40
    x = rng.normal(size=(k, d)).astype(np.float32)
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    je, te = JEngine(d, True, seed=14), _fed_engine(d, True, 14)
    jm = j_construct_mvn(jnp.asarray(x), jnp.asarray(w), scale=1.1, quasi_engine=je)
    tm = tinf.construct_mvn(_t(x), _t(w), scale=1.1, quasi_engine=te)
    assert isinstance(tm, tinf.QuasiMultivariateNormal) and tm.batch_shape == ()
    _close(tm.loc, jm.loc)
    _close(tm.scale_tril, jm.scale_tril)
    _close(tm.sample(None, (k,)), jm.sample(None, (k,)))
    loc = rng.normal(size=(k, d)).astype(np.float32)
    tril = np.tril(rng.normal(size=(d, d)) * 0.3 + np.eye(d) * 2.0).astype(np.float32)
    jb, tb = JQMVN(je, jnp.asarray(loc), jnp.asarray(tril)), tinf.QuasiMultivariateNormal(te, _t(loc), _t(tril))
    _close(tb.sample(None), jb.sample(None))
    assert te.n_drawn == je._num_drawn == 2 * k and te.n_copies == 2
    assert type(tinf.construct_mvn(_t(x), _t(w))) is tdist.MultivariateNormal


# -- 3. one SMC² rejuvenation with the distance stop -----------------------------------------------
N, K, T, STEPS, DISTANCE = 32, 16, 8, 5, 0.25
OES = 5


def _apf_draws(key, n_steps, lanes=K, n=N):
    """The standard normals and per-lane uniforms a JAX APF
    ``batch_filter_masked`` of ``n`` particles over ``lanes`` lanes of the
    stochastic-volatility model draws from ``key``, in the order the port's
    APF takes them: the initial cloud, then per step the sub-steps'
    increments (one batched draw, none at the first step), the resampling
    uniforms and the bootstrap proposal's normals."""
    k_init, k_first, k_scan = jax.random.split(key, 3)
    normals = [np.asarray(jax.random.normal(k_init, (n, lanes), jnp.float32))]
    uniforms = []
    for t, k in enumerate([k_first] + list(jax.random.split(k_scan, n_steps - 1))):
        n_sub = 0 if t == 0 else OES - 1
        keys = jax.random.split(k, n_sub + 2)
        if n_sub:
            normals.append(np.asarray(jax.random.normal(keys[1], (n_sub, n, lanes), jnp.float32)))
        k_resample, k_prop = jax.random.split(keys[-1])
        uniforms.append(np.asarray(jax.random.uniform(k_resample, (lanes,), jnp.float32)))
        normals.append(np.asarray(jax.random.normal(k_prop, (n, lanes), jnp.float32)))
    return normals, uniforms


def _replay(monkeypatch, normals, uniforms, accept_uniforms):
    """Feed the port the JAX run's draws; returns the iterators to check
    that every draw was taken."""
    normals, uniforms, accept_uniforms = iter(normals), iter(uniforms), iter(accept_uniforms)

    def sample(self, generator, sample_shape=()):
        z = next(normals)
        assert z.shape == tuple(sample_shape) + tuple(self.batch_shape)
        return self.loc + self.scale * _t(z)

    monkeypatch.setattr(tdist.Normal, "sample", sample)
    monkeypatch.setattr(pt.APF, "resample_uniform", lambda self, generator: _t(next(uniforms)))
    monkeypatch.setattr(tmcmc_utils, "_uniform", lambda generator, like: _t(next(accept_uniforms)))
    return normals, uniforms, accept_uniforms


def test_smc2_rejuvenation_with_distance_stop_replays_jax(monkeypatch):
    """``ParticleMetropolisHastings(num_steps=5, distance_threshold=0.25)``
    on a quasi context over 16 lanes of APF(32) after 8 observations of the
    stochastic-volatility model, both packages from one cloud and one
    context, the port taking the JAX run's draws (module docstring): the
    same lane resample, the same Sobol candidates, the stop after the same
    transition (before the fifth), the same Sobol points consumed, contexts
    and log-likelihoods within rel 1e-5."""
    import chip_smoke

    y = chip_smoke.simulate_obs(T)
    jctx, tctx = _sv_contexts(K, seed=15)
    _feed_context_engines(monkeypatch, 15)
    jctx.initialize_parameters()
    tctx.initialize_parameters()
    pt.convert.set_context_values(tctx, {n: np.asarray(v) for n, v in jctx.parameters.items()})

    jfilt = pf.APF(jexamples.stochastic_volatility_builder, N, record_moments=False).set_batch_shape(
        (K,)).initialize_model(jctx)
    jres = jfilt.batch_filter(jax.random.PRNGKey(16), jnp.asarray(y))
    jstate = JSMC2State(jres.log_likelihood, JRunning(jres.latest_state, jres.log_likelihood, record_moments=False),
                        parsed_data=list(y))
    transitions = []
    run_pmmh = jmh.run_pmmh
    monkeypatch.setattr(jmh, "run_pmmh", lambda *a, **kw: transitions.append(1) or run_pmmh(*a, **kw))
    jkernel = jmh.ParticleMetropolisHastings(num_steps=STEPS, distance_threshold=DISTANCE)
    key = jax.random.PRNGKey(17)
    jupd = jkernel.update(key, jctx, jfilt, jstate)
    n_done = len(transitions)
    assert 1 < n_done < STEPS and jkernel._increases == 0, "the distance stop must fire without a doubling"

    k_resample, key = jax.random.split(key)
    resample_u = np.asarray(jax.random.uniform(jax.random.split(k_resample)[0], (), jnp.float32))
    normals, uniforms, accept_u = [], [], []
    for _ in range(n_done):
        k_step, key = jax.random.split(key)
        _, k_filter, k_accept, _ = jax.random.split(k_step, 4)
        z, u = _apf_draws(k_filter, T)
        normals += z
        uniforms += u
        accept_u.append(np.asarray(jax.random.uniform(k_accept, (K,), jnp.float32)))
    its = _replay(monkeypatch, normals, uniforms, accept_u)

    tfilt = pt.APF(pt.examples.stochastic_volatility_builder, N, record_moments=False, device="cpu").set_batch_shape(
        (K,)).initialize_model(tctx)
    latest = jres.latest_state
    cloud = pt.convert.correction_from_numpy(*(np.asarray(a) for a in (
        latest.x.time_index, latest.x.value, latest.log_weights, latest.log_likelihood, latest.prev_indices)),
        device="cpu")
    ll = _t(np.asarray(jres.log_likelihood))
    tstate = tinf.SMC2State(ll.clone(), tinf.RunningFilterResult(cloud, ll.clone(), record_moments=False),
                            parsed_data=list(y))
    tkernel = tinf.ParticleMetropolisHastings(num_steps=STEPS, distance_threshold=DISTANCE)
    tkernel._resampler = lambda generator, weights, normalized=False: tresampling.systematic(
        None, weights, normalized=normalized, u=_t(resample_u))
    tupd = tkernel.update(None, tctx, tfilt, tstate)

    assert all(next(it, None) is None for it in its), "the port must take every draw of the JAX run"
    assert tkernel.n_transitions == n_done and tkernel.n_distance_stops == 1 and tkernel.n_doublings == 0
    assert tkernel.n_host_syncs == 2 * n_done  # the acceptance rate and the distance, per transition
    assert tctx.quasi_engine.n_drawn == jctx.quasi_engine._num_drawn == K * (1 + n_done)
    assert tupd.context.quasi_engine is None and type(tupd.context) is tinf.QuasiInferenceContext
    for constrained in (True, False):
        _close(tupd.context.stack_parameters(constrained), jupd.context.stack_parameters(constrained))
    _close(tupd.state.filter_state.log_likelihood, jupd.state.filter_state.log_likelihood)
    assert not tupd.state.w.any() and not np.asarray(jupd.state.w).any()


# -- 4. a whole notebook fit, every draw fed from the host ------------------------------------------
FIT_K, FIT_N, FIT_T, FIT_STEPS, FIT_DISTANCE = 64, 32, 32, 2, 0.025


class _Tape:
    """Standard normals and uniforms drawn on the host with numpy, recorded
    in the order the JAX fit asks for them (its ``jax.random.normal`` /
    ``uniform``, patched), then handed to the port's seams in that order:
    one stream each, every draw checked by shape."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.normals, self.uniforms = [], []

    def jax_normal(self, key, shape=(), dtype=jnp.float32):
        self.normals.append(self.rng.standard_normal(tuple(shape)).astype(np.float32))
        return jnp.asarray(self.normals[-1], dtype)

    def jax_uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        self.uniforms.append(self.rng.uniform(size=tuple(shape)).astype(np.float32))
        return jnp.asarray(self.uniforms[-1], dtype)

    def replay(self, monkeypatch, n_skip_normals: int):
        """Patch the port's draw seams to take the recorded draws, the
        normals from the initial cloud on (the prior draws before it are
        overwritten by the Sobol start in both packages)."""
        normals, uniforms = iter(self.normals[n_skip_normals:]), iter(self.uniforms)
        plain_sample, plain_init = tdist.Normal.sample, pt.APF.initialize
        live = []

        def sample(self, generator, sample_shape=()):
            if not live:
                return plain_sample(self, generator, sample_shape)
            z = next(normals)
            assert z.shape == tuple(sample_shape) + tuple(self.batch_shape)
            return self.loc + self.scale * _t(z)

        def uniform(shape):
            u = next(uniforms)
            assert u.shape == tuple(shape)
            return _t(u)

        def initialize(self, generator):
            live.append(True)
            return plain_init(self, generator)

        monkeypatch.setattr(tdist.Normal, "sample", sample)
        monkeypatch.setattr(pt.APF, "initialize", initialize)
        monkeypatch.setattr(pt.APF, "resample_uniform", lambda self, generator: uniform(self.batch_shape))
        monkeypatch.setattr(tmcmc_utils, "_uniform", lambda generator, like: uniform(like.shape))
        lane_resampler = lambda generator, w, normalized=False: tresampling.systematic(  # noqa: E731
            None, w, normalized=normalized, u=uniform(()))
        return normals, uniforms, lane_resampler


def _recording_step(alg, record, read):
    """Wrap ``alg.step`` to append ``read(state)`` after every observation."""
    step = alg.step

    def recorded(y, state):
        state = step(y, state)
        record.append(read(state))
        return state

    alg.step = recorded


def test_whole_notebook_fit_replays_jax(monkeypatch):
    """One whole notebook-style SMC² fit (Sobol start, SymmetricMH on the
    quasi context, ``num_steps=2``, the distance stop) of SMC2(APF(32), 64)
    over 32 observations of the stochastic-volatility model, in both
    packages: the JAX package on its per-step path (``chunk_size=1``, eager
    under ``jax.disable_jit()``) drawing every normal and uniform from a host
    tape, the port fed the same draws and the same Sobol points. After every
    observation: the same number of rejuvenations, lane log-weights within
    rel 1e-5 / abs 5e-5 and parameters within rel 1e-5 / abs 5e-6 (a
    parameter near 0); the fit ends with the same transitions and distance
    stops, every draw taken."""
    import chip_smoke

    seed = 21
    y = chip_smoke.simulate_obs(FIT_T)
    tape = _Tape(seed)
    jctx = JQuasiContext(key=jax.random.PRNGKey(seed), seed=seed)
    jalg = jinf.SMC2(pf.APF(jexamples.stochastic_volatility_builder, FIT_N), FIT_K, num_steps=FIT_STEPS,
                     distance_threshold=FIT_DISTANCE, context=jctx, key=jax.random.PRNGKey(seed + 1))
    counts = {"rejuvenations": 0, "transitions": 0}
    update, run_pmmh = jalg.kernel.update, jmh.run_pmmh

    def counting_update(*args, **kwargs):
        counts["rejuvenations"] += 1
        return update(*args, **kwargs)

    monkeypatch.setattr(jalg.kernel, "update", counting_update)
    monkeypatch.setattr(jmh, "run_pmmh", lambda *a, **kw: counts.__setitem__(
        "transitions", counts["transitions"] + 1) or run_pmmh(*a, **kw))
    jrec = []
    _recording_step(jalg, jrec, lambda s: (np.asarray(s.w), np.asarray(jctx.stack_parameters(True)),
                                           counts["rejuvenations"]))
    n_prior_draws = []
    initialize = jalg._filter.__class__.initialize

    def marked_initialize(self, key):
        n_prior_draws.append(len(tape.normals))
        return initialize(self, key)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal", tape.jax_normal)
        m.setattr(jax.random, "uniform", tape.jax_uniform)
        m.setattr(pf.APF, "initialize", marked_initialize)
        with jax.disable_jit():
            jalg.fit(jnp.asarray(y), logging=jinf.logging.DefaultLogger(), chunk_size=1)
    assert counts["rejuvenations"] >= 2, "the fit must rejuvenate more than once"

    _feed_context_engines(monkeypatch, seed)
    normals, uniforms, lane_resampler = tape.replay(monkeypatch, n_prior_draws[0])
    tctx = tinf.make_context(use_quasi=True, generator=torch.Generator().manual_seed(seed), device="cpu")
    talg = tinf.SMC2(pt.APF(pt.examples.stochastic_volatility_builder, FIT_N, device="cpu"), FIT_K,
                     num_steps=FIT_STEPS, distance_threshold=FIT_DISTANCE, context=tctx,
                     generator=torch.Generator().manual_seed(seed + 1), device="cpu")
    talg.kernel._resampler = lane_resampler
    trec = []
    _recording_step(talg, trec, lambda s: (s.w.numpy().copy(), tctx.stack_parameters(True).numpy().copy(),
                                           talg.kernel.n_rejuvenations))
    talg.fit(y)

    assert next(normals, None) is None and next(uniforms, None) is None, "the port must take every draw"
    assert len(trec) == len(jrec) == FIT_T
    for (jw, jp, jn), (tw, tp, tn) in zip(jrec, trec):
        assert tn == jn
        _close(tw, jw, atol=5e-5)
        _close(tp, jp, atol=5e-6)
    assert talg.kernel.n_transitions == counts["transitions"]


def test_posterior_plot_matches_jax():
    """``weighted_gaussian_kde`` and ``mimic_arviz_posterior`` on the same
    weighted cloud: the same curves, titles and layout as the JAX package's
    (numpy on the host in both; matplotlib's Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from pyfilter_tpu.inference import plot as jplot

    jctx, tctx = _sv_contexts(50, seed=18)
    pt.convert.set_context_values(tctx, {n: np.asarray(v) for n, v in jctx.parameters.items()})
    w = np.random.default_rng(19).normal(size=50).astype(np.float32)
    jfig, jaxes = jplot.mimic_arviz_posterior(jctx, JSMC2State(jnp.asarray(w), None))
    tfig, taxes = tinf.plot.mimic_arviz_posterior(tctx, tinf.SMC2State(_t(w), None))
    assert len(taxes) == len(jaxes) == 6
    for ta, ja in zip(taxes, jaxes):
        assert ta.get_title() == ja.get_title()
        (tline,), (jline,) = ta.get_lines(), ja.get_lines()
        _close(tline.get_xdata(), jline.get_xdata())
        _close(tline.get_ydata(), jline.get_ydata())
    plt.close(jfig)
    plt.close(tfig)


def test_quasi_entry_points():
    """``make_context(use_quasi=True)`` and ``SMC2(distance_threshold=)``
    wire through; the card is the default device."""
    ctx = tinf.make_context(use_quasi=True, randomize=False, device="cpu")
    assert type(ctx) is tinf.QuasiInferenceContext and not ctx._randomize
    alg = tinf.SMC2(pt.APF(pt.examples.stochastic_volatility_builder, 8, device="cpu"), 4, num_steps=3,
                    distance_threshold=0.025, context=ctx, device="cpu")
    assert alg.kernel._dist_thresh == 0.025 and alg.kernel._n_steps == 3
    alg.initialize()
    assert ctx.quasi_engine is not None and ctx.quasi_engine.n_drawn == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tinf.make_context(use_quasi=True)


# -- the JAX package at phase 10's full size --------------------------------------------------------
def _jax_notebook_fit(seed, chunk_size=None):
    """One JAX ``SMC2(APF(stochastic_volatility_builder, 400), 1000,
    num_steps=5, distance_threshold=0.025)`` fit with a Sobol start (its
    default chunked ``fit``, as ``examples/stochastic_volatility_smc2.py``
    runs it) over ``chip_smoke.py``'s phase-10 observations on the CPU:
    wall seconds, whether the weights are finite, the kernel's counts
    (rejuvenations, PMMH transitions, rejuvenations cut short by the distance
    stop, doublings, final state particles) and the posterior mean and sd by
    name."""
    import chip_smoke
    from pyfilter_tpu.inference.sequential.kernels import mh as jmh

    jax.config.update("jax_platforms", "cpu")
    y = jnp.asarray(chip_smoke.simulate_obs(chip_smoke.NB_T))
    counts = {"rejuvenations": 0, "transitions": 0, "stops": 0, "doublings": 0}
    run_pmmh, increase = jmh.run_pmmh, jmh.ParticleMetropolisHastings._increase_states

    def counting_pmmh(*args, **kwargs):
        counts["transitions"] += 1
        return run_pmmh(*args, **kwargs)

    def counting_increase(self, *args, **kwargs):
        counts["doublings"] += 1
        return increase(self, *args, **kwargs)

    jmh.run_pmmh = counting_pmmh
    jmh.ParticleMetropolisHastings._increase_states = counting_increase
    ctx = JQuasiContext(key=jax.random.PRNGKey(seed), seed=seed)
    alg = jinf.SMC2(pf.APF(jexamples.stochastic_volatility_builder, chip_smoke.NB_N), chip_smoke.NB_K,
                    num_steps=chip_smoke.NB_STEPS, distance_threshold=chip_smoke.NB_DISTANCE, context=ctx,
                    key=jax.random.PRNGKey(seed + 1))
    update = alg.kernel.update

    def counting_update(*args, **kwargs):
        before, doubled = counts["transitions"], counts["doublings"]
        out = update(*args, **kwargs)
        counts["rejuvenations"] += 1
        if counts["doublings"] == doubled and counts["transitions"] - before < chip_smoke.NB_STEPS:
            counts["stops"] += 1
        return out

    alg.kernel.update = counting_update
    t0 = time.perf_counter()
    state = alg.fit(y, logging=jinf.logging.DefaultLogger(), chunk_size=chunk_size)
    w = np.asarray(state.normalized_weights(), np.float64)
    stacked = np.asarray(ctx.stack_parameters(True), np.float64)
    mean = w @ stacked
    sd = np.sqrt(w @ (stacked - mean) ** 2)
    wall = time.perf_counter() - t0
    counts["state_particles"] = alg.filter.n_particles
    names = list(ctx.parameters)
    return (wall, bool(np.isfinite(np.asarray(state.w)).all()), counts, dict(zip(names, mean.tolist())),
            dict(zip(names, sd.tolist())))


def jax_notebook_spread(seeds, workers: int, chunk_size=None):
    """The JAX package's notebook SMC² at phase 10's full size, one fit per
    seed on the CPU in ``workers`` processes (``chunk_size=1``: its per-step
    loop, else its chunked default): each fit's wall seconds, counts and
    posterior; then, per parameter, the mean of the fits' posterior means
    and their spread between seeds (``chip_smoke.NB_JAX``)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    means = []
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        fits = pool.map(_jax_notebook_fit, seeds, [chunk_size] * len(seeds))
        for seed, (wall, finite, counts, mean, sd) in zip(seeds, fits):
            means.append(mean)
            print(f"jax seed {seed}: {wall:.3f} s; finite weights {finite}; {counts}; posterior mean {mean}; "
                  f"sd {sd}", flush=True)
    spread = {p: (float(np.mean([m[p] for m in means])), float(np.std([m[p] for m in means], ddof=1)))
              for p in means[0]}
    print(f"jax: over {len(means)} fits, (mean, sd between seeds) of each posterior mean {spread}", flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_quasi.py [--workers 4] [--chunk-size 1] SEED ...
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--chunk-size", type=int, default=None)
    parser.add_argument("seeds", type=int, nargs="+")
    args = parser.parse_args()
    jax_notebook_spread(args.seeds, args.workers, args.chunk_size)
