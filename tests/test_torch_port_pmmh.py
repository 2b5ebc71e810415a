"""The port's batch PMMH, held against the JAX package: the random-walk and
adaptive proposals, the PMMH transition with its kernel exchange, the
``"seed"`` initializer's choice, and short ``PMMH.fit`` runs with every draw
replayed; and the two repaired faults of the filter layer (the fused
resample's size gate, ``FilterResult.resample(entire_history=False)``).

The model is ``examples/batch_inference_zoo.py``'s: an AR(1) with beta ~
Uniform(0, 1) and sigma ~ LogNormal(-1, 0.5), observed with noise 0.2. The
replays feed the port the JAX run's draws, recomputed from its key schedule:
the prior draws, each filter pass's initial cloud, per-step resampling
uniforms and proposal normals (``Normal.sample``, ``Uniform.sample``,
``ParticleFilter.resample_uniform``), the candidates (``Normal.sample``), and
the acceptance uniforms (``batch.mcmc.utils._uniform``).

Tolerances: rel 1e-5 with abs 1e-6 on kernels, contexts, log-likelihoods
and chains (float32 in two frameworks, the BASELINE.md gate), except the
adaptive walk's Cholesky factor, held through its covariance at that gate
and itself at abs 5e-5 (a rank-1 chain covariance early on makes its small
diagonal entry cancel; measured gap 2.2e-5); accept masks, chosen seeds and
draw counts exact.
"""

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import inference as jinf
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.filters.result import FilterResult as JFilterResult
from pyfilter_tpu.filters.state import ParticleFilterCorrection as JCorrection
from pyfilter_tpu.inference.state import FilterAlgorithmState as JFilterState
from pyfilter_tpu.timeseries import TimeseriesState as JState
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch.filters.particle import base as tparticle_base
from pyfilter_tpu_torch.inference.batch.mcmc import pmmh as tpmmh
from pyfilter_tpu_torch.inference.batch.mcmc import utils as tmcmc_utils
from pyfilter_tpu_torch.inference.state import FilterAlgorithmState as TFilterState
from pyfilter_tpu_torch.timeseries import models as tmodels

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N, K, T, SAMPLES, SCALE = 50, 4, 20, 5, 0.08
BETA, SIGMA, OBS_SCALE = 0.7, 0.3, 0.2


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


def j_build(ctx):
    beta = ctx.named_parameter("beta", jdist.Uniform(0.0, 1.0))
    sigma = ctx.named_parameter("sigma", jdist.LogNormal(-1.0, 0.5))
    return jts.LinearStateSpaceModel(jts.models.AR(0.0, beta, sigma), (1.0, OBS_SCALE))


def t_build(ctx):
    def const(v):
        return tmodels.parameter(v, ctx.device)

    beta = ctx.named_parameter("beta", tdist.Uniform(const(0.0), const(1.0)))
    sigma = ctx.named_parameter("sigma", tdist.LogNormal(const(-1.0), const(0.5)))
    return pt.timeseries.LinearStateSpaceModel(tmodels.AR(0.0, beta, sigma, device=ctx.device), (1.0, OBS_SCALE))


@pytest.fixture(scope="module")
def y():
    """T observations of the true AR model (the port's simulator, CPU, seed 0)."""
    model = pt.timeseries.LinearStateSpaceModel(tmodels.AR(0.0, BETA, SIGMA, device="cpu"), (1.0, OBS_SCALE))
    return model.sample_states(torch.Generator().manual_seed(0), T).get_paths()[1].numpy()


def _contexts(seed, k=K):
    """A JAX context and a port context with the model's priors over ``k``
    lanes and the same values (the JAX context's prior draws)."""
    jctx = jinf.make_context(key=jax.random.PRNGKey(seed))
    jctx.set_batch_shape((k,))
    j_build(jctx)
    tctx = tinf.make_context(device="cpu")
    tctx.set_batch_shape((k,))
    t_build(tctx)
    pt.convert.set_context_values(tctx, {n: np.asarray(v) for n, v in jctx.parameters.items()})
    return jctx, tctx


def _with_values(jctx, tctx, x):
    """Both contexts with the unconstrained stacked values ``x``."""
    return (jctx.unstack_parameters(jnp.asarray(x), constrained=False),
            tctx.unstack_parameters(_t(x), constrained=False))


# -- 1. proposals ----------------------------------------------------------------------------------
def _kernels_close(tk, jk):
    if isinstance(tk, tdist.Independent):
        _close(tk.base_dist.loc, jk.base_dist.loc)
        _close(tk.base_dist.scale, jk.base_dist.scale)
        return
    for name in ("loc", "mean", "m2"):
        _close(getattr(tk, name), getattr(jk, name))
    # the proposal covariance L L^T at the gate; the factor itself at abs
    # 5e-5, since a lane with two distinct positions so far has a rank-1
    # covariance (plus eps I) whose Cholesky factor's small diagonal entry
    # sqrt(c11 - l10^2) cancels: one float32 ULP of c11 moves it by ~2e-6
    tril, jtril = tk.scale_tril.double(), torch.from_numpy(np.asarray(jk.scale_tril, np.float64))
    _close(tril @ tril.mT, jtril @ jtril.mT)
    _close(tril, jtril, atol=5e-5)
    assert tk.count == float(jk.count)


@pytest.mark.parametrize("proposal", ["RandomWalk", "AdaptiveRandomWalk"])
def test_proposal_build_exchange_log_prob_match_jax(proposal):
    """``build`` on a context, then 11 transitions (2 D + 7 for D = 2) of
    ``exchange`` with candidate kernels built on fixed candidates and fixed
    accept masks, and ``log_prob`` of the lanes' values under each kernel;
    the adaptive walk adapts from transition 4 and freezes after 8."""
    rng = np.random.default_rng(1)
    jctx, tctx = _contexts(seed=2)
    kwargs = {"scale": SCALE} if proposal == "RandomWalk" else {"initial_scale": 0.05, "adapt_until": 8}
    jprop, tprop = getattr(jinf, proposal)(**kwargs), getattr(tinf, proposal)(**kwargs)
    jk, tk = jprop.build(jctx, None, None, None), tprop.build(tctx, None, None, None)
    _kernels_close(tk, jk)
    x = np.asarray(jctx.stack_parameters(constrained=False))
    frozen = None
    for i in range(11):
        cand = (x + rng.normal(0.0, 0.3, x.shape)).astype(np.float32)
        mask = rng.random(K) < 0.6
        jc, tc = _with_values(jctx, tctx, cand)
        jk = jprop.exchange(jk, jprop.build(jc, None, None, None), jnp.asarray(mask))
        tk = tprop.exchange(tk, tprop.build(tc, None, None, None), _t(mask))
        _kernels_close(tk, jk)
        _close(tk.log_prob(_t(cand)), jk.log_prob(jnp.asarray(cand)))
        x = np.where(mask[:, None], cand, x)
        if proposal == "AdaptiveRandomWalk":
            if i == 7:
                frozen = tk.scale_tril.clone()
            if i > 7:
                assert torch.equal(tk.scale_tril, frozen), "the walk must freeze after adapt_until"
    if proposal == "AdaptiveRandomWalk":
        assert not torch.equal(frozen, 0.05 * torch.eye(2).expand(K, 2, 2)), "the walk must have adapted"
        assert not tk.log_prob(_t(x)).any()


def test_symmetric_mh_exchange_keeps_the_kernel():
    jctx, tctx = _contexts(seed=3)
    state = tinf.SequentialAlgorithmState(torch.zeros(K), None)
    kernel = tinf.SymmetricMH().build(tctx, state, None, None)
    assert tinf.SymmetricMH().exchange(kernel, None, torch.ones(K, dtype=torch.bool)) is kernel


# -- 2. draws of the JAX runs ----------------------------------------------------------------------
def _filter_draws(key, n_steps, lanes):
    """The standard normals and per-lane uniforms a JAX SISR ``batch_filter``
    on the AR model draws from ``key``: the initial cloud, then per step the
    resampling uniforms and the bootstrap proposal's normals."""
    k_init, k_first, k_scan = jax.random.split(key, 3)
    shape = (N, lanes)
    normals = [np.asarray(jax.random.normal(k_init, shape, jnp.float32))]
    uniforms = []
    for k in [k_first] + list(jax.random.split(k_scan, n_steps - 1)):
        keys = jax.random.split(k, 2)
        uniforms.append(np.asarray(jax.random.uniform(keys[0], (lanes,), jnp.float32)))
        normals.append(np.asarray(jax.random.normal(keys[-1], shape, jnp.float32)))
    return normals, uniforms


def _transition_draws(key, n_steps, d=2):
    """A batch-PMMH transition's draws from ``key``: the candidate's
    normals, the re-filter's, the acceptance uniforms."""
    k_sample, k_filter, k_accept, _ = jax.random.split(key, 4)
    normals, uniforms = _filter_draws(k_filter, n_steps, K)
    candidate = np.asarray(jax.random.normal(k_sample, (K, d), jnp.float32))
    return [candidate] + normals, uniforms, np.asarray(jax.random.uniform(k_accept, (K,), jnp.float32))


class _Replay:
    """Feeds the port the JAX run's draws; ``done()`` says whether every one
    was taken."""

    def __init__(self, monkeypatch):
        self.draws = collections.defaultdict(collections.deque)
        replay = self

        def normal(self, generator, sample_shape=()):
            return self.loc + self.scale * replay.take("normal", tuple(sample_shape) + tuple(self.batch_shape))

        def uniform(self, generator, sample_shape=()):
            return self.low + (self.high - self.low) * replay.take("uniform", tuple(sample_shape) + tuple(self.batch_shape))

        monkeypatch.setattr(tdist.Normal, "sample", normal)
        monkeypatch.setattr(tdist.Uniform, "sample", uniform)
        monkeypatch.setattr(pt.SISR, "resample_uniform", lambda f, generator: self.take("lane_u", f.batch_shape))
        monkeypatch.setattr(tmcmc_utils, "_uniform", lambda generator, like: self.take("accept_u", tuple(like.shape)))

    def add(self, kind, arrays):
        self.draws[kind].extend(arrays)

    def take(self, kind, shape):
        z = self.draws[kind].popleft()
        assert z.shape == shape, (kind, z.shape, shape)
        return _t(z)

    def done(self):
        return not any(self.draws.values())


# -- 3. the transition -------------------------------------------------------------------------------
def _filter_result_from_jax(res):
    latest = res.latest_state
    cloud = pt.convert.correction_from_numpy(*(np.asarray(a) for a in (
        latest.x.time_index, latest.x.value, latest.log_weights, latest.log_likelihood, latest.prev_indices,
        latest.mean, latest.variance)), device="cpu")
    return pt.filters.FilterResult(*(_t(np.asarray(a)) for a in (
        res.log_likelihood, res.step_log_likelihoods, res.filter_means, res.filter_variances)), cloud)


def test_run_pmmh_mutate_kernel_replays_jax(y, monkeypatch):
    """Two transitions of ``run_pmmh(mutate_kernel=True)`` with the random
    walk from one context and one filter result: the JAX transition (its
    compiled full-re-filter tier) and the port's with the JAX draws; the
    accept masks, the exchanged kernels, contexts and filter results."""
    jctx, tctx = _contexts(seed=4)
    jfilt = pf.SISR(j_build, N).set_batch_shape((K,)).initialize_model(jctx)
    tfilt = pt.SISR(t_build, N, device="cpu").set_batch_shape((K,)).initialize_model(tctx)
    jres = jfilt.batch_filter(jax.random.PRNGKey(5), jnp.asarray(y))
    jstate, tstate = JFilterState(jres), TFilterState(_filter_result_from_jax(jres))
    jprop, tprop = jinf.RandomWalk(SCALE), tinf.RandomWalk(SCALE)
    jk, tk = jprop.build(jctx, jstate, jfilt, y), tprop.build(tctx, tstate, tfilt, y)
    replay = _Replay(monkeypatch)
    moved = np.zeros(K, bool)
    for i in range(2):
        key = jax.random.PRNGKey(30 + i)
        jstep = jinf.run_pmmh(key, jctx, jstate, jprop, jk, jfilt, jnp.asarray(y), mutate_kernel=True)
        normals, uniforms, accept_u = _transition_draws(key, T)
        replay.add("normal", normals)
        replay.add("lane_u", uniforms)
        replay.add("accept_u", [accept_u])
        tstep = tinf.batch.mcmc.run_pmmh(None, tctx, tstate, tprop, tk, tfilt, y, mutate_kernel=True)
        assert replay.done()
        np.testing.assert_array_equal(tstep.accepted.numpy(), np.asarray(jstep.accepted))
        moved |= tstep.accepted.numpy()
        _kernels_close(tstep.proposal_kernel, jstep.proposal_kernel)
        for constrained in (True, False):
            _close(tstep.context.stack_parameters(constrained), jstep.context.stack_parameters(constrained))
        _close(tstep.filter_state.log_likelihood, jstep.filter_state.log_likelihood)
        _close(tstep.filter_state.filter_means, jstep.filter_state.filter_means)
        jctx, tctx, jk, tk = jstep.context, tstep.context, jstep.proposal_kernel, tstep.proposal_kernel
        jstate, tstate = JFilterState(jstep.filter_state), TFilterState(tstep.filter_state)
    assert moved.any() and not moved.all(), "the transitions must accept some lanes and reject others"


# -- 4. the initializers and whole fits ------------------------------------------------------------
def test_seed_initializer_top_k_matches_jax(y, monkeypatch):
    """``initializer="seed"`` over 12 prior draws with given log-likelihoods
    (ties, NaN, +-inf among them): both packages start the chains at the
    draws the JAX package's reversed stable argsort ranks first."""
    ll = np.asarray([-3.0, np.nan, -1.0, -2.0, np.inf, -1.0, -np.inf, -5.0, -1.5, -1.0, -7.0, -2.0], np.float32)
    want = np.argsort(np.where(np.isfinite(ll), ll, -np.inf), kind="stable")[::-1][:K]
    np.testing.assert_array_equal(tpmmh.top_seeds(_t(ll), K).numpy(), want)

    Result = collections.namedtuple("Result", "log_likelihood")
    seeds = {}
    for lib, filt_cls, ctx_cls, ll_of in ((pf, pf.SISR, jinf.InferenceContext, jnp.asarray),
                                          (pt, pt.SISR, tinf.InferenceContext, _t)):
        clone = ctx_cls._clone_registry
        monkeypatch.setattr(ctx_cls, "_clone_registry", lambda self, _c=clone, _lib=lib: seeds.setdefault(
            _lib.__name__, _c(self)))
        monkeypatch.setattr(filt_cls, "batch_filter", lambda self, *a, _f=ll_of, **kw: Result(_f(ll)))
    jalg = jinf.PMMH(pf.SISR(j_build, N), SAMPLES, num_chains=K, initializer="seed", num_seeds=len(ll),
                     context=jinf.make_context(key=jax.random.PRNGKey(8)), key=jax.random.PRNGKey(9))
    talg = tinf.PMMH(pt.SISR(t_build, N, device="cpu"), SAMPLES, num_chains=K, initializer="seed",
                     num_seeds=len(ll), context=tinf.make_context(device="cpu"), device="cpu")
    for alg, name in ((jalg, "pyfilter_tpu"), (talg, "pyfilter_tpu_torch")):
        alg._filter = alg._filter.initialize_model(alg.context)
        alg._seed_chains(y)
        for param, v in alg.context.parameters.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(seeds[name].parameters[param])[want])


@pytest.mark.parametrize("initializer", ["mean", "seed"])
def test_pmmh_fit_replays_jax(y, initializer, monkeypatch):
    """``PMMH(SISR(build, 50), 5, num_chains=4, RandomWalk(0.08))`` over 20
    observations: the JAX package's per-sample loop (``chunk_size=1``) and
    the port's fit with every JAX draw replayed (module docstring), from the
    initializer's prior draws through the last acceptance; the chains, the
    final filter result and the context."""
    n_seeds = 8
    jalg = jinf.PMMH(pf.SISR(j_build, N), SAMPLES, num_chains=K, proposal=jinf.RandomWalk(SCALE),
                     initializer=initializer, num_seeds=n_seeds, context=jinf.make_context(key=jax.random.PRNGKey(10)),
                     key=jax.random.PRNGKey(11))
    keys = []
    next_key = jalg._next_key
    jalg._next_key = lambda: keys.append(next_key()) or keys[-1]
    jres = jalg.fit(jnp.asarray(y), logging=jinf.logging.DefaultLogger(), chunk_size=1)

    talg = tinf.PMMH(pt.SISR(t_build, N, device="cpu"), SAMPLES, num_chains=K, proposal=tinf.RandomWalk(SCALE),
                     initializer=initializer, num_seeds=n_seeds, context=tinf.make_context(device="cpu"), device="cpu")
    talg.filter.initialize_model(talg.context)  # registers the priors before the replay
    replay = _Replay(monkeypatch)
    order = iter(keys[1:])  # the first key re-seeds the JAX context
    if initializer == "seed":
        replay.add("uniform", [np.asarray(jax.random.uniform(next(order), (n_seeds,), jnp.float32))])
        replay.add("normal", [np.asarray(jax.random.normal(next(order), (n_seeds,), jnp.float32))])
        normals, uniforms = _filter_draws(next(order), T, n_seeds)
    else:
        replay.add("uniform", [np.asarray(jax.random.uniform(next(order), (10_000,), jnp.float32))])
        replay.add("normal", [np.asarray(jax.random.normal(next(order), (10_000,), jnp.float32))])
        normals, uniforms = [], []
    replay.add("normal", normals)
    replay.add("lane_u", uniforms)
    normals, uniforms = _filter_draws(next(order), T, K)
    replay.add("normal", normals)
    replay.add("lane_u", uniforms)
    next(order)  # the proposal's build key (unused by the random walk)
    for _ in range(SAMPLES):
        normals, uniforms, accept_u = _transition_draws(next(order), T)
        replay.add("normal", normals)
        replay.add("lane_u", uniforms)
        replay.add("accept_u", [accept_u])
    assert next(order, None) is None
    tres = talg.fit(y, logging=tinf.logging.DefaultLogger())
    assert replay.done(), "the port must take every draw of the JAX run"

    tchains, jchains = tres.as_arrays(), jres.as_arrays()
    assert list(tchains) == list(jchains) == ["beta", "sigma"]
    for name in tchains:
        assert tchains[name].shape == (SAMPLES + 1, K)
        _close(tchains[name], jchains[name])
    _close(tres.filter_state.log_likelihood, jres.filter_state.log_likelihood)
    _close(talg.context.stack_parameters(True), jalg.context.stack_parameters(True))
    moves = np.diff(tchains["beta"], axis=0) != 0
    assert moves.any() and not moves.all(), "the chains must both accept and reject"


def test_pmmh_entry_points():
    with pytest.raises(NotImplementedError):
        tinf.PMMH(pt.SISR(t_build, N, device="cpu"), 2, initializer="prior", context=tinf.make_context(device="cpu"),
                  device="cpu")
    alg = tinf.PMMH(pt.SISR(t_build, N, device="cpu"), 2, num_chains=3, num_seeds=2,
                    context=tinf.make_context(device="cpu"), device="cpu")
    assert isinstance(alg._proposal, tinf.RandomWalk) and alg._num_seeds == 3
    assert alg.filter.batch_shape == (3,) and alg.context.batch_shape == (3,)
    logger = tinf.logging.TQDMWrapper()
    with logger.initialize(alg, 2):
        logger.do_log(1, None)
    assert logger._tqdm is None


# -- 5. the repaired faults ------------------------------------------------------------------------
def test_sisr_past_the_fused_size_limit_takes_the_resampler(monkeypatch):
    """A single-lane SISR at N = 2^24 particles, two observations: the fused
    kernel's limit, so the filter resamples through its resampler and a
    gather (as the JAX package routes it) and returns a finite
    log-likelihood. The fused route is poisoned to show it is not taken."""

    def poisoned(*args, **kwargs):
        raise AssertionError("the fused resample must not run at N >= 2^24")

    monkeypatch.setattr(tparticle_base, "systematic_expand", poisoned)
    model = pt.timeseries.LinearStateSpaceModel(tmodels.AR(0.0, BETA, SIGMA, device="cpu"), (1.0, OBS_SCALE))
    filt = pt.SISR(model, 1 << 24, ess_threshold=1.0 + 1e-6, record_moments=False, device="cpu")
    assert not filt._use_fused_resample(torch.zeros(1))
    assert pt.SISR(model, (1 << 24) - 1, device="cpu")._use_fused_resample(torch.zeros(1))
    res = filt.batch_filter(torch.Generator().manual_seed(0), np.asarray([0.1, -0.2], np.float32))
    assert filt.n_resamples == 2 and math.isfinite(float(res.log_likelihood))


@pytest.mark.parametrize("entire_history", [True, False])
def test_filter_result_resample_matches_jax(entire_history):
    """``FilterResult.resample`` over 3 lanes: with ``entire_history=False``
    only the latest state and the log-likelihood move."""
    rng = np.random.default_rng(12)
    n, lanes, steps = 6, 3, 4
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((lanes,), (steps, lanes), (steps, lanes), (steps, lanes))]
    x, lw = rng.normal(size=(n, lanes)).astype(np.float32), rng.normal(size=(n, lanes)).astype(np.float32)
    ll, prev = rng.normal(size=lanes).astype(np.float32), rng.integers(0, n, (n, lanes)).astype(np.int32)
    jcloud = JCorrection.from_weighted_particles(JState(jnp.asarray(2.0), jnp.asarray(x)), jnp.asarray(lw),
                                                 jnp.asarray(ll), jnp.asarray(prev))
    jres = JFilterResult(*(jnp.asarray(a) for a in leaves), jcloud)
    tres = pt.filters.FilterResult(*(_t(a) for a in leaves), pt.convert.correction_from_numpy(
        np.float32(2.0), x, lw, ll, prev, np.asarray(jcloud.mean), np.asarray(jcloud.variance), device="cpu"))
    idx = np.asarray([2, 0, 2], np.int32)
    got = tres.resample(_t(idx), entire_history=entire_history)
    want = jres.resample(jnp.asarray(idx), entire_history=entire_history)
    for name in ("log_likelihood", "step_log_likelihoods", "filter_means", "filter_variances"):
        _close(getattr(got, name), getattr(want, name))
    _close(got.latest_state.x.value, want.latest_state.x.value)
    _close(got.latest_state.log_weights, want.latest_state.log_weights)
    np.testing.assert_array_equal(got.latest_state.prev_indices.numpy(), np.asarray(want.latest_state.prev_indices))
    if not entire_history:
        assert got.step_log_likelihoods is tres.step_log_likelihoods


# -- the port's phase-11 fit on the CPU -------------------------------------------------------------
def _rehearse(args):
    """One of ``chip_smoke.py``'s phase-11 PMMH fits on the CPU (seed
    ``seed``), with ``mutation``: ``"jacobian"`` evaluates the priors on the
    constrained space where the transition asks for the unconstrained one
    (no Jacobian), ``"exchange"`` keeps the random walk's kernel where it
    started. Returns the wall seconds, each chain's acceptance rate, the
    pooled post-burn-in (mean, sd) by name, and the transition gate's failure
    (None where it passes)."""
    seed, mutation = args
    import chip_smoke

    torch.set_num_threads(2)
    if mutation == "jacobian":
        eval_priors = tinf.InferenceContext.eval_priors
        tinf.InferenceContext.eval_priors = lambda self, constrained=True: eval_priors(self, True)
    elif mutation == "exchange":
        tinf.RandomWalk.exchange = lambda self, latest, candidate, mask: latest
    y = chip_smoke.pmmh_data(torch, pt)
    alg, state, _, _, wall, _, accept, pooled = chip_smoke.pmmh_fit(torch, pt, y, "cpu", seed)
    try:
        chip_smoke.pmmh_transition_gate(torch, alg, state, y, "cpu")
        failure = None
    except AssertionError as e:
        failure = str(e)
    return wall, accept.tolist(), pooled, failure


def pmmh_rehearsals(seeds, mutation: str, workers: int):
    """Phase 11's PMMH fit on the CPU over ``seeds`` in ``workers``
    processes: each fit's pooled means against the exact grid posterior in
    posterior sds (the gate of ``chip_smoke.PMMH_TOL_SD``) and the largest
    gap; and whether each fit passes ``chip_smoke.pmmh_transition_gate``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import chip_smoke

    exact = chip_smoke.ar_grid_posterior(chip_smoke.pmmh_data(torch, pt))
    print(f"exact posterior (mean, sd) {exact}; without the Jacobian "
          f"{chip_smoke.ar_grid_posterior(chip_smoke.pmmh_data(torch, pt), jacobian=False)}", flush=True)
    worst, failed = 0.0, 0
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        for seed, (wall, accept, pooled, failure) in zip(seeds, pool.map(_rehearse, [(s, mutation) for s in seeds])):
            gaps = {n: (pooled[n][0] - exact[n][0]) / exact[n][1] for n in pooled}
            worst = max(worst, *(abs(g) for g in gaps.values()))
            failed += failure is not None
            print(f"{mutation} seed {seed}: {wall:.1f} s; acceptance per chain {accept}; pooled (mean, sd) {pooled}; "
                  f"gap / posterior sd {gaps}; transition gate {'fails: ' + failure if failure else 'passes'}",
                  flush=True)
    print(f"{mutation}: largest |gap| over {len(seeds)} fits {worst} posterior sd; the transition gate fails on "
          f"{failed} of {len(seeds)}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_port_pmmh.py [--mutation none|jacobian|exchange] [--workers 4] SEED ...
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--mutation", choices=("none", "jacobian", "exchange"), default="none")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("seeds", type=int, nargs="+")
    args = parser.parse_args()
    pmmh_rehearsals(args.seeds, args.mutation, args.workers)
