"""The port's gradient-based PMMH, held against the JAX package: the PMMH
transition that builds the candidate's kernel from the candidate's filter,
the observations and a generator (repaired here: it built it from neither),
``GradientBasedProposal`` of both orders, and one transition of each
deciding as the JAX package's does.

The model is the JAX package's inference test model (``tests/
test_inference.py``): an Ornstein-Uhlenbeck process with kappa ~ Exp(1),
gamma ~ N(0, 1), sigma ~ LogNormal(-2, 1), observed with noise 0.05, under
``APF(LinearGaussianObservations(), record_states=True)``. Both packages
start from the JAX context's values (``convert.set_context_values``) and the
JAX filter's recorded history (``convert.history_from_numpy``); the FFBS
pass inside the proposal's build draws through the port's seams
``filters.particle.base.trajectory_ends`` (the JAX resampler's indices) and
``gumbel`` (the JAX key's Gumbel noise, ``jax.random.categorical`` being
``argmax(logits + gumbel)``).

Tolerances: the first-order kernel's loc rel 1e-5 (abs 1e-6): one gradient
of float32 sums; the second-order loc and Cholesky factor rel 1e-4 (abs
1e-5): through a 3 x 3 eigendecomposition and its inverse; accept masks
exact.
"""

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
from pyfilter_tpu.filters.particle import proposals as jprops
from pyfilter_tpu.inference.state import FilterAlgorithmState as JState
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch import timeseries as tts
from pyfilter_tpu_torch.filters.particle import base as tbase
from pyfilter_tpu_torch.filters.particle.proposals import LinearGaussianObservations
from pyfilter_tpu_torch.inference.batch.mcmc import utils as tmcmc

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N, K, T = 40, 3, 20


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


def j_build(ctx):
    k = ctx.named_parameter("kappa", jdist.Exponential(1.0))
    g = ctx.named_parameter("gamma", jdist.Normal(0.0, 1.0))
    s = ctx.named_parameter("sigma", jdist.LogNormal(-2.0, 1.0))
    return jts.LinearStateSpaceModel(jts.models.OrnsteinUhlenbeck(k, g, s), (1.0, 0.05))


def t_build(ctx):
    c = lambda v: torch.tensor(v, device=ctx.device)  # noqa: E731
    k = ctx.named_parameter("kappa", tdist.Exponential(c(1.0)))
    g = ctx.named_parameter("gamma", tdist.Normal(c(0.0), c(1.0)))
    s = ctx.named_parameter("sigma", tdist.LogNormal(c(-2.0), c(1.0)))
    return tts.LinearStateSpaceModel(tts.models.OrnsteinUhlenbeck(k, g, s, device=ctx.device), (1.0, 0.05))


@pytest.fixture(scope="module")
def y():
    true = tts.LinearStateSpaceModel(tts.models.OrnsteinUhlenbeck(0.5, 1.0, 0.1, device="cpu"), (1.0, 0.05))
    return true.sample_states(torch.Generator().manual_seed(5), T).get_paths()[1].numpy()


@pytest.fixture(scope="module")
def setup(y):
    """The JAX context, filter and recorded run, and the port's context and
    filter on the same parameter values."""
    jctx = jinf.make_context(key=jax.random.PRNGKey(1))
    jctx.set_batch_shape((K,))
    jfilt = pf.APF(j_build, N, proposal=jprops.LinearGaussianObservations(), record_states=True)
    jfilt = jfilt.set_batch_shape((K,)).initialize_model(jctx)
    jres = jfilt.batch_filter(jax.random.PRNGKey(2), jnp.asarray(y))

    tctx = tinf.make_context(device="cpu")
    tctx.set_batch_shape((K,))
    tfilt = pt.APF(t_build, N, proposal=LinearGaussianObservations(), record_states=True, device="cpu")
    tfilt = tfilt.set_batch_shape((K,)).initialize_model(tctx)
    pt.convert.set_context_values(tctx, {k: np.asarray(v) for k, v in jctx.parameters.items()})
    tfilt = tfilt.initialize_model(tctx)
    return jctx, jfilt, jres, tctx, tfilt


def _port_result(jres):
    """The port's ``FilterResult`` from the JAX package's, history included."""
    h, s = jres.states, jres.latest_state
    latest = pt.convert.correction_from_numpy(
        *(np.asarray(a) for a in (s.x.time_index, s.x.value, s.log_weights, s.log_likelihood, s.prev_indices,
                                  s.mean, s.variance)), device="cpu")
    return pt.FilterResult(*(torch.from_numpy(np.array(a)) for a in (
        jres.log_likelihood, jres.step_log_likelihoods, jres.filter_means, jres.filter_variances)), latest,
        pt.convert.history_from_numpy(*(np.asarray(a) for a in h), device="cpu"))


def _replay_ffbs(monkeypatch, jfilt, jres, key):
    """Make the port's next FFBS pass over ``jres``'s history draw what the
    JAX package's ``smooth(key, jres, "ffbs")`` draws."""
    log_w = jres.states.log_weights
    k_last, k_scan = jax.random.split(key)
    idx_last = torch.from_numpy(np.array(jfilt.resampler(k_last, log_w[-1])))
    keys = jax.random.split(k_scan, log_w.shape[0] - 1)
    shape = (N,) + tuple(log_w.shape[2:]) + (N,)
    noise = iter([torch.from_numpy(np.array(jax.random.gumbel(keys[t], shape, jnp.float32)))
                  for t in range(log_w.shape[0] - 2, -1, -1)])
    monkeypatch.setattr(tbase, "trajectory_ends", lambda generator, resampler, lw, n: idx_last)
    monkeypatch.setattr(tbase, "gumbel", lambda generator, shape_, like: next(noise))


@pytest.mark.parametrize("second_order", [False, True])
def test_gradient_proposal_build_matches_jax(second_order, setup, y, monkeypatch):
    jctx, jfilt, jres, tctx, tfilt = setup
    scale = 5e-2 if second_order else 2e-2
    key = jax.random.PRNGKey(3)
    jk = jinf.GradientBasedProposal(scale, use_second_order=second_order).build(
        jctx, JState(jres), jfilt, jnp.asarray(y), key=key)
    _replay_ffbs(monkeypatch, jfilt, jres, key)
    tk = tinf.GradientBasedProposal(scale, use_second_order=second_order).build(
        tctx, tinf.state.FilterAlgorithmState(_port_result(jres)), tfilt, y, None)
    if not second_order:
        assert isinstance(tk, tdist.Independent)
        _close(tk.base_dist.loc, jk.base_dist.loc, rtol=1e-5, atol=1e-6)
        _close(tk.base_dist.scale, jk.base_dist.scale, rtol=0, atol=0)
        # the drift moved the kernel off the current parameters
        assert float((tk.base_dist.loc - tctx.stack_parameters(constrained=False)).abs().max()) > 1e-4
    else:
        assert isinstance(tk, tdist.MultivariateNormal)
        _close(tk.loc, jk.loc, rtol=1e-4, atol=1e-5)
        _close(tk.scale_tril, jk.scale_tril, rtol=1e-4, atol=1e-5)


def test_gradient_proposal_needs_a_recorded_history(setup, y):
    _, _, _, tctx, tfilt = setup
    res = tfilt.replace(record_states=False).batch_filter(torch.Generator().manual_seed(0), y)
    with pytest.raises(ValueError, match="record_states"):
        tinf.GradientBasedProposal().build(tctx, tinf.state.FilterAlgorithmState(res), tfilt, y, None)


def test_second_order_lane_with_a_non_finite_hessian_is_nan(setup, y, monkeypatch):
    """torch's ``eigh`` raises on a non-finite matrix where JAX's gives NaN:
    such a lane's kernel is NaN, the other lanes' finite."""
    _, _, _, tctx, tfilt = setup
    res = tfilt.batch_filter(torch.Generator().manual_seed(0), y)
    from pyfilter_tpu_torch.inference.batch.mcmc import proposals as tprops

    real = tprops._per_particle_hessian

    def poisoned(grad_fn, x, event_ndim):
        h = real(grad_fn, x, event_ndim)
        h[1, 0, 0] = float("nan")
        return h

    monkeypatch.setattr(tprops, "_per_particle_hessian", poisoned)
    kernel = tinf.GradientBasedProposal(5e-2, use_second_order=True).build(
        tctx, tinf.state.FilterAlgorithmState(res), tfilt, y, torch.Generator().manual_seed(1))
    assert bool(torch.isnan(kernel.loc[1]).all()) and bool(torch.isfinite(kernel.loc[[0, 2]]).all())


def test_pmmh_accept_builds_the_candidate_kernel_from_the_candidate(setup, y, monkeypatch):
    """The candidate's kernel (whose density at the current parameters is the
    reverse move's) is built on the candidate's context AND the filter built
    on it, the observations and the transition's generator; the draws come
    in the order candidate, re-filter, acceptance uniforms, build. The call
    before the repair passed no filter and no observations, which the
    gradient proposal cannot build from (it raised)."""
    _, _, _, tctx, tfilt = setup
    gen = torch.Generator().manual_seed(4)
    state = tinf.state.FilterAlgorithmState(tfilt.batch_filter(gen, y))
    prop = tinf.GradientBasedProposal(2e-2)
    kernel = prop.build(tctx, state, tfilt, y, gen)
    seen, order = [], []
    build, uniform = prop.build, tmcmc._uniform

    def spy_build(context, state_, filter_, y_, generator):
        seen.append((context, filter_, y_, generator))
        order.append("build")
        return build(context, state_, filter_, y_, generator)

    monkeypatch.setattr(prop, "build", spy_build)
    monkeypatch.setattr(tmcmc, "_uniform", lambda g, like: order.append("uniform") or uniform(g, like))
    step = tmcmc.run_pmmh(gen, tctx, state, prop, kernel, tfilt, y, mutate_kernel=True)
    (context, filter_, y_, generator), = seen
    assert order == ["uniform", "build"]
    assert generator is gen and y_ is y
    assert filter_ is not tfilt and filter_.model.hidden.parameters[0] is context.get_parameter("kappa")
    assert torch.isfinite(step.proposal_kernel.base_dist.loc).all()


@pytest.mark.parametrize("second_order", [False, True])
def test_pmmh_transition_decides_as_jax(second_order, setup, y, monkeypatch):
    """One PMMH transition (``mutate_kernel=True``) on the JAX package's draws:
    its candidate, re-filter and log-uniforms, and its kernel builds' FFBS
    draws, fed to the port's ``pmmh_accept``. The same lanes accept, the
    contexts and the exchanged kernels agree."""
    jctx, jfilt, jres, tctx, tfilt = setup
    scale = 5e-2 if second_order else 2e-2
    jprop = jinf.GradientBasedProposal(scale, use_second_order=second_order)
    tprop = tinf.GradientBasedProposal(scale, use_second_order=second_order)
    jstate, k0, key = JState(jres), jax.random.PRNGKey(6), jax.random.PRNGKey(7)
    jkernel = jprop.build(jctx, jstate, jfilt, jnp.asarray(y), key=k0)
    jstep = jinf.run_pmmh(key, jctx, jstate, jprop, jkernel, jfilt, jnp.asarray(y), mutate_kernel=True)

    # the transition's own draws, by its key schedule
    k_sample, k_filter, k_accept, k_build = jax.random.split(key, 4)
    rvs = jkernel.sample(k_sample, ())
    jpctx = jctx.unstack_parameters(rvs, constrained=False)
    jpfilt = jfilt.initialize_model(jpctx)
    jnew = jpfilt.batch_filter(k_filter, jnp.asarray(y))
    log_u = jnp.log(jax.random.uniform(k_accept, jnew.log_likelihood.shape))

    tstate = tinf.state.FilterAlgorithmState(_port_result(jres))
    _replay_ffbs(monkeypatch, jfilt, jres, k0)
    tkernel = tprop.build(tctx, tstate, tfilt, y, None)
    trvs = torch.from_numpy(np.asarray(rvs))
    tpctx = tctx.unstack_parameters(trvs, constrained=False)
    tpfilt = tfilt.initialize_model(tpctx)
    _replay_ffbs(monkeypatch, jfilt, jnew, k_build)
    tstep = tmcmc.pmmh_accept(tctx, tstate, tprop, tkernel, trvs, tpctx, tpfilt, _port_result(jnew),
                              torch.from_numpy(np.asarray(log_u)), y, None, mutate_kernel=True)

    np.testing.assert_array_equal(tstep.accepted.numpy(), np.asarray(jstep.accepted))
    _close(tstep.context.stack_parameters(constrained=False), jstep.context.stack_parameters(constrained=False),
           rtol=1e-5, atol=1e-6)
    tk, jk = tstep.proposal_kernel, jstep.proposal_kernel
    if second_order:
        _close(tk.loc, jk.loc, rtol=1e-4, atol=1e-5)
    else:
        _close(tk.base_dist.loc, jk.base_dist.loc, rtol=1e-5, atol=1e-6)


def test_pmmh_fit_with_gradient_proposals_on_cpu(y):
    """Short ``PMMH.fit`` runs of both orders and the random walk: finite
    chains that move, and the chain diagnostics on them."""
    moved = {}
    for name, prop in (("first", tinf.GradientBasedProposal(2e-2)),
                       ("second", tinf.GradientBasedProposal(5e-2, use_second_order=True)),
                       ("rw", tinf.RandomWalk(2e-2))):
        ctx = tinf.make_context(generator=torch.Generator().manual_seed(1), device="cpu")
        alg = tinf.PMMH(pt.APF(t_build, N, proposal=LinearGaussianObservations(), record_states=True, device="cpu"),
                        8, num_chains=2, proposal=prop, context=ctx, generator=torch.Generator().manual_seed(2),
                        device="cpu")
        res = alg.fit(y, logging=tinf.logging.DefaultLogger())
        arr = res.as_arrays()
        assert all(np.isfinite(v).all() and v.shape == (9, 2) for v in arr.values())
        moved[name] = sum(float(np.abs(np.diff(v, axis=0)).sum()) for v in arr.values())
        summary = tinf.summarize_chains(res)
        assert set(summary) == {"kappa", "gamma", "sigma"}
    assert all(m > 0 for m in moved.values()), moved
