"""The port's SMC² stack held against the JAX package: priors, the context's
stack and lane surgery, the proposal MVN, the Cholesky fallback, the
parameter-lane resampler and one PMMH acceptance on the same numbers; then
the port's own SMC² fit (statistical), its particle doubling and its device
rule.

Both contexts are built by each package's ``stochastic_volatility_builder``
and carry the same parameter values (written across with
``pyfilter_tpu_torch.convert.set_context_values``). Tolerances: rel 1e-5 on
densities, moments and Cholesky factors (float32 arithmetic in two
frameworks; the BASELINE.md gate), rel 1e-6 on values that one package
copies from the other (the accepted PMMH lanes), indices and accept masks
exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu_torch as pt
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import examples as jexamples
from pyfilter_tpu import inference as jinf
from pyfilter_tpu import resampling as jresampling
from pyfilter_tpu.filters.state import ParticleFilterCorrection as JCorrection
from pyfilter_tpu.inference.batch.mcmc.proposals import SymmetricMH as JSymmetricMH
from pyfilter_tpu.inference.state import SequentialAlgorithmState as JSeqState
from pyfilter_tpu.timeseries import TimeseriesState as JState
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch import resampling as tresampling
from pyfilter_tpu_torch.inference.batch.mcmc import SymmetricMH, pmmh_accept
from pyfilter_tpu_torch.ops import expand as texpand

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

K = 16
TRUE = dict(kappa=0.1, gamma=1.0, sigma=0.05, mu=0.0, nu=0.0, tau=1.0)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _contexts(seed=0, k=K):
    """A JAX context and a port context with the SV builder's six priors and
    the same values (the JAX context's prior draws)."""
    jctx = jinf.make_context(key=jax.random.PRNGKey(seed))
    jctx.set_batch_shape((k,))
    jexamples.stochastic_volatility_builder(jctx)
    tctx = tinf.make_context(device="cpu")
    tctx.set_batch_shape((k,))
    pt.examples.stochastic_volatility_builder(tctx)
    pt.convert.set_context_values(tctx, {n: np.asarray(v) for n, v in jctx.parameters.items()})
    return jctx, tctx


def _simulate(n_obs, seed=0, dt=0.2):
    """SV observations from the true parameters (numpy)."""
    rng = np.random.default_rng(seed)
    vol, ys = TRUE["gamma"], []
    for _ in range(n_obs):
        for _ in range(int(1.0 / dt)):
            vol = vol + TRUE["kappa"] * (TRUE["gamma"] - vol) * vol * dt + TRUE["sigma"] * vol * math.sqrt(dt) * rng.normal()
        ys.append(TRUE["mu"] + vol * math.sinh((math.asinh(rng.normal()) + TRUE["nu"]) * TRUE["tau"]))
    return np.asarray(ys, np.float32)


def test_priors_and_stacking_match_jax():
    jctx, tctx = _contexts()
    assert list(tctx.parameters) == list(jctx.parameters)
    for constrained in (True, False):
        np.testing.assert_allclose(tctx.eval_priors(constrained).numpy(),
                                   np.asarray(jctx.eval_priors(constrained)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tctx.stack_parameters(constrained).numpy(),
                                   np.asarray(jctx.stack_parameters(constrained)), rtol=1e-5, atol=1e-6)
        stacked = tctx.stack_parameters(constrained)
        back = tctx.unstack_parameters(stacked, constrained=constrained)
        for name, v in tctx.parameters.items():
            np.testing.assert_allclose(back.parameters[name].numpy(), v.numpy(), rtol=1e-6)
    with pytest.raises(ValueError):
        tctx.unstack_parameters(torch.zeros(K, 5))


def test_mvn_fit_log_prob_and_sample_match_jax():
    _, tctx = _contexts(seed=1)
    x = tctx.stack_parameters(constrained=False)
    w = tdist.Normal(torch.tensor(0.0), torch.tensor(1.0)).sample(torch.Generator().manual_seed(3), (K,))
    w = torch.softmax(w, 0)
    tmvn = tinf.construct_mvn(x, w, scale=1.1)
    jmvn = jinf.construct_mvn(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), scale=1.1)
    np.testing.assert_allclose(tmvn.loc.numpy(), np.asarray(jmvn.loc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tmvn.scale_tril.numpy(), np.asarray(jmvn.scale_tril), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tmvn.log_prob(x).numpy(), np.asarray(jmvn.log_prob(jnp.asarray(x.numpy()))),
                               rtol=1e-5, atol=1e-4)
    # a sample from given standard-normal draws: the port's generator makes
    # them, the JAX package applies its own formula to the same draws
    eps = torch.randn((K, 6), generator=torch.Generator().manual_seed(4))
    got = tmvn.sample(torch.Generator().manual_seed(4), (K,))
    want = jmvn.loc + jnp.einsum("...ij,...j->...i", jmvn.scale_tril, jnp.asarray(eps.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_robust_cholesky_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(4, 4)).astype(np.float32)
    pd = a @ a.T + 0.5 * np.eye(4, dtype=np.float32)
    not_pd = np.diag([2.0, -1.0, 3.0, 0.5]).astype(np.float32)
    for cov in (pd, not_pd, np.stack([pd, not_pd])):
        np.testing.assert_allclose(tdist.robust_cholesky(_t(cov)).numpy(),
                                   np.asarray(jdist.robust_cholesky(jnp.asarray(cov))), rtol=1e-5, atol=1e-6)
    assert torch.isfinite(tdist.robust_cholesky(_t(not_pd))).all()


@pytest.mark.parametrize("batch", [(), (3,)])
def test_systematic_resampler_matches_jax(batch):
    rng = np.random.default_rng(6)
    lw = rng.normal(0.0, 2.0, (256, *batch)).astype(np.float32)
    u = rng.uniform(size=batch).astype(np.float32)
    want = np.asarray(jresampling.systematic(None, jnp.asarray(lw), u=jnp.asarray(u)))
    got = tresampling.systematic(None, _t(lw), u=_t(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _corrections(seed, n=12, k=K):
    """One lane-batched correction in both packages from the same numbers."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.5, 1.5, (n, k)).astype(np.float32)
    lw = rng.normal(size=(n, k)).astype(np.float32)
    ll = rng.normal(size=k).astype(np.float32)
    prev = rng.integers(0, n, (n, k)).astype(np.int32)
    jc = JCorrection.from_weighted_particles(JState(jnp.asarray(3.0), jnp.asarray(vals)), jnp.asarray(lw),
                                            jnp.asarray(ll), jnp.asarray(prev))
    tc = pt.convert.correction_from_numpy(*(np.asarray(a) for a in (
        jc.x.time_index, jc.x.value, jc.log_weights, jc.log_likelihood, jc.prev_indices, jc.mean, jc.variance
    )), device="cpu")
    return jc, tc


def _assert_same_correction(tc, jc):
    for a, b in zip((tc.x.value, tc.log_weights, tc.log_likelihood, tc.prev_indices, tc.mean, tc.variance),
                    (jc.x.value, jc.log_weights, jc.log_likelihood, jc.prev_indices, jc.mean, jc.variance)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_lane_surgery_matches_jax():
    jctx, tctx = _contexts(seed=2)
    other_j, other_t = _contexts(seed=3)
    idx = np.random.default_rng(7).integers(0, K, K).astype(np.int32)
    mask = np.random.default_rng(8).uniform(size=K) < 0.5
    for tnew, jnew in ((tctx.resample(_t(idx)), jctx.resample(jnp.asarray(idx))),
                       (tctx.exchange(other_t, _t(mask)), jctx.exchange(other_j, jnp.asarray(mask)))):
        for name in tctx.parameters:
            np.testing.assert_array_equal(tnew.parameters[name].numpy(), np.asarray(jnew.parameters[name]))

    (jc, tc), (jo, to) = _corrections(9), _corrections(10)
    _assert_same_correction(tc.resample(_t(idx)), jc.resample(jnp.asarray(idx)))
    _assert_same_correction(tc.exchange(to, _t(mask)), jc.exchange(jo, jnp.asarray(mask)))


def test_one_pmmh_acceptance_matches_jax():
    """One PMMH transition's arithmetic on the same context, candidate,
    per-lane log-likelihoods and log-uniforms (JAX side composed as its
    transition body does)."""
    jctx, tctx = _contexts(seed=4)
    rng = np.random.default_rng(11)
    w = rng.normal(size=K).astype(np.float32)
    ll_old = rng.normal(-50.0, 2.0, K).astype(np.float32)
    ll_new = (ll_old + rng.normal(0.0, 1.0, K)).astype(np.float32)
    log_u = np.log(rng.uniform(size=K)).astype(np.float32)

    jkernel = JSymmetricMH().build(jctx, JSeqState(jnp.asarray(w), None), None, None)
    rvs = np.asarray(jkernel.sample(jax.random.PRNGKey(12), (K,)))
    jprop = jctx.unstack_parameters(jnp.asarray(rvs), constrained=False)
    jnew_kernel = JSymmetricMH().build(jprop, JSeqState(jnp.zeros(K), None), None, None)
    log_acc = (jnew_kernel.log_prob(jctx.stack_parameters(constrained=False)) - jkernel.log_prob(jnp.asarray(rvs))
               + jprop.eval_priors(constrained=False) - jctx.eval_priors(constrained=False)
               + jnp.asarray(ll_new - ll_old))
    j_accept = np.asarray(jnp.asarray(log_u) < log_acc)
    assert 0 < j_accept.sum() < K, "the case must accept some lanes and reject others"
    j_ctx_new = jctx.exchange(jprop, jnp.asarray(j_accept))

    (_, old), (_, new) = _corrections(13), _corrections(14)
    state = tinf.SequentialAlgorithmState(_t(w), tinf.RunningFilterResult(old, _t(ll_old)))
    tkernel = SymmetricMH().build(tctx, state, None, None)
    tprop = tctx.unstack_parameters(_t(rvs), constrained=False)
    new_res = pt.FilterResult(_t(ll_new), None, None, None, new)
    # SymmetricMH's candidate-side build reads neither the candidate's filter
    # nor the observations nor the generator (as the JAX side's, given None)
    step = pmmh_accept(tctx, state, SymmetricMH(), tkernel, _t(rvs), tprop, None, new_res, _t(log_u), None, None)

    np.testing.assert_array_equal(step.accepted.numpy(), j_accept)
    for name in tctx.parameters:
        np.testing.assert_allclose(step.context.parameters[name].numpy(), np.asarray(j_ctx_new.parameters[name]),
                                   rtol=1e-6)
    np.testing.assert_allclose(step.filter_state.log_likelihood.numpy(), np.where(j_accept, ll_new, ll_old),
                               rtol=1e-6)
    np.testing.assert_array_equal(step.filter_state.latest_state.x.value.numpy(),
                                  np.where(j_accept[None], new.x.value.numpy(), old.x.value.numpy()))


def test_smc2_on_the_port_recovers_the_volatility_level():
    """SMC² (APF 200 state particles x 256 parameter lanes, two PMMH steps
    per rejuvenation) on 150 observations simulated from the true
    parameters, on the CPU: finite weights, at least one rejuvenation, every
    APF correction through the fused lane resample, and the posterior means
    inside the JAX package's bounds (tests/test_examples.py:79-82)."""
    y = _simulate(150, seed=15)
    ctx = tinf.make_context(generator=torch.Generator().manual_seed(1), device="cpu")
    filt = pt.APF(pt.examples.stochastic_volatility_builder, 200, record_moments=False, device="cpu")
    alg = tinf.SMC2(filt, 256, num_steps=2, context=ctx, generator=torch.Generator().manual_seed(2),
                    record_moments=False, device="cpu")
    state = alg.fit(y, logging=tinf.logging.DefaultLogger())

    w = state.normalized_weights()
    assert torch.isfinite(state.w).all() and torch.isfinite(w).all()
    assert alg.kernel.n_transitions > 0
    est = dict(zip(ctx.parameters, (w @ ctx.stack_parameters(constrained=True)).tolist()))
    assert 0.3 < est["gamma"] < 3.0, est
    assert 0.5 < est["tau"] < 2.0, est
    # one trigger read per observation, one acceptance read per transition,
    # one health read at the end
    assert alg.n_host_syncs == len(y) + 1 and alg.kernel.n_host_syncs == alg.kernel.n_transitions


def test_smc2_particle_doubling(monkeypatch):
    """Few state particles and an acceptance threshold no rate can reach
    force the doubling path (JAX tests/test_inference.py:441-460): the fit
    raises ``TooManyIncreases`` after doubling 5 -> 20, and every doubled
    re-filter still resamples through the lane expansion."""
    lane_calls = []
    real = texpand.systematic_expand_lanes
    monkeypatch.setattr("pyfilter_tpu_torch.filters.particle.base.systematic_expand_lanes",
                        lambda *a, **kw: lane_calls.append(a[1].shape[0]) or real(*a, **kw))
    monkeypatch.setattr(pt.APF, "corrections", 0)
    y = _simulate(60, seed=16)
    ctx = tinf.make_context(generator=torch.Generator().manual_seed(1), device="cpu")
    filt = pt.APF(pt.examples.stochastic_volatility_builder, 5, device="cpu")
    alg = tinf.SMC2(filt, 64, context=ctx, generator=torch.Generator().manual_seed(2), device="cpu")
    alg.kernel._acceptance_threshold = 1.01
    alg.kernel._max_increases = 2
    with pytest.raises(tinf.TooManyIncreases):
        alg.fit(y)
    assert alg.filter.n_particles == 20 and alg.kernel.n_doublings == 2
    assert len(lane_calls) == pt.APF.corrections > 0
    assert {5, 10, 20} <= set(lane_calls)


def test_entry_points_default_to_the_card():
    """Without a CUDA device the entry points raise unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinf.make_context()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.APF(pt.examples.stochastic_volatility_builder, 8)
    ctx = tinf.make_context(device="cpu")
    filt = pt.APF(pt.examples.stochastic_volatility_builder, 8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinf.SMC2(filt, 4, context=ctx)
    tinf.SMC2(filt, 4, context=ctx, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.examples.lorenz63_model()
    lorenz = pt.SISR(pt.examples.lorenz63_builder, 8, device="cpu")
    for make in (tinf.NESS, tinf.FixedWidthNESS, lambda *a, **kw: tinf.NESSMC2(*a, switch=5, **kw),
                 lambda *a, **kw: tinf.SMC2FW(*a, switch=5, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(lorenz, 4, context=ctx)
        make(lorenz, 4, context=ctx, device="cpu")
