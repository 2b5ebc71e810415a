"""The port's waste-free SMC² rejuvenation, held against the JAX package.

One waste-free rejuvenation (``ParticleMetropolisHastings(num_steps=3,
waste_free=True)``: 8 chain roots of 32 lanes of APF(16), three PMMH
transitions over 8 observations of the stochastic-volatility model) from one
cloud and one context in both packages, the port taking the JAX run's
draws: the roots' uniform (``mh.systematic_m``), the candidates' normals
(``MultivariateNormal.sample``), each re-filter's normals and per-lane
uniforms (``Normal.sample``, ``APF.resample_uniform``) and the acceptance
uniforms (``batch.mcmc.utils._uniform``), recomputed from the JAX key
schedule. The roots exactly, the swarm, its log-likelihoods and its cloud
within rel 1e-5. Then the three refusals, and the abort path, which
doubles the particles and re-filters at all 32 lanes.

Run as a script, the file fits phase 16b's configuration with the JAX
package (the source of ``chip_smoke.WF_JAX``):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_waste_free.py [--workers 4] SEED ...
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import examples as jexamples
from pyfilter_tpu import inference as jinf
from pyfilter_tpu import resampling as jresampling
from pyfilter_tpu.inference.sequential.kernels import mh as jmh
from pyfilter_tpu.inference.state import RunningFilterResult as JRunning
from pyfilter_tpu.inference.state import SMC2State as JSMC2State
from pyfilter_tpu.utils import normalize as jnormalize
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch import resampling as tresampling
from pyfilter_tpu_torch.inference.batch.mcmc import utils as tmcmc_utils
from pyfilter_tpu_torch.inference.sequential.kernels import mh as tmh
from test_torch_port_quasi import _apf_draws

torch.set_num_threads(1)

N, K, T, STEPS = 16, 32, 8, 3
M = K // (STEPS + 1)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


def _contexts(seed):
    jctx = jinf.make_context(key=jax.random.PRNGKey(seed))
    jctx.set_batch_shape((K,))
    jexamples.stochastic_volatility_builder(jctx)
    tctx = tinf.make_context(device="cpu")
    tctx.set_batch_shape((K,))
    pt.examples.stochastic_volatility_builder(tctx)
    pt.convert.set_context_values(tctx, {n: np.asarray(v) for n, v in jctx.parameters.items()})
    return jctx, tctx


def _states(jctx, tctx, y, key):
    """One APF(N) x K run of the JAX package as the state of both packages
    (its log-likelihoods as the lane weights), and the port's filter."""
    jfilt = pf.APF(jexamples.stochastic_volatility_builder, N, record_moments=False).set_batch_shape(
        (K,)).initialize_model(jctx)
    jres = jfilt.batch_filter(key, jnp.asarray(y))
    jstate = JSMC2State(jres.log_likelihood, JRunning(jres.latest_state, jres.log_likelihood, record_moments=False),
                        parsed_data=list(y))
    latest = jres.latest_state
    cloud = pt.convert.correction_from_numpy(*(np.asarray(a) for a in (
        latest.x.time_index, latest.x.value, latest.log_weights, latest.log_likelihood, latest.prev_indices)),
        device="cpu")
    ll = _t(np.asarray(jres.log_likelihood))
    tstate = tinf.SMC2State(ll.clone(), tinf.RunningFilterResult(cloud, ll.clone(), record_moments=False),
                            parsed_data=list(y))
    tfilt = pt.APF(pt.examples.stochastic_volatility_builder, N, record_moments=False, device="cpu").set_batch_shape(
        (K,)).initialize_model(tctx)
    return jfilt, jstate, tfilt, tstate


def test_waste_free_rejuvenation_replays_jax(monkeypatch):
    import chip_smoke

    y = chip_smoke.simulate_obs(T)
    jctx, tctx = _contexts(21)
    jfilt, jstate, tfilt, tstate = _states(jctx, tctx, y, jax.random.PRNGKey(22))
    w = np.asarray(jstate.w)
    jkernel = jmh.ParticleMetropolisHastings(num_steps=STEPS, waste_free=True, acceptance_threshold=0.0)
    key = jax.random.PRNGKey(23)
    jupd = jkernel.update(key, jctx, jfilt, jstate)

    # the key schedule of mh.update's fused path (_jitted_rejuvenate)
    _, key = jax.random.split(key)
    k_resample, key = jax.random.split(key)
    k_r2, _ = jax.random.split(k_resample)
    u_roots = np.asarray(jax.random.uniform(k_r2, (), jnp.float32))
    j_roots = np.asarray(jresampling.systematic_m(k_r2, jnormalize(jnp.asarray(w)), M, normalized=True))
    candidates, normals, uniforms, accept_u = [], [], [], []
    for _ in range(STEPS):
        k_step, key = jax.random.split(key)
        k_sample, k_filter, k_accept, _ = jax.random.split(k_step, 4)
        candidates.append(np.asarray(jax.random.normal(k_sample, (M, 6), jnp.float32)))
        z, u = _apf_draws(k_filter, T, M, N)
        normals += z
        uniforms += u
        accept_u.append(np.asarray(jax.random.uniform(k_accept, (M,), jnp.float32)))
    its = [iter(candidates), iter(normals), iter(uniforms), iter(accept_u)]

    def normal_sample(self, generator, sample_shape=()):
        z = next(its[1])
        assert z.shape == tuple(sample_shape) + tuple(self.batch_shape)
        return self.loc + self.scale * _t(z)

    def mvn_sample(self, generator, sample_shape=()):
        z = next(its[0])
        assert z.shape == tuple(sample_shape) + tuple(self.batch_shape) + tuple(self.event_shape)
        return self.loc + torch.einsum("...ij,...j->...i", self.scale_tril, _t(z))

    roots = []

    def systematic_m(generator, weights, m, normalized=False):
        roots.append(tresampling.systematic_m(None, weights, m, normalized=normalized, u=_t(u_roots)))
        return roots[-1]

    monkeypatch.setattr(tdist.Normal, "sample", normal_sample)
    monkeypatch.setattr(tdist.MultivariateNormal, "sample", mvn_sample)
    monkeypatch.setattr(pt.APF, "resample_uniform", lambda self, generator: _t(next(its[2])))
    monkeypatch.setattr(tmcmc_utils, "_uniform", lambda generator, like: _t(next(its[3])))
    monkeypatch.setattr(tmh, "systematic_m", systematic_m)
    tkernel = tinf.ParticleMetropolisHastings(num_steps=STEPS, waste_free=True, acceptance_threshold=0.0)
    tupd = tkernel.update(None, tctx, tfilt, tstate)

    assert all(next(it, None) is None for it in its), "the port must take every draw of the JAX run"
    np.testing.assert_array_equal(roots[0].numpy(), j_roots)
    assert tkernel.n_transitions == STEPS and tkernel.n_doublings == 0 and tkernel.n_host_syncs == STEPS
    assert tupd.context.batch_shape == (K,) and tupd.filter_.batch_shape == (K,)
    for constrained in (True, False):
        _close(tupd.context.stack_parameters(constrained).numpy(),
               np.asarray(jupd.context.stack_parameters(constrained)))
    _close(tupd.state.filter_state.log_likelihood.numpy(), np.asarray(jupd.state.filter_state.log_likelihood))
    _close(tupd.state.filter_state.latest_state.x.value.numpy(),
           np.asarray(jupd.state.filter_state.latest_state.x.value))
    _close(tupd.state.filter_state.latest_state.log_weights.numpy(),
           np.asarray(jupd.state.filter_state.latest_state.log_weights), atol=1e-5)
    assert not tupd.state.w.any() and not np.asarray(jupd.state.w).any()
    # lane j * M + r is root r after j moves: the roots keep their values
    _close(tupd.context.stack_parameters(False)[:M].numpy(), tctx.resample(roots[0]).stack_parameters(False).numpy())


def test_waste_free_refusals():
    """The JAX package's three errors: particles not divisible by
    num_steps + 1 (in SMC2 and in the kernel), the distance stop, and a
    filter that records its history."""
    build = pt.examples.stochastic_volatility_builder
    with pytest.raises(ValueError, match="divisible"):
        tinf.SMC2(pt.APF(build, 8, device="cpu"), 30, num_steps=3, waste_free=True,
                  context=tinf.make_context(device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="incompatible with distance_threshold"):
        tinf.ParticleMetropolisHastings(num_steps=3, waste_free=True, distance_threshold=0.1)
    import chip_smoke

    y = chip_smoke.simulate_obs(4)
    _, tctx = _contexts(24)
    _, _, tfilt, tstate = _states(*_contexts(24), y, jax.random.PRNGKey(25))
    kernel = tinf.ParticleMetropolisHastings(num_steps=STEPS, waste_free=True)
    with pytest.raises(ValueError, match="non-recording filter"):
        kernel.update(torch.Generator(), tctx, tfilt.replace(record_states=True), tstate)
    with pytest.raises(ValueError, match="divisible"):
        tinf.ParticleMetropolisHastings(num_steps=4, waste_free=True).update(torch.Generator(), tctx, tfilt, tstate)


def test_waste_free_abort_doubles_and_refilters_every_lane(monkeypatch):
    """An acceptance threshold no rate reaches aborts after the first
    transition: the particles double and the whole history is re-filtered at
    all K lanes, from the K-lane swarm (the roots' last states repeated)."""
    import chip_smoke

    y = chip_smoke.simulate_obs(T)
    _, tctx = _contexts(26)
    _, _, tfilt, tstate = _states(*_contexts(26), y, jax.random.PRNGKey(27))
    widths = []
    real = pt.APF.batch_filter
    monkeypatch.setattr(pt.APF, "batch_filter", lambda self, *a, **kw: widths.append(
        (self.n_particles, self.batch_shape)) or real(self, *a, **kw))
    kernel = tinf.ParticleMetropolisHastings(num_steps=STEPS, waste_free=True, acceptance_threshold=1.01)
    upd = kernel.update(torch.Generator().manual_seed(0), tctx, tfilt, tstate)
    assert widths == [(N, (M,)), (2 * N, (K,))]
    assert kernel.n_transitions == 1 and kernel.n_doublings == 1 and upd.filter_.n_particles == 2 * N
    assert upd.state.w.shape == (K,) and torch.isfinite(upd.state.filter_state.log_likelihood).all()
    theta = upd.context.stack_parameters(False)
    # after the abort the remaining chain positions repeat the last move's states
    torch.testing.assert_close(theta[2 * M: 3 * M], theta[M: 2 * M], rtol=0, atol=0)
    torch.testing.assert_close(theta[3 * M:], theta[M: 2 * M], rtol=0, atol=0)


def _wf_jax_fit(seed: int) -> dict:
    """One JAX fit of phase 16b's configuration (a worker process): the
    posterior mean by name, and its seconds."""
    import time

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke

    y = chip_smoke.simulate_obs(chip_smoke.N_OBS)
    t0 = time.perf_counter()
    ctx = jinf.make_context(key=jax.random.PRNGKey(seed))
    filt = pf.APF(jexamples.stochastic_volatility_builder, chip_smoke.SMC2_N, record_moments=False)
    alg = jinf.SMC2(filt, chip_smoke.SMC2_K, num_steps=chip_smoke.WF_STEPS, waste_free=True, context=ctx,
                    key=jax.random.PRNGKey(seed + 1), record_moments=False)
    state = alg.fit(jnp.asarray(y), logging=jinf.logging.DefaultLogger())
    w = np.asarray(state.normalized_weights(), np.float64)
    stacked = np.asarray(ctx.stack_parameters(constrained=True), np.float64)
    mean = dict(zip(ctx.parameters, (w @ stacked).tolist()))
    return {"mean": mean, "finite": bool(np.isfinite(np.asarray(state.w)).all()),
            "particles": int(alg.filter.n_particles), "seconds": time.perf_counter() - t0}


def wf_jax_spread(seeds, workers):
    """The JAX fits behind ``chip_smoke.WF_JAX`` over ``seeds`` in ``workers``
    processes: each fit, then per parameter the mean and the spread (sd,
    ddof 1) over seeds."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        fits = list(pool.map(_wf_jax_fit, seeds))
    for seed, fit in zip(seeds, fits):
        print(f"seed {seed}: {fit}", flush=True)
    names = list(fits[0]["mean"])
    summary = {n: (float(np.mean([f["mean"][n] for f in fits])), float(np.std([f["mean"][n] for f in fits], ddof=1)))
               for n in names}
    print(f"WF_JAX_N = {len(fits)}")
    print(f"WF_JAX = {summary}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_waste_free.py [--workers 4] SEED ...
    import argparse

    parser = argparse.ArgumentParser(description=wf_jax_spread.__doc__)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("seeds", type=int, nargs="+")
    args = parser.parse_args()
    wf_jax_spread(args.seeds, args.workers)
