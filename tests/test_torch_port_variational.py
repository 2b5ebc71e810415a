"""The port's VI bridge, ``fit_svi``, ``fit_mle`` and the chain diagnostics,
held against the JAX package.

- ``smoothed_joint_log_likelihood`` and its gradient in the unconstrained
  parameters, on the same smoothed trajectories fed to both packages: the
  nutria model (a lane batch and one lane) and the stochastic-volatility
  model, whose observations sit at every fifth recorded sub-step.
- Five Adam steps of ``fit_svi`` and of ``fit_mle`` against optax's, from
  one context (``convert.set_context_values``) and with a fixed likelihood
  factor in both packages (the smoothed joint density of fixed trajectories;
  a float32 Kalman log-likelihood), the ELBO's noise replayed from the JAX
  key schedule into the port's ``variational._standard_normal``; the JAX
  results carried into the port's by ``convert``.
- Small fits that run the whole path on the CPU: the nutria notebook at its
  ``--quick`` size in both packages, and ``fit_mle`` toward the float64
  Kalman MLE.
- ``inference.diagnostics`` on the same numpy chains.

Script mode: ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_port_variational.py [--workers W] [--init-scale S] SEED ...``
runs the JAX package's nutria fit at ``chip_smoke.py`` phase 13d's full size
(``chip_smoke.nutria_data``, ``chip_smoke.nutria_start``) once per seed and
prints each fit's posterior quantiles and the medians' mean and spread
between seeds (the readings behind ``chip_smoke.NUTRIA_JAX``); with
``--port`` it runs the port's fit at that size on the CPU instead and prints
each median's gap against phase 13d's limit.

Tolerances: the joint log-likelihood rel 1e-5 (float32 sums over T steps
and the trajectories), its gradient rel 1e-5 with abs 1e-4 of the gradient's
scale; Adam's losses and parameters rel 1e-5 (abs 1e-6); diagnostics rel
1e-10 (float64 numpy on both sides).
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
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.filters.particle import base as jbase
from pyfilter_tpu.inference import diagnostics as jdiag
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch import timeseries as tts
from pyfilter_tpu_torch.filters.particle import base as tbase
from pyfilter_tpu_torch.inference import variational as tvar

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


def _contexts(j_builder, t_builder, lanes, seed):
    """A JAX context with its builder's parameters drawn from the priors, and
    the port's holding the same values."""
    jctx = jinf.make_context(key=jax.random.PRNGKey(seed))
    jctx.set_batch_shape(lanes)
    j_builder(jctx)
    tctx = tinf.make_context(device="cpu")
    tctx.set_batch_shape(lanes)
    t_builder(tctx)
    pt.convert.set_context_values(tctx, {k: np.asarray(v) for k, v in jctx.parameters.items()})
    return jctx, tctx


# -- the VI bridge ---------------------------------------------------------------------
_BRIDGE = {
    # name: (JAX builder, port builder, lanes, trajectories, observations, oes)
    "nutria-lanes": (lambda c: jexamples.nutria_builder(c, num_obs=20),
                     lambda c: pt.examples.nutria_builder(c, num_obs=20), (3,), 16, 20, 1),
    "nutria-one-lane": (lambda c: jexamples.nutria_builder(c, num_obs=20),
                        lambda c: pt.examples.nutria_builder(c, num_obs=20), (1,), 16, 20, 1),
    "sv-substeps": (jexamples.stochastic_volatility_builder, pt.examples.stochastic_volatility_builder, (2,), 8, 6,
                    5),
}


@pytest.mark.parametrize("name", sorted(_BRIDGE))
def test_smoothed_joint_log_likelihood_matches_jax(name):
    j_builder, t_builder, lanes, m, n_obs, oes = _BRIDGE[name]
    jctx, tctx = _contexts(j_builder, t_builder, lanes, seed=3)
    rows = 1 + n_obs if oes == 1 else 2 + (n_obs - 1) * oes  # a recorded history's rows
    rng = np.random.default_rng(8)
    if oes == 1:
        smoothed = rng.normal(0.5, 0.4, size=(rows, m, *lanes)).astype(np.float32)
        y = rng.normal(0.5, 0.5, size=n_obs).astype(np.float32)
    else:  # a positive volatility path
        smoothed = rng.uniform(0.7, 1.3, size=(rows, m, *lanes)).astype(np.float32)
        y = rng.normal(0.0, 1.0, size=n_obs).astype(np.float32)
    times = np.concatenate([[0.0], 1.0 + np.arange(rows - 1)]).astype(np.float32)

    theta = np.asarray(jctx.stack_parameters(constrained=False))

    def j_ll(th):
        model = j_builder(jctx.unstack_parameters(th, constrained=False))
        return jbase.smoothed_joint_log_likelihood(model, jnp.asarray(times), jnp.asarray(smoothed), jnp.asarray(y),
                                                   oes=oes)

    j_val = np.asarray(j_ll(jnp.asarray(theta)))
    j_grad = np.asarray(jax.grad(lambda th: jnp.sum(j_ll(th)))(jnp.asarray(theta)))

    t_theta = torch.from_numpy(theta.copy()).requires_grad_(True)
    with tctx.no_prior_verification():
        model = t_builder(tctx.unstack_parameters(t_theta, constrained=False))
    t_val = tbase.smoothed_joint_log_likelihood(model, torch.from_numpy(times), torch.from_numpy(smoothed), y, oes=oes)
    assert t_val.shape == lanes
    t_val.sum().backward()
    _close(t_val.detach(), j_val, rtol=1e-5)
    _close(t_theta.grad, j_grad, rtol=1e-5, atol=1e-4 * np.abs(j_grad).max())


def test_smoothed_log_likelihood_keeps_the_filter_out_of_the_graph():
    """The port's factor on its own draws: the filter and FFBS run outside the
    graph (the same draws again give the same value, as the joint density of
    those trajectories), and the gradient reaches every parameter."""
    y = pt.examples.nutria_model(device="cpu").sample_states(torch.Generator().manual_seed(0), 15).get_paths()[1]
    tctx = tinf.make_context(generator=torch.Generator().manual_seed(1), device="cpu")
    tctx.set_batch_shape((2,))
    filt = pt.APF(lambda c: pt.examples.nutria_builder(c, num_obs=15), 30, device="cpu").set_batch_shape((2,))
    filt = filt.initialize_model(tctx)
    theta = tctx.stack_parameters(constrained=False).clone().requires_grad_(True)
    model = filt.initialize_model(tctx.unstack_parameters(theta, constrained=False)).model
    ll = filt.smoothed_log_likelihood(torch.Generator().manual_seed(2), y.numpy(), model=model)
    ll.sum().backward()
    assert ll.shape == (2,) and bool(torch.isfinite(ll).all())
    assert bool((theta.grad != 0).all())

    rec = filt.replace(record_states=True)
    gen = torch.Generator().manual_seed(2)
    res = rec.batch_filter(gen, y.numpy())
    smoothed = rec.smooth(gen, res)
    again = tbase.smoothed_joint_log_likelihood(filt.model, res.states.time_indexes, smoothed, y.numpy())
    _close(again, ll.detach(), rtol=1e-6)


# -- Adam against optax, with a fixed factor ---------------------------------------------
S, T_FIX, M_FIX = 3, 12, 10


def _fixed_trajectories():
    rng = np.random.default_rng(12)
    smoothed = rng.normal(0.6, 0.3, size=(T_FIX + 1, M_FIX, S)).astype(np.float32)
    y = rng.normal(0.6, 0.4, size=T_FIX).astype(np.float32)
    return np.arange(T_FIX + 1, dtype=np.float32), smoothed, y


def test_fit_svi_adam_steps_match_optax(monkeypatch):
    times, smoothed, y = _fixed_trajectories()
    monkeypatch.setattr(pf.filters.ParticleFilter, "smoothed_log_likelihood",
                        lambda self, key, y_, **kw: jbase.smoothed_joint_log_likelihood(
                            self.model, jnp.asarray(times), jnp.asarray(smoothed), y_))
    monkeypatch.setattr(pt.filters.ParticleFilter, "smoothed_log_likelihood",
                        lambda self, generator, y_, **kw: tbase.smoothed_joint_log_likelihood(
                            self.model, torch.from_numpy(times), torch.from_numpy(smoothed), y_))
    j_builder = lambda c: jexamples.nutria_builder(c, num_obs=T_FIX)  # noqa: E731
    t_builder = lambda c: pt.examples.nutria_builder(c, num_obs=T_FIX)  # noqa: E731
    jctx, tctx = _contexts(j_builder, t_builder, (S,), seed=4)
    key, steps = jax.random.PRNGKey(9), 5

    _, k_loop = jax.random.split(key)
    eps = []
    for _ in range(steps):
        k_loop, k_i = jax.random.split(k_loop)
        eps.append(torch.from_numpy(np.array(jax.random.normal(jax.random.split(k_i)[0], (S, 5)))))
    tape = iter(eps)
    monkeypatch.setattr(tvar, "_standard_normal", lambda generator, shape, like: next(tape))

    jres = jinf.fit_svi(j_builder, jnp.asarray(y), lambda b: pf.APF(b, 8), key=key, num_steps=steps,
                        num_elbo_samples=S, learning_rate=1e-2, context=jctx)
    tres = tinf.fit_svi(t_builder, y, lambda b: pt.APF(b, 8, device="cpu"), None, num_steps=steps,
                        num_elbo_samples=S, learning_rate=1e-2, context=tctx)
    _close(tres.losses, jres.losses, rtol=1e-5, atol=1e-6)
    _close(tres.guide.loc, jres.guide.loc, rtol=1e-5, atol=1e-6)
    _close(tres.guide.log_scale, jres.guide.log_scale, rtol=1e-5, atol=1e-6)
    # the JAX result carried into the port's, read back the same
    carried = pt.convert.svi_result_from_numpy(np.asarray(jres.guide.loc), np.asarray(jres.guide.log_scale),
                                               np.asarray(jres.losses), tctx)
    jq, tq, cq = jres.posterior_quantiles(), tres.posterior_quantiles(), carried.posterior_quantiles()
    for name in jq:
        for q in jq[name]:
            _close(cq[name][q], jq[name][q], rtol=1e-6, atol=1e-7)
            _close(tq[name][q], jq[name][q], rtol=1e-5, atol=1e-6)
    _close(carried.posterior().log_prob(torch.zeros(5)), jres.posterior().log_prob(jnp.zeros(5)), rtol=1e-6)


def _kalman_t(beta, y, q=0.25, r=0.09):
    """Scalar AR(1) Kalman log-likelihood in torch (x0 ~ N(0, q)), float32."""
    m, p, ll = torch.zeros(()), torch.full((), q), torch.zeros(())
    for y_t in y:
        m, p = beta * m, beta**2 * p + q
        s = p + r
        ll = ll - 0.5 * (torch.log(2 * math.pi * s) + (float(y_t) - m) ** 2 / s)
        k = p / s
        m, p = m + k * (float(y_t) - m), (1 - k) * p
    return ll


def _kalman_j(beta, y, q=0.25, r=0.09):
    m, p, ll = jnp.zeros(()), jnp.full((), q), jnp.zeros(())
    for y_t in y:
        m, p = beta * m, beta**2 * p + q
        s = p + r
        ll = ll - 0.5 * (jnp.log(2 * math.pi * s) + (float(y_t) - m) ** 2 / s)
        k = p / s
        m, p = m + k * (float(y_t) - m), (1 - k) * p
    return ll


def _j_ar_builder(ctx):
    beta = ctx.named_parameter("beta", jdist.Uniform(0.0, 1.0))
    return jts.LinearStateSpaceModel(jmodels.AR(0.0, beta, 0.5), (1.0, 0.3))


def _t_ar_builder(ctx):
    beta = ctx.named_parameter("beta", tdist.Uniform(torch.tensor(0.0), torch.tensor(1.0)))
    return tts.LinearStateSpaceModel(tts.models.AR(0.0, beta, 0.5, device=ctx.device), (1.0, 0.3))


def _ar_data(n, seed):
    model = tts.LinearStateSpaceModel(tts.models.AR(0.0, 0.8, 0.5, device="cpu"), (1.0, 0.3))
    return model.sample_states(torch.Generator().manual_seed(seed), n).get_paths()[1].numpy()


def test_fit_mle_adam_steps_match_optax(monkeypatch):
    """MAP steps (the prior and its Jacobian included) on a fixed objective,
    the Kalman log-likelihood standing in for the filter's in both packages."""
    from types import SimpleNamespace

    y = _ar_data(15, seed=3)
    monkeypatch.setattr(pf.SISR, "batch_filter", lambda self, key, y_, use_jit=True: SimpleNamespace(
        log_likelihood=_kalman_j(self.model.hidden.parameters[1], y)))
    monkeypatch.setattr(pt.SISR, "batch_filter", lambda self, generator, y_: SimpleNamespace(
        log_likelihood=_kalman_t(self.model.hidden.parameters[1], y)))
    jctx, tctx = _contexts(_j_ar_builder, _t_ar_builder, (), seed=5)
    jres = jinf.fit_mle(_j_ar_builder, jnp.asarray(y), lambda b: pf.SISR(b, 8), key=jax.random.PRNGKey(0),
                        num_steps=5, learning_rate=3e-2, context=jctx, map_estimate=True)
    tres = tinf.fit_mle(_t_ar_builder, y, lambda b: pt.SISR(b, 8, device="cpu"), None, num_steps=5,
                        learning_rate=3e-2, context=tctx, map_estimate=True)
    _close(tres.losses, jres.losses, rtol=1e-5, atol=1e-6)
    _close(tres.theta, jres.theta, rtol=1e-5, atol=1e-6)
    carried = pt.convert.mle_result_from_numpy(np.asarray(jres.theta), np.asarray(jres.losses), tctx)
    _close(carried.parameters()["beta"], jres.parameters()["beta"], rtol=1e-6)
    _close(tres.parameters()["beta"], jres.parameters()["beta"], rtol=1e-5)


# -- small fits on the whole path ----------------------------------------------------------------
def test_nutria_quick_fit_lowers_the_loss_in_both_packages():
    """The notebook's ``--quick`` size (T = 50, APF(60), 60 steps) from the
    start phase 13d uses, in both packages: the mean of the last 10 losses
    below the first 10's, a finite guide."""
    import chip_smoke

    y = chip_smoke.nutria_data(50)
    j_builder = lambda c: jexamples.nutria_builder(c, num_obs=50)  # noqa: E731
    t_builder = lambda c: pt.examples.nutria_builder(c, num_obs=50)  # noqa: E731
    jctx, tctx = _contexts(j_builder, t_builder, (4,), seed=6)
    for ctx, np_ns in ((jctx, jnp), (tctx, None)):
        for name, value in chip_smoke.nutria_start(4).items():
            ctx.update_parameter(name, jnp.asarray(value) if np_ns is jnp else torch.from_numpy(value))
    jres = jinf.fit_svi(j_builder, jnp.asarray(y), lambda b: pf.APF(b, 60), key=jax.random.PRNGKey(1),
                        num_steps=60, context=jctx, init_scale=chip_smoke.NUTRIA_INIT_SCALE)
    tres = tinf.fit_svi(t_builder, y, lambda b: pt.APF(b, 60, device="cpu"), torch.Generator().manual_seed(1),
                        num_steps=60, context=tctx, init_scale=chip_smoke.NUTRIA_INIT_SCALE)
    for losses, guide in ((np.asarray(jres.losses), jres.guide), (tres.losses.numpy(), tres.guide)):
        assert np.isfinite(losses).all() and np.isfinite(np.asarray(guide.loc)).all()
        assert losses[-10:].mean() < losses[:10].mean(), (losses[:10].mean(), losses[-10:].mean())


def _kalman_np(beta, y, q=0.25, r=0.09):
    m, p, ll = 0.0, q, 0.0
    for y_t in y.astype(np.float64):
        m, p = beta * m, beta**2 * p + q
        s = p + r
        ll -= 0.5 * (math.log(2 * math.pi * s) + (y_t - m) ** 2 / s)
        k = p / s
        m, p = m + k * (y_t - m), (1 - k) * p
    return ll


def test_fit_mle_moves_beta_toward_the_kalman_mle():
    """SISR(64), T = 40, 40 Adam steps from beta = 0.4: closer to the float64
    Kalman MLE of the data (a 60-point grid) than the start, the loss lower."""
    y = _ar_data(40, seed=7)
    betas = np.linspace(0.2, 0.99, 60)
    mle = betas[int(np.argmax([_kalman_np(b, y) for b in betas]))]
    tctx = tinf.make_context(device="cpu")
    tctx.set_batch_shape(())
    _t_ar_builder(tctx)
    tctx.update_parameter("beta", 0.4)
    res = tinf.fit_mle(_t_ar_builder, y, lambda b: pt.SISR(b, 64, device="cpu"), torch.Generator().manual_seed(8),
                       num_steps=40, learning_rate=3e-2, context=tctx)
    fitted = float(res.parameters()["beta"])
    assert abs(fitted - mle) < 0.5 * abs(0.4 - mle), (fitted, mle)
    losses = res.losses.numpy()
    assert losses[-10:].mean() < losses[:10].mean()


# -- diagnostics -------------------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(200, 4), (101, 3, 2), (3, 2)])
def test_diagnostics_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    chains = np.cumsum(rng.normal(size=shape), axis=0) * 0.1 + rng.normal(size=shape)
    for fn in ("potential_scale_reduction", "effective_sample_size"):
        j, t = getattr(jdiag, fn)(chains), getattr(tinf.diagnostics, fn)(chains)
        assert np.asarray(t).shape == np.asarray(j).shape
        np.testing.assert_allclose(t, j, rtol=1e-10, equal_nan=True)

    class _Chains:
        def as_arrays(self):
            return {"a": chains, "b": chains[..., :1] if chains.ndim > 2 else chains * 2.0}

    js, ts = jdiag.summarize_chains(_Chains(), burn_in=0.3), tinf.summarize_chains(_Chains(), burn_in=0.3)
    for name in js:
        for stat in js[name]:
            np.testing.assert_allclose(ts[name][stat], js[name][stat], rtol=1e-10, equal_nan=True)


# -- script mode: the JAX package's nutria fits at phase 13d's size ---------------------------------------------
def _jax_nutria_fit(args):
    """One JAX nutria fit at phase 13d's size: seconds, finite, quantiles."""
    import time

    import chip_smoke

    seed, init_scale = args
    jax.config.update("jax_platforms", "cpu")
    y = chip_smoke.nutria_data()
    build = lambda c: jexamples.nutria_builder(c, num_obs=chip_smoke.NUTRIA_T)  # noqa: E731
    ctx = jinf.make_context(key=jax.random.PRNGKey(1000 + seed))
    ctx.set_batch_shape((chip_smoke.NUTRIA_SAMPLES,))
    build(ctx)
    for name, value in chip_smoke.nutria_start(chip_smoke.NUTRIA_SAMPLES).items():
        ctx.update_parameter(name, jnp.asarray(value))
    t0 = time.perf_counter()
    res = jinf.fit_svi(build, jnp.asarray(y), lambda b: pf.APF(b, chip_smoke.NUTRIA_N), key=jax.random.PRNGKey(seed),
                       num_steps=chip_smoke.NUTRIA_STEPS, num_elbo_samples=chip_smoke.NUTRIA_SAMPLES,
                       learning_rate=chip_smoke.NUTRIA_LR, context=ctx, init_scale=init_scale)
    losses = np.asarray(res.losses)
    quantiles = {k: {q: float(v) for q, v in d.items()} for k, d in res.posterior_quantiles().items()}
    return time.perf_counter() - t0, bool(np.isfinite(losses).all()), quantiles, \
        float(losses[:50].mean()), float(losses[-50:].mean())


def jax_nutria_witness(seeds, workers: int, init_scale: float):
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    medians, sds = [], []
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        for seed, (wall, finite, qs, first, last) in zip(
                seeds, pool.map(_jax_nutria_fit, [(s, init_scale) for s in seeds])):
            print(f"jax seed {seed}: {wall:.1f} s; finite {finite}; loss {first:.3f} -> {last:.3f}; quantiles {qs}",
                  flush=True)
            if finite:
                medians.append({k: d[0.5] for k, d in qs.items()})
                sds.append({k: (d[0.95] - d[0.05]) / (2 * 1.6448536269514722) for k, d in qs.items()})
    if len(medians) > 1:
        print("jax: (mean, sd between seeds) of each posterior median, mean guide sd: "
              + repr({k: (float(np.mean([m[k] for m in medians])), float(np.std([m[k] for m in medians], ddof=1)),
                          float(np.mean([s[k] for s in sds]))) for k in medians[0]})
              + f" over {len(medians)} finite fits of {len(seeds)}")


def port_nutria_gaps(seed: int):
    """The port's nutria fit at phase 13d's full size on the CPU (phase 13d's
    own call, the context seeded ``seed``, the fit ``seed + 1``): each
    posterior median's gap from the JAX fits' against phase 13d's limit."""
    import time

    import chip_smoke

    y = chip_smoke.nutria_data()
    build = lambda c: pt.examples.nutria_builder(c, num_obs=chip_smoke.NUTRIA_T)  # noqa: E731
    ctx = tinf.make_context(generator=torch.Generator().manual_seed(seed), device="cpu")
    ctx.set_batch_shape((chip_smoke.NUTRIA_SAMPLES,))
    build(ctx)
    for name, value in chip_smoke.nutria_start(chip_smoke.NUTRIA_SAMPLES).items():
        ctx.update_parameter(name, torch.from_numpy(value))
    t0 = time.perf_counter()
    res = tinf.fit_svi(build, y, lambda b: pt.APF(b, chip_smoke.NUTRIA_N, device="cpu"),
                       torch.Generator().manual_seed(seed + 1), num_steps=chip_smoke.NUTRIA_STEPS,
                       num_elbo_samples=chip_smoke.NUTRIA_SAMPLES, learning_rate=chip_smoke.NUTRIA_LR, context=ctx,
                       init_scale=chip_smoke.NUTRIA_INIT_SCALE)
    losses = res.losses.numpy()
    print(f"port seed {seed}: {time.perf_counter() - t0:.1f} s; loss {losses[:50].mean():.3f} -> "
          f"{losses[-50:].mean():.3f}", flush=True)
    for name, qs in res.posterior_quantiles().items():
        med = float(np.asarray(qs[0.5]))
        j_mean, j_sd, j_guide_sd = chip_smoke.NUTRIA_JAX[name]
        limit = max(chip_smoke.NUTRIA_TOL * j_sd, j_guide_sd)
        print(f"  {name:>7s}: median {med:.5f}, gap {med - j_mean:+.5f} = {(med - j_mean) / j_sd:+.3f} sds between "
              f"seeds = {(med - j_mean) / limit:+.3f} of the limit {limit:.5f}", flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_variational.py [--workers 4] SEED ...
    # PYTHONPATH=. python tests/test_torch_port_variational.py --port SEED ...: the port's fits instead
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--init-scale", type=float, default=None)
    parser.add_argument("--port", action="store_true")
    parser.add_argument("seeds", type=int, nargs="+")
    args = parser.parse_args()
    import chip_smoke

    if args.port:
        for s in args.seeds:
            port_nutria_gaps(s)
    else:
        jax_nutria_witness(args.seeds, args.workers,
                           chip_smoke.NUTRIA_INIT_SCALE if args.init_scale is None else args.init_scale)
