"""The port's density-tempered SMC, held against the JAX package.

``find_increment`` on the same log-likelihoods; one small whole fit
(``TemperedSMC(SISR(build, 32), 16)`` over 20 observations) replayed draw for
draw; and ``tests/test_tempered.py``'s SISR-based gates on the port (the
posterior recovered within 3.5 swarm sds, a stalled ladder refused, the
evidence ranking two observation scales, the waste-free swarm against the
standard one, the divisibility check).

The model is ``examples/batch_inference_zoo.py``'s: an AR(1) with beta ~
Uniform(0, 1) and sigma ~ LogNormal(-1, 0.5), observed with noise 0.2.

The replay runs the JAX fit eagerly (``jax.disable_jit()``) with
``jax.random.normal`` / ``uniform`` patched to a host tape (:class:`Tape`) and
feeds the port the same draws through its seams: the prior draws
(``Uniform.sample``, ``Normal.sample``), each filter pass's initial cloud and
proposal normals, its per-lane resample uniforms, the swarm resampler's
uniform (a replay resampler), the MH noise and acceptance uniforms
(``tempered._standard_normal``, ``tempered._uniform``). TF32 is off.
Tolerances: the ladder rel 1e-5, the samples and the log evidence rel 1e-4
(float32 log-likelihoods in two frameworks, summed over 20 steps and pushed
through a host bisection), acceptance rates exact (the same accept masks).
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
from pyfilter_tpu.inference.batch import tempered as jtempered
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch import resampling as tresampling
from pyfilter_tpu_torch.inference.batch import tempered as ttempered
from pyfilter_tpu_torch.timeseries import models as tmodels

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BETA, SIGMA, OBS_SCALE = 0.7, 0.3, 0.2


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


class Tape:
    """Standard normals and uniforms drawn with numpy, recorded in the order
    the JAX run asks for them, then handed to the port's seams in that order
    (one stream each, every shape checked). Shared with
    ``test_torch_port_if2.py``."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.normals, self.uniforms = [], []

    def jax_normal(self, key, shape=(), dtype=jnp.float32):
        self.normals.append(self.rng.standard_normal(tuple(shape)).astype(np.float32))
        return jnp.asarray(self.normals[-1], dtype)

    def jax_uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        self.uniforms.append(self.rng.uniform(size=tuple(shape)).astype(np.float32))
        return jnp.asarray(minval + (maxval - minval) * self.uniforms[-1], dtype)

    def record(self, monkeypatch, run):
        """``run()`` eagerly, drawing from the tape."""
        with monkeypatch.context() as m:
            m.setattr(jax.random, "normal", self.jax_normal)
            m.setattr(jax.random, "uniform", self.jax_uniform)
            with jax.disable_jit():
                return run()

    def replay(self, monkeypatch, normal_seams=(), uniform_seams=()):
        """Patch the port's seams to take the recorded draws: ``Normal.sample``,
        ``Uniform.sample``, the SISR's lane uniforms, and the ``(module,
        name)`` seams ``(generator, like) -> tensor like like``. Returns both
        iterators (empty once every draw is taken) and a lane resampler taking
        ``systematic``'s uniform from the tape."""
        normals, uniforms = iter(self.normals), iter(self.uniforms)

        def normal(shape):
            z = next(normals)
            assert z.shape == tuple(shape), (z.shape, tuple(shape))
            return _t(z)

        def uniform(shape):
            u = next(uniforms)
            assert u.shape == tuple(shape), (u.shape, tuple(shape))
            return _t(u)

        monkeypatch.setattr(tdist.Normal, "sample", lambda self, generator, sample_shape=(): self.loc + self.scale * (
            normal(tuple(sample_shape) + tuple(self.batch_shape))))
        monkeypatch.setattr(tdist.Uniform, "sample", lambda self, generator, sample_shape=(): self.low + (
            self.high - self.low) * uniform(tuple(sample_shape) + tuple(self.batch_shape)))
        monkeypatch.setattr(pt.SISR, "resample_uniform", lambda self, generator: uniform(self.batch_shape))
        for module, name in normal_seams:
            monkeypatch.setattr(module, name, lambda generator, like: normal(like.shape))
        for module, name in uniform_seams:
            monkeypatch.setattr(module, name, lambda generator, like: uniform(like.shape))
        lane_resampler = lambda generator, w, normalized=False: tresampling.systematic(  # noqa: E731
            None, w, normalized=normalized, u=uniform(()))
        return normals, uniforms, lane_resampler


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


def t_build_obs(obs_scale, sigma=SIGMA):
    def build(ctx):
        beta = ctx.named_parameter("beta", tdist.Uniform(tmodels.parameter(0.0, ctx.device),
                                                         tmodels.parameter(1.0, ctx.device)))
        return pt.timeseries.LinearStateSpaceModel(tmodels.AR(0.0, beta, sigma, device=ctx.device), (1.0, obs_scale))

    return build


def simulate(n_obs, seed, beta=BETA, sigma=SIGMA):
    """``n_obs`` observations of the true model (the port's simulator, CPU)."""
    model = pt.timeseries.LinearStateSpaceModel(tmodels.AR(0.0, beta, sigma, device="cpu"), (1.0, OBS_SCALE))
    return model.sample_states(torch.Generator().manual_seed(seed), n_obs).get_paths()[1].numpy()


def _fit(n_state, k, y, seed, build=t_build, **kwargs):
    ctx = tinf.make_context(generator=torch.Generator().manual_seed(seed), device="cpu")
    alg = tinf.TemperedSMC(pt.SISR(build, n_state, device="cpu"), k, context=ctx,
                           generator=torch.Generator().manual_seed(seed + 1), device="cpu", **kwargs)
    return alg.fit(y, logging=tinf.logging.DefaultLogger()), ctx


# -- 1. the ladder ---------------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["spread", "flat", "one-outlier", "dead-lanes"])
def test_find_increment_matches_jax(case):
    """The same increment from the same log-likelihoods (the host bisection
    of both packages), and the ESS it keeps at the target."""
    rng = np.random.default_rng(3)
    ll = {
        "spread": rng.normal(-50.0, 20.0, 64),
        "flat": np.full(64, -12.0) + rng.normal(0.0, 1e-3, 64),
        "one-outlier": np.concatenate([rng.normal(-80.0, 2.0, 63), [-10.0]]),
        "dead-lanes": np.where(rng.random(64) < 0.2, -1e300, rng.normal(-30.0, 5.0, 64)),
    }[case]
    for lam in (0.0, 0.3, 0.97):
        got = ttempered.find_increment(ll, lam, 0.5)
        assert got == jtempered.find_increment(ll, lam, 0.5)
        assert 0.0 < got <= 1.0 - lam + 1e-12
        if got < 1.0 - lam and got > 1e-6:
            assert abs(ttempered._host_ess(got * ll) - 32.0) < 0.5


# -- 2. one whole fit, draw for draw ---------------------------------------------------------------
def test_tempered_fit_replays_jax(monkeypatch):
    """``TemperedSMC(SISR(build, 32), 16)`` over 20 observations at its
    defaults (target ESS 0.5, 2 MH steps): the JAX fit on a host tape and the
    port's on the same draws give the same ladder, acceptance rates, final
    swarm and log evidence, and the user's context holds the swarm."""
    k, n, y = 16, 32, simulate(20, seed=4)
    tape = Tape(5)
    jctx = jinf.make_context(key=jax.random.PRNGKey(6))
    jres = tape.record(monkeypatch, lambda: jinf.TemperedSMC(
        pf.SISR(j_build, n), k, context=jctx, key=jax.random.PRNGKey(7)).fit(
        jnp.asarray(y), logging=jinf.logging.DefaultLogger()))
    assert len(jres.lambdas) >= 2, "the fit must take more than one stage"

    normals, uniforms, lane_resampler = tape.replay(
        monkeypatch, normal_seams=[(ttempered, "_standard_normal")], uniform_seams=[(ttempered, "_uniform")])
    tctx = tinf.make_context(device="cpu")
    tres = tinf.TemperedSMC(pt.SISR(t_build, n, device="cpu"), k, resampler=lane_resampler, context=tctx,
                            device="cpu").fit(y, logging=tinf.logging.DefaultLogger())
    assert next(normals, None) is None and next(uniforms, None) is None, "the port must take every draw"

    _close(tres.lambdas, jres.lambdas)
    np.testing.assert_array_equal(tres.acceptance_rates, np.asarray(jres.acceptance_rates, np.float32))
    assert 0.0 < tres.acceptance_rates.max() and tres.acceptance_rates.min() < 1.0
    for name in ("beta", "sigma"):
        _close(tres.samples[name], jres.samples[name], rtol=1e-4, atol=1e-5)
        _close(tctx.get_parameter(name), jctx.get_parameter(name), rtol=1e-4, atol=1e-5)
    _close(tres.log_evidence, jres.log_evidence, rtol=1e-4)


# -- 3. tests/test_tempered.py's gates on the port ---------------------------------------------------
def test_tempered_smc_recovers_posterior():
    """``tests/test_tempered.py:24``: the ladder rises strictly to 1, each
    posterior mean lies within 3.5 swarm sds of the truth, the evidence is
    finite and the user's context holds the final swarm."""
    y = simulate(200, seed=0)
    res, ctx = _fit(150, 400, y, seed=1)
    lam = res.lambdas
    assert lam[-1] == 1.0 and (np.diff(lam) > 0).all()
    assert len(res.acceptance_rates) == len(lam)
    for name, true in (("beta", BETA), ("sigma", SIGMA)):
        s = res.samples[name]
        assert s.shape == (400,)
        assert abs(s.mean() - true) / s.std() < 3.5, (name, s.mean(), s.std())
    assert np.isfinite(res.log_evidence)
    assert tuple(ctx.get_parameter("beta").shape) == (400,)


def test_tempered_smc_raises_on_stalled_ladder():
    """``tests/test_tempered.py:100``: one stage cannot reach lambda = 1."""
    with pytest.raises(RuntimeError, match="ladder stalled"):
        _fit(100, 200, simulate(200, seed=4), seed=5, max_stages=1)


def test_tempered_evidence_ranks_models():
    """``tests/test_tempered.py:113``: the log evidence prefers the true
    observation scale over a badly misspecified one by more than 10 nats."""
    y = simulate(150, seed=2)
    good = _fit(150, 300, y, seed=3, build=t_build_obs(0.2))[0].log_evidence
    bad = _fit(150, 300, y, seed=3, build=t_build_obs(1.5))[0].log_evidence
    assert good > bad + 10.0, (good, bad)


def test_tempered_smc_waste_free_matches_standard():
    """``tests/test_tempered.py:134``: the waste-free swarm (100 roots, 3 MH
    steps) recovers the posterior and agrees with the standard strategy
    within 1.5 swarm sds and 3 nats of evidence; the context holds all 400."""
    y = simulate(200, seed=0)
    wf, ctx = _fit(150, 400, y, seed=1, num_mh_steps=3, waste_free=True)
    std, _ = _fit(150, 400, y, seed=1, num_mh_steps=3)
    assert wf.lambdas[-1] == 1.0
    for name, true in (("beta", BETA), ("sigma", SIGMA)):
        s = wf.samples[name]
        assert s.shape == (400,)
        assert abs(s.mean() - true) / s.std() < 3.5, (name, s.mean(), s.std())
        assert abs(s.mean() - std.samples[name].mean()) < 1.5 * max(s.std(), std.samples[name].std())
    assert np.isfinite(wf.log_evidence)
    assert abs(wf.log_evidence - std.log_evidence) < 3.0
    assert tuple(ctx.get_parameter("beta").shape) == (400,)


def test_tempered_smc_waste_free_validates_divisibility():
    """``tests/test_tempered.py:166``."""
    with pytest.raises(ValueError, match="divisible"):
        tinf.TemperedSMC(pt.SISR(t_build, 64, device="cpu"), 100, num_mh_steps=2, waste_free=True,
                         context=tinf.make_context(device="cpu"), device="cpu")


def test_tempered_smc_entry_points():
    """The exports sit where the JAX package puts them; the card is the
    default device."""
    assert tinf.TemperedSMC is tinf.batch.TemperedSMC is ttempered.TemperedSMC
    assert tinf.TemperedSMCResult is ttempered.TemperedSMCResult
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tinf.TemperedSMC(pt.SISR(t_build, 8, device="cpu"), 4, context=tinf.make_context(device="cpu"))


# -- the JAX package at phase 15's full width --------------------------------------------------------
def _zoo_jax_fit(seed):
    """The JAX package's TemperedSMC and IF2 fits of ``chip_smoke.py`` phase
    15 (the batch-inference zoo's parts 2-3 at full width on phase 11's data)
    on the CPU, keys from ``seed``: the posterior means, the log evidence,
    the ladder's length, the IF2 MLE and each fit's wall seconds."""
    import time

    import chip_smoke

    jax.config.update("jax_platforms", "cpu")
    y = jnp.asarray(chip_smoke.pmmh_data(torch, pt))
    t0 = time.perf_counter()
    tres = jinf.TemperedSMC(pf.SISR(j_build, chip_smoke.ZOO_N), chip_smoke.ZOO_K,
                            context=jinf.make_context(key=jax.random.PRNGKey(seed)),
                            key=jax.random.PRNGKey(seed + 1)).fit(y, logging=jinf.logging.DefaultLogger())
    t1 = time.perf_counter()
    ires = jinf.IF2(pf.SISR(j_build, chip_smoke.ZOO_N), chip_smoke.ZOO_K, num_iterations=chip_smoke.ZOO_IF2_ITERS,
                    sigma=chip_smoke.ZOO_IF2_SIGMA, cooling=chip_smoke.ZOO_IF2_COOLING,
                    context=jinf.make_context(key=jax.random.PRNGKey(seed + 2)),
                    key=jax.random.PRNGKey(seed + 3)).fit(y, logging=jinf.logging.DefaultLogger())
    t2 = time.perf_counter()
    return {"tempered": {"beta": float(tres.samples["beta"].mean()), "sigma": float(tres.samples["sigma"].mean()),
                         "log_evidence": float(tres.log_evidence)},
            "if2": {"beta": float(ires.mle["beta"]), "sigma": float(ires.mle["sigma"])},
            "stages": len(tres.lambdas), "walls": (t1 - t0, t2 - t1)}


def zoo_jax_spread(seeds, workers):
    """The JAX fits behind ``chip_smoke.ZOO_JAX`` over ``seeds`` in
    ``workers`` processes: each fit, then per reading the mean and the
    spread (sd, ddof 1) over seeds, and the gap of the mean to the exact grid
    references."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import chip_smoke

    exact = chip_smoke.ar_grid_posterior(chip_smoke.pmmh_data(torch, pt))
    print(f"grid: posterior {exact['beta']}, {exact['sigma']}; log evidence {exact['log_evidence']}; "
          f"MLE {exact['mle']}", flush=True)
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        fits = list(pool.map(_zoo_jax_fit, seeds))
    for seed, fit in zip(seeds, fits):
        print(f"seed {seed}: {fit}", flush=True)
    summary = {}
    for part in ("tempered", "if2"):
        summary[part] = {name: (float(np.mean([f[part][name] for f in fits])),
                                float(np.std([f[part][name] for f in fits], ddof=1))) for name in fits[0][part]}
    print(f"ZOO_JAX_N = {len(fits)}")
    print(f"ZOO_JAX = {summary}")
    print(f"stages {[f['stages'] for f in fits]}; walls {[tuple(round(w, 1) for w in f['walls']) for f in fits]}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_port_tempered.py [--workers 4] SEED ...
    import argparse

    parser = argparse.ArgumentParser(description=zoo_jax_spread.__doc__)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("seeds", type=int, nargs="+")
    args = parser.parse_args()
    zoo_jax_spread(args.seeds, args.workers)
