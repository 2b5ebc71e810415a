"""The port's online score and streaming maximum likelihood held against the
JAX package's ``pyfilter_tpu/inference/score.py``.

- The score functionals (the per-particle gradients of ``log f`` and ``log
  g`` in the unconstrained parameters, ``vmap`` over particles of ``grad``
  in both packages) on the same clouds, parameters and times, a NaN
  observation among them, and ``chip_smoke.jacfwd_transition`` (forward
  mode, which phase 14 times beside them): rel 1e-5 / abs 1e-5.
- ``online_score`` at ``tests/test_score.py:33-62``'s size (N = 2000, T =
  150) within that test's tolerance (rel 0.18, abs 2.5) of the exact score,
  ``jax.grad`` of the JAX package's Kalman log-likelihood through
  ``ExtendedKalmanFilter`` (exact on a linear model), as that test takes it.
- Three windows of ``fit_mle_streaming`` with every draw replayed (the
  filter's normals and resample uniforms, and PaRIS's backward indices from
  one tape, as ``tests/test_torch_port_paris.py`` replays them), the JAX
  package's own ``fit_mle_streaming`` run eagerly under
  ``jax.disable_jit()``: the parameter path and the window log-likelihoods
  within rel 1e-5 / abs 1e-6.
- The whole ``online_score`` recursion on the same tape (the score
  functionals inside PaRIS, not only on given clouds), after 2, 4 and 6
  observations: the score, the per-particle statistics and the
  log-likelihood within rel 1e-5.
- The online score's offset from the exact score, over seeds of each
  package at ``tests/test_score.py:33``'s point (``slow``: about 6 minutes
  on one CPU thread). Script mode prints the readings: ``PYTHONPATH=. python
  tests/test_torch_port_score.py --offset SEEDS [--workers W]``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import inference as jinf
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.filters.particle import smoothing as jsmoothing
from pyfilter_tpu.inference import score as jscore
from pyfilter_tpu.ops import systematic_counts as j_counts
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch.filters.particle import smoothing as tsmoothing
from pyfilter_tpu_torch.inference import score as tscore

torch.set_num_threads(1)

ALPHA, OBS_STD = chip_smoke.STREAM_ALPHA, chip_smoke.STREAM_OBS


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


def j_build(ctx):
    """tests/test_score.py's builder (chip_smoke.stream_builder's priors)."""
    beta = ctx.named_parameter("beta", jdist.Normal(0.0, 2.0))
    sigma = ctx.named_parameter("sigma", jdist.LogNormal(-1.0, 1.0))
    return jts.LinearStateSpaceModel(jmodels.AR(ALPHA, beta, sigma), (1.0, OBS_STD))


def t_build(ctx):
    return chip_smoke.stream_builder(pt, ctx)


def _contexts(beta, sigma):
    jctx = jinf.make_context(key=jax.random.PRNGKey(1))
    jctx.set_batch_shape(())
    j_build(jctx)
    jctx.update_parameter("beta", jnp.asarray(beta))
    jctx.update_parameter("sigma", jnp.asarray(sigma))
    tctx = chip_smoke.stream_context(torch, pt, "cpu", beta, sigma)
    pt.convert.set_context_values(tctx, {n: np.asarray(v) for n, v in jctx.parameters.items()})
    return jctx, tctx


def test_score_functionals_match_jax():
    """h_fn on one transition and h_obs_fn on one observation (and on a NaN
    one, which contributes zeros), 256 particles, at beta 0.5, sigma 0.5."""
    jctx, tctx = _contexts(0.5, 0.5)
    jtheta = jctx.stack_parameters(constrained=False)
    ttheta = tctx.stack_parameters(constrained=False)
    _close(ttheta, jtheta, atol=0.0)
    j_h, j_obs = jscore._score_functionals(jctx, j_build, jtheta, 0)
    t_h, t_obs = tscore._score_functionals(tctx, t_build, ttheta, 0)
    rng = np.random.default_rng(0)
    xp, xc = (rng.normal(0.5, 0.6, size=256).astype(np.float32) for _ in range(2))
    got = t_h(torch.from_numpy(xp), torch.from_numpy(xc), 4.0)
    assert got.shape == (256, 2)
    _close(got, j_h(jnp.asarray(xp), jnp.asarray(xc), jnp.asarray(4.0)))
    _close(chip_smoke.jacfwd_transition(torch, pt, tctx, t_build, ttheta, 0)(torch.from_numpy(xp),
                                                                           torch.from_numpy(xc), 4.0), got)
    for y_t in (0.8, float("nan")):
        got = t_obs(torch.from_numpy(xc), torch.tensor(y_t), 4.0)
        _close(got, j_obs(jnp.asarray(xc), jnp.asarray(y_t), jnp.asarray(4.0)))
    assert not t_obs(torch.from_numpy(xc), torch.tensor(float("nan")), 4.0).any()


def test_online_score_matches_the_kalman_score():
    """tests/test_score.py:33-62 on the port: the PaRIS score at beta 0.5,
    sigma 0.5 over 150 observations at N = 2000 against ``jax.grad`` of the
    exact Kalman log-likelihood, and the score by name."""
    y = chip_smoke.stream_data(torch, pt, 150, seed=0)
    jctx, tctx = _contexts(0.5, 0.5)

    def kalman_ll(th):
        ctx2 = jctx.unstack_parameters(th, constrained=False)
        with ctx2.no_prior_verification():
            m = j_build(ctx2)
        return pf.ExtendedKalmanFilter(m).batch_filter(jnp.asarray(y)).log_likelihood

    oracle = np.asarray(jax.grad(kalman_ll)(jctx.stack_parameters(constrained=False))[0])
    np.testing.assert_allclose(oracle, chip_smoke.kalman_score(y, 0.5, 0.5), rtol=1e-4)
    res = pt.inference.online_score(t_build, y, lambda b: pt.SISR(b, 2000, device="cpu"),
                                    torch.Generator().manual_seed(2), context=tctx)
    assert res.score.shape == (2,) and res.stats.shape == (2000, 2)
    np.testing.assert_allclose(res.score.numpy(), oracle, rtol=0.18, atol=2.5)
    assert torch.isfinite(res.log_likelihood)
    by_name = res.by_parameter()
    assert list(by_name) == ["beta", "sigma"] and float(by_name["sigma"][0]) == float(res.score[1])
    with pytest.raises(ValueError, match="batch shape"):
        ctx = pt.inference.make_context(device="cpu")
        ctx.set_batch_shape((2,))
        pt.inference.online_score(t_build, y, lambda b: pt.SISR(b, 16, device="cpu"), context=ctx)


class _Replay:
    """Normals, resample uniforms and backward indices for both packages
    (``tests/test_torch_port_paris.py``'s replay)."""

    def __init__(self, seed):
        self.seed, self.calls, self.uniforms, self.tape = seed, {"jax": 0, "port": 0}, {"jax": 0, "port": 0}, []
        self.asked = {"jax": 0, "port": 0}

    def _next(self, counter, side, offset):
        k = counter[side]
        counter[side] += 1
        return np.random.default_rng((self.seed, offset + k))

    def patch(self, monkeypatch, n):
        rep = self

        def j_sample(self, key, sample_shape=()):
            shape = tuple(sample_shape) + tuple(jnp.broadcast_shapes(jnp.shape(self.loc), jnp.shape(self.scale)))
            return self.loc + self.scale * jnp.asarray(rep._next(rep.calls, "jax", 0).normal(size=shape), jnp.float32)

        def t_sample(self, generator, sample_shape=()):
            z = rep._next(rep.calls, "port", 0).normal(size=tuple(sample_shape) + self.batch_shape)
            return self.loc + self.scale * torch.from_numpy(z.astype(np.float32))

        def indices(side, j):
            k = rep.asked[side]
            rep.asked[side] += 1
            if side == "jax":
                rep.tape.append(np.random.default_rng((rep.seed, 20_000 + k)).integers(0, n, size=j))
            return rep.tape[k]

        def j_back(key, model, vals_t, lw_t, t_t, targets, log_sup, max_rounds=16, block=64, fallback_subset=None,
                   return_violation=False):
            idx = jnp.asarray(indices("jax", targets.shape[0]), jnp.int32)
            return (idx, jnp.asarray(False)) if return_violation else idx

        def t_back(generator, model, vals_t, lw_t, time_index, targets, log_sup, max_rounds=16, block=64):
            return torch.from_numpy(indices("port", targets.shape[0])), torch.zeros((), dtype=torch.bool)

        monkeypatch.setattr(jdist.Normal, "sample", j_sample)
        monkeypatch.setattr(tdist.Normal, "sample", t_sample)
        monkeypatch.setattr(jsmoothing, "backward_indices", j_back)
        monkeypatch.setattr(tsmoothing, "backward_indices", t_back)

    def factories(self, n):
        rep = self

        def j_resampler(key, w, normalized=False):
            u = rep._next(rep.uniforms, "jax", 10_000).uniform()
            return j_counts(None, w, normalized=normalized, u=jnp.asarray(u, jnp.float32))

        class Replay(pt.SISR):
            def resample_uniform(self, generator):
                return torch.tensor(np.float32(rep._next(rep.uniforms, "port", 10_000).uniform()))

        return (lambda b: pf.SISR(b, n, resampling_method=j_resampler)), (lambda b: Replay(b, n, device="cpu"))


def test_streaming_mle_replays_jax_window_for_window(monkeypatch):
    """Three windows of 4 observations (two trailing ones dropped) at N = 64
    from beta 0.3, sigma 0.7, lr 2e-2: the parameters after each window (the
    per-window bound from the parameters, the carried cloud, Adam with
    optax's defaults) and the window log-likelihoods against the JAX
    package's fit on the same draws."""
    n, window = 64, 4
    y = chip_smoke.stream_data(torch, pt, 3 * window + 2, seed=4)
    jctx, tctx = _contexts(0.3, 0.7)
    rep = _Replay(seed=9)
    rep.patch(monkeypatch, n)
    j_factory, t_factory = rep.factories(n)
    with jax.disable_jit():
        jres = jscore.fit_mle_streaming(j_build, jnp.asarray(y), j_factory, jax.random.PRNGKey(3), window=window,
                                        learning_rate=2e-2, context=jctx)
    tres = tscore.fit_mle_streaming(t_build, y, t_factory, None, window=window, learning_rate=2e-2, context=tctx)
    assert rep.asked["port"] == rep.asked["jax"] == 2 * 3 * window
    assert rep.calls["port"] == rep.calls["jax"] and rep.uniforms["port"] == rep.uniforms["jax"]
    assert tres.theta_path.shape == (3, 2) and tres.window_log_likelihoods.shape == (3,)
    _close(tres.theta_path, jres.theta_path, atol=1e-6)
    _close(tres.window_log_likelihoods, jres.window_log_likelihoods, atol=1e-6)
    _close(tres.theta, jres.theta, atol=1e-6)
    fitted, jfitted = tres.parameters(), jres.parameters()
    for name in ("beta", "sigma"):
        _close(fitted[name], jfitted[name], atol=1e-6)
    with pytest.raises(ValueError, match="window"):
        tscore.fit_mle_streaming(t_build, y[:3], t_factory, None, window=window, context=tctx)


@pytest.mark.parametrize("n_obs", [2, 4, 6])
def test_online_score_replays_jax_step_for_step(n_obs, monkeypatch):
    """``online_score`` at N = 64 over the first 2, 4 and 6 observations,
    both packages on one tape of normals, resample uniforms and backward
    indices: the score (each step's, through the prefixes), the statistics
    and the log-likelihood, and the same backward draws asked for."""
    n = 64
    y = chip_smoke.stream_data(torch, pt, n_obs, seed=6)
    jctx, tctx = _contexts(0.5, 0.5)
    rep = _Replay(seed=11)
    rep.patch(monkeypatch, n)
    j_factory, t_factory = rep.factories(n)
    with jax.disable_jit():
        jres = jinf.online_score(j_build, jnp.asarray(y), j_factory, jax.random.PRNGKey(5), context=jctx)
    tres = tscore.online_score(t_build, y, t_factory, None, context=tctx)
    assert rep.asked["port"] == rep.asked["jax"] == 2 * n_obs
    assert rep.calls["port"] == rep.calls["jax"] and rep.uniforms["port"] == rep.uniforms["jax"]
    _close(tres.score, jres.score, atol=0.0)
    _close(tres.stats, jres.stats, atol=1e-6)
    _close(tres.log_likelihood, jres.log_likelihood, atol=0.0)


OFFSET_T, OFFSET_N, OFFSET_POINT = 150, 2000, (0.5, 0.5)


def _offset_run(args):
    """One online score at ``tests/test_score.py:33``'s point, seed ``seed``,
    in ``package`` ("jax" or "port"), on one CPU thread."""
    package, seed = args
    torch.set_num_threads(1)
    y = chip_smoke.stream_data(torch, pt, OFFSET_T, seed=0)
    jctx, tctx = _contexts(*OFFSET_POINT)
    if package == "jax":
        res = jinf.online_score(j_build, jnp.asarray(y), lambda b: pf.SISR(b, OFFSET_N), jax.random.PRNGKey(seed),
                                context=jctx)
        return np.asarray(res.score, np.float64)
    res = tscore.online_score(t_build, y, lambda b: pt.SISR(b, OFFSET_N, device="cpu"),
                              torch.Generator().manual_seed(seed), context=tctx)
    return res.score.double().numpy()


def online_score_offsets(n_seeds, workers=1):
    """Each package's mean score over ``n_seeds`` seeds, its SEM, and the
    offset from the exact (float64 Kalman) score; then the port's offset
    less the JAX package's in combined SEMs."""
    import multiprocessing

    exact = np.asarray(chip_smoke.kalman_score(chip_smoke.stream_data(torch, pt, OFFSET_T, seed=0), *OFFSET_POINT))
    jobs = [(p, s) for p in ("jax", "port") for s in range(100, 100 + n_seeds)]
    if workers > 1:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            scores = pool.map(_offset_run, jobs)
    else:
        scores = [_offset_run(j) for j in jobs]
    out = {"exact": exact}
    for p in ("jax", "port"):
        arr = np.stack([sc for (pp, _), sc in zip(jobs, scores) if pp == p])
        out[p] = {"mean": arr.mean(0), "sem": arr.std(0, ddof=1) / np.sqrt(len(arr)), "offset": arr.mean(0) - exact}
    out["gap_in_sem"] = (out["port"]["offset"] - out["jax"]["offset"]) / np.hypot(out["port"]["sem"],
                                                                                out["jax"]["sem"])
    return out


@pytest.mark.slow
def test_online_score_offset_matches_jax():
    """The port's offset from the exact score is the JAX package's, within 3
    combined SEM in each component, over 16 seeds of each at T = 150, N =
    2000 (Queue 3 item 2 of ROADMAP: the log-sigma component read 0.6% low
    on the card at N = 1e5)."""
    out = online_score_offsets(16)
    assert (np.abs(out["gap_in_sem"]) < 3.0).all(), out


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=online_score_offsets.__doc__)
    parser.add_argument("--offset", type=int, required=True, help="seeds of each package")
    parser.add_argument("--workers", type=int, default=1)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    res = online_score_offsets(args.offset, args.workers)
    np.set_printoptions(precision=6, suppress=True)
    print("exact", res["exact"])
    for p in ("jax", "port"):
        print(p, "mean", res[p]["mean"], "sem", res[p]["sem"], "offset", res[p]["offset"])
    print("port offset - jax offset, combined SEMs:", res["gap_in_sem"])
