"""The port's PGAS, held against the JAX package.

``csmc_sweep`` replayed draw for draw against the JAX function at
``observe_every_step`` 1 and 5: the port takes the JAX run's standard normals
(``Normal.sample``) and Gumbels (the ``filters.particle.base.gumbel`` seam),
recomputed from its key schedule, and returns its trajectory within rel 1e-5
(float32 arithmetic in two frameworks). Then the JAX package's own gates on
the port: the conditional SMC kernel leaves the smoothing law invariant
against a float64 RTS smoother (tests/test_pgas.py:23), the trajectory
length is checked (:189), and a short fit of three chains has the shapes
``summarize_chains`` reads (:79).

Run as a script, the file fits phase 16d's configuration with the JAX
package (the source of ``chip_smoke.PGAS_TOL_SD``):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_pgas.py [--workers 4] SEED ...
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
from pyfilter_tpu.inference.batch.mcmc import csmc_sweep as j_csmc_sweep
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch.inference.batch.mcmc import csmc_sweep

torch.set_num_threads(1)

ALPHA, BETA, SIGMA, OBS_STD = 0.2, 0.7, 0.4, 0.3


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _models(oes: int = 1):
    jssm = jts.LinearStateSpaceModel(jts.models.AR(ALPHA, BETA, SIGMA), (1.0, OBS_STD), observe_every_step=oes)
    tssm = pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.AR(ALPHA, BETA, SIGMA, device="cpu"),
                                               (1.0, OBS_STD), observe_every_step=oes)
    return jssm, tssm


def _data(jssm, n_obs, seed, oes=1):
    ys = np.array(jssm.sample_states(jax.random.PRNGKey(seed), n_obs * oes).get_paths()[1])
    return ys[oes - 1:: oes] if oes > 1 else ys


def _jax_csmc_draws(key, n, n_obs, oes, ancestor_sampling=True):
    """The normals and Gumbels of the JAX package's ``csmc_sweep`` from
    ``key``, as the port asks for them: the normals in order (the initial
    cloud, the first move, then each observation's sub-steps), the Gumbels as
    the ancestors' block ``(T, N, N)``, slot 0's block ``(T, N)`` and the
    final draw's ``(N,)``."""
    k_init, k_first, k_scan, k_draw = jax.random.split(key, 4)
    normals = [np.asarray(jax.random.normal(k_init, (n,), jnp.float32))]
    anc, slot0 = [], []

    def ancestors(k):
        k_anc, k_as = jax.random.split(k)
        anc.append(np.asarray(jax.random.gumbel(k_anc, (n, n), jnp.float32)))
        slot0.append(np.asarray(jax.random.gumbel(k_as, (n,), jnp.float32)))

    k_anc0, k_prop0 = jax.random.split(k_first)
    ancestors(k_anc0)
    normals.append(np.asarray(jax.random.normal(k_prop0, (n,), jnp.float32)))
    for k in jax.random.split(k_scan, n_obs - 1):
        k_a, *k_props = jax.random.split(k, 1 + oes)
        ancestors(k_a)
        normals += [np.asarray(jax.random.normal(kp, (n,), jnp.float32)) for kp in k_props]
    gumbels = [np.stack(anc)] + ([np.stack(slot0)] if ancestor_sampling else [])
    gumbels.append(np.asarray(jax.random.gumbel(k_draw, (n,), jnp.float32)))
    return normals, gumbels


@pytest.mark.parametrize("oes,ancestor_sampling", [(1, True), (5, True), (1, False)])
def test_csmc_sweep_replays_jax(monkeypatch, oes, ancestor_sampling):
    n, n_obs = 32, 30 if oes == 1 else 12
    jssm, tssm = _models(oes)
    y = _data(jssm, n_obs, 2, oes)
    if oes == 1:
        y[7] = np.nan  # an all-NaN row: uniform weights
    ref = np.random.default_rng(3).normal(0.5, 0.5, 2 + (n_obs - 1) * oes).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(j_csmc_sweep(key, jssm, jnp.asarray(y), jnp.asarray(ref), n, ancestor_sampling))
    normals, gumbels = (iter(d) for d in _jax_csmc_draws(key, n, n_obs, oes, ancestor_sampling))

    def normal_sample(self, generator, sample_shape=()):
        z = next(normals)
        assert z.shape == tuple(sample_shape) + tuple(self.batch_shape)
        return self.loc + self.scale * _t(z)

    def gumbel(generator, shape, like):
        g = next(gumbels)
        assert g.shape == tuple(shape), (g.shape, shape)
        return _t(g)

    monkeypatch.setattr(tdist.Normal, "sample", normal_sample)
    monkeypatch.setattr(pt.filters.particle.base, "gumbel", gumbel)
    got = csmc_sweep(None, tssm, y, _t(ref), n, ancestor_sampling)
    assert next(normals, None) is None and next(gumbels, None) is None
    assert got.shape == want.shape == (2 + (n_obs - 1) * oes,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # slot 0 carried the reference where the genealogy did not leave it
    assert np.isfinite(got.numpy()).all()


def test_csmc_invariance_matches_rts():
    """tests/test_pgas.py:23 on the port: iterating the kernel at fixed theta
    leaves the smoothing law invariant; the long-run trajectory average
    matches the float64 RTS smoother, the spread its sds."""
    import chip_smoke

    jssm, tssm = _models()
    y = _data(jssm, 40, 0)
    rts_mean, rts_var = chip_smoke.rts_ar(y, ALPHA, BETA, SIGMA, OBS_STD)
    rts_std = np.sqrt(rts_var)
    gen = torch.Generator().manual_seed(1)
    traj = torch.zeros(len(y) + 1)
    trajs = []
    for _ in range(400):
        traj = csmc_sweep(gen, tssm, y, traj, 32)
        trajs.append(traj.numpy())
    trajs = np.asarray(trajs)[100:]
    err = np.abs(trajs.mean(axis=0)[1:] - rts_mean) / rts_std
    assert err.mean() < 0.25, err.mean()
    assert err.max() < 0.8, err.max()
    std_ratio = trajs.std(axis=0)[1:] / rts_std
    assert 0.75 < std_ratio.mean() < 1.25, std_ratio.mean()


def test_csmc_validates_trajectory_length():
    """tests/test_pgas.py:189 on the port."""
    _, tssm = _models(3)
    with pytest.raises(ValueError, match="record_intermediary"):
        csmc_sweep(torch.Generator(), tssm, np.zeros(10, np.float32), torch.zeros(11), 16)


def t_pgas_build(ctx):
    import chip_smoke

    return chip_smoke.pgas_builder(pt, ctx)


def test_pgas_multichain_shapes_and_diagnostics():
    """tests/test_pgas.py:79 on the port: three chains side by side, (S, C)
    records, distinct starts, one retained path per chain, and
    ``summarize_chains``; the context takes chain 0's last draw."""
    jssm, _ = _models()
    y = _data(jssm, 80, 6)
    ctx = tinf.make_context(generator=torch.Generator().manual_seed(7), device="cpu")
    alg = tinf.PGAS(pt.SISR(t_pgas_build, 32, device="cpu"), 40, rw_scale=0.1, num_chains=3, context=ctx,
                    generator=torch.Generator().manual_seed(8), device="cpu")
    res = alg.fit(y)
    assert res.samples["beta"].shape == res.samples["sigma"].shape == (40, 3)
    assert res.trajectory.shape == (3, 81) and np.isfinite(res.trajectory).all()
    assert len(np.unique(res.samples["beta"][0])) == 3
    assert res.as_arrays()["beta"].shape == (40, 3) and 0.0 <= res.acceptance_rate <= 1.0
    summary = tinf.summarize_chains(res)
    assert set(summary) == {"beta", "sigma"}
    assert np.isfinite(summary["beta"]["rhat"]).all() and np.isfinite(summary["beta"]["ess"]).all()
    assert ctx.batch_shape == ()
    assert float(ctx.get_parameter("beta")) == pytest.approx(float(res.samples["beta"][-1, 0]))
    assert not alg.graphed  # a CPU fit replays no CUDA graph


def test_pgas_single_chain_and_initializers():
    """One chain: ``(S,)`` records with a singleton chain axis in
    ``as_arrays``; the ``"sample"`` start keeps the context's draw; an
    unknown initializer refuses."""
    jssm, _ = _models()
    y = _data(jssm, 30, 9)
    ctx = tinf.make_context(generator=torch.Generator().manual_seed(10), device="cpu")
    alg = tinf.PGAS(pt.SISR(t_pgas_build, 16, device="cpu"), 6, initializer="sample", context=ctx,
                    generator=torch.Generator().manual_seed(11), device="cpu")
    res = alg.fit(y)
    assert res.samples["beta"].shape == (6,) and res.as_arrays()["beta"].shape == (6, 1)
    assert res.trajectory.shape == (1, 31)
    with pytest.raises(ValueError, match="initializer"):
        tinf.PGAS(pt.SISR(t_pgas_build, 16, device="cpu"), 6, initializer="median",
                  context=tinf.make_context(device="cpu"), device="cpu")


def j_pgas_build(ctx):
    import chip_smoke

    beta = ctx.named_parameter("beta", jdist.Uniform(0.0, 1.0))
    sigma = ctx.named_parameter("sigma", jdist.LogNormal(-1.0, 1.0))
    return jts.LinearStateSpaceModel(jts.models.AR(chip_smoke.PGAS_ALPHA, beta, sigma), (1.0, chip_smoke.PGAS_OBS))


def _pgas_jax_fit(seed: int) -> dict:
    """One JAX fit of phase 16d's single-chain configuration (a worker
    process): acceptance, the post-burn-in (a quarter) mean and sd by name,
    and its seconds."""
    import time

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke

    y = chip_smoke.pgas_data(torch, pt)
    t0 = time.perf_counter()
    ctx = jinf.make_context(key=jax.random.PRNGKey(seed))
    alg = jinf.PGAS(pf.SISR(j_pgas_build, chip_smoke.PGAS_N), chip_smoke.PGAS_SAMPLES, rw_scale=chip_smoke.PGAS_SCALE,
                    context=ctx, key=jax.random.PRNGKey(seed + 1))
    res = alg.fit(jnp.asarray(y), logging=jinf.logging.DefaultLogger())
    burn = chip_smoke.PGAS_SAMPLES // 4
    post = {n: (float(np.mean(v[burn:])), float(np.std(v[burn:]))) for n, v in res.samples.items()}
    return {"acceptance": res.acceptance_rate, "post": post, "seconds": time.perf_counter() - t0}


def pgas_jax_spread(seeds, workers):
    """The JAX fits behind ``chip_smoke.PGAS_TOL_SD`` over ``seeds`` in
    ``workers`` processes: each fit's post-burn-in means against the exact
    grid posterior, in its sds."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import chip_smoke

    exact = chip_smoke.ar_grid_posterior(chip_smoke.pgas_data(torch, pt), alpha=chip_smoke.PGAS_ALPHA,
                                         obs=chip_smoke.PGAS_OBS, sigma_prior=(-1.0, 1.0))
    print(f"grid posterior: beta {exact['beta']}, sigma {exact['sigma']}", flush=True)
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        fits = list(pool.map(_pgas_jax_fit, seeds))
    gaps = {n: [] for n in ("beta", "sigma")}
    for seed, fit in zip(seeds, fits):
        for n in gaps:
            gaps[n].append((fit["post"][n][0] - exact[n][0]) / exact[n][1])
        print(f"seed {seed}: {fit}; gaps in posterior sd {[round(g[-1], 4) for g in gaps.values()]}", flush=True)
    for n, g in gaps.items():
        print(f"{n}: gaps mean {np.mean(g):+.4f}, spread {np.std(g, ddof=1):.4f}, largest |gap| "
              f"{np.max(np.abs(g)):.4f}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_pgas.py [--workers 4] SEED ...
    import argparse

    parser = argparse.ArgumentParser(description=pgas_jax_spread.__doc__)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("seeds", type=int, nargs="+")
    args = parser.parse_args()
    pgas_jax_spread(args.seeds, args.workers)
