"""The port's Storvik filter, held against the JAX package.

The closed-form 2x2 helpers, ``update_stats``, the conjugate posteriors and
``posterior_mean`` of all four blocks on the same statistics (rel 1e-5:
float32 arithmetic in two frameworks); one whole pass (NIG AR block, N =
512, T = 80, ``ess_threshold=1.1`` so every step resamples) with the port
taking the JAX run's draws, recomputed from its key schedule outside the
scan (the gamma shape ``a0 + n / 2`` is the same for every particle, since
every particle has seen ``n`` transitions), compared at rel 1e-5 (the final
statistics, sums over the 80 steps, at rel 1e-4); then
tests/test_storvik.py's recovery gates on the port, on the JAX package's data.

The replay seams: ``storvik._gamma`` and ``storvik._standard_normal`` (the
parameter draws), ``Normal.sample`` (the initial cloud and the
propagations), and the resampler: the port takes the JAX run's own ancestor
indices, recorded through a ``jax.debug.callback``. (Fed only the JAX run's
uniforms, the port's exact fixed-point copy counts and the JAX package's
float32 cumulative sum part at a copy-count boundary within 5 to 30 steps at
this size, whatever the key: the log-weights of two float32 frameworks
differ by about 1e-6, and one of the 512 boundaries then crosses one of the
512 positions every 16 steps or so. The fused route's equality with the
resampler route is the next test's.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu_torch as pt
from pyfilter_tpu import inference as jinf
from pyfilter_tpu import resampling as jresampling
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.inference.sequential import storvik as jstorvik
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch.inference.sequential import storvik as tstorvik

torch.set_num_threads(1)

ALPHA, BETA, SIGMA, OBS_STD = 0.2, 0.7, 0.4, 0.25


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


def make_data(n=400, seed=0):
    """tests/test_storvik.py:20's data (the JAX package simulates it)."""
    ssm = jts.LinearStateSpaceModel(jmodels.AR(ALPHA, BETA, SIGMA), (1.0, OBS_STD))
    return np.array(ssm.sample_states(jax.random.PRNGKey(seed), n).get_paths()[1])


def _blocks():
    """(JAX block, port block, state dim) for the four conjugate blocks."""
    return {
        "nig": (jinf.NIGAutoregression(obs_scale=OBS_STD, m0=(0.1, 0.3), v0=4.0, a0=2.0, b0=0.5),
                tinf.NIGAutoregression(obs_scale=OBS_STD, m0=(0.1, 0.3), v0=4.0, a0=2.0, b0=0.5, device="cpu"), 0),
        "nig-obs": (jinf.NIGARUnknownObsVariance(v0=4.0, a0=2.0, b0=0.5, c0=2.0, d0=0.1),
                    tinf.NIGARUnknownObsVariance(v0=4.0, a0=2.0, b0=0.5, c0=2.0, d0=0.1, device="cpu"), 0),
        "poisson": (jinf.PoissonGammaCounts(jmodels.AR(0.0, 0.9, 0.3), a0=2.0, b0=0.5),
                    tinf.PoissonGammaCounts(pt.timeseries.models.AR(0.0, 0.9, 0.3, device="cpu"), a0=2.0, b0=0.5),
                    0),
        "var": (jinf.NIGVectorAutoregression(2, obs_scale=0.1, v0=4.0, a0=2.0, b0=0.3),
                tinf.NIGVectorAutoregression(2, obs_scale=0.1, v0=4.0, a0=2.0, b0=0.3, device="cpu"), 2),
    }


@pytest.mark.parametrize("name", ["nig", "nig-obs", "poisson", "var"])
def test_statistics_posteriors_and_means_match_jax(name):
    """Ten ``update_stats`` steps from ``initial_stats`` on the same random
    paths (a NaN observation among them), then ``_posterior`` and
    ``posterior_mean``, in both packages."""
    jconj, tconj, d = _blocks()[name]
    n = 64
    rng = np.random.default_rng(3)
    jstats, tstats = jconj.initial_stats(n), tconj.initial_stats(n)
    shape = (n, d) if d else (n,)
    x = rng.normal(0.0, 0.5, shape).astype(np.float32)
    for step in range(10):
        x_new = (0.7 * x + rng.normal(0.0, 0.4, shape)).astype(np.float32)
        y = rng.poisson(3.0, (d,) if d else ()).astype(np.float32) if name == "poisson" else \
            rng.normal(0.0, 1.0, (d,) if d else ()).astype(np.float32)
        if step == 4:
            y = np.full_like(y, np.nan)
        jstats = jconj.update_stats(jstats, jnp.asarray(x), jnp.asarray(x_new), jnp.asarray(y))
        tstats = tconj.update_stats(tstats, _t(x), _t(x_new), _t(y))
        x = x_new
    for a, b in zip(tstats, jstats):
        _close(a.numpy(), np.asarray(b))
    if name == "nig-obs":  # the transition's block, then the observation's
        post = list(zip(tconj._posterior(tstats[:4]), jconj._posterior(jstats[:4]))) + list(
            zip(tconj._obs_posterior(tstats), jconj._obs_posterior(jstats)))
    else:
        post = zip(tconj._posterior(tstats), jconj._posterior(jstats))
    for a, b in post:
        if isinstance(a, tuple):  # the closed-form factor
            for u, v in zip(a, b):
                _close(u.numpy(), np.asarray(v))
        elif d and a.dim() == 3 and a.shape[-1] == a.shape[-2] == d + 1:
            _close(a.numpy(), np.asarray(b))  # the Cholesky factor
        else:
            _close(a.numpy() if isinstance(a, torch.Tensor) else a, np.asarray(b))
    for a, b in zip(tconj.posterior_mean(tstats), jconj.posterior_mean(jstats)):
        _close(a.numpy(), np.asarray(b))


def test_closed_form_helpers_match_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(50, 2, 2)).astype(np.float32)
    lam = (a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(2, dtype=np.float32)).astype(np.float32)
    rhs = rng.normal(size=(50, 2)).astype(np.float32)
    tchol, jchol = tstorvik._chol2x2(_t(lam)), jstorvik._chol2x2(jnp.asarray(lam))
    for u, v in zip(tchol, jchol):
        _close(u.numpy(), np.asarray(v))
    _close(tstorvik._cho_solve2x2(tchol, _t(rhs)).numpy(), np.asarray(jstorvik._cho_solve2x2(jchol, jnp.asarray(rhs))))
    _close(tstorvik._solve_upper2x2(tchol, _t(rhs)).numpy(),
           np.asarray(jstorvik._solve_upper2x2(jchol, jnp.asarray(rhs))))
    # the factor reproduces the matrix
    l11, l21, l22 = (t.numpy() for t in tchol)
    _close(np.stack([l11 * l11, l11 * l21, l21 * l21 + l22 * l22], -1),
           np.stack([lam[:, 0, 0], lam[:, 1, 0], lam[:, 1, 1]], -1))


def _jax_draws(key, conj, n, n_obs):
    """The draws of the JAX package's ``StorvikFilter._run`` over the NIG AR
    block from ``key``, in the port's order: the initial theta's gamma and
    normals, the initial cloud's normals, then per step the gamma, the
    coefficients' normals, the propagation's normals and the resample's
    uniform."""
    k_init, k_theta0, k_scan = jax.random.split(key, 3)
    gammas, normals, coefs, uniforms = [], [], [], []

    def theta(k, steps):
        k_sig, k_coef = jax.random.split(k)
        a = jnp.full((n,), conj.a0 + 0.5 * steps, jnp.float32)
        gammas.append(np.asarray(jax.random.gamma(k_sig, a)))
        coefs.append(np.asarray(jax.random.normal(k_coef, (n, 2), jnp.float32)))

    theta(k_theta0, 0)
    normals.append(np.asarray(jax.random.normal(k_init, (n,), jnp.float32)))
    for t, k in enumerate(jax.random.split(k_scan, n_obs)):
        k_theta, k_prop, k_res = jax.random.split(k, 3)
        theta(k_theta, t)
        normals.append(np.asarray(jax.random.normal(k_prop, (n,), jnp.float32)))
        uniforms.append(np.asarray(jax.random.uniform(k_res, (), jnp.float32)))
    return gammas, coefs, normals, uniforms


def test_whole_pass_replays_jax(monkeypatch):
    """tests/test_storvik.py:207's size with every step resampling: the
    port's pass on the JAX run's draws gives its log-likelihood, its running
    posterior means and its final cloud and statistics."""
    y = make_data(80)
    n = 512
    jconj = jinf.NIGAutoregression(obs_coeff=1.0, obs_scale=OBS_STD, m0=(0.0, 0.0), v0=4.0, a0=2.0, b0=0.5)
    key = jax.random.PRNGKey(7)
    recorded = []

    def recording(k, w):
        idx = jresampling.systematic(k, w)
        jax.debug.callback(lambda i: recorded.append(np.array(i)), idx, ordered=True)
        return idx

    jres = jinf.StorvikFilter(jconj, n, ess_threshold=1.1, resampler=recording).fit(key, jnp.asarray(y))
    jax.effects_barrier()
    assert len(recorded) == len(y)
    gammas, coefs, normals, uniforms = (iter(d) for d in _jax_draws(key, jconj, n, len(y)))
    indices = iter(recorded)

    def normal_sample(self, generator, sample_shape=()):
        z = next(normals)
        assert z.shape == tuple(sample_shape) + tuple(self.batch_shape)
        return self.loc + self.scale * _t(z)

    def gamma(generator, concentration):
        g = next(gammas)
        assert g.shape == tuple(concentration.shape)
        return _t(g)

    monkeypatch.setattr(tdist.Normal, "sample", normal_sample)
    monkeypatch.setattr(tstorvik, "_gamma", gamma)
    monkeypatch.setattr(tstorvik, "_standard_normal", lambda generator, shape, like: _t(next(coefs)))
    tconj = tinf.NIGAutoregression(obs_coeff=1.0, obs_scale=OBS_STD, m0=(0.0, 0.0), v0=4.0, a0=2.0, b0=0.5,
                                   device="cpu")
    filt = tinf.StorvikFilter(tconj, n, ess_threshold=1.1, resampler=lambda generator, w: _t(next(indices)),
                              device="cpu")
    tres = filt.fit(None, y)

    assert all(next(it, None) is None for it in (gammas, coefs, normals, indices))
    assert filt.n_resamples == filt.n_host_syncs == len(y)
    _close(tres.log_likelihood.numpy(), np.asarray(jres.log_likelihood))
    for a, b in zip(tres.param_means, jres.param_means):
        assert tuple(a.shape) == np.shape(b) == (len(y),)
        _close(a.numpy(), np.asarray(b))
    # the final cloud, O(1) in spread, at 1e-5 of its scale
    _close(tres.values.numpy(), np.asarray(jres.values), atol=1e-5)
    _close(tres.ess.numpy(), np.asarray(jres.ess))
    # the statistics sum 80 steps of products of states: rel 1e-4, about 4x the
    # largest relative gap they read (2.6e-5; the comparisons above need at most 9.3e-6)
    for a, b in zip(tres.stats, jres.stats):
        _close(a.numpy(), np.asarray(b), rtol=1e-4)
    assert not tres.log_weights.any() and not np.asarray(jres.log_weights).any()


def test_fused_route_equals_the_resampler_route():
    """tests/test_storvik.py:207 on the port: the fused resample of the
    state and the statistics and the resampler plus gather give the same
    pass, bit for bit, from the same generator."""
    y = make_data(80)
    conj = tinf.NIGAutoregression(obs_scale=OBS_STD, v0=4.0, a0=2.0, b0=0.5, device="cpu")
    runs = []
    for fused in (True, False):
        filt = tinf.StorvikFilter(conj, 512, ess_threshold=1.1, fused_resample=fused, device="cpu")
        if not fused:
            filt.resampler = lambda generator, w: pt.resampling.systematic(None, w, u=filt.resample_uniform(generator))
        runs.append(filt.fit(torch.Generator().manual_seed(7), y))
    assert torch.equal(runs[0].log_likelihood, runs[1].log_likelihood)
    for a, b in zip(runs[0].param_means, runs[1].param_means):
        assert torch.equal(a, b)
    assert torch.equal(runs[0].values, runs[1].values)


def test_storvik_recovers_parameters_online():
    """tests/test_storvik.py:33's gates on the port, on its data."""
    y = make_data()
    conj = tinf.NIGAutoregression(obs_coeff=1.0, obs_scale=OBS_STD, m0=(0.0, 0.0), v0=4.0, a0=2.0, b0=0.5,
                                  device="cpu")
    res = tinf.StorvikFilter(conj, 3000, device="cpu").fit(torch.Generator().manual_seed(1), y)
    a_m, b_m, s2_m = (m.numpy() for m in res.param_means)
    assert abs(a_m[-1] - ALPHA) < 0.1, a_m[-1]
    assert abs(b_m[-1] - BETA) < 0.1, b_m[-1]
    assert abs(np.sqrt(s2_m[-1]) - SIGMA) < 0.08, np.sqrt(s2_m[-1])

    def err(t):
        return abs(a_m[t] - ALPHA) + abs(b_m[t] - BETA) + abs(np.sqrt(s2_m[t]) - SIGMA)

    early = np.mean([err(t) for t in range(20, 60)])
    late = np.mean([err(t) for t in range(360, 400)])
    assert late < 0.7 * early, (early, late)
    assert np.isfinite(float(res.log_likelihood))
    assert res.ess.min() > 1.0


def test_other_blocks_recover_on_the_jax_data():
    """tests/test_storvik.py:112-174's gates on the port, each block on the
    JAX package's data for it (NaN rows among them for the unknown
    observation variance)."""
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    conj = tinf.NIGARUnknownObsVariance(obs_coeff=1.0, v0=4.0, a0=2.0, b0=0.5, c0=2.0, d0=0.1, device="cpu")
    res = tinf.StorvikFilter(conj, 3000, device="cpu").fit(gen(11), make_data(500, 10))
    a_m, b_m, s2_m, sy2_m = (float(m[-1]) for m in res.param_means)
    assert abs(a_m - ALPHA) < 0.12 and abs(b_m - BETA) < 0.12, (a_m, b_m)
    assert abs(np.sqrt(s2_m) - SIGMA) < 0.1 and abs(np.sqrt(sy2_m) - OBS_STD) < 0.1, (s2_m, sy2_m)
    y_nan = make_data(120, 12)
    y_nan[30:40] = np.nan
    res2 = tinf.StorvikFilter(conj, 1000, device="cpu").fit(gen(13), y_nan)
    assert np.isfinite(float(res2.log_likelihood)) and abs(float(res2.param_means[1][-1]) - BETA) < 0.25

    jconj = jinf.PoissonGammaCounts(jmodels.AR(0.0, 0.9, 0.3), a0=2.0, b0=0.5)
    yc = np.asarray(jconj.build_model((jnp.asarray(5.0),)).sample_states(jax.random.PRNGKey(14), 400).get_paths()[1])
    conj = tinf.PoissonGammaCounts(pt.timeseries.models.AR(0.0, 0.9, 0.3, device="cpu"), a0=2.0, b0=0.5)
    (lam_m,) = tinf.StorvikFilter(conj, 2000, device="cpu").fit(gen(15), yc).param_means
    assert abs(float(lam_m[-1]) - 5.0) < 0.5, float(lam_m[-1])
    assert abs(float(lam_m[-1]) - 5.0) < abs(float(lam_m[30]) - 5.0) + 0.05

    a_true, sig_true = np.asarray([[0.8, 0.1], [0.0, 0.7]], np.float32), np.asarray([0.3, 0.4], np.float32)
    jvar = jinf.NIGVectorAutoregression(2, obs_scale=0.1, v0=4.0, a0=2.0, b0=0.3)
    yv = np.asarray(jvar.build_model((jnp.asarray(a_true), jnp.zeros(2), jnp.asarray(sig_true))).sample_states(
        jax.random.PRNGKey(16), 500).get_paths()[1])
    conj = tinf.NIGVectorAutoregression(2, obs_scale=0.1, v0=4.0, a0=2.0, b0=0.3, device="cpu")
    res = tinf.StorvikFilter(conj, 2000, device="cpu").fit(gen(17), yv)
    a_m, b_m, s2_m = (m[-1].numpy() for m in res.param_means)
    assert np.abs(a_m - a_true).max() < 0.12 and np.abs(b_m).max() < 0.12, (a_m, b_m)
    assert np.abs(np.sqrt(s2_m) - sig_true).max() < 0.1 and np.isfinite(float(res.log_likelihood))


def test_storvik_refuses_a_block_on_another_device():
    conj = tinf.NIGAutoregression(device="cpu")
    with pytest.raises(ValueError, match="conjugate block lies on"):
        tinf.StorvikFilter(conj, 10, device="meta")
