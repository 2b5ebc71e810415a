"""The port's resampling schemes (``stratified``, ``multinomial``,
``residual``, ``metropolis``, ``rejection``) held against the JAX package's
``pyfilter_tpu/resampling.py``, and SISR run with each of them.

Exact where the two packages compute the same function of the same numbers:
``stratified`` with injected uniforms, index for index, and ``residual``'s
deterministic part. The random parts draw from different generators, so
their law is held against the weights: a chi-square test of the offspring
counts over many resamples at a fixed seed (p above 1e-3), and, for
``metropolis``, its bias decaying in ``n_iter`` (the JAX package's
``tests/test_resampling.py`` pattern). The filters run the JAX package's
oracle suite on ``"ar"`` (N = 1500, T = 100) under its gates, against the
float64 Kalman filter, and never take the fused resample-and-gather path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import chip_smoke
import pyfilter_tpu_torch as pt
from pyfilter_tpu import resampling as jres
from pyfilter_tpu_torch import resampling as tres
from pyfilter_tpu_torch.filters.particle.base import ParticleFilter

torch.set_num_threads(1)

SCHEMES = ["systematic", "stratified", "multinomial", "residual", "metropolis", "rejection"]
NEW_SCHEMES = SCHEMES[1:]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _weights(n, lanes=(), seed=0, power=1.0):
    w = np.random.default_rng(seed).random((n, *lanes)) ** power
    return (w / w.sum(0)).astype(np.float32)


@pytest.mark.parametrize("n", [10, 100, 1000])
def test_stratified_matches_jax_index_for_index(n):
    w = _weights(n, seed=n)
    u = np.random.default_rng(n + 1).random(n).astype(np.float32)
    want = np.asarray(jres.stratified(None, jnp.asarray(w), normalized=True, u=jnp.asarray(u)))
    got = tres.stratified(None, _t(w), normalized=True, u=_t(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # from log-weights, as the filters pass them
    lw = np.log(w)
    want = np.asarray(jres.stratified(None, jnp.asarray(lw), u=jnp.asarray(u)))
    np.testing.assert_array_equal(tres.stratified(None, _t(lw), u=_t(u)).numpy(), want)


def test_stratified_over_lanes_matches_jax():
    w = _weights(64, (5,), seed=3)
    u = np.random.default_rng(4).random((64, 5)).astype(np.float32)
    want = np.asarray(jres.stratified(None, jnp.asarray(w), normalized=True, u=jnp.asarray(u)))
    np.testing.assert_array_equal(tres.stratified(None, _t(w), normalized=True, u=_t(u)).numpy(), want)


@pytest.mark.parametrize("lanes", [(), (3,)])
def test_residual_deterministic_part_matches_jax(lanes):
    """The first ``sum floor(N w)`` slots are the deterministic copies, in
    particle order: the same in both packages (and at least ``floor(N w_i)``
    copies of each particle, the JAX package's test)."""
    n = 10
    w = np.array([0.5, 0.2, 0.1] + [0.2 / 7] * 7, np.float64)
    w = np.stack([np.roll(w, k) for k in range(int(np.prod(lanes)) or 1)], axis=-1).reshape((n, *lanes))
    w = (w / w.sum(0)).astype(np.float32)
    want = np.asarray(jres.residual(jax.random.PRNGKey(3), jnp.asarray(w), normalized=True))
    got = tres.residual(torch.Generator().manual_seed(3), _t(w), normalized=True).numpy()
    n_det = np.floor(n * w).sum(0).astype(int).reshape(-1)
    for lane, (g, j) in enumerate(zip(got.reshape(n, -1).T, want.reshape(n, -1).T)):
        np.testing.assert_array_equal(g[: n_det[lane]], j[: n_det[lane]])
        counts = np.bincount(g, minlength=n)
        assert np.all(counts >= np.floor(n * w.reshape(n, -1)[:, lane])), counts


@pytest.mark.parametrize("scheme", ["multinomial", "residual", "rejection", "stratified"])
def test_offspring_law_by_chi_square(scheme):
    """Over 400 resamples of one weight vector (the resamples are lanes of
    one call), each particle's offspring count against ``400 N w``: a
    chi-square p above 1e-3 at a fixed seed."""
    n, reps = 50, 400
    w = _weights(n, seed=11, power=2.0)
    idx = getattr(tres, scheme)(torch.Generator().manual_seed(12), _t(np.repeat(w[:, None], reps, 1)),
                                normalized=True)
    assert idx.shape == (n, reps) and idx.dtype == torch.int32
    counts = np.bincount(idx.numpy().ravel(), minlength=n)
    expected = n * reps * w.astype(np.float64)
    assert stats.chisquare(counts, expected / expected.sum() * counts.sum()).pvalue > 1e-3


def test_metropolis_bias_decays_in_chain_length():
    """The JAX package's test: over 256 independent resamples (lanes here),
    the L1 bias of the slot law at ``n_iter=64`` is under 0.3 of that at 2."""
    n, reps = 256, 256
    w = _weights(n, seed=11, power=3.0)
    lanes = _t(np.repeat(w[:, None], reps, 1))

    def bias(n_iter):
        idx = tres.metropolis(torch.Generator().manual_seed(n_iter), lanes, normalized=True, n_iter=n_iter)
        counts = np.bincount(idx.numpy().ravel(), minlength=n)
        return np.abs(counts / (n * reps) - w).sum()

    assert bias(64) < 0.3 * bias(2)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
def test_dtype_shape_and_range(scheme, batch):
    lw = _t(np.random.default_rng(5).normal(size=(200, *batch)))
    idx = getattr(tres, scheme)(torch.Generator().manual_seed(6), lw)
    assert idx.shape == (200, *batch) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < 200


@pytest.mark.parametrize("scheme", ["stratified", "multinomial", "residual"])
def test_log_weights_and_probabilities_agree(scheme):
    """``normalized=True`` on the probabilities gives the indices of the
    log-weights, on the same draws."""
    lw = _t(np.random.default_rng(7).normal(size=(300, 2)))
    fn = getattr(tres, scheme)
    a = fn(torch.Generator().manual_seed(8), lw)
    b = fn(torch.Generator().manual_seed(8), pt.normalize(lw), normalized=True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("scheme", NEW_SCHEMES)
def test_point_mass_and_dead_weights(scheme):
    """All mass on one particle: every slot takes it (``metropolis`` with a
    chain long enough to propose it, as the JAX package's test). All-(-inf)
    log-weights resample as uniform ones: ``stratified`` then gives each
    particle one copy, and every scheme stays in range."""
    n = 50
    w = np.zeros(n, np.float32)
    w[17] = 1.0
    kw = {"n_iter": 1000} if scheme == "metropolis" else {}
    fn = getattr(tres, scheme)
    assert set(fn(torch.Generator().manual_seed(1), _t(w), normalized=True, **kw).tolist()) == {17}
    want = set(np.asarray(getattr(jres, scheme)(jax.random.PRNGKey(1), jnp.asarray(w), normalized=True, **kw)).tolist())
    assert want == {17}
    dead = fn(torch.Generator().manual_seed(2), torch.full((n,), -torch.inf))
    assert dead.shape == (n,) and int(dead.min()) >= 0 and int(dead.max()) < n
    if scheme == "stratified":
        assert np.bincount(dead.numpy(), minlength=n).max() == 1


def test_rejection_keeps_open_slots_after_max_rounds():
    """A slot still open after ``max_rounds`` candidates keeps itself: with
    no rounds at all only the self-test runs."""
    w = _weights(400, seed=9, power=4.0)
    g = torch.Generator().manual_seed(3)
    idx = tres.rejection(g, _t(w), normalized=True, max_rounds=0)
    g = torch.Generator().manual_seed(3)
    kept = torch.log(torch.rand(400, generator=g)) <= torch.log(_t(w)) - torch.log(_t(w)).max()
    assert torch.equal(idx, torch.arange(400, dtype=torch.int32)) and not bool(kept.all())


@pytest.mark.parametrize("scheme", NEW_SCHEMES)
def test_sisr_with_each_scheme_passes_the_oracle(scheme, monkeypatch):
    """Bootstrap SISR with the scheme as its ``resampling_method`` on the
    suite's ``"ar"`` model (N = 1500, T = 100) under the reference's gates
    against the float64 Kalman filter; the fused path is never taken."""

    def no_fused(*args, **kwargs):
        raise AssertionError("an explicit resampler must not take the fused resample")

    monkeypatch.setattr(ParticleFilter, "_fused_resample", no_fused)
    _, y = chip_smoke.oracle_data("ar")
    km, kll = chip_smoke.kalman_linear(y, chip_smoke.oracle_system("ar"))
    filt = pt.SISR(chip_smoke.oracle_model(pt, "ar", "cpu"), chip_smoke.ORACLE_N,
                   resampling_method=getattr(tres, scheme), device="cpu")
    res = filt.batch_filter(torch.Generator().manual_seed(42), y[:, 0])
    dev, ll_err = chip_smoke.oracle_gate(res.filter_means.numpy(), res.log_likelihood.numpy(), km, kll)
    assert filt.n_resamples > 0
    assert dev < chip_smoke.ORACLE_TOL and ll_err < chip_smoke.ORACLE_TOL, (dev, ll_err)
