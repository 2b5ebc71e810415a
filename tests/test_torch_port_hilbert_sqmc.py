"""The port's Hilbert sort and SQMC, held against the JAX package's
``pyfilter_tpu/ops/hilbert.py`` and ``pyfilter_tpu/filters/particle/sqmc.py``.

The Hilbert keys and permutations must equal the JAX package's exactly, ties
included (coarse grids tie often, and both sorts are stable). The SQMC pass
is replayed: both packages build the same scrambled-Sobol point sets (scipy,
seeded), and the port takes the JAX run's Cranley-Patterson shifts,
recomputed here from the JAX pass's key schedule (``split(key, 3)`` = the
initial shift, the first step's, the scan's key; per step ``split(k)``; per
lane ``split(key, K)`` first), through its seam ``SQMC.shift_uniform``. The
JAX pass runs jitted. With the shifts equal the ancestors are equal and the
log-likelihood and the moments agree within rel 1e-5 / abs 1e-5 (the
cumulative sums differ only in float32 rounding: the port's is the exact
fixed-point sum, the JAX package's a float32 sum in its own order; no tie
at a boundary falls in these seeds at N = 256, ROADMAP's rule for N <= 4096).
Then ``tests/test_sqmc.py``'s properties on the port itself at a small size.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import distributions as jdist, timeseries as jts
from pyfilter_tpu.ops.hilbert import hilbert_argsort as j_argsort, hilbert_keys as j_keys
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu_torch.filters.particle.sqmc import SQMC as TSQMC
from pyfilter_tpu_torch.ops.hilbert import cloud_argsort

from kalman import KalmanFilter as NumpyKalman

torch.set_num_threads(1)

A, B, S, O = 0.2, 0.7, 0.4, 0.3
N, T = 256, 30
TM, TD = pt.timeseries.models, pt.distributions


def _t(a):
    return torch.from_numpy(np.array(a))


# -- Hilbert ----------------------------------------------------------------------------------


@pytest.mark.parametrize("d,bits", [(2, 4), (3, 3), (2, 2), (4, 16)])
def test_hilbert_keys_and_permutations_match_jax(d, bits):
    """Random grid cells (repeats included) and real clouds whose grid cells
    tie: the ``(hi, lo)`` words and the stable permutations are the JAX
    package's, element for element."""
    rng = np.random.default_rng(d * 100 + bits)
    cells = rng.integers(0, 1 << bits, size=(600, d))
    j_hi, j_lo = j_keys(jnp.asarray(cells, jnp.uint32), bits)
    t_hi, t_lo = pt.ops.hilbert_keys(torch.from_numpy(cells), bits)
    np.testing.assert_array_equal(np.asarray(j_hi, np.int64), t_hi.numpy())
    np.testing.assert_array_equal(np.asarray(j_lo, np.int64), t_lo.numpy())

    cloud = rng.normal(size=(600, d)).astype(np.float32)
    cloud[::7] = cloud[1::7][: len(cloud[::7])]  # exact duplicates: ties at any resolution
    for b in (bits, None):
        np.testing.assert_array_equal(np.asarray(j_argsort(jnp.asarray(cloud), b)),
                                      pt.ops.hilbert_argsort(torch.from_numpy(cloud), b).numpy())


@pytest.mark.parametrize("d,bits", [(2, 4), (3, 3), (4, 3)])
def test_port_hilbert_curve_is_bijective_with_unit_steps(d, bits):
    cells = np.array(list(itertools.product(range(1 << bits), repeat=d)), np.int64)
    hi, lo = pt.ops.hilbert_keys(torch.from_numpy(cells), bits)
    h = (hi.numpy() << 32) | lo.numpy()
    assert sorted(h.tolist()) == list(range((1 << bits) ** d))
    path = cells[np.argsort(h)]
    assert (np.abs(np.diff(path, axis=0)).sum(axis=1) == 1).all()


def test_lane_argsort_is_each_lanes_own():
    """``cloud_argsort`` over ``(N, K, d)`` orders each lane by its own
    min-max rescale, as ``hilbert_argsort`` of that lane; a scalar cloud is
    the plain stable sort."""
    rng = np.random.default_rng(0)
    cloud = torch.from_numpy(rng.normal(size=(300, 3, 2)).astype(np.float32) * np.array([1.0, 5.0, 0.1], np.float32)
                             [:, None])
    got = cloud_argsort(cloud)
    for k in range(3):
        assert torch.equal(got[:, k], pt.ops.hilbert_argsort(cloud[:, k]))
    v = torch.tensor([3.0, -1.0, 2.0, -1.0, 0.5])
    np.testing.assert_array_equal(pt.ops.hilbert_argsort(v).numpy(), np.argsort(v.numpy(), kind="stable"))


# -- SQMC against the JAX package ---------------------------------------------------------------


def jax_shifts(key, d_init: int, dim: int, t_steps: int) -> list:
    """The shifts a single-lane JAX pass draws, in order: the initial
    point set's, then one per step."""
    k_init, k0, k_scan = jax.random.split(key, 3)
    out = [jax.random.uniform(k_init, (d_init,)), jax.random.uniform(k0, (dim,))]
    k = k_scan
    for _ in range(t_steps - 1):
        k, k_use = jax.random.split(k)
        out.append(jax.random.uniform(k_use, (dim,)))
    return [np.asarray(s) for s in out]


def jax_lane_shifts(key, lanes: int, d_init: int, dim: int, t_steps: int) -> list:
    """The shifts of a vmapped JAX pass over ``lanes`` lanes: each draw ``(K, dim)``."""
    per_lane = [jax_shifts(k, d_init, dim, t_steps) for k in jax.random.split(key, lanes)]
    return [np.stack(draws) for draws in zip(*per_lane)]


def ar_data(t_steps=T, seed=3, nan_rows=(10, 11, 12)):
    rng = np.random.default_rng(seed)
    x, ys = A, []
    for _ in range(t_steps):
        x = A + B * x + S * rng.normal()
        ys.append(x + O * rng.normal())
    y = np.asarray(ys, np.float32)
    y[list(nan_rows)] = np.nan
    return y


def _ring_2d(pkg):
    """``tests/test_sqmc.py:98``'s 2-D independent AR chains, in either package."""
    if pkg == "jax":
        hidden = jts.AffineProcess(
            lambda x, beta, q: (A + beta * x.value, q), (jnp.asarray(B), jnp.asarray(S)),
            jdist.Normal(jnp.zeros(2), jnp.ones(2)).to_event(1),
            lambda *_: jdist.Normal(jnp.full(2, A), jnp.full(2, S)).to_event(1))
        return jts.LinearStateSpaceModel(hidden, (1.0, O), event_shape=(2,))
    hidden = pt.timeseries.AffineProcess(
        lambda x, beta, q: (A + beta * x.value, q), (torch.tensor(B), torch.tensor(S)),
        TD.Normal(torch.zeros(2), torch.ones(2)).to_event(1),
        lambda *_: TD.Normal(torch.full((2,), A), torch.full((2,), S)).to_event(1))
    return pt.timeseries.LinearStateSpaceModel(hidden, (1.0, O), event_shape=(2,))


CASES = {
    # name: (proposal, lanes, model pair)
    "bootstrap": ("bootstrap", None, lambda: (jts.LinearStateSpaceModel(jmodels.AR(A, B, S), (1.0, O)),
                                              pt.timeseries.LinearStateSpaceModel(TM.AR(A, B, S, device="cpu"),
                                                                                  (1.0, O)))),
    "guided": ("linear_gaussian", None, lambda: (jts.LinearStateSpaceModel(jmodels.AR(A, B, S), (1.0, 0.15)),
                                                 pt.timeseries.LinearStateSpaceModel(TM.AR(A, B, S, device="cpu"),
                                                                                     (1.0, 0.15)))),
    "2d": ("bootstrap", None, lambda: (_ring_2d("jax"), _ring_2d("torch"))),
    "lanes": ("linear_gaussian", 3, lambda: (
        jts.LinearStateSpaceModel(jmodels.AR(jnp.asarray([0.1, 0.2, 0.3]), B, S), (1.0, O)),
        pt.timeseries.LinearStateSpaceModel(TM.AR(torch.tensor([0.1, 0.2, 0.3]), B, S, device="cpu"), (1.0, O)))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sqmc_matches_jax_on_replayed_shifts(name):
    """Bootstrap and guided SQMC on the AR model with an all-NaN gap, the 2-D
    Hilbert path with a partly missing row, and K = 3 lanes (the guided
    pass, per-lane alpha) against the vmapped JAX pass: the ancestors equal,
    the log-likelihood, the per-step increments and the moments within rel
    1e-5 / abs 1e-5."""
    proposal, lanes, models = CASES[name]
    jssm, tssm = models()
    d = 2 if name == "2d" else 1
    if d == 2:
        rng = np.random.default_rng(5)
        y = (rng.normal(size=(T, 2)) * 0.8 + A).astype(np.float32)
        y[7, 0] = np.nan
        y[15] = np.nan
    else:
        y = ar_data()
    batch = () if lanes is None else (lanes,)
    key = jax.random.PRNGKey(4)
    jres = jax.jit(pf.SQMC(jssm, N, proposal=proposal, record_states=True, batch_shape=batch).batch_filter)(
        key, jnp.asarray(y))
    dim = 1 + d
    shifts = iter(jax_shifts(key, d, dim, T) if lanes is None else jax_lane_shifts(key, lanes, d, dim, T))

    filt = TSQMC(tssm, N, proposal=proposal, record_states=True, batch_shape=batch, device="cpu")
    filt.shift_uniform = lambda generator, dim_: _t(next(shifts))
    tres = filt.batch_filter(None, y)
    assert next(shifts, None) is None

    np.testing.assert_array_equal(np.asarray(jres.states.prev_indices), tres.states.prev_indices.numpy())
    np.testing.assert_allclose(tres.log_likelihood.numpy(), np.asarray(jres.log_likelihood), rtol=1e-5)
    np.testing.assert_allclose(tres.step_log_likelihoods.numpy(), np.asarray(jres.step_log_likelihoods), rtol=1e-5,
                               atol=1e-5)
    for got, want in ((tres.filter_means, jres.filter_means), (tres.filter_variances, jres.filter_variances),
                      (tres.states.values, jres.states.values)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tres.states.time_indexes.numpy(), np.asarray(jres.states.time_indexes))
    if name != "2d":
        gap = np.asarray(tres.step_log_likelihoods)[10:13]
        np.testing.assert_allclose(gap, 0.0, atol=1e-6)  # the all-NaN rows add nothing


def test_sqmc_steps_from_a_converted_jax_state():
    """``convert.sqmc_state_from_numpy``: one guided step from the JAX
    package's initial cloud, on the same shift, gives its ancestors, cloud
    and log-likelihood."""
    jssm, tssm = CASES["guided"][2]()
    jf = pf.SQMC(jssm, N, proposal="linear_gaussian")
    js0 = jax.jit(jf.initialize)(jax.random.PRNGKey(0))
    shift = jax.random.uniform(jax.random.PRNGKey(1), (2,))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32: shift)
        js1, j_anc = jax.jit(lambda s: jf.filter(jax.random.PRNGKey(1), jnp.float32(0.4), s))(js0._replace(
            log_weights=jnp.asarray(np.linspace(-1.0, 0.5, N, dtype=np.float32))))
    ts0 = pt.convert.sqmc_state_from_numpy(np.asarray(js0.values), np.linspace(-1.0, 0.5, N, dtype=np.float32),
                                           np.asarray(js0.time_index), np.asarray(js0.log_likelihood), device="cpu")
    filt = TSQMC(tssm, N, proposal="linear_gaussian", device="cpu")
    filt.shift_uniform = lambda generator, dim: _t(shift)
    ts1, t_anc = filt.filter(None, torch.tensor(0.4), ts0)
    np.testing.assert_array_equal(np.asarray(j_anc), t_anc.numpy())
    np.testing.assert_allclose(ts1.values.numpy(), np.asarray(js1.values), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ts1.log_likelihood), float(js1.log_likelihood), rtol=1e-5)


def test_sqmc_validation_errors():
    """Where the JAX package raises, the port raises."""
    lq = np.linalg.cholesky([[0.3, 0.1], [0.1, 0.2]]).astype(np.float32)
    mvn = pt.timeseries.AffineProcess(lambda x, a: (a * x.value, 1.0), (torch.tensor(0.9),),
                                      TD.MultivariateNormal(torch.zeros(2), scale_tril=_t(lq)),
                                      lambda a: TD.MultivariateNormal(torch.zeros(2), scale_tril=_t(lq)))
    with pytest.raises(ValueError, match="icdf"):
        TSQMC(pt.timeseries.LinearStateSpaceModel(mvn, (1.0, 0.2), event_shape=(2,)), 64, device="cpu")
    coupled = pt.timeseries.AffineProcess(lambda x, b: (b * x.value, 0.4), (torch.tensor(0.7),),
                                          TD.Normal(torch.zeros(2), torch.ones(2)).to_event(1),
                                          lambda *_: TD.Normal(torch.zeros(2), torch.ones(2)).to_event(1))
    ssm = pt.timeseries.LinearStateSpaceModel(coupled, (torch.eye(2), 0.2), event_shape=(2,))
    with pytest.raises(ValueError, match="scalar/per-component"):
        TSQMC(ssm, 64, proposal="linear_gaussian", device="cpu")
    with pytest.raises(ValueError, match="needs the LinearStateSpaceModel"):
        TSQMC(pt.timeseries.StateSpaceModel(TM.AR(A, B, S, device="cpu"), lambda x: TD.Normal(x.value, torch.tensor(
            0.3))), 64, proposal="linear_gaussian", device="cpu")
    with pytest.raises(ValueError, match="proposal must be"):
        TSQMC(ssm, 64, proposal="optimal", device="cpu")
    ar = CASES["bootstrap"][2]()[1]
    with pytest.raises(ValueError, match="initial_state"):
        TSQMC(ar, 16, device="cpu").batch_filter(None, ar_data(), initial_state=object())
    with pytest.raises(ValueError, match="one lane axis"):
        TSQMC(ar, 16, batch_shape=(2, 2), device="cpu").batch_filter(torch.Generator(), ar_data())
    with pytest.raises(ValueError, match="icdf"):
        pf.SQMC(jts.LinearStateSpaceModel(jts.AffineProcess(
            lambda x, a: (a * x.value, 1.0), (jnp.asarray(0.9),),
            jdist.MultivariateNormal(jnp.zeros(2), scale_tril=jnp.asarray(lq)),
            lambda a: jdist.MultivariateNormal(jnp.zeros(2), scale_tril=jnp.asarray(lq))), (1.0, 0.2),
            event_shape=(2,)), 64)


# -- tests/test_sqmc.py's properties on the port ------------------------------------------------


def test_sqmc_variance_reduction_and_exactness():
    """At N = 512 the replicate variance of the log-likelihood is under a
    third of the always-resampling SISR's, the mean pins the float64 Kalman
    value (4 SE + 0.05) and the filter means track the Kalman means."""
    kf = NumpyKalman([[B]], [[1.0]], [[S**2]], [[O**2]], transition_offsets=[A], initial_state_mean=[A],
                     initial_state_covariance=[[S**2]])
    _, y = kf.sample(50, rng=np.random.default_rng(3))
    kalman_means, _, ll_exact = kf.filter(y[:, 0])
    y = y[:, 0].astype(np.float32)
    ssm = CASES["bootstrap"][2]()[1]
    reps = 16
    sq = TSQMC(ssm, 512, device="cpu")
    lls = np.array([float(sq.batch_filter(torch.Generator().manual_seed(i), y).log_likelihood) for i in range(reps)])
    si = pt.SISR(ssm, 512, ess_threshold=1.1, device="cpu")
    lls_s = np.array([float(si.batch_filter(torch.Generator().manual_seed(i), y).log_likelihood) for i in range(reps)])
    assert np.var(lls) < np.var(lls_s) / 3.0, (np.var(lls), np.var(lls_s))
    assert abs(np.mean(lls) - ll_exact) < 4.0 * np.sqrt(np.var(lls) / reps) + 0.05
    res = sq.batch_filter(torch.Generator().manual_seed(0), y)
    assert float(np.sqrt(np.mean((res.filter_means.numpy() - kalman_means[:, 0]) ** 2))) < 0.02


def test_sqmc_history_feeds_the_smoother_and_the_estimators():
    """``record_states=True`` yields a standard FilterHistory: rejection
    FFBSi and the genealogy variance estimators take it unchanged."""
    ssm = CASES["bootstrap"][2]()[1]
    y = ar_data()
    res = TSQMC(ssm, 256, record_states=True, device="cpu").batch_filter(torch.Generator().manual_seed(2), y)
    assert res.states.values.shape == (T + 1, 256)
    assert torch.equal(res.states.prev_indices[0], torch.arange(256, dtype=torch.int32))
    sm = pt.filters.particle.ffbsi_smooth(torch.Generator().manual_seed(3), ssm, res.states, pt.ops.systematic_counts,
                                          n_trajectories=128)
    assert sm.shape == (T + 1, 128) and torch.isfinite(sm).all()
    v = pt.filters.particle.log_likelihood_variance(res)
    assert torch.isfinite(v.variance[-1]) and float(v.variance[-1]) >= 0
    assert pt.filters.particle.filter_mean_variance(res, lag=5).sigma2.shape == (T + 1,)


def test_guided_sqmc_in_pmmh_exchanges_lanes():
    """SQMC built from a context inside PMMH (the example's form at a small
    size): per-chain lanes, the candidate's pass and the lane exchange run,
    and the chains move."""
    inf = pt.inference

    def build(ctx):
        const = lambda v: TM.parameter(v, "cpu")  # noqa: E731
        k = ctx.named_parameter("kappa", TD.Exponential(const(1.0)))
        g = ctx.named_parameter("gamma", TD.Normal(const(0.0), const(1.0)))
        s = ctx.named_parameter("sigma", TD.LogNormal(const(-2.0), const(1.0)))
        return pt.timeseries.LinearStateSpaceModel(TM.OrnsteinUhlenbeck(k, g, s, device="cpu"), (1.0, 0.05))

    rng = np.random.default_rng(5)
    x, ys = 1.0, []
    for _ in range(30):
        x = 1.0 + (x - 1.0) * np.exp(-0.5) + 0.1 * np.sqrt((1 - np.exp(-1.0)) / 1.0) * rng.normal()
        ys.append(x + 0.05 * rng.normal())
    ctx = inf.make_context(generator=torch.Generator().manual_seed(1), device="cpu")
    alg = inf.PMMH(TSQMC(build, 64, proposal="linear_gaussian", device="cpu"), 20, num_chains=2,
                   proposal=inf.RandomWalk(5e-2), context=ctx, generator=torch.Generator().manual_seed(2), device="cpu")
    ch = alg.fit(np.asarray(ys, np.float32), logging=inf.logging.DefaultLogger()).as_arrays()
    assert ch["gamma"].shape == (21, 2) and np.isfinite(ch["gamma"]).all()
    assert np.mean(ch["gamma"][1:] != ch["gamma"][:-1]) > 0.2
