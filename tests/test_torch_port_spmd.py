"""The port's explicit-SPMD tier (``parallel/spmd.py``, ``parallel/enkf.py``),
held against the port's one-process filters draw for draw and, with the
JAX package's ``pyfilter_tpu/parallel/spmd.py`` and ``enkf.py``, against the
oracles of their tests (``tests/test_parallel.py``,
``tests/test_parallel_enkf.py``).

One gloo group of four processes runs every port-side check
(``torch_parallel_group``, ``torch_parallel_checks.spmd_checks``): at four
ranks a halo of one is a real window (at two it holds the whole ring). The
group runs in a thread of this process while the JAX side runs here, on the
conftest's 8-device mesh, on the same observations (numpy, fixed seeds).

- **Draw for draw.** The one-process port filters (SISR, APF with the
  bootstrap and the linear-Gaussian proposal, GPF) run here on a recorded
  numpy tape of every normal draw; each rank replays its slice of the same
  tape (its rows of the initial sample, the sub-step increments and the
  proposal noise) and both take the resample uniforms from one seed. The
  SPMD copy counts are the one-process counts of the same probabilities
  (``collective``), but the probabilities are normalized by all-reduced
  sums, rounded in another order, so a boundary can move: up to the first
  history row where the clouds part, the per-step log-likelihoods, the means
  and the clouds agree within rel/abs 1e-5, with several resamples before
  it. The recursions are the same in the JAX SPMD body and the one-process
  filters, so no case needs the JAX package's oracle instead. The history
  layout (one row a transition, the times the host's float64) equals the
  one-process ``record_states`` + ``record_intermediary`` record; the JAX
  package's GPF records no sub-step and would flatten its history, the
  port's records the same layout for every filter type. ``spmd_enkf`` on a
  replayed tape equals ``EnsembleKalmanFilter`` within 1e-5, with and
  without a localization and with inflation 1.05.
- **The oracles.** The port at P = 4 and the JAX package at P = 8 each meet
  the gates of ``test_parallel.py`` ``:906`` (SISR and LGO against Kalman),
  ``:633`` (APF), ``:794`` (GPF), ``:814`` (Metropolis), ``:692`` (NaN
  skip), ``:567`` and ``:1042`` (FFBS, sub-stepped), ``:1087`` (FFBSi),
  ``:716`` and ``:776`` (predict), ``:601`` and ``:740`` (the VI factor's
  gradient), and ``test_parallel_enkf.py`` ``:20`` and ``:79``. Where a JAX
  test compares with a single-device smoother's estimate, both packages are
  held to the float64 RTS smoother's means, which that estimate estimates,
  at the test's tolerance. Where it compares with a single-device filter's
  or factor's value, the port is held to its own single-device run; the JAX
  package's SPMD runs are held to it by ``tests/test_parallel.py`` itself,
  and here to the oracles and gradient signs only (its single-device
  passes would double this file's compiles).
- **Exchanges, counted by ``_comm``** (in place of the HLO assertions at
  ``test_parallel.py:939,1117`` and ``test_parallel_enkf.py:43``).
"""

import math
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu_torch as pt
from pyfilter_tpu import parallel as jparallel, timeseries as jts
from pyfilter_tpu.filters.particle import proposals as jprop
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu_torch.filters import enkf as tenkf
from pyfilter_tpu_torch.filters.particle.proposals import Bootstrap, LinearGaussianObservations
from torch_parallel_checks import replay_filter, ring_localization, ring_model, spmd_model
from torch_parallel_group import run_group

torch.set_num_threads(1)

WORLD = 4
TOL = 1e-5


# -- data and float64 oracles --------------------------------------------------------------------------------------


def _ar_path(n, seed, alpha=0.0, beta=0.95, sigma=0.3, obs=0.1):
    rng = np.random.default_rng(seed)
    x, xs, y = rng.normal(alpha, sigma), np.empty(n), np.empty(n, np.float32)
    for t in range(n):
        x = alpha + beta * x + sigma * rng.normal()
        xs[t], y[t] = x, x + obs * rng.normal()
    return xs, y


def _port_path(model, n, seed):
    x, y = model.sample_states(torch.Generator().manual_seed(seed), n).get_paths()
    return x.numpy(), y.numpy()


def _rts(y_rows, a, b, s, obs, m0, p0):
    """Float64 Kalman filter and RTS smoother of ``x' = a + b x + s e`` from
    ``x_0 ~ N(m0, p0)``, observed as ``y = x + obs v`` at the rows 1..R-1
    where ``y_rows`` is not NaN. Returns the log-likelihood, the filter
    means (rows 1..) and variances, and the smoothed means (rows 0..)."""
    r = len(y_rows) + 1
    fm, fp, pm, pp = np.zeros(r), np.zeros(r), np.zeros(r), np.zeros(r)
    fm[0], fp[0], ll = m0, p0, 0.0
    for t in range(1, r):
        pm[t], pp[t] = a + b * fm[t - 1], b * b * fp[t - 1] + s * s
        fm[t], fp[t] = pm[t], pp[t]
        yt = float(y_rows[t - 1])
        if not math.isnan(yt):
            var = pp[t] + obs * obs
            ll += -0.5 * ((yt - pm[t]) ** 2 / var + math.log(2 * math.pi * var))
            k = pp[t] / var
            fm[t], fp[t] = pm[t] + k * (yt - pm[t]), (1 - k) * pp[t]
    sm = fm.copy()
    for t in range(r - 2, -1, -1):
        sm[t] = fm[t] + fp[t] * b / pp[t + 1] * (sm[t + 1] - pm[t + 1])
    return ll, fm[1:], fp[1:], sm


def _ar_oracle(y):
    return _rts(y, 0.0, 0.95, 0.3, 0.1, 0.0, 0.09)


def _ou3_rows(y, oes=3):
    """The observations of a sub-stepped history's rows 1.. (NaN where unobserved)."""
    rows = np.full(1 + (len(y) - 1) * oes, np.nan)
    rows[0::oes] = y
    return rows


def _ou_ab(kappa, gamma, sigma):
    decay = math.exp(-kappa)
    return gamma * (1 - decay), decay, sigma * math.sqrt((1 - decay**2) / (2 * kappa))


# -- the one-process runs on a recorded tape --------------------------------------------------------------------------


def _record(seed, fn):
    """``fn()`` with every normal draw taken from a numpy generator and kept:
    ``(result, tape)``."""
    rng, tape = np.random.default_rng(seed), []

    def draw(shape):
        z = rng.standard_normal(tuple(shape)).astype(np.float32)
        tape.append(z)
        return torch.from_numpy(z)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(pt.distributions.Normal, "sample", lambda self, generator, sample_shape=(): (
            self.loc + self.scale * draw(tuple(sample_shape) + tuple(self.batch_shape))))
        m.setattr(tenkf, "_standard_normal", lambda generator, shape, like: draw(shape))
        return fn(), tape


REPLAY = {  # name: (filter type, linear-Gaussian proposal, observe_every_step)
    "sisr": ("sisr", False, 1), "sisr-lgo": ("sisr", True, 1), "apf": ("apf", False, 1),
    "apf-lgo": ("apf", True, 1), "gpf": ("gpf", False, 1), "sisr-oes5": ("sisr", False, 5),
}
REPLAY_N = 512
ENKF_REPLAY = {"enkf": (0.0, 1.0), "enkf-localized": (2.0, 1.0), "enkf-inflated": (2.0, 1.05)}  # radius, inflation


def _one_process(name, y):
    ft, lgo, oes = REPLAY[name]
    case = {"filter": ft, "lgo": lgo, "oes": oes, "n": REPLAY_N, "seed": 40 + list(REPLAY).index(name), "y": y}
    model, proposal = replay_filter(case)
    cls = {"sisr": pt.SISR, "apf": pt.APF, "gpf": pt.GPF}[ft]
    kw = {} if ft == "gpf" else {"proposal": proposal}
    filt = cls(model, REPLAY_N, record_states=True, record_intermediary=True, device="cpu", **kw)
    res, tape = _record(7, lambda: filt.batch_filter(torch.Generator().manual_seed(case["seed"]), y))
    case["tape"] = tape
    return case, res


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    truth, ar_y = _ar_path(60, 0)
    ar_y_nan = ar_y.copy()
    ar_y_nan[20:30] = np.nan
    gap = ar_y[:40].copy()
    gap[15:20] = np.nan  # an all-NaN gap in every replay
    _, ou5 = _port_path(spmd_model("ou", 5), 20 * 5, 1)
    ou5 = ou5[~np.isnan(ou5)]
    _, ou3 = _port_path(spmd_model("ou", 3), 20 * 3, 2)
    ou3 = ou3[~np.isnan(ou3)]
    _, ou_y = _port_path(spmd_model("ou"), 50, 3)
    _, trend_y = _port_path(spmd_model("trend"), 30, 4)
    trend2 = pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.TrendingOU(0.5, 1.0, 0.05, 0.2, device="cpu"),
                                                 (1.0, 0.1))
    _, trend2_y = _port_path(trend2, 30, 5)
    _, enkf_y = _port_path(spmd_model("ar-enkf"), 60, 6)

    replay, one = {}, {}
    for name in REPLAY:
        replay[name], one[name] = _one_process(name, ou5 if name == "sisr-oes5" else gap)
    enkf_replay, enkf_one = {}, {}
    ring_y = np.random.default_rng(8).normal(size=(10, 8)).astype(np.float32)
    for name, (radius, inflation) in ENKF_REPLAY.items():
        loc = ring_localization(8, radius) if radius else None
        filt = pt.EnsembleKalmanFilter(ring_model(8), 40, inflation=inflation, localization=loc, device="cpu")
        enkf_one[name], tape = _record(9, lambda: filt.batch_filter(None, ring_y))
        enkf_replay[name] = {"d": 8, "m": 40, "radius": radius, "inflation": inflation, "y": ring_y, "tape": tape}

    payload = {"replay": replay, "enkf_replay": enkf_replay, "ar_y": ar_y, "ar_y_nan": ar_y_nan, "ou3_y": ou3,
               "ou_y": ou_y, "trend_y": trend_y, "trend2_y": trend2_y, "enkf_y": enkf_y}
    group = {}

    def start():
        try:
            group["ranks"] = run_group("spmd_checks", WORLD, payload, tmp_path_factory.mktemp("spmd"))
        except BaseException as err:  # re-raised below, in the test's thread
            group["error"] = err

    thread = threading.Thread(target=start)
    thread.start()
    try:
        jax_side = _jax_side(payload)
    finally:
        thread.join()
    if "error" in group:
        raise group["error"]
    single = {k: v for r in group["ranks"] for k, v in r["single"].items()}
    data = {"truth": truth, "payload": payload, "one": one, "enkf_one": enkf_one, "single": single}
    return data, group["ranks"], jax_side


def _jax_filters(payload, mesh, key) -> dict:
    ar = jts.LinearStateSpaceModel(jmodels.AR(0.0, 0.95, 0.3), (1.0, 0.1))
    y, y_nan = jnp.asarray(payload["ar_y"]), jnp.asarray(payload["ar_y_nan"])
    lgo = jprop.LinearGaussianObservations()
    out = {}
    for name, data, kw in (("sisr", y, {}), ("sisr-lgo", y, {"proposal": lgo}), ("apf", y, {"filter_type": "apf"}),
                           ("apf-lgo", y, {"filter_type": "apf", "proposal": lgo}), ("gpf", y, {"filter_type": "gpf"}),
                           ("metropolis", y, {"resampler": "metropolis", "metropolis_iters": 128}),
                           *((f"nan-{ft}", y_nan, {"filter_type": ft}) for ft in ("sisr", "apf", "gpf"))):
        _, _, ll, means = jparallel.spmd_batch_filter(ar, 4096, key, data, mesh, **kw)
        out[name] = {"ll": float(ll), "means": np.asarray(means)}
    return out


def _jax_smoothing(payload, mesh, key) -> dict:
    ar = jts.LinearStateSpaceModel(jmodels.AR(0.0, 0.95, 0.3), (1.0, 0.1))
    _, _, _, means, hist = jparallel.spmd_batch_filter(ar, 2048, key, jnp.asarray(payload["ar_y"][:50]), mesh,
                                                       record_history=True)
    exact = jparallel.spmd_smooth(ar, jax.random.PRNGKey(7), hist, mesh, n_trajectories=512)
    out = {"ffbs": {"sm": np.asarray(exact), "means": np.asarray(means)}}
    out["ffbsi"] = {"exact": np.asarray(exact), **{
        name: np.asarray(jparallel.spmd_smooth(ar, jax.random.PRNGKey(8), hist, mesh, n_trajectories=512, **kw))
        for name, kw in (("rej", {"method": "ffbsi"}), ("forced", {"method": "ffbsi", "max_rounds": 0}))}}

    oup = jts.LinearStateSpaceModel(jmodels.OrnsteinUhlenbeck(0.5, 1.0, 0.2), (1.0, 0.05))
    means, variances = jparallel.spmd_predict(oup, key, jnp.full((8192,), 3.0), jnp.zeros((8192,)), 10, mesh,
                                              time_index=0)
    out["predict"] = {"means": np.asarray(means), "variances": np.asarray(variances)}
    trend = jts.LinearStateSpaceModel(jmodels.TrendingOU(0.5, 1.0, 0.05, 0.1), (1.0, 0.05))
    vals, lw, _, _ = jparallel.spmd_batch_filter(trend, 2048, key, jnp.asarray(payload["trend_y"]), mesh)
    out["predict-trend"] = np.asarray(jparallel.spmd_predict(trend, key, vals, lw, 5, mesh, time_index=30)[0])

    enkf = jts.LinearStateSpaceModel(jmodels.AR(0.2, 0.7, 0.4), (1.0, 0.25))
    res = jparallel.spmd_enkf(enkf, 4000, jax.random.PRNGKey(1), jnp.asarray(payload["enkf_y"]), mesh)
    out["enkf"] = {"ll": float(res.log_likelihood), "means": np.asarray(res.filter_means),
                   "variances": np.asarray(res.filter_variances)}
    return out


def _jax_factors(payload, mesh, key) -> dict:
    ou3 = jts.LinearStateSpaceModel(jmodels.OrnsteinUhlenbeck(0.5, 1.0, 0.1), (1.0, 0.05), observe_every_step=3)
    y3 = jnp.asarray(payload["ou3_y"])
    *_, hist = jparallel.spmd_batch_filter(ou3, 1024, key, y3, mesh, record_history=True)
    sm = jparallel.spmd_smooth(ou3, jax.random.PRNGKey(7), hist, mesh, n_trajectories=256)
    out = {"ffbs-oes3": {"sm": np.asarray(sm), "times": np.asarray(hist[2])}}

    ou_y, trend_y = jnp.asarray(payload["ou_y"]), jnp.asarray(payload["trend2_y"])

    def ou_factor(gamma):
        m = jts.LinearStateSpaceModel(jmodels.OrnsteinUhlenbeck(0.5, gamma, 0.1), (1.0, 0.05))
        return jparallel.spmd_smoothed_log_likelihood(m, 1024, key, ou_y, mesh, n_trajectories=128)

    def trend_factor(beta, m_traj):
        m = jts.LinearStateSpaceModel(jmodels.TrendingOU(0.5, 1.0, beta, 0.2), (1.0, 0.1))
        return jparallel.spmd_smoothed_log_likelihood(m, 512, key, trend_y, mesh, n_trajectories=m_traj)

    ou_vg = jax.jit(jax.value_and_grad(ou_factor))
    trend_vg = jax.jit(jax.value_and_grad(lambda b: trend_factor(b, 128)))
    out["vi"] = {"low": ou_vg(jnp.asarray(0.7)), "high": ou_vg(jnp.asarray(1.3))[1]}
    out["vi-trend"] = {"low": trend_vg(jnp.asarray(0.01))}
    return out


def _jax_side(payload) -> dict:
    """The JAX package's SPMD functions on the conftest's 8-device mesh, on the
    same observations as the port: three independent jobs in threads, so
    that their compiles overlap."""
    mesh, key = jparallel.make_mesh(), jax.random.PRNGKey(0)
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(job, payload, mesh, key) for job in (_jax_factors, _jax_filters, _jax_smoothing)]
        return {k: v for job in jobs for k, v in job.result().items()}


# -- draw for draw against the one-process filters --------------------------------------------------------------------


def _whole(ranks, name, key, axis=1):
    return np.concatenate([r["replay"][name][key] for r in ranks], axis=axis)


@pytest.mark.parametrize("name", list(REPLAY))
def test_replayed_spmd_filter_matches_one_process(case, name):
    """Each rank's slice of the one-process tape gives the one-process run's
    cloud: the history rows, per-step log-likelihoods and means agree within
    1e-5 up to the first row where a moved copy-count boundary parts the
    clouds, with several resamples before it; the history layout is the
    one-process record's, the times the host's float64."""
    data, ranks, _ = case
    one, r0 = data["one"][name], ranks[0]["replay"][name]
    ft, _, oes = REPLAY[name]
    hv, hv_one = _whole(ranks, name, "hist_values"), one.states.values.numpy()
    assert hv.shape == hv_one.shape == (2 + (len(data["payload"]["replay"][name]["y"]) - 1) * oes, REPLAY_N)
    np.testing.assert_array_equal(r0["times"], one.states.time_indexes.numpy())
    assert r0["times_dtype"] == "torch.float64"

    # the one-process resamples: the steps whose corrected row's ancestors are not the identity
    n_steps = len(r0["means"])
    idx_one = one.states.prev_indices.numpy()
    fired = [t for t in range(n_steps) if (idx_one[1 + t * oes] != np.arange(REPLAY_N)).any()]
    spmd_idx = [np.concatenate([r["replay"][name]["ancestors"][k] for r in ranks]) for k in range(r0["fires"])]
    same = [k < len(fired) and np.array_equal(spmd_idx[k], idx_one[1 + fired[k] * oes]) for k in range(r0["fires"])]
    moved = same.index(False) if False in same else len(same)
    if ft == "gpf":
        assert r0["fires"] == len(fired) == 0
    else:
        assert moved >= 3, f"the copy counts parted at resample {moved}"
    # the rows and steps before the first moved boundary's step
    steps = fired[moved] if moved < len(fired) else n_steps
    rows = 1 + max(steps - 1, 0) * oes + (steps > 0)
    np.testing.assert_allclose(hv[:rows], hv_one[:rows], rtol=TOL, atol=TOL)
    for r in ranks:
        s = r["replay"][name]
        np.testing.assert_allclose(s["incs"][:steps], one.step_log_likelihoods.numpy()[:steps], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(s["means"][:steps], one.filter_means.numpy()[:steps], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(s["means"], r0["means"])  # replicated
        np.testing.assert_array_equal(s["ll"], r0["ll"])
    if steps == n_steps:
        assert r0["fires"] == len(fired)
        np.testing.assert_allclose(_whole(ranks, name, "values", 0), one.latest_state.x.value.numpy(), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(r0["ll"], float(one.log_likelihood), rtol=TOL, atol=TOL)
    # the all-NaN gap adds nothing to the log-likelihood
    gap = np.isnan(data["payload"]["replay"][name]["y"])
    assert gap.sum() == (0 if oes > 1 else 5) and (r0["incs"][gap] == 0.0).all()


@pytest.mark.parametrize("name", list(ENKF_REPLAY))
def test_replayed_spmd_enkf_matches_one_process(case, name):
    """``spmd_enkf`` on each rank's slice of the one-process tape equals
    ``EnsembleKalmanFilter`` on the whole tape within 1e-5: the member means
    and anomaly products are all-reduced sums, the localization tapers them
    after the sum, the inflation uses the all-reduced mean; all-reduces only."""
    data, ranks, _ = case
    one = data["enkf_one"][name]
    for r in ranks:
        s = r["replay"][name]
        np.testing.assert_allclose(s["lls"], one.step_log_likelihoods.numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(s["means"], one.filter_means.numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(s["variances"], one.filter_variances.numpy(), rtol=TOL, atol=TOL)
        assert s["comm"]["all_gather"]["calls"] == s["comm"]["ring_shift"]["calls"] == 0
    np.testing.assert_allclose(np.concatenate([r["replay"][name]["ensemble"] for r in ranks]),
                               one.latest_state.ensemble.numpy(), rtol=TOL, atol=TOL)


# -- the JAX tests' oracles, for both packages -----------------------------------------------------------------------


def _both(case, key):
    _, ranks, jax_side = case
    return {"port": ranks[0]["oracle"][key], "jax": jax_side[key]}


@pytest.mark.parametrize("name,ll_tol", [("sisr", 1.2), ("sisr-lgo", 0.6)])
def test_spmd_filter_matches_kalman(case, name, ll_tol):
    """``:906``: the bootstrap SPMD filter within 1.2 nats of Kalman (the LGO
    proposal within 0.6) and its means within 0.08, N = 4096; the cloud stays
    sharded (each rank N/P particles)."""
    data, ranks, _ = case
    ll_k, m_k, _, _ = _ar_oracle(data["payload"]["ar_y"])
    for side, r in _both(case, name).items():
        assert abs(r["ll"] - ll_k) < ll_tol, (side, r["ll"], ll_k)
        np.testing.assert_allclose(r["means"], m_k, atol=0.08, err_msg=side)
    assert all(r["oracle"][name]["shape"] == (4096 // WORLD,) for r in ranks)


def test_spmd_apf_matches_kalman(case):
    """``:633``: the bootstrap APF's means within 0.08 of Kalman, and the
    port's log-likelihood within 6 nats of its single-device APF's (it
    scatters widely on this model); the LGO APF within 0.6 nats of Kalman."""
    data, _, _ = case
    ll_k, m_k, _, _ = _ar_oracle(data["payload"]["ar_y"])
    for side, r in _both(case, "apf").items():
        np.testing.assert_allclose(r["means"], m_k, atol=0.08, err_msg=side)
    port = _both(case, "apf")["port"]
    assert abs(port["ll"] - data["single"]["apf"]) < 6.0, (port["ll"], data["single"]["apf"])
    for side, r in _both(case, "apf-lgo").items():
        assert abs(r["ll"] - ll_k) < 0.6, (side, r["ll"], ll_k)
        np.testing.assert_allclose(r["means"], m_k, atol=0.08, err_msg=side)


def test_spmd_gpf_matches_kalman(case):
    """``:794``: the GPF within 1.2 nats of Kalman (the port's also of its
    single-device GPF) and its means within 0.08."""
    data, _, _ = case
    ll_k, m_k, _, _ = _ar_oracle(data["payload"]["ar_y"])
    for side, r in _both(case, "gpf").items():
        assert abs(r["ll"] - ll_k) < 1.2, (side, r["ll"], ll_k)
        np.testing.assert_allclose(r["means"], m_k, atol=0.08, err_msg=side)
    port = _both(case, "gpf")["port"]
    assert abs(port["ll"] - data["single"]["gpf"]) < 1.2, (port["ll"], data["single"]["gpf"])


def test_spmd_metropolis_matches_kalman(case):
    """``:814``: the Metropolis resampler (128 steps a slot) within 1.2 nats
    and 0.1 of Kalman."""
    data, _, _ = case
    ll_k, m_k, _, _ = _ar_oracle(data["payload"]["ar_y"])
    for side, r in _both(case, "metropolis").items():
        assert abs(r["ll"] - ll_k) < 1.2, (side, r["ll"], ll_k)
        np.testing.assert_allclose(r["means"], m_k, atol=0.1, err_msg=side)


@pytest.mark.parametrize("filter_type", ["sisr", "apf", "gpf"])
def test_spmd_nan_skip(case, filter_type):
    """``:692``: an all-NaN gap is skipped; the NaN-aware Kalman filter's
    log-likelihood within 1.2 (not the bootstrap APF's) and means within 0.15."""
    data, _, _ = case
    ll_k, m_k, _, _ = _ar_oracle(data["payload"]["ar_y_nan"])
    for side, r in _both(case, f"nan-{filter_type}").items():
        assert np.isfinite(r["ll"])
        if filter_type != "apf":
            assert abs(r["ll"] - ll_k) < 1.2, (side, r["ll"], ll_k)
        np.testing.assert_allclose(r["means"], m_k, atol=0.15, err_msg=side)


def test_spmd_ffbs_matches_oracle(case):
    """``:567``: the history spans t = 0..T; FFBS's trajectory means beat the
    filter means against the truth (within 5%) and lie within 0.08 of the
    smoothing means (the RTS smoother's, which the single-device FFBS of the
    JAX test estimates)."""
    data, ranks, _ = case
    truth = data["truth"][:50]
    _, _, _, rts = _ar_oracle(data["payload"]["ar_y"][:50])
    assert ranks[0]["oracle"]["ffbs"]["hist_shapes"] == [(51, 2048 // WORLD), (51, 2048 // WORLD), (51,)]
    for side, r in _both(case, "ffbs").items():
        assert r["sm"].shape == (51, 512)
        sm_mean = r["sm"].mean(axis=1)
        filt_rmse = float(np.sqrt(np.mean((r["means"] - truth) ** 2)))
        sm_rmse = float(np.sqrt(np.mean((sm_mean[1:] - truth) ** 2)))
        assert sm_rmse <= filt_rmse * 1.05, (side, sm_rmse, filt_rmse)
        np.testing.assert_allclose(sm_mean, rts, atol=0.08, err_msg=side)
    for r in ranks:
        np.testing.assert_array_equal(r["oracle"]["ffbs"]["sm"], ranks[0]["oracle"]["ffbs"]["sm"])  # replicated


def test_spmd_ffbs_substepped(case):
    """``:1042``: with observe_every_step = 3 the history holds every
    transition (2 + 19 * 3 rows, times 0, 1, ...), FFBS's means lie within
    0.08 of the smoothing means; the port's VI factor is finite and within
    rel 0.15 / abs 3 of its single-device factor."""
    data, ranks, _ = case
    y = data["payload"]["ou3_y"]
    a, b, s = _ou_ab(0.5, 1.0, 0.1)
    _, _, _, rts = _rts(_ou3_rows(y), a, b, s, 0.05, 1.0, 0.01)
    port = ranks[0]["oracle"]["ffbs-oes3"]
    assert port["len"] == 2 + 19 * 3
    for side, r in _both(case, "ffbs-oes3").items():
        np.testing.assert_allclose(r["times"], np.arange(2 + 19 * 3), atol=1e-5, err_msg=side)
        assert r["sm"].shape == (2 + 19 * 3, 256)
        np.testing.assert_allclose(r["sm"].mean(axis=1), rts, atol=0.08, err_msg=side)
    assert np.isfinite(port["factor"])
    np.testing.assert_allclose(port["factor"], data["single"]["ou3_factor"], rtol=0.15, atol=3.0)


def test_spmd_ffbsi_matches_exact_pass(case):
    """``:1087``: rejection FFBSi and its forced fallback (``max_rounds=0``)
    have the exact pass's means (0.06) and spread (rel 0.35); the port reads
    the host once a backward step."""
    _, ranks, _ = case
    for side, r in _both(case, "ffbsi").items():
        m_e = r["exact"].mean(axis=1)
        assert r["rej"].shape == r["forced"].shape == r["exact"].shape == (51, 512)
        np.testing.assert_allclose(r["rej"].mean(axis=1), m_e, atol=0.06, err_msg=side)
        np.testing.assert_allclose(r["forced"].mean(axis=1), m_e, atol=0.06, err_msg=side)
        np.testing.assert_allclose(r["rej"].std(axis=1), r["exact"].std(axis=1), rtol=0.35, atol=0.01, err_msg=side)
    port = ranks[0]["oracle"]["ffbsi"]
    assert port["host_reads"] == 50 and 0 <= port["fallback_passes"] <= 50


def test_spmd_predict(case):
    """``:716``: the predictive moments from x0 = 3 track the OU's closed form
    (means 0.02; variances rel 0.1, abs 5e-4); ``:776``: a trending cloud
    filtered to t = 30 predicts along the trend (0.35)."""
    t = np.arange(1, 11)
    decay = np.exp(-0.5 * t)
    want_mean, want_var = 1.0 + 2.0 * decay, 0.2**2 * (1 - decay**2) / (2 * 0.5)
    for side, r in _both(case, "predict").items():
        assert r["means"].shape == r["variances"].shape == (10,)
        np.testing.assert_allclose(r["means"], want_mean, atol=0.02, err_msg=side)
        np.testing.assert_allclose(r["variances"], want_var, rtol=0.1, atol=5e-4, err_msg=side)
    for side, r in _both(case, "predict-trend").items():
        np.testing.assert_allclose(r, 1.0 + 0.05 * np.arange(31, 36), atol=0.35, err_msg=side)


def test_spmd_vi_factor_gradients(case):
    """``:601``: the VI factor's gradient in the OU's gamma points to the
    truth from both sides; ``:740``: on a time-inhomogeneous model the
    gradient in the trend slope points up from below. The port's factor at
    the truth is also within 3 nats of its single-device factor, and at M =
    T within 8 nats of M = 128's and of the single-device pass's."""
    data, ranks, jax_side = case
    port, port_t = ranks[0]["oracle"]["vi"], ranks[0]["oracle"]["vi-trend"]
    jv, jt = jax_side["vi"], jax_side["vi-trend"]
    sides = {"port": (port["low"][0], port["low"][1], port["high"][1], port_t["low"][1]),
             "jax": (float(jv["low"][0]), float(jv["low"][1]), float(jv["high"]), float(jt["low"][1]))}
    for side, (val, g_low, g_high, gt_low) in sides.items():
        assert np.isfinite(val) and g_low > 0 and g_high < 0 and gt_low > 0, (side, val, g_low, g_high, gt_low)
    assert abs(port["true"][0] - data["single"]["ou_factor"]) < 3.0, (port["true"], data["single"]["ou_factor"])
    v_eq, v_ref = port_t["eq"][0], port_t["ref"][0]
    assert abs(v_eq - v_ref) < 8.0 and abs(data["single"]["trend_factor"] - v_ref) < 8.0, (v_eq, v_ref)


def test_spmd_enkf_matches_kalman(case):
    """``test_parallel_enkf.py:20``: M = 4000 members within 1 nat of Kalman,
    means within 0.05, variances rel 0.15; each rank holds M/P members."""
    data, ranks, _ = case
    ll_k, m_k, v_k, _ = _rts(data["payload"]["enkf_y"], 0.2, 0.7, 0.4, 0.25, 0.2, 0.16)
    for side, r in _both(case, "enkf").items():
        assert abs(r["ll"] - ll_k) < 1.0, (side, r["ll"], ll_k)
        np.testing.assert_allclose(r["means"][:, 0], m_k, atol=0.05, err_msg=side)
        np.testing.assert_allclose(r["variances"][:, 0], v_k, rtol=0.15, err_msg=side)
    assert all(r["oracle"]["enkf"]["shape"] == (4000 // WORLD, 1) for r in ranks)


def test_spmd_enkf_rejects_indivisible_ensemble(case):
    """``test_parallel_enkf.py:79``: 1001 members do not split over 4 ranks."""
    _, ranks, _ = case
    for r in ranks:
        assert r["oracle"]["enkf_indivisible"] is not None and "divide" in r["oracle"]["enkf_indivisible"]


# -- exchanges and devices ------------------------------------------------------------------------------------------


def test_quiet_steps_make_all_reduces_only(case):
    """An SISR step that does not resample exchanges by all-reduce alone: six
    of a scalar each (the ESS, the log-likelihood's max and sum, the
    normalization's max and sum, the mean), after the first normalization's
    two."""
    _, ranks, _ = case
    for r in ranks:
        quiet = r["comm"]["quiet"]
        assert quiet["fires"] == 0 and quiet["comm"]["all_reduce"]["calls"] == 2 + 6 * 10
        assert quiet["comm"]["all_reduce"]["bytes"] == 4 * (2 + 6 * 10)
        assert quiet["comm"]["all_gather"]["calls"] == quiet["comm"]["ring_shift"]["calls"] == 0


@pytest.mark.parametrize("halo", [1, 2])
def test_firing_steps_exchange_the_halo(case, halo):
    """A resample whose ancestors fit the window makes ``2 * halo`` ring
    shifts of one shard for each leaf it moves (the int64 prefix sums and the
    values) and one all-gather of the P shard totals, nothing larger."""
    _, ranks, _ = case
    n_local = 1024 // WORLD
    for r in ranks:
        run = r["comm"][f"fire-h{halo}"]
        fires, comm = run["fires"], run["comm"]
        assert fires == 10 and run["fallbacks"] == 0
        assert comm["all_reduce"]["calls"] == 2 + 6 * 10 + fires  # and each fire's vote on whether it fits
        assert comm["ring_shift"]["calls"] == fires * 2 * halo * 2
        assert comm["ring_shift"]["bytes"] == fires * 2 * halo * n_local * (8 + 4)
        assert comm["all_gather"]["calls"] == fires and comm["all_gather"]["bytes"] == fires * 8


def test_ffbsi_backward_steps_gather_nothing(case):
    """An FFBSi backward step exchanges by all-reduce alone (O(M) rows), with
    one host read a step."""
    _, ranks, _ = case
    for r in ranks:
        run = r["comm"]["ffbsi"]
        assert run["comm"]["all_gather"]["calls"] == run["comm"]["ring_shift"]["calls"] == 0
        assert run["reads"] == run["steps"]


def test_spmd_enkf_makes_all_reduces_only(case):
    _, ranks, _ = case
    for r in ranks:
        comm = r["comm"]["enkf"]
        assert comm["all_reduce"]["calls"] > 0 and comm["all_gather"]["calls"] == comm["ring_shift"]["calls"] == 0


def test_fallback_resamples_the_gathered_cloud(case):
    """Ancestors outside the window: the all-gather fallback gives each rank
    its slots of the one-process expansion of the whole cloud, bit for bit."""
    _, ranks, _ = case
    for r in ranks:
        assert r["fallback"]["equal"] and r["fallback"]["fallbacks"] == 1
        assert r["fallback"]["comm"]["all_gather"]["calls"] == 3  # the totals, the probabilities, the values


def test_device(case):
    """``make_mesh()`` without a card raises; on a CPU mesh every output of
    the SPMD entry points lies on the CPU."""
    _, ranks, _ = case
    for r in ranks:
        assert r["no_card"] is not None and "CUDA" in r["no_card"]
        assert r["oracle"]["sisr"]["device"] == "cpu"
