"""The port's recorded histories, SISR over lanes and smoothers (exact FFBS,
rejection FFBSi, fixed-lag), held against the JAX package and against the
float64 RTS smoother of ``tests/kalman.py``.

Deterministic comparisons feed both packages the same numbers:

- SISR over 3 lanes and the recorded histories: the JAX package's own
  jitted ``batch_filter`` runs from a key, and the port's replays that run's
  draws, taken from the same key by the JAX package's key schedule: its
  ``Normal.sample`` returns ``loc + scale * z`` with the JAX run's ``z`` in
  order, and its fused resampling branch takes the JAX run's uniform of the
  step through ``ParticleFilter.resample_uniform``.
- Fixed-lag smoothing and FFBS run on the JAX package's own history
  (``convert.history_from_numpy``); fixed-lag is a chain of gathers, so it
  matches bit for bit, and FFBS's categorical draws match under the JAX
  package's own Gumbel noise, replayed into the port's ``gumbel``.

Tolerance: rel 1e-5 / abs 5e-5 in float32 (the BASELINE.md gate), indices
and gathers exactly. The law tests use ``tests/test_smoothing_ffbsi.py``'s
bounds: each smoothed mean within ``4.5 sqrt(max var / M)`` plus 0.02-0.03
of the oracle's.
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
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.filters.particle import transition_log_sup as j_log_sup
from pyfilter_tpu.filters.state import ParticleFilterCorrection as JCorrection
from pyfilter_tpu.timeseries import TimeseriesState as JState
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import timeseries as tts
from pyfilter_tpu_torch.filters.particle import base as tbase
from pyfilter_tpu_torch.filters.particle import smoothing as tsmoothing
from pyfilter_tpu_torch.filters.particle import transition_log_sup as t_log_sup
from pyfilter_tpu_torch.ops import backward

from kalman import KalmanFilter as NumpyKalman

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ALPHA, BETA, SIGMA, OBS_STD = 0.2, 0.7, 0.4, 0.25
RTOL, ATOL = 1e-5, 5e-5


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=RTOL, atol=ATOL)


def j_ar(oes=1):
    return jts.LinearStateSpaceModel(jmodels.AR(ALPHA, BETA, SIGMA), (1.0, OBS_STD), observe_every_step=oes)


def t_ar(oes=1):
    return tts.LinearStateSpaceModel(tts.models.AR(ALPHA, BETA, SIGMA, device="cpu"), (1.0, OBS_STD),
                                     observe_every_step=oes)


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def data_and_oracle():
    oracle = NumpyKalman(
        [[BETA]], [[1.0]], [[SIGMA**2]], [[OBS_STD**2]],
        transition_offsets=[ALPHA], initial_state_mean=[ALPHA], initial_state_covariance=[[SIGMA**2]],
    )
    _, y = oracle.sample(40, rng=np.random.default_rng(11))
    sm, sp = oracle.smooth(y)
    return y[:, 0].astype(np.float32), sm[:, 0], sp[:, 0, 0]


@pytest.fixture(scope="module")
def jax_run(data_and_oracle):
    """A JAX SISR history (N = 128, T = 30) and the filter that made it."""
    y = data_and_oracle[0][:30]
    jfilt = pf.SISR(j_ar(), 128, record_states=True)
    return jfilt, jfilt.batch_filter(jax.random.PRNGKey(1), jnp.asarray(y))


def _port_history(jres):
    h = jres.states
    return pt.convert.history_from_numpy(*(np.asarray(a) for a in h), device="cpu")


# -- the JAX package's own draws, replayed into the port ------------------------------
def _jax_draws(key, n_steps, oes, shape, lanes, intermediary):
    """The standard normals and uniforms a JAX SISR ``batch_filter`` (given
    an initial state, bootstrap proposal) draws from ``key``, following its
    key schedule: the normals in the order the port's filter samples them,
    and each step's resampling uniform (per lane)."""
    _, k_first, k_scan = jax.random.split(key, 3)
    step_keys = [k_first] + (list(jax.random.split(k_scan, n_steps - 1)) if n_steps > 1 else [])
    normals, uniforms = [], []
    for t, k in enumerate(step_keys):
        n_sub = 0 if t == 0 else oes - 1
        keys = jax.random.split(k, n_sub + 2)
        uniforms.append(np.asarray(jax.random.uniform(keys[0], lanes, jnp.float32)))
        if n_sub and not intermediary:  # one batched draw of every sub-step's increment
            normals.append(np.asarray(jax.random.normal(keys[1], (n_sub,) + shape, jnp.float32)))
        else:
            normals += [np.asarray(jax.random.normal(keys[1 + i], shape, jnp.float32)) for i in range(n_sub)]
        normals.append(np.asarray(jax.random.normal(keys[-1], shape, jnp.float32)))
    return normals, uniforms


class _ReplaySISRT(pt.SISR):
    """The port's SISR with its default resampler, whose fused branch takes
    the JAX filter's uniform of the current step."""

    def __init__(self, *args, uniforms, **kwargs):
        super().__init__(*args, **kwargs)
        self.uniforms, self.step, self.uniform_draws = uniforms, -1, 0

    def _filter(self, *args, **kwargs):
        self.step += 1
        return super()._filter(*args, **kwargs)

    def resample_uniform(self, generator):
        self.uniform_draws += 1
        return torch.tensor(self.uniforms[self.step])


# mode: (particles, lanes, observations, observe_every_step, record_states, record_intermediary)
_RUNS = {
    "lanes": (64, (3,), 10, 1, True, False),
    "full": (16, (), 6, 1, True, False),
    "bounded": (16, (), 6, 1, 4, False),
    "intermediary": (16, (), 5, 5, True, True),
}


@pytest.mark.parametrize("mode", sorted(_RUNS))
def test_sisr_runs_match_jax_on_its_draws(mode, data_and_oracle, monkeypatch):
    """The JAX package's SISR ``batch_filter`` (jitted) and the port's from
    one cloud, the port replaying the JAX run's own normals and uniforms:
    per-step filter means and log-likelihoods, and the recorded history
    (shapes, time indexes, values, log-weights, ancestor indices) — SISR over
    3 lanes (identity indices on the lanes that do not resample),
    ``record_states=True``, a bounded ``record_states=4``, and
    ``record_intermediary`` at ``observe_every_step=5``."""
    n, lanes, n_obs, oes, record, inter = _RUNS[mode]
    y = data_and_oracle[0][:n_obs]
    key = jax.random.PRNGKey(7)
    normals, uniforms = _jax_draws(key, n_obs, oes, (n,) + lanes, lanes, inter)
    x0 = np.random.default_rng(6).normal(ALPHA, SIGMA, size=(n,) + lanes).astype(np.float32)

    ident = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32).reshape((n,) + (1,) * len(lanes)), (n,) + lanes)
    jstate = JCorrection.from_weighted_particles(JState(jnp.asarray(0.0), jnp.asarray(x0)), jnp.zeros((n,) + lanes),
                                                 jnp.zeros(lanes), ident)
    jfilt = pf.SISR(j_ar(oes), n, batch_shape=lanes, record_states=record, record_intermediary=inter)
    jres = jfilt.batch_filter(key, jnp.asarray(y), initial_state=jstate)

    draws = iter(normals)

    def t_sample(self, generator, sample_shape=()):
        z = next(draws)
        assert z.shape == tuple(sample_shape) + tuple(self.batch_shape)
        return self.loc + self.scale * torch.tensor(z)

    monkeypatch.setattr(tdist.Normal, "sample", t_sample)
    tfilt = _ReplaySISRT(t_ar(oes), n, batch_shape=lanes, record_states=record, record_intermediary=inter,
                         device="cpu", uniforms=uniforms)
    tstate = pt.convert.correction_from_numpy(
        *(np.asarray(a) for a in (jstate.x.time_index, jstate.x.value, jstate.log_weights, jstate.log_likelihood,
                                  jstate.prev_indices, jstate.mean, jstate.variance)),
        device="cpu",
    )
    tres = tfilt.batch_filter(None, y, initial_state=tstate)
    assert next(draws, None) is None, "the port must take every draw of the JAX run"
    assert tfilt.uniform_draws == (n_obs if lanes else tfilt.n_resamples) and tfilt.n_resamples > 0

    _close(tres.filter_means, jres.filter_means)
    _close(tres.step_log_likelihoods, jres.step_log_likelihoods)
    rows = {"lanes": n_obs + 1, "full": n_obs + 1, "bounded": 4, "intermediary": 2 + (n_obs - 1) * oes}[mode]
    jh, th = jres.states, tres.states
    assert th.values.shape == th.log_weights.shape == th.prev_indices.shape == (rows, n) + lanes
    np.testing.assert_array_equal(th.time_indexes.numpy(), np.asarray(jh.time_indexes, np.float32))
    _close(th.values, jh.values)
    _close(th.log_weights, jh.log_weights)
    np.testing.assert_array_equal(th.prev_indices.numpy(), np.asarray(jh.prev_indices))
    if lanes:
        moved = (th.prev_indices[1:] != torch.tensor(np.asarray(ident))).any(dim=1)  # (T, lanes)
        assert moved.any() and not moved.all(), "the run must mix lanes that resample and lanes that do not"


def test_bounded_history_is_the_tail_of_the_full_one(data_and_oracle):
    """``record_states=k`` keeps exactly the last k rows of the full history
    (same generator seed), and refuses k outside [2, T + 1] and
    intermediaries."""
    y = data_and_oracle[0][:12]
    full = pt.SISR(t_ar(), 32, record_states=True, device="cpu").batch_filter(gen(3), y).states
    for k in (2, 5, 13):
        tail = pt.SISR(t_ar(), 32, record_states=k, device="cpu").batch_filter(gen(3), y).states
        for a, b in zip(tail, full):
            assert torch.equal(a, b[-k:])
    for bad in (1, 14):
        with pytest.raises(ValueError, match="record_states"):
            pt.SISR(t_ar(), 32, record_states=bad, device="cpu").batch_filter(gen(3), y)
    with pytest.raises(ValueError, match="intermediaries"):
        pt.SISR(t_ar(), 32, record_states=4, record_intermediary=True, device="cpu").batch_filter(gen(3), y)


def test_result_lane_surgery_carries_the_history(data_and_oracle):
    """``FilterResult.resample`` / ``exchange`` over lanes move the recorded
    history's lanes with the rest (the time indexes are shared)."""
    y = data_and_oracle[0][:8]
    filt = pt.SISR(t_ar(), 16, record_states=True, batch_shape=(4,), device="cpu")
    res = filt.batch_filter(gen(12), y)
    other = filt.batch_filter(gen(13), y)
    idx = torch.tensor([2, 2, 0, 3])
    moved = res.resample(idx)
    for a, b in zip(moved.states[1:], res.states[1:]):
        assert torch.equal(a, b[:, :, idx])
    assert torch.equal(moved.states.time_indexes, res.states.time_indexes)
    assert torch.equal(moved.log_likelihood, res.log_likelihood[idx])
    assert torch.equal(moved.latest_state.x.value, res.latest_state.x.value[:, idx])

    mask = torch.tensor([True, False, False, True])
    mixed = res.exchange(other, mask)
    for a, mine, theirs in zip(mixed.states[1:], res.states[1:], other.states[1:]):
        assert torch.equal(a[:, :, mask], theirs[:, :, mask]) and torch.equal(a[:, :, ~mask], mine[:, :, ~mask])
    assert torch.equal(mixed.filter_means[:, mask], other.filter_means[:, mask])


@pytest.mark.parametrize("lanes", [(), (3,)])
def test_fixed_lag_matches_jax_bit_for_bit(lanes, data_and_oracle):
    """Fixed-lag smoothing on the JAX package's own history: a chain of
    gathers, so every value matches exactly."""
    y = jnp.asarray(data_and_oracle[0][:30])
    jfilt = pf.SISR(j_ar(), 96, record_states=True, batch_shape=lanes)
    jres = jfilt.batch_filter(jax.random.PRNGKey(2), y)
    j_fl = np.asarray(jfilt.smooth(jax.random.PRNGKey(3), jres, method="fl"))
    tfilt = pt.SISR(t_ar(), 96, batch_shape=lanes, device="cpu")
    t_fl = tfilt.smooth(None, _port_history(jres), method="fl")
    assert t_fl.shape == j_fl.shape == (31, 96) + lanes
    np.testing.assert_array_equal(t_fl.numpy(), j_fl)


def test_ffbs_logits_and_draws_match_jax(jax_run, monkeypatch):
    """Exact FFBS on the JAX package's history: the (M, N) backward logits of
    every step, and the draws when the port's Gumbel noise is the JAX
    package's own (``jax.random.categorical`` is ``argmax(logits + gumbel)``)."""
    jfilt, jres = jax_run
    key = jax.random.PRNGKey(5)
    j_sm = np.asarray(jfilt.smooth(key, jres, method="ffbs"))
    n_rows, n = j_sm.shape
    k_last, k_scan = jax.random.split(key)
    keys = jax.random.split(k_scan, n_rows - 1)
    idx_last = np.asarray(jfilt.resampler(k_last, jres.states.log_weights[-1]))
    steps = list(range(n_rows - 2, -1, -1))
    noise = iter([np.asarray(jax.random.gumbel(keys[t], (n, n), jnp.float32)) for t in steps])
    monkeypatch.setattr(tbase, "gumbel", lambda generator, shape, like: torch.tensor(next(noise)))

    tfilt = pt.SISR(t_ar(), n, resampling_method=lambda g, w, normalized=False: torch.tensor(idx_last),
                    device="cpu")
    hist = _port_history(jres)
    t_sm = tfilt.smooth(None, hist, method="ffbs")
    np.testing.assert_array_equal(t_sm.numpy(), j_sm)

    times, values, log_w = (np.asarray(a) for a in (jres.states.time_indexes, jres.states.values,
                                                    jres.states.log_weights))
    jmodel, tmodel = jfilt.model, tfilt.model
    for t in steps:
        dens = jmodel.hidden.build_density(JState(jnp.asarray(times[t]), jnp.asarray(values[t])))
        j_logits = jnp.asarray(log_w[t])[None] + dens.log_prob(jnp.asarray(j_sm[t + 1])[:, None])
        t_logits = tbase.ffbs_logits(tmodel, hist.values[t], hist.log_weights[t], float(times[t]),
                                     torch.tensor(j_sm[t + 1]))
        assert t_logits.shape == (n, n)
        _close(t_logits, j_logits)


def test_transition_log_sup_matches_jax_and_refuses_heteroscedastic_scales():
    """AR: -log(sigma) - log(2 pi) / 2; MVN increments: the covariance's
    determinant; a state-dependent scale refuses with a pointer to
    ``log_density_sup``."""
    expect = -np.log(SIGMA) - 0.5 * np.log(2 * np.pi)
    np.testing.assert_allclose(float(t_log_sup(t_ar())), expect, rtol=RTOL)
    np.testing.assert_allclose(float(t_log_sup(t_ar())), float(j_log_sup(j_ar())), rtol=RTOL)

    q = np.array([[0.3, 0.18], [0.18, 0.25]])
    lq = np.linalg.cholesky(q).astype(np.float32)
    j_hidden = jts.AffineProcess(
        lambda x, a: (a * x.value, 1.0), (jnp.asarray(0.9),),
        jdist.MultivariateNormal(jnp.zeros(2), scale_tril=jnp.asarray(lq)),
        lambda a: jdist.MultivariateNormal(jnp.zeros(2), scale_tril=jnp.asarray(lq)),
    )
    t_hidden = tts.AffineProcess(
        lambda x, a: (a * x.value, 1.0), (torch.tensor(0.9),),
        tdist.MultivariateNormal(torch.zeros(2), torch.from_numpy(lq)),
        lambda a: tdist.MultivariateNormal(torch.zeros(2), torch.from_numpy(lq)),
    )
    t_val = float(t_log_sup(tts.LinearStateSpaceModel(t_hidden, (1.0, 0.1), event_shape=(2,))))
    np.testing.assert_allclose(t_val, -np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(q)[1], rtol=RTOL)
    np.testing.assert_allclose(
        t_val, float(j_log_sup(jts.LinearStateSpaceModel(j_hidden, (1.0, 0.1), event_shape=(2,)))), rtol=RTOL
    )
    # the multivariate normal pushforward of the transition
    x, x_next = (np.random.default_rng(9).normal(size=(5, 2)).astype(np.float32) for _ in range(2))
    _close(t_hidden.build_density(tts.TimeseriesState(0.0, torch.from_numpy(x), 1)).log_prob(torch.from_numpy(x_next)),
           j_hidden.build_density(JState(jnp.asarray(0.0), jnp.asarray(x), 1)).log_prob(jnp.asarray(x_next)))

    hetero = tts.AffineProcess(
        lambda x, s: (x.value, s * (1.0 + torch.abs(x.value))), (torch.tensor(0.3),),
        tdist.Normal(torch.tensor(0.0), torch.tensor(1.0)), lambda s: tdist.Normal(torch.tensor(0.0), torch.tensor(1.0)),
    )
    with pytest.raises(ValueError, match="log_density_sup"):
        t_log_sup(tts.LinearStateSpaceModel(hetero, (1.0, 0.1)))


# -- laws, against the RTS oracle ------------------------------------------------------
def _means(traj):
    return traj.double().mean(dim=1).numpy()


def test_ffbs_and_ffbsi_match_rts_oracle(data_and_oracle):
    """Exact FFBS and rejection FFBSi sample one law: both hit the RTS
    smoothing marginals within Monte Carlo error."""
    y, sm_mean, sm_var = data_and_oracle
    ffbsi_filt = pt.SISR(t_ar(), 2000, record_states=True, device="cpu")
    rej = ffbsi_filt.smooth(gen(1), ffbsi_filt.batch_filter(gen(0), y), method="ffbsi")
    ffbs_filt = pt.SISR(t_ar(), 1000, record_states=True, device="cpu")
    exact = ffbs_filt.smooth(gen(3), ffbs_filt.batch_filter(gen(2), y), method="ffbs")
    assert rej.shape == (41, 2000) and exact.shape == (41, 1000)
    np.testing.assert_allclose(_means(exact)[1:], sm_mean, atol=4.5 * np.sqrt(sm_var / 1000).max() + 0.02)
    np.testing.assert_allclose(_means(rej)[1:], sm_mean, atol=4.5 * np.sqrt(sm_var / 2000).max() + 0.02)
    np.testing.assert_allclose(rej.double().var(dim=1).numpy()[1:], sm_var, rtol=0.5, atol=0.01)


@pytest.mark.parametrize("route", ["kernel", "streamed"])
def test_ffbsi_forced_fallback_is_exact(data_and_oracle, monkeypatch, route):
    """``max_rounds=0`` sends every draw through the exact Gumbel-max
    fallback, whose law must still be the oracle's: on the fallback kernel's
    route (the AR model's), one pass a step; on the streamed passes every
    other process takes (forced here), ``ceil(1000 / 128)`` a step."""
    y, sm_mean, sm_var = data_and_oracle
    if route == "streamed":
        monkeypatch.setattr(tsmoothing, "_fallback_kernel_takes", lambda *a: False)
        monkeypatch.setattr(tsmoothing, "ffbsi_fallback", None)
    filt = pt.SISR(t_ar(), 1000, record_states=True, device="cpu")
    res = filt.batch_filter(gen(4), y)
    tbase_passes = pt.filters.particle.ffbsi_smooth.fallback_passes
    sm = filt.smooth(gen(5), res, method="ffbsi", max_rounds=0, block=37)
    assert pt.filters.particle.ffbsi_smooth.fallback_passes - tbase_passes == (40 if route == "kernel" else 40 * 8)
    np.testing.assert_allclose(_means(sm)[1:], sm_mean, atol=4.5 * np.sqrt(sm_var / 1000).max() + 0.025)


@pytest.mark.parametrize("slots", ["every", "permuted-half"])
def test_ffbsi_fallback_plain_law(slots):
    """The fallback's plain version (the wrapper on CPU tensors) draws the
    exact categorical: N = 50 with -inf log-weights and a heteroscedastic
    scale, 16,000 draws a target, Pearson's chi-square against float64
    probabilities at p >= 1e-4 a target, no particle of probability 0 drawn;
    with half the slots failed, in a permuted order, only those are written."""
    case = chip_smoke.fallback_law_case(torch, "cpu")
    tables, targets = case[:2]
    gen_ = gen(23)
    if slots == "every":
        counts = chip_smoke.fallback_law_counts(torch, backward.ffbsi_fallback, case, gen_, 8)
        assert min(chip_smoke.fallback_law_pvalues(counts, case[3])) >= chip_smoke.FALLBACK_LAW_P
        return
    j = targets.shape[0]
    order = torch.cat([torch.randperm(j, generator=gen_), torch.tensor([j])])
    idx = torch.full((j,), -7, dtype=torch.int64)
    out = backward.ffbsi_fallback(gen_, tables, targets, order, j // 2, idx)
    assert out is idx
    hit = torch.zeros(j, dtype=torch.bool)
    hit[order[: j // 2]] = True
    assert bool((idx[~hit] == -7).all()) and bool(((idx[hit] >= 0) & (idx[hit] < tables.shape[1])).all())
    assert not bool((idx[hit] % 10 == 0).any())  # every tenth particle has probability 0


def _inc_shifted_process():
    """A scalar affine process with a ``Normal(0.3, 1.7)`` increment and a
    state-dependent scale."""
    return tts.AffineProcess(lambda x, b: (b * x.value, 0.2 + 0.1 * torch.abs(x.value)), (torch.tensor(BETA),),
                             tdist.Normal(torch.tensor(0.3), torch.tensor(1.7)),
                             lambda b: tdist.Normal(torch.tensor(0.0), torch.tensor(1.0)))


@pytest.mark.parametrize("process", ["ar", "random-walk", "verhulst", "shifted-increment"])
def test_transition_tables_match_the_density(process):
    """The kernel's tables ``(c, a, b)`` give ``log w + log p(y | x)`` up to
    ``-log sqrt(2 pi)`` for every kind of process the kernel takes: the AR,
    a random walk, an Euler-Maruyama SDE with a state-dependent scale, and an
    increment with its own loc and scale."""
    hidden = {
        "ar": lambda: tts.models.AR(ALPHA, BETA, SIGMA, device="cpu"),
        "random-walk": lambda: tts.models.RandomWalk(0.3, device="cpu"),
        "verhulst": lambda: tts.models.Verhulst(0.1, 1.0, 0.05, dt=0.2, device="cpu"),
        "shifted-increment": _inc_shifted_process,
    }[process]()
    g = gen(3)
    vals = torch.rand(200, generator=g) * 2.0 + 0.1
    lw = torch.randn(200, generator=g)
    lw[::7] = -torch.inf
    ys = torch.linspace(-1.0, 3.0, 9)
    assert tsmoothing._fallback_kernel_takes(hidden, vals, lw, ys)
    c, a, b = tsmoothing.transition_tables(hidden, vals, lw, 2.0)
    got = b - 0.5 * torch.square(a * (ys[:, None] - c)) - 0.5 * np.log(2.0 * np.pi)
    want = lw + hidden.build_density(tts.TimeseriesState(2.0, vals, 0)).log_prob(ys[:, None])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_ffbsi_scalar_affine_takes_the_fallback_kernel(data_and_oracle, monkeypatch):
    """The AR model's failed targets go through ``ffbsi_fallback`` once a
    step with a failure (here its plain version), never through the streamed
    passes, and its smoothed means still hit the oracle's."""
    y, sm_mean, sm_var = data_and_oracle
    calls = []
    real = tsmoothing.ffbsi_fallback
    monkeypatch.setattr(tsmoothing, "ffbsi_fallback", lambda *a: calls.append(a[4]) or real(*a))
    monkeypatch.setattr(tsmoothing, "_streaming_categorical", None)
    filt = pt.SISR(t_ar(), 1000, record_states=True, device="cpu")
    res = filt.batch_filter(gen(12), y)
    before = pt.filters.particle.ffbsi_smooth.fallback_passes
    sm = filt.smooth(gen(13), res, method="ffbsi", max_rounds=1)
    assert 0 < len(calls) == pt.filters.particle.ffbsi_smooth.fallback_passes - before <= 40
    assert all(0 < k <= 1000 for k in calls)
    np.testing.assert_allclose(_means(sm)[1:], sm_mean, atol=4.5 * np.sqrt(sm_var / 1000).max() + 0.025)


@pytest.mark.parametrize("case", ["lanes", "linear-2d", "joint-2d", "float64"])
def test_ffbsi_other_inputs_keep_the_streamed_passes(case, monkeypatch):
    """Inputs outside the kernel's condition (lanes, a 2-D state, a joint
    process, float64) take the streamed chain as before: with every slot
    failed, one pass a step over lanes, ``ceil(J / k_sub)`` passes laneless
    (k_sub 128 at J = 300); the fallback kernel's wrapper is never called."""
    monkeypatch.setattr(tsmoothing, "ffbsi_fallback", None)
    g = gen(31)
    if case == "lanes":
        model, vals, targets, passes = t_ar(), torch.randn(300, 3, generator=g), torch.randn(300, 3, generator=g), 1
    elif case == "float64":
        model, passes = t_ar(), 3
        vals, targets = torch.randn(300, generator=g, dtype=torch.float64), torch.randn(300, generator=g,
                                                                                         dtype=torch.float64)
    else:
        model = chip_smoke.oracle_model(pt, case.replace("linear", "rw").replace("-", ""), "cpu")
        vals, targets, passes = torch.randn(300, 2, generator=g), torch.randn(300, 2, generator=g), 3
    lw = torch.randn(vals.shape[: vals.dim() - model.hidden.event_ndim], generator=g, dtype=vals.dtype)
    before = pt.filters.particle.ffbsi_smooth.fallback_passes
    idx, violated = tsmoothing.backward_indices(g, model, vals, lw, 0.0, targets, 0.0, max_rounds=0)
    assert pt.filters.particle.ffbsi_smooth.fallback_passes - before == passes
    assert idx.shape == lw.shape and bool(((idx >= 0) & (idx < 300)).all()) and not bool(violated)


def test_ffbsi_with_lanes(data_and_oracle):
    """A lane-batched history (SISR over lanes): every lane smooths to the
    oracle's marginals; the forced fallback over lanes streams in blocks of
    37 (a padded last block)."""
    y, sm_mean, _ = data_and_oracle
    filt = pt.SISR(t_ar(), 400, record_states=True, batch_shape=(3,), device="cpu")
    res = filt.batch_filter(gen(6), y)
    for kwargs in ({}, {"max_rounds": 0, "block": 37}):
        sm = filt.smooth(gen(7), res, method="ffbsi", **kwargs)
        assert sm.shape == (41, 400, 3)
        m = _means(sm)
        for lane in range(3):
            np.testing.assert_allclose(m[1:, lane], sm_mean, atol=0.12)


def test_smooth_m_trajectories(data_and_oracle):
    """``n_trajectories = M != N`` for both smoothers, from ``systematic_m``;
    lane-batched histories refuse it."""
    y, sm_mean, sm_var = data_and_oracle
    filt = pt.SISR(t_ar(), 2000, record_states=True, device="cpu")
    res = filt.batch_filter(gen(8), y)
    for method in ("ffbs", "ffbsi"):
        sm = filt.smooth(gen(9), res, method=method, n_trajectories=300)
        assert sm.shape == (41, 300)
        np.testing.assert_allclose(_means(sm)[1:], sm_mean, atol=4.5 * np.sqrt(sm_var / 300).max() + 0.03)

    laned = pt.SISR(t_ar(), 200, record_states=True, batch_shape=(2,), device="cpu")
    res_l = laned.batch_filter(gen(10), y)
    for method in ("ffbs", "ffbsi"):
        with pytest.raises(ValueError, match="laneless"):
            laned.smooth(gen(11), res_l, method=method, n_trajectories=50)


def test_ffbsi_bound_violation_is_loud():
    """A state-dependent scale that equals the homoscedastic probes of
    ``transition_log_sup`` at its probe states slips past the check with a
    bound that is not one: the output is all NaN, not silently biased;
    ``check_bound=False`` accepts the bias, a correct explicit bound smooths."""

    def mean_scale(x, b):
        v = x.value
        poly = v * (v - 0.7) * (v + 1.3)
        return b * v, SIGMA * (1.0 - 0.6 * torch.tanh(poly * poly))  # SIGMA at every probe state

    hidden = tts.AffineProcess(
        mean_scale, (torch.tensor(BETA),), tdist.Normal(torch.tensor(0.0), torch.tensor(SIGMA)),
        lambda b: tdist.Normal(torch.tensor(0.0), torch.tensor(1.0)),
    )
    ssm = tts.LinearStateSpaceModel(hidden, (1.0, OBS_STD))
    log_sup = t_log_sup(ssm)  # the wrong bound, derived silently
    _, y = ssm.sample_states(gen(30), 50).get_paths()
    filt = pt.SISR(ssm, 1000, record_states=True, device="cpu")
    res = filt.batch_filter(gen(31), y)

    assert torch.isnan(filt.smooth(gen(32), res, method="ffbsi")).all()
    assert torch.isfinite(filt.smooth(gen(32), res, method="ffbsi", check_bound=False)).all()
    good = float(log_sup) + float(np.log(1.0 / 0.4)) + 0.05
    assert torch.isfinite(filt.smooth(gen(32), res, method="ffbsi", log_density_sup=good)).all()
