"""The port's PaRIS online smoother and in-trace density bound held against
the JAX package's ``pyfilter_tpu/filters/particle/smoothing.py``.

Draw for draw: both packages' ``paris`` run the same filter on the same
draws (``Normal.sample`` of both draws ``loc + scale * z`` with the same ``z``
for the k-th call, each resample takes the same uniform: the port's
``resample_uniform``, the JAX filter's replay resampler), and every backward
draw of both comes from one numpy tape of indices: the JAX package's
``smoothing.backward_indices`` and the port's are each replaced, in this
test's view of the module, by a function that returns the tape's next entry
(and records what it was asked: the time index and the targets). The JAX
side runs eagerly under ``jax.disable_jit()`` (its ``lax.scan`` a Python
loop). Tolerances: per-particle statistics and the estimate rel 1e-5 / abs
1e-6, the log-likelihood rel 1e-5 (float32 sums of a few terms each side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.filters.particle import smoothing as jsmoothing
from pyfilter_tpu.ops import systematic_counts as j_counts
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import timeseries as tts
from pyfilter_tpu_torch.filters.particle import smoothing as tsmoothing

torch.set_num_threads(1)

ALPHA, BETA, SIGMA, OBS_STD = 0.2, 0.7, 0.4, 0.25
N, T, N_TILDE = 64, 8, 2


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


def _j_ssm(oes=1):
    return jts.LinearStateSpaceModel(jmodels.AR(ALPHA, BETA, SIGMA), (1.0, OBS_STD), observe_every_step=oes)


def _t_ssm(oes=1):
    return tts.LinearStateSpaceModel(tts.models.AR(ALPHA, BETA, SIGMA, device="cpu"), (1.0, OBS_STD),
                                     observe_every_step=oes)


def _y(n=T, seed=0):
    return np.random.default_rng(seed).normal(0.6, 0.5, size=n).astype(np.float32)


class _Replay:
    """The draws of both packages: normals and resample uniforms by call
    count, and the backward indices from one tape (each entry drawn by numpy
    when the JAX side first asks for it; the port must ask for the same
    entries in the same order)."""

    def __init__(self, seed):
        self.seed = seed
        self.calls = {"jax": 0, "port": 0}
        self.uniforms = {"jax": 0, "port": 0}
        self.tape, self.asked = [], {"jax": [], "port": []}

    def _z(self, side, shape):
        k = self.calls[side]
        self.calls[side] += 1
        return np.random.default_rng((self.seed, k)).normal(size=shape).astype(np.float32)

    def _u(self, side):
        k = self.uniforms[side]
        self.uniforms[side] += 1
        return np.float32(np.random.default_rng((self.seed, 10_000 + k)).uniform())

    def _indices(self, side, n, targets, t):
        k = len(self.asked[side])
        self.asked[side].append((float(t), np.asarray(targets, np.float32)))
        if side == "jax":
            self.tape.append(np.random.default_rng((self.seed, 20_000 + k)).integers(0, n, size=len(targets)))
        return self.tape[k]

    def patch(self, monkeypatch):
        rep = self

        def j_sample(self, key, sample_shape=()):
            shape = tuple(sample_shape) + tuple(jnp.broadcast_shapes(jnp.shape(self.loc), jnp.shape(self.scale)))
            return self.loc + self.scale * jnp.asarray(rep._z("jax", shape))

        def t_sample(self, generator, sample_shape=()):
            return self.loc + self.scale * torch.from_numpy(rep._z("port", tuple(sample_shape) + self.batch_shape))

        def j_back(key, model, vals_t, lw_t, t_t, targets, log_sup, max_rounds=16, block=64, fallback_subset=None,
                   return_violation=False):
            idx = jnp.asarray(rep._indices("jax", vals_t.shape[0], targets, t_t), jnp.int32)
            return (idx, jnp.asarray(False)) if return_violation else idx

        def t_back(generator, model, vals_t, lw_t, time_index, targets, log_sup, max_rounds=16, block=64):
            idx = torch.from_numpy(rep._indices("port", vals_t.shape[0], targets, time_index))
            return idx, torch.zeros((), dtype=torch.bool)

        monkeypatch.setattr(jdist.Normal, "sample", j_sample)
        monkeypatch.setattr(tdist.Normal, "sample", t_sample)
        monkeypatch.setattr(jsmoothing, "backward_indices", j_back)
        monkeypatch.setattr(tsmoothing, "backward_indices", t_back)

    def filters(self, oes):
        rep = self

        def j_resampler(key, w, normalized=False):
            return j_counts(None, w, normalized=normalized, u=jnp.asarray(rep._u("jax")))

        class Replay(pt.SISR):
            def resample_uniform(self, generator):
                return torch.tensor(rep._u("port"))

        return pf.SISR(_j_ssm(oes), N, resampling_method=j_resampler), Replay(_t_ssm(oes), N, device="cpu")


def _functionals(oes):
    """The same additive functional, observation term and initial term in
    both packages: ``(x gated on the observation times, x_prev * x)``,
    ``x * y`` and ``(x0, x0^2)``."""

    def j_h(xp, xc, t):
        return jnp.where(jnp.mod(t, float(oes)) == 1.0, xc, jnp.zeros_like(xc)), xp * xc

    def t_h(xp, xc, t):
        return (xc if t % oes == 1.0 else torch.zeros_like(xc)), xp * xc

    return (j_h, lambda x, y, t: (x * y, jnp.zeros_like(x)), lambda x0: (x0, x0 * x0),
            t_h, lambda x, y, t: (x * y, torch.zeros_like(x)), lambda x0: (x0, x0 * x0))


@pytest.mark.parametrize("oes", [1, 3])
def test_paris_replays_jax_draw_for_draw(oes, monkeypatch):
    """PaRIS at ``observe_every_step`` 1 and 3 (N = 64, T = 8, n_tilde = 2),
    with an observation term and an initial term: the backward updates ask
    for the same clouds at the same times (one per sub-step transition), and
    the per-particle statistics, the estimate and the log-likelihood agree;
    every draw of every tape is taken."""
    rep = _Replay(seed=oes)
    rep.patch(monkeypatch)
    jfilt, tfilt = rep.filters(oes)
    j_h, j_obs, j_h0, t_h, t_obs, t_h0 = _functionals(oes)
    y = _y()
    with jax.disable_jit():
        jest, jstats, jres = jsmoothing.paris(jfilt, jax.random.PRNGKey(0), jnp.asarray(y), j_h, h0_fn=j_h0,
                                              n_tilde=N_TILDE, h_obs_fn=j_obs)
    test, tstats, tres = tsmoothing.paris(tfilt, None, y, t_h, h0_fn=t_h0, n_tilde=N_TILDE, h_obs_fn=t_obs)

    assert len(rep.asked["port"]) == len(rep.asked["jax"]) == N_TILDE * (1 + (T - 1) * oes)
    for (tt, tt_targets), (jt, jt_targets) in zip(rep.asked["port"], rep.asked["jax"]):
        assert tt == jt
        _close(tt_targets, jt_targets)
    assert rep.calls["port"] == rep.calls["jax"] and rep.uniforms["port"] == rep.uniforms["jax"] > 0
    as_port = pt.convert.tree_from_numpy(tuple(np.asarray(leaf) for leaf in jstats), device="cpu")
    for a, b in zip(tstats, as_port):
        assert a.shape == b.shape == (N,) and b.dtype == torch.float32
        _close(a, b)
    for a, b in zip(test, jest):
        _close(a, b)
    _close(tres.log_likelihood, jres.log_likelihood, rtol=1e-5, atol=0.0)
    _close(tres.step_log_likelihoods, jres.step_log_likelihoods)
    _close(tres.filter_means, jres.filter_means)
    assert tres.latest_state.x.time_index == float(jres.latest_state.x.time_index) == 1 + (T - 1) * oes


def test_paris_from_a_carried_state(monkeypatch):
    """``initial_state`` with ``first_step=False`` (fit_mle_streaming's later
    windows): the first observation is a full move with its sub-steps."""
    oes = 3
    rep = _Replay(seed=7)
    rep.patch(monkeypatch)
    jfilt, tfilt = rep.filters(oes)
    j_h, _, _, t_h, _, _ = _functionals(oes)
    y = _y(4, seed=2)
    with jax.disable_jit():
        jstate = jfilt.initialize(jax.random.PRNGKey(1))
        tstate = tfilt.initialize(None)
        jest, jstats, jres = jsmoothing.paris(jfilt, jax.random.PRNGKey(0), jnp.asarray(y), j_h, n_tilde=N_TILDE,
                                              initial_state=jstate, first_step=False)
    test, tstats, tres = tsmoothing.paris(tfilt, None, y, t_h, n_tilde=N_TILDE, initial_state=tstate,
                                          first_step=False)
    assert len(rep.asked["port"]) == len(rep.asked["jax"]) == N_TILDE * 4 * oes
    for a, b in zip(tstats + test, jstats + jest):
        _close(a, b)
    _close(tres.log_likelihood, jres.log_likelihood, rtol=1e-5, atol=0.0)


def test_violated_bound_poisons_the_estimate_in_both_packages():
    """A bound far below the transition density's maximum: both packages
    return NaN statistics and estimate (real backward draws), and a finite
    log-likelihood."""
    y = _y(5, seed=3)
    h = lambda xp, xc, t: xc  # noqa: E731
    jest, jstats, jres = jsmoothing.paris(pf.SISR(_j_ssm(), N), jax.random.PRNGKey(4), jnp.asarray(y), h,
                                          log_density_sup=-5.0)
    test, tstats, tres = tsmoothing.paris(pt.SISR(_t_ssm(), N, device="cpu"), torch.Generator().manual_seed(4), y, h,
                                          log_density_sup=-5.0)
    assert np.isnan(np.asarray(jest)) and np.isnan(np.asarray(jstats)).all()
    assert torch.isnan(test) and torch.isnan(tstats).all()
    assert np.isfinite(float(jres.log_likelihood)) and torch.isfinite(tres.log_likelihood)
    # the right bound: finite
    ok, _, _ = tsmoothing.paris(pt.SISR(_t_ssm(), N, device="cpu"), torch.Generator().manual_seed(4), y, h)
    assert torch.isfinite(ok)


def _sup_models():
    """(JAX model, port model) pairs: AR, the random walk, LLT and the cycle."""
    t_models, j_models = pt.timeseries.models, jmodels
    return {
        "ar": (_j_ssm(), _t_ssm()),
        "random_walk": (jts.LinearStateSpaceModel(j_models.RandomWalk(0.3), (1.0, 0.1)),
                        tts.LinearStateSpaceModel(t_models.RandomWalk(0.3, device="cpu"), (1.0, 0.1))),
        "llt": (jts.LinearStateSpaceModel(j_models.LocalLinearTrend(0.05, 0.02), (jnp.eye(2), 0.15 * jnp.ones(2)),
                                          event_shape=(2,)),
                tts.LinearStateSpaceModel(t_models.LocalLinearTrend(0.05, 0.02, device="cpu"),
                                          (torch.eye(2), torch.full((2,), 0.15)), event_shape=(2,))),
        "cyclical": (jts.LinearStateSpaceModel(j_models.Cyclical(0.9, 0.5, 0.1), (jnp.asarray([[1.0, 0.0]]),
                                                                                     jnp.asarray([0.05])),
                                               event_shape=(1,)),
                     tts.LinearStateSpaceModel(t_models.Cyclical(0.9, 0.5, 0.1, device="cpu"),
                                               (torch.tensor([[1.0, 0.0]]), torch.tensor([0.05])), event_shape=(1,))),
    }


@pytest.mark.parametrize("name", ["ar", "random_walk", "llt", "cyclical"])
def test_traced_bound_equals_the_probed_one(name):
    """``transition_log_sup_traced`` (no probe, no host read) equals
    ``transition_log_sup`` on homoscedastic models, and both the JAX
    package's."""
    jm, tm = _sup_models()[name]
    traced, probed = tsmoothing.transition_log_sup_traced(tm), tsmoothing.transition_log_sup(tm)
    assert traced.dtype == torch.float32 and traced.shape == ()
    assert float(traced) == float(probed)
    _close(traced, jsmoothing.transition_log_sup(jm), rtol=1e-6, atol=0.0)
    _close(traced, jsmoothing.transition_log_sup_traced(jm), rtol=1e-6, atol=0.0)
