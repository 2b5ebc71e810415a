"""The port's single-step filter API held against the JAX package's
``pyfilter_tpu/filters/base.py`` and ``filters/state.py``: ``step``,
``filter(..., return_intermediaries=True)``, ``batch_filter_masked`` with
``pad_observations``, ``ParticleFilterCorrection.lane_concat`` and
``resample_particles``.

Replays: ``Normal.sample`` of both packages draws ``loc + scale * z`` with the
same ``z`` for the k-th call of each package (``_Tape``), and each resample
takes the same uniform (the port's ``resample_uniform``, the JAX filter's
replay resampler ``systematic_counts(None, w, u=...)``); the JAX side runs
eagerly under ``jax.disable_jit()``. Tolerance: rel 1e-5 / abs 5e-5 on
float32 values (the BASELINE.md gate), indices and time indexes exactly.
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
from pyfilter_tpu.filters.base import pad_observations as j_pad
from pyfilter_tpu.filters.state import ParticleFilterCorrection as JCorrection
from pyfilter_tpu.ops import systematic_counts as j_counts
from pyfilter_tpu.timeseries import TimeseriesState as JState
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import timeseries as tts
from pyfilter_tpu_torch.filters.base import pad_observations as t_pad
from pyfilter_tpu_torch.filters.state import ParticleFilterCorrection as TCorrection

torch.set_num_threads(1)

ALPHA, BETA, SIGMA, OBS_STD = 0.2, 0.7, 0.4, 0.25
RTOL, ATOL = 1e-5, 5e-5


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=RTOL, atol=ATOL)


def _j_ssm(oes=1):
    return jts.LinearStateSpaceModel(jmodels.AR(ALPHA, BETA, SIGMA), (1.0, OBS_STD), observe_every_step=oes)


def _t_ssm(oes=1):
    return tts.LinearStateSpaceModel(tts.models.AR(ALPHA, BETA, SIGMA, device="cpu"), (1.0, OBS_STD),
                                     observe_every_step=oes)


def _y(n, seed=0):
    return np.random.default_rng(seed).normal(0.6, 0.5, size=n).astype(np.float32)


class _Tape:
    """Standard normals for ``Normal.sample`` of both packages (the k-th call
    of each gets the same draw) and a uniform for each resample."""

    def __init__(self, seed):
        self.seed, self.calls, self.uniform_calls = seed, {"jax": 0, "port": 0}, {"jax": 0, "port": 0}

    def z(self, side, shape):
        k = self.calls[side]
        self.calls[side] += 1
        return np.random.default_rng((self.seed, k)).normal(size=shape).astype(np.float32)

    def u(self, side):
        k = self.uniform_calls[side]
        self.uniform_calls[side] += 1
        return np.float32(np.random.default_rng((self.seed, 10_000 + k)).uniform())

    def patch(self, monkeypatch):
        tape = self

        def j_sample(self, key, sample_shape=()):
            shape = tuple(sample_shape) + tuple(jnp.broadcast_shapes(jnp.shape(self.loc), jnp.shape(self.scale)))
            return self.loc + self.scale * jnp.asarray(tape.z("jax", shape))

        def t_sample(self, generator, sample_shape=()):
            return self.loc + self.scale * torch.from_numpy(tape.z("port", tuple(sample_shape) + self.batch_shape))

        monkeypatch.setattr(jdist.Normal, "sample", j_sample)
        monkeypatch.setattr(tdist.Normal, "sample", t_sample)

    def filters(self, n, oes=1, **kwargs):
        """The JAX SISR with the replay resampler and the port's with the
        replayed uniform, both on the AR model."""
        tape = self

        def j_resampler(key, w, normalized=False):
            return j_counts(None, w, normalized=normalized, u=jnp.asarray(tape.u("jax")))

        class Replay(pt.SISR):
            def resample_uniform(self, generator):
                return torch.tensor(tape.u("port"))

        return (pf.SISR(_j_ssm(oes), n, resampling_method=j_resampler, **kwargs),
                Replay(_t_ssm(oes), n, device="cpu", **kwargs))


def _port_state(j):
    return pt.convert.correction_from_numpy(
        *(np.asarray(a) for a in (j.x.time_index, j.x.value, j.log_weights, j.log_likelihood, j.prev_indices,
                                  j.mean, j.variance)), event_ndim=j.x.event_ndim, device="cpu")


def _j_state(n, lanes=(), seed=1, time_index=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(ALPHA, SIGMA, size=(n, *lanes)).astype(np.float32)
    lw = rng.normal(0.0, 1.5, size=(n, *lanes)).astype(np.float32)
    ident = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32).reshape((n,) + (1,) * len(lanes)), (n, *lanes))
    return JCorrection.from_weighted_particles(JState(jnp.asarray(time_index), jnp.asarray(x)), jnp.asarray(lw),
                                               jnp.zeros(lanes), ident)


def _same_correction(t, j):
    assert t.x.time_index == float(j.x.time_index)
    for a, b in ((t.x.value, j.x.value), (t.log_weights, j.log_weights), (t.log_likelihood, j.log_likelihood),
                 (t.mean, j.mean), (t.variance, j.variance)):
        _close(a, b)
    np.testing.assert_array_equal(t.prev_indices.numpy(), np.asarray(j.prev_indices))


@pytest.mark.parametrize("first_step", [True, False])
def test_step_is_filter(first_step):
    """``step`` from one state on one generator seed equals ``filter``, bit for bit."""
    filt = pt.SISR(_t_ssm(3), 256, device="cpu")
    state = _port_state(_j_state(256))
    a = filt.step(torch.Generator().manual_seed(4), 0.7, state, first_step=first_step)
    b = filt.filter(torch.Generator().manual_seed(4), 0.7, state, first_step=first_step)
    for x, y in zip((a.x.value, a.log_weights, a.log_likelihood, a.prev_indices, a.mean, a.variance),
                    (b.x.value, b.log_weights, b.log_likelihood, b.prev_indices, b.mean, b.variance)):
        assert torch.equal(x, y)
    assert a.x.time_index == b.x.time_index == (1.0 if first_step else 3.0)


@pytest.mark.parametrize("y_t", [0.7, float("nan")])
def test_return_intermediaries_matches_jax(y_t, monkeypatch):
    """One move at ``observe_every_step=3`` from a weighted cloud that
    resamples: the correction and the two sub-steps (time indexes, values,
    the post-resample log-weights, the ancestor indices) against the JAX
    package's, on replayed draws; an all-NaN observation propagates only.
    The first move has no sub-step (None in both)."""
    tape = _Tape(seed=5)
    tape.patch(monkeypatch)
    jfilt, tfilt = tape.filters(64, oes=3, ess_threshold=2.0)
    jstate = _j_state(64, time_index=1.0)
    with jax.disable_jit():
        jnew, jinter = jfilt.filter(jax.random.PRNGKey(0), jnp.asarray(y_t), jstate, return_intermediaries=True)
        _, jnone = jfilt.filter(jax.random.PRNGKey(0), jnp.asarray(y_t), jstate, first_step=True,
                                return_intermediaries=True)
    tnew, tinter = tfilt.filter(None, y_t, _port_state(jstate), return_intermediaries=True)
    _, tnone = tfilt.filter(None, y_t, _port_state(jstate), first_step=True, return_intermediaries=True)
    assert tape.calls["jax"] == tape.calls["port"] and tape.uniform_calls["jax"] == tape.uniform_calls["port"] == 2
    _same_correction(tnew, jnew)
    assert jnone is None and tnone is None
    times, values, lw, idx = tinter
    assert values.shape == lw.shape == idx.shape == (2, 64)
    np.testing.assert_array_equal(times.numpy(), np.asarray(jinter[0], np.float32))
    np.testing.assert_array_equal(times.numpy(), [2.0, 3.0])
    _close(values, jinter[1])
    _close(lw, jinter[2])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jinter[3]))


@pytest.mark.parametrize("n_valid", [1, 5, 11])
def test_batch_filter_masked_matches_jax(n_valid, monkeypatch):
    """``batch_filter_masked(*pad_observations(y))`` on replayed draws: the
    padded per-step log-likelihoods (zero past ``n_valid``), the total and
    the last state against the JAX package's."""
    y = _y(n_valid, seed=n_valid)
    yp_j, nv_j = j_pad(y)
    yp_t, nv_t = t_pad(y)
    assert nv_t == nv_j == n_valid and isinstance(yp_t, np.ndarray)
    np.testing.assert_array_equal(yp_t, np.asarray(yp_j))
    tape = _Tape(seed=6)
    tape.patch(monkeypatch)
    jfilt, tfilt = tape.filters(64)
    with jax.disable_jit():
        jres = jfilt.batch_filter_masked(jax.random.PRNGKey(0), yp_j, nv_j)
    tres = tfilt.batch_filter_masked(None, yp_t, nv_t)
    assert tape.calls["jax"] == tape.calls["port"] and tape.uniform_calls["jax"] == tape.uniform_calls["port"]
    assert tres.step_log_likelihoods.shape == (len(yp_t),) and tres.filter_means is None
    _close(tres.step_log_likelihoods, jres.step_log_likelihoods)
    _close(tres.log_likelihood, jres.log_likelihood)
    _same_correction(tres.latest_state, jres.latest_state)


@pytest.mark.parametrize("n_valid", [1, 11])
def test_batch_filter_masked_is_batch_filter_of_the_first_rows(n_valid):
    y = _y(n_valid, seed=n_valid)
    plain = pt.SISR(_t_ssm(), 64, device="cpu")
    a = plain.batch_filter_masked(torch.Generator().manual_seed(9), t_pad(y)[0], n_valid)
    b = plain.batch_filter(torch.Generator().manual_seed(9), y)
    assert torch.equal(a.log_likelihood, b.log_likelihood)
    assert torch.equal(a.step_log_likelihoods[:n_valid], b.step_log_likelihoods)
    assert not a.step_log_likelihoods[n_valid:].any()
    assert torch.equal(a.latest_state.x.value, b.latest_state.x.value)


def test_pad_observations_and_masked_refusals():
    y = _y(5)
    out, n = t_pad(torch.from_numpy(y), bucket=12)
    assert n == 5 and out.shape == (12,) and torch.equal(out[:5], torch.from_numpy(y)) and not out[5:].any()
    assert t_pad(_y(8))[0].shape == (8,) and t_pad(_y(9))[0].shape == (16,)
    y2 = np.ones((3, 2), np.float32)
    np.testing.assert_array_equal(t_pad(y2)[0], np.asarray(j_pad(y2)[0]))
    with pytest.raises(ValueError, match="bucket"):
        t_pad(y, bucket=4)
    with pytest.raises(ValueError, match="cannot record"):
        pt.SISR(_t_ssm(), 16, record_states=True, device="cpu").batch_filter_masked(None, *t_pad(y))
    with pytest.raises(ValueError, match="n_valid"):
        pt.SISR(_t_ssm(), 16, device="cpu").batch_filter_masked(None, y, 9)


def test_lane_concat_and_resample_particles_match_jax():
    """Three corrections over 2, 1 and 3 lanes concatenated along the lane
    axis, then the particle axis gathered by indices ``(N, 6)``: every leaf
    against the JAX package's."""
    n = 32
    jstates = [_j_state(n, (k,), seed=10 + k, time_index=4.0) for k in (2, 1, 3)]
    jstates = [s._replace(log_likelihood=jnp.asarray(np.arange(k, dtype=np.float32) + k))
               for s, k in zip(jstates, (2, 1, 3))]
    jcat = JCorrection.lane_concat(jstates)
    tcat = TCorrection.lane_concat([_port_state(s) for s in jstates])
    assert tcat.x.value.shape == tcat.log_weights.shape == (n, 6) and tcat.log_likelihood.shape == (6,)
    _same_correction(tcat, jcat)

    idx = np.random.default_rng(3).integers(0, n, size=(n, 6)).astype(np.int32)
    jres = jcat.resample_particles(jnp.asarray(idx))
    tres = tcat.resample_particles(torch.from_numpy(idx))
    _same_correction(tres, jres)
    assert not tres.log_weights.any() and tres.prev_indices.dtype == torch.int32
