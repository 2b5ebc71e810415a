"""The port's ensemble filters (the stochastic EnKF, the ETKF and LETKF) and
their ensemble smoothers, held against the JAX package's
``pyfilter_tpu/filters/enkf.py`` and ``etkf.py``.

Their randomness is matched by replaying the same draws in both packages:
the JAX pass runs eagerly with ``jax.random.normal`` drawing from a numpy
tape (``test_torch_port_tempered.Tape``: the initial ensemble, the
forecasts' increments, the EnKF's observation perturbations, in the JAX
run's order), then the port takes the same draws through its seams, the
distributions' ``Normal.sample`` and ``filters.enkf._standard_normal`` (the
perturbations). With the draws equal, the stochastic EnKF and the global
ETKF agree within rel 1e-5 / abs 1e-5. The ``eigh`` paths and the
Newton-Schulz LETKF within rel 1e-4: ``eigh`` is LAPACK's on both sides but
its float32 eigenvectors reach the symmetric square root through a
reconstruction that rounds differently, and the 14 Newton-Schulz iterations
are 28 matrix products each rounding on its own. Then the JAX package's own
checks on the port: lane batching equals a per-lane loop on the same draws
(``tests/test_enkf.py:145,182``), an infinite taper radius reproduces the
global ETKF, and with the slope of a local linear trend never observed a
large ensemble meets the level-only exact filter (``tests/test_partial_nan.py:93``).
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
from pyfilter_tpu.filters import enkf as jenkf
from pyfilter_tpu.filters import etkf as jetkf
from pyfilter_tpu_torch.filters import enkf as tenkf
from test_torch_port_kalman import ar_data, ar_pair, close, llt_data, llt_pair
from test_torch_port_tempered import Tape

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)


def replay(monkeypatch, tape):
    """The port's normal draws taken from ``tape``, in order; returns the
    iterator (empty once every draw is taken)."""
    draws = iter(tape.normals)

    def normal(shape):
        z = next(draws)
        assert z.shape == tuple(shape), (z.shape, tuple(shape))
        return torch.from_numpy(z)

    monkeypatch.setattr(pt.distributions.Normal, "sample", lambda self, generator, sample_shape=(): (
        self.loc + self.scale * normal(tuple(sample_shape) + tuple(self.batch_shape))))
    monkeypatch.setattr(tenkf, "_standard_normal", lambda generator, shape, like: normal(shape))
    return draws


def ring_pair(d, q_std=0.3, obs_std=0.25, decay=0.95, mix=0.2):
    """``tests/test_etkf.py``'s linear ring diffusion, observed elementwise."""
    def jmean_scale(x, decay_, mix_, q_):
        v = x.value
        return decay_ * ((1.0 - mix_) * v + mix_ * 0.5 * (jnp.roll(v, 1, axis=-1) + jnp.roll(v, -1, axis=-1))), q_

    jhidden = jts.AffineProcess(jmean_scale, (jnp.asarray(decay), jnp.asarray(mix), jnp.asarray(q_std)),
                                jdist.Normal(jnp.zeros(d), jnp.ones(d)).to_event(1),
                                lambda *_: jdist.Normal(jnp.zeros(d), jnp.ones(d)).to_event(1))
    jssm = jts.LinearStateSpaceModel(jhidden, (1.0, obs_std), event_shape=(d,))

    def tmean_scale(x, decay_, mix_, q_):
        v = x.value
        return decay_ * ((1.0 - mix_) * v + mix_ * 0.5 * (torch.roll(v, 1, dims=-1) + torch.roll(v, -1, dims=-1))), q_

    unit = pt.distributions.Normal(torch.zeros(d), torch.ones(d)).to_event(1)
    thidden = pt.timeseries.AffineProcess(tmean_scale, tuple(torch.tensor(v) for v in (decay, mix, q_std)), unit,
                                          lambda *_: unit)
    return jssm, pt.timeseries.LinearStateSpaceModel(thidden, (1.0, obs_std), event_shape=(d,))


def ring_distances(d):
    idx = np.arange(d, dtype=np.float32)
    diff = np.abs(idx[:, None] - idx[None, :])
    return np.minimum(diff, d - diff)


def ring_data(d, n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=d)
    y = np.empty((n, d), np.float32)
    for t in range(n):
        x = 0.95 * (0.8 * x + 0.1 * (np.roll(x, 1) + np.roll(x, -1))) + 0.3 * rng.normal(size=d)
        y[t] = x + 0.25 * rng.normal(size=d)
    return y


def localization_pair(d, radius):
    dist = ring_distances(d)
    jloc = pf.Localization.from_distances(jnp.asarray(dist), jnp.asarray(dist), radius, dist_xx=jnp.asarray(dist))
    tloc = pt.convert.localization_from_numpy(radius, dist_xy=dist, dist_yy=dist, dist_xx=dist, device="cpu")
    return jloc, tloc


def run_both(monkeypatch, jrun, trun, seed=0):
    """``jrun()`` eagerly on a numpy tape, then ``trun()`` on the same draws,
    every draw taken."""
    tape = Tape(seed)
    jout = tape.record(monkeypatch, jrun)
    with monkeypatch.context() as m:
        draws = replay(m, tape)
        tout = trun()
        assert next(draws, None) is None, "the port took fewer draws than the JAX run"
    return jout, tout


def same_result(jres, tres, rtol=1e-5, atol=1e-5):
    close(tres.log_likelihood, jres.log_likelihood, rtol, atol)
    close(tres.step_log_likelihoods, jres.step_log_likelihoods, rtol, atol)
    close(tres.filter_means, jres.filter_means, rtol, atol)
    close(tres.filter_variances, jres.filter_variances, rtol, atol)
    close(tres.latest_state.ensemble, jres.latest_state.ensemble, rtol, atol)


ENSEMBLE = {
    "enkf": (lambda m, **k: pf.EnsembleKalmanFilter(m, 40, **k),
             lambda m, **k: pt.EnsembleKalmanFilter(m, 40, device="cpu", **k), 1e-5),
    "enkf-inflated": (lambda m, **k: pf.EnsembleKalmanFilter(m, 40, inflation=1.05, **k),
                      lambda m, **k: pt.EnsembleKalmanFilter(m, 40, inflation=1.05, device="cpu", **k), 1e-5),
    "etkf": (lambda m, **k: pf.EnsembleTransformKalmanFilter(m, 40, **k),
             lambda m, **k: pt.EnsembleTransformKalmanFilter(m, 40, device="cpu", **k), 1e-4),
    "etkf-newton": (lambda m, **k: pf.EnsembleTransformKalmanFilter(m, 40, sqrt_method="newton", **k),
                    lambda m, **k: pt.EnsembleTransformKalmanFilter(m, 40, sqrt_method="newton", device="cpu", **k),
                    1e-4),
}


@pytest.mark.parametrize("name", sorted(ENSEMBLE))
@pytest.mark.parametrize("model", ["ar-oes2", "llt-nan"])
def test_filter_matches_jax_on_replayed_draws(monkeypatch, name, model):
    if model == "ar-oes2":
        (jm, tm), y = ar_pair(oes=2), ar_data(12, 3, nan_rows=(4,))
    else:
        (jm, tm), y = llt_pair(), llt_data(12, 4)
        y[3:6, 1] = np.nan
    make_j, make_t, tol = ENSEMBLE[name]
    jres, tres = run_both(monkeypatch, lambda: make_j(jm).batch_filter(KEY, jnp.asarray(y)),
                          lambda: make_t(tm).batch_filter(None, y))
    same_result(jres, tres, rtol=tol)
    if model == "ar-oes2":
        assert float(tres.step_log_likelihoods[4]) == 0.0


@pytest.mark.parametrize("name,sqrt_method", [("letkf", "newton"), ("letkf", "eigh"), ("enkf", None)])
def test_localized_filters_match_jax(monkeypatch, name, sqrt_method):
    """The LETKF (Newton-Schulz by default, ``eigh`` too) and the localized
    EnKF on the ring at d = 12, M = 10, Gaspari-Cohn radius 2."""
    d = 12
    jm, tm = ring_pair(d)
    jloc, tloc = localization_pair(d, 2.0)
    close(tloc.rho_xy, jloc.rho_xy)
    y = ring_data(d)
    y[2, 3] = np.nan
    if name == "letkf":
        kw = {} if sqrt_method == "newton" else {"sqrt_method": "eigh"}
        jf = pf.EnsembleTransformKalmanFilter(jm, 10, inflation=1.05, localization=jloc, **kw)
        tf = pt.EnsembleTransformKalmanFilter(tm, 10, inflation=1.05, localization=tloc, device="cpu", **kw)
        assert tf.sqrt_method == jf.sqrt_method
        tol = 1e-4
    else:
        jf = pf.EnsembleKalmanFilter(jm, 10, inflation=1.05, localization=jloc)
        tf = pt.EnsembleKalmanFilter(tm, 10, inflation=1.05, localization=tloc, device="cpu")
        tol = 1e-5
    jres, tres = run_both(monkeypatch, lambda: jf.batch_filter(KEY, jnp.asarray(y)),
                          lambda: tf.batch_filter(None, y))
    same_result(jres, tres, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["enkf", "etkf", "letkf"])
def test_smoothers_match_jax(monkeypatch, name):
    """The EnKS and ETKS (member-paired ensemble RTS; the LETKF's with the
    ``rho_xx`` taper)."""
    if name == "letkf":
        d = 12
        jm, tm = ring_pair(d)
        jloc, tloc = localization_pair(d, 2.0)
        y = ring_data(d, n=6)
        jf = pf.EnsembleTransformKalmanFilter(jm, 10, localization=jloc)
        tf = pt.EnsembleTransformKalmanFilter(tm, 10, localization=tloc, device="cpu")
    else:
        (jm, tm), y = ar_pair(), ar_data(10, 5)
        cls_j, cls_t = ((pf.EnsembleKalmanFilter, pt.EnsembleKalmanFilter) if name == "enkf"
                        else (pf.EnsembleTransformKalmanFilter, pt.EnsembleTransformKalmanFilter))
        jf, tf = cls_j(jm, 30), cls_t(tm, 30, device="cpu")
    jsm, tsm = run_both(monkeypatch, lambda: jf.smooth(KEY, jnp.asarray(y)), lambda: tf.smooth(None, y))
    close(tsm, jsm, rtol=1e-5 if name == "enkf" else 1e-4, atol=1e-5 if name == "enkf" else 1e-4)


@pytest.mark.parametrize("m_count,d,taper", [(5, 8, False), (12, 3, False), (6, 8, True)])
def test_enrts_backward_matches_jax(m_count, d, taper):
    """The backward pass alone on given ensembles: the ensemble-space solve
    (M <= d), the state-space one (d < M), and the tapered one."""
    rng = np.random.default_rng(m_count + d)
    fores, anas = (rng.normal(size=(5, m_count, d)).astype(np.float32) for _ in range(2))
    rho = np.exp(-ring_distances(d) / 2.0).astype(np.float32) if taper else None
    out_j = jenkf.enrts_backward(jnp.asarray(fores), jnp.asarray(anas), float(m_count),
                                 rho_xx=None if rho is None else jnp.asarray(rho))
    out_t = tenkf.enrts_backward(torch.tensor(fores), torch.tensor(anas), float(m_count),
                                 rho_xx=None if rho is None else torch.tensor(rho))
    close(out_t, out_j, rtol=1e-4, atol=1e-4)


def test_gaspari_cohn_and_localization_match_jax():
    r = np.linspace(0.0, 2.5, 51, dtype=np.float32)
    close(pt.filters.gaspari_cohn(torch.tensor(r)), jetkf.gaspari_cohn(jnp.asarray(r)))
    coords = np.random.default_rng(0).normal(size=(6, 2)).astype(np.float32)
    obs = coords[:4] + 0.1
    jl = pf.Localization.from_coords(jnp.asarray(coords), jnp.asarray(obs), radius=0.8)
    tl = pt.convert.localization_from_numpy(0.8, state_coords=coords, obs_coords=obs, device="cpu")
    for a, b in zip(tl, jl):
        close(a, b)


@pytest.mark.parametrize("name", ["enkf", "etkf"])
def test_lane_batching_matches_per_lane_loop(monkeypatch, name):
    """``tests/test_enkf.py:145,182``: lane-batched model leaves (one beta per
    lane) under one vmap reproduce single-lane runs on the same draws (each
    draw of the vmapped pass is one tape entry, shared by the lanes), and the
    JAX package's single-lane runs on that tape too."""
    betas = np.asarray([0.5, 0.7, 0.9], np.float32)
    y = ar_data(10, 6)
    make_j, make_t = ((pf.EnsembleKalmanFilter, pt.EnsembleKalmanFilter) if name == "enkf"
                      else (pf.EnsembleTransformKalmanFilter, pt.EnsembleTransformKalmanFilter))
    tapes, singles_j = [], []
    for b in betas:
        tapes.append(Tape(1))
        jm = ar_pair(beta=float(b))[0]
        singles_j.append(tapes[-1].record(monkeypatch, lambda: make_j(jm, 50).batch_filter(KEY, jnp.asarray(y))))
    with monkeypatch.context() as m:
        replay(m, tapes[0])
        laned = make_t(ar_pair(beta=betas)[1], 50, batch_shape=(3,), device="cpu").batch_filter(None, y)
    assert tuple(laned.log_likelihood.shape) == (3,) and tuple(laned.latest_state.ensemble.shape) == (3, 50, 1)
    assert tuple(laned.filter_means.shape) == (10, 3, 1)
    for i, b in enumerate(betas):
        with monkeypatch.context() as m:
            replay(m, tapes[i])
            single = make_t(ar_pair(beta=float(b))[1], 50, device="cpu").batch_filter(None, y)
        close(laned.log_likelihood[i], single.log_likelihood, rtol=2e-5)
        close(laned.filter_means[:, i], single.filter_means, rtol=1e-4, atol=1e-5)
        close(laned.log_likelihood[i], singles_j[i].log_likelihood, rtol=2e-5 if name == "enkf" else 1e-4)
    perm = laned.latest_state.resample(torch.tensor([2, 0, 1]))
    close(perm.log_likelihood, laned.latest_state.log_likelihood[[2, 0, 1]])


def test_lanes_draw_their_own_noise():
    """Without a tape each lane draws its own forecast noise from the one
    generator (``randomness="different"``)."""
    laned = pt.EnsembleTransformKalmanFilter(ar_pair(beta=np.asarray([0.7, 0.7], np.float32))[1], 40,
                                             batch_shape=(2,), device="cpu").batch_filter(
        torch.Generator().manual_seed(3), ar_data(10, 7))
    assert torch.isfinite(laned.log_likelihood).all()
    assert not torch.equal(laned.latest_state.ensemble[0], laned.latest_state.ensemble[1])


def test_etkf_with_infinite_radius_matches_global_etkf():
    """``tests/test_etkf.py:146``: every taper weight 1 makes the LETKF's
    per-component solves reproduce the global ETKF (the same forecast draws
    from one seed)."""
    d = 8
    _, tm = ring_pair(d)
    _, tloc = localization_pair(d, 1e6)
    y = ring_data(d, n=6, seed=2)
    outs = [pt.EnsembleTransformKalmanFilter(tm, 200, localization=loc, device="cpu").batch_filter(
        torch.Generator().manual_seed(5), y) for loc in (None, tloc)]
    close(outs[1].filter_means, outs[0].filter_means, rtol=1e-3, atol=1e-4)
    close(outs[1].log_likelihood, outs[0].log_likelihood, rtol=1e-4)


def test_enkf_tracks_the_exact_filter_with_partial_nan():
    """``tests/test_partial_nan.py:93``: the slope always missing, a large
    ensemble meets the level-only exact filter."""
    y = llt_data()
    y_masked = y.copy()
    y_masked[:, 1] = np.nan
    oracle = pt.KalmanFilter(llt_pair(observe_slope=False)[1], device="cpu").batch_filter(y[:, :1])
    res = pt.EnsembleKalmanFilter(llt_pair()[1], ensemble_size=4000, device="cpu").batch_filter(
        torch.Generator().manual_seed(1), y_masked)
    assert abs(float(res.log_likelihood) - float(oracle.log_likelihood)) < 2.0
    close(res.filter_means, oracle.filter_means, rtol=0.0, atol=0.08)
