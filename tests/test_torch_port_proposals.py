"""The port's optimal linear-Gaussian proposal, its numerics, the linear
models and ``systematic_m``, held against the JAX package; and the reference
README's flagship flow (APF with the optimal proposal, recorded history,
FFBS and fixed-lag smoothing) on the port, on the CPU.

Deterministic pieces take the same numpy inputs in both packages. Sampling
is replayed: the tests replace ``Normal.sample`` / ``MultivariateNormal.sample``
of both packages by ``loc + scale * z`` (``loc + L z``) with the same
standard-normal ``z``, and the resampling uniforms are injected (the JAX
filter through a replay resampler on its unfused branch, the port's through
``ParticleFilter.resample_uniform`` on its fused branch).

Tolerance: rel 1e-5 / abs 5e-5 in float32 (the BASELINE.md gate; abs 5e-5
because a log-likelihood sums T float32 increments rounded differently by the
two frameworks), rel 1e-4 on the outputs of the 2-D inverse; indices exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import examples as jexamples
from pyfilter_tpu import resampling as jresampling
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.filters.particle import proposals as jprops
from pyfilter_tpu.filters.particle.proposals import utils as jputils
from pyfilter_tpu.filters.state import ParticleFilterCorrection as JCorrection
from pyfilter_tpu.filters.state import ParticleFilterPrediction as JPrediction
from pyfilter_tpu.ops import systematic_counts as j_counts
from pyfilter_tpu.timeseries import TimeseriesState as JState
from pyfilter_tpu.timeseries import models as jmodels
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import resampling as tresampling
from pyfilter_tpu_torch import timeseries as tts
from pyfilter_tpu_torch.filters.particle.proposals import LinearGaussianObservations
from pyfilter_tpu_torch.filters.particle.proposals import utils as tputils
from pyfilter_tpu_torch.filters.state import ParticleFilterPrediction as TPrediction

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 5e-5
N = 64
AR_PARAMS = (0.1, 0.9, 0.3)
RW_SIGMA = np.array([0.05, 0.1], np.float32)
OBS_S = 0.15


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


# -- the two linear-Gaussian models of tests/test_filters.py, in both packages --
def _jax_model(name):
    if name == "ar":
        return jts.LinearStateSpaceModel(jmodels.AR(*AR_PARAMS), (1.0, OBS_S))
    a = jnp.eye(2, dtype=jnp.float32)
    rw = jts.LinearModel(
        (a, jnp.asarray(RW_SIGMA)),
        jdist.Normal(0.0, 1.0).expand((2,)).to_event(1),
        lambda m_, _, s_: jdist.Normal(0.0, s_).expand((2,)).to_event(1),
        event_ndim=1,
    )
    return jts.LinearStateSpaceModel(rw, (a, jnp.full(2, OBS_S, jnp.float32)), event_shape=(2,))


def _port_model(name):
    if name == "ar":
        return pt.convert.linear_ssm_from_numpy(
            pt.convert.ar_from_numpy(*map(np.float32, AR_PARAMS), device="cpu"),
            np.float32(1.0), np.float32(0.0), np.float32(OBS_S),
        )
    zero, one = torch.zeros(()), torch.ones(())
    rw = tts.LinearModel(
        (torch.eye(2), torch.from_numpy(RW_SIGMA)),
        tdist.Normal(zero, one).expand((2,)).to_event(1),
        lambda m_, _, s_: tdist.Normal(torch.zeros_like(s_), s_).expand((2,)).to_event(1),
        event_ndim=1,
    )
    return tts.LinearStateSpaceModel(rw, (torch.eye(2), torch.full((2,), OBS_S)), event_shape=(2,))


class _Noise:
    """Standard-normal draws replayed in both packages: ``z[t]`` at step ``t``."""

    def __init__(self, z):
        self.z, self.t = z, 0

    def patch(self, monkeypatch):
        noise = self

        def j_normal(self, key, sample_shape=()):
            return self.loc + self.scale * jnp.asarray(noise.z[noise.t])

        def j_mvn(self, key, sample_shape=()):
            return self.loc + jnp.einsum("...ij,...j->...i", self.scale_tril, jnp.asarray(noise.z[noise.t]))

        def t_normal(self, generator, sample_shape=()):
            return self.loc + self.scale * torch.from_numpy(noise.z[noise.t].copy())

        def t_mvn(self, generator, sample_shape=()):
            return self.loc + torch.einsum("...ij,...j->...i", self.scale_tril, torch.from_numpy(noise.z[noise.t].copy()))

        monkeypatch.setattr(jdist.Normal, "sample", j_normal)
        monkeypatch.setattr(jdist.MultivariateNormal, "sample", j_mvn)
        monkeypatch.setattr(tdist.Normal, "sample", t_normal)
        monkeypatch.setattr(tdist.MultivariateNormal, "sample", t_mvn)


def _event_shape(name):
    return () if name == "ar" else (2,)


# -- the linear models ------------------------------------------------------------
def test_linear_models_match_jax():
    """AR and RandomWalk carried across as the JAX processes' numpy leaves,
    and the 2-D linear model: transition, initial and observation densities
    on the same inputs."""
    rng = np.random.default_rng(5)
    x, x_next = (rng.normal(size=N).astype(np.float32) for _ in range(2))
    pairs = [
        (jmodels.AR(*AR_PARAMS), lambda p: pt.convert.ar_from_numpy(*p, device="cpu")),
        (jmodels.RandomWalk(0.3), lambda p: pt.convert.random_walk_from_numpy(*p, device="cpu")),
    ]
    for jproc, convert in pairs:
        tproc = convert([np.asarray(v, np.float32) for v in jproc.parameters])
        jd = jproc.build_density(JState(jnp.asarray(2.0), jnp.asarray(x)))
        td = tproc.build_density(tts.TimeseriesState(2.0, torch.from_numpy(x)))
        _close(td.log_prob(torch.from_numpy(x_next)), jd.log_prob(jnp.asarray(x_next)))
        _close(tproc.initial_distribution().log_prob(torch.from_numpy(x)),
               jproc.initial_distribution().log_prob(jnp.asarray(x)))

    x2, y2 = (rng.normal(size=(N, 2)).astype(np.float32) for _ in range(2))
    jmodel, tmodel = _jax_model("rw2d"), _port_model("rw2d")
    jstate, tstate = JState(jnp.asarray(1.0), jnp.asarray(x2), 1), tts.TimeseriesState(1.0, torch.from_numpy(x2), 1)
    _close(tmodel.hidden.build_density(tstate).log_prob(torch.from_numpy(y2)),
           jmodel.hidden.build_density(jstate).log_prob(jnp.asarray(y2)))
    _close(tmodel.build_density(tstate).log_prob(torch.from_numpy(y2)), jmodel.build_density(jstate).log_prob(jnp.asarray(y2)))
    assert tmodel.build_density(tstate).event_shape == (2,)


# -- find_optimal_density and linear_marginal_density ----------------------------
# (hidden_event_ndim, obs_event_ndim): scalar, full matrix, vector hidden state
# seen as a scalar, scalar hidden state seen as a vector
_CASES = {"scalar": (0, 0), "matrix": (1, 1), "vector-hidden": (1, 0), "vector-obs": (0, 1)}


def _density_inputs(case, seed):
    he, oe = _CASES[case]
    rng = np.random.default_rng(seed)
    dh, do = (2 if he else 1), (3 if oe else 1)
    hshape, oshape = ((N, dh) if he else (N,)), ((N, do) if oe else (N,))
    if he and oe:
        a = rng.normal(size=(do, dh))
    elif he:
        a = rng.normal(size=dh)
    elif oe:
        a = rng.normal(size=do)
    else:
        a = rng.normal()
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    return dict(
        y=f32(rng.normal(size=oshape)), loc=f32(rng.normal(size=hshape)),
        h=f32(rng.uniform(0.5, 2.0, size=(dh,) if he else ())), o=f32(rng.uniform(0.5, 2.0, size=(do,) if oe else ())),
        a=f32(a), offset=f32(rng.normal(size=(do,) if oe else ())), he=he, oe=oe,
    )


def _params(d):
    """A distribution's parameters: (loc, scale) or (loc, scale_tril)."""
    tril = getattr(d, "scale_tril", None)
    return [np.asarray(d.loc), np.asarray(d.scale if tril is None else tril)]


@pytest.mark.parametrize("case", sorted(_CASES))
def test_find_optimal_density_matches_jax(case):
    d = _density_inputs(case, seed=1)
    jk = jputils.find_optimal_density(*(jnp.asarray(d[k]) for k in ("y", "loc", "h", "o", "a")), d["he"], d["oe"])
    tk = tputils.find_optimal_density(*(torch.from_numpy(d[k]) for k in ("y", "loc", "h", "o", "a")), d["he"], d["oe"])
    assert type(tk).__name__ == type(jk).__name__
    rtol = RTOL if case == "scalar" else 1e-4  # through the 2-D inverse
    for tp, jp in zip(_params(tk), _params(jk)):
        assert tp.shape == jp.shape
        _close(tp, jp, rtol=rtol)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_linear_marginal_density_matches_jax(case):
    d = _density_inputs(case, seed=2)
    args = ("loc", "h", "o", "a", "offset")
    jk = jputils.linear_marginal_density(*(jnp.asarray(d[k]) for k in args), d["he"], d["oe"])
    tk = tputils.linear_marginal_density(*(torch.from_numpy(d[k]) for k in args), d["he"], d["oe"])
    assert type(tk).__name__ == type(jk).__name__
    rtol = RTOL if case == "scalar" else 1e-4
    for tp, jp in zip(_params(tk), _params(jk)):
        assert tp.shape == jp.shape
        _close(tp, jp, rtol=rtol)
    _close(tk.log_prob(torch.from_numpy(d["y"])), jk.log_prob(jnp.asarray(d["y"])), rtol=rtol)


# -- the proposal itself ----------------------------------------------------------
@pytest.mark.parametrize("name", ["ar", "rw2d"])
def test_linear_proposal_sample_and_weight_matches_jax(name, monkeypatch):
    rng = np.random.default_rng(3)
    shape = (N,) + _event_shape(name)
    x0 = rng.normal(size=shape).astype(np.float32)
    y = rng.normal(size=_event_shape(name)).astype(np.float32)
    noise = _Noise(rng.normal(size=(1,) + shape).astype(np.float32))
    noise.patch(monkeypatch)
    ev = len(_event_shape(name))
    w = np.zeros(N, np.float32)
    idx = np.arange(N, dtype=np.int32)

    jpred = JPrediction(JState(jnp.asarray(3.0), jnp.asarray(x0), ev), jnp.asarray(w), jnp.asarray(w + 1 / N), jnp.asarray(idx))
    tpred = TPrediction(tts.TimeseriesState(3.0, torch.from_numpy(x0), ev), torch.from_numpy(w), torch.from_numpy(w + 1 / N),
                        torch.from_numpy(idx))
    jmodel, tmodel = _jax_model(name), _port_model(name)
    jx, jw = jprops.LinearGaussianObservations().sample_and_weight(None, jmodel, jnp.asarray(y), jpred)
    tx, tw = LinearGaussianObservations().sample_and_weight(None, tmodel, torch.from_numpy(y), tpred)
    assert tx.time_index == float(jx.time_index) == 4.0
    rtol = RTOL if name == "ar" else 1e-4
    _close(tx.value, jx.value, rtol=rtol)
    _close(tw, jw, rtol=rtol)
    _close(LinearGaussianObservations().pre_weight(tmodel, torch.from_numpy(y), tpred.x),
           jprops.LinearGaussianObservations().pre_weight(jmodel, jnp.asarray(y), jpred.x), rtol=rtol)


@pytest.mark.parametrize("custom", [False, True])
def test_pre_weight_func_matches_jax(custom):
    """The APF pre-weight at the affine conditional mean (the default) and at
    a caller's ``pre_weight_func`` (here the current state itself)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=N).astype(np.float32)
    y = np.float32(0.3)
    func = (lambda hidden, state: state) if custom else None
    jw = jprops.Bootstrap(pre_weight_func=func).pre_weight(_jax_model("ar"), jnp.asarray(y), JState(jnp.asarray(1.0), jnp.asarray(x)))
    tw = pt.filters.particle.proposals.Bootstrap(pre_weight_func=func).pre_weight(
        _port_model("ar"), torch.tensor(y), tts.TimeseriesState(1.0, torch.from_numpy(x)))
    _close(tw, jw)


class _ReplayAPFT(pt.APF):
    """The port's APF with its default resampler, whose fused branch draws
    the replayed uniform of the current step."""

    def __init__(self, *args, us, noise, **kwargs):
        super().__init__(*args, **kwargs)
        self.us, self.noise, self.uniform_draws = us, noise, 0

    def resample_uniform(self, generator):
        self.uniform_draws += 1
        return torch.tensor(self.us[self.noise.t])


def test_apf_linear_proposal_matches_jax_with_replayed_noise(monkeypatch):
    """15 APF steps with the optimal proposal on the AR model, stepped
    through each package's own ``filter`` from one cloud (the 2-D model's
    matrix branch is held above, through ``sample_and_weight``)."""
    name, n_steps = "ar", 15
    rng = np.random.default_rng(4)
    shape = (N,) + _event_shape(name)
    x0 = rng.normal(size=shape).astype(np.float32)
    y = (np.cumsum(rng.normal(size=(n_steps,) + _event_shape(name)), axis=0) * 0.1).astype(np.float32)
    noise = _Noise(rng.normal(size=(n_steps,) + shape).astype(np.float32))
    us = rng.uniform(size=n_steps).astype(np.float32)
    noise.patch(monkeypatch)

    jfilt = pf.APF(
        _jax_model(name), N, proposal=jprops.LinearGaussianObservations(),
        resampling_method=lambda key, w, normalized=False: j_counts(None, w, normalized=normalized,
                                                                    u=jnp.asarray(us[noise.t])),
    )
    tfilt = _ReplayAPFT(_port_model(name), N, proposal=LinearGaussianObservations(), device="cpu", us=us, noise=noise)
    assert tfilt._use_fused_resample(torch.zeros(1))
    ev = len(_event_shape(name))
    jstate = JCorrection.from_weighted_particles(
        JState(jnp.asarray(0.0), jnp.asarray(x0), ev), jnp.zeros(N), jnp.zeros(()), jnp.arange(N, dtype=jnp.int32)
    )
    tstate = pt.convert.correction_from_numpy(
        *(np.asarray(a) for a in (jstate.x.time_index, jstate.x.value, jstate.log_weights, jstate.log_likelihood,
                                  jstate.prev_indices, jstate.mean, jstate.variance)),
        event_ndim=ev, device="cpu",
    )
    out = {"jax": ([], []), "port": ([], [])}
    with jax.disable_jit():
        for t in range(n_steps):
            noise.t = t
            jstate = jfilt.filter(jax.random.PRNGKey(0), jnp.asarray(y[t]), jstate, first_step=t == 0)
            tstate = tfilt.filter(None, y[t], tstate, first_step=t == 0)
            for key, s in (("jax", jstate), ("port", tstate)):
                out[key][0].append(np.asarray(s.mean))
                out[key][1].append(np.asarray(s.log_likelihood))
    (jm, jl), (tm, tl) = (np.stack(a) for a in out["jax"]), (np.stack(a) for a in out["port"])
    assert tfilt.uniform_draws == n_steps and np.isfinite(tl).all()
    _close(tm, jm)
    _close(tl, jl)
    _close(tl.sum(), jl.sum())
    np.testing.assert_array_equal(tstate.prev_indices.numpy(), np.asarray(jstate.prev_indices))


# -- systematic_m ---------------------------------------------------------------------
@pytest.mark.parametrize("n,m,seed", [(512, 100, 0), (300, 700, 1), (2, 9, 3)])
def test_systematic_m_matches_jax(n, m, seed):
    """The same uniform (drawn by the JAX package from its key) gives the same
    indices at these sizes, where the exact and the float32 cumulative sums
    round alike."""
    lw = np.random.default_rng(seed).normal(size=n).astype(np.float32) * 2.0
    key = jax.random.PRNGKey(seed)
    j_idx = np.asarray(jresampling.systematic_m(key, jnp.asarray(lw), m))
    u = jax.random.uniform(key, (), dtype=jnp.float32)
    t_idx = tresampling.systematic_m(None, torch.from_numpy(lw), m, u=torch.tensor(float(u)))
    assert t_idx.dtype == torch.int32 and t_idx.shape == (m,)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)


# -- the flagship flow, on the port, on the CPU -------------------------------------------
def test_flagship_flow_on_cpu():
    """The reference README's flow at examples/sine_apf.py's quick size: the
    port's health checks (finite log-likelihood, filter RMSE at the
    observation-noise scale, FFBS no worse than the filter, fixed-lag
    smoothing of the right shape), and the port's log-likelihood against the
    JAX package's on the same data within 4 standard errors (each package
    with its own randomness)."""
    n_particles, n_obs, runs = 200, 300, 6
    model = pt.examples.sine_diffusion_model(dt=0.05, device="cpu")
    x_true, y = model.sample_states(torch.Generator().manual_seed(0), n_obs).get_paths()
    assert y.shape == (n_obs,) and torch.isfinite(y).all()
    lls = []
    for seed in range(runs):
        filt = pt.APF(model, n_particles, proposal=LinearGaussianObservations(), record_states=True, device="cpu")
        res = filt.batch_filter(torch.Generator().manual_seed(seed), y)
        lls.append(float(res.log_likelihood))
    assert res.states.values.shape == (n_obs + 1, n_particles)
    np.testing.assert_array_equal(res.states.time_indexes.numpy(), np.arange(n_obs + 1, dtype=np.float32))

    rmse = float(torch.sqrt(torch.mean((res.filter_means - x_true) ** 2)))
    ffbs = filt.smooth(torch.Generator().manual_seed(9), res, method="ffbs")
    fl = filt.smooth(None, res, method="fl")
    assert ffbs.shape == fl.shape == (n_obs + 1, n_particles)
    ffbs_rmse = float(torch.sqrt(torch.mean((ffbs.mean(1)[1:] - x_true) ** 2)))
    assert np.isfinite(lls).all()
    assert rmse < 0.2, rmse
    assert ffbs_rmse <= rmse, (ffbs_rmse, rmse)

    jmodel = jexamples.sine_diffusion_model(dt=0.05)
    jfilt = pf.APF(jmodel, n_particles, proposal=jprops.LinearGaussianObservations())
    jll = float(jfilt.batch_filter(jax.random.PRNGKey(0), jnp.asarray(y.numpy())).log_likelihood)
    sd = float(np.std(lls, ddof=1))
    assert abs(np.mean(lls) - jll) < 4 * math.sqrt(sd**2 / runs + sd**2), (lls, jll)
