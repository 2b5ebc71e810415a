"""The port's lane-batched APF on the stochastic-volatility model, held
against the JAX package.

Both filters run K = 8 lanes, each with its own SV parameters, and are
stepped by hand through their own ``filter`` moves on the same numpy noise,
as in ``tests/test_torch_port_sisr.py``: a test-local replay proposal (the
transition law with its standard-normal draws injected), a replaying
increment distribution for the batched sub-step draw, and the per-lane
resampling uniforms. The JAX filter on the CPU takes its unfused branch, so
it gets a replay resampler (``systematic_counts`` with the uniforms given);
the port's filter keeps its default resampler and runs its fused lane
branch (``ops.systematic_expand_lanes``, which pulls the values and the
pre-weights through one expansion), with the uniforms replayed through
``ParticleFilter.resample_uniform``. Both start from one cloud, carried
across with ``pyfilter_tpu_torch.convert``.

Tolerance: rel 1e-5 / abs 5e-5 on the per-step per-lane filter means and
log-likelihoods and on the total (the BASELINE.md gate; abs 5e-5 because the
log-likelihood sums T float32 increments, each rounded differently by the
two frameworks).
"""

import dataclasses
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
from pyfilter_tpu.filters.particle.proposals import Proposal as JProposal
from pyfilter_tpu.filters.state import ParticleFilterCorrection as JCorrection
from pyfilter_tpu.ops import systematic_counts as j_counts
from pyfilter_tpu.timeseries import TimeseriesState as JState
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch.filters.particle.proposals import Proposal as TProposal
from pyfilter_tpu_torch.ops import expand as texpand

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N, K, T, DT = 64, 8, 15, 0.2
OES = int(1.0 / DT)
NAMES = ("kappa", "gamma", "sigma", "mu", "nu", "tau")


def _lane_params(seed):
    """Per-lane SV parameters around the bench model's, chosen so the APF's
    unshifted ``log(sum w exp(pre))`` stays finite."""
    rng = np.random.default_rng(seed)
    lo = dict(kappa=0.3, gamma=0.8, sigma=0.1, mu=-0.1, nu=-0.2, tau=0.9)
    hi = dict(kappa=0.7, gamma=1.2, sigma=0.2, mu=0.1, nu=0.2, tau=1.3)
    return {n: rng.uniform(lo[n], hi[n], K).astype(np.float32) for n in NAMES}


def _simulate(n_obs, seed):
    """Observations of one SV path (bench parameters; numpy)."""
    rng = np.random.default_rng(seed)
    vol, ys = 1.0, []
    for _ in range(n_obs):
        for _ in range(OES):
            vol = vol + 0.5 * (1.0 - vol) * vol * DT + 0.15 * vol * math.sqrt(DT) * rng.normal()
        ys.append(vol * math.sinh(math.asinh(rng.normal()) * 1.1))
    return np.asarray(ys, np.float32)


class _Clock:
    t = 0


class _ReplayNormalJ(jdist.Normal):
    def __init__(self, loc, scale, z, clock):
        super().__init__(loc, scale)
        self.z, self.clock = z, clock

    def sample(self, key, sample_shape=()):
        return self.loc + self.scale * jnp.asarray(self.z[self.clock.t])


@dataclasses.dataclass(frozen=True, eq=False)
class _ReplayProposalJ(JProposal):
    z: np.ndarray = None
    clock: object = None

    def sample_and_weight(self, key, model, y, prediction):
        x = prediction.get_timeseries_state()
        dens = model.hidden.build_density(x)
        new_x = x.propagate_from(values=dens.loc + dens.scale * jnp.asarray(self.z[self.clock.t]))
        return new_x, model.build_density(new_x).log_prob(y)


class _ReplayNormalT(tdist.Normal):
    def __init__(self, loc, scale, z, clock):
        super().__init__(loc, scale)
        self.z, self.clock = z, clock

    def sample(self, generator, sample_shape=()):
        return self.loc + self.scale * torch.from_numpy(self.z[self.clock.t].copy())


class _ReplayProposalT(TProposal):
    def __init__(self, z, clock):
        self.z, self.clock = z, clock

    def sample_and_weight(self, generator, model, y, prediction):
        x = prediction.get_timeseries_state()
        dens = model.hidden.build_density(x)
        new_x = x.propagate_from(values=dens.loc + dens.scale * torch.from_numpy(self.z[self.clock.t].copy()))
        return new_x, model.build_density(new_x).log_prob(y)


class _ReplayAPFT(pt.APF):
    """The port's APF with its default resampler, whose fused lane branch
    draws the replayed uniforms of the current step."""

    def __init__(self, *args, us, clock, **kwargs):
        super().__init__(*args, **kwargs)
        self.us, self.clock, self.uniform_draws = us, clock, 0

    def resample_uniform(self, generator):
        self.uniform_draws += 1
        return torch.from_numpy(self.us[self.clock.t].copy())


def test_apf_lanes_match_jax_with_replayed_noise(monkeypatch):
    rng = np.random.default_rng(21)
    params = _lane_params(22)
    y = _simulate(T, seed=23)
    x0 = rng.uniform(0.8, 1.2, (N, K)).astype(np.float32)
    z_sub = rng.normal(size=(T, OES - 1, N, K)).astype(np.float32)
    z_prop = rng.normal(size=(T, N, K)).astype(np.float32)
    us = rng.uniform(size=(T, K)).astype(np.float32)
    clock = _Clock()

    jmodel = jexamples.stochastic_volatility_model(**{n: jnp.asarray(v) for n, v in params.items()}, dt=DT)
    inc = jmodel.hidden.increment_distribution
    jmodel.hidden.increment_distribution = _ReplayNormalJ(inc.loc, inc.scale, z_sub, clock)
    jfilt = pf.APF(
        jmodel, N, proposal=_ReplayProposalJ(z=z_prop, clock=clock), batch_shape=(K,),
        resampling_method=lambda key, w, normalized=False: j_counts(
            None, w, normalized=normalized, u=jnp.asarray(us[clock.t])
        ),
    )
    assert not jfilt._use_fused_resample(jnp.zeros(1))

    tmodel = pt.convert.sv_model_from_numpy(*params.values(), dt=DT, device="cpu")
    inc = tmodel.hidden.increment_distribution
    tmodel.hidden.increment_distribution = _ReplayNormalT(inc.loc, inc.scale, z_sub, clock)
    tfilt = _ReplayAPFT(tmodel, N, proposal=_ReplayProposalT(z_prop, clock), batch_shape=(K,), device="cpu",
                        us=us, clock=clock)
    lane_calls = []
    real = texpand.systematic_expand_lanes
    monkeypatch.setattr("pyfilter_tpu_torch.filters.particle.base.systematic_expand_lanes",
                        lambda *a, **kw: lane_calls.append(1) or real(*a, **kw))

    ident = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[:, None], (N, K))
    jstate = JCorrection.from_weighted_particles(
        JState(jnp.asarray(0.0), jnp.asarray(x0)), jnp.zeros((N, K)), jnp.zeros(K), ident
    )
    tstate = pt.convert.correction_from_numpy(
        *(np.asarray(a) for a in (jstate.x.time_index, jstate.x.value, jstate.log_weights,
                                  jstate.log_likelihood, jstate.prev_indices, jstate.mean, jstate.variance)),
        device="cpu",
    )

    out = {"jax": ([], []), "port": ([], [])}
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    with jax.disable_jit():
        for t in range(T):
            clock.t = t
            jstate = jfilt.filter(key, jnp.asarray(y[t]), jstate, first_step=t == 0)
            tstate = tfilt.filter(gen, y[t], tstate, first_step=t == 0)
            for name, s in (("jax", jstate), ("port", tstate)):
                out[name][0].append(np.asarray(s.mean))
                out[name][1].append(np.asarray(s.log_likelihood))

    (jm, jl), (tm, tl) = (np.stack(a) for a in out["jax"]), (np.stack(a) for a in out["port"])
    assert tm.shape == (T, K) and np.isfinite(tl).all()
    assert tfilt.uniform_draws == T == len(lane_calls), "every correction must take the fused lane branch"
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(tl.sum(axis=0), jl.sum(axis=0), rtol=1e-5, atol=5e-5)
    np.testing.assert_array_equal(tstate.prev_indices.numpy(), np.asarray(jstate.prev_indices))


def test_apf_lanes_batch_filter_on_cpu():
    """The port's own ``batch_filter`` over lanes with a ``torch.Generator``:
    lanes with the true parameters give log-likelihood estimates whose mean
    agrees with the JAX package's APF on the same data (its own randomness;
    the bound is 4 standard errors of the difference of the two means)."""
    y = _simulate(40, seed=24)
    model = pt.examples.stochastic_volatility_model(0.5, 1.0, 0.15, dt=DT, device="cpu")
    filt = pt.APF(model, 256, batch_shape=(32,), device="cpu")
    res = filt.batch_filter(torch.Generator().manual_seed(1), y)
    assert res.log_likelihood.shape == (32,) and res.filter_means.shape == (40, 32)
    assert torch.isfinite(res.log_likelihood).all()
    assert res.latest_state.x.value.shape == (256, 32)

    jres = pf.APF(jexamples.stochastic_volatility_model(0.5, 1.0, 0.15, dt=DT), 256, batch_shape=(32,)).batch_filter(
        jax.random.PRNGKey(0), jnp.asarray(y)
    )
    t_ll, j_ll = res.log_likelihood.numpy(), np.asarray(jres.log_likelihood)
    se = math.sqrt(t_ll.var(ddof=1) / 32 + j_ll.var(ddof=1) / 32)
    assert abs(t_ll.mean() - j_ll.mean()) < 4 * se + 1e-3


@pytest.mark.parametrize("factor", [2, 4])
def test_increase_particles_keeps_lanes(factor):
    model = pt.examples.stochastic_volatility_model(device="cpu")
    filt = pt.APF(model, 16, batch_shape=(3,), device="cpu")
    bigger = filt.increase_particles(factor)
    assert bigger.n_particles == 16 * factor and filt.n_particles == 16
    state = bigger.initialize(torch.Generator().manual_seed(0))
    assert state.x.value.shape == (16 * factor, 3) and state.prev_indices.shape == (16 * factor, 3)
    assert (state.prev_indices[:, 2] == torch.arange(16 * factor, dtype=torch.int32)).all()
