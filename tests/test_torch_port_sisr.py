"""The port's bootstrap SISR on the stochastic-volatility model, end to end,
held against the JAX package.

Both filters are stepped by hand through their own ``filter`` moves on the
same numpy noise: a test-local replay proposal (the bootstrap law, its
standard-normal draws injected) and a replaying increment distribution that
feeds the batched sub-step draw. The resampling uniforms are injected too:
the JAX filter gets a replay resampler (``systematic_counts`` with the
uniform given), and the port's filter keeps its default resampler, so it
runs its fused branch (``systematic_expand`` on the counts, then the weight
reset), with the uniform replayed through ``ParticleFilter.resample_uniform``.
Both start from one cloud, carried across with ``pyfilter_tpu_torch.convert``.
Nothing in either package changes for this.

Tolerance: rel 1e-5 / abs 5e-5 on the per-step filter means, the ESS and the
total log-likelihood (the BASELINE.md gate; abs 5e-5 because the
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
from pyfilter_tpu import utils as jutils
from pyfilter_tpu.filters.particle.proposals import Proposal as JProposal
from pyfilter_tpu.filters.state import ParticleFilterCorrection as JCorrection
from pyfilter_tpu.ops import systematic_counts as j_counts
from pyfilter_tpu.timeseries import TimeseriesState as JState
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import utils as tutils
from pyfilter_tpu_torch.filters.particle.proposals import Proposal as TProposal

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N, T = 512, 20
PARAMS = dict(kappa=0.5, gamma=1.0, sigma=0.15, mu=0.1, nu=0.2, tau=1.2)


def _simulate(dt, n_obs, seed):
    """Observations from the model itself (numpy, float64 path)."""
    rng = np.random.default_rng(seed)
    p = PARAMS
    vol, ys = p["gamma"], []
    for _ in range(n_obs):
        for _ in range(int(1.0 / dt)):
            vol = vol + p["kappa"] * (p["gamma"] - vol) * vol * dt + p["sigma"] * vol * math.sqrt(dt) * rng.normal()
        z = rng.normal()
        ys.append(p["mu"] + vol * math.sinh((math.asinh(z) + p["nu"]) * p["tau"]))
    return np.asarray(ys, np.float32)


class _Clock:
    t = 0


# -- JAX side ---------------------------------------------------------------
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


# -- port side ---------------------------------------------------------------
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


class _ReplaySISRT(pt.SISR):
    """The port's SISR with its default resampler, whose fused branch draws
    the replayed uniform of the current step."""

    def __init__(self, *args, us, clock, **kwargs):
        super().__init__(*args, **kwargs)
        self.us, self.clock, self.uniform_draws = us, clock, 0

    def resample_uniform(self, generator):
        self.uniform_draws += 1
        return torch.tensor(self.us[self.clock.t])


@pytest.mark.parametrize("dt", [1.0, 0.2])
def test_sisr_slice_matches_jax_with_replayed_noise(dt):
    oes = int(1.0 / dt)
    rng = np.random.default_rng(11)
    y = _simulate(dt, T, seed=12)
    x0 = rng.uniform(0.8, 1.2, N).astype(np.float32)
    z_sub = rng.normal(size=(T, max(oes - 1, 1), N)).astype(np.float32)
    z_prop = rng.normal(size=(T, N)).astype(np.float32)
    us = rng.uniform(size=T).astype(np.float32)
    clock = _Clock()

    jmodel = jexamples.stochastic_volatility_model(**PARAMS, dt=dt)
    inc = jmodel.hidden.increment_distribution
    jmodel.hidden.increment_distribution = _ReplayNormalJ(inc.loc, inc.scale, z_sub, clock)
    jfilt = pf.SISR(
        jmodel, N, proposal=_ReplayProposalJ(z=z_prop, clock=clock),
        resampling_method=lambda key, w, normalized=False: j_counts(
            None, w, normalized=normalized, u=jnp.asarray(us[clock.t])
        ),
    )

    tmodel = pt.convert.sv_model_from_numpy(*PARAMS.values(), dt=dt, device="cpu")
    inc = tmodel.hidden.increment_distribution
    tmodel.hidden.increment_distribution = _ReplayNormalT(inc.loc, inc.scale, z_sub, clock)
    tfilt = _ReplaySISRT(tmodel, N, proposal=_ReplayProposalT(z_prop, clock), device="cpu", us=us, clock=clock)
    assert tfilt._use_fused_resample(torch.zeros(1))

    jstate = JCorrection.from_weighted_particles(
        JState(jnp.asarray(0.0), jnp.asarray(x0)), jnp.zeros(N), jnp.zeros(()), jnp.arange(N, dtype=jnp.int32)
    )
    tstate = pt.convert.correction_from_numpy(
        *(np.asarray(a) for a in (jstate.x.time_index, jstate.x.value, jstate.log_weights,
                                  jstate.log_likelihood, jstate.prev_indices, jstate.mean, jstate.variance)),
        device="cpu",
    )

    out = {"jax": ([], [], []), "port": ([], [], [])}
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    with jax.disable_jit():
        for t in range(T):
            clock.t = t
            jstate = jfilt.filter(key, jnp.asarray(y[t]), jstate, first_step=t == 0)
            tstate = tfilt.filter(gen, y[t], tstate, first_step=t == 0)
            for name, s, ess in (("jax", jstate, jutils.get_ess(jstate.log_weights)),
                                 ("port", tstate, tutils.get_ess(tstate.log_weights))):
                out[name][0].append(float(s.mean))
                out[name][1].append(float(ess))
                out[name][2].append(float(s.log_likelihood))

    (jm, je, jl), (tm, te, tl) = out["jax"], out["port"]
    assert tfilt.n_resamples > 0, "the replay must exercise the resample gate"
    assert tfilt.uniform_draws == tfilt.n_resamples, "every fire must take the fused branch"
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(te, je, rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(sum(tl), sum(jl), rtol=1e-5, atol=5e-5)
    np.testing.assert_array_equal(tstate.prev_indices.numpy(), np.asarray(jstate.prev_indices))


@pytest.mark.parametrize("record_moments", [True, False])
def test_port_batch_filter_on_cpu(record_moments):
    """The port's own ``batch_filter`` with a ``torch.Generator``: finite
    log-likelihood, the all-NaN skip (an exactly-zero increment), moments on
    request, resampling through ``systematic_expand``'s plain version."""
    dt = 0.2
    y = _simulate(dt, 30, seed=13)
    y[7] = np.nan
    model = pt.examples.stochastic_volatility_model(**PARAMS, dt=dt, device="cpu")
    filt = pt.SISR(model, 2048, record_moments=record_moments, device="cpu")
    assert filt._use_fused_resample(torch.zeros(1))
    res = filt.batch_filter(torch.Generator().manual_seed(1), y)

    assert math.isfinite(float(res.log_likelihood))
    assert res.step_log_likelihoods.shape == (30,) and float(res.step_log_likelihoods[7]) == 0.0
    assert filt.n_resamples > 0
    assert res.latest_state.x.time_index == 1 + 29 * 5
    if record_moments:
        assert torch.isfinite(res.filter_means).all() and torch.isfinite(res.filter_variances).all()
        assert abs(float(res.filter_means.mean()) - 1.0) < 0.5
    else:
        assert not res.filter_means.any()

    # the JAX package on the same data, with its own randomness: the two
    # log-likelihood estimates agree within Monte Carlo error (sd ~0.05 at
    # this size)
    jres = pf.SISR(jexamples.stochastic_volatility_model(**PARAMS, dt=dt), 2048).batch_filter(
        jax.random.PRNGKey(0), jnp.asarray(y)
    )
    assert float(jres.step_log_likelihoods[7]) == 0.0
    assert abs(float(jres.log_likelihood) - float(res.log_likelihood)) < 0.5
