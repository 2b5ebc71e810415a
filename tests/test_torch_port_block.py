"""The port's block particle filter, held against the JAX package's
``pyfilter_tpu/filters/block.py``.

Its randomness is matched by replaying the JAX run's draws: the JAX pass
runs jitted with ``jax.random.normal`` and ``jax.random.uniform`` wrapped to
record every draw they make through an ordered ``jax.debug.callback``
(:class:`KeyTape`): the initial cloud, then per step the propagation's
normals and the default resampler's uniforms, one per (lane, block). The
port takes the normals through ``Normal.sample`` and the uniforms through
``BlockParticleFilter.resample_uniform``, into its default route (the lane
kernel's plain version on the CPU). The JAX package's copy counts come from
a float32 cumulative sum and the port's from the exact fixed-point one; at
N = 128 no boundary ties in these seeds, so the ancestors are equal and the
log-likelihood, the moments and ``aux`` agree within rel 1e-5 / abs 1e-5.
Then ``tests/test_block.py``'s properties on the port itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu_torch as pt
from pyfilter_tpu import distributions as jdist, timeseries as jts
from pyfilter_tpu.filters import BlockParticleFilter as JBlock
from pyfilter_tpu.ops import systematic_counts as j_systematic_counts
from pyfilter_tpu_torch.filters.block import BlockParticleFilter as TBlock

from kalman import KalmanFilter as NumpyKalman

torch.set_num_threads(1)

SIGMA, OBS_STD = 0.35, 0.3
N = 128


class KeyTape:
    """Every ``jax.random.normal`` / ``uniform`` draw of a jitted JAX run,
    recorded in program order (an ordered ``jax.debug.callback`` beside each
    draw), then handed to the port's seams in that order. Shared with
    ``test_torch_port_variance_twisted.py``."""

    def __init__(self):
        self.normals, self.uniforms = [], []

    def record(self, monkeypatch, run):
        """``jax.jit(run)()``, recording its draws."""
        normal, uniform = jax.random.normal, jax.random.uniform

        def recorded(fn, tape):
            def draw(key, shape=(), dtype=jnp.float32, *args):
                z = fn(key, shape, dtype, *args)
                jax.debug.callback(lambda v: tape.append(np.array(v)), z, ordered=True)
                return z
            return draw

        with monkeypatch.context() as m:
            m.setattr(jax.random, "normal", recorded(normal, self.normals))
            m.setattr(jax.random, "uniform", recorded(uniform, self.uniforms))
            out = jax.jit(run)()
            jax.block_until_ready(out)
        return out

    def replay_normals(self, monkeypatch):
        """``Normal.sample`` of the port takes the recorded normals (shapes checked)."""
        draws = iter(self.normals)

        def sample(dist, generator, sample_shape=()):
            z = next(draws)
            assert z.shape == tuple(sample_shape) + tuple(dist.batch_shape), z.shape
            return dist.loc + dist.scale * torch.from_numpy(z)

        monkeypatch.setattr(pt.distributions.Normal, "sample", sample)
        return draws


def ring_models(d, mix=0.2, decay=0.9):
    """``tests/test_block.py``'s locally coupled linear ring in both
    packages (``mix=0`` makes the dimensions independent)."""
    def jmean(x, decay_, mix_, q_):
        v = x.value
        return decay_ * ((1.0 - mix_) * v + mix_ * 0.5 * (jnp.roll(v, 1, axis=-1) + jnp.roll(v, -1, axis=-1))), q_

    def tmean(x, decay_, mix_, q_):
        v = x.value
        return decay_ * ((1.0 - mix_) * v + mix_ * 0.5 * (torch.roll(v, 1, dims=-1) + torch.roll(v, -1, dims=-1))), q_

    jh = jts.AffineProcess(jmean, (jnp.asarray(decay), jnp.asarray(mix), jnp.asarray(SIGMA)),
                           jdist.Normal(jnp.zeros(d), jnp.ones(d)).to_event(1),
                           lambda *_: jdist.Normal(jnp.zeros(d), jnp.ones(d)).to_event(1))
    td = pt.distributions
    th = pt.timeseries.AffineProcess(tmean, (torch.tensor(decay), torch.tensor(mix), torch.tensor(SIGMA)),
                                     td.Normal(torch.zeros(d), torch.ones(d)).to_event(1),
                                     lambda *_: td.Normal(torch.zeros(d), torch.ones(d)).to_event(1))
    return (jts.LinearStateSpaceModel(jh, (1.0, OBS_STD), event_shape=(d,)),
            pt.timeseries.LinearStateSpaceModel(th, (1.0, OBS_STD), event_shape=(d,)))


def ring_data(d, t_steps, seed, mix=0.2, decay=0.9):
    """A path of the ring and its observations, simulated in numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=d)
    xs, ys = [], []
    for _ in range(t_steps):
        x = decay * ((1 - mix) * x + mix * 0.5 * (np.roll(x, 1) + np.roll(x, -1))) + SIGMA * rng.normal(size=d)
        xs.append(x)
        ys.append(x + OBS_STD * rng.normal(size=d))
    return np.asarray(xs, np.float32), np.asarray(ys, np.float32)


def _close(tres, jres):
    np.testing.assert_allclose(tres.log_likelihood.numpy(), np.asarray(jres.log_likelihood), rtol=1e-5)
    for name in ("step_log_likelihoods", "filter_means", "filter_variances", "aux"):
        np.testing.assert_allclose(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("blocks,lanes", [({"block_size": 2}, ()), ({"blocks": ((0, 3), (1, 4), (2, 5))}, ()),
                                          ({"block_size": 3}, (3,))], ids=["contiguous", "permuted", "lanes"])
def test_block_filter_matches_jax_on_replayed_draws(monkeypatch, blocks, lanes):
    """Contiguous and permuted blocks, and three lanes, over a partly
    missing row (two components) and an all-NaN row: the default route
    (the lane kernel's plain version) on the JAX run's draws."""
    d, t_steps = 6, 12
    jssm, tssm = ring_models(d)
    _, y = ring_data(d, t_steps, seed=1)
    y[3, :2] = np.nan
    y[7] = np.nan
    tape = KeyTape()
    jres = tape.record(monkeypatch, lambda: JBlock(jssm, N, batch_shape=lanes, **blocks).batch_filter(
        jax.random.PRNGKey(0), jnp.asarray(y)))
    draws = tape.replay_normals(monkeypatch)
    filt = TBlock(tssm, N, batch_shape=lanes, device="cpu", **blocks)
    uniforms = iter(tape.uniforms)
    filt.resample_uniform = lambda generator: torch.from_numpy(next(uniforms))
    tres = filt.batch_filter(None, y)
    assert next(draws, None) is None and next(uniforms, None) is None
    _close(tres, jres)
    np.testing.assert_allclose(float(tres.step_log_likelihoods[7].sum()), 0.0, atol=1e-6)
    np.testing.assert_allclose(tres.aux[7].numpy(), 1.0, atol=1e-5)  # no observed block: no resample


def test_block_filter_with_a_resampler_passed_in(monkeypatch):
    """A callable resampler takes its own route (its indices, a gather, the
    unobserved blocks' identity): fed the JAX run's own indices, the pass is
    the JAX package's. A resampler by name runs too."""
    d, t_steps = 4, 8
    jssm, tssm = ring_models(d, mix=0.0)
    _, y = ring_data(d, t_steps, seed=8, mix=0.0)
    y[2, 2:] = np.nan
    uniforms = np.random.default_rng(3)
    indices = []

    def j_resampler(key, w, normalized=False):
        idx = j_systematic_counts(None, w, normalized=normalized, u=jnp.asarray(uniforms.uniform(size=w.shape[1:]),
                                                                                  jnp.float32))
        jax.debug.callback(lambda v: indices.append(np.array(v)), idx, ordered=True)
        return idx

    tape = KeyTape()
    jres = tape.record(monkeypatch, lambda: JBlock(jssm, N, block_size=2, resampling_method=j_resampler).batch_filter(
        jax.random.PRNGKey(4), jnp.asarray(y)))
    tape.replay_normals(monkeypatch)
    fed = iter(indices)
    tres = TBlock(tssm, N, block_size=2, resampling_method=lambda g, w, normalized=False: torch.from_numpy(next(fed)),
                  device="cpu").batch_filter(None, y)
    _close(tres, jres)
    monkeypatch.undo()
    res = TBlock(tssm, N, block_size=2, resampling_method="stratified", device="cpu").batch_filter(
        torch.Generator().manual_seed(0), y)
    assert torch.isfinite(res.log_likelihood) and res.aux.shape == (t_steps, 2)


def test_block_filter_steps_from_a_converted_jax_state(monkeypatch):
    """``convert.block_state_from_numpy``: one step from the JAX package's
    initial cloud on its draws gives its cloud, log-likelihood and ESS."""
    d = 4
    jssm, tssm = ring_models(d)
    jf = JBlock(jssm, N, block_size=2)
    y_t = np.array([0.3, -0.2, np.nan, 0.5], np.float32)
    tape = KeyTape()
    js0, js1 = tape.record(monkeypatch, lambda: (lambda s0: (s0, jf.filter(jax.random.PRNGKey(2), jnp.asarray(y_t), s0)))(
        jf.initialize(jax.random.PRNGKey(1))))
    tape.normals.pop(0)  # the initial cloud's, which the conversion carries
    tape.replay_normals(monkeypatch)
    ts0 = pt.convert.block_state_from_numpy(np.asarray(js0.values), np.asarray(js0.time_index),
                                            np.asarray(js0.log_likelihood), np.asarray(js0.block_ess), device="cpu")
    filt = TBlock(tssm, N, block_size=2, device="cpu")
    filt.resample_uniform = lambda generator: torch.from_numpy(tape.uniforms[0])
    ts1 = filt.filter(None, torch.from_numpy(y_t), ts0)
    np.testing.assert_allclose(ts1.values.numpy(), np.asarray(js1.values), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ts1.log_likelihood), float(js1.log_likelihood), rtol=1e-5)
    np.testing.assert_allclose(ts1.block_ess.numpy(), np.asarray(js1.block_ess), rtol=1e-5)


def test_validation_errors():
    """Where the JAX package raises, the port raises."""
    jssm, tssm = ring_models(4, mix=0.0)
    for block, ssm in ((JBlock, jssm), (lambda *a, **k: TBlock(*a, device="cpu", **k), tssm)):
        with pytest.raises(ValueError, match="block_size"):
            block(ssm, 10, block_size=3)
        with pytest.raises(ValueError, match="exactly one"):
            block(ssm, 10)
        with pytest.raises(ValueError, match="partition"):
            block(ssm, 10, blocks=((0, 1), (1, 2)))
        with pytest.raises(ValueError, match="equal sizes"):
            block(ssm, 10, blocks=((0, 1, 2), (3,)))
    scalar = pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.AR(0.1, 0.5, 0.3, device="cpu"), (1.0, 0.2))
    with pytest.raises(ValueError, match="vector state"):
        TBlock(scalar, 10, block_size=1, device="cpu")
    with pytest.raises(ValueError, match="vector observations"):
        TBlock(tssm, 10, block_size=2, device="cpu").batch_filter(torch.Generator(), np.zeros(5, np.float32))


# -- tests/test_block.py's properties on the port -----------------------------------------------


def test_block_size_one_matches_factorized_kalman():
    """Independent chains: the block filter at ``block_size=1`` is a bank of
    bootstrap filters, so it matches the per-dimension float64 Kalman
    filters (log-likelihood rel 0.01, median relative mean error 0.1)."""
    d, t_steps = 6, 40
    _, tssm = ring_models(d, mix=0.0)
    _, y = ring_data(d, t_steps, seed=3, mix=0.0)
    res = TBlock(tssm, 3000, block_size=1, device="cpu").batch_filter(torch.Generator().manual_seed(1), y)
    ll_sum, means = 0.0, []
    for k in range(d):
        kf = NumpyKalman([[0.9]], [[1.0]], [[SIGMA**2]], [[OBS_STD**2]], initial_state_mean=[0.0],
                         initial_state_covariance=[[1.0]])
        fm, _, ll_k = kf.filter(y[:, k])
        ll_sum += ll_k
        means.append(fm[:, 0])
    means = np.stack(means, axis=-1)
    assert abs(float(res.log_likelihood) - ll_sum) / abs(ll_sum) < 0.01
    assert np.median(np.abs(res.filter_means.numpy() - means) / (np.abs(means) + 1e-2)) < 0.1
    assert res.aux.shape == (t_steps, d) and (res.aux > 0).all() and (res.aux <= 1.0 + 1e-6).all()


def test_block_filter_beats_global_bootstrap_in_high_dim():
    """d = 32, N = 256: the block filter's RMSE is under 0.75 of the global
    SISR's and under twice the observation sd, its mean block ESS above 0.3."""
    d, t_steps = 32, 30
    _, tssm = ring_models(d)
    x, y = ring_data(d, t_steps, seed=11)
    res_b = TBlock(tssm, 256, block_size=2, device="cpu").batch_filter(torch.Generator().manual_seed(2), y)
    res_s = pt.SISR(tssm, 256, device="cpu").batch_filter(torch.Generator().manual_seed(2), y)
    rmse_b = float(np.sqrt(np.mean((res_b.filter_means.numpy() - x) ** 2)))
    rmse_s = float(np.sqrt(np.mean((res_s.filter_means.numpy() - x) ** 2)))
    assert rmse_b < 0.75 * rmse_s, (rmse_b, rmse_s)
    assert rmse_b < 2.0 * OBS_STD
    assert float(res_b.aux.mean()) > 0.3
