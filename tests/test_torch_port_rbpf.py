"""The port's Rao-Blackwellized particle filter, held against the JAX
package's ``pyfilter_tpu/filters/rbpf.py``.

Its randomness is matched by replaying the JAX run's draws: the JAX pass
runs eagerly with ``jax.random.normal`` drawing from a numpy tape (the
initial cloud, then each step's propagation) and a replay resampler that
draws its uniform from numpy and records the ancestor indices the JAX
package's ``systematic_counts`` gives; the port takes the same normals
through ``Normal.sample`` and the same indices through its resampler (fed
only the uniforms, the port's exact copy counts and the JAX package's
float32 cumulative sum could part at a tie). With the draws equal, the
log-likelihood and the moments agree within rel 1e-5 / abs 1e-5. The fused
route (K1's plain version on the CPU) is bit-equal to the gather route, as
``tests/test_rbpf.py:157`` pins for the JAX package. Then that file's checks
on the port: a point-mass nonlinear block is the Kalman filter, the 2-D
Kalman oracle, the Rao-Blackwell variance gain over a joint bootstrap
filter, and the all-NaN skip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import timeseries as jts
from pyfilter_tpu.filters import LinearSubstructure as JLinear
from pyfilter_tpu.ops import systematic_counts as j_systematic_counts
from pyfilter_tpu.timeseries import models as jmodels
from test_torch_port_kalman import close
from test_torch_port_tempered import Tape

torch.set_num_threads(1)

AL, BL, SL = 0.2, 0.7, 0.4  # the linear block's AR(1)
AN, BN, SN = 0.0, 0.9, 0.3  # the nonlinear block's AR(1)
OBS_STD = 0.25
TM = pt.timeseries.models


def j_linear(obs_offset):
    return JLinear(
        trans_matrix=lambda n: jnp.array([[BL]]), trans_offset=lambda n: jnp.array([AL]),
        trans_cov=lambda n: jnp.array([[SL**2]]), obs_matrix=lambda n: jnp.array([[1.0]]), obs_offset=obs_offset,
        obs_cov=lambda n: jnp.array([[OBS_STD**2]]), init_mean=jnp.array([AL]), init_cov=jnp.array([[SL**2]]))


def t_linear(obs_offset):
    return pt.convert.linear_substructure_from_numpy(
        np.array([[BL]]), np.array([AL]), np.array([[SL**2]]), np.array([[1.0]]), obs_offset,
        np.array([[OBS_STD**2]]), np.array([AL]), np.array([[SL**2]]), device="cpu")


def joint_pair(n_particles, **kw):
    """``tests/test_rbpf.py``'s joint model (``y = n + l + v``) as an RBPF in
    both packages."""
    jr = pf.RaoBlackwellizedPF(jmodels.AR(AN, BN, SN), j_linear(lambda n: jnp.atleast_1d(n.value)), n_particles,
                               **kw)
    tr = pt.RaoBlackwellizedPF(TM.AR(AN, BN, SN, device="cpu"), t_linear(lambda n: torch.atleast_1d(n.value)),
                               n_particles, device="cpu", **kw)
    return jr, tr


def joint_data(n, seed):
    """Observations of the joint model, simulated in numpy."""
    rng = np.random.default_rng(seed)
    nn, ll = rng.normal(AN, SN), rng.normal(AL, SL)
    y = np.empty(n, np.float32)
    for t in range(n):
        nn = AN + BN * nn + SN * rng.normal()
        ll = AL + BL * ll + SL * rng.normal()
        y[t] = nn + ll + OBS_STD * rng.normal()
    return y


def exact_2d_loglik(y):
    """``tests/test_rbpf.py``'s float64 2-D Kalman oracle."""
    a_mat, b_vec = np.array([[BN, 0.0], [0.0, BL]]), np.array([AN, AL])
    q, h, r = np.diag([SN**2, SL**2]), np.array([[1.0, 1.0]]), np.array([[OBS_STD**2]])
    m, p, ll = b_vec.copy(), q.copy(), 0.0
    for y_t in np.asarray(y, np.float64):
        m, p = a_mat @ m + b_vec, a_mat @ p @ a_mat.T + q
        s = h @ p @ h.T + r
        innov = np.atleast_1d(y_t) - h @ m
        ll += float(-0.5 * (innov @ np.linalg.solve(s, innov) + np.log(np.linalg.det(s)) + np.log(2 * np.pi)))
        k = p @ h.T @ np.linalg.inv(s)
        m, p = m + k @ innov, p - k @ h @ p
    return ll


@pytest.mark.parametrize("ess_threshold", [0.9, 1.1], ids=["gated", "every-step"])
def test_matches_jax_on_replayed_draws(monkeypatch, ess_threshold):
    y = joint_data(15, 1)
    y[6] = np.nan
    uniforms = np.random.default_rng(9)
    indices = []

    def j_resampler(key, w, normalized=False):
        idx = j_systematic_counts(None, w, normalized=normalized, u=jnp.asarray(uniforms.uniform(), jnp.float32))
        indices.append(np.asarray(idx))
        return idx

    jr, _ = joint_pair(64, ess_threshold=ess_threshold, resampling_method=j_resampler, fused_resample=False)
    tape = Tape(2)
    jres = tape.record(monkeypatch, lambda: jr.batch_filter(jax.random.PRNGKey(0), jnp.asarray(y)))
    assert indices, "the JAX run never resampled"

    draws, fed = iter(tape.normals), iter(indices)

    def normal(shape):
        z = next(draws)
        assert z.shape == tuple(shape), (z.shape, tuple(shape))
        return torch.from_numpy(z)

    monkeypatch.setattr(pt.distributions.Normal, "sample", lambda self, generator, sample_shape=(): (
        self.loc + self.scale * normal(tuple(sample_shape) + tuple(self.batch_shape))))
    _, tr = joint_pair(64, ess_threshold=ess_threshold, fused_resample=False,
                       resampling_method=lambda g, w, normalized=False: torch.from_numpy(next(fed).copy()))
    tres = tr.batch_filter(None, y)
    assert next(draws, None) is None and next(fed, None) is None
    assert tr.n_resamples == len(indices)
    for name in ("log_likelihood", "step_log_likelihoods", "filter_means", "filter_variances"):
        close(getattr(tres, name), getattr(jres, name))
    close(tres.latest_state.m, jres.latest_state.m)
    close(tres.latest_state.p, jres.latest_state.p)
    assert float(tres.step_log_likelihoods[6]) == 0.0


def test_fused_route_is_bit_equal_to_the_gather_route():
    """``tests/test_rbpf.py:157``: a fire every step, the same generator; the
    fused route (value, mean and covariance as 3 planes through K1, its plain
    version here) and the gather route give the same bits."""
    y = joint_data(30, 9)
    out = []
    for fused in (False, True):
        _, tr = joint_pair(256, ess_threshold=1.1, fused_resample=fused)
        assert tr._use_fused_resample(torch.zeros(1)) == fused
        out.append(tr.batch_filter(torch.Generator().manual_seed(10), y))
        assert tr.n_resamples == len(y)
    for name in ("log_likelihood", "filter_means", "filter_variances"):
        assert torch.equal(getattr(out[0], name), getattr(out[1], name)), name
    assert torch.equal(out[0].latest_state.p, out[1].latest_state.p)
    # the default rule takes the fused route for the systematic resampler
    assert joint_pair(16)[1]._use_fused_resample(torch.zeros(1))
    assert not pt.RaoBlackwellizedPF(TM.AR(AN, BN, SN, device="cpu"), t_linear(np.array([0.0])), 16,
                                     resampling_method=pt.resampling.multinomial,
                                     device="cpu")._use_fused_resample(torch.zeros(1))


def test_degenerate_nonlinear_block_is_the_kalman_filter():
    """``tests/test_rbpf.py:29``: a point-mass nonlinear block makes the RBPF
    the Kalman filter, with no Monte-Carlo error."""
    dist = pt.distributions
    frozen = pt.timeseries.AffineProcess(lambda x, s: (x.value, s), (torch.tensor(0.0),), dist.Delta(0.0),
                                         lambda s: dist.Delta(0.0))
    rbpf = pt.RaoBlackwellizedPF(frozen, t_linear(np.array([0.0])), 16, device="cpu")
    ssm = pt.timeseries.LinearStateSpaceModel(TM.AR(AL, BL, SL, device="cpu"), (1.0, OBS_STD))
    y = joint_data(50, 0)
    exact = pt.KalmanFilter(ssm, device="cpu").batch_filter(y)
    res = rbpf.batch_filter(torch.Generator().manual_seed(1), y)
    close(res.log_likelihood, exact.log_likelihood)
    close(res.filter_means[:, 1], exact.filter_means[:, 0], rtol=1e-4)
    close(res.filter_variances[:, 1], exact.filter_variances[:, 0], rtol=1e-4, atol=1e-6)


def test_matches_the_2d_kalman_oracle():
    """``tests/test_rbpf.py:84``'s rule: 8 seeds' mean within 4 SE + 0.3."""
    y = joint_data(60, 2)
    exact = exact_2d_loglik(y)
    _, tr = joint_pair(200)
    lls = np.asarray([float(tr.batch_filter(torch.Generator().manual_seed(10 + i), y).log_likelihood)
                      for i in range(8)])
    assert abs(lls.mean() - exact) < 4 * lls.std(ddof=1) / np.sqrt(len(lls)) + 0.3, (lls.mean(), exact)


def test_rao_blackwell_variance_gain():
    """``tests/test_rbpf.py:98``: at equal N the RBPF's log-likelihood is
    tighter than the joint bootstrap filter's."""
    y = joint_data(60, 3)
    dist = pt.distributions
    a_mat, b_vec, s_vec = torch.tensor([[BN, 0.0], [0.0, BL]]), torch.tensor([AN, AL]), torch.tensor([SN, SL])
    joint = pt.timeseries.LinearModel((a_mat, b_vec, s_vec), dist.Normal(torch.zeros(2), torch.ones(2)).to_event(1),
                                      lambda a, b, s: dist.Normal(b, s).to_event(1), event_ndim=1)
    ssm = pt.timeseries.StateSpaceModel(joint, lambda x, o: dist.Normal(x.value[..., 0] + x.value[..., 1], o),
                                        (torch.tensor(OBS_STD),))
    _, tr = joint_pair(200)
    sisr = pt.SISR(ssm, 200, device="cpu")
    rb = [float(tr.batch_filter(torch.Generator().manual_seed(100 + i), y).log_likelihood) for i in range(12)]
    bs = [float(sisr.batch_filter(torch.Generator().manual_seed(100 + i), y).log_likelihood) for i in range(12)]
    assert np.std(rb, ddof=1) < np.std(bs, ddof=1), (np.std(rb, ddof=1), np.std(bs, ddof=1))


def test_nan_skip():
    y = joint_data(40, 4)
    y[10:14] = np.nan
    res = joint_pair(200)[1].batch_filter(torch.Generator().manual_seed(5), y)
    assert np.isfinite(float(res.log_likelihood))
    assert float(res.step_log_likelihoods[10:14].abs().sum()) == 0.0
    assert torch.isfinite(res.filter_means).all()


def test_device_rules():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.RaoBlackwellizedPF(TM.AR(AN, BN, SN, device="cpu"), t_linear(np.array([0.0])), 16)
    with pytest.raises(ValueError, match="lies on"):
        pt.RaoBlackwellizedPF(TM.AR(AN, BN, SN, device="cpu"), t_linear(np.array([0.0])), 16, device="meta")
