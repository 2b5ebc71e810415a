"""The port's Gaussian marginal-likelihood adapter, held against the JAX
package's ``pyfilter_tpu/filters/marginal.py``, and the batch algorithms on
it.

Each kind's lane log-likelihoods (``ekf``, ``ukf``, ``ckf``, ``gsf`` and
``imm``; one parameter value per lane, the JAX context's values carried
across with ``convert.set_context_values``) equal the JAX package's lane
pass and a per-lane loop of single filters within rel 1e-5 / abs 1e-5
(``BASELINE.md``); the lanes' states survive PMMH's lane surgery. Then the
two ``TemperedSMC`` tests on the adapter (``tests/test_tempered.py:49,77``)
and ``tests/test_marginal_filter.py``'s IMM ranking on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import inference as jinf
from pyfilter_tpu import timeseries as jts
from test_torch_port_kalman import close

torch.set_num_threads(1)

TM, TD = pt.timeseries.models, pt.distributions
TRUE_BETA, TRUE_SIGMA, OBS = 0.7, 0.3, 0.2


def j_build(ctx):
    beta = ctx.named_parameter("beta", jdist.Uniform(0.0, 1.0))
    sigma = ctx.named_parameter("sigma", jdist.LogNormal(-1.0, 0.5))
    return jts.LinearStateSpaceModel(jts.models.AR(0.0, beta, sigma), (1.0, OBS))


def t_build(ctx):
    const = lambda v: TM.parameter(v, ctx.device)  # noqa: E731
    beta = ctx.named_parameter("beta", TD.Uniform(const(0.0), const(1.0)))
    sigma = ctx.named_parameter("sigma", TD.LogNormal(const(-1.0), const(0.5)))
    return pt.timeseries.LinearStateSpaceModel(TM.AR(0.0, beta, sigma, device=ctx.device), (1.0, OBS))


def j_switching(ctx):
    """``tests/test_marginal_filter.py``'s builder: the (2, 2) matrix from a
    stay probability, lane-leading."""
    p = jnp.asarray(ctx.named_parameter("p_stay", jdist.Uniform(0.5, 0.999)))[..., None, None]
    eye = jnp.eye(2)
    low = jts.LinearStateSpaceModel(jts.models.AR(0.0, 0.9, 0.1), (1.0, 0.1))
    high = jts.LinearStateSpaceModel(jts.models.AR(0.0, 0.9, 1.0), (1.0, 0.1))
    return pf.MarkovSwitchingModel((low, high), p * eye + (1.0 - p) * (1.0 - eye))


def t_switching(ctx):
    const = lambda v: TM.parameter(v, ctx.device)  # noqa: E731
    p = ctx.named_parameter("p_stay", TD.Uniform(const(0.5), const(0.999)))[..., None, None]
    eye = torch.eye(2, device=ctx.device)
    regimes = tuple(pt.timeseries.LinearStateSpaceModel(TM.AR(0.0, 0.9, s, device=ctx.device), (1.0, 0.1))
                    for s in (0.1, 1.0))
    return pt.MarkovSwitchingModel(regimes, p * eye + (1.0 - p) * (1.0 - eye))


def ar_y(n, seed, beta=TRUE_BETA, sigma=TRUE_SIGMA):
    rng = np.random.default_rng(seed)
    x, y = rng.normal(0.0, sigma), np.empty(n, np.float32)
    for t in range(n):
        x = beta * x + sigma * rng.normal()
        y[t] = x + OBS * rng.normal()
    return y


def switching_y(seed, t_obs=120, block=30):
    rng = np.random.default_rng(seed)
    regime = (np.arange(t_obs) // block) % 2
    x, prev = np.zeros(t_obs, np.float32), 0.0
    for t in range(t_obs):
        prev = 0.9 * prev + (0.1, 1.0)[regime[t]] * rng.normal()
        x[t] = prev
    return x + 0.1 * rng.normal(size=t_obs).astype(np.float32)


def lane_pair(j_builder, t_builder, kind, lanes, seed, **kw):
    """The adapter of ``kind`` over ``lanes`` lanes in both packages, at the
    JAX context's prior draws (carried into the port's context)."""
    ctx = jinf.make_context(key=jax.random.PRNGKey(seed))
    ctx.set_batch_shape((lanes,))
    jf = pf.GaussianMarginalFilter(j_builder, kind=kind, **kw).set_batch_shape((lanes,)).initialize_model(ctx)
    tctx = pt.inference.make_context(device="cpu")
    tctx.set_batch_shape((lanes,))
    t_builder(tctx)
    pt.convert.set_context_values(tctx, {k: np.asarray(v) for k, v in ctx.parameters.items()})
    tf = pt.GaussianMarginalFilter(t_builder, kind=kind, device="cpu", **kw).set_batch_shape(
        (lanes,)).initialize_model(tctx)
    return jf, tf, {k: np.asarray(v) for k, v in ctx.parameters.items()}


@pytest.mark.parametrize("kind,kw", [("ekf", {}), ("ukf", {}), ("ckf", {}),
                                     ("gsf", {"n_components": 3, "spread": 0.5}), ("ekf", {"iterations": 2})],
                         ids=["ekf", "ukf", "ckf", "gsf", "iekf"])
def test_lane_log_likelihoods_match_jax(kind, kw):
    y = ar_y(40, 1)
    y[9] = np.nan
    jf, tf, _ = lane_pair(j_build, t_build, kind, 5, 2, **kw)
    jres, tres = jf.batch_filter(jax.random.PRNGKey(3), jnp.asarray(y)), tf.batch_filter(None, y)
    assert tuple(tres.log_likelihood.shape) == (5,) and tuple(tres.filter_means.shape) == (40, 5, 1)
    for name in ("log_likelihood", "step_log_likelihoods", "filter_means", "filter_variances"):
        close(getattr(tres, name), getattr(jres, name))
    for a, b in zip(tres.latest_state, jres.latest_state):
        if isinstance(a, torch.Tensor):
            close(a, b)


def test_imm_lane_log_likelihoods_match_jax():
    y = switching_y(4)
    jf, tf, _ = lane_pair(j_switching, t_switching, "imm", 6, 5)
    jres, tres = jf.batch_filter(jax.random.PRNGKey(6), jnp.asarray(y)), tf.batch_filter(None, y)
    for name in ("log_likelihood", "step_log_likelihoods", "filter_means", "filter_variances"):
        close(getattr(tres, name), getattr(jres, name))
    close(torch.exp(tres.aux), np.exp(np.asarray(jres.aux)))
    assert tuple(tres.aux.shape) == (120, 6, 2)


def test_lane_log_likelihoods_match_a_per_lane_loop():
    """``tests/test_tempered.py:77``: the vmapped lane likelihoods equal a
    per-lane EKF loop, in the port and in the JAX package."""
    y = ar_y(60, 7)
    _, tf, values = lane_pair(j_build, t_build, "ekf", 5, 8)
    res = tf.batch_filter(None, y)
    for i in range(5):
        beta, sigma = float(values["beta"][i]), float(values["sigma"][i])
        tm = pt.timeseries.LinearStateSpaceModel(TM.AR(0.0, beta, sigma, device="cpu"), (1.0, OBS))
        close(res.log_likelihood[i], pt.ExtendedKalmanFilter(tm, device="cpu").batch_filter(y).log_likelihood)
        jm = jts.LinearStateSpaceModel(jts.models.AR(0.0, beta, sigma), (1.0, OBS))
        close(res.log_likelihood[i], pf.ExtendedKalmanFilter(jm).batch_filter(jnp.asarray(y)).log_likelihood)


def test_lane_surgery_on_the_adapters_states():
    """``tests/test_marginal_filter.py:150``'s exchange after a resample, on
    the GSF lanes, and the result's own ``exchange``/``resample``."""
    y = ar_y(30, 9)
    _, tf, _ = lane_pair(j_build, t_build, "gsf", 6, 10, n_components=3, spread=0.5)
    res = tf.batch_filter(None, y)
    last = res.latest_state
    perm = torch.tensor([1, 0, 3, 2, 5, 4])
    mask = torch.tensor([True, False] * 3)
    swapped = last.exchange(last.resample(perm), mask)
    assert swapped.means.shape == last.means.shape
    close(swapped.means[0], last.means[1])
    close(swapped.means[1], last.means[1])
    mixed = res.exchange(res.resample(perm), mask)
    close(mixed.log_likelihood[0], res.log_likelihood[1])
    close(mixed.filter_means[:, 2], res.filter_means[:, 3])
    both = pt.filters.GSFState.lane_concat([last, last])
    assert both.means.shape[0] == 12 and both.time_index == last.time_index


def test_builder_checks():
    ctx = pt.inference.make_context(device="cpu")
    ctx.set_batch_shape((3,))
    with pytest.raises(TypeError, match="MarkovSwitchingModel"):
        pt.GaussianMarginalFilter(t_build, kind="imm", device="cpu").set_batch_shape((3,)).initialize_model(ctx)
    with pytest.raises(ValueError):
        pt.GaussianMarginalFilter(t_build, kind="kalman", device="cpu")
    with pytest.raises(ValueError):
        pt.GaussianMarginalFilter(t_build, device="cpu").set_batch_shape((2, 3))
    with pytest.raises(ValueError, match="initialize_model"):
        pt.GaussianMarginalFilter(t_build, device="cpu").batch_filter(None, ar_y(5, 0))


def test_graph_cache_follows_the_builder_and_static_values():
    """The card's captured passes are shared by copies with the same builder
    only, and their key tells apart models that differ in a static number or
    function (``structure(values=True)``), not only in their classes."""
    import math
    import types

    from pyfilter_tpu_torch.filters._lane import structure

    f = pt.GaussianMarginalFilter(t_build, device="cpu")
    f._graphs["key"] = "seen"
    assert f.replace(batch_shape=(2,))._graphs is f._graphs
    assert f.replace(model_builder=lambda c: t_build(c))._graphs == {}
    make = lambda scale, fn: types.SimpleNamespace(scale=scale, fn=fn, loc=torch.zeros(2))  # noqa: E731
    a, b, c = make(0.2, math.sin), make(0.3, math.sin), make(0.2, math.cos)
    assert structure(a) == structure(b) == structure(c)
    assert len({structure(m, values=True) for m in (a, b, c)}) == 3
    assert structure(a, values=True) == structure(make(0.2, math.sin), values=True)


def test_imm_adapter_takes_a_fixed_matrix_as_a_leaf():
    """A builder's fixed transition matrix (a list) becomes a float32 tensor
    leaf of the model on the filter's device, and the pass equals the IMM
    filter's own on each lane."""
    def build(ctx):
        const = lambda v: TM.parameter(v, ctx.device)  # noqa: E731
        low = ctx.named_parameter("low", TD.LogNormal(const(-2.3), const(0.3)))
        regimes = tuple(pt.timeseries.LinearStateSpaceModel(TM.AR(0.0, 0.9, s, device=ctx.device), (1.0, 0.1))
                        for s in (low, 1.0))
        return pt.MarkovSwitchingModel(regimes, [[0.95, 0.05], [0.05, 0.95]])

    ctx = pt.inference.make_context(generator=torch.Generator().manual_seed(0), device="cpu")
    ctx.set_batch_shape((3,))
    build(ctx)
    f = pt.GaussianMarginalFilter(build, kind="imm", device="cpu").set_batch_shape((3,)).initialize_model(ctx)
    assert f.model.transition_matrix.dtype == torch.float32 and f.model.transition_matrix.shape == (2, 2)
    y = switching_y(4, t_obs=40)
    res = f.batch_filter(None, y)
    for k in range(3):
        regimes = tuple(pt.timeseries.LinearStateSpaceModel(TM.AR(0.0, 0.9, s, device="cpu"), (1.0, 0.1))
                        for s in (ctx.parameters["low"][k], 1.0))
        one = pt.InteractingMultipleModel(regimes, [[0.95, 0.05], [0.05, 0.95]], device="cpu").batch_filter(y)
        close(res.log_likelihood[k], one.log_likelihood)
        close(torch.exp(res.aux[:, k]), torch.exp(one.aux))  # regime probabilities, as the IMM tests compare them


def test_imm_likelihood_ranks_sticky_above_switching():
    """``tests/test_marginal_filter.py:119``'s last check: the IMM marginal
    likelihood prefers the sticky transition matrix on block-switching data."""
    y = switching_y(0, t_obs=300, block=50)
    ctx = pt.inference.make_context(device="cpu")
    ctx.set_batch_shape((2,))
    t_switching(ctx)
    ctx.update_parameter("p_stay", torch.tensor([0.6, 0.97]))
    f = pt.GaussianMarginalFilter(t_switching, kind="imm", device="cpu").set_batch_shape((2,)).initialize_model(ctx)
    lls = f.batch_filter(None, y).log_likelihood
    assert float(lls[1]) > float(lls[0])


def test_tempered_smc_exact_likelihood_via_ekf_adapter():
    """``tests/test_tempered.py:49`` on the port: TemperedSMC on the EXACT
    (EKF = Kalman on a linear model) likelihood agrees with the particle run,
    with a healthier final acceptance and a close evidence."""
    y = ar_y(200, 0)

    def fit(filt, seed):
        ctx = pt.inference.make_context(generator=torch.Generator().manual_seed(seed), device="cpu")
        return pt.inference.TemperedSMC(filt, 400, context=ctx, generator=torch.Generator().manual_seed(seed + 1),
                                        device="cpu").fit(y)

    exact = fit(pt.GaussianMarginalFilter(t_build, kind="ekf", device="cpu"), 1)
    noisy = fit(pt.SISR(t_build, 150, device="cpu"), 1)
    assert exact.lambdas[-1] == 1.0
    for name, true in (("beta", TRUE_BETA), ("sigma", TRUE_SIGMA)):
        s, s_noisy = np.asarray(exact.samples[name]), np.asarray(noisy.samples[name])
        assert abs(s.mean() - true) / s.std() < 3.5, (name, s.mean(), s.std())
        assert abs(s.mean() - s_noisy.mean()) < max(s.std(), s_noisy.std())
    assert abs(exact.log_evidence - noisy.log_evidence) < 3.0
    assert exact.acceptance_rates[-1] > noisy.acceptance_rates[-1]


def test_imm_marginal_pmmh_moves_toward_sticky():
    """A short PMMH on the IMM adapter (the port's ``_seed_chains``, the
    re-filters and ``exchange`` of the IMM lanes): finite chains that move,
    pulled above the prior mean 0.75 by block-switching data."""
    y = switching_y(1, t_obs=80, block=20)
    ctx = pt.inference.make_context(generator=torch.Generator().manual_seed(3), device="cpu")
    alg = pt.inference.PMMH(pt.GaussianMarginalFilter(t_switching, kind="imm", device="cpu"), 10, num_chains=3,
                            proposal=pt.inference.RandomWalk(0.15), initializer="seed", num_seeds=8, context=ctx,
                            generator=torch.Generator().manual_seed(4), device="cpu")
    chains = alg.fit(y).as_arrays()["p_stay"]
    assert np.isfinite(chains).all() and len(np.unique(chains[3:])) > 3
    assert chains[3:].mean() > 0.85
