"""The port's IF2 (iterated filtering), held against the JAX package.

Two passes of ``IF2(SISR(build, 32), 16)`` over 10 observations replayed draw
for draw (the JAX fit eagerly on a host tape, the port on the same draws:
the prior draws, each pass's jitter and initial cloud, every step's
perturbation normals, the filter's lane uniforms and proposal normals, the
lane resampler's uniform); and ``tests/test_if2.py``'s gates on the port (the
MLE near the truth, the swarm contracted, the likelihood trace improving,
the uncooled swarm wider than the cooled one).

Tolerances: ``theta_trace``, ``swarm`` and the passes' log-likelihoods rel
1e-4 / abs 1e-5 (float32 in two frameworks through 20 model rebuilds and
lane resamples). The model is the batch-inference zoo's AR(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import inference as jinf
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch.inference.batch import if2 as tif2
from test_torch_port_tempered import BETA, SIGMA, Tape, _close, j_build, simulate, t_build

torch.set_num_threads(1)


def test_if2_replays_jax(monkeypatch):
    """Two passes of ``IF2(SISR(build, 32), 16, sigma=0.1, cooling=0.88)``
    over 10 observations: the same pass means, final swarm and pass
    log-likelihoods as the JAX fit on the same draws, every draw taken."""
    k, n, y = 16, 32, simulate(10, seed=8)
    kwargs = dict(num_iterations=2, sigma=0.1, cooling=0.88)
    # tape seed 9 would put one copy-count tie in pass 2 (lane 14 of the 12th
    # filter step: the same probabilities and uniform give counts one apart
    # in the two packages, the JAX package's float cumulative sum against
    # the port's exact fixed-point one), and the fits then part; seed 10 has
    # no tie
    tape = Tape(10)
    jctx = jinf.make_context(key=jax.random.PRNGKey(10))
    jres = tape.record(monkeypatch, lambda: jinf.IF2(pf.SISR(j_build, n), k, context=jctx, key=jax.random.PRNGKey(11),
                                                     **kwargs).fit(jnp.asarray(y), logging=jinf.logging.DefaultLogger()))

    normals, uniforms, lane_resampler = tape.replay(monkeypatch, normal_seams=[(tif2, "_standard_normal")])
    tctx = tinf.make_context(device="cpu")
    tres = tinf.IF2(pt.SISR(t_build, n, device="cpu"), k, resampler=lane_resampler, context=tctx, device="cpu",
                    **kwargs).fit(y, logging=tinf.logging.DefaultLogger())
    assert next(normals, None) is None and next(uniforms, None) is None, "the port must take every draw"

    for name in ("beta", "sigma"):
        assert tres.theta_trace[name].shape == (2,) and tres.swarm[name].shape == (k,)
        _close(tres.theta_trace[name], jres.theta_trace[name], rtol=1e-4, atol=1e-5)
        _close(tres.swarm[name], jres.swarm[name], rtol=1e-4, atol=1e-5)
        _close(tres.mle[name], jres.mle[name], rtol=1e-4, atol=1e-5)
        _close(tctx.get_parameter(name), jctx.get_parameter(name), rtol=1e-4, atol=1e-5)
    _close(tres.log_likelihoods, jres.log_likelihoods, rtol=1e-4, atol=1e-5)
    assert len(np.unique(tres.swarm["beta"])) < k, "the lane resample must duplicate some lanes"


def _fit(n_state, k, y, seed, **kwargs):
    ctx = tinf.make_context(generator=torch.Generator().manual_seed(seed), device="cpu")
    alg = tinf.IF2(pt.SISR(t_build, n_state, device="cpu"), k, context=ctx,
                   generator=torch.Generator().manual_seed(seed + 1), device="cpu", **kwargs)
    return alg.fit(y, logging=tinf.logging.DefaultLogger()), ctx


def test_if2_recovers_mle_and_contracts():
    """``tests/test_if2.py:23``: the MLE within 0.12 / 0.08 of the truth, the
    result's shapes, the swarm sd under 0.1, the last three passes'
    log-likelihoods above the first three, the context holding the swarm."""
    y = simulate(300, seed=0)
    res, ctx = _fit(100, 200, y, seed=1, num_iterations=20, sigma=0.1, cooling=0.88)
    assert abs(res.mle["beta"] - BETA) < 0.12, res.mle
    assert abs(res.mle["sigma"] - SIGMA) < 0.08, res.mle
    assert res.theta_trace["beta"].shape == (20,)
    assert res.swarm["beta"].shape == (200,)
    assert res.log_likelihoods.shape == (20,)
    assert res.swarm["beta"].std() < 0.1
    assert res.log_likelihoods[-3:].mean() > res.log_likelihoods[:3].mean()
    assert tuple(ctx.get_parameter("beta").shape) == (200,)


def test_if2_uncooled_swarm_stays_wider():
    """``tests/test_if2.py:56``: at cooling 1 the final swarm stays wider
    than at 0.75, from the same seed and budget."""
    y = simulate(120, seed=2)
    cooled = _fit(64, 128, y, seed=3, num_iterations=12, sigma=0.1, cooling=0.75)[0]
    hot = _fit(64, 128, y, seed=3, num_iterations=12, sigma=0.1, cooling=1.0)[0]
    assert cooled.swarm["beta"].std() < hot.swarm["beta"].std()


def test_if2_entry_points():
    assert tinf.IF2 is tinf.batch.IF2 is tif2.IF2 and tinf.IF2Result is tif2.IF2Result
    alg = tinf.IF2(pt.SISR(t_build, 8, device="cpu"), 4, context=tinf.make_context(device="cpu"), device="cpu")
    assert alg.filter.batch_shape == (4,) and alg.context.batch_shape == (4,) and not alg.record_moments
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tinf.IF2(pt.SISR(t_build, 8, device="cpu"), 4, context=tinf.make_context(device="cpu"))
