"""The port's collectors and per-step callbacks, held against the JAX package.

Each collector's value on one state converted from a JAX SMC² run equals
the JAX collector's on the JAX state (rel 1e-5: weighted sums of the same
float32 numbers in two frameworks); ``register_callback`` keeps one copy of a
callback; the JAX package's own collector tests (tests/test_inference.py:755
and :1267) run on the port; the hybrids call their callbacks too.

Run as a script, the file prints the standardized residuals' mean and
variance over CPU fits of chip_smoke's phase 16a configuration (the source of
``chip_smoke.CKPT_RESID``):

    PYTHONPATH=. python tests/test_torch_port_collectors.py SEED ...
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pyfilter_tpu_torch as pt
from pyfilter_tpu import inference as jinf
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch.filters.particle.proposals import LinearGaussianObservations
from test_torch_port_checkpoint import K, N, SPLIT, _port_context, _port_state, _y, jax_run  # noqa: F401

torch.set_num_threads(1)


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


def test_collectors_match_the_jax_packages(jax_run):
    """MeanCollector, Standardizer and ParameterPosterior (constrained and
    not) on the port's copy of a JAX run's state and context."""
    jctx, jalg, jstate = jax_run
    tctx = _port_context(jctx)
    talg = tinf.SMC2(pt.APF(pt.examples.stochastic_volatility_builder, N, device="cpu"), K, context=tctx,
                     record_moments=False, device="cpu")
    talg.filter = talg.filter.initialize_model(tctx)
    tstate = _port_state(jstate)
    y = _y()[SPLIT - 1]
    for tcol, jcol in ((tinf.sequential.MeanCollector(), jinf.sequential.MeanCollector()),
                       (tinf.sequential.Standardizer(), jinf.sequential.Standardizer()),
                       (tinf.sequential.ParameterPosterior(), jinf.sequential.ParameterPosterior()),
                       (tinf.sequential.ParameterPosterior(False), jinf.sequential.ParameterPosterior(False))):
        tcol(talg, torch.as_tensor(y), tstate)  # the observation as the algorithm passes it
        jcol(jalg, jnp.asarray(y), jstate)
        assert tcol.name == jcol.name
        got, want = tstate.collected[tcol.name][-1], jstate.collected[jcol.name][-1]
        assert got.device.type == "cpu" and tuple(got.shape) == tuple(np.shape(want))
        _close(got.numpy(), np.asarray(want))
    assert np.abs(tstate.collected["filter_means"][-1].numpy()) > 0  # the filter records its moments


def test_register_callback_keeps_one_copy():
    ctx = tinf.make_context(device="cpu")
    alg = tinf.SMC2(pt.APF(pt.examples.stochastic_volatility_builder, 8, device="cpu"), 8, context=ctx,
                    device="cpu")
    col = tinf.sequential.MeanCollector()
    for cb in (col, col, None, col):
        alg.register_callback(cb)
    assert alg._callbacks == [col]


def ou_build(ctx):
    """tests/test_inference.py:30's model on the port."""
    def const(v):
        return pt.timeseries.models.parameter(v, ctx.device)

    k = ctx.named_parameter("kappa", tdist.Exponential(const(1.0)))
    g = ctx.named_parameter("gamma", tdist.Normal(const(0.0), const(1.0)))
    s = ctx.named_parameter("sigma", tdist.LogNormal(const(-2.0), const(1.0)))
    return pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.OrnsteinUhlenbeck(k, g, s, device=ctx.device),
                                               (1.0, 0.05))


def ou_data(n_obs: int, seed: int = 5):
    model = pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.OrnsteinUhlenbeck(0.5, 1.0, 0.1, device="cpu"),
                                                (1.0, 0.05))
    return model.sample_states(torch.Generator().manual_seed(seed), n_obs).get_paths()[1].numpy()


def test_sequential_with_collectors():
    """tests/test_inference.py:755-766 on the port."""
    y = ou_data(40)
    ctx = tinf.make_context(generator=torch.Generator().manual_seed(1), device="cpu")
    alg = tinf.SMC2(pt.APF(ou_build, 100, proposal=LinearGaussianObservations(), device="cpu"), 150, context=ctx,
                    generator=torch.Generator().manual_seed(2), device="cpu")
    alg.register_callback(tinf.sequential.MeanCollector())
    alg.register_callback(tinf.sequential.ParameterPosterior())
    state = alg.fit(y, logging=tinf.logging.DefaultLogger())
    assert len(state.collected["filter_means"]) == 40
    assert len(state.collected["parameter_means"]) == 40
    assert torch.isfinite(torch.stack(state.collected["parameter_means"])).all()
    # collected on the context's device, the last row the final posterior mean
    _close(state.collected["parameter_means"][-1].numpy(),
           (state.normalized_weights() @ ctx.stack_parameters()).numpy())


def test_standardizer_collector():
    """tests/test_inference.py:1267-1287 on the port: the stochastic-volatility
    workload's inverse-transformed residuals are finite and O(1); a model
    whose observation is not transformed refuses."""
    import chip_smoke

    y = chip_smoke.simulate_obs(40)
    ctx = tinf.make_context(generator=torch.Generator().manual_seed(1), device="cpu")
    alg = tinf.SMC2(pt.APF(pt.examples.stochastic_volatility_builder, 100, device="cpu"), 128, context=ctx,
                    generator=torch.Generator().manual_seed(2), device="cpu")
    alg.register_callback(tinf.sequential.Standardizer())
    state = alg.fit(y, logging=tinf.logging.DefaultLogger())
    resid = torch.stack(state.collected["standardized"]).numpy()
    assert resid.shape == (40,)
    assert np.isfinite(resid).all()
    assert np.abs(resid).mean() < 3.0

    other = tinf.SMC2(pt.APF(ou_build, 10, device="cpu"), 8, context=tinf.make_context(device="cpu"), device="cpu")
    other.register_callback(tinf.sequential.Standardizer())
    try:
        other.fit(ou_data(2))
    except NotImplementedError as err:
        assert "Normal" in str(err)
    else:
        raise AssertionError("a Normal observation must not standardize")


def test_hybrid_calls_its_callbacks():
    """The hybrids run the callbacks registered on them, with the active
    stage's filter (the Standardizer reads its model)."""
    y = ou_data(12)
    ctx = tinf.make_context(generator=torch.Generator().manual_seed(3), device="cpu")
    alg = tinf.NESSMC2(pt.APF(ou_build, 20, device="cpu"), 32, switch=5, context=ctx,
                       generator=torch.Generator().manual_seed(4), device="cpu", smc2_kw={"threshold": 0.0})
    alg.register_callback(tinf.sequential.ParameterPosterior())
    alg.register_callback(tinf.sequential.MeanCollector())
    state = alg.fit(y)
    assert len(state.collected["parameter_means"]) == len(state.collected["filter_means"]) == 12
    assert alg._active_filter() is alg._second.filter and alg._active_filter().model is not None


def standardized_resid_spread(seeds):
    """Phase 16a's configuration on the CPU (the plain versions), one fit per
    seed: the standardized residuals' mean and variance."""
    import chip_smoke

    torch.set_num_threads(4)
    y = chip_smoke.simulate_obs(chip_smoke.N_OBS)
    for seed in seeds:
        _, alg = chip_smoke.ckpt_algorithm(torch, pt, "cpu", seed)
        state = alg.fit(y)
        r = torch.stack(state.collected["standardized"]).double().numpy()
        print(f"seed {seed}: standardized residuals mean {r.mean():+.6f} variance {r.var():.6f}", flush=True)


if __name__ == "__main__":
    import sys

    standardized_resid_spread([int(s) for s in sys.argv[1:]] or [0, 1, 2, 3])
