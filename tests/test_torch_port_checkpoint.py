"""The port's checkpointing held against the JAX package: the state dicts of
the algorithm states and the context, the npz format of ``io`` in both
directions, a JAX-written SMC² checkpoint resumed by the port, the context's
``apply_fun`` / ``copy`` / ``make_new`` (plain and quasi) and the prior check
on load, and ``save_pytree`` / ``load_pytree`` through ``torch.save``.

Both packages run the stochastic-volatility builder; the port's objects are
built from the JAX run's numpy leaves with ``pyfilter_tpu_torch.convert``.
Tolerances: state dicts array for array at rel 1e-6 (values the port copies
from the JAX run, so equal up to float32 storage), the resumed fit's loaded
weights exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfilter_tpu as pf
import pyfilter_tpu_torch as pt
from pyfilter_tpu import distributions as jdist
from pyfilter_tpu import examples as jexamples
from pyfilter_tpu import inference as jinf
from pyfilter_tpu import io as jio
from pyfilter_tpu_torch import distributions as tdist
from pyfilter_tpu_torch import inference as tinf

torch.set_num_threads(1)

N, K, T, SPLIT = 16, 32, 24, 12


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _y(n_obs=T):
    import chip_smoke

    return chip_smoke.simulate_obs(n_obs)


@pytest.fixture(scope="module")
def jax_run():
    """A JAX SMC² fit of the first SPLIT observations (APF(N) x K lanes):
    its context, algorithm and state."""
    y = _y()
    ctx = jinf.make_context(key=jax.random.PRNGKey(1))
    alg = jinf.SMC2(pf.APF(jexamples.stochastic_volatility_builder, N), K, context=ctx, key=jax.random.PRNGKey(2),
                    record_moments=False)
    state = alg.fit(jnp.asarray(y[:SPLIT]), logging=jinf.logging.DefaultLogger())
    return ctx, alg, state


def _port_context(jctx):
    tctx = tinf.make_context(device="cpu")
    tctx.set_batch_shape(jctx.batch_shape)
    pt.examples.stochastic_volatility_builder(tctx)
    return pt.convert.set_context_values(tctx, {n: np.asarray(v) for n, v in jctx.parameters.items()})


def _port_state(jstate):
    """The JAX state's arrays as a port SMC2State (built with ``convert``,
    not with ``load_state_dict``)."""
    latest = jstate.filter_state.latest_state
    corr = pt.convert.correction_from_numpy(*(np.asarray(a) for a in (
        latest.x.time_index, latest.x.value, latest.log_weights, latest.log_likelihood, latest.prev_indices,
        latest.mean, latest.variance)), device="cpu")
    fs = tinf.RunningFilterResult(corr, _t(np.asarray(jstate.filter_state.log_likelihood)), record_moments=False)
    state = tinf.SMC2State(_t(np.asarray(jstate.w)), fs, parsed_data=[np.asarray(v) for v in jstate.parsed_data])
    state.ess = [_t(np.asarray(e)) for e in jstate.ess]
    state.current_iteration = jstate.current_iteration
    return state


def _assert_same_tree(a, b, path="root"):
    """Key for key, item for item, arrays at rel 1e-6 with equal shapes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, list(a), list(b))
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, type(a), type(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    elif isinstance(a, (int, float, str)) and not isinstance(a, np.generic):
        assert a == b, (path, a, b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), rtol=1e-6, atol=0, err_msg=path)


def test_state_dicts_equal_the_jax_packages(jax_run):
    """The port's state and context built from a JAX run write the JAX
    package's state dicts, key for key and array for array."""
    jctx, _, jstate = jax_run
    tstate = _port_state(jstate)
    _assert_same_tree(tstate.state_dict(), jstate.state_dict())
    _assert_same_tree(_port_context(jctx).state_dict(), jctx.state_dict())
    # the correction's leaves follow the JAX pytree order
    leaves = tstate.state_dict()["filter_state"]["latest_state_leaves"]
    jleaves = jax.tree_util.tree_leaves(jstate.filter_state.latest_state)
    assert [np.shape(a) for a in leaves] == [np.shape(b) for b in jleaves]


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    """tests/test_inference.py:768-800 with the JAX package writing and the
    port reading: a fresh port context and SMC2 at the checkpoint's particle
    count load the npz, take its weights, and step on."""
    jctx, jalg, jstate = jax_run
    path = str(tmp_path / "jax_ckpt.npz")
    jio.save_state_dict(path, {"algorithm": jstate.state_dict(), "context": jctx.state_dict()})
    loaded = pt.io.load_state_dict(path)

    ctx = tinf.make_context(generator=torch.Generator().manual_seed(9), device="cpu")
    alg = tinf.SMC2(pt.APF(pt.examples.stochastic_volatility_builder, jalg.filter.n_particles, device="cpu"), K,
                    context=ctx, generator=torch.Generator().manual_seed(10), record_moments=False, device="cpu")
    state = alg.initialize()
    ctx.load_state_dict(loaded["context"])
    state.load_state_dict(loaded["algorithm"])
    alg.filter = alg.filter.initialize_model(ctx)
    np.testing.assert_array_equal(state.w.numpy(), np.asarray(jstate.w))
    assert state.current_iteration == jstate.current_iteration == SPLIT
    for name in ctx.parameters:
        np.testing.assert_array_equal(ctx.parameters[name].numpy(), np.asarray(jctx.parameters[name]))
    t0 = state.filter_state.latest_state.x.time_index
    for yt in _y()[SPLIT:]:
        state = alg.step(yt, state)
    assert len(state.ess) == T + 1 and state.current_iteration == T
    assert state.filter_state.latest_state.x.time_index == t0 + 5.0 * (T - SPLIT)
    assert torch.isfinite(state.filter_state.log_likelihood).all()


def test_port_checkpoint_loads_in_the_jax_package(jax_run, tmp_path):
    """The other direction: the port's npz of its state and context loads
    into the JAX package's."""
    jctx, _, jstate = jax_run
    tstate, tctx = _port_state(jstate), _port_context(jctx)
    path = str(tmp_path / "port_ckpt.npz")
    pt.io.save_state_dict(path, {"algorithm": tstate.state_dict(), "context": tctx.state_dict()})
    loaded = jio.load_state_dict(path)
    jctx2 = jinf.make_context(key=jax.random.PRNGKey(5))
    jctx2.set_batch_shape((K,))
    jexamples.stochastic_volatility_builder(jctx2)
    jctx2.load_state_dict(loaded["context"])
    for name in jctx.parameters:
        np.testing.assert_array_equal(np.asarray(jctx2.parameters[name]), np.asarray(jctx.parameters[name]))
    jstate.load_state_dict(loaded["algorithm"])
    np.testing.assert_array_equal(np.asarray(jstate.w), tstate.w.numpy())


def test_load_puts_tensors_on_the_states_device_and_checks_shapes(jax_run):
    """Loading numpy leaves gives tensors on the state's device with its
    dtypes; a cloud of another particle count raises, as in the JAX
    package."""
    _, _, jstate = jax_run
    tstate = _port_state(jstate)
    sd = jstate.state_dict()
    tstate.load_state_dict(sd)
    latest = tstate.filter_state.latest_state
    assert latest.prev_indices.dtype == torch.int32 and latest.x.value.dtype == torch.float32
    assert isinstance(latest.x.time_index, float)
    other = _port_state(jstate)
    other.filter_state.latest_state = other.filter_state.latest_state._replace(
        x=other.filter_state.latest_state.x.copy(values=torch.zeros(2 * N, K)))
    with pytest.raises(ValueError, match="different shape"):
        other.filter_state.load_state_dict(sd["filter_state"])


def test_io_round_trip_of_nested_structures(tmp_path):
    """Dicts, lists, tuples, scalars, strings, None, numpy arrays and
    tensors through one npz."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": [1, 2.5, True, "s", None],
            "c": (torch.ones(3, dtype=torch.int32), {"d": np.float32(4.0)}), "e": []}
    path = str(tmp_path / "tree")
    pt.io.save_state_dict(path, tree)
    back = pt.io.load_state_dict(path)
    assert list(back) == ["a", "b", "c", "e"] and back["b"] == [1, 2.5, True, "s", None] and back["e"] == []
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert isinstance(back["c"], tuple) and back["c"][0].dtype == np.int32
    np.testing.assert_array_equal(back["c"][0], np.ones(3, np.int32))
    assert float(back["c"][1]["d"]) == 4.0
    # the JAX package reads the same file
    jback = jio.load_state_dict(path + ".npz")
    np.testing.assert_array_equal(jback["a"], tree["a"])


def test_context_apply_fun_copy_and_make_new():
    """tests/test_inference.py:130-163 on the port, plain and quasi."""
    for quasi in (False, True):
        ctx = tinf.make_context(use_quasi=quasi, generator=torch.Generator().manual_seed(5), device="cpu")
        ctx.set_batch_shape((6,))
        ctx.named_parameter("a", tdist.Normal(torch.tensor(0.0), torch.tensor(1.0)))
        doubled = ctx.apply_fun(lambda v: 2.0 * v)
        np.testing.assert_allclose(doubled.get_parameter("a").numpy(), 2.0 * ctx.get_parameter("a").numpy())
        assert type(doubled) is type(ctx) and doubled.batch_shape == (6,)
        cp = ctx.copy()
        assert cp is not ctx and type(cp) is type(ctx)
        np.testing.assert_array_equal(cp.get_parameter("a").numpy(), ctx.get_parameter("a").numpy())
        new = ctx.make_new()
        assert type(new) is type(ctx) and new.batch_shape is None and not new.parameters
        assert new.device == ctx.device and new.generator is ctx.generator
        lanes = ctx.apply_fun(lambda v: v[:3])
        assert lanes.batch_shape == (3,)
    ctx.named_parameter("b", tdist.Normal(torch.zeros(2), torch.ones(2)).to_event(1))
    with pytest.raises(ValueError, match="mismatched batch shapes"):
        ctx.apply_fun(lambda v: v[:2] if v.dim() == 1 else v)


def test_context_state_dict_refuses_another_prior():
    """tests/test_inference.py:129-147 on the port: a round trip, then a
    context with another prior under the same name refuses the checkpoint."""
    def make(seed, loc=0.0, scale=1.0):
        ctx = tinf.make_context(generator=torch.Generator().manual_seed(seed), device="cpu")
        ctx.set_batch_shape((7,))
        ctx.named_parameter("a", tdist.Normal(torch.tensor(loc), torch.tensor(scale)))
        return ctx

    sd = make(4).state_dict()
    ctx2 = make(5)
    ctx2.load_state_dict(sd)
    np.testing.assert_array_equal(ctx2.get_parameter("a").numpy(), sd["parameters"]["a"])
    with pytest.raises(ValueError, match="disagrees"):
        make(6, 1.0, 2.0).load_state_dict(sd)
    with pytest.raises(ValueError, match="parameter sets differ"):
        make(6).load_state_dict({"parameters": {}, "prior": {}})
    # the JAX package's context dict for the same prior loads too
    jctx = jinf.make_context(key=jax.random.PRNGKey(4))
    jctx.set_batch_shape((7,))
    jctx.named_parameter("a", jdist.Normal(0.0, 1.0))
    ctx2.load_state_dict(jctx.state_dict())
    np.testing.assert_array_equal(ctx2.get_parameter("a").numpy(), np.asarray(jctx.get_parameter("a")))


def test_save_and_load_pytree_through_torch_save(tmp_path, jax_run):
    """A correction and a dict of tensors as ordered leaves; ``target=``
    gives the structure back, each leaf on its target's dtype."""
    _, _, jstate = jax_run
    corr = _port_state(jstate).filter_state.latest_state
    tree = {"corr": corr, "theta": torch.arange(3.0), "meta": (torch.tensor(2, dtype=torch.int64),)}
    path = str(tmp_path / "tree.pt")
    pt.io.save_pytree(path, tree)
    leaves = pt.io.load_pytree(path)
    assert len(leaves) == len(pt.io.tree_leaves(tree)) == 7 + 2
    back = pt.io.load_pytree(path, target=tree)
    assert isinstance(back["corr"], type(corr)) and back["corr"].x.time_index == corr.x.time_index
    for a, b in zip(pt.io.tree_leaves(back), pt.io.tree_leaves(tree)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="more leaves"):
        pt.io.load_pytree(path, target={"theta": torch.arange(3.0)})
