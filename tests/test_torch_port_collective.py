"""The port's ``parallel/collective.py`` held against the JAX package's
``pyfilter_tpu/parallel/collective.py`` and against its own one-process
resampler.

One gloo group of four processes runs every check of the file
(``torch_parallel_group``, ``torch_parallel_checks.collective_checks``);
the JAX side runs here with ``shard_map`` on the conftest's 8-device CPU
mesh, on the same inputs made with numpy from fixed seeds:

- the weight operations within rel 1e-5, with NaN and +inf scrubbed
  (``tests/test_parallel.py:144-176``);
- the systematic routes' indices equal to the JAX functions' at tie-free
  seeds (n = 2048, the uniform ``jax.random.uniform(key, ())``), and
  bit-equal to the port's one-process ``copy_counts`` + ``invert_counts`` at
  world 2 and 4 from the same probabilities, at n = 4096 and n = 2^17 (the
  port's prefix sums are exact integers in any order);
- the forced fallback; the collective-free tier's laws within the reference
  tests' tolerances (``:471``, ``:526``, the p = 2 duplicate mask ``:665``);
- the exchanges each route makes, counted by ``parallel._comm``, in place of
  the reference's compiled-HLO assertions (``:232``, ``:430``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import pyfilter_tpu_torch as pt
from pyfilter_tpu import parallel as jparallel
from pyfilter_tpu import utils as jutils
from pyfilter_tpu.parallel import collective as jcol
from pyfilter_tpu_torch.ops.resample import copy_counts, invert_counts
from torch_parallel_group import run_group

torch.set_num_threads(1)

WORLD = 4
N_SMALL, N_BIG = 4096, 1 << 17


def _jax_map(fn, n_in, out_specs):
    mesh = jparallel.make_mesh()
    return shard_map(fn, mesh=mesh, in_specs=(P("particles"),) * n_in, out_specs=out_specs)


def _one_process(probs, u):
    return invert_counts(copy_counts(torch.as_tensor(probs), torch.tensor(u))).numpy()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    lw_w = (rng.normal(size=1024) * 2.0).astype(np.float32)
    lw_w[3], lw_w[7] = np.nan, np.inf
    inc = rng.normal(size=1024).astype(np.float32)
    lw_2048 = rng.normal(size=2048).astype(np.float32)
    lw_bad = np.full(2048, -np.inf, np.float32)
    lw_bad[-100:] = 0.0
    bit_lw = {"small": (rng.normal(size=N_SMALL) * 1.5).astype(np.float32),
              "big": (rng.normal(size=N_BIG) * 2.0).astype(np.float32)}
    payload = {
        "lw_w": lw_w, "inc": inc, "lw_2048": lw_2048,
        "vals": rng.normal(size=(2048, 3)).astype(np.float32),
        "u3": np.float32(jax.random.uniform(jax.random.PRNGKey(3), ())),
        "u7": np.float32(jax.random.uniform(jax.random.PRNGKey(7), ())),
        "lw_ok": rng.normal(size=2048).astype(np.float32), "lw_bad": lw_bad,
        "vx": rng.normal(size=(2048, 2)).astype(np.float32), "aux": np.arange(2048, dtype=np.int32),
        "bit_lw": bit_lw,
        "bit_probs": {k: pt.normalize(torch.as_tensor(v)).numpy() for k, v in bit_lw.items()},
        "bit_u": {"small": np.float32(0.37), "big": np.float32(0.61)},
        "bit_vals": {k: np.arange(len(v), dtype=np.float32) for k, v in bit_lw.items()},
        "lw_metro": (0.5 * rng.normal(size=8192)).astype(np.float32),
        "vals_metro": rng.normal(size=(8192, 3)).astype(np.float32),
        "n_pair": 4096,
        "logits": np.broadcast_to(rng.normal(size=64).astype(np.float32), (20_000, 64)).copy(),
        "cat_vals": np.stack([np.arange(64, dtype=np.float32), np.arange(64, dtype=np.float32) ** 2], -1),
        "ar_y": (rng.normal(size=50) * 0.5).astype(np.float32),
    }
    ranks = run_group("collective_checks", WORLD, payload, tmp_path_factory.mktemp("collective"))
    return payload, ranks


def _cat(ranks, key, sub=None):
    return np.concatenate([r[key] if sub is None else r[key][sub] for r in ranks])


def test_weight_ops_match_jax(case):
    payload, ranks = case
    lw, inc = jnp.asarray(payload["lw_w"]), jnp.asarray(payload["inc"])
    probs, ess, ll = _jax_map(
        lambda a, b: (jcol.psum_normalize(a, "particles"), jcol.distributed_ess(a, "particles"),
                      jcol.distributed_log_likelihood(b, a, "particles")), 2, (P("particles"), P(), P()))(lw, inc)
    np.testing.assert_allclose(_cat(ranks, "probs"), np.asarray(probs), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(_cat(ranks, "probs"), np.asarray(jutils.normalize(lw)), rtol=1e-5, atol=1e-8)
    for r in ranks:  # replicated
        np.testing.assert_allclose(r["ess"], float(ess), rtol=1e-5)
        np.testing.assert_allclose(r["ll"], float(ll), rtol=1e-5)


def test_allgather_and_halo_match_jax(case):
    payload, ranks = case
    k = jax.random.PRNGKey(3)
    lw = jnp.asarray(payload["lw_2048"])
    ag, (g_idx, _, fits) = _jax_map(
        lambda a: (jcol.allgather_systematic(k, a, "particles"), jcol.halo_systematic(k, a, "particles")), 1,
        (P("particles"), (P("particles"), P("particles"), P())))(lw)
    assert bool(fits) and all(r["jax_halo_fits"] for r in ranks)
    np.testing.assert_array_equal(_cat(ranks, "jax_allgather"), np.asarray(ag))
    np.testing.assert_array_equal(_cat(ranks, "jax_halo"), np.asarray(g_idx))
    idx = _cat(ranks, "jax_allgather")
    np.testing.assert_array_equal(_cat(ranks, "jax_take"), payload["vals"][idx])
    np.testing.assert_array_equal(_cat(ranks, "jax_halo_take"), payload["vals"][idx])
    # window positions resolve to the same global ancestors (halo 1)
    n_local = 2048 // WORLD
    base = (np.arange(2048) // n_local - 1) * n_local
    np.testing.assert_array_equal(base + _cat(ranks, "jax_halo_window"), idx)


@pytest.mark.parametrize("name", ["ok", "bad"])
def test_composed_resample_matches_jax(case, name):
    """Healthy weights take the halo route, weights all on the last shard the
    all-gather fallback; both equal to the JAX function's result."""
    payload, ranks = case
    k = jax.random.PRNGKey(7)
    vals = {"x": jnp.asarray(payload["vx"]), "aux": jnp.asarray(payload["aux"])}
    taken, idx = shard_map(
        lambda a, v: jcol.distributed_systematic(k, a, v, "particles"), mesh=jparallel.make_mesh(),
        in_specs=(P("particles"), {"x": P("particles", None), "aux": P("particles")}),
        out_specs=({"x": P("particles", None), "aux": P("particles")}, P("particles")))(
        jnp.asarray(payload[f"lw_{name}"]), vals)
    got = [r[f"composed_{name}"] for r in ranks]
    assert all(g["fits"] == (name == "ok") for g in got)
    np.testing.assert_array_equal(np.concatenate([g["idx"] for g in got]), np.asarray(idx))
    np.testing.assert_array_equal(np.concatenate([g["x"] for g in got]), np.asarray(taken["x"]))
    np.testing.assert_array_equal(np.concatenate([g["aux"] for g in got]), np.asarray(taken["aux"]))
    if name == "bad":
        assert (np.concatenate([g["idx"] for g in got]) >= 2048 - 100).all()


@pytest.mark.parametrize("size", ["small", "big"])
@pytest.mark.parametrize("label", ["world", "pair"])
def test_routes_bit_equal_to_one_process(case, size, label):
    """World 4 and the two 2-rank groups of the same processes: every route
    gives the one-process indices bit for bit."""
    payload, ranks = case
    ref = _one_process(payload["bit_probs"][size], payload["bit_u"][size])
    key = f"bit_{size}_{label}"
    groups = [ranks] if label == "world" else [ranks[:2], ranks[2:]]
    for grp in groups:
        got = [r[key] for r in grp]
        assert all(g["fits"] for g in got)
        for route in ("allgather", "halo"):
            np.testing.assert_array_equal(np.concatenate([g[route] for g in got]), ref)
    # the composed resample from log-weights normalizes by all-reduce: the
    # values it takes are the ones its indices name
    for grp in groups:
        got = [r[key] for r in grp]
        idx = np.concatenate([g["composed_idx"] for g in got])
        np.testing.assert_array_equal(np.concatenate([g["composed_vals"] for g in got]),
                                      payload["bit_vals"][size][idx])


def test_local_metropolis_law_and_window(case):
    """``:471`` (aggregated ancestor mass tracks the weights, atol 0.015) and
    ``:430`` (every ancestor in its slot's ring window; ring shifts only)."""
    payload, ranks = case
    n = 8192
    g_idx = _cat(ranks, "metro_idx")
    w = np.exp(payload["lw_metro"].astype(np.float64))
    w /= w.sum()
    got = np.bincount(g_idx, minlength=n).reshape(16, -1).sum(1) / n
    np.testing.assert_allclose(got, w.reshape(16, -1).sum(1), atol=0.015)
    np.testing.assert_array_equal(_cat(ranks, "metro_taken"), payload["vals_metro"][g_idx])
    n_local = n // WORLD
    slot, anc = np.arange(n) // n_local, g_idx // n_local
    assert np.minimum((anc - slot) % WORLD, (slot - anc) % WORLD).max() <= 1
    for r in ranks:
        comm = r["metro_comm"]
        assert comm["ring_shift"]["calls"] > 0
        assert comm["all_reduce"]["calls"] == 0 and comm["all_gather"]["calls"] == 0


def test_local_metropolis_two_ranks_no_double_counting(case):
    """``:665``: on two ranks the halo-1 window wraps a whole lap; uniform
    weights must split the ancestors evenly between the two shards."""
    _, ranks = case
    for pair in (ranks[:2], ranks[2:]):
        g_idx = np.concatenate([r["pair_idx"] for r in sorted(pair, key=lambda r: r["pair_rank"])])
        assert abs(float(np.mean(g_idx >= 4096 // 2)) - 0.5) < 0.05


def test_distributed_categorical_law_and_take(case):
    """``:526``: the sharded Gumbel-max's frequencies match the softmax of the
    global row (atol 0.01), the row take is exact, and the exchanges are two
    max all-reduces and one sum all-reduce of ``rows`` values, no gather."""
    payload, ranks = case
    logits = payload["logits"][0]
    want = np.exp(logits.astype(np.float64)) / np.exp(logits.astype(np.float64)).sum()
    idx = ranks[0]["cat"]
    assert all(np.array_equal(r["cat"], idx) for r in ranks)
    np.testing.assert_allclose(np.bincount(idx, minlength=64) / len(idx), want, atol=0.01)
    np.testing.assert_array_equal(ranks[0]["cat_take"], payload["cat_vals"][idx])
    comm = ranks[0]["cat_comm"]
    assert comm["all_reduce"]["calls"] == 3 and comm["all_gather"]["calls"] == 0


def test_sharded_sisr_exchanges(case):
    """``:232``'s contract, counted: the weight reductions are all-reduces on
    every step, and the cloud is all-gathered only inside a resample fire
    (the probabilities and the value planes, two gathers a fire)."""
    _, ranks = case
    for r in ranks:
        comm = r["sisr_comm"]
        assert r["sisr_fires"] > 0
        assert comm["all_gather"]["calls"] == 2 * r["sisr_fires"]
        assert comm["all_reduce"]["calls"] >= 4 * 50
        assert comm["host_copies"] == 0  # CPU tensors on gloo travel as they are
