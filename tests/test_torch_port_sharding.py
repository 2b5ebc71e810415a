"""The port's ``parallel/sharding.py`` and the ``mesh`` option of SMC², NESS
and PMMH, held against the JAX package's ``pyfilter_tpu/parallel/sharding.py``
tests (``tests/test_parallel.py``) and against the port's one-process runs.

One gloo group of four processes runs every check of the file
(``torch_parallel_group``, ``torch_parallel_checks.sharding_checks``), on
observations made with numpy from fixed seeds:

- ``make_mesh``, ``shard_filter_state``'s shapes and ``lane_sharded_filter``
  (``:54``, ``:94``, ``:118``), beside the JAX package's;
- the particle-sharded SISR against the one-process run at the same seed,
  over 4 ranks, over 2, and by the resampler route (the fused kernels'
  limit set below the cloud): every draw of a sharded run is the
  one-process run's, so up to the first step where the all-reduced weight
  sums, rounded in another order, move a copy-count boundary the ancestors
  are equal and the clouds, per-step log-likelihoods and means agree within
  1e-5; over the whole run, where they are two estimates of one likelihood,
  the reference's bar (``:62``: log-likelihood rel 0.02, means atol 0.05);
- the draw mode's declared layouts;
- ``sharded_filter_step`` on an APF (``:106``);
- SMC² (and its waste-free rejuvenation), NESS and PMMH sharded over a lane
  axis against the one-process fit at the same seeds (``:857``, ``:884``,
  ``:1026``): the parameters and the posterior mean within rel 1e-5, the
  lane log-weights (sums of 30 increments of order 10) within 1e-4, because
  the per-step reductions over the particle axis of an ``(N, K)`` cloud round
  by the lane count (the CPU vectorizes them across lanes, the card's kernels
  take their launch shape from it), while every draw and every decision is
  the one-process fit's; a 2-D (lanes x particles) SMC² fit runs to the end
  with finite weights on sharded clouds (``:857``).
"""

import jax
import numpy as np
import pytest
import torch

from pyfilter_tpu import parallel as jparallel
from torch_parallel_group import run_group

torch.set_num_threads(1)

WORLD = 4


def _ar_data(n, seed):
    rng = np.random.default_rng(seed)
    x, y = 0.0, np.empty(n, np.float32)
    for t in range(n):
        x = 0.95 * x + 0.3 * rng.normal()
        y[t] = x + 0.1 * rng.normal()
    return y


def _ou_data(n, seed):
    rng = np.random.default_rng(seed)
    x, y = 1.0, np.empty(n, np.float32)
    for t in range(n):
        x = 1.0 + (x - 1.0) * np.exp(-0.5) + 0.1 * rng.normal()
        y[t] = x + 0.05 * rng.normal()
    return y


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    payload = {"y": _ar_data(50, 0), "ou_y": _ou_data(30, 5)}
    return payload, run_group("sharding_checks", WORLD, payload, tmp_path_factory.mktemp("sharding"))


def test_mesh_construction(case):
    """``:54``: the default mesh puts every rank on one "particles" axis."""
    _, ranks = case
    devices = jax.devices()[:WORLD]
    jmesh = jparallel.make_mesh((WORLD,), devices=devices)
    jmesh2 = jparallel.make_mesh((2, WORLD // 2), ("lanes", "particles"), devices=devices)
    for r in ranks:
        assert r["mesh"]["1d"] == dict(jmesh.shape) == {"particles": WORLD}
        assert r["mesh"]["2d"] == dict(jmesh2.shape) == {"lanes": 2, "particles": WORLD // 2}


def test_shard_filter_state_placement(case):
    """``:94``: particle leaves split on axis 0, per-lane leaves whole; on a
    2-D mesh the lane axis splits too. Each rank holds its rows."""
    _, ranks = case
    for r in ranks:
        assert r["placement"] == {"value": (800 // WORLD,), "ll": (), "rows": True}
        assert r["placement_2d"] == {"value": (256 // (WORLD // 2), 2), "ll": (2,)}


def test_lane_plus_particle_mesh_and_lane_sharded_filter(case):
    """``:118``: a lane batch over a (lanes, particles) mesh filters to finite
    per-lane log-likelihoods, and ``lane_sharded_filter`` leaves each rank
    its lanes of the model's lane leaves."""
    _, ranks = case
    beta = np.linspace(0.5, 0.99, 4, dtype=np.float32)
    for r in ranks:
        assert r["lane_plus_particle"].shape == (2,) and np.isfinite(r["lane_plus_particle"]).all()
        lane = r["lane_rank"]
        np.testing.assert_array_equal(r["beta"], beta[2 * lane:2 * lane + 2])
    # the ranks of one lane group agree on its log-likelihoods
    by_lane = {}
    for r in ranks:
        by_lane.setdefault(r["lane_rank"], []).append(r["lane_plus_particle"])
    for lls in by_lane.values():
        np.testing.assert_array_equal(lls[0], lls[1])


def _whole(ranks, run: str, key: str) -> np.ndarray:
    """The sharded run's recorded ``key`` over the whole cloud, its shards in
    rank order (the first pair of ranks for ``"pair"``), particle axis 1."""
    group = sorted(ranks[:2], key=lambda r: r["pair_rank"]) if run == "pair" else ranks
    return np.concatenate([r["sisr"][run][key] for r in group], axis=1)


@pytest.mark.parametrize("run", ["world", "pair", "unfused"])
def test_sharded_sisr_matches_one_process(case, run):
    """Every draw of the sharded run is the one-process run's, so the two
    move together until the all-reduced weight sums, rounded in another
    order, move a copy-count boundary: up to that step the ancestors are
    equal and the clouds, per-step log-likelihoods and means agree within
    1e-5. Over the whole run ``:62``'s bar holds (log-likelihood rel 0.02,
    means atol 0.05). ``"world"`` shards over 4 ranks, ``"pair"`` over 2,
    and ``"unfused"`` resamples by the resampler and a gather over the
    gathered cloud (the fused kernels' limit set below it)."""
    _, ranks = case
    s0 = ranks[0]["sisr"][run]
    assert s0["fused"] == (run != "unfused") and s0["fires"] > 0
    idx, values = _whole(ranks, run, "idx"), _whole(ranks, run, "values")
    assert idx.shape == values.shape == s0["one_idx"].shape == (51, 1024)
    moved = np.flatnonzero((idx != s0["one_idx"]).any(axis=1))
    # rows of the history: the initial cloud, then one a step
    same = int(moved[0]) if moved.size else idx.shape[0]
    assert same > 1, "the first resample already moved a boundary"
    np.testing.assert_array_equal(idx[:same], s0["one_idx"][:same])
    np.testing.assert_allclose(values[:same], s0["one_values"][:same], rtol=1e-5, atol=1e-5)
    steps = same - 1
    for r in ranks:
        s = r["sisr"][run]
        np.testing.assert_allclose(s["lls"][:steps], s0["one_lls"][:steps], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s["means"][:steps], s0["one_means"][:steps], rtol=1e-5, atol=1e-5)
        assert abs(float(s["ll"]) - float(s["one_ll"])) / abs(float(s["one_ll"])) < 0.02
        np.testing.assert_allclose(s["means"], s["one_means"], atol=0.05)
        assert np.isfinite(s["values"]).all()
    for r in ranks:
        np.testing.assert_array_equal(r["sisr"][run]["ll"], s0["ll"])  # replicated


def test_draws_follow_their_declared_layouts(case):
    """The draw mode of a sharded run (``parallel/_shards.py``
    ``ShardedDraws``): a draw declared with the cloud's ``(N, *batch)``, one
    after a leading sub-step axis and one declared over the lanes are each
    the one-process draw's slice for this rank; a draw declared free of
    sharded axes is the same on every rank; an undeclared draw with an axis
    of a sharded local size raises instead of being split by a guess."""
    _, ranks = case
    for r in ranks:
        d = r["draws"]
        assert d["cloud"] and d["steps"] and d["lanes"] and d["raised"] == [True, True]
        np.testing.assert_array_equal(d["free"], ranks[0]["draws"]["free"])


def test_sharded_step_apf(case):
    """``:106``: one APF move on a sharded cloud; each rank returns its shard,
    the log-likelihood is the whole cloud's."""
    _, ranks = case
    for r in ranks:
        a = r["apf_step"]
        assert a["shape"] == (512 // WORLD,) and np.isfinite(a["ll"])
        np.testing.assert_allclose(a["ll"], a["one_ll"], rtol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["apf_step"]["cloud"] for r in ranks]),
                               ranks[0]["apf_step"]["one_cloud"], rtol=1e-5, atol=1e-5)


def _posterior(w, params):
    p = np.exp(w.astype(np.float64) - w.max())
    return (p / p.sum()) @ params.astype(np.float64)


def _lanes(arr, rank, k):
    step = k // WORLD
    return arr[rank * step:(rank + 1) * step]


@pytest.mark.parametrize("kind", ["smc2", "waste-free", "ness"])
def test_lane_sharded_fit_equals_one_process(case, kind):
    """Each rank's parameter lanes and lane weights are its lanes of the
    one-process fit at the same seeds (rel 1e-5: module docstring)."""
    _, ranks = case
    for rank, r in enumerate(ranks):
        one, mesh = r[kind]["one"], r[kind]["mesh"]
        assert mesh["iteration"] == one["iteration"] == 30
        assert mesh["rejuvenations"] == one["rejuvenations"] > 0
        np.testing.assert_allclose(mesh["params"], _lanes(one["params"], rank, 64), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mesh["w"], _lanes(one["w"], rank, 64), atol=1e-4)
        assert mesh["cloud"] == (24, 64 // WORLD)
    one = ranks[0][kind]["one"]
    w = np.concatenate([r[kind]["mesh"]["w"] for r in ranks])
    params = np.concatenate([r[kind]["mesh"]["params"] for r in ranks])
    np.testing.assert_allclose(_posterior(w, params), _posterior(one["w"], one["params"]), rtol=1e-5, atol=1e-6)


def test_lane_sharded_pmmh_equals_one_process(case):
    """``:1026``: the chains shard over the lanes; each rank's chains are the
    one-process run's (rel 1e-5)."""
    _, ranks = case
    for rank, r in enumerate(ranks):
        one, mesh = r["pmmh"]["one"], r["pmmh"]["mesh"]
        assert np.isfinite(mesh["samples"]).all()
        np.testing.assert_allclose(mesh["samples"], one["samples"][:, 2 * rank:2 * rank + 2], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mesh["ll"], one["ll"][2 * rank:2 * rank + 2], rtol=1e-5)


def test_two_axis_smc2_fit(case):
    """``:857``: SMC² on a (lanes, particles) mesh runs its whole fit with
    rejuvenation; the carried cloud is sharded on both axes."""
    _, ranks = case
    for r in ranks:
        fit = r["smc2-2d"]
        assert fit["iteration"] == 30 and fit["rejuvenations"] > 0
        assert np.isfinite(fit["w"]).all() and fit["w"].shape == (32,)
        assert fit["cloud"] == (32 // (WORLD // 2), 32)
