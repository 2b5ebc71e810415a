"""The port's side of the parallel tests, run inside one gloo group per test
file (:mod:`torch_parallel_group`): each function takes ``(rank, world,
payload)`` and returns this rank's results as numpy arrays. Torch and the
port only; the test files hold the JAX side and the assertions."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

import pyfilter_tpu_torch as pt
from pyfilter_tpu_torch import inference as inf
from pyfilter_tpu_torch.filters.particle import base as pbase
from pyfilter_tpu_torch.filters.particle.proposals import LinearGaussianObservations
from pyfilter_tpu_torch.parallel import _comm
from pyfilter_tpu_torch.parallel import collective as col
from pyfilter_tpu_torch.parallel._shards import LaneShard, ParticleShard, ShardedDraws
from pyfilter_tpu_torch.utils import draws_after, draws_of


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _shard(a, size: int, rank: int) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a))
    step = t.shape[0] // size
    return t[rank * step:(rank + 1) * step].clone()


def _routes(group, probs, u, lw=None, vals=None) -> dict:
    """The three systematic routes of this rank, from probabilities (and
    from log-weights with values, for the composed resample)."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    p = _shard(probs, size, rank)
    out = {
        "allgather": col.allgather_systematic(None, p, group, normalized=True, u=u),
        "halo": col.halo_systematic(None, p, group, normalized=True, u=u),
    }
    if lw is not None:
        out["composed"] = col.distributed_systematic(None, _shard(lw, size, rank), _shard(vals, size, rank), group,
                                                     u=u)
    return out


def collective_checks(rank: int, world: int, payload: dict) -> dict:
    mesh = pt.parallel.make_mesh(device_type="cpu")
    group = mesh.get_group("particles")
    pairs = pt.parallel.make_mesh((world // 2, 2), ("outer", "pair"), device_type="cpu").get_group("pair")
    res = {}

    lw, inc = _shard(payload["lw_w"], world, rank), _shard(payload["inc"], world, rank)
    res["probs"] = _np(col.psum_normalize(lw, group))
    res["ess"] = _np(col.distributed_ess(lw, group))
    res["ll"] = _np(col.distributed_log_likelihood(inc, lw, group))

    # against the JAX functions, from log-weights
    u3 = torch.tensor(payload["u3"])
    lw2 = _shard(payload["lw_2048"], world, rank)
    res["jax_allgather"] = _np(col.allgather_systematic(None, lw2, group, u=u3))
    g_idx, w_idx, fits = col.halo_systematic(None, lw2, group, u=u3)
    res["jax_halo"], res["jax_halo_window"], res["jax_halo_fits"] = _np(g_idx), _np(w_idx), bool(fits)
    vals = _shard(payload["vals"], world, rank)
    res["jax_take"] = _np(col.allgather_take(vals, torch.as_tensor(res["jax_allgather"]), group))
    res["jax_halo_take"] = _np(col.halo_take(vals, w_idx, group))
    u7 = torch.tensor(payload["u7"])
    for name in ("ok", "bad"):
        values = {"x": _shard(payload["vx"], world, rank), "aux": _shard(payload["aux"], world, rank)}
        taken, idx = col.distributed_systematic(None, _shard(payload[f"lw_{name}"], world, rank), values, group, u=u7)
        _, _, fits = col.halo_systematic(None, _shard(payload[f"lw_{name}"], world, rank), group, u=u7)
        res[f"composed_{name}"] = {"x": _np(taken["x"]), "aux": _np(taken["aux"]), "idx": _np(idx),
                                   "fits": bool(fits)}

    # bit-equality with the one-process counts, at the same probabilities
    for key, probs in payload["bit_probs"].items():
        u = torch.tensor(payload["bit_u"][key])
        for label, grp in (("world", group), ("pair", pairs)):
            out = _routes(grp, probs, u, lw=payload["bit_lw"][key], vals=payload["bit_vals"][key])
            res[f"bit_{key}_{label}"] = {
                "allgather": _np(out["allgather"]), "halo": _np(out["halo"][0]), "fits": bool(out["halo"][2]),
                "composed_idx": _np(out["composed"][1]), "composed_vals": _np(out["composed"][0]),
            }

    # the collective-free tier: exchanges counted, laws sampled
    _comm.reset()
    gen = torch.Generator().manual_seed(5)
    lw_m = _shard(payload["lw_metro"], world, rank)
    taken, g_idx = col.distributed_metropolis(gen, lw_m, _shard(payload["vals_metro"], world, rank), group, halo=1,
                                              n_iter=64)
    res["metro_idx"], res["metro_taken"], res["metro_comm"] = _np(g_idx), _np(taken), _comm.counts()
    pair_rank = dist.get_rank(pairs)
    zeros = _shard(np.zeros(payload["n_pair"], np.float32), 2, pair_rank)
    res["pair_idx"] = _np(col.local_metropolis(torch.Generator().manual_seed(3), zeros, pairs, halo=1, n_iter=64)[0])
    res["pair_rank"] = pair_rank

    _comm.reset()
    logits = torch.as_tensor(payload["logits"])  # (rows, n), each rank its columns
    n_local = logits.shape[1] // world
    cat = col.distributed_categorical(torch.Generator().manual_seed(3), logits[:, rank * n_local:(rank + 1) * n_local],
                                      group)
    res["cat"] = _np(cat)
    res["cat_take"] = _np(col.distributed_take_rows(_shard(payload["cat_vals"], world, rank), cat, group))
    res["cat_comm"] = _comm.counts()

    # the sharded SISR's exchanges: reductions every step, gathers only in fires
    filt = pt.SISR(_ar_model(), 1024, device="cpu")
    filt.batch_filter(torch.Generator().manual_seed(1), payload["ar_y"])
    _comm.reset()
    pt.parallel.sharded_batch_filter(filt, torch.Generator().manual_seed(1), payload["ar_y"], mesh)
    res["sisr_comm"], res["sisr_fires"] = _comm.counts(), filt.n_resamples
    return res


def ou_builder(ctx):
    """``tests/test_parallel.py:844``'s OU builder on the port."""
    d, dev = pt.distributions, ctx.device

    def c(v):
        return torch.tensor(v, device=dev)

    k = ctx.named_parameter("kappa", d.Exponential(c(1.0)))
    g = ctx.named_parameter("gamma", d.Normal(c(0.0), c(1.0)))
    s = ctx.named_parameter("sigma", d.LogNormal(c(-2.0), c(1.0)))
    return pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.OrnsteinUhlenbeck(k, g, s, device=dev), (1.0, 0.05))


def _ar_model(beta=0.95):
    return pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.AR(0.0, beta, 0.3, device="cpu"), (1.0, 0.1))


def _fit(kind: str, mesh, y, **mesh_kw) -> dict:
    """One fit of ``kind`` at fixed seeds, on ``mesh`` (or one process)."""
    ctx = inf.make_context(generator=torch.Generator().manual_seed(1), device="cpu")
    gen = torch.Generator().manual_seed(2)
    apf = pt.APF(ou_builder, 24, proposal=LinearGaussianObservations(), device="cpu")
    if kind == "pmmh":
        alg = inf.PMMH(apf, 5, num_chains=8, context=ctx, generator=gen, device="cpu", mesh=mesh,
                       proposal=inf.RandomWalk(0.05), **mesh_kw)
        res = alg.fit(y, logging=inf.logging.DefaultLogger())
        return {"samples": _np(torch.stack(res.samples["kappa"])), "ll": _np(res.filter_state.log_likelihood)}
    if kind == "ness":
        alg = inf.NESS(apf, 64, context=ctx, generator=gen, device="cpu", mesh=mesh, **mesh_kw)
    else:
        alg = inf.SMC2(apf if kind != "smc2-2d" else pt.APF(ou_builder, 32, proposal=LinearGaussianObservations(),
                                                            device="cpu"),
                       64, context=ctx, generator=gen, device="cpu", mesh=mesh,
                       num_steps=3 if kind == "waste-free" else 1, waste_free=kind == "waste-free", **mesh_kw)
    state = alg.fit(y, logging=inf.logging.DefaultLogger())
    return {"params": _np(ctx.stack_parameters()), "w": _np(state.w), "iteration": state.current_iteration,
            "rejuvenations": alg.kernel.n_rejuvenations, "cloud": tuple(state.filter_state.latest_state.x.value.shape)}


def _sisr_runs(mesh, axis: str, y) -> dict:
    """SISR(1024, record_states) on the AR model at seed 3, on one process
    and sharded over the mesh axis ``axis``: per-step log-likelihoods and
    means, the recorded clouds and ancestors (this rank's slots of the
    sharded run), and the resample fires of each."""
    filt = pt.SISR(_ar_model(), 1024, record_states=True, device="cpu")
    one = filt.batch_filter(torch.Generator().manual_seed(3), y)
    ParticleShard.fires = 0
    shr = pt.parallel.sharded_batch_filter(filt, torch.Generator().manual_seed(3), y, mesh, particle_axis=axis)
    return {"one_lls": _np(one.step_log_likelihoods), "lls": _np(shr.step_log_likelihoods),
            "one_ll": _np(one.log_likelihood), "ll": _np(shr.log_likelihood),
            "one_means": _np(one.filter_means), "means": _np(shr.filter_means),
            "one_values": _np(one.states.values), "values": _np(shr.states.values),
            "one_idx": _np(one.states.prev_indices), "idx": _np(shr.states.prev_indices),
            "one_fires": filt.n_resamples, "fires": ParticleShard.fires,
            "fused": filt._use_fused_resample(torch.zeros(1))}


def sharding_checks(rank: int, world: int, payload: dict) -> dict:
    res = {}
    mesh = pt.parallel.make_mesh(device_type="cpu")
    mesh2 = pt.parallel.make_mesh((2, world // 2), ("lanes", "particles"), device_type="cpu")
    lanes = pt.parallel.make_mesh((world,), ("lanes",), device_type="cpu")
    res["mesh"] = {name: dict(zip(m.mesh_dim_names, m.mesh.shape)) for name, m in (("1d", mesh), ("2d", mesh2))}
    res["lane_rank"] = dist.get_rank(mesh2.get_group("lanes"))

    filt = pt.SISR(_ar_model(), 800, device="cpu")
    state = filt.initialize(torch.Generator().manual_seed(0))
    sh = pt.parallel.shard_filter_state(state, mesh)
    res["placement"] = {"value": tuple(sh.x.value.shape), "ll": tuple(sh.log_likelihood.shape),
                        "rows": bool(torch.equal(sh.x.value, state.x.value[rank * 200:(rank + 1) * 200]))}

    ar4 = pt.timeseries.LinearStateSpaceModel(
        pt.timeseries.models.AR(0.0, torch.linspace(0.5, 0.99, 4), 0.3, device="cpu"), (1.0, 0.1))
    f4 = pt.SISR(ar4, 256, batch_shape=(4,), device="cpu")
    sh4 = pt.parallel.shard_filter_state(f4.initialize(torch.Generator().manual_seed(1)), mesh2,
                                         particle_axis="particles", lane_axis="lanes", n_lane_dims=1)
    res["placement_2d"] = {"value": tuple(sh4.x.value.shape), "ll": tuple(sh4.log_likelihood.shape)}
    res["lane_plus_particle"] = _np(pt.parallel.sharded_batch_filter(
        f4, torch.Generator().manual_seed(2), payload["y"][:20], mesh2, lane_axis="lanes").log_likelihood)
    lane_mesh = pt.parallel.make_mesh((2, world // 2), ("lanes", "rest"), device_type="cpu")
    res["beta"] = _np(pt.parallel.lane_sharded_filter(f4, lane_mesh).model.hidden.parameters[1])

    # the sharded SISR against the one-process run at the same seed: over
    # every rank, over pairs of ranks, and by the resampler and a gather (the
    # fused kernels' limit set below the cloud, as a cloud of 2^24 entries
    # or more resamples)
    pairs = pt.parallel.make_mesh((world // 2, 2), ("outer", "pair"), device_type="cpu")
    res["pair_rank"] = dist.get_rank(pairs.get_group("pair"))
    res["sisr"] = {"world": _sisr_runs(mesh, "particles", payload["y"]),
                   "pair": _sisr_runs(pairs, "pair", payload["y"])}
    limit = pbase.FUSED_ENTRIES
    pbase.FUSED_ENTRIES = 512
    try:
        res["sisr"]["unfused"] = _sisr_runs(mesh, "particles", payload["y"])
    finally:
        pbase.FUSED_ENTRIES = limit

    # the draw mode: a declared layout is drawn whole and sliced, a draw
    # declared free of sharded axes is the same on every rank, an undeclared
    # draw with an axis of a sharded size raises
    parts, lanes_sh = ParticleShard(mesh.get_group("particles"), 8), LaneShard(mesh.get_group("particles"), 4 * world)
    g = torch.Generator().manual_seed(11)
    with ShardedDraws(parts, lanes_sh):
        with draws_of(particles=(8, 4)):
            cloud = torch.randn(8, 4, 2, generator=g)
            with draws_after(1):
                steps = torch.rand(3, 8, 4, generator=g)
        with draws_of(lanes=(4,)):
            lane_u = torch.rand(4, generator=g)
        with draws_of():
            free = torch.randn(8, generator=g)
        raised = []
        for shape in ((8,), (5, 4)):
            try:
                torch.randn(shape, generator=g)
                raised.append(False)
            except ValueError:
                raised.append(True)
    g = torch.Generator().manual_seed(11)
    whole = (torch.randn(8 * world, 4 * world, 2, generator=g), torch.rand(3, 8 * world, 4 * world, generator=g),
             torch.rand(4 * world, generator=g))
    rows, cols = slice(8 * rank, 8 * rank + 8), slice(4 * rank, 4 * rank + 4)
    res["draws"] = {"cloud": bool(torch.equal(cloud, whole[0][rows, cols])),
                    "steps": bool(torch.equal(steps, whole[1][:, rows, cols])),
                    "lanes": bool(torch.equal(lane_u, whole[2][cols])), "free": _np(free), "raised": raised}

    # one APF step (the optimal proposal of the linear-Gaussian observations)
    apf = pt.APF(_ar_model(), 512, proposal=LinearGaussianObservations(), device="cpu")
    st = apf.initialize(torch.Generator().manual_seed(4))
    out = pt.parallel.sharded_filter_step(apf, torch.Generator().manual_seed(5), payload["y"][0], st, mesh,
                                          first_step=True)
    ref = apf.filter(torch.Generator().manual_seed(5), payload["y"][0], st, first_step=True)
    res["apf_step"] = {"shape": tuple(out.x.value.shape), "ll": _np(out.log_likelihood),
                       "one_ll": _np(ref.log_likelihood), "cloud": _np(out.x.value), "one_cloud": _np(ref.x.value)}

    # the algorithms: lane-sharded against one process at the same seeds
    for kind in ("smc2", "waste-free", "ness", "pmmh"):
        res[kind] = {"one": _fit(kind, None, payload["ou_y"]), "mesh": _fit(kind, lanes, payload["ou_y"])}
    res["smc2-2d"] = _fit("smc2-2d", mesh2, payload["ou_y"], particle_axis="particles")
    return res


def card_checks(rank: int, world: int, payload: dict) -> dict:
    """The all-gather route with the kernels on the card (a gloo group, the
    ranks' shards on the one card): K1 on one lane at n = 1e6 and K2 on a
    lane batch at (400, 1000), each rank's indices against the one-process
    counts of the whole cloud, and the host copies gloo made."""
    from pyfilter_tpu_torch.ops import expand
    from pyfilter_tpu_torch.ops.resample import copy_counts, invert_counts
    mesh = pt.parallel.make_mesh()
    dev = pt.parallel.sharding.mesh_device(mesh)
    shard = ParticleShard(mesh.get_group("particles"), 0)
    res = {"device": str(dev)}
    for name, n, lanes, d in (("k1", 1_000_000, (), 1), ("k2", 400, (1000,), 2)):
        g = torch.Generator(device=dev).manual_seed(7)  # the same cloud on every rank
        probs = torch.softmax(torch.randn((n,) + lanes, generator=g, device=dev) * 2.0, 0)
        vals = torch.randn((n,) + lanes + (d,), generator=g, device=dev)
        u = torch.rand(lanes, generator=g, device=dev)
        rows = slice(rank * n // world, (rank + 1) * n // world)
        counter = expand.fused_expand_lanes if lanes else expand.fused_expand
        fused = expand.systematic_expand_lanes if lanes else expand.systematic_expand
        before = counter.launches
        _comm.reset()
        out, idx = shard.resample(probs[rows].contiguous(), vals[rows].contiguous(),
                                  lambda p, v: fused(None, p, v, normalized=True, u=u))
        launches = counter.launches - before
        ref = invert_counts(copy_counts(probs.T.contiguous() if lanes else probs, u))
        ref = ref.T if lanes else ref
        taken = torch.gather(vals, 0, ref.long().unsqueeze(-1).expand(vals.shape))
        res[name] = {"indices": bool(torch.equal(idx, ref[rows])), "values": bool(torch.equal(out, taken[rows])),
                     "launches": launches, "host_copies": _comm.host_copies.count,
                     "on_card": out.device.type == "cuda" and idx.device.type == "cuda"}
    return res
