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


# -- the explicit-SPMD tier (tests/test_torch_port_spmd.py) ---------------------------------------------------------


class RankTape:
    """The draws of one global numpy tape, in order, each cut to this rank's
    share: the axis on which the global draw is ``world`` times the rank's
    draw is sliced to the rank's rows (a draw the ranks share is taken
    whole)."""

    def __init__(self, arrays, world: int, rank: int):
        self.arrays, self.world, self.rank, self.taken = list(arrays), world, rank, 0

    def take(self, shape) -> torch.Tensor:
        z, shape = self.arrays[self.taken], tuple(shape)
        self.taken += 1
        if z.shape == shape:
            return torch.from_numpy(z.copy())
        for ax, (g, s) in enumerate(zip(z.shape, shape)):
            if g == s * self.world and z.shape[:ax] == shape[:ax] and z.shape[ax + 1:] == shape[ax + 1:]:
                return torch.from_numpy(np.take(z, np.arange(self.rank * s, (self.rank + 1) * s), axis=ax).copy())
        raise AssertionError(f"draw {self.taken - 1}: the tape holds {z.shape}, the rank asks for {shape}")


def _replaying(tape: RankTape):
    """Patch the per-rank draws to come from ``tape``: the distributions'
    normals, the EnKF's perturbations, and the rank generator replaced by a
    throwaway one, so that the shared generator gives the resample uniforms
    alone, as it does in the one-process run. Returns the undo."""
    from pyfilter_tpu_torch.filters import enkf as tenkf
    from pyfilter_tpu_torch.parallel import spmd

    saved = [(pt.distributions.Normal, "sample", pt.distributions.Normal.sample),
             (tenkf, "_standard_normal", tenkf._standard_normal), (spmd, "_rank_stream", spmd._rank_stream)]
    pt.distributions.Normal.sample = lambda self, generator, sample_shape=(): (
        self.loc + self.scale * tape.take(tuple(sample_shape) + tuple(self.batch_shape)))
    tenkf._standard_normal = lambda generator, shape, like: tape.take(shape)
    spmd._rank_stream = lambda generator, group: torch.Generator()

    def undo():
        for owner, name, value in saved:
            setattr(owner, name, value)

    return undo


def _recording(incs: list, fires: list):
    """Record each filter step's log-likelihood increment into ``incs`` and
    each resample's global ancestors into ``fires``; returns the undo."""
    from pyfilter_tpu_torch.parallel import spmd

    saved = {name: getattr(spmd._FilterRun, name) for name in ("sisr_step", "apf_step", "gpf_step", "resample")}

    def step(fn):
        def wrapped(self, *args):
            out = fn(self, *args)
            incs.append(0.0 if out[2] is None else float(out[2]))
            return out
        return wrapped

    def resample(self, *args, **kwargs):
        out = saved["resample"](self, *args, **kwargs)
        fires.append(_np(out[1]))
        return out

    for name, fn in saved.items():
        setattr(spmd._FilterRun, name, resample if name == "resample" else step(fn))
    return lambda: [setattr(spmd._FilterRun, name, fn) for name, fn in saved.items()]


def spmd_model(kind: str, oes: int = 1):
    """The models of the SPMD checks, on the CPU."""
    models = pt.timeseries.models
    if kind == "ar":  # tests/test_parallel.py:15
        return pt.timeseries.LinearStateSpaceModel(models.AR(0.0, 0.95, 0.3, device="cpu"), (1.0, 0.1),
                                                    observe_every_step=oes)
    if kind == "ar-enkf":  # tests/test_parallel_enkf.py:15
        return pt.timeseries.LinearStateSpaceModel(models.AR(0.2, 0.7, 0.4, device="cpu"), (1.0, 0.25))
    if kind == "ou":  # tests/test_parallel.py:1049
        return pt.timeseries.LinearStateSpaceModel(models.OrnsteinUhlenbeck(0.5, 1.0, 0.1, device="cpu"),
                                                    (1.0, 0.05), observe_every_step=oes)
    if kind == "ou-predict":  # :721
        return pt.timeseries.LinearStateSpaceModel(models.OrnsteinUhlenbeck(0.5, 1.0, 0.2, device="cpu"),
                                                    (1.0, 0.05))
    if kind == "trend":  # :784
        return pt.timeseries.LinearStateSpaceModel(models.TrendingOU(0.5, 1.0, 0.05, 0.1, device="cpu"),
                                                    (1.0, 0.05))
    raise ValueError(kind)


def ring_model(d: int, q_std=0.3, obs_std=0.25, decay=0.95, mix=0.2):
    """``tests/test_etkf.py``'s linear ring diffusion, observed elementwise, on the CPU."""
    def mean_scale(x, decay_, mix_, q_):
        v = x.value
        return decay_ * ((1.0 - mix_) * v + mix_ * 0.5 * (torch.roll(v, 1, dims=-1) + torch.roll(v, -1, dims=-1))), q_

    unit = pt.distributions.Normal(torch.zeros(d), torch.ones(d)).to_event(1)
    hidden = pt.timeseries.AffineProcess(mean_scale, tuple(torch.tensor(v) for v in (decay, mix, q_std)), unit,
                                         lambda *_: unit)
    return pt.timeseries.LinearStateSpaceModel(hidden, (1.0, obs_std), event_shape=(d,))


def ring_localization(d: int, radius: float):
    idx = np.arange(d, dtype=np.float32)
    diff = np.abs(idx[:, None] - idx[None, :])
    dist_ = np.minimum(diff, d - diff)
    return pt.convert.localization_from_numpy(radius, dist_xy=dist_, dist_yy=dist_, device="cpu")


def replay_filter(case: dict):
    """The filter and the model of one replay case."""
    from pyfilter_tpu_torch.filters.particle.proposals import Bootstrap
    model = spmd_model("ou" if case["oes"] > 1 else "ar", case["oes"])
    proposal = LinearGaussianObservations() if case["lgo"] else Bootstrap()
    return model, proposal


def _replay_runs(world: int, rank: int, payload: dict, mesh) -> dict:
    """Every replay case of the payload on this rank: the SPMD pass on the
    rank's slices of the one-process tape."""
    from pyfilter_tpu_torch.parallel import spmd

    out = {}
    for name, case in payload["replay"].items():
        model, proposal = replay_filter(case)
        incs, fires = [], []
        undo = [_replaying(RankTape(case["tape"], world, rank)), _recording(incs, fires)]
        spmd.spmd_batch_filter.fires = spmd.spmd_batch_filter.fallbacks = 0
        try:
            vals, lw, ll, means, (hv, hl, ht) = pt.parallel.spmd_batch_filter(
                model, case["n"], torch.Generator().manual_seed(case["seed"]), case["y"], mesh,
                filter_type=case["filter"], proposal=proposal, record_history=True)
        finally:
            for u in undo:
                u()
        out[name] = {"values": _np(vals), "lw": _np(lw), "ll": _np(ll), "means": _np(means), "incs": np.array(incs),
                     "ancestors": fires,
                     "hist_values": _np(hv), "hist_lw": _np(hl), "times": _np(ht), "times_dtype": str(ht.dtype),
                     "fires": spmd.spmd_batch_filter.fires, "fallbacks": spmd.spmd_batch_filter.fallbacks}
    for name, case in payload["enkf_replay"].items():
        model = ring_model(case["d"])
        loc = ring_localization(case["d"], case["radius"]) if case["radius"] else None
        undo = _replaying(RankTape(case["tape"], world, rank))
        _comm.reset()
        try:
            res = pt.parallel.spmd_enkf(model, case["m"], torch.Generator().manual_seed(0), case["y"], mesh,
                                        inflation=case["inflation"], localization=loc)
        finally:
            undo()
        out[name] = {"lls": _np(res.step_log_likelihoods), "ll": _np(res.log_likelihood),
                     "means": _np(res.filter_means), "variances": _np(res.filter_variances),
                     "ensemble": _np(res.latest_state.ensemble), "comm": _comm.counts()}
    return out


def _oracle_runs(mesh, payload: dict) -> dict:
    """The JAX tests' oracle workloads on the port at P ranks."""
    from pyfilter_tpu_torch.parallel import spmd

    par = pt.parallel
    y, y_nan = payload["ar_y"], payload["ar_y_nan"]
    ar = spmd_model("ar")
    out = {}

    def run(key, seed, data, **kw):
        vals, lw, ll, means = par.spmd_batch_filter(ar, 4096, torch.Generator().manual_seed(seed), data, mesh, **kw)
        out[key] = {"ll": float(ll), "means": _np(means), "shape": tuple(vals.shape), "device": str(vals.device)}
        return vals, lw

    run("sisr", 1, y)  # :906
    run("sisr-lgo", 2, y, proposal=LinearGaussianObservations())
    run("apf", 3, y, filter_type="apf")  # :633
    run("apf-lgo", 4, y, filter_type="apf", proposal=LinearGaussianObservations())
    run("gpf", 5, y, filter_type="gpf")  # :794
    run("metropolis", 6, y, resampler="metropolis", metropolis_iters=128)  # :814
    for i, ft in enumerate(("sisr", "apf", "gpf")):  # :692
        run(f"nan-{ft}", 7 + i, y_nan, filter_type=ft)

    # :567: FFBS over the sharded history, N = 2048, M = 512
    _, _, _, means, hist = par.spmd_batch_filter(ar, 2048, torch.Generator().manual_seed(11), y[:50], mesh,
                                                 record_history=True)
    sm = par.spmd_smooth(ar, torch.Generator().manual_seed(12), hist, mesh, n_trajectories=512)
    out["ffbs"] = {"sm": _np(sm), "means": _np(means), "hist_shapes": [tuple(h.shape) for h in hist]}

    # :1087: rejection FFBSi (and its forced fallback) against the exact pass, on :567's history
    exact = sm
    spmd.spmd_smooth.host_reads = spmd.spmd_smooth.fallback_passes = 0
    _comm.reset()
    rej = par.spmd_smooth(ar, torch.Generator().manual_seed(15), hist, mesh, n_trajectories=512, method="ffbsi")
    rej_comm, reads, passes = _comm.counts(), spmd.spmd_smooth.host_reads, spmd.spmd_smooth.fallback_passes
    forced = par.spmd_smooth(ar, torch.Generator().manual_seed(16), hist, mesh, n_trajectories=512, method="ffbsi",
                             max_rounds=0)
    out["ffbsi"] = {"exact": _np(exact), "rej": _np(rej), "forced": _np(forced), "comm": rej_comm,
                    "host_reads": reads, "fallback_passes": passes}

    # :1042: FFBS on a sub-stepped model, and its VI factor
    ou3 = spmd_model("ou", 3)
    *_, hist = par.spmd_batch_filter(ou3, 1024, torch.Generator().manual_seed(17), payload["ou3_y"], mesh,
                                     record_history=True)
    sm = par.spmd_smooth(ou3, torch.Generator().manual_seed(18), hist, mesh, n_trajectories=256)
    factor = par.spmd_smoothed_log_likelihood(ou3, 1024, torch.Generator().manual_seed(19), payload["ou3_y"], mesh,
                                              n_trajectories=128)
    out["ffbs-oes3"] = {"sm": _np(sm), "times": _np(hist[2]), "len": hist[0].shape[0], "factor": float(factor)}

    # :716 and :776: prediction
    ou = spmd_model("ou-predict")
    n_local = 8192 // dist.get_world_size(mesh.get_group("particles"))
    means, variances = par.spmd_predict(ou, torch.Generator().manual_seed(20), torch.full((n_local,), 3.0),
                                        torch.zeros(n_local), 10, mesh, time_index=0)
    out["predict"] = {"means": _np(means), "variances": _np(variances)}
    trend = spmd_model("trend")
    vals, lw, _, _ = par.spmd_batch_filter(trend, 2048, torch.Generator().manual_seed(21), payload["trend_y"], mesh)
    pred, _ = par.spmd_predict(trend, torch.Generator().manual_seed(22), vals, lw, 5, mesh, time_index=30)
    out["predict-trend"] = _np(pred)

    # :601 and :740: the VI factor's gradient
    def ou_factor(gamma, seed):
        g = torch.tensor(gamma, requires_grad=True)
        m = pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.OrnsteinUhlenbeck(0.5, g, 0.1, device="cpu"),
                                                (1.0, 0.05))
        f = par.spmd_smoothed_log_likelihood(m, 1024, torch.Generator().manual_seed(seed), payload["ou_y"], mesh,
                                             n_trajectories=128)
        f.backward()
        return float(f), float(g.grad)

    def trend_factor(beta, m_traj, seed):
        b = torch.tensor(beta, requires_grad=True)
        m = pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.TrendingOU(0.5, 1.0, b, 0.2, device="cpu"),
                                                (1.0, 0.1))
        f = par.spmd_smoothed_log_likelihood(m, 512, torch.Generator().manual_seed(seed), payload["trend2_y"], mesh,
                                             n_trajectories=m_traj)
        f.backward()
        return float(f), float(b.grad)

    out["vi"] = {"low": ou_factor(0.7, 23), "high": ou_factor(1.3, 24), "true": ou_factor(1.0, 25)}
    out["vi-trend"] = {"low": trend_factor(0.01, 128, 26), "eq": trend_factor(0.05, 30, 27),
                       "ref": trend_factor(0.05, 128, 28)}

    # tests/test_parallel_enkf.py:20 and :79
    res = par.spmd_enkf(spmd_model("ar-enkf"), 4000, torch.Generator().manual_seed(29), payload["enkf_y"], mesh)
    out["enkf"] = {"ll": float(res.log_likelihood), "means": _np(res.filter_means),
                   "variances": _np(res.filter_variances), "shape": tuple(res.latest_state.ensemble.shape)}
    try:
        par.spmd_enkf(spmd_model("ar-enkf"), 1001, torch.Generator().manual_seed(30), np.zeros(5, np.float32), mesh)
        out["enkf_indivisible"] = None
    except ValueError as err:
        out["enkf_indivisible"] = str(err)
    return out


def _comm_runs(mesh, payload: dict) -> dict:
    """The exchanges of each kind of step, counted by ``_comm``."""
    par = pt.parallel
    from pyfilter_tpu_torch.parallel import spmd

    wide = pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.AR(0.0, 0.95, 0.3, device="cpu"), (1.0, 2.0))
    y = payload["ar_y"][:10]
    out = {}
    for key, threshold, halo in (("quiet", 0.0, 1), ("fire-h1", 2.0, 1), ("fire-h2", 2.0, 2)):
        spmd.spmd_batch_filter.fires = spmd.spmd_batch_filter.fallbacks = 0
        _comm.reset()
        par.spmd_batch_filter(wide, 1024, torch.Generator().manual_seed(31), y, mesh, ess_threshold=threshold,
                              halo=halo)
        out[key] = {"comm": _comm.counts(), "fires": spmd.spmd_batch_filter.fires,
                    "fallbacks": spmd.spmd_batch_filter.fallbacks}
    ar = spmd_model("ar")
    *_, hist = par.spmd_batch_filter(ar, 1024, torch.Generator().manual_seed(32), y, mesh, record_history=True)
    _comm.reset()
    spmd.spmd_smooth.host_reads = 0
    par.spmd_smooth(ar, torch.Generator().manual_seed(33), hist, mesh, n_trajectories=128, method="ffbsi")
    out["ffbsi"] = {"comm": _comm.counts(), "steps": hist[0].shape[0] - 1, "reads": spmd.spmd_smooth.host_reads}
    _comm.reset()
    par.spmd_enkf(spmd_model("ar-enkf"), 400, torch.Generator().manual_seed(34), y, mesh)
    out["enkf"] = _comm.counts()
    return out


def _fallback_run(mesh, world: int, rank: int) -> dict:
    """One resample whose ancestors all lie on the last rank: the halo route
    does not fit and the all-gather fallback resamples the gathered cloud,
    against the one-process expansion of the same cloud."""
    from pyfilter_tpu_torch.ops import systematic_expand
    from pyfilter_tpu_torch.parallel import spmd

    n = 256
    lw = torch.full((n,), -float("inf"))
    lw[-8:] = torch.linspace(-1.0, 0.0, 8)
    vals = torch.arange(n, dtype=torch.float32) * 0.5
    rows = slice(rank * n // world, (rank + 1) * n // world)
    run = spmd._FilterRun(spmd_model("ar"), n, torch.Generator().manual_seed(35), mesh.get_group("particles"),
                          world, torch.device("cpu"), 0.9, 1, None, "systematic", 32)
    spmd.spmd_batch_filter.fallbacks = 0
    _comm.reset()
    out, idx = run.resample(lw[rows].contiguous(), vals[rows].contiguous())
    g = torch.Generator().manual_seed(35)
    torch.randint(0, 2**62, (), generator=g)  # the rank generator's seed, drawn first
    ref_out, ref_idx = systematic_expand(None, lw, vals, u=torch.rand((), generator=g))
    return {"equal": bool(torch.equal(out, ref_out[rows]) and torch.equal(idx, ref_idx[rows])),
            "fallbacks": spmd.spmd_batch_filter.fallbacks, "comm": _comm.counts()}


def _single_device(rank: int, payload: dict) -> dict:
    """The one-process runs that the JAX tests' single-device bars ask for,
    shared out over the ranks (each rank its own, no exchange)."""
    gen = torch.Generator().manual_seed
    ar = spmd_model("ar")
    if rank == 0:
        from pyfilter_tpu_torch.filters.particle.proposals import Bootstrap
        apf = pt.APF(ar, 4096, proposal=Bootstrap(), device="cpu").batch_filter(gen(50), payload["ar_y"])
        return {"apf": float(apf.log_likelihood)}
    if rank == 1:
        return {"gpf": float(pt.GPF(ar, 4096, device="cpu").batch_filter(gen(51), payload["ar_y"]).log_likelihood)}
    if rank == 2:
        factor = pt.SISR(spmd_model("ou", 3), 1024, device="cpu").smoothed_log_likelihood(
            gen(52), payload["ou3_y"], n_trajectories=128)
        return {"ou3_factor": float(factor)}
    trend = pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.TrendingOU(0.5, 1.0, 0.05, 0.2, device="cpu"),
                                                (1.0, 0.1))
    ou = pt.SISR(spmd_model("ou"), 1024, device="cpu").smoothed_log_likelihood(gen(53), payload["ou_y"],
                                                                               n_trajectories=128)
    tr = pt.SISR(trend, 512, device="cpu").smoothed_log_likelihood(gen(54), payload["trend2_y"], n_trajectories=128)
    return {"ou_factor": float(ou), "trend_factor": float(tr)}


def spmd_checks(rank: int, world: int, payload: dict) -> dict:
    res = {"single": _single_device(rank, payload)}
    try:
        pt.parallel.make_mesh()
        res["no_card"] = None
    except RuntimeError as err:
        res["no_card"] = str(err)
    mesh = pt.parallel.make_mesh(device_type="cpu")
    res["replay"] = _replay_runs(world, rank, payload, mesh)
    res["oracle"] = _oracle_runs(mesh, payload)
    res["comm"] = _comm_runs(mesh, payload)
    res["fallback"] = _fallback_run(mesh, world, rank)
    return res
