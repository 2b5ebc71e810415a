"""PGAS — particle Gibbs with ancestor sampling (Lindsten, Jordan & Schön 2014).

Counterpart of ``pyfilter_tpu/inference/batch/mcmc/pgas.py``: a
conditional-SMC Gibbs sampler over the joint posterior ``p(theta, x_{0:T} |
y_{1:T})``. Each sweep refreshes the retained trajectory with a conditional
SMC pass whose slot 0 is pinned to it and whose ancestor there is drawn
against ``w_{t-1}^j f(x*_t | x_{t-1}^j)`` (:func:`csmc_sweep`), then moves
theta by ``num_theta_steps`` random-walk Metropolis-Hastings steps against
the exact joint density of the retained trajectory (O(T) each, no re-filter).

The JAX package's scan over sweeps, and its chunked, masked remainder, are
a Python loop over sweeps here; the ``chunk_size`` machinery is XLA dispatch
machinery and is not ported. Chains ride a lane axis after the particle
axis, as the JAX package ``vmap``s them: one sweep moves every chain, and a
sweep reads nothing back to the host. Categorical draws are Gumbel-argmax
with the noise from ``filters.particle.base.gumbel`` (the seam a test
replays): ``N`` ancestors from ``N`` logits take ``(N, N)`` Gumbels, as
``jax.random.categorical(key, logits, shape=(N,))`` draws them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ....filters.particle import base as particle_base
from ....filters.particle.base import smoothed_joint_log_likelihood
from ....timeseries import TimeseriesState
from ....utils import batched_gather, cuda_graph, normalize_log
from ... import prior as prior_ops
from ...base import BaseAlgorithm
from ...logging import DefaultLogger


#: Gumbel draws a block of steps holds at most (a sweep draws its steps'
#: ancestor noise a block at a time, not one step at a time)
GUMBEL_BLOCK_ELEMENTS = 1 << 22


class _GumbelSteps:
    """The Gumbel noise ``shape`` of each of ``n_steps`` steps, drawn through
    ``filters.particle.base.gumbel`` a block of steps at a time (one call a
    block: ``(block, *shape)``), step ``i`` read as row ``i % block``."""

    def __init__(self, generator, n_steps: int, shape: tuple, like: torch.Tensor):
        self.generator, self.n_steps, self.shape, self.like = generator, n_steps, tuple(shape), like
        self.block = max(1, min(n_steps, GUMBEL_BLOCK_ELEMENTS // max(math.prod(self.shape), 1)))
        self.rows = None

    def __call__(self, i: int) -> torch.Tensor:
        if i % self.block == 0:
            rows = min(self.block, self.n_steps - i)
            self.rows = particle_base.gumbel(self.generator, (rows,) + self.shape, self.like)
        return self.rows[i % self.block]


def _take(values: torch.Tensor, idx: torch.Tensor, event_ndim: int) -> torch.Tensor:
    """``values[idx[b], b]`` for every batch index ``b``: ``values`` is
    ``(N, *batch, *event)``, ``idx`` ``(*batch)``."""
    return batched_gather(values, idx.unsqueeze(0), event_ndim)[0]


def _particle_logits(lw: torch.Tensor) -> torch.Tensor:
    """Normalised log-weights ``(N, *batch)`` with the particle axis last."""
    return torch.movedim(normalize_log(lw), 0, -1)


def csmc_sweep(generator, model, y, ref_traj: torch.Tensor, n_particles: int, ancestor_sampling: bool = True,
               y_device: torch.Tensor | None = None):
    """One conditional-SMC sweep: a fresh trajectory whose law leaves the
    smoothing posterior ``p(x_{0:T} | y, theta)`` invariant when
    ``ref_traj`` is the retained path. Bootstrap proposal, multinomial
    resampling at every observation; ``ancestor_sampling=False`` is plain
    conditional SMC.

    ``ref_traj``: ``(2 + (T-1) * oes, *batch, *event)`` — the filters'
    recorded-history layout ``[x_0, x at the first correction, oes sub-steps
    for each later observation]`` (``observe_every_step = oes``); ``batch``
    holds the chains, each with the model parameters along the same axes.
    ``y``: ``(T, ...)`` on the host (``y_device``: its copy on the device,
    if the caller holds one). The draws, in order: the initial cloud;
    then per observation, at the first of each block of observations
    (:class:`_GumbelSteps`), the block's ancestor Gumbels ``(block, N,
    *batch, N)`` and slot 0's ``(block, *batch, N)`` (ancestor sampling
    only), and every observation's propagations; last the final index's
    Gumbels ``(*batch, N)``."""
    hidden = model.hidden
    ev = hidden.event_ndim
    oes = int(model.observe_every_step)
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    y_host = np.asarray(y, dtype=np.float32)
    n_obs = y_host.shape[0]
    expected_len = 2 + (n_obs - 1) * oes
    if ref_traj.shape[0] != expected_len:
        raise ValueError(
            f"retained trajectory has {ref_traj.shape[0]} states; oes={oes} with {n_obs} observations needs "
            f"{expected_len} (record sub-step states — record_intermediary=True)"
        )
    dev = ref_traj.device
    batch = tuple(ref_traj.shape[1: ref_traj.dim() - ev])
    y_dev = torch.tensor(y_host, device=dev) if y_device is None else y_device
    skip = np.isnan(y_host.reshape(n_obs, -1)).all(axis=1)  # all-NaN rows: uniform weights
    n = int(n_particles)

    vals0 = hidden.initial_sample(generator, (n,) + batch).value.clone()
    vals0[0] = ref_traj[0]
    lw = torch.zeros((n,) + batch, device=dev)
    # every observation's ancestor noise: (N, *batch, N) for the N draws,
    # (*batch, N) for slot 0's ancestor
    g_anc = _GumbelSteps(generator, n_obs, (n,) + batch + (n,), lw)
    g_slot0 = _GumbelSteps(generator, n_obs, batch + (n,), lw) if ancestor_sampling else None

    def ancestors(i, vals, lw, t, ref_next, out):
        logits = _particle_logits(lw)  # (*batch, N)
        torch.argmax(logits + g_anc(i), dim=-1, out=out)  # (N, *batch)
        if ancestor_sampling:
            # slot 0 against w_{t-1}^j f(x*_next | x_{t-1}^j)
            trans_lp = hidden.build_density(TimeseriesState(t, vals, ev)).log_prob(ref_next)
            torch.argmax(logits + torch.movedim(trans_lp, 0, -1) + g_slot0(i), dim=-1, out=out[0])
        else:
            out[0] = 0
        return out

    def weight(vals, t, i):
        if skip[i]:
            return torch.zeros((n,) + batch, device=dev)
        return model.build_density(TimeseriesState(t, vals, ev)).log_prob(y_dev[i])

    # ancestors of every observation, (T, N, *batch); the first observation's
    # move is ONE transition from t = 0
    ancs = torch.empty((n_obs, n) + batch, dtype=torch.int64, device=dev)
    ancestors(0, vals0, lw, 0.0, ref_traj[1], ancs[0])
    vals1 = hidden.propagate(generator, TimeseriesState(0.0, batched_gather(vals0, ancs[0], ev), ev)).value.clone()
    vals1[0] = ref_traj[1]
    lw = weight(vals1, 1.0, 0)

    # the later observations: oes sub-steps each, every one recorded, slot 0
    # pinned to the retained sub-state
    subs = torch.empty((max(n_obs - 1, 0), oes) + tuple(vals1.shape), dtype=vals1.dtype, device=dev)
    ref_subs = ref_traj[2:].reshape((max(n_obs - 1, 0), oes) + tuple(ref_traj.shape[1:]))
    cur, t = vals1, 1.0
    for i in range(1, n_obs):
        cur = batched_gather(cur, ancestors(i, cur, lw, t, ref_subs[i - 1, 0], ancs[i]), ev)
        for s in range(oes):  # sub-steps never resample
            nxt = subs[i - 1, s]
            nxt.copy_(hidden.propagate(generator, TimeseriesState(t + s, cur, ev)).value)
            nxt[0] = ref_subs[i - 1, s]
            cur = nxt
        t += oes
        lw = weight(cur, t, i)

    # the genealogy traced back from a draw of the final weights (sub-steps
    # share their observation's particle index)
    logits = _particle_logits(lw)
    idx = torch.argmax(logits + particle_base.gumbel(generator, logits.shape, logits), dim=-1)
    out = torch.empty((expected_len,) + tuple(ref_traj.shape[1:]), dtype=vals1.dtype, device=dev)
    for i in range(n_obs - 2, -1, -1):
        for s in range(oes):
            out[2 + i * oes + s] = _take(subs[i, s], idx, ev)
        idx = _take(ancs[i + 1], idx, 0)
    out[1] = _take(vals1, idx, ev)
    out[0] = _take(vals0, _take(ancs[0], idx, 0), ev)
    return out


class PGASResult:
    """The parameter draws after every sweep: ``samples[name]`` is
    ``(num_samples, *event)`` for one chain, ``(num_samples, num_chains,
    *event)`` for several (numpy). ``as_arrays`` always has the chain axis,
    so ``inference.summarize_chains(result)`` composes (one chain is split
    in halves for R-hat). ``trajectory``: each chain's retained path."""

    def __init__(self, samples, acceptance_rate, trajectory, num_chains: int = 1):
        self.samples = samples
        self.acceptance_rate = float(acceptance_rate)
        self.trajectory = trajectory
        self.num_chains = int(num_chains)

    def as_arrays(self):
        if self.num_chains == 1:
            return {k: np.asarray(v)[:, None] for k, v in self.samples.items()}
        return {k: np.asarray(v) for k, v in self.samples.items()}


def _standard_normal(generator, like: torch.Tensor) -> torch.Tensor:
    """The random walk's standard normals, ``like``'s shape."""
    return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)


def _uniform(generator, like: torch.Tensor) -> torch.Tensor:
    """The acceptance uniforms, ``like``'s shape."""
    return torch.rand(like.shape, generator=generator, dtype=like.dtype, device=like.device)


class PGAS(BaseAlgorithm):
    """Particle Gibbs with ancestor sampling over ``filter_``'s model builder
    (its ``n_particles``; its proposal is unused: CSMC is bootstrap).

    ``num_theta_steps`` random-walk MH moves of step ``rw_scale`` on the
    unconstrained space per sweep. ``initializer``: ``"mean"`` starts at the
    unconstrained prior mean (a 4096-draw estimate per parameter),
    ``"sample"`` at the context's prior draw. ``num_chains`` > 1 runs the
    chains side by side, each started at the initializer plus
    ``chain_jitter`` N(0, 1) on the unconstrained space. The retained
    trajectories start from one FFBS draw each of a recording filter (whose
    resamples run the expand kernels on the card). ``observe_every_step > 1``
    retains the sub-step states (the filters' recorded-history layout).

    On the card the sweep is captured once as a CUDA graph and replayed: a
    sweep is some 25 small kernels a time step (600 steps: 15,000
    launches), which the host dispatches one by one at about 0.8 ms a step;
    the graph launches them all at once, from the same generator, so the
    draws are the eager sweep's (:meth:`_graphed_sweep`)."""

    def __init__(self, filter_, num_samples: int, rw_scale: float = 5e-2, ancestor_sampling: bool = True,
                 num_theta_steps: int = 5, initializer: str = "mean", num_chains: int = 1, chain_jitter: float = 0.1,
                 context=None, generator=None, device=None):
        super().__init__(filter_, context=context, generator=generator, device=device)
        self.num_samples = int(num_samples)
        self.rw_scale = float(rw_scale)
        self.ancestor_sampling = bool(ancestor_sampling)
        self.num_theta_steps = max(int(num_theta_steps), 1)
        if initializer not in ("mean", "sample"):
            raise ValueError("initializer must be 'mean' or 'sample'")
        self.initializer = initializer
        self.num_chains = max(int(num_chains), 1)
        self.chain_jitter = float(chain_jitter)
        #: whether the last fit replayed its sweeps as a CUDA graph
        self.graphed = False
        self.context.set_batch_shape(())
        self._filter = self._filter.set_batch_shape(())

    def _chain_context(self, theta: torch.Tensor):
        """The context holding each chain's unconstrained ``theta`` ``(C,
        D)``: batch shape ``(C,)``, or ``()`` for one chain."""
        ctx = self.context._clone_registry()
        ctx.batch_shape = (self.num_chains,) if self.num_chains > 1 else ()
        return ctx.unstack_parameters(theta, constrained=False)

    def _start(self) -> torch.Tensor:
        """The chains' unconstrained starts ``(C, D)``."""
        ctx = self.context
        if self.initializer == "mean":
            parts = []
            for name in ctx.parameters:
                prior = ctx.get_prior(name)
                u = prior_ops.get_unconstrained(prior, prior.sample(self.generator, (4096,)))
                parts.append(u.reshape(4096, -1).mean(dim=0))
            theta0 = torch.cat(parts)[None]
        else:
            theta0 = ctx.stack_parameters(constrained=False).reshape(1, -1)
        theta0 = theta0.expand(self.num_chains, -1)
        if self.num_chains > 1:
            theta0 = theta0 + self.chain_jitter * _standard_normal(self.generator, theta0)
        return theta0.contiguous()

    def _joint(self, theta, trajectory, y_dev, times):
        """The joint log-density of each chain's retained trajectory and
        ``theta`` (unconstrained, the priors' Jacobians in), ``(C,)`` or
        ``()``."""
        ctx2 = self._chain_context(theta)
        model = self._filter.initialize_model(ctx2).model
        oes = int(model.observe_every_step)
        ll = smoothed_joint_log_likelihood(model, times, trajectory.unsqueeze(1), y_dev, oes=oes)
        return ll + ctx2.eval_priors(constrained=False)

    def sweep(self, theta, trajectory, y, times, y_dev=None):
        """One Gibbs sweep of every chain: the trajectory refreshed by
        :func:`csmc_sweep` given ``theta`` ``(C, D)``, then
        ``num_theta_steps`` random-walk MH moves of theta against the exact
        joint. ``y`` on the host, ``y_dev`` its copy on the device. Returns
        the new theta, trajectory and each chain's acceptance rate ``(C,)``,
        all on the device; it reads nothing back to the host."""
        if y_dev is None:
            y_dev = torch.tensor(np.asarray(y, dtype=np.float32), device=self.device)
        model = self._filter.initialize_model(self._chain_context(theta)).model
        trajectory = csmc_sweep(self.generator, model, y, trajectory, self._filter.n_particles,
                                self.ancestor_sampling, y_device=y_dev)
        lp_cur = self._joint(theta, trajectory, y_dev, times)
        acc = torch.zeros(lp_cur.shape, dtype=theta.dtype, device=self.device)
        for _ in range(self.num_theta_steps):
            theta_star = theta + self.rw_scale * _standard_normal(self.generator, theta)
            lp_star = self._joint(theta_star, trajectory, y_dev, times)
            accept = torch.log(_uniform(self.generator, lp_cur)) < lp_star - lp_cur
            theta = torch.where(accept.reshape(-1, 1), theta_star, theta)
            lp_cur = torch.where(accept, lp_star, lp_cur)
            acc = acc + accept.to(theta.dtype)
        return theta, trajectory, (acc / self.num_theta_steps).reshape(-1)

    def _graphed_sweep(self, sweep, theta, trajectory):
        """``sweep(theta, trajectory)`` captured as a CUDA graph from the
        algorithm's generator (:func:`~pyfilter_tpu_torch.utils.cuda_graph`).
        Returns a function with the sweep's signature that replays the graph
        and returns copies of its outputs."""
        replay, _ = cuda_graph(sweep, (theta, trajectory), self.device, generator=self.generator)
        self.graphed = True
        return lambda theta_, trajectory_: tuple(t.clone() for t in replay(theta_, trajectory_))

    def fit(self, y, logging=None) -> PGASResult:
        """Run ``num_samples`` sweeps over the observations ``y`` (time axis
        leading; kept on the host)."""
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        y = np.asarray(y, dtype=np.float32)
        ctx = self.context
        self._filter = self._filter.initialize_model(ctx)
        oes = int(self._filter.model.observe_every_step)
        c = self.num_chains
        batch = (c,) if c > 1 else ()

        theta = self._start()  # (C, D)
        # each chain's retained trajectory: one FFBS draw of a recording filter
        filt = self._filter.set_batch_shape(batch).initialize_model(self._chain_context(theta)).replace(
            record_states=True, record_intermediary=oes > 1)
        res = filt.batch_filter(self.generator, y)
        trajectory = filt.smooth(self.generator, res, method="ffbs")[:, 0].contiguous()  # (L, *batch, *event)
        times = torch.arange(trajectory.shape[0], dtype=torch.float32, device=self.device)
        y_dev = torch.tensor(y, device=self.device)

        sweep = functools.partial(self.sweep, y=y, times=times, y_dev=y_dev)
        self.graphed = False
        if self.device.type == "cuda":
            sweep = self._graphed_sweep(sweep, theta, trajectory)
        thetas = torch.empty((self.num_samples, c, theta.shape[1]), dtype=theta.dtype, device=self.device)
        accepts = torch.empty((self.num_samples, c), dtype=theta.dtype, device=self.device)
        logger = logging if logging is not None else DefaultLogger()
        with logger.initialize(self, self.num_samples):
            for i in range(self.num_samples):
                theta, trajectory, accepts[i] = sweep(theta, trajectory)
                thetas[i] = theta
                logger.do_log(i + 1, None)

        theta_chain = thetas.cpu()  # the one read of the chain
        samples, index = {}, 0
        for name in ctx.parameters:
            shape = ctx.get_shape(name, constrained=False)
            numel = math.prod(shape)
            block = theta_chain[:, :, index: index + numel].reshape((self.num_samples, c) + shape)
            if c == 1:
                block = block[:, 0]
            prior = ctx.get_prior(name)
            samples[name] = prior_ops.get_constrained(prior, block.to(self.device)).cpu().numpy()
            index += numel
        # the final draw of chain 0 into the user-held context
        final = ctx._clone_registry()
        final.batch_shape = ()
        ctx.absorb(final.unstack_parameters(theta[0], constrained=False))
        traj = trajectory.cpu().numpy()
        return PGASResult(samples, float(accepts.mean()), np.moveaxis(traj, 0, 1) if c > 1 else traj[None],
                          num_chains=c)
