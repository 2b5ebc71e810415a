"""Carry weights and state across from the JAX package, as numpy arrays.

The port never imports the JAX package: a caller turns the JAX objects'
leaves into numpy arrays (``np.asarray``) and hands them here, which builds
the port's objects from them — so both packages can start from one
particle cloud (one lane or a lane batch), one set of model parameters
(scalars or one per lane), one context's parameter values, and one recorded
filter history (which the port's smoothers then run on), one fitted guide
or maximum-likelihood point, PaRIS's per-particle statistics (a pytree
of arrays), and any distribution or bijector by its family's name and
parameters. Only numpy arrays,
numpy scalars and Python numbers are accepted. It also builds the
linear-Gaussian suite's 2-D models and the nonlinear benchmark model from
their numpy parameters, so that both packages filter the same model, and
the Gaussian family's model pieces: a Markov-switching model over the
port's regime models, a Rao-Blackwellized PF's linear substructure, and a
localization from coordinates or distances; and the states of SQMC and the
block particle filter.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import distributions, examples
from .distributions import Normal
from .filters.block import BlockPFState
from .filters.particle.sqmc import SQMCState
from .filters.result import FilterHistory
from .filters.state import ParticleFilterCorrection
from .timeseries import (
    AffineProcess,
    LinearModel,
    LinearStateSpaceModel,
    StateSpaceModel,
    TimeseriesState,
    joint_process,
    models,
)
from .utils import resolve_device

_NUMERIC = (np.ndarray, np.generic, int, float)


def _check(name, value):
    if not isinstance(value, _NUMERIC):
        raise TypeError(f"{name}: expected a numpy array or number, got {type(value).__name__}")
    return np.asarray(value)


def _tensor(name, value, dtype, device):
    return torch.tensor(_check(name, value), dtype=dtype, device=device)


def correction_from_numpy(
    time_index,
    values,
    log_weights,
    log_likelihood,
    prev_indices,
    mean=None,
    variance=None,
    event_ndim: int = 0,
    device=None,
) -> ParticleFilterCorrection:
    """A ``ParticleFilterCorrection`` from the numpy leaves of the JAX
    package's one (``x.time_index``, ``x.value``, ``log_weights``,
    ``log_likelihood``, ``prev_indices``, ``mean``, ``variance``), single
    lane or lane-batched (particle-indexed leaves ``(N, *batch)``, per-lane
    ones ``(*batch,)``). Missing moments become zeros, as for a filter that
    does not record them."""
    device = resolve_device(device)
    ll = _tensor("log_likelihood", log_likelihood, torch.float32, device)
    x = TimeseriesState(
        float(_check("time_index", time_index)),
        _tensor("values", values, torch.float32, device),
        event_ndim,
    )
    mean = torch.zeros_like(ll) if mean is None else _tensor("mean", mean, torch.float32, device)
    variance = torch.zeros_like(ll) if variance is None else _tensor("variance", variance, torch.float32, device)
    return ParticleFilterCorrection(
        x,
        _tensor("log_weights", log_weights, torch.float32, device),
        ll,
        _tensor("prev_indices", prev_indices, torch.int32, device),
        mean,
        variance,
    )


def sqmc_state_from_numpy(values, log_weights, time_index, log_likelihood, event_ndim: int = 0,
                          device=None) -> SQMCState:
    """An ``SQMCState`` from the numpy leaves of the JAX package's one
    (``values``, ``log_weights``, ``time_index``, ``log_likelihood``), single
    lane or with lanes in the port's layout (particle axis first: ``(N, K,
    ...)``; a vmapped JAX state is lane-leading and moves its lane axis to 1
    first)."""
    device = resolve_device(device)
    return SQMCState(_tensor("values", values, torch.float32, device),
                     _tensor("log_weights", log_weights, torch.float32, device),
                     float(_check("time_index", time_index)),
                     _tensor("log_likelihood", log_likelihood, torch.float32, device), int(event_ndim))


def block_state_from_numpy(values, time_index, log_likelihood, block_ess, device=None) -> BlockPFState:
    """A ``BlockPFState`` from the numpy leaves of the JAX package's one
    (``values`` ``(N, *lanes, d)``, ``time_index``, ``log_likelihood``
    ``(*lanes)``, ``block_ess`` ``(*lanes, B)``)."""
    device = resolve_device(device)
    return BlockPFState(_tensor("values", values, torch.float32, device), float(_check("time_index", time_index)),
                        _tensor("log_likelihood", log_likelihood, torch.float32, device),
                        _tensor("block_ess", block_ess, torch.float32, device))


def sv_model_from_numpy(kappa, gamma, sigma, mu, nu, tau, dt, device=None):
    """The stochastic-volatility model from the JAX model's six parameters
    (``hidden.parameters``, ``parameters``; scalars, or one value per lane)
    and ``dt`` (``hidden.dt``)."""
    device = resolve_device(device)
    params = [_tensor(n, v, torch.float32, device) for n, v in
              zip(("kappa", "gamma", "sigma", "mu", "nu", "tau"), (kappa, gamma, sigma, mu, nu, tau))]
    return examples.stochastic_volatility_model(*params, dt=float(_check("dt", dt)), device=device)


def history_from_numpy(time_indexes, values, log_weights, prev_indices, device=None) -> FilterHistory:
    """A ``FilterHistory`` from the numpy leaves of the JAX package's one
    (``time_indexes``, ``values``, ``log_weights``, ``prev_indices``); the
    time indexes stay on the host, as the port records them."""
    device = resolve_device(device)
    return FilterHistory(
        _tensor("time_indexes", time_indexes, torch.float32, "cpu"),
        _tensor("values", values, torch.float32, device),
        _tensor("log_weights", log_weights, torch.float32, device),
        _tensor("prev_indices", prev_indices, torch.int32, device),
    )


def ar_from_numpy(alpha, beta, sigma, device=None) -> models.AR:
    """The AR(1) process from the JAX one's ``parameters`` (scalars, or one
    value per lane)."""
    device = resolve_device(device)
    params = (_tensor(n, v, torch.float32, device) for n, v in (("alpha", alpha), ("beta", beta), ("sigma", sigma)))
    return models.AR(*params, device=device)


def random_walk_from_numpy(sigma, device=None) -> models.RandomWalk:
    """The random walk from the JAX one's ``parameters``."""
    device = resolve_device(device)
    return models.RandomWalk(_tensor("sigma", sigma, torch.float32, device), device=device)


def linear_ssm_from_numpy(hidden, a, b, s, event_shape=(), observe_every_step: int = 1) -> LinearStateSpaceModel:
    """The linear-Gaussian state-space model over the port's ``hidden``
    process from the JAX model's ``parameters`` ``(a, b, s)``, on the
    process's device."""
    params = tuple(_tensor(n, v, torch.float32, hidden.device) for n, v in (("a", a), ("b", b), ("s", s)))
    return LinearStateSpaceModel(hidden, params, event_shape=event_shape, observe_every_step=observe_every_step)


def rw2d_from_numpy(a, sigma, s, device=None) -> LinearStateSpaceModel:
    """The 2-D linear random walk of the linear-Gaussian suite: ``x' = a x +
    sigma * eps`` with an ``Independent`` standard-normal increment, initial
    ``N(0, sigma)`` per component, observed as ``y = a x + s v``; ``a`` is
    ``(d, d)``, ``sigma`` and ``s`` are ``(d,)``."""
    device = resolve_device(device)
    a = _tensor("a", a, torch.float32, device)
    sigma = _tensor("sigma", sigma, torch.float32, device)
    d = sigma.shape[-1]
    zero, one = torch.zeros((), device=device), torch.ones((), device=device)
    rw = LinearModel(
        (a, sigma),
        Normal(zero, one).expand((d,)).to_event(1),
        lambda a_, b_, s_: Normal(torch.zeros_like(s_), s_).expand((d,)).to_event(1),
        event_ndim=1,
    )
    return LinearStateSpaceModel(rw, (a, _tensor("s", s, torch.float32, device)), event_shape=(d,))


def joint_random_walks_from_numpy(sigmas, a, s, device=None) -> LinearStateSpaceModel:
    """The suite's joint process: one scalar random walk per entry of
    ``sigmas``, stacked by ``joint_process``, observed as ``y = a x + s v``."""
    device = resolve_device(device)
    walks = {f"proc_{i + 1}": models.RandomWalk(_tensor("sigma", v, torch.float32, device), device=device)
             for i, v in enumerate(_check("sigmas", sigmas))}
    params = (_tensor("a", a, torch.float32, device), _tensor("s", s, torch.float32, device))
    return LinearStateSpaceModel(joint_process(**walks), params, event_shape=(len(walks),))


def ukf_benchmark_mean(x, s):
    """The observation mean ``x^2 / 20`` of the nonlinear benchmark model."""
    return x.value**2.0 / 20.0


def ukf_benchmark_mean_derivative(x, s):
    """Its derivative ``x / 10``."""
    return x.value / 10.0


def _ukf_mean_scale(x, sigma):
    v = x.value
    return v / 2.0 + 25.0 * v / (1.0 + v**2.0) + 8.0 * math.cos(1.2 * x.time_index), sigma


def ukf_benchmark_from_numpy(sigma, s, device=None) -> StateSpaceModel:
    """The nonlinear benchmark model of the unscented-filter literature:
    ``x' = x/2 + 25 x / (1 + x^2) + 8 cos(1.2 t) + sigma eps``, initial
    ``N(0, sqrt 5)``, observed as ``y = x^2 / 20 + s v``
    (:func:`ukf_benchmark_mean`); the time index is the host's float."""
    device = resolve_device(device)
    zero, one = torch.zeros((), device=device), torch.ones((), device=device)
    hidden = AffineProcess(_ukf_mean_scale, (_tensor("sigma", sigma, torch.float32, device),), Normal(zero, one),
                           lambda sigma_: Normal(torch.zeros_like(sigma_), math.sqrt(5.0) * torch.ones_like(sigma_)))
    return StateSpaceModel(hidden, lambda x, s_: Normal(ukf_benchmark_mean(x, s_), s_),
                           (_tensor("s", s, torch.float32, device),))


def set_context_values(context, values: dict):
    """Write the JAX context's parameter values (``{name: numpy array}``, as
    ``{k: np.asarray(v) for k, v in ctx.parameters.items()}`` gives them)
    into the port's ``context``, whose builder registered the same names."""
    if set(values) != set(context.parameters):
        raise ValueError(f"parameters differ: {sorted(values)} != {sorted(context.parameters)}")
    for name, value in values.items():
        context.update_parameter(name, _tensor(name, value, torch.float32, context.device))
    return context


def svi_result_from_numpy(loc, log_scale, losses, context):
    """The port's ``SVIResult`` from a JAX ``SVIResult``'s guide
    (``guide.loc``, ``guide.log_scale``) and ``losses``, on ``context`` (the
    port's context over the same parameters) and its device."""
    from .inference.variational import GuideState, SVIResult

    dev = context.device
    guide = GuideState(_tensor("loc", loc, torch.float32, dev), _tensor("log_scale", log_scale, torch.float32, dev))
    return SVIResult(guide, _tensor("losses", losses, torch.float32, dev), context)


def mle_result_from_numpy(theta, losses, context):
    """The port's ``MLEResult`` from a JAX ``MLEResult``'s ``theta`` ``(1, D)``
    and ``losses``, on ``context`` and its device."""
    from .inference.variational import MLEResult

    dev = context.device
    return MLEResult(_tensor("theta", theta, torch.float32, dev), _tensor("losses", losses, torch.float32, dev), context)


def tree_from_numpy(tree, device=None):
    """A pytree (tuples, lists, dicts) of numpy arrays, such as the leaves of
    the JAX package's PaRIS statistics, as float32 tensors on ``device``, in
    the same structure."""
    from torch.utils._pytree import tree_map

    device = resolve_device(device)
    return tree_map(lambda leaf: _tensor("leaf", leaf, torch.float32, device), tree)


#: constructor arguments that are Python integers, not tensors
_STATIC_ARGS = {"event_ndim"}
_BIJECTORS = ("Identity", "Exp", "Log", "Softplus", "Sigmoid", "Tanh", "Affine", "Power", "SinhArcsinh")


def distribution_from_numpy(name: str, device=None, **params):
    """The port's distribution of the family ``name`` (any name in
    ``distributions.__all__`` with numeric parameters: ``"Normal"``,
    ``"Beta"``, ``"Categorical"``, ...), its parameters given as numpy arrays
    or numbers under the JAX constructor's keywords (``logits=`` or
    ``probs=`` for the binary and count families), as float32 tensors on
    ``device``."""
    cls = getattr(distributions, name, None)
    if not (isinstance(cls, type) and issubclass(cls, distributions.Distribution)):
        raise ValueError(f"no distribution family named {name!r}")
    device = resolve_device(device)
    kwargs = {k: int(v) if k in _STATIC_ARGS else _tensor(k, v, torch.float32, device) for k, v in params.items()}
    return cls(**kwargs)


def bijector_from_numpy(name: str, device=None, **params):
    """The port's bijector ``name`` (``"Identity"``, ``"Exp"``, ``"Log"``,
    ``"Softplus"``, ``"Sigmoid"``, ``"Tanh"``, ``"Affine"``, ``"Power"``,
    ``"SinhArcsinh"``), its parameters given as numpy arrays or numbers
    under the JAX constructor's keywords, as float32 tensors on ``device``."""
    if name not in _BIJECTORS:
        raise ValueError(f"no bijector named {name!r}")
    device = resolve_device(device)
    return getattr(distributions, name)(**{k: _tensor(k, v, torch.float32, device) for k, v in params.items()})


def markov_switching_from_numpy(models, transition_matrix, initial_probs=None):
    """A ``MarkovSwitchingModel`` over the port's regime ``models`` (already
    built, one device) with the transition matrix ``(K, K)`` (or lane-batched
    ``(L, K, K)``) and optional initial probabilities from numpy, on the
    models' device."""
    from .filters.imm import MarkovSwitchingModel

    device = models[0].device
    p0 = None if initial_probs is None else _tensor("initial_probs", initial_probs, torch.float32, device)
    return MarkovSwitchingModel(tuple(models), _tensor("transition_matrix", transition_matrix, torch.float32, device),
                                p0)


def linear_substructure_from_numpy(trans_matrix, trans_offset, trans_cov, obs_matrix, obs_offset, obs_cov,
                                   init_mean, init_cov, device=None):
    """A Rao-Blackwellized PF's ``LinearSubstructure``: each of the six
    per-particle functions is given either as a numpy array (a constant
    block, returned for every particle) or as a function of the particle's
    state returning a tensor on ``device``; the prior's mean and covariance
    as numpy arrays."""
    from .filters.rbpf import LinearSubstructure

    device = resolve_device(device)

    def block(name, value):
        if callable(value):
            return value
        const = _tensor(name, value, torch.float32, device)
        return lambda n: const

    return LinearSubstructure(
        block("trans_matrix", trans_matrix), block("trans_offset", trans_offset), block("trans_cov", trans_cov),
        block("obs_matrix", obs_matrix), block("obs_offset", obs_offset), block("obs_cov", obs_cov),
        _tensor("init_mean", init_mean, torch.float32, device), _tensor("init_cov", init_cov, torch.float32, device))


def localization_from_numpy(radius: float = 1.0, state_coords=None, obs_coords=None, dist_xy=None, dist_yy=None,
                            dist_xx=None, device=None):
    """A ``Localization``: from ``state_coords`` (and ``obs_coords``, Euclidean
    distances) or from the distance matrices ``dist_xy``, ``dist_yy`` and
    optionally ``dist_xx``, numpy arrays, on ``device``."""
    from .filters.etkf import Localization

    device = resolve_device(device)
    if state_coords is not None:
        oc = None if obs_coords is None else _tensor("obs_coords", obs_coords, torch.float32, device)
        return Localization.from_coords(_tensor("state_coords", state_coords, torch.float32, device), oc,
                                        radius=float(radius))
    dxx = None if dist_xx is None else _tensor("dist_xx", dist_xx, torch.float32, device)
    return Localization.from_distances(_tensor("dist_xy", dist_xy, torch.float32, device),
                                       _tensor("dist_yy", dist_yy, torch.float32, device), float(radius), dist_xx=dxx)
