"""Interacting Multiple Model (IMM) filter: Markov-switching Gaussian
filtering, and the Kim smoother.

Counterpart of ``pyfilter_tpu/filters/imm.py``. One Gaussian filter (EKF,
UKF or CKF) per candidate model ("regime") and a latent Markov chain with
transition matrix ``Pi`` between them (Blom & Bar-Shalom 1988). Each step:
the regimes' priors are mixed by the Markov probabilities, every regime
predicts and corrects, and the regime probabilities are re-weighted by the
innovation likelihoods. The candidates' tensor leaves are stacked into one
regime axis (:func:`_stack_models`) and every per-regime operation is one
``torch.func.vmap`` over it, with the model rebuilt from its leaves inside.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ._lane import lane_concat, lane_exchange, lane_resample, lane_vmap_batch_filter, model_leaves, rebuild, structure
from ._masked import filter_device, observations, solve
from .gsf import GAUSSIAN_BASES, mixture_moments
from .result import FilterResult


class MarkovSwitchingModel(NamedTuple):
    """A regime-switching model: the candidate :class:`StateSpaceModel`\\ s
    (the same structure, only their tensors differ), the ``(K, K)``
    transition matrix (which may be an inference parameter: a builder of the
    marginal adapter's ``kind="imm"`` computes it from the context) and,
    optionally, the initial regime probabilities."""

    models: Any
    transition_matrix: torch.Tensor
    initial_probs: Optional[torch.Tensor] = None


class IMMState(NamedTuple):
    means: torch.Tensor  # (K, d) per-regime posterior means
    covs: torch.Tensor  # (K, d, d)
    log_probs: torch.Tensor  # (K,) regime probabilities, normalized
    log_likelihood: torch.Tensor
    time_index: float

    def get_mean(self):
        """Regime-marginalized mean: sum_k P(regime k) m_k."""
        return torch.exp(self.log_probs) @ self.means

    def get_variance(self):
        """Diagonal of the regime-marginalized covariance."""
        return mixture_moments(self.log_probs, self.means, self.covs)[1]

    def most_likely_regime(self):
        return torch.argmax(self.log_probs)

    # -- lane surgery (leaves lane-leading under the marginal adapter's vmap) --
    def exchange(self, other: "IMMState", mask) -> "IMMState":
        return lane_exchange(self, other, mask)

    def resample(self, indices, entire_history: bool = True) -> "IMMState":
        return lane_resample(self, indices)

    @staticmethod
    def lane_concat(states) -> "IMMState":
        return lane_concat(IMMState, states)


def _stack_models(candidates: Sequence) -> list:
    """The candidates' tensor leaves stacked into a leading regime axis.
    Raises if their structures differ (other classes or containers): the
    vmapped step needs one program. Leaves at the same place may differ in
    shape as long as they broadcast (one candidate's parameter lane-batched,
    another's a scalar constant)."""
    if len({structure(m) for m in candidates}) != 1:
        raise ValueError("IMM candidate models must share their structure (the same classes and containers); "
                         f"got {len({structure(m) for m in candidates})} distinct structures")
    stacked = []
    for leaves in zip(*(model_leaves(m) for m in candidates)):
        leaves = [leaf.to(torch.float32) for leaf in leaves]
        shape = torch.broadcast_shapes(*(leaf.shape for leaf in leaves))
        stacked.append(torch.stack([leaf.expand(shape) for leaf in leaves]))
    return stacked


def _concrete(t) -> bool:
    """Whether the host may read ``t``'s values: not a tensor batched under
    ``vmap``, and not while a CUDA graph is being captured (a lane's or a
    captured pass's transition matrix is trusted to be stochastic by
    construction, as a traced one is in the JAX package; the marginal
    adapter's eager initial state checks it every pass)."""
    if isinstance(t, torch.Tensor) and t.is_cuda and torch.cuda.is_current_stream_capturing():
        return False
    return not (isinstance(t, torch.Tensor) and torch._C._functorch.is_functorch_wrapped_tensor(t))


class InteractingMultipleModel:
    """IMM estimator over ``K = len(candidates)`` regime models on ``device``
    (the card unless ``device="cpu"``; the models').

    ``candidates``: a sequence of models or a :class:`MarkovSwitchingModel`
    (whose matrix and initial probabilities are then used).
    ``transition_matrix[i, j] = P(regime j at t+1 | regime i at t)`` (rows
    sum to 1; checked on the host unless the matrix is a lane of a vmap).
    ``initial_probs`` defaults to uniform; ``base`` picks the per-regime
    filter as in :class:`GaussianSumFilter`; ``batch_shape=(K,)`` runs
    independent IMM lanes."""

    def __init__(self, candidates, transition_matrix=None, initial_probs=None, base: str = "ekf", batch_shape=(),
                 device=None, **base_kwargs):
        if isinstance(candidates, MarkovSwitchingModel):
            spec = candidates
            candidates = spec.models
            transition_matrix = spec.transition_matrix
            if initial_probs is None:
                initial_probs = spec.initial_probs
        if transition_matrix is None:
            raise ValueError("transition_matrix is required (directly or via the spec)")
        k = len(candidates)
        if k < 2:
            raise ValueError("IMM needs at least 2 candidate models")
        self.device = filter_device(candidates[0], device)
        trans = torch.as_tensor(transition_matrix, dtype=torch.float32, device=self.device)
        if tuple(trans.shape) != (k, k):
            raise ValueError(f"transition_matrix must be ({k}, {k}); got {tuple(trans.shape)}")
        if _concrete(trans) and not np.allclose(trans.detach().cpu().numpy().sum(axis=1), 1.0, atol=1e-5):
            raise ValueError("transition_matrix rows must sum to 1")
        if base not in GAUSSIAN_BASES:
            raise ValueError(f"unknown base filter {base!r} (want one of {sorted(GAUSSIAN_BASES)})")
        self._base_cls = GAUSSIAN_BASES[base]
        self.base_name = base
        self._base_kwargs = base_kwargs
        self.candidates = tuple(candidates)
        self.models = _stack_models(candidates)
        self.template = candidates[0]
        self.n_regimes = k
        self.batch_shape = tuple(batch_shape)
        self.log_trans = torch.log(torch.clamp(trans, min=1e-30))
        if initial_probs is None:
            self.log_p0 = torch.full((k,), -math.log(float(k)), device=self.device)
        else:
            p0 = torch.as_tensor(initial_probs, dtype=torch.float32, device=self.device)
            self.log_p0 = torch.log(torch.clamp(p0, min=1e-30)) - torch.log(p0.sum())

    # -- per-regime base filters (vmapped over the stacked regime axis) --------
    def _regime_filter(self, leaves):
        return self._base_cls(rebuild(self.template, leaves), device=self.device, **self._base_kwargs)

    def _over_regimes(self, fn, *args):
        """``fn(regime_filter, *per_regime_args)`` vmapped over the regimes."""
        return torch.func.vmap(lambda leaves, *a: fn(self._regime_filter(leaves), *a))(self.models, *args)

    def initialize(self) -> IMMState:
        means, covs = self._over_regimes(lambda filt: filt.initialize_moments())
        return IMMState(means, covs, self.log_p0, torch.zeros((), device=self.device), 0.0)

    def filter(self, y_t, state: IMMState, n_transitions: int = None) -> IMMState:
        """One IMM move: Markov mixing, the per-regime predict + correct, the
        regime re-weighting. An all-NaN observation skips the correction
        exactly (each regime's ll is 0) and adds exactly 0."""
        y_t = torch.atleast_1d(torch.as_tensor(y_t, dtype=torch.float32, device=self.device))
        if n_transitions is None:
            n_transitions = int(self.template.observe_every_step)

        # 1. mixing: log_mix[i, j] = log P(was i | now j) under the Markov prediction
        logits = self.log_trans + state.log_probs[:, None]  # (K_i, K_j)
        log_p_pred = torch.logsumexp(logits, dim=0)  # (K_j,)
        mix = torch.exp(logits - log_p_pred[None, :])  # columns sum to 1
        means0 = torch.einsum("ij,id->jd", mix, state.means)
        dev = state.means[:, None, :] - means0[None, :, :]  # (K_i, K_j, d)
        covs0 = torch.einsum("ij,ide->jde", mix, state.covs) + torch.einsum("ij,ijd,ije->jde", mix, dev, dev)

        # 2. per-regime predict + correct
        t0 = state.time_index

        def one_regime(filt, m, p):
            tt = t0
            for _ in range(n_transitions):
                m, p, _ = filt.predict_moments(m, p, tt)
                tt = tt + 1.0
            return filt.correct_moments(m, p, y_t, tt)

        means, covs, ll_k = self._over_regimes(one_regime, means0, covs0)

        # 3. regime update; an all-NaN gap adds exactly 0
        post = log_p_pred + ll_k
        norm = torch.logsumexp(post, dim=0)
        step_ll = torch.where(torch.isnan(y_t).all(), 0.0, norm)
        return IMMState(means, covs, post - norm, state.log_likelihood + step_ll, t0 + float(n_transitions))

    def batch_filter(self, y) -> FilterResult:
        """IMM filtering over the whole sequence; the recorded moments are
        regime-marginalized, the per-step regime log-probabilities ``(T, K)``
        are in ``aux``."""
        if self.batch_shape:
            spec = MarkovSwitchingModel(self.candidates, torch.exp(self.log_trans), torch.exp(self.log_p0))
            return lane_vmap_batch_filter(
                lambda s: InteractingMultipleModel(s, base=self.base_name, device=self.device, **self._base_kwargs),
                spec, self.batch_shape, y,
            )
        y = observations(y, self.device)
        state = self.filter(y[0], self.initialize(), n_transitions=1)
        lls, recs = [state.log_likelihood], [(state.get_mean(), state.get_variance(), state.log_probs)]
        for t in range(1, y.shape[0]):
            new = self.filter(y[t], state)
            lls.append(new.log_likelihood - state.log_likelihood)
            recs.append((new.get_mean(), new.get_variance(), new.log_probs))
            state = new
        means, variances, regime_lps = (torch.stack(parts) for parts in zip(*recs))
        return FilterResult(state.log_likelihood, torch.stack(lls), means, variances, state, None, aux=regime_lps)

    # -- smoothing ------------------------------------------------------------------
    def smooth(self, y):
        """Kim (1994) smoother for Markov-switching state-space models: the
        forward IMM pass records each step's per-regime filtered moments and
        regime probabilities; backward, per step, the discrete smoothing
        (Kim's approximation), an RTS step for each pair (regime i's filtered
        moments predicted through regime j's dynamics), and the moment-matched
        collapse over the next regime. Returns ``(means (T, d), variances (T,
        d), regime log-probabilities (T, K), (per-regime means (T, K, d), covs
        (T, K, d, d)))``."""
        y = observations(y, self.device)
        oes = int(self.template.observe_every_step)

        state = self.filter(y[0], self.initialize(), n_transitions=1)
        recs = [state]
        for t in range(1, y.shape[0]):
            state = self.filter(y[t], state)
            recs.append(state)

        def pair_predict(m_f_t, p_f_t, t):
            """(K_i, K_j) predictions of regime i's moments under model j."""
            out = torch.func.vmap(
                lambda leaves: torch.func.vmap(
                    lambda m_i, p_i: self._regime_filter(leaves).predict_moments_cross(m_i, p_i, t, oes)
                )(m_f_t, p_f_t)
            )(self.models)
            return tuple(o.transpose(0, 1) for o in out)

        last = recs[-1]
        m_s, p_s, lp_s = [last.means], [last.covs], [last.log_probs]
        for t in range(y.shape[0] - 2, -1, -1):
            m_f_t, p_f_t, log_mu_t = recs[t].means, recs[t].covs, recs[t].log_probs
            mp, pp, cc = pair_predict(m_f_t, p_f_t, recs[t].time_index)

            # 1. discrete backward recursion (Kim's approximation)
            log_mu_pred = torch.logsumexp(log_mu_t[:, None] + self.log_trans, dim=0)  # (K_j,)
            lj = log_mu_t[:, None] + self.log_trans + lp_s[-1][None, :] - log_mu_pred[None, :]
            log_mu_s_t = torch.logsumexp(lj, dim=1)
            w_cond = torch.exp(lj - log_mu_s_t[:, None])  # P(r_{t+1}=j | r_t=i, y)

            # 2. per-pair RTS smoothing: gain = cc pp^{-1}, batched over (K_i, K_j)
            gain = solve(pp.transpose(-1, -2), cc.transpose(-1, -2)).transpose(-1, -2)
            m_pair = m_f_t[:, None] + torch.einsum("ijab,ijb->ija", gain, m_s[-1][None] - mp)
            p_pair = p_f_t[:, None] + torch.einsum("ijab,ijbc,ijdc->ijad", gain, p_s[-1][None] - pp, gain)

            # 3. moment-matched collapse over the NEXT regime
            m_s_t = torch.einsum("ij,ija->ia", w_cond, m_pair)
            dev = m_pair - m_s_t[:, None]
            p_s_t = torch.einsum("ij,ijab->iab", w_cond, p_pair) + torch.einsum("ij,ija,ijb->iab", w_cond, dev, dev)
            m_s.append(m_s_t)
            p_s.append(p_s_t)
            lp_s.append(log_mu_s_t)
        m_s, p_s, lp_s = (torch.stack(parts[::-1]) for parts in (m_s, p_s, lp_s))

        mu = torch.exp(lp_s)  # (T, K)
        mean = torch.einsum("tk,tka->ta", mu, m_s)
        dev = m_s - mean[:, None]
        var = torch.einsum("tk,tkaa->ta", mu, p_s) + torch.einsum("tk,tka,tka->ta", mu, dev, dev)
        return mean, var, lp_s, (m_s, p_s)
