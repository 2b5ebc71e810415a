"""Ensemble transform Kalman filter (ETKF / LETKF) with Gaspari-Cohn
covariance localization.

Counterpart of ``pyfilter_tpu/filters/etkf.py``: the deterministic
square-root update (Bishop, Etherton & Majumdar 2001; the symmetric root of
Hunt, Kostelich & Szunyogh 2007) and Gaspari-Cohn localization (Gaspari &
Cohn 1999, eq. 4.10). With localization every state component solves its
own (M, M) analysis against distance-weighted observation precisions: here
one batched ``(d, M, M)`` computation, by ``eigh`` or by the coupled
Newton-Schulz iteration (matmuls only; the default when localized). The
forecast is the only draw.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ._masked import cholesky_or_nan, masked_gaussian_update, observations
from .enkf import EnKFState, _EnsembleBase, enrts_backward


def gaspari_cohn(r: torch.Tensor) -> torch.Tensor:
    """Gaspari & Cohn (1999, eq. 4.10) 5th-order taper of the normalized
    distance ``r = dist / c``: 1 at 0, compactly supported on [0, 2]."""
    r = torch.abs(torch.as_tensor(r))
    r2, r3 = r * r, r * r * r
    near = -0.25 * r3 * r2 + 0.5 * r3 * r + 0.625 * r3 - (5.0 / 3.0) * r2 + 1.0
    far = (
        (1.0 / 12.0) * r3 * r2
        - 0.5 * r3 * r
        + 0.625 * r3
        + (5.0 / 3.0) * r2
        - 5.0 * r
        + 4.0
        - (2.0 / 3.0) / torch.clamp(r, min=1e-12)
    )
    return torch.where(r <= 1.0, near, torch.where(r <= 2.0, far, 0.0))


def _euclidean(a, b):
    return torch.sqrt(torch.sum(torch.square(a - b), dim=-1))


class Localization(NamedTuple):
    """Distance-based Gaspari-Cohn tapers between the state and observation
    geometries: ``rho_xy`` ``(d, d_y)`` (also the LETKF's per-component
    observation weights), ``rho_yy`` ``(d_y, d_y)``, and ``rho_xx`` ``(d, d)``
    (the ensemble smoother's backward gain). Build from coordinates with
    :meth:`from_coords` (a pluggable metric) or from distance matrices with
    :meth:`from_distances`; the tapers lie where the inputs do."""

    rho_xy: torch.Tensor
    rho_yy: torch.Tensor
    rho_xx: Optional[torch.Tensor] = None

    @classmethod
    def from_coords(cls, state_coords, obs_coords=None, radius: float = 1.0,
                    metric: Optional[Callable] = None) -> "Localization":
        """``state_coords``: ``(d, c)`` (or ``(d,)``) coordinates of each state
        component; ``obs_coords`` defaults to them. ``radius`` is the taper's
        half-support ``c`` (zero from distance ``2 * radius``)."""
        sc = torch.as_tensor(state_coords, dtype=torch.float32)
        if sc.dim() == 1:
            sc = sc[:, None]
        oc = sc if obs_coords is None else torch.as_tensor(obs_coords, dtype=torch.float32, device=sc.device)
        if oc.dim() == 1:
            oc = oc[:, None]
        metric = metric or _euclidean
        d_xy = metric(sc[:, None, :], oc[None, :, :])
        d_yy = metric(oc[:, None, :], oc[None, :, :])
        d_xx = metric(sc[:, None, :], sc[None, :, :])
        return cls.from_distances(d_xy, d_yy, radius, dist_xx=d_xx)

    @classmethod
    def from_distances(cls, dist_xy, dist_yy, radius: float = 1.0, dist_xx=None) -> "Localization":
        return cls(
            gaspari_cohn(torch.as_tensor(dist_xy) / radius),
            gaspari_cohn(torch.as_tensor(dist_yy) / radius),
            None if dist_xx is None else gaspari_cohn(torch.as_tensor(dist_xx) / radius),
        )


class EnsembleTransformKalmanFilter(_EnsembleBase):
    """Deterministic square-root ensemble filter over a
    :class:`StateSpaceModel` on ``device`` (the card unless ``device="cpu"``;
    the model's), with the model contract of :class:`EnsembleKalmanFilter`.
    ``localization=None`` is the global ETKF; a :class:`Localization` the
    LETKF (diagonal observation noise). ``sqrt_method``: ``"eigh"`` (the
    global default) or ``"newton"`` (the localized default, ``ns_iters``
    Newton-Schulz iterations)."""

    def __init__(self, model, ensemble_size: int = 100, inflation: float = 1.0,
                 localization: Optional[Localization] = None, batch_shape=(), sqrt_method: Optional[str] = None,
                 ns_iters: int = 14, device=None):
        if sqrt_method is None:
            sqrt_method = "newton" if localization is not None else "eigh"
        if sqrt_method not in ("eigh", "newton"):
            raise ValueError("sqrt_method must be 'eigh' or 'newton'")
        self._setup(model, ensemble_size, inflation, localization, batch_shape, device)
        self.sqrt_method = sqrt_method
        self.ns_iters = int(ns_iters)

    def _lane_filter(self, model):
        return type(self)(model, self.ensemble_size, self.inflation, self.localization,
                          sqrt_method=self.sqrt_method, ns_iters=self.ns_iters, device=self.device)

    # -- analysis ----------------------------------------------------------------
    def _transform(self, yr, innov_r, m_count):
        """The ETKF solve in whitened observation space, batched over leading
        axes: ``yr`` ``(..., M, p)`` whitened observation anomalies,
        ``innov_r`` ``(..., p)`` the whitened innovation. Returns ``(w_bar
        (..., M), w_mat (..., M, M))``, the mean weights and the symmetric
        square-root transform. ``A = (M-1) I + Yr Yr'`` is SPD with
        eigenvalues >= M-1; scaled by its Gershgorin row-sum bound its
        spectrum lies in (0, 1], where Newton-Schulz converges."""
        m1 = m_count - 1.0
        eye = torch.eye(yr.shape[-2], dtype=yr.dtype, device=yr.device)
        a_mat = m1 * eye + yr @ yr.transpose(-1, -2)
        rhs = (yr @ innov_r[..., None])[..., 0]
        if self.sqrt_method == "eigh":
            evals, evecs = torch.linalg.eigh(a_mat)
            evals = torch.clamp(evals, min=1e-8)
            pa = (evecs / evals[..., None, :]) @ evecs.transpose(-1, -2)  # A^{-1}
            w_bar = (pa @ rhs[..., None])[..., 0]
            w_mat = (evecs / torch.sqrt(evals / m1)[..., None, :]) @ evecs.transpose(-1, -2)
            return w_bar, w_mat
        # Newton-Schulz: Z -> (A/c)^{-1/2}, so A^{-1/2} = Z / sqrt(c)
        c = torch.amax(torch.sum(torch.abs(a_mat), dim=-1), dim=-1)[..., None, None]
        b, z = a_mat / c, eye.expand(a_mat.shape)
        for _ in range(self.ns_iters):
            t = 0.5 * (3.0 * eye - z @ b)
            b, z = b @ t, t @ z
        inv_sqrt = z / torch.sqrt(c)  # A^{-1/2} (symmetric up to the iteration's error)
        pa = inv_sqrt @ inv_sqrt.transpose(-1, -2)
        w_bar = (pa @ rhs[..., None])[..., 0]
        return w_bar, m1**0.5 * inv_sqrt

    def _analysis(self, generator, ens, y_t, t):
        m_count = float(self.ensemble_size)
        g = self._obs_mean(ens, t)  # (M, d_y)
        g_bar = g.mean(dim=0)
        b = g - g_bar
        x_bar = ens.mean(dim=0)
        a = ens - x_bar
        r = self._obs_cov_at(x_bar, t)

        # missing components excised exactly: their whitened anomaly and
        # innovation columns are zero
        missing = torch.isnan(y_t)
        obs_mask = (~missing).to(ens.dtype)
        innov = torch.where(missing, 0.0, y_t - g_bar)

        # the step log-likelihood from the (tapered) observation-space
        # Gaussian, the stochastic filter's estimator
        c_yy = b.T @ b / (m_count - 1.0) + r
        c_xy = a.T @ b / (m_count - 1.0)
        if self.localization is not None:
            c_yy = c_yy * self.localization.rho_yy + r * (1.0 - self.localization.rho_yy)
            c_xy = c_xy * self.localization.rho_xy
        _, _, ll_t, _ = masked_gaussian_update(y_t, g_bar, c_xy, c_yy)

        if self.localization is None:
            # the global ETKF in R^{-1/2}-whitened observation space
            r_chol = cholesky_or_nan(r)
            yr = torch.linalg.solve_triangular(r_chol, (b * obs_mask).T, upper=False).T  # (M, d_y)
            innov_r = torch.linalg.solve_triangular(r_chol, innov[:, None], upper=False)[:, 0]
            w_bar, w_mat = self._transform(yr, innov_r, m_count)
            return x_bar + (w_bar[None, :] + w_mat) @ a, ll_t

        # LETKF: one whitened (M, M) solve per state component (a batch of d),
        # the observation precisions weighted by rho_xy[k] (diagonal R only)
        w = self.localization.rho_xy * obs_mask / torch.diagonal(r)  # (d, d_y)
        sw = torch.sqrt(w)
        yr = (b * obs_mask)[None] * sw[:, None, :]  # (d, M, d_y)
        w_bar_k, w_mat_k = self._transform(yr, innov * sw, m_count)  # (d, M), (d, M, M)
        # x_a[i, k] = x_bar_k + sum_m (w_bar_k[m] + W_k[i, m]) A[m, k]
        return x_bar + torch.einsum("kim,mk->ik", w_bar_k[:, None, :] + w_mat_k, a), ll_t

    # -- filtering ----------------------------------------------------------------
    def filter(self, generator, y_t, state: EnKFState, n_transitions: int = None) -> EnKFState:
        """One forecast + deterministic analysis move (``generator`` drives the
        forecast only)."""
        y_t = torch.atleast_1d(torch.as_tensor(y_t, dtype=torch.float32, device=self.device))
        if n_transitions is None:
            n_transitions = int(self.model.observe_every_step)
        ens, t = self._forecast(generator, state.ensemble, state.time_index, n_transitions)
        ens, ll_t = self._analysis(generator, ens, y_t, t)
        return EnKFState(ens, state.log_likelihood + ll_t, t)

    def smooth(self, generator, y):
        """Ensemble transform Kalman smoother: the forward pass's (forecast,
        analysis) pairs through the member-paired ensemble RTS
        (:func:`~pyfilter_tpu_torch.filters.enkf.enrts_backward`), its gain
        tapered by ``localization.rho_xx`` when localized. Returns the
        smoothed ensemble ``(T, M, d)``."""
        steps = self._pass(generator, observations(y, self.device))
        fores = torch.stack([s[0] for s in steps])
        anas = torch.stack([s[1] for s in steps])
        rho_xx = self.localization.rho_xx if self.localization is not None else None
        return enrts_backward(fores, anas, float(self.ensemble_size), rho_xx=rho_xx)
