"""Shared pieces of the Gaussian filter family: the masked Gaussian
measurement update, the Gaussian moments of a density, and the family's
device and observation handling.

Counterpart of ``pyfilter_tpu/filters/_masked.py``. A NaN observation
component is marginalized out of the update exactly. Every factorisation is
``cholesky_ex``, whose failure becomes a NaN factor on the device (what
``jnp.linalg.cholesky`` returns), so a step of a deterministic filter makes
no host sync.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import resolve_device, same_device


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``a``, NaN where ``a`` is not positive
    definite, decided on the device."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[..., None, None], math.nan, chol)


def cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A^{-1} b`` from ``A``'s lower Cholesky factor, by two triangular
    solves (cuBLAS's ``trsm``, which a CUDA graph captures; a batched
    ``torch.cholesky_solve`` goes to MAGMA, which cannot be captured)."""
    z = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), z, upper=True)


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^{-1} b`` with no error check on the host (a singular ``a`` gives
    non-finite values, as ``jnp.linalg.solve`` does)."""
    return torch.linalg.solve_ex(a, b)[0]


def filter_device(model, device) -> torch.device:
    """The device a Gaussian filter runs on (the card unless ``device`` says
    otherwise), which must be the model's."""
    dev = resolve_device(device)
    if not same_device(model.device, dev):
        raise ValueError(f"the model lies on {model.device}, the filter on {dev}")
    return dev


def observations(y, device) -> torch.Tensor:
    """The observations ``(T, d_y)`` float32 on ``device`` (a 1-D series
    gains its event axis); one copy to the device for the whole pass."""
    if isinstance(y, torch.Tensor):
        y = y.detach().to(device=device, dtype=torch.float32)
    else:
        y = torch.as_tensor(np.asarray(y, dtype=np.float32), device=device)
    return y[:, None] if y.dim() == 1 else y


def density_covariance(density, d: int) -> torch.Tensor:
    """Full ``(d, d)`` noise covariance of a Gaussian(-moment) density: the
    exact ``covariance_matrix`` when the density has one (a multivariate
    normal: correlated noise is kept), else ``diag(variance)``. Leading
    length-1 batch axes are collapsed."""
    cov = getattr(density, "covariance_matrix", None)
    if cov is not None:
        return cov.reshape((-1,) + tuple(cov.shape[-2:]))[0]
    v = torch.as_tensor(density.variance)
    return torch.diag_embed(v.reshape(-1)[:d])


def initial_gaussian_moments(init, d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(m0, P0)`` of an initial distribution, the full covariance kept: the
    mean broadcast to ``(d,)``, the covariance the exact
    ``covariance_matrix`` when there is one, ``diag(variance)`` otherwise."""
    m0 = torch.atleast_1d(torch.as_tensor(init.mean, dtype=torch.float32)).expand(d)
    cov = getattr(init, "covariance_matrix", None)
    if cov is not None:
        p0 = cov.to(torch.float32).reshape(-1, d, d)[0]
    else:
        p0 = torch.diag_embed(torch.atleast_1d(torch.as_tensor(init.variance, dtype=torch.float32)).expand(d))
    return m0, p0


def masked_gaussian_update(y_t, y_hat, c_xy, s_mat):
    """Kalman-type measurement update with per-component NaN marginalization.

    The cross-covariance columns and innovation-covariance rows and columns
    of NaN slots are zeroed, with a unit diagonal in their place: the exact
    sub-filter over the observed components, at static shapes. Returns
    ``(gain, innov, ll_t, s_eff)``, ``ll_t`` the log-density of the observed
    components only. Update the moments as ``m + gain @ innov`` and ``p -
    gain @ s_eff @ gain.T``; with every component missing the gain and the
    innovation are zero and ``ll_t == 0``."""
    missing = torch.isnan(y_t)
    obs = (~missing).to(s_mat.dtype)
    innov = torch.where(missing, 0.0, y_t - y_hat)
    s_eff = s_mat * obs[:, None] * obs[None, :] + torch.diag_embed(1.0 - obs)
    c_eff = c_xy * obs[None, :]

    chol = cholesky_or_nan(s_eff)
    eye = torch.eye(y_t.shape[-1], dtype=s_mat.dtype, device=s_mat.device)
    gain = c_eff @ cho_solve(chol, eye)
    solved = cho_solve(chol, innov[:, None])[:, 0]
    log_det = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    ll_t = -0.5 * (innov @ solved + log_det + obs.sum() * math.log(2.0 * math.pi))
    return gain, innov, ll_t, s_eff
