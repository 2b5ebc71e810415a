"""MCMC convergence diagnostics for the chains of a batch PMMH fit:
split-:math:`\\hat R` (potential scale reduction, Gelman et al. BDA3 §11.4)
and the effective sample size from the autocorrelation (Geyer's initial
positive sequence, as Vehtari et al. 2021 use it, without the
rank-normalisation).

Counterpart of ``pyfilter_tpu/inference/diagnostics.py``: numpy on the host
(the chains come off the device once per fit), a copy of the JAX package's
functions so that the port imports nothing of it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["potential_scale_reduction", "effective_sample_size", "summarize_chains"]


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(T, K) -> (T//2, 2K): each chain split in half (split-R-hat)."""
    t = (x.shape[0] // 2) * 2
    half = t // 2
    return np.concatenate([x[:half], x[half:t]], axis=1)


def _rhat_scalar(x: np.ndarray) -> float:
    x = _split_chains(np.asarray(x, np.float64))
    n, m = x.shape
    if n < 2 or m < 2:
        return float("nan")
    chain_means = x.mean(axis=0)
    w = x.var(axis=0, ddof=1).mean()
    b_over_n = chain_means.var(ddof=1)
    var_hat = (n - 1) / n * w + b_over_n
    if w == 0:
        return 1.0
    return float(np.sqrt(var_hat / w))


def _autocov(x: np.ndarray) -> np.ndarray:
    """Per-chain autocovariance via FFT; x is (n, m), returns (n, m)."""
    n = x.shape[0]
    xc = x - x.mean(axis=0)
    size = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, n=size, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=size, axis=0)[:n].real
    return acov / n


def _ess_scalar(x: np.ndarray) -> float:
    x = _split_chains(np.asarray(x, np.float64))
    n, m = x.shape
    if n < 4:
        return float("nan")
    acov = _autocov(x)
    chain_var = acov[0] * n / (n - 1.0)
    w = chain_var.mean()
    var_hat = (n - 1) / n * w + x.mean(axis=0).var(ddof=1)
    if var_hat == 0:
        return float(n * m)

    # combined autocorrelation, Geyer initial positive sequence over pairs
    rho = 1.0 - (w - acov.mean(axis=1)) / var_hat  # (n,)
    rho[0] = 1.0
    tau = 0.0
    t = 1
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        tau += pair
        t += 2
    ess = m * n / (1.0 + 2.0 * tau)
    return float(min(ess, m * n))


def _apply_elementwise(fn, chains: np.ndarray) -> np.ndarray:
    """Apply a (T, K) -> scalar statistic over trailing event dims."""
    chains = np.asarray(chains)
    if chains.ndim == 2:
        return np.asarray(fn(chains))
    flat = chains.reshape(chains.shape[0], chains.shape[1], -1)
    out = np.array([fn(flat[..., i]) for i in range(flat.shape[-1])])
    return out.reshape(chains.shape[2:])


def potential_scale_reduction(chains) -> np.ndarray:
    """Split-:math:`\\hat R` of a ``(num_samples, num_chains, *event)`` chain
    record (e.g. one entry of ``PMMHResult.as_arrays()``). Values near 1
    indicate the chains mixed into the same distribution; > ~1.05 means keep
    sampling."""
    return _apply_elementwise(_rhat_scalar, chains)


def effective_sample_size(chains) -> np.ndarray:
    """Autocorrelation-adjusted effective sample size across all chains of a
    ``(num_samples, num_chains, *event)`` record."""
    return _apply_elementwise(_ess_scalar, chains)


def summarize_chains(result, burn_in: float = 0.5) -> Dict[str, dict]:
    """Per-parameter summary of a :class:`PMMHResult`: posterior mean/std
    (post burn-in) plus split-R-hat and ESS over the retained samples.

    ``burn_in``: fraction of leading samples to drop (reference plotting
    keeps everything; 0.5 is the conventional default)."""
    out = {}
    for name, arr in result.as_arrays().items():
        arr = np.asarray(arr)
        kept = arr[int(round(burn_in * arr.shape[0])):]
        out[name] = {
            "mean": kept.mean(axis=(0, 1)),
            "std": kept.std(axis=(0, 1)),
            "rhat": potential_scale_reduction(kept),
            "ess": effective_sample_size(kept),
        }
    return out
