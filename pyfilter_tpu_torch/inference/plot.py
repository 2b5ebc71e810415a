"""Posterior plotting: weighted univariate KDEs, one axis per parameter.

Counterpart of ``pyfilter_tpu/inference/plot.py`` (``weighted_gaussian_kde``,
``mimic_arviz_posterior``): numpy on the host, ``matplotlib`` imported only
when a figure is drawn. The port's context and state are read to the host
once.
"""

from __future__ import annotations

import math

import numpy as np


def weighted_gaussian_kde(x: np.ndarray, w: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Weighted Gaussian KDE of ``x`` under weights ``w``, on ``grid``, with
    Silverman's bandwidth on the weights' effective sample size."""
    w = w / w.sum()
    ess = 1.0 / np.sum(w**2.0)
    mean = np.sum(w * x)
    var = np.sum(w * (x - mean) ** 2.0)
    bw = 1.06 * math.sqrt(max(var, 1e-12)) * ess ** (-1.0 / 5)
    z = (grid[:, None] - x[None, :]) / bw
    return np.sum(w[None, :] * np.exp(-0.5 * z**2.0), axis=-1) / (bw * math.sqrt(2 * math.pi))


def mimic_arviz_posterior(context, state, num_cols: int = 3, ax=None, **kwargs):
    """A grid of weighted posterior KDEs, one axis per scalar parameter
    element; returns the figure (None when ``ax`` is given) and the axes."""
    import matplotlib.pyplot as plt

    w = state.normalized_weights().double().cpu().numpy()
    stacked = context.stack_parameters(constrained=True).double().cpu().numpy()

    labels = []
    for name in context.parameters:
        numel = math.prod(context.get_shape(name, constrained=True))
        labels.extend([name] if numel == 1 else [f"{name}[{i}]" for i in range(numel)])

    num_params = stacked.shape[-1]
    num_rows = (num_params + num_cols - 1) // num_cols
    fig = None
    if ax is None:
        fig, ax = plt.subplots(num_rows, num_cols, figsize=(4 * num_cols, 2.5 * num_rows))
    axes = np.atleast_1d(np.asarray(ax)).ravel()

    for i in range(num_params):
        x = stacked[:, i]
        lo, hi = np.quantile(x, [0.001, 0.999])
        span = max(hi - lo, 1e-9)
        grid = np.linspace(lo - 0.1 * span, hi + 0.1 * span, 256)
        axes[i].plot(grid, weighted_gaussian_kde(x, w, grid), **kwargs)
        axes[i].set_title(labels[i])
        axes[i].set_yticks([])
    for j in range(num_params, len(axes)):
        axes[j].axis("off")
    return fig, axes
