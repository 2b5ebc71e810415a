"""The cells at sizes a CPU test run holds, with limits for those sizes.

Each limit was set from CPU readings at these sizes and seeds (5, 6, 7):
above the sound runs' largest reading, below every planted fault's and
the control's in at least one number (``test_bench_faults.py``)."""

from __future__ import annotations

from benchmark import spec

SIZES = {
    # traffic overrides, observations
    "sv-notebook.filter-n1e7": ({"particles": 20000, "checked_passes": 1}, 30),
    "ar1-gauss.smooth-ffbsi-n1e5": ({"particles": 2000, "trajectories": 2000, "checked_passes": 1}, 30),
    "sv-notebook.smc2-k16384": ({"lanes": 512, "particles": 64, "checked_passes": 1, "warmup_observations": 5,
                                 "pass_seeds": 2}, 100),
}

# sound runs read at most: filter 0.015 / 0.0013; smoothing 0.17 / 0.089;
# SMC2 0.24 / 0.27 / 0.22
LIMITS = {
    "sv-notebook.filter-n1e7": {"loglik_gap": 0.04, "filtered_mean_gap": 0.01},
    "ar1-gauss.smooth-ffbsi-n1e5": {"loglik_gap": 0.5, "smoothed_lag_product_gap": 0.5},
    "sv-notebook.smc2-k16384": {"posterior_mean_gap_sd": 0.45, "posterior_sd_log_ratio": 0.5,
                                "posterior_loglik_gap": 0.45},
}


def cell(name: str) -> spec.Cell:
    c = spec.Cell(name)
    traffic, t_obs = SIZES[name]
    c.traffic.update(traffic)
    c.config = dict(c.config, observations=t_obs)
    c.limits = dict(LIMITS[name])
    return c
