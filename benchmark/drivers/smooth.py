"""Back-to-back passes of SISR with recorded states, then rejection FFBSi
over the history, each over a series of the pool. The check holds each
sampled pass's log-likelihood against the exact Kalman filter's, and the
mean over its smoothed trajectories of the additive functional ``sum_t
x_{t-1} x_t`` against its exact expectation under the Rauch-Tung-Striebel
smoother: a number that reads the trajectories' joint law, not only their
marginal means."""

from __future__ import annotations

import numpy as np
import torch

from .base import Driver, worst


class Smooth(Driver):
    END_TO_END = ("smooth_draws_per_s",)

    def configure(self):
        self.n, self.m = int(self.traffic["particles"]), int(self.traffic["trajectories"])

    def setup(self):
        from pyfilter_tpu_torch.filters.particle.smoothing import ffbsi_smooth, transition_log_sup

        self.ffbsi = ffbsi_smooth
        tr = self.traffic
        self.model = self.model_mod.model(self.pt, self.cfg, self.device)
        self.log_sup = transition_log_sup(self.model)
        self.filt = self.pt.SISR(self.model, self.n, record_states=True, record_moments=False, device=self.device)
        self.backward_steps = 0
        gen = self.generator(self.pass_seeds(None)[0])
        res = self.filt.batch_filter(gen, self.dataset(0)[: int(tr["warmup_observations"])])
        last = int(tr["warmup_backward_steps"])
        self._smooth(gen, type(res.states)(*(leaf[-last:] for leaf in res.states)))
        self.backward_steps = 0
        self.sync()

    def _smooth(self, gen, history):
        self.backward_steps += history.values.shape[0] - 1
        return self.ffbsi(gen, self.model, history, self.filt.resampler, log_density_sup=self.log_sup,
                          n_trajectories=self.m)

    def run_pass(self, i: int):
        gen = self.generator(self.pass_seeds(i)[0])
        res = self.filt.batch_filter(gen, self.dataset(i))
        traj = self._smooth(gen, res.states)
        lag_product = self.ref.lag_product(traj)
        self.outputs.append(torch.stack([res.log_likelihood.to(torch.float64), lag_product]))
        self.sync()

    def counters(self) -> dict:
        return {"fallback_passes": self.ffbsi.fallback_passes, "backward_steps": self.backward_steps,
                "fires": self.filt.n_resamples}

    def observations(self, passes: int) -> int:
        return passes * self.t_obs

    def end_to_end(self, passes: int, elapsed: float) -> dict:
        return {"smooth_draws_per_s": passes * (self.t_obs + 1) * self.m / elapsed}

    def finish(self) -> tuple:
        self.outputs = [o.cpu().numpy() for o in self.outputs]
        failed = sum(not np.isfinite(o).all() for o in self.outputs)
        return len(self.outputs), failed

    def release(self):
        self.ffbsi = None
        super().release()

    def program_outputs(self, sample: list) -> list:
        return [self.outputs[i] for i in sample]

    def reference_outputs(self, sample: list, dtype, stream: int = 0) -> list:
        out = []
        for i in sample:
            ll, lag_product = self.ref.kalman_rts(self.cfg, self.dataset(i), dtype=dtype)
            out.append(np.array([ll, lag_product]))
        return out

    def compare(self, sample: list, outputs: list, limits: dict) -> list:
        ref = self.reference_outputs(sample, torch.float64)
        ll_gap = worst(abs(o[0] - r[0]) for o, r in zip(outputs, ref))
        lag_gap = worst(abs(o[1] - r[1]) for o, r in zip(outputs, ref))
        return [("loglik_gap", ll_gap, limits["loglik_gap"]),
                ("smoothed_lag_product_gap", lag_gap, limits["smoothed_lag_product_gap"])]


DRIVER = Smooth
