"""Back-to-back SISR ``batch_filter`` passes, each over its own series of the
pool, a new generator seed a pass. The check holds each sampled pass's
log-likelihood and last filtered mean against the reference's SISR on the
same series at the same particle count."""

from __future__ import annotations

import numpy as np
import torch

from .base import Driver, worst


class Filter(Driver):
    END_TO_END = ("sisr_particle_steps_per_s",)

    def configure(self):
        self.n = int(self.traffic["particles"])

    def setup(self):
        pt, tr = self.pt, self.traffic
        self.model = self.model_mod.model(pt, self.cfg, self.device)
        self.filt = pt.SISR(self.model, self.n, ess_threshold=float(tr["ess_threshold"]), record_moments=False,
                            device=self.device)
        self.sub = self.model.observe_every_step
        warm = int(tr["warmup_observations"])
        self.filt.batch_filter(self.generator(self.pass_seeds(None)[0]), self.dataset(0)[:warm])
        # a resample fire at the window's shape: the ESS gate may not fire in the warm-up
        probs = torch.full((self.n,), 1.0 / self.n, device=self.device)
        values = torch.zeros((1, self.n), device=self.device)
        pt.ops.expand.fused_expand(probs, torch.rand((), device=self.device), values)
        self.sync()

    def run_pass(self, i: int):
        res = self.filt.batch_filter(self.generator(self.pass_seeds(i)[0]), self.dataset(i))
        last = res.latest_state
        mean = torch.sum(self.pt.normalize(last.log_weights) * last.x.value)
        self.outputs.append(torch.stack([res.log_likelihood, mean]))
        self.sync()

    def counters(self) -> dict:
        return {"fires": self.filt.n_resamples}

    def observations(self, passes: int) -> int:
        return passes * self.t_obs

    def end_to_end(self, passes: int, elapsed: float) -> dict:
        # the first observation takes one propagation, every later one `sub`
        steps = self.n * (1 + (self.t_obs - 1) * self.sub) * passes
        return {"sisr_particle_steps_per_s": steps / elapsed}

    def finish(self) -> tuple:
        self.outputs = [[float(v) for v in o.tolist()] for o in self.outputs]
        failed = sum(not np.isfinite(o).all() for o in self.outputs)
        return len(self.outputs), failed

    def program_outputs(self, sample: list) -> list:
        return [self.outputs[i] for i in sample]

    def reference_outputs(self, sample: list, dtype, stream: int = 0) -> list:
        seeds = [self.reference_seed(i, stream) for i in sample]
        return [list(self.ref.sisr(self.cfg, self.dataset(i), self.n, self.generator(s), dtype=dtype,
                                   ess_threshold=float(self.traffic["ess_threshold"])))
                for i, s in zip(sample, seeds)]

    def compare(self, sample: list, outputs: list, limits: dict) -> list:
        ref = self.reference_outputs(sample, torch.float32)
        ll_gap = worst(abs(o[0] - r[0]) for o, r in zip(outputs, ref))
        mean_gap = worst(abs(o[1] - r[1]) for o, r in zip(outputs, ref))
        return [("loglik_gap", ll_gap, limits["loglik_gap"]), ("filtered_mean_gap", mean_gap, limits["filtered_mean_gap"])]


DRIVER = Filter
