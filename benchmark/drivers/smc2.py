"""Back-to-back ``SMC2(APF).fit`` runs, each over its own series of the pool,
with fresh generator seeds a fit. A callback times every observation's
update from the previous callback (the first from the fit's start), with a
device sync in it. The check holds each sampled fit's posterior mean and sd
of every parameter, and the posterior mean of the lanes' log-likelihood,
against the reference's SMC2 on the same series at the same sizes."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .base import Driver, worst

PARAMETERS = ("kappa", "gamma", "sigma", "mu", "nu", "tau")


class SMC2(Driver):
    END_TO_END = ("smc2_obs_per_s",)

    def configure(self):
        self.lanes, self.n = int(self.traffic["lanes"]), int(self.traffic["particles"])

    def setup(self):
        from pyfilter_tpu_torch import inference

        self.inf = inference
        tr = self.traffic
        self.builder = self.model_mod.builder(self.pt, self.cfg)
        self.update_s: list = []
        self.apf_steps = self.host_syncs = self.doublings = 0
        self._last = 0.0
        self._fit(self.dataset(0)[: int(tr["warmup_observations"])], self.pass_seeds(None))
        self.update_s.clear()
        self.outputs.clear()
        self.sync()

    def _on_update(self, alg, y, state):
        self.sync()
        now = time.perf_counter()
        self.update_s.append(now - self._last)
        self._last = now

    def _fit(self, y, seeds):
        pt, tr, dev = self.pt, self.traffic, self.device
        corrections = pt.APF.corrections
        self._last = time.perf_counter()
        ctx = self.inf.make_context(generator=self.generator(seeds[0]), device=dev)
        filt = pt.APF(self.builder, self.n, record_moments=False, device=dev)
        alg = self.inf.SMC2(filt, self.lanes, threshold=float(tr["threshold"]), num_steps=int(tr["num_steps"]),
                            context=ctx, generator=self.generator(seeds[1]), record_moments=False, device=dev)
        alg.register_callback(self._on_update)
        state = alg.fit(y)
        w = state.normalized_weights()
        stacked = ctx.stack_parameters(constrained=True)
        mean = w @ stacked
        sd = torch.sqrt(torch.clamp(w @ torch.square(stacked - mean), min=1e-12))
        loglik = w @ torch.where(w > 0, state.filter_state.log_likelihood, 0.0)
        finite = torch.isfinite(state.w).all().to(mean.dtype)
        self.outputs.append((list(ctx.parameters), torch.cat([mean, sd, loglik[None], finite[None]])))
        self.apf_steps += pt.APF.corrections - corrections
        self.host_syncs += alg.n_host_syncs + alg.kernel.n_host_syncs
        self.doublings += alg.kernel.n_doublings
        self.sync()

    def run_pass(self, i: int):
        self._fit(self.dataset(i), self.pass_seeds(i))

    def counters(self) -> dict:
        return {"apf_steps": self.apf_steps, "host_syncs": self.host_syncs, "doublings": self.doublings}

    def diagnostics(self) -> dict:
        ms = np.asarray(self.update_s) * 1e3
        qs = (50, 90, 95, 97.5, 99, 100)
        return {"updates": len(ms), "update_ms": dict(zip(map(str, qs), np.percentile(ms, qs).round(4).tolist()))}

    def observations(self, passes: int) -> int:
        return passes * self.t_obs

    def end_to_end(self, passes: int, elapsed: float) -> dict:
        return {"smc2_obs_per_s": passes * self.t_obs / elapsed}

    def timings(self) -> dict:
        return {"update": list(self.update_s)}

    def finish(self) -> tuple:
        out = []
        for names, vec in self.outputs:
            v = vec.tolist()
            k = len(names)
            rec = {f"mean.{n}": v[j] for j, n in enumerate(names)}
            rec.update({f"sd.{n}": v[k + j] for j, n in enumerate(names)})
            rec["loglik"], rec["finite"] = v[2 * k], v[2 * k + 1]
            out.append(rec)
        self.outputs = out
        failed = sum(r["finite"] != 1.0 or not all(math.isfinite(x) for x in r.values()) for r in out)
        return len(out), failed

    def release(self):
        self.builder = None
        super().release()

    def program_outputs(self, sample: list) -> list:
        return [self.outputs[i] for i in sample]

    def reference_outputs(self, sample: list, dtype, stream: int = 0, filter_dtype=None) -> list:
        tr = self.traffic
        seeds = [self.reference_seed(i, stream) for i in sample]
        return [self.ref.smc2(self.cfg, self.dataset(i), self.lanes, self.n, self.generator(s), dtype=dtype,
                              threshold=float(tr["threshold"]), num_steps=int(tr["num_steps"]),
                              filter_dtype=filter_dtype)
                for i, s in zip(sample, seeds)]

    def control_outputs(self, sample: list) -> list:
        # every lane's filter in bfloat16, the lane weights and the PMMH moves
        # in float32: in bfloat16 throughout the lanes' log-likelihoods (about
        # -250) round to 1-2 nats, the acceptance stays under its threshold
        # and the fit raises after its fifth doubling of the particles
        return self.reference_outputs(sample, torch.float32, stream=1, filter_dtype=torch.bfloat16)

    def compare(self, sample: list, outputs: list, limits: dict) -> list:
        ref = self.reference_outputs(sample, torch.float32)
        pairs = [(o, r, p) for o, r in zip(outputs, ref) for p in PARAMETERS]
        mean_gap = worst(abs(o[f"mean.{p}"] - r[f"mean.{p}"]) / max(o[f"sd.{p}"], r[f"sd.{p}"]) for o, r, p in pairs)
        sd_gap = worst(abs(math.log(o[f"sd.{p}"] / r[f"sd.{p}"])) for o, r, p in pairs)
        ll_gap = worst(abs(o["loglik"] - r["loglik"]) for o, r in zip(outputs, ref))
        return [("posterior_mean_gap_sd", mean_gap, limits["posterior_mean_gap_sd"]),
                ("posterior_sd_log_ratio", sd_gap, limits["posterior_sd_log_ratio"]),
                ("posterior_loglik_gap", ll_gap, limits["posterior_loglik_gap"])]


DRIVER = SMC2
