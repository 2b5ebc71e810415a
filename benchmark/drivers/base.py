"""What every driver shares: seeds, the data pool, the device sync and the
sample of passes the check compares."""

from __future__ import annotations

import math

import numpy as np
import torch


def worst(values) -> float:
    """The largest of ``values``; infinite where one is not a finite number."""
    values = [float(v) for v in values]
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


class Seeds:
    """Independent streams from the run's ``--seed`` (any whole number):
    the order of the series, the program's generators, the reference's and
    the sample of passes checked."""

    def __init__(self, seed: int):
        self.data, self.program, self.reference, self.sample = np.random.SeedSequence(int(seed)).spawn(4)

    @staticmethod
    def torch_seeds(seq: np.random.SeedSequence, n: int) -> list:
        return [int(s) for s in seq.generate_state(n, np.uint64) >> np.uint64(1)]


class Driver:
    """One cell's work. ``setup`` builds the data and the program and warms
    every shape the window uses; ``run_pass(i)`` runs pass ``i`` of the
    window and waits for the device; after the window, ``finish`` reads the
    passes' outputs to the host, ``release`` frees the program's state and
    ``compare`` holds a sample of the outputs against the reference."""

    #: end-to-end metrics this driver computes
    END_TO_END: tuple = ()

    def __init__(self, pt, cfg: dict, traffic: dict, model_mod, ref_mod, device: str, seed: int):
        self.pt, self.cfg, self.traffic = pt, cfg, traffic
        self.model_mod, self.ref = model_mod, ref_mod
        self.device = torch.device(device)
        self.seeds = Seeds(seed)
        self.t_obs = int(cfg["observations"])
        # every seed filters the same series (the traffic's data seed), each
        # in its own order, so that the seed does not change the work
        self.data = ref_mod.simulate(cfg, np.random.default_rng(int(traffic["data_seed"])), int(traffic["datasets"]))
        order = np.random.default_rng(self.seeds.data)
        self.order = order.permutation(len(self.data))
        self.seed_order = order.permutation(int(traffic.get("pass_seeds", 1)))
        # a window runs whole rounds of the pool, so every run does the same work
        self.round_passes = int(traffic.get("pass_seeds", 1))
        self.outputs: list = []
        self.configure()

    def configure(self):
        """Read the traffic mix's sizes (before ``setup``; the control
        compares without building the program)."""

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def pass_seeds(self, i: int) -> list:
        """Pass ``i``'s generator seeds, the same in every run of one seed;
        ``i = None`` gives the warm-up's. Where the traffic mix names a
        pool of ``pass_seeds``, every run draws them from that pool (fixed
        by the ``data_seed``), each seed in its own order, and the window
        runs whole rounds of it: every run then fits the same set."""
        if i is None:
            return Seeds.torch_seeds(np.random.SeedSequence(self.seeds.program.entropy, spawn_key=(4,)), 2)
        pool = self.traffic.get("pass_seeds")
        if pool is None:
            return Seeds.torch_seeds(np.random.SeedSequence(self.seeds.program.entropy, spawn_key=(1, i)), 2)
        j = int(self.seed_order[i % len(self.seed_order)])
        return Seeds.torch_seeds(np.random.SeedSequence(int(self.traffic["data_seed"]), spawn_key=(1, j)), 2)

    def reference_seed(self, i: int, stream: int = 0) -> int:
        """The reference's generator seed for pass ``i``: stream 0 for the
        check, 1 for the control."""
        return Seeds.torch_seeds(np.random.SeedSequence(self.seeds.reference.entropy, spawn_key=(2 + stream, i)), 1)[0]

    def dataset(self, i: int) -> np.ndarray:
        return self.data[self.order[i % len(self.data)]]

    def sample(self, passes: int) -> list:
        """The passes the check compares, drawn from the seed."""
        k = min(int(self.traffic["checked_passes"]), passes)
        return sorted(int(i) for i in np.random.default_rng(self.seeds.sample).choice(passes, size=k, replace=False))

    def control_outputs(self, sample: list) -> list:
        """The control's outputs of the passes ``sample``: the reference in
        the program's place, a precision below the configuration's."""
        return self.reference_outputs(sample, torch.bfloat16, stream=1)

    def release(self):
        """Drop the program's objects and cached device memory."""
        for name in ("filt", "model", "log_sup"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def counters(self) -> dict:
        return {}

    def timings(self) -> dict:
        """Host-clock seconds of the window's events, by kind, for the
        per-layer readers."""
        return {}

    def diagnostics(self) -> dict:
        """Readings of the window printed on standard error, for a reader of the run."""
        return {}
