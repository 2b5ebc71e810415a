#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pyfilter_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # the phases below, on one card
    python3 chip_smoke.py --profile   # also: one traced main-path run

Phases, in order; any failure exits non-zero before the result line:

1. Device: requires CUDA; prints the card's name and power limit
   (``nvidia-smi``) and the torch and CUDA versions.
2. Build: compiles the port's CUDA source with ``nvcc`` into
   ``build/kernels/``.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at the edge cases, bit for bit.
4. Main path: bootstrap SISR on the stochastic-volatility model at
   N = 1e6, T = 200 observations (5 hidden sub-steps each): one warm-up run,
   then three timed runs with every kernel's launch count set to 0 before
   them. Checks a finite log-likelihood, that each kernel ran as often as
   the filter resampled (and more than 0 times), and that the estimate
   agrees with the mean of the port's CPU runs (plain versions) within
   ``LL_TOL``.
   Times each kernel on the main path's own data against its plain version,
   a one-call PyTorch yardstick and its memory bound.

Prints a ``{"kernels": [...]}`` line, then, as the last line,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

N_PARTICLES = 1_000_000
N_OBS = 200
DT = 0.2
OES = int(1.0 / DT)
KAPPA, GAMMA, SIGMA = 0.1, 1.0, 0.05
MU, NU, TAU = 0.0, 0.0, 1.0
N_TIMED = 3
# H100 SXM data sheet: 3.35 TB/s of HBM3
HBM_BYTES_PER_S = 3.35e12
# The CPU reference: the same filter through the plain versions, at
# N_CPU_REF particles, one run per seed, averaged. Its Monte Carlo standard
# deviation is about 0.015 nats per run at N = 65536 and the card's three
# runs at N = 1e6 spread about 0.007, so the gap between the two means has a
# standard deviation of about 0.006: LL_TOL is 3 run-deviations at
# N = 65536 plus the card's spread, about 9 of the gap's deviations.
LL_TOL = 0.05
N_CPU_REF = 1 << 16
N_CPU_SEEDS = 8


def simulate_obs(n_obs: int):
    """The stochastic-volatility observations, simulated on the host with
    numpy from seed 0 (the same simulator as ``bench.py``)."""
    import numpy as np

    rng = np.random.default_rng(0)
    vol = GAMMA
    ys = []
    for _ in range(n_obs):
        for _ in range(OES):
            vol = vol + KAPPA * (GAMMA - vol) * vol * DT + SIGMA * vol * math.sqrt(DT) * rng.normal()
            vol = max(vol, 1e-4)
        z = rng.normal()
        ys.append(MU + vol * math.sinh((math.asinh(z) + NU) * TAU))
    return np.asarray(ys, np.float32)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_cold(torch, fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn()`` on the card, timed with CUDA events,
    with the 50 MB L2 cache flushed before each launch (untimed)."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")  # 256 MB
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def check_expand(torch, expand) -> float:
    """Phase 3: the expand kernel against its plain version, bit for bit."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n_cases, worst = 0, 0.0
    for n in (1_000_000, 1_000_003, 257):
        ar = torch.arange(n, device=dev)
        weights = {"random": torch.randn(n, generator=g, device=dev) * 0.5,
                   "random-wide": torch.randn(n, generator=g, device=dev) * 2.0}
        for name, hot in (("hot-first", 0), ("hot-middle", n // 2), ("hot-last", n - 1)):
            weights[name] = torch.full((n,), -math.inf, device=dev).index_fill_(0, torch.tensor([hot], device=dev), 0.0)
        weights["zero-runs"] = torch.where(ar % 3 == 0, 0.0, -math.inf)
        for d in (1, 3):
            v2d = torch.randn(d, n, generator=g, device=dev)
            for name, lw in weights.items():
                for u in (float(torch.rand((), generator=g, device=dev)), 1.0):
                    probs = torch.softmax(lw, dim=0)
                    counts = expand._counts_from_probs(probs, torch.tensor(u, device=dev))
                    out, idx = expand.fused_expand(counts, v2d)
                    ref_out, ref_idx = expand._expand_plain(counts, v2d)
                    worst = max(worst, float((out - ref_out).abs().max()))
                    if not (torch.equal(idx, ref_idx) and torch.equal(out, ref_out)):
                        bad = int((idx != ref_idx).sum())
                        raise AssertionError(f"expand kernel != plain at n={n} d={d} {name} u={u}: {bad} indices differ")
                    n_cases += 1
    torch.cuda.synchronize()
    print(f"phase 3: expand kernel == plain version on {n_cases} cases (n in 1e6, 1e6+3, 257; d in 1, 3); "
          "tolerance: bit for bit (torch.equal), since indices are integers and the gather copies")
    return worst


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import pyfilter_tpu_torch as pt
    from pyfilter_tpu_torch.ops import _build, expand

    # -- 1. device --------------------------------------------------------
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
          f"devices {torch.cuda.device_count()}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    text = _build.build("expand", ptxas_info=True)
    print(f"phase 2: {'built expand.cu' if text is not None else 'expand.cu already built'} "
          f"in {time.perf_counter() - t0:.1f} s")
    for line in (text or "").splitlines():
        if "ptxas" in line and ("registers" in line or "spill" in line):
            print(f"  expand: {line.strip()}")

    # -- 3. kernels against their plain versions ----------------------------
    max_err = check_expand(torch, expand)

    # -- 4. main path -------------------------------------------------------
    y = simulate_obs(N_OBS)
    model = pt.examples.stochastic_volatility_model(KAPPA, GAMMA, SIGMA, MU, NU, TAU, dt=DT)
    filt = pt.SISR(model, N_PARTICLES, record_moments=False)
    warm = filt.batch_filter(torch.Generator(device="cuda").manual_seed(0), y)
    torch.cuda.synchronize()
    if not math.isfinite(float(warm.log_likelihood)):
        raise AssertionError(f"warm-up log-likelihood is {float(warm.log_likelihood)}")

    expand.fused_expand.launches = 0
    filt.n_resamples = 0
    times, lls = [], []
    for rep in range(N_TIMED):
        gen = torch.Generator(device="cuda").manual_seed(rep + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = filt.batch_filter(gen, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        lls.append(float(res.log_likelihood))
    launches, fires = expand.fused_expand.launches, filt.n_resamples
    if not all(math.isfinite(v) for v in lls):
        raise AssertionError(f"non-finite log-likelihood: {lls}")
    if not (launches == fires > 0):
        raise AssertionError(f"expand kernel launched {launches} times for {fires} resample fires")
    rate = N_PARTICLES * N_OBS * OES / min(times)
    print(f"phase 4: SISR N={N_PARTICLES} T={N_OBS} x{OES} sub-steps: log-likelihood {lls}")
    print(f"  run seconds {times}; particle-steps/s (best) {rate:.6g}; "
          f"resample fires {fires} in {N_TIMED} runs; expand launches {launches}")

    # the same filter on the CPU through the plain versions: estimates of
    # the same log-likelihood with independent randomness
    cpu_model = pt.examples.stochastic_volatility_model(KAPPA, GAMMA, SIGMA, MU, NU, TAU, dt=DT, device="cpu")
    cpu_lls = [float(pt.SISR(cpu_model, N_CPU_REF, record_moments=False, device="cpu")
                     .batch_filter(torch.Generator().manual_seed(seed), y).log_likelihood)
               for seed in range(N_CPU_SEEDS)]
    gap = abs(float(np.mean(lls)) - float(np.mean(cpu_lls)))
    print(f"  CPU reference (plain versions, N={N_CPU_REF}, {N_CPU_SEEDS} seeds): {cpu_lls}; "
          f"mean {float(np.mean(cpu_lls))}, sd {float(np.std(cpu_lls, ddof=1))}")
    print(f"  card runs: spread {max(lls) - min(lls)}; gap of the means {gap} (limit {LL_TOL})")
    if not gap < LL_TOL:
        raise AssertionError(f"card and CPU log-likelihoods differ by {gap} (> {LL_TOL})")

    # the host sync of the ESS gate: one scalar round trip per observation
    ess = torch.ones((), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        bool(ess < 0.5)
    sync_us = (time.perf_counter() - t0) * 1e3
    print(f"  ESS-gate compare + host sync on an idle stream: {sync_us:.3f} us each, "
          f"{sync_us * N_OBS / 1e3:.3f} ms per run of {N_OBS} observations")

    # the expand kernel on the main path's own data: the last cloud and weights
    state = res.latest_state
    probs = pt.normalize(state.log_weights)
    counts = expand._counts_from_probs(probs, torch.rand((), device="cuda"))
    v2d = state.x.value.reshape(1, -1).contiguous()
    n, d = N_PARTICLES, 1
    grid = torch.arange(n, dtype=torch.int32, device="cuda")
    ref_out, ref_idx = expand._expand_plain(counts, v2d)
    out, idx = expand.fused_expand(counts, v2d)
    lib_idx = torch.searchsorted(counts, grid, right=True, out_int32=True)
    torch.cuda.synchronize()
    err = float((out - ref_out).abs().max())
    if not (torch.equal(idx, ref_idx) and torch.equal(lib_idx, ref_idx) and err == 0.0):
        raise AssertionError("expand kernel, plain version and library call disagree on the main path's data")
    prep_ms = time_cold(torch, lambda: expand._counts_from_probs(probs, torch.rand((), device="cuda")))
    k_ms = time_cold(torch, lambda: expand.fused_expand(counts, v2d))
    p_ms = time_cold(torch, lambda: expand._expand_plain(counts, v2d))
    l_ms = time_cold(torch, lambda: v2d.index_select(1, torch.searchsorted(counts, grid, right=True, out_int32=True)))
    bound_ms = (4 * n + 4 * d * n + 4 * d * n + 4 * n) / HBM_BYTES_PER_S * 1e3
    print(f"  expand per fire (n={n}, d={d}, L2 flushed): kernel {k_ms} ms, plain {p_ms} ms, "
          f"library {l_ms} ms, bound {bound_ms} ms (bytes); card {card}")
    print(f"  resample prep per fire (cumsum, ceil, running max; L2 flushed): {prep_ms} ms; card {card}")

    if "--profile" in argv:
        profile_main_path(torch, filt, y)

    kernels = [{
        "name": "expand",
        "route": "cuda",
        "source": "pyfilter_tpu_torch/ops/csrc/expand.cu",
        "replaces": "pyfilter_tpu/ops/expand.py:110",
        "launches": launches,
        "max_abs_err": max(max_err, err),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": l_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


def profile_main_path(torch, filt, y):
    """One main-path run under ``torch.profiler``: device-busy time, idle
    share and the kernels by device time; the trace goes to ``chiprun_out/``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        filt.batch_filter(torch.Generator(device="cuda").manual_seed(9), y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    rows = sorted(((device_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(f"profile: wall {wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / 1e6 / wall:.4f} ({len(rows)} kernels by name)")
    for us, count, key in rows[:15]:
        if us:
            print(f"  {us / 1e3:10.3f} ms  x{count:<6d} {key[:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out", "main_path_trace.json"))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
