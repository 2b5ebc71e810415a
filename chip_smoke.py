#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pyfilter_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # the phases below, on one card
    python3 chip_smoke.py --profile   # also: one traced run of each main path

Phases, in order; any failure exits non-zero before the result line:

1. Device: requires CUDA; prints the card's name and power limit
   (``nvidia-smi``) and the torch and CUDA versions.
2. Build: compiles the port's CUDA sources with ``nvcc`` into
   ``build/kernels/``, one ``nvcc`` per source, all started together.
3. Kernels: each kernel (counts prep from probabilities and expansion)
   against its plain PyTorch version on the card, at the main paths' shapes
   and at the edge cases (degenerate, zero-run, uniform and sub-2^-60
   weights; uniforms 0, 2^-24, 0.5, 1-2^-24, 1), bit for bit.
4. Main path: bootstrap SISR on the stochastic-volatility model at
   N = 1e6, T = 200 observations (5 hidden sub-steps each): one warm-up run,
   then three timed runs with every kernel's launch count set to 0 before
   them. Checks a finite log-likelihood, that each kernel ran as often as
   the filter resampled (and more than 0 times), and that the estimate
   agrees with the mean of the port's CPU runs (plain versions) within
   ``LL_TOL``.
   Times the kernel on the main path's own data against its plain version,
   the PyTorch chain from probabilities (cumsum, ceil, searchsorted,
   index_select), its memory bound, the plain counts prep and the
   counts-only yardstick of earlier runs.
5. Lane-batched APF: the APF at N = 400 particles on K = 1000 lanes, every
   lane with the true parameters, over the same T = 200 observations: 1000
   independent log-likelihood estimates. Checks that the lane kernel ran
   once per APF step, and that the mean over lanes agrees with the same
   filter's on the CPU (plain versions) within 4 standard errors. Times the
   lane kernel on the last cloud as phase 4 times the expand kernel.
6. Main path 2: SMC² at ``bench.py``'s configuration (APF 400 x K = 1000
   parameter lanes, threshold 0.2, two PMMH steps, T = 200): one warm-up
   fit, then timed fits with every count set to 0 before them. Checks
   finite weights, that the lane kernel ran once per APF step (forward and
   re-filter), the posterior's bounds, and the gap to one fit on the CPU
   within ``POST_TOL_SD`` posterior standard deviations.

With ``--profile``, also the device operations per observation (main path
1) and per APF step (main path 2). Prints a ``{"kernels": [...]}`` line,
then, as the last line,
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
# the GPU spin that time_cold queues ahead of each timed call: about 1 ms at
# the H100's clocks, longer than the host takes to launch any timed function
SPIN_CYCLES = 2_000_000
# The CPU reference: the same filter through the plain versions, at
# N_CPU_REF particles, one run per seed, averaged. Its Monte Carlo standard
# deviation is about 0.015 nats per run at N = 65536 and the card's three
# runs at N = 1e6 spread about 0.007, so the gap between the two means has a
# standard deviation of about 0.006: LL_TOL is 3 run-deviations at
# N = 65536 plus the card's spread, about 9 of the gap's deviations.
LL_TOL = 0.05
N_CPU_REF = 1 << 16
N_CPU_SEEDS = 8
# main path 2: bench.py's SMC2 configuration
SMC2_N, SMC2_K, SMC2_STEPS, SMC2_THRESHOLD = 400, 1000, 2, 0.2
SMC2_TIMED = 2
# the card's posterior means against the CPU fit's, per parameter, in units
# of the larger of the two posterior standard deviations. Two card fits and
# one CPU fit (other seeds) gave gaps of 0.02-0.25 sd over the six
# parameters (12 readings), and the two card fits differ from each other by
# up to 0.2 sd: the limit is 4x the largest reading. A fit that reads the
# wrong history or drops the Jacobian moves gamma or tau by whole posterior
# standard deviations.
POST_TOL_SD = 1.0


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


def time_cold(torch, fn, reps: int = 20, spin: bool = True) -> float:
    """Median milliseconds of ``fn()`` on the card, timed with CUDA events,
    with the 50 MB L2 cache flushed before each launch (untimed). With
    ``spin``, a GPU spin of about 1 ms (``torch.cuda._sleep``) is queued
    between the flush and the start event, so the host has enqueued all of
    ``fn``'s work before the card reaches it: the time is the device's, not
    the host's launch cost. Without it (how earlier runs timed), a function
    whose launches take the host longer than the flush takes the card also
    counts the host's gaps."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")  # 256 MB
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# the uniforms where a wrong rounding shows: every n * cumw - u of uniform
# weights lies near an integer
EDGE_US = (0.0, 2.0**-24, 0.5, 1.0 - 2.0**-24, 1.0)


def edge_probs(torch, n: int, name: str, dev):
    """Probabilities ``(n,)`` where a wrong rounding or a missing pin shows:
    uniform, or masses below 2^-60 (no fixed-point mass) beside healthy ones."""
    if name == "uniform":
        return torch.full((n,), 1.0 / n, device=dev)
    p = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(n), device=dev) + 0.5
    p[::3] = 1e-20
    p[1::5] = 2.0**-61
    return p / p.sum()


def library_chain(torch, probs, u, v2d, grid):
    """The library yardstick from probabilities, single lane: float32
    ``torch.cumsum``, ``ceil(n * c - u)``, ``searchsorted``, ``index_select``
    (timed only here; its float sum is not the port's exact one)."""
    n = probs.shape[0]
    counts = torch.clamp(torch.ceil(n * torch.cumsum(probs, 0) - u), 0, n).to(torch.int32)
    return v2d.index_select(1, torch.clamp(torch.searchsorted(counts, grid, right=True, out_int32=True), max=n - 1))


def check_expand(torch, expand) -> float:
    """Phase 3: the expand kernel (counts prep and expansion) against its plain
    version, bit for bit: random, wide, degenerate and zero-run weights with a
    random u and u = 1; uniform and sub-2^-60 probabilities at the edge uniforms."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n_cases, worst = 0, 0.0
    for n in (1_000_000, 1_000_003, 8193, 257, 2, 1):
        ar = torch.arange(n, device=dev)
        weights = {"random": torch.randn(n, generator=g, device=dev) * 0.5,
                   "random-wide": torch.randn(n, generator=g, device=dev) * 2.0}
        for name, hot in (("hot-first", 0), ("hot-middle", n // 2), ("hot-last", n - 1)):
            weights[name] = torch.full((n,), -math.inf, device=dev).index_fill_(0, torch.tensor([hot], device=dev), 0.0)
        weights["zero-runs"] = torch.where(ar % 3 == 0, 0.0, -math.inf)
        cases = [(name, torch.softmax(lw, dim=0), u) for name, lw in weights.items()
                 for u in (float(torch.rand((), generator=g, device=dev)), 1.0)]
        cases += [(name, edge_probs(torch, n, name, dev), u) for name in ("uniform", "tiny") for u in EDGE_US]
        for d in (1, 3):
            v2d = torch.randn(d, n, generator=g, device=dev)
            for name, probs, u in cases:
                ut = torch.tensor(u, device=dev)
                out, idx = expand.fused_expand(probs, ut, v2d)
                ref_out, ref_idx = expand._expand_probs_plain(probs, ut, v2d)
                worst = max(worst, float((out - ref_out).abs().max()))
                if not (torch.equal(idx, ref_idx) and torch.equal(out, ref_out)):
                    bad = int((idx != ref_idx).sum())
                    raise AssertionError(f"expand kernel != plain at n={n} d={d} {name} u={u}: {bad} indices differ")
                n_cases += 1
    torch.cuda.synchronize()
    print(f"phase 3: expand kernel == plain version on {n_cases} cases (n in 1e6, 1e6+3, 8193, 257, 2, 1; "
          "d in 1, 3; random, degenerate, zero-run, uniform and sub-2^-60 probabilities; u random, "
          "0, 2^-24, 0.5, 1-2^-24, 1); tolerance: bit for bit (torch.equal), since indices are integers "
          "and the gather copies")
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
    from pyfilter_tpu_torch.ops.resample import copy_counts

    # -- 1. device --------------------------------------------------------
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
          f"devices {torch.cuda.device_count()}")

    # -- 2. build -----------------------------------------------------------
    for name, (text, seconds) in _build.build_all(ptxas_info=True).items():
        print(f"phase 2: {f'built {name}.cu' if text is not None else f'{name}.cu already built'} in {seconds:.1f} s")
        for line in (text or "").splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line):
                print(f"  {name}: {line.strip()}")

    # -- 3. kernels against their plain versions ----------------------------
    max_err = check_expand(torch, expand)
    lanes_err = check_expand_lanes(torch, expand)

    # -- 4. main path -------------------------------------------------------
    y = simulate_obs(N_OBS)
    model = pt.examples.stochastic_volatility_model(KAPPA, GAMMA, SIGMA, MU, NU, TAU, dt=DT)
    filt = pt.SISR(model, N_PARTICLES, record_moments=False)
    warm = filt.batch_filter(torch.Generator(device="cuda").manual_seed(0), y)
    torch.cuda.synchronize()
    if not math.isfinite(float(warm.log_likelihood)):
        raise AssertionError(f"warm-up log-likelihood is {float(warm.log_likelihood)}")

    expand.fused_expand.launches = expand.fused_expand_lanes.launches = 0
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
    u = torch.rand((), device="cuda")
    v2d = state.x.value.reshape(1, -1).contiguous()
    n, d = N_PARTICLES, 1
    grid = torch.arange(n, dtype=torch.int32, device="cuda")
    counts = copy_counts(probs, u)
    ref_out, ref_idx = expand._expand_probs_plain(probs, u, v2d)
    out, idx = expand.fused_expand(probs, u, v2d)
    lib_idx = torch.searchsorted(counts, grid, right=True, out_int32=True)
    chain_out = library_chain(torch, probs, u, v2d, grid)
    torch.cuda.synchronize()
    err = float((out - ref_out).abs().max())
    if not (torch.equal(idx, ref_idx) and torch.equal(lib_idx, ref_idx) and err == 0.0):
        raise AssertionError("expand kernel, plain version and library call disagree on the main path's data")
    k_ms = time_cold(torch, lambda: expand.fused_expand(probs, u, v2d))
    k_nospin_ms = time_cold(torch, lambda: expand.fused_expand(probs, u, v2d), spin=False)
    p_ms = time_cold(torch, lambda: expand._expand_probs_plain(probs, u, v2d))
    l_ms = time_cold(torch, lambda: library_chain(torch, probs, u, v2d, grid))
    prep_ms = time_cold(torch, lambda: copy_counts(probs, u))
    c_ms = time_cold(torch, lambda: v2d.index_select(1, torch.searchsorted(counts, grid, right=True, out_int32=True)))
    # probs, u and values read once, out and idx written once
    bound_ms = (4 * n + 4 + 4 * d * n + 4 * d * n + 4 * n) / HBM_BYTES_PER_S * 1e3
    print(f"  expand per fire from probabilities (n={n}, d={d}, L2 flushed): kernel {k_ms} ms, plain {p_ms} ms, "
          f"library chain (cumsum, ceil, searchsorted, index_select) {l_ms} ms, bound {bound_ms} ms (bytes), "
          f"{bound_ms / k_ms:.4f} of the bound; card {card}")
    print(f"  kernel timed without the spin (as earlier runs timed) {k_nospin_ms} ms; plain counts prep {prep_ms} ms; "
          f"counts-only yardstick (searchsorted + index_select on ready counts) {c_ms} ms; library chain's outputs "
          f"equal the kernel's at "
          f"{float((chain_out == out).float().mean()):.6f} of positions (float32 cumsum); card {card}")

    if "--profile" in argv:
        filt.n_resamples = 0
        ops = profile_run(torch, "main path 1",
                          lambda: filt.batch_filter(torch.Generator(device="cuda").manual_seed(9), y),
                          trace="main_path_trace.json")
        print(f"  device operations per observation {ops / N_OBS:.2f} ({filt.n_resamples} resample fires)")

    # -- 5. the lane-batched APF ---------------------------------------------
    lanes = apf_lanes(torch, pt, expand, copy_counts, y, card)

    # -- 6. main path 2: SMC2 ---------------------------------------------------
    lanes["launches"] = smc2(torch, pt, expand, y, card, profile="--profile" in argv)

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
    }, {
        "name": "expand_lanes",
        "route": "cuda",
        "source": "pyfilter_tpu_torch/ops/csrc/expand_lanes.cu",
        "replaces": "pyfilter_tpu/ops/expand.py:438, pyfilter_tpu/ops/expand.py:489",
        "launches": lanes["launches"],
        "max_abs_err": max(lanes_err, lanes["err"]),
        "ms": lanes["ms"],
        "plain_ms": lanes["plain_ms"],
        "bound_ms": lanes["bound_ms"],
        "bound_by": "bytes",
        "library_ms": lanes["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


def check_expand_lanes(torch, expand) -> float:
    """Phase 3: the lane kernel (counts prep and expansion) against its plain
    version, bit for bit, with weight scales 1 and 6, one degenerate lane per
    case (all mass on the first, middle or last particle), one lane of
    alternating zero-weight runs, one of uniform weights, random uniforms and
    the edge uniforms. n = 7104 keeps the counts in shared memory and n = 7105
    takes the kernel's global scratch route."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    n_cases, worst = 0, 0.0
    shapes = ((400, 1000), (257, 5), (40, 16), (72, 16), (800, 1000), (3200, 1000), (7104, 40), (7105, 40), (2, 9))
    for n, n_lanes in shapes:
        for d in (1, 2):
            planes = torch.randn(d, n, n_lanes, generator=g, device=dev)
            for scale in (1.0, 6.0):
                for hot in (0, n // 2, n - 1):
                    lw = torch.randn(n, n_lanes, generator=g, device=dev) * scale
                    lw[:, 0] = -math.inf
                    lw[hot, 0] = 0.0
                    lw[:, 1] = torch.where(torch.arange(n, device=dev) % 3 == 0, 0.0, -math.inf)
                    lw[:, 2] = 0.0
                    probs = torch.softmax(lw, dim=0)
                    us = [torch.rand(n_lanes, generator=g, device=dev)]
                    us += [torch.full((n_lanes,), u, device=dev) for u in (EDGE_US if hot == 0 else (1.0,))]
                    for u in us:
                        out, idx = expand.fused_expand_lanes(probs, u, planes)
                        ref_out, ref_idx = expand._expand_lanes_probs_plain(probs, u, planes)
                        worst = max(worst, float((out - ref_out).abs().max()))
                        if not (torch.equal(idx, ref_idx) and torch.equal(out, ref_out)):
                            bad = int((idx != ref_idx).sum())
                            raise AssertionError(f"lane kernel != plain at n={n} L={n_lanes} d={d} scale={scale} "
                                                 f"hot={hot}: {bad} indices differ")
                        n_cases += 1
    torch.cuda.synchronize()
    print(f"phase 3: lane kernel == plain version on {n_cases} cases ((n, L) in {', '.join(map(str, shapes))}; "
          "d in 1, 2; scales 1, 6; a degenerate lane, zero-weight runs, uniform weights, random u and u in "
          "0, 2^-24, 0.5, 1-2^-24, 1); tolerance: bit for bit (torch.equal)")
    return worst


def apf_lanes(torch, pt, expand, copy_counts, y, card) -> dict:
    """Phase 5: the APF at SMC2_N particles on SMC2_K lanes of the true
    parameters, on the card and on the CPU; then the lane kernel per fire."""
    import numpy as np

    def run(device, gen):
        model = pt.examples.stochastic_volatility_model(KAPPA, GAMMA, SIGMA, MU, NU, TAU, dt=DT, device=device)
        filt = pt.APF(model, SMC2_N, batch_shape=(SMC2_K,), record_moments=False, device=device)
        return filt, filt.batch_filter(gen, y)

    run("cuda", torch.Generator(device="cuda").manual_seed(0))  # warm-up
    expand.fused_expand.launches = expand.fused_expand_lanes.launches = 0
    pt.APF.corrections = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    filt, res = run("cuda", torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, steps = expand.fused_expand_lanes.launches, pt.APF.corrections
    card_ll = res.log_likelihood.cpu().numpy().astype(np.float64)
    cpu_ll = run("cpu", torch.Generator().manual_seed(2))[1].log_likelihood.numpy().astype(np.float64)
    if not (np.isfinite(card_ll).all() and np.isfinite(cpu_ll).all()):
        raise AssertionError("non-finite lane log-likelihoods")
    if not (launches == steps == N_OBS):
        raise AssertionError(f"lane kernel launched {launches} times for {steps} APF steps")
    gap = abs(card_ll.mean() - cpu_ll.mean())
    limit = 4 * math.sqrt(card_ll.var(ddof=1) / SMC2_K + cpu_ll.var(ddof=1) / SMC2_K)
    print(f"phase 5: APF N={SMC2_N} x K={SMC2_K} lanes, T={N_OBS}: {wall:.4f} s on the card; "
          f"lane kernel launches {launches} for {steps} APF steps")
    print(f"  log-likelihood over lanes: card mean {card_ll.mean()} sd {card_ll.std(ddof=1)}; "
          f"CPU (plain versions) mean {cpu_ll.mean()} sd {cpu_ll.std(ddof=1)}; gap {gap} (limit {limit})")
    if not gap < limit:
        raise AssertionError(f"card and CPU lane means differ by {gap} (> {limit})")

    # the lane kernel on the last cloud: state values and pre-weights, as the
    # APF's correction resamples them
    state = res.latest_state
    pre = filt.proposal.pre_weight(filt.model, torch.tensor(float(y[-1]), device="cuda"), state.x)
    probs = pt.normalize(pre + state.log_weights)
    planes = torch.stack([state.x.value, pre]).contiguous()
    n, d = SMC2_N, planes.shape[0]
    u = torch.rand(SMC2_K, device="cuda")
    counts = copy_counts(probs.T, u).contiguous()  # (L, n)
    grid = torch.arange(n, dtype=torch.int32, device="cuda").expand(SMC2_K, n).contiguous()

    def counts_only():
        lib_idx = torch.searchsorted(counts, grid, right=True)
        return torch.gather(planes, 1, lib_idx.T.unsqueeze(0).expand_as(planes))

    def library():
        """From probabilities: float32 cumsum, ceil(n * c - u), searchsorted, gather."""
        c = torch.cumsum(probs, 0).T.contiguous()
        lane_counts = torch.clamp(torch.ceil(n * c - u[:, None]), 0, n).to(torch.int32)
        lib_idx = torch.clamp(torch.searchsorted(lane_counts, grid, right=True), max=n - 1)
        return torch.gather(planes, 1, lib_idx.T.unsqueeze(0).expand_as(planes))

    out, idx = expand.fused_expand_lanes(probs, u, planes)
    ref_out, ref_idx = expand._expand_lanes_probs_plain(probs, u, planes)
    torch.cuda.synchronize()
    err = float((out - ref_out).abs().max())
    if not (torch.equal(idx, ref_idx) and torch.equal(counts_only(), ref_out) and err == 0.0):
        raise AssertionError("lane kernel, plain version and library call disagree on phase 5's cloud")
    chain_share = float((library() == out).float().mean())
    k_ms = time_cold(torch, lambda: expand.fused_expand_lanes(probs, u, planes))
    k_nospin_ms = time_cold(torch, lambda: expand.fused_expand_lanes(probs, u, planes), spin=False)
    p_ms = time_cold(torch, lambda: expand._expand_lanes_probs_plain(probs, u, planes))
    l_ms = time_cold(torch, library)
    prep_ms = time_cold(torch, lambda: copy_counts(probs.T, u))
    c_ms = time_cold(torch, counts_only)
    # probs, u and values read once, out and idx written once
    bound_ms = ((4 * n + 4 * d * n + 4 * d * n + 4 * n) * SMC2_K + 4 * SMC2_K) / HBM_BYTES_PER_S * 1e3
    print(f"  lane expand per fire from probabilities (n={n}, L={SMC2_K}, d={d}, L2 flushed): kernel {k_ms} ms, "
          f"plain {p_ms} ms, library chain (cumsum, ceil, searchsorted, gather) {l_ms} ms, bound {bound_ms} ms "
          f"(bytes), {bound_ms / k_ms:.4f} of the bound; card {card}")
    print(f"  kernel timed without the spin (as earlier runs timed) {k_nospin_ms} ms; plain counts prep {prep_ms} ms; "
          f"counts-only yardstick (searchsorted + gather on ready counts) {c_ms} ms; library chain's outputs "
          f"equal the kernel's at {chain_share:.6f} of positions (float32 cumsum); card {card}")
    return {"err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bound_ms}


def smc2(torch, pt, expand, y, card, profile: bool = False) -> int:
    """Phase 6: SMC2 at bench.py's configuration on the card (warm-up, then
    SMC2_TIMED timed fits) and once on the CPU; with ``profile``, one more
    card fit under the profiler. Returns the lane kernel's launches over the
    timed fits."""
    import numpy as np

    from pyfilter_tpu_torch import inference as inf

    def fit(device, seed):
        def gen(s):
            return torch.Generator(device=device).manual_seed(s)

        ctx = inf.make_context(generator=gen(seed), device=device)
        filt = pt.APF(pt.examples.stochastic_volatility_builder, SMC2_N, record_moments=False, device=device)
        alg = inf.SMC2(filt, SMC2_K, threshold=SMC2_THRESHOLD, num_steps=SMC2_STEPS, context=ctx,
                       generator=gen(seed + 1), record_moments=False, device=device)
        state = alg.fit(y)
        w = state.normalized_weights()
        stacked = ctx.stack_parameters(constrained=True)
        mean = w @ stacked
        sd = torch.sqrt(torch.clamp(w @ torch.square(stacked - mean), min=1e-12))
        if device == "cuda":
            torch.cuda.synchronize()
        if not bool(torch.isfinite(state.w).all()):
            raise AssertionError(f"non-finite SMC2 weights on {device}")
        return alg, dict(zip(ctx.parameters, mean.tolist())), dict(zip(ctx.parameters, sd.tolist()))

    fit("cuda", 0)  # warm-up
    expand.fused_expand.launches = expand.fused_expand_lanes.launches = 0
    pt.APF.corrections = 0
    walls, runs, syncs = [], [], []
    for rep in range(SMC2_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alg, mean, sd = fit("cuda", 10 * (rep + 1))
        walls.append(time.perf_counter() - t0)
        runs.append((mean, sd))
        k = alg.kernel
        syncs.append(alg.n_host_syncs + k.n_host_syncs)
        print(f"phase 6: SMC2 fit {rep}: {walls[-1]:.4f} s; rejuvenations {k.n_rejuvenations}, PMMH transitions "
              f"{k.n_transitions}, particle doublings {k.n_doublings} (state particles {alg.filter.n_particles}); "
              f"host syncs {syncs[-1]}")
        print(f"  posterior mean {mean}")
        print(f"  posterior sd   {sd}")
    launches, steps = expand.fused_expand_lanes.launches, pt.APF.corrections
    print(f"  SMC2 T={N_OBS}, APF {SMC2_N} x K={SMC2_K}, num_steps={SMC2_STEPS}, threshold {SMC2_THRESHOLD}: "
          f"wall seconds {walls} (best {min(walls)}); APF steps {steps} (forward + re-filter) and lane kernel "
          f"launches {launches} over {SMC2_TIMED} fits; card {card}")
    if not (launches == steps > 0):
        raise AssertionError(f"lane kernel launched {launches} times for {steps} APF steps")
    for mean, _ in runs:
        if not (0.3 < mean["gamma"] < 3.0 and 0.5 < mean["tau"] < 2.0):
            raise AssertionError(f"posterior means out of bounds: {mean}")

    t0 = time.perf_counter()
    _, cpu_mean, cpu_sd = fit("cpu", 10)
    print(f"  CPU fit (plain versions, seed of card fit 0): {time.perf_counter() - t0:.1f} s; "
          f"posterior mean {cpu_mean}; sd {cpu_sd}")
    for rep, (mean, sd) in enumerate(runs):
        gaps = {n: abs(mean[n] - cpu_mean[n]) / max(sd[n], cpu_sd[n]) for n in mean}
        print(f"  card fit {rep} vs CPU: |gap| / posterior sd {gaps} (limit {POST_TOL_SD})")
        if not max(gaps.values()) < POST_TOL_SD:
            raise AssertionError(f"card and CPU posterior means differ by more than {POST_TOL_SD} sd: {gaps}")

    if profile:
        steps = pt.APF.corrections
        ops = profile_run(torch, "main path 2", lambda: fit("cuda", 99))
        steps = pt.APF.corrections - steps
        print(f"  device operations per APF step {ops / steps:.2f} ({steps} APF steps in the traced fit)")

    # the per-step host syncs: one scalar read each, as the trigger makes it
    ess = torch.ones((), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        torch.stack([ess, ess]).tolist()
    sync_us = (time.perf_counter() - t0) * 1e3
    print(f"  trigger read + host sync on an idle stream: {sync_us:.3f} us each; {syncs} syncs per fit "
          f"cost about {[round(s * sync_us / 1e3, 3) for s in syncs]} ms")
    return launches


def profile_run(torch, label: str, fn, trace: str | None = None):
    """One run of ``fn`` under ``torch.profiler``: device-busy time, idle
    share and the kernels by device time; the trace, when named, goes to
    ``build/profile/`` (git-ignored). Returns the device operations traced
    (kernel launches and copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    rows = sorted(((device_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"profile ({label}): wall {wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / 1e6 / wall:.4f} ({len(rows)} kernels by name, {launches} launches)")
    for rank, (us, count, key) in enumerate(rows):
        if us and (rank < 15 or "expand" in key or "scan_counts" in key):  # the port's kernels always
            print(f"  {us / 1e3:10.3f} ms  x{count:<6d} {us / count:9.3f} us each  {key[:90]}")
    if trace:
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profile")
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, trace))
    return launches


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
