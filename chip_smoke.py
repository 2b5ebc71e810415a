#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pyfilter_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # the phases below, on one card
    python3 chip_smoke.py --profile   # also: one traced run of each main path
    python3 chip_smoke.py --ness-spread [CARD_FITS [CPU_FITS]]   # phase 9's seed sweep only
    python3 chip_smoke.py --apf-bias [SEEDS]   # phase 5's APF over more seeds only
    python3 chip_smoke.py --oracle    # phases 1-3 and 12 only
    python3 chip_smoke.py --gradients # phases 1-3 and 13 only
    python3 chip_smoke.py --backward  # phases 1-3 and 13a only
    python3 chip_smoke.py --streaming # phases 1-3 and 14 only
    python3 chip_smoke.py --batch     # phases 1-3 and 15 only
    python3 chip_smoke.py --backward-ab TREE   # TREE's backward kernels against these, one card

Phases, in order; any failure exits non-zero before the result line:

1. Device: requires CUDA; prints the card's name and power limit
   (``nvidia-smi``) and the torch and CUDA versions.
2. Build: compiles the port's CUDA sources with ``nvcc`` into
   ``build/kernels/``, one ``nvcc`` per source, all started together.
3. Kernels: each kernel (counts prep from probabilities and expansion)
   against its plain PyTorch version on the card, at the main paths' shapes
   (each kernel with d = 1, 2 and 3 value planes) and at the edge cases
   (degenerate, zero-run, uniform and sub-2^-60 weights; uniforms 0, 2^-24,
   0.5, 1-2^-24, 1), bit for bit.
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

7. The reference README's flagship flow: ``sine_diffusion_model(dt=0.05)``
   observed T = 500 times (``sample_states`` on the CPU, seed 0, so the truth
   is known), ``APF(N = 1000, proposal=LinearGaussianObservations(),
   record_states=True)`` on the card (FLAG_RUNS runs), then exact FFBS (an
   (N, N) weight matrix per step) and fixed-lag smoothing of the last run.
   Checks a finite log-likelihood, filter RMSE against the truth below
   ``FLAG_RMSE_MAX``, FFBS RMSE no worse than the filter's, the card's mean
   log-likelihood within 4 standard errors of FLAG_RUNS CPU runs' (plain
   versions), the expand kernel launched once per APF step, and the kernel
   equal to its plain version on the last run's cloud.
8. Rejection FFBSi over a recorded SISR history of ``LinearStateSpaceModel(
   AR(0.2, 0.7, 0.4), (1.0, 0.25))``, T = 200: N = 1e5 with M = N
   trajectories, and N = 1e6 with M = 4096 (``systematic_m``). Each: one
   warm-up pass and FFBSI_TIMED timed passes; checks the smoothed means at
   every t >= 1 against a float64 RTS smoother within ``4.5 sqrt(max var /
   M) + 0.02``, no NaN (the bound guard quiet), and the expand kernel
   launched once per resample fire (more than 0). Prints the wall per pass,
   trajectory draws/s, host syncs and fallback passes per pass, and the peak
   device memory. Then SISR over 8 lanes of 400 particles through the lane
   kernel, smoothed by FFBSi over lanes against the same smoother. Each
   kernel equals its plain version on each run's last cloud.

9. Online parameter inference on the Lorenz-63 model (``examples/
   lorenz_ness.py`` at full size, the reference's ``lorenz.ipynb``): the
   LORENZ_T = 300 observed rows of ``lorenz63_model().sample_states`` (CPU,
   seed 0), ``NESS(SISR(lorenz63_builder, 400), 1000)`` on the card (a
   warm-up, then one timed fit per seed of NESS_SEEDS): finite weights, the
   lane kernel launched once per SISR lane step (d = 3), equal to its plain
   version on the last cloud, and a count of fits that find the truth within
   the range that the JAX package's fits give. Then NESSMC2 and SMC2FW at
   their defaults (switch 50, block 10) over the first 100 observations: finite weights, the switch after observation 50, SMC2FW's
   second stage firing on its block schedule. Last, one CPU fit: the
   card's fits that find the truth land where the JAX package's and the
   CPU fit's do (``NESS_TOL_SE``).

10. The reference notebook's SMC2 (``examples/stochastic_volatility_smc2.py``
   at full size, the reference's ``stochastic-volatility.ipynb``): NB_T = 500
   observations of phase 4's simulator, ``SMC2(APF(stochastic_volatility_
   builder, 400), 1000, num_steps=5, distance_threshold=0.025)`` from a Sobol
   start (``make_context(use_quasi=True)``) on the card, a warm-up and
   NB_TIMED timed fits: finite weights, the lane kernel launched once per APF
   step and equal to its plain version on the last cloud, the distance stop
   firing, the Sobol start's moments against the priors', gamma and tau in
   phase 6's bounds, and each posterior mean within NB_TOL_SD spreads
   between seeds of the JAX package's fits of the same configuration
   (NB_JAX).
11. Batch PMMH (``examples/batch_inference_zoo.py`` part 1 at full width,
   num_samples cut to 150): ``PMMH(SISR(AR model, 300), 150, num_chains=4,
   RandomWalk(0.08), initializer="seed")`` over T = 400 observations of the
   AR model on the card: finite chains, the lane kernel launched once per
   SISR lane step (chains' re-filters and the seed pass over 200 lanes) and
   equal to its plain version on the last cloud of each, the pooled
   post-burn-in means within PMMH_TOL_SD posterior sds of the exact
   posterior (a float64 Kalman likelihood on a grid), and one more
   transition that accepts and rejects as the host's float64 log-ratio
   (priors with their Jacobians) says, its kernel following the chain. Then
   one SISR step at N = 2^24 on one lane: past the expand kernel's size
   limit it resamples through its resampler and a gather, and the kernel
   does not launch.

12. The reference's linear-Gaussian oracle suite (BASELINE.md workload 5):
   every filter of the JAX package's ``tests/test_filters.py`` table (SISR,
   APF and GPF with the bootstrap, linear, linearized, damped-Newton,
   nested and Gaussian-approximate proposals) at N = 1500 over T = 100
   observations of ``"ar"`` (13 filters), ``"rw2d"`` and ``"joint2d"`` (9
   each), and the bootstrap SISR and linear APF over 3 lanes with and
   without 10 missing rows, each against a float64 Kalman filter under the
   reference's gates (median relative deviation of the means and relative
   log-likelihood error below 0.1); LocalLinearization (SISR and the APF,
   with and without the derivative, 1000 particles) against a 20000-particle
   bootstrap SISR on the nonlinear benchmark model. Four configurations'
   card log-likelihoods against 8 CPU runs each (worker processes, while the
   card runs) within 4 standard errors; the expand kernel as often as each
   run resamples, the lane kernel likewise on the lanes, neither in a GPF
   run; both kernels equal to their plain versions on the suite's clouds (a
   2-D one among them); the host syncs a step of the damped-Newton filters
   by source.

13. Gradients through the filter (float64 host oracles, TF32 off):
   (a) both backward kernels (the scatter-add transposes of the two gathers)
   at phase 3's shapes, the main paths' and this phase's, degenerate clouds
   among them, and on indices built directly (``backward_indices``: runs and
   gaps at the kernels' tile and chunk edges, n around one tile, lanes past
   the staged rows, L in 1, 7, 9): the same bits at two launches, each source
   within 1e-6 of its run's sum of |g| of a float64 index_add_, the forward
   kernels still bit for bit their plain versions; each timed at the main
   paths' shapes against its bound and index_add_ (scatter_add_ for lanes),
   on a degenerate cloud beside the library call on it, and at the gradient
   paths' shapes (13b, 13c); one differentiable SISR step at N = 1e6 on a
   collapsed cloud, forward and backward, on the host clock.
   (b) ``tests/test_differentiable.py``'s score gate at its own size
   (AR(1), T = 40, N = 512, beta0 = 0.6): the mean gradient of the
   differentiable SISR (a resample every step) and APF over 64 seeds of one
   lane and over one run of 64 lanes within 4 SEM + 5% of the float64 Kalman
   score, the backward kernels launched once per resample whose gathered
   values carry a gradient, the uncorrected SISR gradient further off. (c) ``fit_mle`` at
   ``test_fit_mle_recovers_beta``'s size within 0.08 of the float64 Kalman
   MLE. (d) The reference's nutria notebook (``fit_svi``, APF(300), T = 100,
   500 Adam steps, 4 ELBO samples) from the priors' means: a lower loss, a
   finite guide, each posterior median within NUTRIA_TOL sds between seeds
   of the JAX package's fits (NUTRIA_JAX), one guide sd at least. (e) PMMH on the OU model with the gradient
   proposal of both orders and the random walk: finite moving chains, one
   more MALA transition of each order deciding as the host's float64
   log-ratio (the Hastings term from both kernels) says, MSJD, R-hat, ESS.

14. Online smoothing and streaming maximum likelihood (the JAX package's
   ``tests/test_score.py`` and ``tests/test_smoothing_ffbsi.py`` at their
   sizes; TF32 off). (a) ``fit_mle_streaming`` over T = 10,000 observations of
   an AR(1) (SISR(500), one Adam step per window of 50, lr 2e-2, from beta
   0.3, sigma 0.7): the fit within STREAM_TOL of the truth, finite window
   log-likelihoods, a path of 200 rows, K1 once per resample fire; the wall,
   ms a window and host syncs an observation by source. (b) ``online_score``
   at N = 1e5, T = 200, 8 seeds: each run within rel 0.18 / abs 2.5 of the
   float64 Kalman score (in beta and log sigma), their mean within 4 SEM + 5%
   (one more run at the default 16 rejection rounds of the backward kernel,
   the 8 seeds at ONLINE_ROUNDS); K1 on the last cloud; ms and syncs an observation, peak memory; the
   transition's score functional by ``vmap(grad)`` and by ``jacfwd`` on one
   cloud. (c) PaRIS on the stochastic-volatility model (5 sub-steps, N = 1000,
   30 observations, the caller's bound) within 15% + 0.5 of FFBSi's functional
   over a recorded-intermediary history, and on phase 8's AR model (N = 3000)
   against the RTS smoother's sum. (d) SISR with ``stratified``,
   ``multinomial``, ``residual``, ``metropolis`` and ``rejection`` at N = 1e5
   on phase 12's ``"ar"`` under its Kalman gate, and ``residual`` and
   ``stratified`` over 400 x 1000 lanes, with no kernel launch; ms and host
   syncs a fire. (e) TrendingOU's reversion and UCSV's volatility and level
   gates; SISR at N = 1e5, T = 200 on LLT and the cycle (Kalman gate, d = 2
   planes), TrendingOU and UCSV, K1 once per fire and equal to its plain
   version on each last cloud. (f) ``step`` equal to ``filter``,
   ``batch_filter_masked`` on padded rows equal to ``batch_filter`` of the
   first 137 (N = 1e5), ``lane_concat`` and ``resample_particles``.

15. The batch-inference zoo (``examples/batch_inference_zoo.py`` parts 2-4 at
   the example's full width, on phase 11's model and T = 400 observations;
   TF32 off). (a) ``TemperedSMC(SISR(300), 600)`` at its defaults: the ladder
   rising strictly to 1, each posterior mean within ZOO_POST_SD swarm sds of
   the exact grid posterior's, the log evidence within ZOO_EVIDENCE_NATS of
   the grid's (the priors' constants and the cell widths in). (b)
   ``IF2(SISR(300), 600, 25 passes, sigma 0.1, cooling 0.88)``: the MLE within
   ZOO_MLE_TOL of the grid's, the last 3 passes' log-likelihoods above the
   first 3, the final swarm's beta sd under ZOO_SWARM_SD; host syncs a lane
   step by source. Both fits within ZOO_JAX_TOL spreads between seeds of the
   JAX package's fits of the same configuration (ZOO_JAX), the lane kernel
   once per SISR lane step and equal to its plain version on each fit's last
   cloud. (c) ``predictive_pit`` and ``crps`` of ``SISR(fitted, 300,
   record_states=True)`` on a second series: PIT in [0, 1] with mean and
   variance near the uniform's, the CRPS mean near the closed-form Gaussian
   CRPS under the fitted model's float64 Kalman predictive, the expand
   kernel once per resample fire and equal to its plain version on the last
   cloud. Prints each fit's wall, ms a lane step and the ladder.

``--host-probe TREE`` times, with TREE's package and TREE's own phase-11
fit (``pmmh_fit``), the host time of a lane resample-and-gather call at
phase 11's shape and one phase-11 fit, and prints them as one JSON line; run
it over two trees in alternating order to compare them on one card.

``--backward-ab TREE`` builds TREE's two backward kernels from its sources
and times them against this tree's in turns on one card (phase 13a's
shapes, the gradient paths', degenerate clouds, the collapsed SISR step)
and prints one JSON line; ``--backward`` runs phases 1-3 and 13a only.

``--ness-spread`` runs only phase 9's seed sweep (card and CPU fits and the
gaps between them). ``--apf-bias [SEEDS]`` runs only phase 5's APF over
SEEDS seeds (16 by default) on the card and on the CPU.

With ``--profile``, also the device operations per observation (main path
1 and phase 9), per APF step (main path 2, phases 7 and 10), per backward
step of FFBS (phase 7) and FFBSi (phase 8), per NESS rejuvenation (phase 9)
and per SISR lane step (phase 11, one TemperedSMC stage's MH refresh and one
IF2 pass of phase 15) and filter step (phase 12's damped-Newton
filters) and per observation of two streaming windows (phase 14a), each from
one traced run, and the host
time of one notebook rejuvenation with and without the distance stop.
Prints a ``{"kernels": [...]}`` line, then, as the last line, ``{"ok":
true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

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
# the CPU references of phases 4, 6 and 9 run in worker processes beside the
# card's phases from the start: phase 6's fit on 3 torch threads and phase 9's
# on 2, submitted first, phase 4's eight runs on 1 each on the other two
CPU_REF_WORKERS = 4
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
# phase 7: examples/sine_apf.py's full size; the filter RMSE limit is twice
# the observation noise (the reference's health check: the filter tracks at
# the observation scale, not the prior's)
FLAG_N, FLAG_T, FLAG_DT, FLAG_RUNS = 1000, 500, 0.05, 8
FLAG_RMSE_MAX = 0.2
# phase 8: tools/round4_perf.py's FFBSi configuration (N, M) and the lane run
AR_ALPHA, AR_BETA, AR_SIGMA, AR_OBS_S = 0.2, 0.7, 0.4, 0.25
FFBSI_T = 200
FFBSI_SIZES = ((100_000, None), (1_000_000, 4096))
# one timed pass a size: a pass is device-bound and repeats within 0.5% (7.61-7.65 s at N = 1e5)
FFBSI_TIMED = 1
LANES_N, LANES_K = 400, 8
# phase 9: examples/lorenz_ness.py's full size (the reference's lorenz.ipynb):
# SISR 400 x K = 1000 parameter lanes, 10 sub-steps, T = 300 observations
LORENZ_N, LORENZ_K, LORENZ_T, LORENZ_OES = 400, 1000, 300, 10
LORENZ_TRUE = {"s": 10.0, "r": 28.0, "b": 8.0 / 3.0}
# The NESS posterior over seeds is bimodal on this workload: one observation
# drops the parameter ESS to about 1, and from there some fits find the truth
# (posterior sd of s about 0.15) while the rest freeze near another point
# (posterior sds below 0.02). A fit finds the truth when each posterior mean
# lies within 1% of its Uniform prior's width (35, 40, 19) of the true value.
# Of the JAX package's 32 fits below, those that find it lie within 0.7% of
# the width and the others 1.2-59% away in at least one parameter.
NESS_FOUND_WITHIN = {"s": 0.35, "r": 0.40, "b": 0.19}
# The card fits one NESS per seed of NESS_SEEDS (fixed, not picked by
# outcome), and the port's CPU fit is the sweep's first seed. The JAX
# package's fits at this configuration on the CPU (seeds 10-320;
# ``tests/test_torch_port_ness.py`` run as a script; PERF.md) are the
# reference: 11 of 32 find the truth. NESS_FOUND_RANGE holds the counts among
# the 16 card fits that a two-sided Fisher exact test at 1% does not set
# apart from that. Fits that find the truth still differ between seeds by up
# to 7.7 of their posterior sds (the JAX readings), so they are compared in
# units of the spread between seeds of the JAX fits' posterior means
# (JAX_FOUND: its mean and that spread, per parameter): the mean over the
# card's fits that find the truth within NESS_TOL_SE standard errors of the
# JAX fits' mean and of the CPU fit, which must find the truth too.
NESS_SEEDS, NESS_CPU_SEED = tuple(range(10, 170, 10)), 10
NESS_FOUND_RANGE = (1, 12)
JAX_FOUND_N = 11
JAX_FOUND = {"s": (9.998362941359614, 0.09619523072211195), "r": (27.942921450997407, 0.021936274311088664),
             "b": (2.64768846316189, 0.03919174652425058)}
NESS_TOL_SE = 4.0
HYBRID_T, HYBRID_SWITCH, HYBRID_BLOCK = 100, 50, 10
# phase 10: examples/stochastic_volatility_smc2.py at full size (the
# reference's stochastic-volatility notebook): SMC2(APF 400) x K = 1000,
# five PMMH steps with the adaptive distance stop, a Sobol start, T = 500
NB_N, NB_K, NB_T, NB_STEPS, NB_DISTANCE = 400, 1000, 500, 5, 0.025
NB_TIMED = 2
# The JAX package's fits at this configuration on the CPU (its own Sobol
# engine, seeded per fit; ``tests/test_torch_port_quasi.py`` run as a script,
# seeds 10-160; PERF.md): per parameter the mean over fits of the posterior
# mean and its spread between seeds. Each card fit's posterior mean must lie
# within NB_TOL_SD JAX spreads, scaled by sqrt(1 + 1 / NB_JAX_N) (the spread
# of one new fit about a mean of NB_JAX_N), of the JAX fits' mean.
NB_JAX_N = 16
NB_JAX = {"kappa": (0.05963398119416333, 0.0021728216376560006), "gamma": (1.1237550812641803, 0.007099848737197796),
          "sigma": (0.06149545325972347, 0.0018871368999632714), "mu": (-0.0545479950512443, 0.007158011742576175),
          "nu": (0.006546594264634529, 0.0044313454292809), "tau": (0.9128273436691505, 0.004172942001831331)}
NB_TOL_SD = 4.0
# the JAX fits cut 4-7 of their 7-9 rejuvenations short by the distance stop
NB_JAX_STOPS = (4, 7)
# The Sobol start's moments in unconstrained space: a scrambled-Sobol mean
# over NB_K points errs far less than the 1/sqrt(NB_K) prior sds of a
# pseudo-random one, so each parameter's start mean must lie within
# 1/sqrt(NB_K) prior sds of the prior's. Its variance must lie within twice
# a pseudo-random variance's standard error, sqrt((kurtosis - 1) / NB_K),
# of the prior's (relative): the log of the Exponential prior is heavy in its
# left tail, where one squeezed point near 0 moves the variance by up to 6%
# (CPU, four seeds). The prior's moments are those of 10^6 pseudo-random
# draws pushed through the same bijection on the host in float64. A wrong
# icdf or a missing bijection moves them by whole sds.
# phase 11: examples/batch_inference_zoo.py part 1 at the example's full
# width (T, particles, chains, seeds), num_samples cut from 1500 to the
# example's --quick 150; burn-in one third, as the example
PMMH_N, PMMH_T, PMMH_CHAINS, PMMH_SAMPLES, PMMH_SEEDS, PMMH_SCALE = 300, 400, 4, 150, 200, 0.08
PMMH_TRUE, PMMH_OBS = {"beta": 0.7, "sigma": 0.3}, 0.2
# The pooled post-burn-in means against the exact grid posterior, in its
# sds. Eight CPU fits of the port at this configuration (seeds 30-100;
# ``tests/test_torch_port_pmmh.py`` run as a script; PERF.md) gave gaps with
# a spread of 0.435 sd for beta and 0.225 for sigma (means -0.015 and
# +0.033, largest 0.678): the limit is 4x the larger spread.
PMMH_TOL_SD = 1.75
# The transition gate's bracket about the host's acceptance log-ratio: 20x
# the float32 rounding of the card's ratio (log-likelihoods near -173, whose
# ulp is 1.5e-5, and priors and the Hastings term near 1), and far below the
# 0.09 nats, one sd, that a dropped Jacobian moves a random-walk step's ratio
# by (beta near 0.73, steps of sd PMMH_SCALE on both parameters).
PMMH_BRACKET = 2e-3
# the fused resample's size limit (repair of the single-lane route)
FUSED_LIMIT = 1 << 24
# phase 12: the reference's linear-Gaussian oracle suite (BASELINE.md
# workload 5; the reference's tests/filters/test_particle.py and
# tests/filters/models.py, the JAX package's tests/test_filters.py): every
# filter and proposal at N = 1500 against an exact float64 Kalman filter over
# T = 100 observations simulated from numpy seed 123, under the reference's
# gates: the median relative deviation of the filter means and the relative
# error of the log-likelihood below 0.1. The batched runs lose 10 rows.
ORACLE_N, ORACLE_T, ORACLE_SEED, ORACLE_MISSING, ORACLE_TOL = 1500, 100, 123, 10, 0.1
ORACLE_AR = {"alpha": 0.0, "beta": 0.99, "sigma": 0.05, "a": 1.0, "s": 0.15}
ORACLE_SIGMA2, ORACLE_S2 = (0.05, 0.1), 0.15
ORACLE_2D = ("sisr-bootstrap", "apf-linear", "sisr-linearized", "sisr-linearized2", "gpf", "gpf-glinear",
             "gpf-glinearized", "gpf-glinearized2", "apf-nested")
ORACLE_BATCHED, ORACLE_LANES = ("sisr-bootstrap", "apf-linear"), 3
# the runs whose card log-likelihood is also held against the port's on the
# CPU, phase 7's form: ORACLE_STAT_CARD card runs against ORACLE_STAT_CPU CPU
# runs (in worker processes, while the card runs), within 4 standard errors.
# This is what a card-only numeric shows in: TF32, the pinv cut, a
# factorisation that raises instead of giving NaN.
ORACLE_STAT = (("sisr-linearized2", "rw2d"), ("gpf-glinearized2", "rw2d"), ("apf-nested", "joint2d"), ("gpf", "ar"))
ORACLE_STAT_CARD, ORACLE_STAT_CPU = 3, 8
# the runs whose host syncs are counted by source, and (--profile) whose
# device operations are traced, over ORACLE_SYNC_T steps
ORACLE_SYNC = (("sisr-linearized2", "rw2d"), ("gpf-glinearized2", "rw2d"))
ORACLE_SYNC_T = 20
# LocalLinearization (SISR and the APF, with and without the derivative)
# at LOCAL_N particles against a LOCAL_ORACLE_N-particle bootstrap SISR on
# the nonlinear benchmark model (the JAX package's tests/test_filters.py
# test_local_linearization), T = LOCAL_T, relative log-likelihood gap 0.1
LOCAL_N, LOCAL_ORACLE_N, LOCAL_T, LOCAL_SIGMA, LOCAL_S, LOCAL_SEED = 1000, 20_000, 60, math.sqrt(10.0), 1.0, 33
# phase 13d: examples/nutria_svi.py at full size (the reference's
# nutria-pyro.ipynb): fit_svi(nutria_builder, y, APF(., 300), 500 Adam steps,
# 4 ELBO samples, lr 1e-2) over T = 100 observations of the true model
NUTRIA_TRUE = {"a": 0.1, "b": -0.05, "c": 0.0, "sigma_e": 0.3, "sigma_n": 0.2}
NUTRIA_T, NUTRIA_N, NUTRIA_STEPS, NUTRIA_SAMPLES, NUTRIA_LR = 100, 300, 500, 4, 1e-2
NUTRIA_INIT_SCALE = 0.01
# From the example's own start (the mean of 4 prior draws, guide scale 0.1)
# the fit goes NaN: a lane drawing the drift's c above about 0.1 sends
# particles to infinity. So both packages start every lane at the priors'
# means (nutria_start) with guide scale NUTRIA_INIT_SCALE. The JAX package's
# fits from that start on the CPU (seeds 1-6, all finite; ``JAX_PLATFORMS=cpu
# PYTHONPATH=. python tests/test_torch_port_variational.py --workers 6 1 2 3
# 4 5 6``; PERF.md), per parameter: the mean over fits of the posterior
# median, its sd between seeds, and the mean guide sd on the constrained
# space ((q95 - q05) / 3.29). The card's median must lie within NUTRIA_TOL
# sds between seeds of that mean, or within one guide sd where that is wider.
NUTRIA_JAX = {"a": (0.23875166475772858, 0.005168400021244624, 0.0422303006452616),
              "b": (-0.1176888073484103, 0.005204719634823962, 0.015496775617172444),
              "c": (0.003992344233362625, 0.0037542110385636856, 0.0035062423929612),
              "sigma_e": (0.15849245339632034, 0.0018318036513677036, 0.017773286058250258),
              "sigma_n": (0.1469505081574122, 0.0019140956646430715, 0.016697190214140272)}
NUTRIA_TOL = 4.0
# phase 13b: tests/test_differentiable.py's score gate at its own size, an
# AR(1) observed with noise SCORE_OBS_S, T = SCORE_T, N = SCORE_N, the score
# at beta SCORE_BETA0 over SCORE_SEEDS runs (or lanes)
SCORE_ALPHA, SCORE_BETA, SCORE_SIGMA, SCORE_OBS_S = 0.0, 0.8, 0.5, 0.3
SCORE_T, SCORE_N, SCORE_SEEDS, SCORE_BETA0 = 40, 512, 64, 0.6
# phase 13c: test_fit_mle_recovers_beta's size: SISR(256), T = 150, 250 Adam
# steps at lr 3e-2, within 0.08 of the float64 Kalman MLE (its tolerance)
MLE_N, MLE_T, MLE_STEPS, MLE_LR, MLE_TOL = 256, 150, 250, 3e-2, 0.08
# phase 13e: the JAX package's gradient-PMMH tests' model (tests/test_inference.py)
# at T = 200 with APF(300) and 4 chains; samples cut from 40 to 20 to keep
# the whole run near 900 s (the 40-sample fits took 19-30 s a proposal)
OU_TRUE, OU_OBS, OU_T, OU_N, OU_SAMPLES, OU_CHAINS = (0.5, 1.0, 0.1), 0.05, 200, 300, 20, 4
# phase 13a: a differentiable SISR at N = 1e6 on phase 13's AR(1) with its
# level alpha far from the truth (0): the cloud sits over 10 observation
# sds from every observation, so each resample copies a handful of particles
COLLAPSE_ALPHA, COLLAPSE_T = 3.0, 10


# phase 14: online smoothing and streaming maximum likelihood. (a) The JAX
# package's tests/test_score.py:87-104 at its own size (the T of
# examples/streaming_and_switching.py part 1): AR(0.2, beta, sigma) observed
# with noise 0.25, T = 10,000, SISR(500), one Adam step per window of 50 at
# lr 2e-2 from beta 0.3, sigma 0.7, within 0.06 of the truth (its gate).
STREAM_ALPHA, STREAM_BETA, STREAM_SIGMA, STREAM_OBS = 0.2, 0.7, 0.4, 0.25
STREAM_T, STREAM_N, STREAM_WINDOW, STREAM_LR, STREAM_START, STREAM_TOL = 10_000, 500, 50, 2e-2, (0.3, 0.7), 0.06
# (b) the online score at N = 1e5, T = 200 at tests/test_score.py:33-62's
# point, each run within its tolerance of the float64 Kalman score. One run
# at the default 16 rejection rounds of the backward kernel, then the seeds
# at ONLINE_ROUNDS: the same law (a target that fails every round takes the
# exact Gumbel-max fallback), and about a fifth of the targets in the
# fallback, which is 90% of a default run's 18 s at this size
ONLINE_N, ONLINE_T, ONLINE_SEEDS, ONLINE_AT, ONLINE_RTOL, ONLINE_ATOL = 100_000, 200, 8, (0.5, 0.5), 0.18, 2.5
ONLINE_ROUNDS = 64
# (c) tests/test_smoothing_ffbsi.py:214-247 (PaRIS on the stochastic-volatility
# model, 5 sub-steps, the caller's bound from a floor on the volatility) and
# :170-183 (PaRIS on phase 8's AR model against the RTS smoother's sum)
PARIS_SV_N, PARIS_SV_T, PARIS_SV_XMIN, PARIS_AR_N, PARIS_AR_T = 1000, 30, 0.05, 3000, 70
# (d) every other resampler on phase 12's "ar" at N = 1e5, and two over lanes
RESAMPLERS = ("stratified", "multinomial", "residual", "metropolis", "rejection")
RESAMPLE_N, RESAMPLE_LANE_N, RESAMPLE_LANES, RESAMPLE_LANE_SCHEMES = 100_000, 400, 1000, ("residual", "stratified")
# (e) the four models: LLT and the cycle against the Kalman filter (the JAX
# package's tests/test_timeseries.py:233 and :280 models), TrendingOU and
# UCSV under that file's gates and then SISR at N = 1e5, T = 200
MODEL14_N, MODEL14_T = 100_000, 200
LLT_SIGMA, LLT_OBS = (0.05, 0.02), 0.15
CYC_RHO, CYC_LAMDA, CYC_SIGMA, CYC_OBS = 0.9, 0.5, 0.1, 0.05
TOU_PARAMS, TOU_OBS, TOU_PATHS, TOU_STEPS = (0.8, 1.0, 0.05, 0.1), 0.1, 200, 200
UCSV_SV, UCSV_OBS, UCSV_N, UCSV_T = 0.05, 0.1, 1000, 80
# (f) batch_filter_masked against batch_filter on the first rows
MASKED_N, MASKED_VALID = 100_000, 137
# phase 15: examples/batch_inference_zoo.py parts 2-4 at the example's full
# width on phase 11's model and data: TemperedSMC(SISR(300), 600) at its
# defaults (target ESS 0.5, 2 MH steps), IF2(SISR(300), 600, 25 passes,
# sigma 0.1, cooling 0.88), then PIT and CRPS of SISR(fitted, 300) on a
# second series (the example's seeds: data 4, filter 5, PIT 6, CRPS 7)
ZOO_N, ZOO_K, ZOO_IF2_ITERS, ZOO_IF2_SIGMA, ZOO_IF2_COOLING = 300, 600, 25, 0.1, 0.88
# (a) each posterior mean within ZOO_POST_SD swarm sds of the exact grid
# posterior's mean (tests/test_tempered.py:41's form, against the exact
# posterior rather than the truth), the log evidence within ZOO_EVIDENCE_NATS
# of the grid's (tests/test_tempered.py:73's limit); (b) the MLE within
# ZOO_MLE_TOL of the grid's MLE (tests/test_if2.py:38-39's limits), the final
# swarm's beta sd under ZOO_SWARM_SD, the last 3 passes' log-likelihoods
# above the first 3; (c) tests/test_diagnostics_predictive.py:28-33's PIT
# limits and :105's CRPS limit against the closed-form Gaussian CRPS under
# the fitted model's float64 Kalman one-step predictive
ZOO_POST_SD, ZOO_EVIDENCE_NATS, ZOO_MLE_TOL, ZOO_SWARM_SD = 3.5, 3.0, {"beta": 0.12, "sigma": 0.08}, 0.1
ZOO_PIT_MEAN, ZOO_PIT_VAR, ZOO_CRPS = 0.05, 0.02, 0.02
# The JAX package's fits of (a) and (b) on the CPU (keys from seeds 10-80;
# ``PYTHONPATH=. python tests/test_torch_port_tempered.py --workers 4 10 20
# 30 40 50 60 70 80``; PERF.md): per reading the mean over fits and its
# spread between seeds. Each card fit must lie within ZOO_JAX_TOL spreads,
# scaled by sqrt(1 + 1 / ZOO_JAX_N), of the JAX fits' mean.
ZOO_JAX_N = 8
ZOO_JAX = {"tempered": {"beta": (0.7293013408780098, 0.009679651573518775),
                        "sigma": (0.28140270709991455, 0.0029277762999189343),
                        "log_evidence": (-178.13827920531065, 0.17705244059205943)},
           "if2": {"beta": (0.7445487678050995, 0.00420867755960679),
                   "sigma": (0.29048461094498634, 0.00265811433308287)}}
ZOO_JAX_TOL = 4.0


# the backward kernels' tiling, where their edge cases lie: the single-lane
# kernel's output tile (expand.cu kBackTile), the lane kernel's row chunks a
# lane (expand_lanes.cu kChunks) and the rows past which it stops staging one
# plane in shared memory (kBackStageBytes / 32 bytes a row of 8 lanes)
K1T_TILE, LANE_CHUNKS, LANE_STAGED_ROWS = 4096, 64, 180 * 1024 // 32
BACKWARD_INDEX_NAMES = ("runs-T-1", "runs-T", "runs-T+1", "runs-2T+1", "runs-T-1-off", "runs-T-off", "runs-T+1-off",
                        "runs-2T+1-off", "one-run", "all-first", "all-last", "gap-edge", "sorted-random")


def backward_indices(n: int, name: str, tile: int, seed: int = 0):
    """A monotone int32 index array ``(n,)`` into [0, n), built directly (not
    through a forward kernel), of a kind ``name`` where a tiled backward
    kernel breaks (BACKWARD_INDEX_NAMES): runs of tile - 1, tile, tile + 1 and
    2 tile + 1 outputs each, aligned to the tile edges or off them ("-off");
    one run over every tile; all mass on the first or the last source; two
    copies a source, then a jump of ``tile`` sources at a tile edge (a gap of
    zero-copy sources across it); sorted uniform draws."""
    import numpy as np

    i = np.arange(n, dtype=np.int64)
    if name.startswith("runs-"):
        spec = name[len("runs-"):].removesuffix("-off")
        length = {"T-1": tile - 1, "T": tile, "T+1": tile + 1, "2T+1": 2 * tile + 1}[spec]
        idx = (i + (tile // 3 if name.endswith("-off") else 0)) // max(length, 1)
    elif name == "one-run":
        idx = np.full(n, n // 2)
    elif name == "all-first":
        idx = np.zeros(n, np.int64)
    elif name == "all-last":
        idx = np.full(n, n - 1)
    elif name == "gap-edge":
        idx = np.where(i < tile - 3, i // 2, i // 2 + tile)
    elif name == "sorted-random":
        idx = np.sort(np.random.default_rng(seed + n).integers(0, n, n))
    else:
        raise ValueError(f"unknown index kind {name}")
    return np.minimum(idx, n - 1).astype(np.int32)


def backward_lane_indices(n: int, lanes: int, shift: int = 0):
    """Monotone columns ``(n, lanes)`` int32: lane l's column is
    :func:`backward_indices` of kind BACKWARD_INDEX_NAMES[(l + shift) % 13],
    its tile the lane kernel's rows a chunk."""
    import numpy as np

    tile = max(-(-n // LANE_CHUNKS), 2)
    names = BACKWARD_INDEX_NAMES
    return np.stack([backward_indices(n, names[(l + shift) % len(names)], tile, seed=l) for l in range(lanes)], axis=1)


def nutria_start(lanes: int) -> dict:
    """The fit's starting context, every lane at the priors' means: the drift
    coefficients 0, both variances 0.2 (``InverseGamma(T / 2, (T - 2) / 10)``
    for any T)."""
    import numpy as np

    return {name: np.full(lanes, 0.2 if name.startswith("sigma") else 0.0, np.float32) for name in NUTRIA_TRUE}


def nutria_data(n_obs: int = NUTRIA_T, seed: int = 0):
    """Observations of the nutria model at NUTRIA_TRUE, simulated on the host
    with numpy: ``x_0 ~ N(0, 1)``, ``x_t = x_{t-1} + a + b e^x + c e^{2x} +
    sigma_e eps_t``, ``y_t = x_t + sigma_n v_t``, t = 1..n_obs."""
    import numpy as np

    p = NUTRIA_TRUE
    rng = np.random.default_rng(seed)
    x, ys = rng.normal(), []
    for _ in range(n_obs):
        e = math.exp(x)
        x = x + p["a"] + p["b"] * e + p["c"] * e * e + p["sigma_e"] * rng.normal()
        ys.append(x + p["sigma_n"] * rng.normal())
    return np.asarray(ys, np.float32)


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
    for n in (1_000_000, 1_000_003, 100_000, 8193, 1000, 257, 2, 1):
        ar = torch.arange(n, device=dev)
        weights = {"random": torch.randn(n, generator=g, device=dev) * 0.5,
                   "random-wide": torch.randn(n, generator=g, device=dev) * 2.0}
        for name, hot in (("hot-first", 0), ("hot-middle", n // 2), ("hot-last", n - 1)):
            weights[name] = torch.full((n,), -math.inf, device=dev).index_fill_(0, torch.tensor([hot], device=dev), 0.0)
        weights["zero-runs"] = torch.where(ar % 3 == 0, 0.0, -math.inf)
        cases = [(name, torch.softmax(lw, dim=0), u) for name, lw in weights.items()
                 for u in (float(torch.rand((), generator=g, device=dev)), 1.0)]
        cases += [(name, edge_probs(torch, n, name, dev), u) for name in ("uniform", "tiny") for u in EDGE_US]
        for d in (1, 2, 3):
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
    print(f"phase 3: expand kernel == plain version on {n_cases} cases (n in 1e6, 1e6+3, 1e5, 8193, 1000, 257, 2, 1; "
          "d in 1, 2, 3; random, degenerate, zero-run, uniform and sub-2^-60 probabilities; u random, "
          "0, 2^-24, 0.5, 1-2^-24, 1); tolerance: bit for bit (torch.equal), since indices are integers "
          "and the gather copies")
    return worst


def host_probe(torch, tree: str) -> int:
    """``--host-probe TREE`` (module docstring): TREE's ``pyfilter_tpu_torch``
    and TREE's ``chip_smoke.pmmh_fit``. The lane call is
    ``systematic_expand_lanes`` on PMMH_N x PMMH_CHAINS log-weights and one
    value plane that needs no gradient, as each SISR step of phase 11 makes
    it: 5 batches of 2000 calls after 200 warm-up calls, the card synced at
    each batch's end; the median batch's host microseconds a call."""
    import importlib.util

    import numpy as np

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("tree_chip_smoke", os.path.join(tree, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import pyfilter_tpu_torch as pt
    from pyfilter_tpu_torch.ops.expand import systematic_expand_lanes

    if not os.path.dirname(pt.__file__).startswith(tree):
        raise AssertionError(f"imported {pt.__file__}, not the package of {tree}")
    g = torch.Generator(device="cuda").manual_seed(3)
    lw = torch.randn(smoke.PMMH_N, smoke.PMMH_CHAINS, generator=g, device="cuda")
    x = torch.randn(smoke.PMMH_N, smoke.PMMH_CHAINS, generator=g, device="cuda")
    for _ in range(200):
        systematic_expand_lanes(g, lw, x)
    torch.cuda.synchronize()
    batches = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(2000):
            systematic_expand_lanes(g, lw, x)
        torch.cuda.synchronize()
        batches.append((time.perf_counter() - t0) / 2000 * 1e6)
    y = smoke.pmmh_data(torch, pt)
    fit_wall = smoke.pmmh_fit(torch, pt, y, "cuda", 30)[4]
    print(json.dumps({"tree": tree, "lane_call_us": float(np.median(batches)), "lane_call_us_batches": batches,
                      "pmmh_fit_s": fit_wall}))
    return 0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[:1] == ["--host-probe"]:
        return host_probe(torch, argv[1])

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pyfilter_tpu_torch as pt

    if argv[:1] == ["--ness-spread"]:
        counts = [int(a) for a in argv[1:]] + [8, 2][len(argv) - 1:]
        return ness_spread(torch, pt, *counts[:2])
    if argv[:1] == ["--apf-bias"]:
        return apf_bias(torch, pt, int(argv[1]) if len(argv) > 1 else 16)
    from pyfilter_tpu_torch.ops import _build, expand
    from pyfilter_tpu_torch.ops.resample import copy_counts

    refs, cpu = None, None
    if argv[:1] not in (["--backward-ab"], ["--oracle"], ["--backward"], ["--gradients"], ["--streaming"],
                        ["--batch"]):
        # the CPU references of phases 4, 6 and 9 run in worker processes while the card runs
        refs = ProcessPoolExecutor(CPU_REF_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        if refs is not None:
            cpu = {"phase 6": refs.submit(smc2_cpu_fit, 10), "phase 9": refs.submit(ness_cpu_fit, NESS_CPU_SEED),
                   "phase 4": [refs.submit(sisr_cpu_ll, seed) for seed in range(N_CPU_SEEDS)]}
        return card_phases(torch, pt, _build, expand, copy_counts, argv, cpu)
    finally:
        if refs is not None:
            refs.shutdown(cancel_futures=True)


def card_phases(torch, pt, _build, expand, copy_counts, argv, cpu) -> int:
    """Phases 1-3, then the mode ``argv`` asks for: one of the partial runs,
    or phases 4-15 (:func:`full_run`) with ``cpu``, the futures of the CPU
    references."""
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

    if argv[:1] == ["--backward-ab"]:
        return backward_ab(torch, pt, expand, card, argv[1])

    # -- 3. kernels against their plain versions ----------------------------
    max_err = check_expand(torch, expand)
    lanes_err = check_expand_lanes(torch, expand)
    if argv[:1] == ["--oracle"]:
        oracle_suite(torch, pt, expand, card, profile="--profile" in argv)
        return 0
    if argv[:1] == ["--backward"]:
        print(json.dumps(check_backward(torch, pt, expand, card)))
        return 0
    if argv[:1] == ["--gradients"]:
        grads = gradients(torch, pt, expand, card)
        print(json.dumps({"kernels": backward_kernel_lines(grads)}))
        return 0
    if argv[:1] == ["--streaming"]:
        streaming(torch, pt, expand, card, profile="--profile" in argv)
        return 0
    if argv[:1] == ["--batch"]:
        batch_zoo(torch, pt, expand, card, profile="--profile" in argv)
        return 0
    return full_run(torch, pt, expand, copy_counts, card, max_err, lanes_err, argv, cpu)


def full_run(torch, pt, expand, copy_counts, card, max_err, lanes_err, argv, cpu) -> int:
    """Phases 4-15 (module docstring), after the kernels' checks; ``cpu``
    holds the futures of the CPU references of phases 4, 6 and 9."""
    import numpy as np

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
    cpu_lls = [job.result() for job in cpu["phase 4"]]
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
    smc2_launches = smc2(torch, pt, expand, y, card, cpu["phase 6"], profile="--profile" in argv)

    # -- 7. the flagship flow -------------------------------------------------
    flag_launches, flag_err = flagship(torch, pt, expand, card, profile="--profile" in argv)

    # -- 8. rejection FFBSi at N = 1e5 and 1e6, SISR over lanes --------------------
    ffbsi_launches, lane_launches, ffbsi_err, lane_run_err = ffbsi(torch, pt, expand, card,
                                                                   profile="--profile" in argv)

    # -- 9. NESS on the Lorenz-63 model, and the hybrids ------------------------
    ness_launches, hybrid_launches, ness_err = lorenz_ness(torch, pt, expand, card, cpu["phase 9"],
                                                           profile="--profile" in argv)

    # -- 10. the reference notebook's SMC2 (Sobol start, distance stop) ---------
    nb_launches, nb_err = notebook(torch, pt, expand, card, profile="--profile" in argv)

    # -- 11. batch PMMH, and the single-lane route past the fused size limit -----
    pmmh_launches, pmmh_err = batch_pmmh(torch, pt, expand, card, profile="--profile" in argv)
    fused_limit(torch, pt, expand, card)

    # -- 12. the linear-Gaussian oracle suite ------------------------------------
    oracle_k1, oracle_lanes, oracle_err, oracle_lane_err = oracle_suite(torch, pt, expand, card,
                                                                        profile="--profile" in argv)

    # -- 13. gradients through the filter ----------------------------------------------
    grads = gradients(torch, pt, expand, card)

    # -- 14. online smoothing and streaming maximum likelihood ------------------------
    stream = streaming(torch, pt, expand, card, profile="--profile" in argv)

    # -- 15. the batch-inference zoo: TemperedSMC, IF2, PIT and CRPS --------------------
    zoo = batch_zoo(torch, pt, expand, card, profile="--profile" in argv)

    k1_paths = {"phase 4": launches, "phase 7": flag_launches, "phase 8": ffbsi_launches, "phase 12": oracle_k1,
                **{path: c["k1"] for path, c in grads["paths"].items() if c["k1"]}, **stream["paths"], **zoo["k1"]}
    lane_paths = {"phase 5": lanes["launches"], "phase 6": smc2_launches, "phase 8": lane_launches,
                  "phase 9 NESS": ness_launches, "phase 9 hybrids": hybrid_launches, "phase 10": nb_launches,
                  "phase 11": pmmh_launches, "phase 12": oracle_lanes,
                  **{path: c["lanes"] for path, c in grads["paths"].items() if c["lanes"]}, **zoo["lanes"]}

    kernels = [{
        "name": "expand",
        "route": "cuda",
        "source": "pyfilter_tpu_torch/ops/csrc/expand.cu",
        "replaces": "pyfilter_tpu/ops/expand.py:110",
        "launches": sum(k1_paths.values()),
        "launches_by_path": k1_paths,
        "max_abs_err": max(max_err, err, flag_err, ffbsi_err, oracle_err, stream["err"], zoo["k1_err"]),
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
        "launches": sum(lane_paths.values()),
        "launches_by_path": lane_paths,
        "max_abs_err": max(lanes_err, lanes["err"], lane_run_err, ness_err, nb_err, pmmh_err, oracle_lane_err,
                           zoo["lanes_err"]),
        "ms": lanes["ms"],
        "plain_ms": lanes["plain_ms"],
        "bound_ms": lanes["bound_ms"],
        "bound_by": "bytes",
        "library_ms": lanes["library_ms"],
    }] + backward_kernel_lines(grads)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


def check_expand_lanes(torch, expand) -> float:
    """Phase 3: the lane kernel (counts prep and expansion) against its plain
    version, bit for bit, with d = 1, 2 and 3 value planes (3 runs the
    remainder pass after a pair of planes), weight scales 1 and 6, one degenerate lane per
    case (all mass on the first, middle or last particle), one lane of
    alternating zero-weight runs, one of uniform weights, random uniforms and
    the edge uniforms. n = 7104 keeps the counts in shared memory and n = 7105
    takes the kernel's global scratch route."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    n_cases, worst = 0, 0.0
    shapes = ((400, 1000), (400, 8), (257, 5), (40, 16), (72, 16), (800, 1000), (3200, 1000), (7104, 40), (7105, 40),
              (2, 9))
    for n, n_lanes in shapes:
        for d in (1, 2, 3):
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
          "d in 1, 2, 3; scales 1, 6; a degenerate lane, zero-weight runs, uniform weights, random u and u in "
          "0, 2^-24, 0.5, 1-2^-24, 1); tolerance: bit for bit (torch.equal)")
    return worst


def check_on_cloud(torch, expand, probs, planes, label: str) -> float:
    """A kernel against its plain version on a path's own last cloud, bit
    for bit: the single-lane kernel for ``probs`` ``(n,)`` and ``planes``
    ``(d, n)``, the lane kernel for ``(n, L)`` and ``(d, n, L)``. Returns the
    largest absolute difference (0)."""
    probs, planes = probs.contiguous(), planes.contiguous()
    if probs.dim() == 1:
        u = torch.rand((), device="cuda")
        out, idx = expand.fused_expand(probs, u, planes)
        ref_out, ref_idx = expand._expand_probs_plain(probs, u, planes)
    else:
        u = torch.rand(probs.shape[1], device="cuda")
        out, idx = expand.fused_expand_lanes(probs, u, planes)
        ref_out, ref_idx = expand._expand_lanes_probs_plain(probs, u, planes)
    torch.cuda.synchronize()
    err = float((out - ref_out).abs().max())
    if not (torch.equal(idx, ref_idx) and torch.equal(out, ref_out)):
        raise AssertionError(f"kernel != plain version on {label}: {int((idx != ref_idx).sum())} indices differ")
    print(f"  kernel == plain version on {label}, shapes {tuple(planes.shape)}: bit for bit (torch.equal)")
    return err


def apf_true(torch, pt, y, device: str, seed: int):
    """Phase 5's run: the APF at SMC2_N particles on SMC2_K lanes of the true
    parameters over ``y`` on ``device``, its generator seeded from ``seed``.
    Returns the filter and its result."""
    model = pt.examples.stochastic_volatility_model(KAPPA, GAMMA, SIGMA, MU, NU, TAU, dt=DT, device=device)
    filt = pt.APF(model, SMC2_N, batch_shape=(SMC2_K,), record_moments=False, device=device)
    return filt, filt.batch_filter(torch.Generator(device=device).manual_seed(seed), y)


def apf_lanes(torch, pt, expand, copy_counts, y, card) -> dict:
    """Phase 5: :func:`apf_true` on the card and on the CPU; then the lane
    kernel per fire."""
    import numpy as np

    apf_true(torch, pt, y, "cuda", 0)  # warm-up
    expand.fused_expand.launches = expand.fused_expand_lanes.launches = 0
    pt.APF.corrections = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    filt, res = apf_true(torch, pt, y, "cuda", 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, steps = expand.fused_expand_lanes.launches, pt.APF.corrections
    if expand.fused_expand.launches:
        raise AssertionError(f"the lane APF launched the single-lane kernel {expand.fused_expand.launches} times")
    card_ll = res.log_likelihood.cpu().numpy().astype(np.float64)
    cpu_ll = apf_true(torch, pt, y, "cpu", 2)[1].log_likelihood.numpy().astype(np.float64)
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
    return {"err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bound_ms, "launches": launches}


def smc2_fit(torch, pt, y, device: str, seed: int):
    """One fit of phase 6's SMC2 over ``y`` on ``device``, its context and
    generator seeded from ``seed``: the algorithm, and the posterior mean and
    sd by name."""
    from pyfilter_tpu_torch import inference as inf

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


def smc2(torch, pt, expand, y, card, cpu_fit, profile: bool = False) -> int:
    """Phase 6: SMC2 at bench.py's configuration on the card (warm-up, then
    SMC2_TIMED timed fits), held against one CPU fit (``cpu_fit``, the
    future of :func:`smc2_cpu_fit`); with ``profile``, one more card fit
    under the profiler. Returns the lane kernel's launches over the timed
    fits."""
    def fit(device, seed):
        return smc2_fit(torch, pt, y, device, seed)

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

    cpu_mean, cpu_sd, cpu_seconds = cpu_fit.result()
    print(f"  CPU fit (plain versions, seed of card fit 0, a worker process): {cpu_seconds:.1f} s; "
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


def flagship(torch, pt, expand, card, profile: bool = False) -> tuple:
    """Phase 7: the reference README's flagship flow on the card against the
    known truth and against the same filter on the CPU; with ``profile``, one
    more run and one FFBS pass under the profiler. Returns the expand
    kernel's launches over the card runs and their smoothing, and its largest
    difference from the plain version on the last cloud."""
    import numpy as np

    from pyfilter_tpu_torch.filters.particle.proposals import LinearGaussianObservations

    cpu_model = pt.examples.sine_diffusion_model(dt=FLAG_DT, device="cpu")
    x_true, y = cpu_model.sample_states(torch.Generator().manual_seed(0), FLAG_T).get_paths()
    x_true, y = x_true.numpy().astype(np.float64), y.numpy()
    model = pt.examples.sine_diffusion_model(dt=FLAG_DT)

    def make(m, device):
        return pt.APF(m, FLAG_N, proposal=LinearGaussianObservations(), record_states=True, device=device)

    def rmse(means) -> float:
        return float(np.sqrt(np.mean((means.cpu().numpy().astype(np.float64) - x_true) ** 2)))

    filt = make(model, "cuda")
    filt.batch_filter(torch.Generator(device="cuda").manual_seed(100), y)  # warm-up
    expand.fused_expand.launches = expand.fused_expand_lanes.launches = 0
    pt.APF.corrections = 0
    lls, walls = [], []
    for rep in range(FLAG_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = filt.batch_filter(torch.Generator(device="cuda").manual_seed(rep), y)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        lls.append(float(res.log_likelihood))
    t0 = time.perf_counter()
    ffbs = filt.smooth(torch.Generator(device="cuda").manual_seed(50), res, method="ffbs")
    torch.cuda.synchronize()
    ffbs_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    fl = filt.smooth(None, res, method="fl")
    torch.cuda.synchronize()
    fl_wall = time.perf_counter() - t0
    launches, steps = expand.fused_expand.launches, pt.APF.corrections
    if not (launches == steps == FLAG_RUNS * FLAG_T):
        raise AssertionError(f"expand kernel launched {launches} times for {steps} APF steps")
    if expand.fused_expand_lanes.launches:
        raise AssertionError("the single-lane APF launched the lane kernel")
    # the expand kernel on the last cloud: state values and pre-weights, as
    # the APF's correction resamples them
    state = res.latest_state
    pre = filt.proposal.pre_weight(filt.model, torch.as_tensor(y[-1], device="cuda"), state.x)
    err = check_on_cloud(torch, expand, pt.normalize(pre + state.log_weights),
                         torch.stack([state.x.value, pre]), f"phase 7's APF cloud (n={FLAG_N})")

    f_rmse, s_rmse, l_rmse = rmse(res.filter_means), rmse(ffbs.mean(1)[1:]), rmse(fl.mean(1)[1:])
    hist = res.states
    print(f"phase 7: APF(N={FLAG_N}, LinearGaussianObservations, record_states) on the sine diffusion, "
          f"T={FLAG_T}, dt={FLAG_DT}: {FLAG_RUNS} runs, wall seconds {walls} (best {min(walls)}); "
          f"history {tuple(hist.values.shape)}; expand launches {launches} for {steps} APF steps; card {card}")
    print(f"  log-likelihood {lls}; FFBS ({FLAG_N} trajectories, ({FLAG_N}, {FLAG_N}) weights a step) "
          f"{ffbs_wall:.4f} s, fixed-lag {fl_wall:.4f} s")
    print(f"  RMSE against the truth: filter {f_rmse}, FFBS {s_rmse}, fixed-lag {l_rmse} (filter limit "
          f"{FLAG_RMSE_MAX}; FFBS must not exceed the filter's)")
    if not all(math.isfinite(v) for v in lls):
        raise AssertionError(f"non-finite log-likelihood: {lls}")
    if not (f_rmse < FLAG_RMSE_MAX and s_rmse <= f_rmse and math.isfinite(l_rmse)):
        raise AssertionError(f"flagship health checks failed: RMSE filter {f_rmse}, FFBS {s_rmse}, fixed-lag {l_rmse}")

    cpu_filt = make(cpu_model, "cpu")
    t0 = time.perf_counter()
    cpu_lls = [float(cpu_filt.batch_filter(torch.Generator().manual_seed(seed), y).log_likelihood)
               for seed in range(FLAG_RUNS)]
    cpu_wall = time.perf_counter() - t0
    card_ll, cpu_ll = np.asarray(lls), np.asarray(cpu_lls)
    gap = abs(card_ll.mean() - cpu_ll.mean())
    limit = 4 * math.sqrt(card_ll.var(ddof=1) / FLAG_RUNS + cpu_ll.var(ddof=1) / FLAG_RUNS)
    print(f"  CPU (plain versions, {FLAG_RUNS} seeds, {cpu_wall:.1f} s): mean {cpu_ll.mean()} sd "
          f"{cpu_ll.std(ddof=1)}; card mean {card_ll.mean()} sd {card_ll.std(ddof=1)}; gap {gap} (limit {limit})")
    if not gap < limit:
        raise AssertionError(f"card and CPU flagship log-likelihoods differ by {gap} (> {limit})")
    if profile:
        ops = profile_run(torch, "phase 7, APF run",
                          lambda: filt.batch_filter(torch.Generator(device="cuda").manual_seed(60), y))
        print(f"  device operations per APF step {ops / FLAG_T:.2f}")
        ops = profile_run(torch, "phase 7, FFBS pass",
                          lambda: filt.smooth(torch.Generator(device="cuda").manual_seed(61), res, method="ffbs"))
        print(f"  device operations per FFBS backward step {ops / FLAG_T:.2f}")
    return launches, err


def rts_ar(y, alpha: float, beta: float, sigma: float, obs_s: float):
    """Float64 Kalman filter and RTS smoother of ``x' = alpha + beta x +
    sigma e``, ``x_0 ~ N(alpha, sigma^2)``, observed as ``y = x + obs_s v``:
    the smoothed means and variances at t = 1..T."""
    import numpy as np

    n = len(y)
    fm, fp, pm, pp = (np.zeros(n) for _ in range(4))
    m, p = alpha, sigma**2
    for t in range(n):
        pm[t], pp[t] = alpha + beta * m, beta**2 * p + sigma**2
        gain = pp[t] / (pp[t] + obs_s**2)
        m, p = pm[t] + gain * (float(y[t]) - pm[t]), (1.0 - gain) * pp[t]
        fm[t], fp[t] = m, p
    sm, sp = fm.copy(), fp.copy()
    for t in range(n - 2, -1, -1):
        g = fp[t] * beta / pp[t + 1]
        sm[t] = fm[t] + g * (sm[t + 1] - pm[t + 1])
        sp[t] = fp[t] + g * g * (sp[t + 1] - pp[t + 1])
    return sm, sp


def ffbsi(torch, pt, expand, card, profile: bool = False):
    """Phase 8: rejection FFBSi at N = 1e5 (M = N) and N = 1e6 (M = 4096),
    then SISR over lanes with FFBSi over the lanes; with ``profile``, one
    more pass at each size under the profiler. Returns the expand kernel's
    and the lane kernel's launches over the filter runs, then each kernel's
    largest difference from its plain version on the runs' last clouds."""
    import numpy as np

    from pyfilter_tpu_torch.filters.particle.smoothing import ffbsi_smooth, transition_log_sup

    def ar_model(device=None):
        hidden = pt.timeseries.models.AR(AR_ALPHA, AR_BETA, AR_SIGMA, device=device)
        return pt.timeseries.LinearStateSpaceModel(hidden, (1.0, AR_OBS_S))

    _, y = ar_model("cpu").sample_states(torch.Generator().manual_seed(0), FFBSI_T).get_paths()
    y = y.numpy()
    sm_mean, sm_var = rts_ar(y, AR_ALPHA, AR_BETA, AR_SIGMA, AR_OBS_S)
    model = ar_model()
    log_sup = transition_log_sup(model)

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def check_means(traj, m: int, label: str):
        if bool(torch.isnan(traj).any()):
            raise AssertionError(f"{label}: NaN in the smoothed trajectories (the bound guard fired)")
        means = traj.double().mean(dim=tuple(range(1, traj.dim())))[1:].cpu().numpy()
        worst, tol = float(np.abs(means - sm_mean).max()), 4.5 * math.sqrt(sm_var.max() / m) + 0.02
        print(f"  {label}: smoothed means vs the RTS smoother: worst |gap| {worst} over t = 1..{FFBSI_T} "
              f"(limit {tol})")
        if not worst < tol:
            raise AssertionError(f"{label}: smoothed means off the RTS smoother by {worst} (> {tol})")

    expand.fused_expand.launches = expand.fused_expand_lanes.launches = 0
    k1_launches, k1_err = 0, 0.0
    for n, m in FFBSI_SIZES:
        filt = pt.SISR(model, n, record_states=True, record_moments=False)
        torch.cuda.reset_peak_memory_stats()
        before = expand.fused_expand.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = filt.batch_filter(gen(n), y)
        torch.cuda.synchronize()
        filter_wall = time.perf_counter() - t0
        fires, launches = filt.n_resamples, expand.fused_expand.launches - before
        k1_launches += launches
        if not (launches == fires > 0):
            raise AssertionError(f"N={n}: expand kernel launched {launches} times for {fires} resample fires")
        last = res.latest_state
        k1_err = max(k1_err, check_on_cloud(torch, expand, pt.normalize(last.log_weights),
                                            last.x.value.reshape(1, -1), f"phase 8's SISR cloud (n={n})"))
        hist_bytes = sum(h.numel() * h.element_size() for h in res.states[1:])

        def smooth(seed):
            return ffbsi_smooth(gen(seed), model, res.states, filt.resampler, log_density_sup=log_sup,
                                n_trajectories=m)

        smooth(1)  # warm-up
        walls, syncs, passes = [], [], []
        for rep in range(FFBSI_TIMED):
            ffbsi_smooth.host_syncs = ffbsi_smooth.fallback_passes = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            traj = smooth(2 + rep)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            syncs.append(ffbsi_smooth.host_syncs)
            passes.append(ffbsi_smooth.fallback_passes)
        peak = torch.cuda.max_memory_allocated()
        n_traj = traj.shape[1]
        k_sub = min(n_traj, max(128, n_traj // 512))
        print(f"phase 8: SISR(N={n}, record_states) on the AR model, T={FFBSI_T}: {filter_wall:.4f} s, "
              f"{fires} resample fires = expand launches; history {hist_bytes / 1e9:.4f} GB; card {card}")
        print(f"  FFBSi M={n_traj}: wall per pass {walls} s (best {min(walls)}); trajectory draws/s "
              f"{(FFBSI_T + 1) * n_traj / min(walls):.6g}; host syncs per pass {syncs}; fallback passes per "
              f"pass {passes} (k_sub {k_sub}, block {max(64, min(n, (1 << 25) // k_sub))}); peak device memory "
              f"{peak / 2**30:.4f} GiB; card {card}")
        check_means(traj, n_traj, f"N={n}, M={n_traj}")
        if profile:
            ffbsi_smooth.fallback_passes = 0
            ops = profile_run(torch, f"phase 8, FFBSi pass N={n} M={n_traj}", lambda: smooth(9))
            print(f"  device operations per backward step {ops / FFBSI_T:.2f} "
                  f"({ffbsi_smooth.fallback_passes} fallback passes in the traced pass)")
        del res, traj

    lanes = pt.SISR(model, LANES_N, batch_shape=(LANES_K,), record_states=True, record_moments=False)
    expand.fused_expand_lanes.launches = 0
    res = lanes.batch_filter(gen(7), y)
    lane_launches = expand.fused_expand_lanes.launches
    if not (lane_launches == lanes.n_resamples == FFBSI_T):
        raise AssertionError(f"lane kernel launched {lane_launches} times for {lanes.n_resamples} SISR steps")
    last = res.latest_state
    lane_err = check_on_cloud(torch, expand, pt.normalize(last.log_weights), last.x.value.unsqueeze(0),
                              f"phase 8's SISR lane cloud (n={LANES_N}, L={LANES_K})")
    ffbsi_smooth.host_syncs = ffbsi_smooth.fallback_passes = 0
    traj = ffbsi_smooth(gen(8), model, res.states, lanes.resampler, log_density_sup=log_sup)
    torch.cuda.synchronize()
    print(f"  SISR over lanes (N={LANES_N} x {LANES_K}): lane kernel launches {lane_launches}; FFBSi over the "
          f"lanes {tuple(traj.shape)}: host syncs {ffbsi_smooth.host_syncs}, fallback passes "
          f"{ffbsi_smooth.fallback_passes}")
    check_means(traj, LANES_N * LANES_K, f"lanes N={LANES_N} x {LANES_K}")
    return k1_launches, lane_launches, k1_err, lane_err


def lorenz_data(torch, pt):
    """Phase 9's observations: the observed rows (every LORENZ_OES-th) of
    ``lorenz63_model().sample_states`` on the CPU, seed 0, at the true
    parameters: (LORENZ_T, 2)."""
    model = pt.examples.lorenz63_model(device="cpu")
    _, ys = model.sample_states(torch.Generator().manual_seed(0), LORENZ_T * LORENZ_OES).get_paths()
    return ys[~torch.isnan(ys).any(dim=1)].numpy()


def finds_truth(mean: dict) -> bool:
    """Whether a Lorenz fit's posterior means (by name) all lie within
    NESS_FOUND_WITHIN of the true values."""
    return all(abs(mean[n] - LORENZ_TRUE[n]) < NESS_FOUND_WITHIN[n] for n in LORENZ_TRUE)


def lorenz_fit(torch, pt, y, device: str, seed: int, make=None, **kwargs):
    """One fit of ``make(SISR(lorenz63_builder, LORENZ_N), LORENZ_K,
    **kwargs)`` (``inference.NESS`` unless given) over ``y`` on ``device``,
    its context and generator seeded from ``seed``. Returns the algorithm, its
    state, the wall seconds of ``fit`` and of reading the posterior, and the
    posterior mean and sd of (s, r, b) by name."""
    from pyfilter_tpu_torch import inference as inf

    def gen(s):
        return torch.Generator(device=device).manual_seed(s)

    ctx = inf.make_context(generator=gen(seed), device=device)
    filt = pt.SISR(pt.examples.lorenz63_builder, LORENZ_N, device=device)
    alg = (make or inf.NESS)(filt, LORENZ_K, context=ctx, generator=gen(seed + 1), device=device, **kwargs)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = alg.fit(y)
    w = state.normalized_weights()
    stacked = ctx.stack_parameters(constrained=True)
    mean = w @ stacked
    sd = torch.sqrt(w @ torch.square(stacked - mean))
    mean, sd = mean.tolist(), sd.tolist()  # the host read ends the card's work
    wall = time.perf_counter() - t0
    return alg, state, wall, dict(zip(ctx.parameters, mean)), dict(zip(ctx.parameters, sd))


def lorenz_ness(torch, pt, expand, card, cpu_fit, profile: bool = False):
    """Phase 9: NESS at the notebook's configuration on the card (warm-up,
    then one timed fit per seed of NESS_SEEDS), the lane kernel on the last
    fit's cloud, NESSMC2 and SMC2FW over the first HYBRID_T observations,
    with ``profile`` one traced fit and one traced rejuvenation, and last one
    CPU fit (``cpu_fit``, the future of :func:`ness_cpu_fit`) that the card's
    fits that find the truth are held against.
    Returns the lane kernel's launches over the timed fits and over the
    hybrids, and its largest difference from the plain version on the last
    cloud."""
    y = lorenz_data(torch, pt)
    names = list(LORENZ_TRUE)
    lorenz_fit(torch, pt, y, "cuda", 0)  # warm-up
    expand.fused_expand.launches = expand.fused_expand_lanes.launches = 0
    runs, steps, walls = [], 0, []
    for seed in NESS_SEEDS:
        alg, state, wall, mean, sd = lorenz_fit(torch, pt, y, "cuda", seed)
        steps += alg.filter.n_resamples
        walls.append(wall)
        runs.append((seed, mean, sd, finds_truth(mean)))
        if not bool(torch.isfinite(state.w).all()):
            raise AssertionError(f"non-finite NESS weights on the card (seed {seed})")
        print(f"phase 9: NESS fit, seed {seed}: {wall:.4f} s; rejuvenations {alg.kernel.n_rejuvenations}; "
              f"host syncs {alg.n_host_syncs}; SISR lane steps {alg.filter.n_resamples}; finds the truth {runs[-1][3]}")
        print(f"  posterior mean {mean}; sd {sd}")
    launches = expand.fused_expand_lanes.launches
    print(f"  NESS(SISR({LORENZ_N}), K={LORENZ_K}), T={LORENZ_T} x {LORENZ_OES} sub-steps: best fit {min(walls):.4f} s "
          f"over {len(NESS_SEEDS)} seeds; lane kernel launches {launches} for {steps} SISR lane steps; card {card}")
    if expand.fused_expand.launches:
        raise AssertionError(f"NESS launched the single-lane kernel {expand.fused_expand.launches} times")
    if not (launches == steps == len(NESS_SEEDS) * LORENZ_T):
        raise AssertionError(f"lane kernel launched {launches} times for {steps} SISR lane steps")
    n_found = sum(run[3] for run in runs)
    lo, hi = NESS_FOUND_RANGE
    print(f"  {n_found} of {len(runs)} card fits find the truth {LORENZ_TRUE} (each mean within {NESS_FOUND_WITHIN}); "
          f"the JAX package's readings allow {lo} to {hi}")
    if not lo <= n_found <= hi:
        raise AssertionError(f"{n_found} of {len(runs)} card NESS fits find the truth, outside {NESS_FOUND_RANGE}")
    latest = state.filter_state.latest_state
    err = check_on_cloud(torch, expand, pt.normalize(latest.log_weights), latest.x.value.permute(2, 0, 1),
                         f"phase 9's SISR lane cloud (n={LORENZ_N}, L={LORENZ_K}, d=3)")

    # the hybrids at their defaults: SMC2 up to observation HYBRID_SWITCH,
    # then NESS or FixedWidthNESS
    from pyfilter_tpu_torch import inference as inf

    expand.fused_expand_lanes.launches = 0
    for name, kwargs in (("NESSMC2", {}), ("SMC2FW", {"ness_kw": {"block_len": HYBRID_BLOCK}})):
        switched, fired = [], []

        def make(*args, cls=getattr(inf, name), switched=switched, fired=fired, **kw):
            alg = cls(*args, switch=HYBRID_SWITCH, **kw)
            on_switch, rejuvenate = alg.do_on_switch, alg._second._do_rejuvenate
            alg.do_on_switch = lambda f, s, st: switched.append(st.current_iteration) or on_switch(f, s, st)
            alg._second._do_rejuvenate = lambda st: fired.append(st.current_iteration) or rejuvenate(st)
            return alg

        alg, state, wall, mean, sd = lorenz_fit(torch, pt, y[:HYBRID_T], "cuda", 70, make=make, **kwargs)
        first = alg._first.kernel
        print(f"phase 9: {name}(switch={HYBRID_SWITCH}{', block_len=' + str(HYBRID_BLOCK) if kwargs else ''}) "
              f"over {HYBRID_T} observations: {wall:.4f} s; SMC2 stage: rejuvenations {first.n_rejuvenations}, "
              f"PMMH transitions {first.n_transitions}, doublings {first.n_doublings}; second stage: "
              f"rejuvenations {alg._second.kernel.n_rejuvenations} at iterations {fired}; switch at iteration "
              f"{switched}; posterior mean {mean}, sd {sd}")
        if not bool(torch.isfinite(state.w).all()):
            raise AssertionError(f"non-finite {name} weights")
        if switched != [HYBRID_SWITCH + 1]:
            raise AssertionError(f"{name} switched at {switched}, not after observation {HYBRID_SWITCH}")
        schedule = [HYBRID_SWITCH + i for i in range(1, HYBRID_T - HYBRID_SWITCH) if i % HYBRID_BLOCK == 0]
        if kwargs and fired != schedule:
            raise AssertionError(f"SMC2FW's second stage fired at {fired}, its block schedule gives {schedule}")
    hybrid_launches = expand.fused_expand_lanes.launches
    print(f"  lane kernel launches over both hybrids (forward steps and PMMH re-filters) {hybrid_launches}")

    if profile:
        traced = []
        ops = profile_run(torch, "phase 9, NESS fit", lambda: traced.append(lorenz_fit(torch, pt, y, "cuda", 90)))
        alg, state = traced[0][:2]
        n_rej = alg.kernel.n_rejuvenations
        rej_ops = profile_run(torch, "phase 9, one NESS rejuvenation", lambda: alg._do_rejuvenate(state))
        print(f"  device operations per rejuvenation {rej_ops}; per observation (SISR lane step and its "
              f"{LORENZ_OES - 1} sub-steps, the fit's {n_rej} rejuvenations taken out) "
              f"{(ops - n_rej * rej_ops) / LORENZ_T:.2f}")

    cpu_finite, cpu_mean, cpu_sd, cpu_seconds = cpu_fit.result()
    print(f"  CPU fit (plain versions, seed {NESS_CPU_SEED}, a worker process): {cpu_seconds:.1f} s; posterior "
          f"mean {cpu_mean}; sd {cpu_sd}")
    if not cpu_finite:
        raise AssertionError("non-finite NESS weights on the CPU")
    if not finds_truth(cpu_mean):
        raise AssertionError(f"the CPU reference fit (seed {NESS_CPU_SEED}) froze away from the truth: {cpu_mean}")
    found = [(mean, sd) for _, mean, sd, hit in runs if hit]
    for seed, mean, sd, hit in runs:
        if hit:
            print(f"  card fit (seed {seed}) vs CPU: |gap| / posterior sd "
                  f"{ {n: abs(mean[n] - cpu_mean[n]) / max(sd[n], cpu_sd[n]) for n in names} }")
    for n in names:
        avg = sum(mean[n] for mean, _ in found) / len(found)
        jax_mean, spread = JAX_FOUND[n]
        se_jax = spread * math.sqrt(1 / len(found) + 1 / JAX_FOUND_N)
        se_cpu = spread * math.sqrt(1 / len(found) + 1)
        print(f"  {n}: mean over the card's {len(found)} fits that find the truth {avg}; JAX fits' {jax_mean} "
              f"({(avg - jax_mean) / se_jax:+.3f} SE); CPU fit's {cpu_mean[n]} ({(avg - cpu_mean[n]) / se_cpu:+.3f} "
              f"SE; limit {NESS_TOL_SE})")
        if not (abs(avg - jax_mean) < NESS_TOL_SE * se_jax and abs(avg - cpu_mean[n]) < NESS_TOL_SE * se_cpu):
            raise AssertionError(f"the card's NESS fits that find the truth put {n} at {avg}: JAX fits {jax_mean}, "
                                 f"CPU fit {cpu_mean[n]}, standard errors {se_jax}, {se_cpu}")
    return launches, hybrid_launches, err


def ness_spread(torch, pt, card_fits: int, cpu_fits: int) -> int:
    """``--ness-spread``: phase 9's NESS configuration over the seeds 10, 20,
    ... on the card and on the CPU (the first ``card_fits`` and ``cpu_fits``
    of them): each fit's wall seconds, rejuvenations, parameter ESS after a
    few steps, posterior mean and sd and whether it finds the truth; the gap
    between every two fits that find it, per parameter in units of the larger
    posterior sd."""
    import itertools

    print(card_line())
    y = lorenz_data(torch, pt)
    lorenz_fit(torch, pt, y, "cuda", 0)  # warm-up
    runs = [("cuda", 10 * (i + 1)) for i in range(card_fits)] + [("cpu", 10 * (i + 1)) for i in range(cpu_fits)]
    found = []
    for device, seed in runs:
        alg, state, wall, mean, sd = lorenz_fit(torch, pt, y, device, seed)
        ess = [round(float(state.ess[t]), 2) for t in (1, 2, 3, 10, len(state.ess) - 1)]
        print(f"{device} seed {seed}: {wall:.3f} s; rejuvenations {alg.kernel.n_rejuvenations}; finite weights "
              f"{bool(torch.isfinite(state.w).all())}; finds the truth {finds_truth(mean)}; parameter ESS after "
              f"steps 0, 1, 2, 9 and the last {ess}; posterior mean {mean}; sd {sd}", flush=True)
        if finds_truth(mean):
            found.append((f"{device}:{seed}", mean, sd))
    print(f"{len(found)} of {len(runs)} fits find the truth")
    worst = 0.0
    for (la, ma, sa), (lb, mb, sb) in itertools.combinations(found, 2):
        gaps = {n: abs(ma[n] - mb[n]) / max(sa[n], sb[n]) for n in ma}
        worst = max(worst, max(gaps.values()))
        print(f"  {la} vs {lb}: |gap| / posterior sd {gaps}")
    print(f"largest gap between fits that find the truth: {worst} posterior sd")
    return 0


def notebook_fit(torch, pt, y, device: str, seed: int, t_obs: int | None = None):
    """One fit of the reference notebook's SMC2 (``examples/
    stochastic_volatility_smc2.py``): ``SMC2(APF(stochastic_volatility_builder,
    NB_N), NB_K, num_steps=NB_STEPS, distance_threshold=NB_DISTANCE)`` from a
    Sobol start, over ``y[:t_obs]`` on ``device``, its context and generator
    seeded from ``seed``. Returns the algorithm, its state, its context, the
    wall seconds of ``fit`` and of reading the posterior, the posterior mean
    and sd by name, and the unconstrained start (the first Sobol draw)."""
    from pyfilter_tpu_torch import inference as inf

    def gen(s):
        return torch.Generator(device=device).manual_seed(s)

    ctx = inf.make_context(use_quasi=True, generator=gen(seed), device=device)
    start = []
    initialize = ctx.initialize_parameters
    ctx.initialize_parameters = lambda: initialize() or start.append(ctx.stack_parameters(constrained=False))
    alg = inf.SMC2(pt.APF(pt.examples.stochastic_volatility_builder, NB_N, device=device), NB_K,
                   num_steps=NB_STEPS, distance_threshold=NB_DISTANCE, context=ctx, generator=gen(seed + 1),
                   device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = alg.fit(y[:t_obs])
    w = state.normalized_weights()
    stacked = ctx.stack_parameters(constrained=True)
    mean = w @ stacked
    sd = torch.sqrt(torch.clamp(w @ torch.square(stacked - mean), min=1e-12))
    mean, sd = mean.tolist(), sd.tolist()  # the host read ends the card's work
    wall = time.perf_counter() - t0
    return alg, state, ctx, wall, dict(zip(ctx.parameters, mean)), dict(zip(ctx.parameters, sd)), start[0]


def start_moments_gate(torch, pt, ctx, start) -> None:
    """Phase 10's gate on the Sobol start (its limits: the comment after
    NB_JAX_STOPS): each
    parameter's mean and variance over the NB_K lanes, in unconstrained
    space, against 10^6 pseudo-random prior draws pushed through the same
    bijection on the host in float64."""
    import numpy as np

    from pyfilter_tpu_torch.inference import prior as prior_ops

    start = start.double().cpu().numpy()
    g = torch.Generator().manual_seed(12)
    for i, name in enumerate(ctx.parameters):
        prior = ctx.get_prior(name)
        cpu_prior = type(prior)(*(getattr(prior, a).double().cpu() for a in prior.arg_names))
        draws = prior_ops.get_unconstrained(cpu_prior, cpu_prior.sample(g, (1_000_000,))).numpy()
        mean, var = draws.mean(), draws.var()
        kurtosis = ((draws - mean) ** 4).mean() / var**2
        z = (start[:, i].mean() - mean) / math.sqrt(var)
        ratio = start[:, i].var() / var
        var_tol = 2 * math.sqrt((kurtosis - 1) / NB_K)
        print(f"  Sobol start, {name} (unconstrained): mean {start[:, i].mean():.6f} vs prior {mean:.6f} "
              f"({z:+.5f} prior sd; limit {1 / math.sqrt(NB_K):.5f}); variance / prior variance {ratio:.5f} "
              f"(limit 1 +- {var_tol:.5f})")
        if not (abs(z) < 1 / math.sqrt(NB_K) and abs(ratio - 1) < var_tol):
            raise AssertionError(f"the Sobol start of {name} misses the prior's moments: {z} sd, variance x{ratio}")


def notebook(torch, pt, expand, card, profile: bool = False):
    """Phase 10: the reference notebook's SMC2 at full size on the card
    (warm-up, then NB_TIMED timed fits), against the JAX package's fits of
    the same configuration; with ``profile``, one traced fit over the first
    100 observations and the host time of one rejuvenation with and without
    the distance stop. Returns the lane kernel's launches over the timed fits
    and its largest difference from the plain version on the last cloud."""
    y = simulate_obs(NB_T)
    notebook_fit(torch, pt, y, "cuda", 0)  # warm-up
    expand.fused_expand.launches = expand.fused_expand_lanes.launches = 0
    pt.APF.corrections = 0
    for rep in range(NB_TIMED):
        seed = 10 * (rep + 1)
        alg, state, ctx, wall, mean, sd, start = notebook_fit(torch, pt, y, "cuda", seed)
        k = alg.kernel
        print(f"phase 10: notebook SMC2 fit {rep} (seed {seed}): {wall:.4f} s; rejuvenations {k.n_rejuvenations}, "
              f"PMMH transitions {k.n_transitions}, cut short by the distance stop {k.n_distance_stops} "
              f"(JAX fits: {NB_JAX_STOPS[0]}-{NB_JAX_STOPS[1]}), doublings {k.n_doublings} (state particles "
              f"{alg.filter.n_particles}); host syncs {alg.n_host_syncs + k.n_host_syncs}; Sobol points "
              f"{ctx.quasi_engine.n_drawn} in {ctx.quasi_engine.n_copies} host-to-device copies")
        print(f"  posterior mean {mean}")
        print(f"  posterior sd   {sd}")
        if not bool(torch.isfinite(state.w).all()):
            raise AssertionError(f"non-finite notebook SMC2 weights (seed {seed})")
        if not k.n_distance_stops:
            raise AssertionError("the distance stop never fired: distance_threshold is not wired")
        if not (0.3 < mean["gamma"] < 3.0 and 0.5 < mean["tau"] < 2.0):
            raise AssertionError(f"posterior means out of bounds: {mean}")
        if rep == 0:
            start_moments_gate(torch, pt, ctx, start)
        if NB_JAX:
            gaps = {n: (mean[n] - NB_JAX[n][0]) / (NB_JAX[n][1] * math.sqrt(1 + 1 / NB_JAX_N)) for n in mean}
            print(f"  (card - JAX fits' mean) / their spread between seeds {gaps} (limit {NB_TOL_SD})")
            if not all(abs(g) < NB_TOL_SD for g in gaps.values()):
                raise AssertionError(f"the card's notebook posterior is off the JAX fits': {gaps}")
    launches, steps = expand.fused_expand_lanes.launches, pt.APF.corrections
    print(f"  SMC2 T={NB_T}, APF {NB_N} x K={NB_K}, num_steps={NB_STEPS}, distance_threshold {NB_DISTANCE}, Sobol "
          f"start: APF steps {steps} (forward + re-filter) and lane kernel launches {launches} over {NB_TIMED} fits; "
          f"card {card}")
    if not (launches == steps > 0) or expand.fused_expand.launches:
        raise AssertionError(f"lane kernel launched {launches} times for {steps} APF steps")
    latest = state.filter_state.latest_state
    pre = alg.filter.proposal.pre_weight(alg.filter.model, torch.tensor(float(y[-1]), device="cuda"), latest.x)
    n = alg.filter.n_particles
    err = check_on_cloud(torch, expand, pt.normalize(pre + latest.log_weights), torch.stack([latest.x.value, pre]),
                         f"phase 10's last APF cloud (n={n}, L={NB_K}"
                         f"{'; past 7104 rows, the global-scratch route' if n > 7104 else ''})")
    if profile:
        traced = []
        steps = pt.APF.corrections
        ops = profile_run(torch, "phase 10, notebook fit over 100 observations",
                          lambda: traced.append(notebook_fit(torch, pt, y, "cuda", 90, t_obs=100)))
        steps = pt.APF.corrections - steps
        print(f"  device operations per APF step {ops / steps:.2f} ({steps} APF steps, forward and re-filter)")
        alg, state = traced[0][:2]
        for label, threshold in (("with the distance stop", NB_DISTANCE), ("without it", None)):
            alg.kernel._dist_thresh = threshold
            before = alg.kernel.n_transitions
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            alg._do_rejuvenate(state)
            torch.cuda.synchronize()
            print(f"  one rejuvenation after 100 observations {label}: {(time.perf_counter() - t0) * 1e3:.3f} ms "
                  f"host clock, {alg.kernel.n_transitions - before} PMMH transitions")
    return launches, err


def pmmh_builder(pt, ctx):
    """``examples/batch_inference_zoo.py``'s model: AR(1) with beta ~
    Uniform(0, 1), sigma ~ LogNormal(-1, 0.5), observed with noise PMMH_OBS."""
    def const(v):
        return pt.timeseries.models.parameter(v, ctx.device)

    beta = ctx.named_parameter("beta", pt.distributions.Uniform(const(0.0), const(1.0)))
    sigma = ctx.named_parameter("sigma", pt.distributions.LogNormal(const(-1.0), const(0.5)))
    return pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.AR(0.0, beta, sigma, device=ctx.device),
                                               (1.0, PMMH_OBS))


def pmmh_data(torch, pt):
    """Phase 11's observations: PMMH_T steps of the true AR model, simulated
    by the port on the CPU (seed 0)."""
    model = pt.timeseries.LinearStateSpaceModel(
        pt.timeseries.models.AR(0.0, PMMH_TRUE["beta"], PMMH_TRUE["sigma"], device="cpu"), (1.0, PMMH_OBS))
    return model.sample_states(torch.Generator().manual_seed(0), PMMH_T).get_paths()[1].numpy()


def ar_grid_posterior(y, jacobian: bool = True) -> dict:
    """The exact posterior mean and sd of (beta, sigma) for phase 11's model,
    on a grid in float64: each point's Kalman log-likelihood (``x_0 ~
    N(0, sigma^2)``, predict, then update on ``y_t``, as the port's filter
    steps) plus the log-prior. With ``jacobian=False``, the posterior a chain
    reaches when its unconstrained target omits the bijections' Jacobian.
    Also, under ``"log_evidence"``, the log of the integral of likelihood
    times prior (the priors' normalizing constants and each cell's width in
    beta and in sigma), and under ``"mle"`` the grid point of largest
    likelihood."""
    import numpy as np

    beta = np.linspace(0.0005, 0.9995, 500)[:, None]
    log_sigma = np.linspace(math.log(0.05), math.log(1.0), 500)[None, :]
    sigma = np.exp(log_sigma)
    m, p = np.zeros_like(beta * sigma), np.broadcast_to(sigma**2, (beta * sigma).shape).copy()
    ll = np.zeros_like(m)
    for yt in np.asarray(y, np.float64):
        m, p = beta * m, beta**2 * p + sigma**2
        s = p + PMMH_OBS**2
        ll -= 0.5 * (np.log(2 * math.pi * s) + (yt - m) ** 2 / s)
        gain = p / s
        m, p = m + gain * (yt - m), (1.0 - gain) * p
    # beta ~ U(0, 1) has density 1; sigma ~ LogNormal(-1, 0.5)
    log_sigma_prior = -0.5 * ((log_sigma + 1.0) / 0.5) ** 2 - log_sigma - math.log(0.5 * math.sqrt(2 * math.pi))
    logpost = ll + log_sigma_prior
    # the grid is uniform in beta and in log sigma: a cell is d_beta wide and
    # sigma * d_log_sigma tall
    log_cell = math.log(beta[1, 0] - beta[0, 0]) + log_sigma + math.log(log_sigma[0, 1] - log_sigma[0, 0])
    top = float((logpost + log_cell).max())
    log_evidence = top + math.log(float(np.exp(logpost + log_cell - top).sum()))
    if not jacobian:
        logpost = logpost - np.log(beta * (1 - beta)) - np.log(sigma)
    w = np.exp(logpost - logpost.max()) * sigma
    w /= w.sum()
    out = {}
    for name, v in (("beta", beta + 0 * sigma), ("sigma", sigma + 0 * beta)):
        mean = float((w * v).sum())
        out[name] = (mean, float(np.sqrt((w * (v - mean) ** 2).sum())))
    i, j = np.unravel_index(np.argmax(ll), ll.shape)
    out["log_evidence"] = log_evidence
    out["mle"] = {"beta": float(beta[i, 0]), "sigma": float(sigma[0, j])}
    return out


def pmmh_fit(torch, pt, y, device: str, seed: int, num_samples: int = PMMH_SAMPLES):
    """One fit of ``PMMH(SISR(pmmh_builder, PMMH_N), num_samples, PMMH_CHAINS,
    RandomWalk(PMMH_SCALE), initializer="seed", num_seeds=PMMH_SEEDS)`` on
    ``device``, its context and generator seeded from ``seed``. Returns the
    algorithm, its final state, the seed pass's filter result, the chains by
    name ``(num_samples + 1, chains)``, the wall seconds of ``fit`` (to the
    chains on the host) and of its seed pass, each chain's acceptance rate,
    and the pooled post-burn-in mean and sd by name."""
    import numpy as np

    from pyfilter_tpu_torch import inference as inf

    def gen(s):
        return torch.Generator(device=device).manual_seed(s)

    alg = inf.PMMH(pt.SISR(lambda ctx: pmmh_builder(pt, ctx), PMMH_N, device=device), num_samples,
                   num_chains=PMMH_CHAINS, proposal=inf.RandomWalk(PMMH_SCALE), initializer="seed",
                   num_seeds=PMMH_SEEDS, context=inf.make_context(generator=gen(seed), device=device),
                   generator=gen(seed + 1), device=device)
    seed_pass, seed_chains = [], alg._seed_chains

    def timed_seed_chains(y_host):
        t0 = time.perf_counter()
        res = seed_chains(y_host)
        if device == "cuda":
            torch.cuda.synchronize()
        seed_pass.append((time.perf_counter() - t0, res))
        return res

    alg._seed_chains = timed_seed_chains
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = alg.fit(y, logging=inf.logging.DefaultLogger())
    chains = state.as_arrays()
    wall = time.perf_counter() - t0
    burn = num_samples // 3
    accept = (np.diff(chains["beta"], axis=0) != 0).mean(axis=0)
    pooled = {n: (float(v[1 + burn:].mean()), float(v[1 + burn:].std())) for n, v in chains.items()}
    (seed_wall, seed_res), = seed_pass
    return alg, state, seed_res, chains, wall, seed_wall, accept, pooled


def pmmh_transition_gate(torch, alg, state, y, device: str) -> None:
    """Phase 11's gate on the transition itself (the posterior gate cannot
    see a dropped Jacobian or a random walk that stays put at PMMH_SAMPLES
    samples): one more update from the fit's last state, its candidate and
    re-filter drawn as the fit draws them, then decided twice by
    ``pmmh_accept``, with log-uniforms PMMH_BRACKET nats below and above the
    acceptance log-ratio computed on the host in float64 (the log-likelihoods
    read back; the priors and their Jacobians by formula on the unconstrained
    values; the random walk's Hastings term is 0). Every chain must accept
    below and reject above; the kernel of the next transition must sit at the
    candidate where it accepted and where the chain was where it rejected."""
    import numpy as np

    from pyfilter_tpu_torch.inference.batch.mcmc.utils import pmmh_accept

    def log_prior(z):  # beta = sigmoid(z_0) ~ U(0, 1); log sigma = z_1 ~ N(-1, 0.5)
        return (-np.logaddexp(0.0, -z[:, 0]) - np.logaddexp(0.0, z[:, 0])
                - 0.5 * ((z[:, 1] + 1.0) / 0.5) ** 2 - math.log(0.5 * math.sqrt(2 * math.pi)))

    gen = torch.Generator(device=device).manual_seed(7)
    ctx, proposal = alg.context, alg._proposal
    kernel = proposal.build(ctx, state, alg.filter, y, gen)
    z = ctx.stack_parameters(constrained=False)
    rvs = kernel.sample(gen, ())
    proposal_ctx = ctx.unstack_parameters(rvs, constrained=False)
    proposal_filter = alg.filter.initialize_model(proposal_ctx)
    new_res = proposal_filter.batch_filter(gen, y)
    z64, rvs64 = z.double().cpu().numpy(), rvs.double().cpu().numpy()
    ratio = (new_res.log_likelihood.double().cpu().numpy() - state.filter_state.log_likelihood.double().cpu().numpy()
             + log_prior(rvs64) - log_prior(z64))
    moved = proposal_ctx.stack_parameters(constrained=False)  # the candidate, through the bijections and back
    for sign, want, at in ((-1.0, True, moved), (1.0, False, z)):
        log_u = torch.tensor(ratio + sign * PMMH_BRACKET, dtype=z.dtype, device=z.device)
        step = pmmh_accept(ctx, state, proposal, kernel, rvs, proposal_ctx, proposal_filter, new_res, log_u, y, gen,
                           mutate_kernel=True)
        accepted = step.accepted.cpu().numpy()
        if not (accepted == want).all():
            raise AssertionError(f"PMMH acceptance {accepted.tolist()} with log u {PMMH_BRACKET} nats "
                                 f"{'below' if want else 'above'} the host's log-ratio {ratio.tolist()}")
        if not torch.equal(step.proposal_kernel.base_dist.loc, at):
            raise AssertionError(f"after {'accepting' if want else 'rejecting'} the random walk's kernel is not "
                                 "where the chain is")
    print(f"  transition gate: each of {len(ratio)} chains accepts {PMMH_BRACKET} nats below the host's float64 "
          f"log-ratio {np.round(ratio, 6).tolist()} and rejects above it; the kernel follows the chain")


def batch_pmmh(torch, pt, expand, card, profile: bool = False) -> tuple:
    """Phase 11: batch PMMH at ``examples/batch_inference_zoo.py``'s full
    width on the card (``num_samples`` cut to PMMH_SAMPLES), its pooled
    chains against the exact grid posterior, one more transition against the
    host's acceptance rule, and the lane kernel against its plain version on
    the last clouds of the chains and of the seed pass; with ``profile``, one
    traced fit of 5 samples. Returns the lane kernel's launches and its
    largest difference from the plain version."""
    import numpy as np

    y = pmmh_data(torch, pt)
    exact = ar_grid_posterior(y)
    expand.fused_expand.launches = expand.fused_expand_lanes.launches = 0
    alg, state, seed_res, chains, wall, seed_wall, accept, pooled = pmmh_fit(torch, pt, y, "cuda", 30)
    launches = expand.fused_expand_lanes.launches
    steps = (PMMH_SAMPLES + 2) * PMMH_T  # the seed pass, the initial pass and one re-filter per sample
    print(f"phase 11: PMMH(SISR({PMMH_N}), {PMMH_SAMPLES} samples, {PMMH_CHAINS} chains, RandomWalk({PMMH_SCALE}), "
          f"seed initializer over {PMMH_SEEDS} draws), T={PMMH_T}: {wall:.4f} s, seed pass {seed_wall:.4f} s; "
          f"acceptance per chain {accept.tolist()}; lane kernel launches {launches} for {steps} SISR lane steps; "
          f"card {card}")
    if not all(np.isfinite(v).all() for v in chains.values()):
        raise AssertionError("non-finite PMMH chains")
    if not (launches == steps) or expand.fused_expand.launches:
        raise AssertionError(f"lane kernel launched {launches} times for {steps} SISR lane steps")
    for name, (mean, sd) in pooled.items():
        ex_mean, ex_sd = exact[name]
        gap = (mean - ex_mean) / ex_sd
        print(f"  {name}: pooled post-burn-in mean {mean:.6f} sd {sd:.6f}; exact posterior {ex_mean:.6f} sd "
              f"{ex_sd:.6f}; gap {gap:+.4f} posterior sd (limit {PMMH_TOL_SD})")
        if not abs(gap) < PMMH_TOL_SD:
            raise AssertionError(f"the pooled PMMH chains put {name} {gap} posterior sd off the exact posterior")
    pmmh_transition_gate(torch, alg, state, y, "cuda")
    err = 0.0
    for res, label in ((state.filter_state, "the chains' last re-filter"), (seed_res, "the seed pass")):
        last = res.latest_state
        err = max(err, check_on_cloud(torch, expand, pt.normalize(last.log_weights), last.x.value.unsqueeze(0),
                                      f"phase 11's last SISR cloud of {label} (n={PMMH_N}, "
                                      f"L={last.log_weights.shape[1]})"))
    if profile:
        ops = profile_run(torch, "phase 11, PMMH fit of 5 samples", lambda: pmmh_fit(torch, pt, y, "cuda", 31, 5))
        print(f"  device operations per SISR lane step {ops / (7 * PMMH_T):.2f} "
              "(seed pass, initial pass, 5 re-filters)")
    return launches, err


def fused_limit(torch, pt, expand, card) -> None:
    """The repaired single-lane route: one SISR step at N = FUSED_LIMIT on
    the card resamples through its resampler and a gather (the expand
    kernel's size limit), with a finite log-likelihood."""
    y = simulate_obs(1)
    model = pt.examples.stochastic_volatility_model(KAPPA, GAMMA, SIGMA, MU, NU, TAU, dt=DT, device="cuda")
    filt = pt.SISR(model, FUSED_LIMIT, ess_threshold=1.0 + 1e-6, record_moments=False, device="cuda")
    before = expand.fused_expand.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll = float(filt.batch_filter(torch.Generator(device="cuda").manual_seed(0), y).log_likelihood)
    wall = time.perf_counter() - t0
    print(f"  SISR N=2^24 (one lane, one observation): {wall:.4f} s, log-likelihood {ll}; resample fires "
          f"{filt.n_resamples} through the resampler and a gather; expand launches "
          f"{expand.fused_expand.launches - before}; card {card}")
    if not (math.isfinite(ll) and filt.n_resamples == 1 and expand.fused_expand.launches == before):
        raise AssertionError("the N = 2^24 SISR did not take the resampler route")


def oracle_filters(pt) -> dict:
    """Phase 12's filters, by the JAX package's names (tests/test_filters.py
    ``FILTERS``): factories ``(model, particles, **kwargs)`` of the port."""
    props = pt.filters.particle.proposals
    return {
        "gpf": lambda m, n, **kw: pt.GPF(m, n, **kw),
        "gpf-glinearized": lambda m, n, **kw: pt.GPF(m, n, proposal=props.GaussianLinearized(n_steps=5), **kw),
        "gpf-glinearized2": lambda m, n, **kw: pt.GPF(
            m, n, proposal=props.GaussianLinearized(n_steps=5, use_second_order=True), **kw),
        "gpf-glinear": lambda m, n, **kw: pt.GPF(m, n, proposal=props.GaussianLinear(), **kw),
        "sisr-bootstrap": lambda m, n, **kw: pt.SISR(m, n, proposal=props.Bootstrap(), **kw),
        "apf-bootstrap": lambda m, n, **kw: pt.APF(m, n, proposal=props.Bootstrap(), **kw),
        "sisr-nested": lambda m, n, **kw: pt.SISR(m, n, proposal=props.NestedProposal(50), **kw),
        "apf-nested": lambda m, n, **kw: pt.APF(m, n, proposal=props.NestedProposal(50), **kw),
        "sisr-linearized": lambda m, n, **kw: pt.SISR(m, n, proposal=props.Linearized(n_steps=5), **kw),
        "sisr-linearized2": lambda m, n, **kw: pt.SISR(
            m, n, proposal=props.Linearized(n_steps=5, use_second_order=True), **kw),
        "apf-linearized": lambda m, n, **kw: pt.APF(m, n, proposal=props.Linearized(n_steps=5), **kw),
        "sisr-linear": lambda m, n, **kw: pt.SISR(m, n, proposal=props.LinearGaussianObservations(), **kw),
        "apf-linear": lambda m, n, **kw: pt.APF(m, n, proposal=props.LinearGaussianObservations(), **kw),
    }


def oracle_model(pt, name: str, device):
    """Phase 12's models on ``device``: ``"ar"`` (AR(1) observed with noise),
    ``"rw2d"`` (a 2-D linear random walk) and ``"joint2d"`` (the same walk as
    a joint process of two scalar random walks)."""
    import numpy as np

    f32 = np.float32
    if name == "ar":
        p = ORACLE_AR
        hidden = pt.convert.ar_from_numpy(f32(p["alpha"]), f32(p["beta"]), f32(p["sigma"]), device=device)
        return pt.convert.linear_ssm_from_numpy(hidden, f32(p["a"]), f32(0.0), f32(p["s"]))
    sigma, s, eye = np.asarray(ORACLE_SIGMA2, f32), np.full(2, ORACLE_S2, f32), np.eye(2, dtype=f32)
    if name == "rw2d":
        return pt.convert.rw2d_from_numpy(eye, sigma, s, device=device)
    return pt.convert.joint_random_walks_from_numpy(sigma, eye, s, device=device)


def oracle_system(name: str) -> tuple:
    """The float64 linear-Gaussian system ``x' = F x + b + w, w ~ N(0, Q)``,
    ``y = H x + v, v ~ N(0, R)``, ``x_0 ~ N(m0, P0)`` of a phase-12 model."""
    import numpy as np

    if name == "ar":
        p = ORACLE_AR
        return (np.array([[p["beta"]]]), np.array([p["alpha"]]), np.array([[p["sigma"] ** 2]]),
                np.array([[p["a"]]]), np.array([[p["s"] ** 2]]), np.array([p["alpha"]]), np.array([[p["sigma"] ** 2]]))
    q = np.diag(np.square(ORACLE_SIGMA2))
    return np.eye(2), np.zeros(2), q, np.eye(2), ORACLE_S2**2 * np.eye(2), np.zeros(2), q


def oracle_data(name: str, missing: int = 0, seed: int = ORACLE_SEED):
    """A phase-12 model's path ``(x, y)``, each ``(T, d)``, simulated in
    float64 from numpy ``seed`` (the draws of the JAX package's
    ``tests/kalman.py``), with ``missing`` rows of ``y`` set to NaN."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x, y = simulate_linear(oracle_system(name), ORACLE_T, rng)
    if missing:
        y[rng.integers(1, ORACLE_T, size=missing)] = np.nan
    return x, y


def kalman_linear(y, system) -> tuple:
    """The float64 Kalman filter of ``system`` (:func:`oracle_system`) over
    ``y`` ``(T, d)``, an all-NaN row predicting only: the filter means
    ``(T, d)`` and the log-likelihood."""
    import numpy as np

    f, b, q, h, r, m, p = system
    means, ll = np.zeros((len(y), len(b))), 0.0
    for t, yt in enumerate(np.asarray(y, np.float64)):
        m, p = f @ m + b, f @ p @ f.T + q
        if not np.isnan(yt).all():
            s = h @ p @ h.T + r
            s_inv, innov = np.linalg.inv(s), yt - h @ m
            gain = p @ h.T @ s_inv
            m, p = m + gain @ innov, p - gain @ h @ p
            ll += -0.5 * (innov @ s_inv @ innov + np.linalg.slogdet(s)[1] + len(yt) * math.log(2 * math.pi))
        means[t] = m
    return means, ll


def oracle_gate(means, ll, kalman_means, kalman_ll) -> tuple:
    """The reference's two readings of a run: the median relative deviation
    of the filter means ``(T, [*batch], [d])`` from the Kalman means ``(T,
    d)``, and the largest relative error of the log-likelihood(s)."""
    import numpy as np

    means = np.asarray(means, np.float64)
    # a scalar state's means are (T,) on one lane, (T, L) on lanes
    km = kalman_means if means.ndim == kalman_means.ndim else kalman_means[:, 0]
    dev = float(np.median(np.abs((km - means) / km)))
    return dev, float(np.max(np.abs((np.asarray(ll, np.float64) - kalman_ll) / kalman_ll)))


def oracle_obs(name: str, y):
    """A model's observations as its filter takes them (a scalar per step for ``"ar"``)."""
    return y[:, 0] if name == "ar" else y


def oracle_cpu_ll(filter_name: str, model_name: str, seed: int) -> float:
    """One phase-12 run on the CPU (a worker process): its log-likelihood."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pyfilter_tpu_torch as pt

    _, y = oracle_data(model_name)
    filt = oracle_filters(pt)[filter_name](oracle_model(pt, model_name, "cpu"), ORACLE_N, device="cpu")
    return float(filt.batch_filter(torch.Generator().manual_seed(seed), oracle_obs(model_name, y)).log_likelihood)


def _cpu_worker(threads: int):
    """A CPU reference worker's torch (on ``threads`` threads) and port."""
    import torch

    torch.set_num_threads(threads)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pyfilter_tpu_torch as pt

    return torch, pt


def sisr_cpu_ll(seed: int) -> float:
    """Phase 4's CPU reference: one SISR run at N_CPU_REF through the plain
    versions (a worker process); its log-likelihood."""
    torch, pt = _cpu_worker(1)
    model = pt.examples.stochastic_volatility_model(KAPPA, GAMMA, SIGMA, MU, NU, TAU, dt=DT, device="cpu")
    filt = pt.SISR(model, N_CPU_REF, record_moments=False, device="cpu")
    return float(filt.batch_filter(torch.Generator().manual_seed(seed), simulate_obs(N_OBS)).log_likelihood)


def smc2_cpu_fit(seed: int) -> tuple:
    """Phase 6's CPU fit (a worker process): the posterior mean and sd by
    name, and its seconds."""
    torch, pt = _cpu_worker(3)
    t0 = time.perf_counter()
    _, mean, sd = smc2_fit(torch, pt, simulate_obs(N_OBS), "cpu", seed)
    return mean, sd, time.perf_counter() - t0


def ness_cpu_fit(seed: int) -> tuple:
    """Phase 9's CPU fit (a worker process): whether its weights are finite,
    the posterior mean and sd by name, and its seconds."""
    torch, pt = _cpu_worker(2)
    t0 = time.perf_counter()
    _, state, _, mean, sd = lorenz_fit(torch, pt, lorenz_data(torch, pt), "cpu", seed)
    return bool(torch.isfinite(state.w).all()), mean, sd, time.perf_counter() - t0

def count_syncs(torch, fn) -> dict:
    """The host syncs ``fn()`` makes on the card, by the line of the port
    (or of torch) that asked for each: ``torch.cuda.set_sync_debug_mode``
    warns on every synchronizing call."""
    import collections
    import warnings

    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    def where(w):
        path = w.filename
        path = os.path.relpath(path, root) if path.startswith(root) else path.split("site-packages/")[-1]
        return f"{path}:{w.lineno}"

    return dict(collections.Counter(where(w) for w in seen if "synchroniz" in str(w.message)).most_common())


def oracle_suite(torch, pt, expand, card, profile: bool = False) -> tuple:
    """Phase 12: the linear-Gaussian oracle suite on the card (module
    docstring). Returns the expand kernel's and the lane kernel's launches
    over its runs and their largest differences from the plain versions on
    the suite's clouds."""
    import numpy as np

    t_phase = time.perf_counter()
    filters = oracle_filters(pt)
    data = {name: oracle_data(name) for name in ("ar", "rw2d", "joint2d")}
    kalman = {name: kalman_linear(y, oracle_system(name)) for name, (_, y) in data.items()}
    counts = {"k1": 0, "lanes": 0}
    card_lls = {key: [] for key in ORACLE_STAT}
    last = {}
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))

    def run(filter_name, model_name, seed, batch=(), missing=0):
        filt = filters[filter_name](oracle_model(pt, model_name, "cuda"), ORACLE_N, batch_shape=batch)
        y = oracle_data(model_name, missing)[1] if missing else data[model_name][1]
        km, kll = kalman_linear(y, oracle_system(model_name)) if missing else kalman[model_name]
        before = (expand.fused_expand.launches, expand.fused_expand_lanes.launches)
        pt.APF.corrections = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = filt.batch_filter(torch.Generator(device="cuda").manual_seed(seed), oracle_obs(model_name, y))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = expand.fused_expand.launches - before[0]
        lanes = expand.fused_expand_lanes.launches - before[1]
        fires = pt.APF.corrections if filter_name.startswith("apf") else filt.n_resamples
        expected = (0, 0) if filter_name.startswith("gpf") else ((0, fires) if batch else (fires, 0))
        if (k1, lanes) != expected:
            raise AssertionError(f"phase 12 {filter_name}/{model_name}: expand launches {k1}, lane launches {lanes}, "
                                 f"resample fires {fires}")
        counts["k1"] += k1
        counts["lanes"] += lanes
        dev, ll_err = oracle_gate(res.filter_means.cpu().numpy(), res.log_likelihood.cpu().numpy(), km, kll)
        label = f"{filter_name}/{model_name}" + (f" lanes={batch[0]} missing={missing}" if batch else "")
        print(f"  {label}: {wall:.4f} s ({wall / ORACLE_T * 1e3:.3f} ms a step), log-likelihood "
              f"{res.log_likelihood.cpu().numpy().round(4).tolist()} (Kalman {kll:.4f}); mean deviation {dev:.5f}, "
              f"log-likelihood error {ll_err:.5f}; expand launches {k1}, lane launches {lanes}")
        if not (dev < ORACLE_TOL and ll_err < ORACLE_TOL):
            raise AssertionError(f"phase 12 {label} fails the oracle gate: deviation {dev}, log-likelihood error "
                                 f"{ll_err} (limit {ORACLE_TOL})")
        return filt, res, wall

    print(f"phase 12: the linear-Gaussian oracle suite, N={ORACLE_N}, T={ORACLE_T}, data seed {ORACLE_SEED}, against "
          f"float64 Kalman filters (gates {ORACLE_TOL}); {ORACLE_STAT_CPU} CPU runs of each of {len(ORACLE_STAT)} "
          f"configurations in {workers} worker processes meanwhile; card {card}")
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_jobs = {key: [pool.submit(oracle_cpu_ll, *key, seed) for seed in range(100, 100 + ORACLE_STAT_CPU)]
                    for key in ORACLE_STAT}
        # warm-up: every filter on a scalar and a 2-D model for 3 steps (the
        # first torch.func and linear-algebra calls set themselves up)
        for name in ("ar", "rw2d"):
            y = oracle_obs(name, data[name][1][:3])
            for make in filters.values():
                make(oracle_model(pt, name, "cuda"), ORACLE_N).batch_filter(torch.Generator(device="cuda"), y)
        runs = ([(f, "ar") for f in sorted(filters)] + [(f, m) for m in ("rw2d", "joint2d") for f in ORACLE_2D])
        host = {}
        for filter_name, model_name in runs:
            reps = ORACLE_STAT_CARD if (filter_name, model_name) in ORACLE_STAT else 1
            for rep in range(reps):
                filt, res, wall = run(filter_name, model_name, rep)
                if (filter_name, model_name) in card_lls:
                    card_lls[filter_name, model_name].append(float(res.log_likelihood))
                if "linearized" in filter_name or filter_name.startswith("gpf"):
                    host.setdefault(f"{filter_name}/{model_name}", []).append(wall / ORACLE_T * 1e3)
            last[filter_name, model_name] = (filt, res)
        for filter_name in ORACLE_BATCHED:
            for missing in (0, ORACLE_MISSING):
                last[filter_name, "lanes", missing] = run(filter_name, "ar", 0, (ORACLE_LANES,), missing)[:2]

        # GPF and the linearized filters: wall per step (host-bound), best of their runs
        print("  ms a step (best run) of the linearized and GPF filters: "
              + ", ".join(f"{k} {min(v):.3f}" for k, v in host.items()))
        for filter_name, model_name in ORACLE_SYNC:
            filt = filters[filter_name](oracle_model(pt, model_name, "cuda"), ORACLE_N)
            y = oracle_obs(model_name, data[model_name][1])[:ORACLE_SYNC_T]
            syncs = count_syncs(torch, lambda: filt.batch_filter(torch.Generator(device="cuda").manual_seed(7), y))
            per_step = {k: v / ORACLE_SYNC_T for k, v in syncs.items()}
            print(f"  host syncs a step, {filter_name}/{model_name} ({ORACLE_SYNC_T} steps): "
                  f"{sum(per_step.values()):.2f}, by source {per_step}")

        hessian_cost(torch, pt, card)

        errs = []
        filt, res = last["sisr-linearized2", "rw2d"]
        state = res.latest_state
        errs.append(check_on_cloud(torch, expand, pt.normalize(state.log_weights), state.x.value.T,
                                   f"phase 12's sisr-linearized2/rw2d cloud (n={ORACLE_N}, d=2)"))
        filt, res = last["apf-nested", "ar"]
        state = res.latest_state
        errs.append(check_on_cloud(torch, expand, pt.normalize(state.log_weights), state.x.value.reshape(1, -1),
                                   f"phase 12's apf-nested/ar cloud (n={ORACLE_N}, d=1)"))
        filt, res = last["sisr-bootstrap", "lanes", 0]
        state = res.latest_state
        lane_err = check_on_cloud(torch, expand, pt.normalize(state.log_weights), state.x.value[None],
                                  f"phase 12's batched sisr-bootstrap/ar cloud (n={ORACLE_N}, L={ORACLE_LANES})")

        local_launches = local_linearization(torch, pt, expand, card)
        counts["k1"] += local_launches

        for key, jobs in cpu_jobs.items():
            cpu_ll, card_ll = np.asarray([j.result() for j in jobs]), np.asarray(card_lls[key])
            gap = abs(card_ll.mean() - cpu_ll.mean())
            limit = 4 * math.sqrt(card_ll.var(ddof=1) / len(card_ll) + cpu_ll.var(ddof=1) / len(cpu_ll))
            print(f"  {key[0]}/{key[1]}: card mean log-likelihood {card_ll.mean():.5f} (sd {card_ll.std(ddof=1):.5f}, "
                  f"{len(card_ll)} runs), CPU {cpu_ll.mean():.5f} (sd {cpu_ll.std(ddof=1):.5f}, {len(cpu_ll)} runs); "
                  f"gap {gap:.5f} (limit {limit:.5f})")
            if not gap < limit:
                raise AssertionError(f"phase 12 {key}: card and CPU log-likelihoods differ by {gap} (> {limit})")

    if profile:
        for filter_name, model_name in ORACLE_SYNC:
            filt = filters[filter_name](oracle_model(pt, model_name, "cuda"), ORACLE_N)
            y = oracle_obs(model_name, data[model_name][1])[:ORACLE_SYNC_T]
            ops = profile_run(torch, f"phase 12, {filter_name}/{model_name} over {ORACLE_SYNC_T} steps",
                              lambda: filt.batch_filter(torch.Generator(device="cuda").manual_seed(8), y))
            print(f"  device operations per step {ops / ORACLE_SYNC_T:.2f}")
    if counts["k1"] == 0 or counts["lanes"] == 0:
        raise AssertionError(f"phase 12 launched the expand kernel {counts['k1']} times, the lane kernel "
                             f"{counts['lanes']} times")
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s; expand launches {counts['k1']}, lane launches "
          f"{counts['lanes']}; GPF runs launched neither; card {card}")
    return counts["k1"], counts["lanes"], max(errs), lane_err


def hessian_cost(torch, pt, card, reps: int = 20) -> None:
    """Host milliseconds of one damped-Newton Hessian at phase 12's size on
    the 2-D walk: the port's columns (``torch.func.jvp`` of the gradient,
    forward over reverse) against rows from ``torch.func.vjp`` (reverse over
    reverse), which give the same symmetric matrix; and of one gradient."""
    from pyfilter_tpu_torch.filters.particle.proposals import utils as putils

    model = oracle_model(pt, "rw2d", "cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    x = pt.timeseries.TimeseriesState(3.0, torch.randn(ORACLE_N, 2, generator=g, device="cuda") * 0.1, 1)
    grad_fn = torch.func.grad(putils._joint_log_prob_fn(model, model.hidden.build_density(x),
                                                       x, torch.tensor([0.1, -0.2], device="cuda")))

    def rows():
        pull = torch.func.vjp(grad_fn, x.value)[1]
        return torch.stack([pull(t)[0] for t in putils._unit_tangents(x.value, 1)], dim=-2)

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def cols():
        return putils._per_particle_hessian(grad_fn, x.value, 1)

    gap = float((cols() - rows()).abs().max() / cols().abs().max())
    print(f"  one Hessian (N={ORACLE_N}, d=2): jvp columns {host_ms(cols):.3f} ms, vjp rows {host_ms(rows):.3f} ms, "
          f"gradient {host_ms(lambda: grad_fn(x.value)):.3f} ms (host, {reps} reps); relative gap {gap:.2e}; "
          f"card {card}")


def local_linearization(torch, pt, expand, card) -> int:
    """Phase 12's LocalLinearization runs: SISR and the APF at LOCAL_N
    particles, with the derivative given and from ``torch.func.jvp``, each
    within 0.1 (relative) of a LOCAL_ORACLE_N-particle bootstrap SISR's
    log-likelihood on the nonlinear benchmark model. Returns the expand
    kernel's launches."""
    import numpy as np

    f32 = np.float32
    props = pt.filters.particle.proposals
    cpu_model = pt.convert.ukf_benchmark_from_numpy(f32(LOCAL_SIGMA), f32(LOCAL_S), device="cpu")
    _, y = cpu_model.sample_states(torch.Generator().manual_seed(LOCAL_SEED), LOCAL_T).get_paths()
    y = y.numpy()
    model = pt.convert.ukf_benchmark_from_numpy(f32(LOCAL_SIGMA), f32(LOCAL_S))
    t0 = time.perf_counter()
    oracle = float(pt.SISR(model, LOCAL_ORACLE_N).batch_filter(torch.Generator(device="cuda").manual_seed(0), y)
                   .log_likelihood)
    print(f"  LocalLinearization on the nonlinear benchmark model, T={LOCAL_T}: bootstrap SISR N={LOCAL_ORACLE_N} "
          f"log-likelihood {oracle:.4f} ({time.perf_counter() - t0:.4f} s)")
    launches = 0
    for derivative in (pt.convert.ukf_benchmark_mean_derivative, None):
        proposal = props.LocalLinearization(f=pt.convert.ukf_benchmark_mean, linearized_f=derivative)
        for cls in (pt.SISR, pt.APF):
            filt = cls(model, LOCAL_N, proposal=proposal)
            before = expand.fused_expand.launches
            pt.APF.corrections = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ll = float(filt.batch_filter(torch.Generator(device="cuda").manual_seed(1), y).log_likelihood)
            wall = time.perf_counter() - t0
            k1 = expand.fused_expand.launches - before
            fires = pt.APF.corrections if cls is pt.APF else filt.n_resamples
            err = abs(ll - oracle) / abs(oracle)
            print(f"  {cls.__name__}(N={LOCAL_N}, LocalLinearization, derivative "
                  f"{'given' if derivative else 'by jvp'}): {wall:.4f} s, log-likelihood {ll:.4f}, relative gap "
                  f"{err:.5f} (limit {ORACLE_TOL}); expand launches {k1} for {fires} resample fires")
            if not (err < ORACLE_TOL and k1 == fires):
                raise AssertionError(f"phase 12 LocalLinearization {cls.__name__}: gap {err}, launches {k1}/{fires}")
            launches += k1
    return launches


# -- phase 13: gradients through the filter ------------------------------------------------------------------
def kalman_ar_ll(beta: float, y, alpha: float = SCORE_ALPHA, sigma: float = SCORE_SIGMA,
                 obs_s: float = SCORE_OBS_S) -> float:
    """The float64 Kalman log-likelihood of phase 13's AR(1) (``x_0 ~
    N(alpha, sigma^2)`` unobserved, the first observation on the first
    propagated state), the exact reference of the score and MLE gates."""
    q, r = sigma**2, obs_s**2
    m, p, ll = alpha, q, 0.0
    for y_t in y.astype("float64").tolist():
        m, p = alpha + beta * m, beta * beta * p + q
        s = p + r
        ll -= 0.5 * (math.log(2.0 * math.pi * s) + (y_t - m) ** 2 / s)
        k = p / s
        m, p = m + k * (y_t - m), (1.0 - k) * p
    return ll


def score_model(pt, beta, device):
    return pt.timeseries.LinearStateSpaceModel(
        pt.timeseries.models.AR(SCORE_ALPHA, beta, SCORE_SIGMA, device=device), (1.0, SCORE_OBS_S))


def score_data(torch, pt, n_obs: int, seed: int):
    """Observations of phase 13's AR(1) at SCORE_BETA, simulated by the port
    on the CPU."""
    model = score_model(pt, SCORE_BETA, "cpu")
    return model.sample_states(torch.Generator().manual_seed(seed), n_obs).get_paths()[1].numpy()


def mle_builder(pt, ctx):
    beta = ctx.named_parameter("beta", pt.distributions.Uniform(
        pt.timeseries.models.parameter(0.0, ctx.device), pt.timeseries.models.parameter(1.0, ctx.device)))
    return score_model(pt, beta, ctx.device)


def ou_builder(pt, ctx):
    """Phase 13e's model: the JAX package's inference test model (an OU
    process with kappa ~ Exp(1), gamma ~ N(0, 1), sigma ~ LogNormal(-2, 1),
    observed with noise OU_OBS)."""
    def const(v):
        return pt.timeseries.models.parameter(v, ctx.device)

    dist = pt.distributions
    k = ctx.named_parameter("kappa", dist.Exponential(const(1.0)))
    g = ctx.named_parameter("gamma", dist.Normal(const(0.0), const(1.0)))
    s = ctx.named_parameter("sigma", dist.LogNormal(const(-2.0), const(1.0)))
    return pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.OrnsteinUhlenbeck(k, g, s, device=ctx.device),
                                               (1.0, OU_OBS))


def ou_log_prior(z):
    """The OU builder's log-prior on the unconstrained values ``(K, 3)``
    (``log kappa``, ``gamma``, ``log sigma``), Jacobians included, in float64."""
    import numpy as np

    return (z[:, 0] - np.exp(z[:, 0]) - 0.5 * z[:, 1] ** 2 - 0.5 * (z[:, 2] + 2.0) ** 2 - math.log(2.0 * math.pi))


def _lane_weights(torch, n, lanes, name, g):
    """Log-weights ``(n, lanes)``: random with lane 0 degenerate (all mass on
    its last particle), zero-weight runs, or every lane degenerate."""
    lw = torch.randn(n, lanes, generator=g, device="cuda") * 2.0
    if name == "zero-runs":
        lw[torch.arange(n, device="cuda") % 3 != 0] = -math.inf
    if name == "degenerate":
        lw[:] = -math.inf
        lw[n // 2] = 0.0
    lw[:, 0] = -math.inf
    lw[n - 1, 0] = 0.0
    return lw


def check_backward(torch, pt, expand, card) -> dict:
    """Phase 13a: both backward kernels against their float64 references on
    the card. Per case: the forward kernel bit-equal to its plain version,
    the backward kernel bit-identical across two launches, and each source's
    gradient within 1e-6 of the sum of |g| over its run of a float64
    ``index_add_`` (scatter-add for lanes). Then each timed at the main
    paths' shapes. Returns each kernel's largest error and times."""
    g = torch.Generator(device="cuda").manual_seed(13)
    out = {}

    def gate(label, grad, ref64, mass):
        err = (grad.double() - ref64).abs()
        bad = err > 1e-6 * mass
        if bool(bad.any()):
            raise AssertionError(f"backward kernel off its float64 reference at {label}: {int(bad.sum())} sources, "
                                 f"worst {float(err.max())}")
        return float(err.max())

    worst, n_cases = 0.0, 0
    for n in (1_000_000, 1_000_003, 100_000, 8193, 1000, 512, 257, 2, 1):
        for name in ("random", "degenerate", "zero-runs"):
            lw = torch.randn(n, generator=g, device="cuda") * 2.0
            if name == "degenerate":
                lw = torch.full((n,), -math.inf, device="cuda")
                lw[n // 2] = 0.0
            elif name == "zero-runs":
                lw[torch.arange(n, device="cuda") % 3 != 0] = -math.inf
            probs = torch.softmax(lw, dim=0)
            for d in (1, 2, 3):
                u = torch.rand((), generator=g, device="cuda")
                v2d = torch.randn(d, n, generator=g, device="cuda")
                fwd, idx = expand.fused_expand(probs, u, v2d)
                ref_fwd, ref_idx = expand._expand_probs_plain(probs, u, v2d)
                if not (torch.equal(idx, ref_idx) and torch.equal(fwd, ref_fwd)):
                    raise AssertionError(f"expand kernel != plain version at n={n} d={d} {name}")
                gr = torch.randn(d, n, generator=g, device="cuda")
                a, b = expand.fused_expand_backward(gr, idx), expand.fused_expand_backward(gr, idx)
                if not torch.equal(a, b):
                    raise AssertionError(f"expand backward kernel not deterministic at n={n} d={d} {name}")
                ref64, mass = float64_scatter(torch, gr, idx)
                worst = max(worst, gate(f"n={n} d={d} {name}", a, ref64, mass))
                n_cases += 1
    torch.cuda.synchronize()
    print(f"phase 13a: expand backward kernel on {n_cases} cases (n in 1e6, 1e6+3, 1e5, 8193, 1000, 512, 257, 2, 1; "
          f"d in 1, 2, 3; random, degenerate and zero-run weights): the same bits at two launches, within 1e-6 of "
          f"each source's run's sum of |g| of a float64 index_add_ (largest error {worst}); the forward kernel bit "
          "for bit its plain version")
    out["k1_err"] = worst

    worst, n_cases = 0.0, 0
    shapes = ((400, 1000), (400, 8), (257, 5), (40, 16), (72, 16), (800, 1000), (3200, 1000), (7104, 40), (7105, 40),
              (2, 9), (512, 64), (300, 4))
    for n, lanes in shapes:
        for name in ("random", "degenerate", "zero-runs"):
            probs = torch.softmax(_lane_weights(torch, n, lanes, name, g), dim=0)
            for d in (1, 2, 3):
                u = torch.rand(lanes, generator=g, device="cuda")
                planes = torch.randn(d, n, lanes, generator=g, device="cuda")
                fwd, idx = expand.fused_expand_lanes(probs, u, planes)
                ref_fwd, ref_idx = expand._expand_lanes_probs_plain(probs, u, planes)
                if not (torch.equal(idx, ref_idx) and torch.equal(fwd, ref_fwd)):
                    raise AssertionError(f"lane kernel != plain version at n={n} L={lanes} d={d} {name}")
                gr = torch.randn(d, n, lanes, generator=g, device="cuda")
                a, b = expand.fused_expand_lanes_backward(gr, idx), expand.fused_expand_lanes_backward(gr, idx)
                if not torch.equal(a, b):
                    raise AssertionError(f"lane backward kernel not deterministic at n={n} L={lanes} d={d} {name}")
                ref64, mass = float64_scatter(torch, gr, idx)
                worst = max(worst, gate(f"n={n} L={lanes} d={d} {name}", a, ref64, mass))
                n_cases += 1
    torch.cuda.synchronize()
    print(f"phase 13a: lane backward kernel on {n_cases} cases ((n, L) in {', '.join(map(str, shapes))}; d in 1, 2, "
          f"3; random weights with a degenerate lane, every lane degenerate, zero-run weights): the same bits at two "
          f"launches, within 1e-6 of each source's run's sum of |g| of a float64 scatter-add (largest error "
          f"{worst}); the forward kernel bit for bit its plain version")
    out["lane_err"] = worst

    # synthetic indices, built directly: runs and gaps at the tile edges
    # (K1T_TILE outputs) and at the lane kernel's row chunks, past its staged rows
    worst, n_cases = 0.0, 0
    k1_sets = [(5 * K1T_TILE + 3, BACKWARD_INDEX_NAMES)] + [
        (n, ("sorted-random", "one-run", "runs-T-1", "gap-edge", "all-last")) for n in
        (K1T_TILE - 1, K1T_TILE, K1T_TILE + 1)] + [(N_PARTICLES, ("one-run", "all-first", "all-last", "sorted-random"))]
    for n, names in k1_sets:
        for name in names:
            idx = torch.from_numpy(backward_indices(n, name, K1T_TILE)).to("cuda")
            for d in (1, 2):
                gr = torch.randn(d, n, generator=g, device="cuda")
                a, b = expand.fused_expand_backward(gr, idx), expand.fused_expand_backward(gr, idx)
                if not torch.equal(a, b):
                    raise AssertionError(f"expand backward kernel not deterministic at n={n} d={d} {name}")
                ref64, mass = float64_scatter(torch, gr, idx)
                worst = max(worst, gate(f"n={n} d={d} {name} (synthetic)", a, ref64, mass))
                n_cases += 1
    torch.cuda.synchronize()
    print(f"phase 13a: expand backward kernel on {n_cases} synthetic index cases (tile {K1T_TILE}; n in "
          f"{', '.join(str(n) for n, _ in k1_sets)}; d in 1, 2; {', '.join(BACKWARD_INDEX_NAMES)}): the same bits at "
          f"two launches, within 1e-6 of each source's run's sum of |g| of a float64 scatter-add (largest error "
          f"{worst})")
    out["k1_err"] = max(out["k1_err"], worst)

    worst, n_cases = 0.0, 0
    lane_sets = ((400, 9), (400, 1000), (65, 7), (64, 1), (2, 9), (1, 1), (4096, 7), (LANE_STAGED_ROWS, 9),
                 (LANE_STAGED_ROWS + 1, 7), (7105, 9))
    for n, lanes in lane_sets:
        for shift in (0, 5):
            idx = torch.from_numpy(backward_lane_indices(n, lanes, shift)).to("cuda")
            for d in (1, 2, 5):
                gr = torch.randn(d, n, lanes, generator=g, device="cuda")
                a, b = expand.fused_expand_lanes_backward(gr, idx), expand.fused_expand_lanes_backward(gr, idx)
                if not torch.equal(a, b):
                    raise AssertionError(f"lane backward kernel not deterministic at n={n} L={lanes} d={d} (synthetic)")
                ref64, mass = float64_scatter(torch, gr, idx)
                worst = max(worst, gate(f"n={n} L={lanes} d={d} shift {shift} (synthetic)", a, ref64, mass))
                n_cases += 1
    torch.cuda.synchronize()
    print(f"phase 13a: lane backward kernel on {n_cases} synthetic index cases ((n, L) in "
          f"{', '.join(map(str, lane_sets))}; every lane one of the {len(BACKWARD_INDEX_NAMES)} kinds with the "
          f"chunk's rows as its tile, two rotations; d in 1, 2, 5): the same bits at two launches, within 1e-6 of "
          f"each source's run's sum of |g| of a float64 scatter-add (largest error {worst})")
    out["lane_err"] = max(out["lane_err"], worst)

    # times at the main paths' shapes: K1 n = 1e6, d = 1; the lane kernel n = 400, L = 1000, d = 2
    n = N_PARTICLES
    probs = torch.softmax(torch.randn(n, generator=g, device="cuda"), dim=0)
    gr = torch.randn(1, n, generator=g, device="cuda")
    _, idx = expand.fused_expand(probs, torch.rand((), generator=g, device="cuda"), gr)
    il, buf = idx.long(), torch.zeros_like(gr)
    out["k1_ms"] = time_cold(torch, lambda: expand.fused_expand_backward(gr, idx))
    out["k1_plain_ms"] = time_cold(torch, lambda: expand._expand_backward_plain(gr, idx))
    out["k1_library_ms"] = time_cold(torch, lambda: buf.index_add_(1, il, gr))
    out["k1_bound_ms"] = (4 * n + 4 * n + 4 * n) / HBM_BYTES_PER_S * 1e3  # g, idx read; gradient written
    deg = torch.zeros(n, device="cuda")
    deg[n // 2] = 1.0
    _, deg_idx = expand.fused_expand(deg, torch.rand((), generator=g, device="cuda"), gr)
    deg_il = deg_idx.long()
    out["k1_degenerate_ms"] = time_cold(torch, lambda: expand.fused_expand_backward(gr, deg_idx))
    out["k1_library_degenerate_ms"] = time_cold(torch, lambda: buf.index_add_(1, deg_il, gr))
    print(f"phase 13a: expand backward at n={n}, d=1 (L2 flushed, median of 20): kernel {out['k1_ms']} ms, plain "
          f"(zeros + index_add_) {out['k1_plain_ms']} ms, library (index_add_) {out['k1_library_ms']} ms, bound "
          f"{out['k1_bound_ms']} ms (bytes), {out['k1_bound_ms'] / out['k1_ms']:.4f} of the bound; one run of n "
          f"(every output from one source): kernel {out['k1_degenerate_ms']} ms, index_add_ "
          f"{out['k1_library_degenerate_ms']} ms; card {card}")

    n, lanes, d = SMC2_N, SMC2_K, 2
    probs = torch.softmax(torch.randn(n, lanes, generator=g, device="cuda"), dim=0)
    gr = torch.randn(d, n, lanes, generator=g, device="cuda")
    _, idx = expand.fused_expand_lanes(probs, torch.rand(lanes, generator=g, device="cuda"), gr)
    il, buf = idx.long().unsqueeze(0).expand(d, n, lanes), torch.zeros_like(gr)
    out["lane_ms"] = time_cold(torch, lambda: expand.fused_expand_lanes_backward(gr, idx))
    out["lane_plain_ms"] = time_cold(torch, lambda: expand._expand_lanes_backward_plain(gr, idx))
    out["lane_library_ms"] = time_cold(torch, lambda: buf.scatter_add_(1, il, gr))
    out["lane_bound_ms"] = (4 * d * n * lanes + 4 * n * lanes + 4 * d * n * lanes) / HBM_BYTES_PER_S * 1e3
    deg_idx = torch.full((n, lanes), n // 2, dtype=torch.int32, device="cuda")
    deg_il = deg_idx.long().unsqueeze(0).expand(d, n, lanes)
    out["lane_degenerate_ms"] = time_cold(torch, lambda: expand.fused_expand_lanes_backward(gr, deg_idx))
    out["lane_library_degenerate_ms"] = time_cold(torch, lambda: buf.scatter_add_(1, deg_il, gr))
    print(f"phase 13a: lane backward at n={n}, L={lanes}, d={d} (L2 flushed, median of 20): kernel {out['lane_ms']} "
          f"ms, plain (zeros + scatter_add_) {out['lane_plain_ms']} ms, library (scatter_add_) "
          f"{out['lane_library_ms']} ms, bound {out['lane_bound_ms']} ms (bytes), "
          f"{out['lane_bound_ms'] / out['lane_ms']:.4f} of the bound; every lane one run of n: kernel "
          f"{out['lane_degenerate_ms']} ms, scatter_add_ {out['lane_library_degenerate_ms']} ms; card {card}")

    # times where the gradient paths launch the kernels (13b, 13c)
    out["path_ms"] = {}
    for label, gr, idx in gradient_path_inputs(torch, expand, g):
        kernel = expand.fused_expand_backward if idx.dim() == 1 else expand.fused_expand_lanes_backward
        out["path_ms"][label] = (time_cold(torch, lambda: kernel(gr, idx)),
                                 time_cold(torch, library_backward(torch, gr, idx)))
    print("phase 13a: at the gradient paths' shapes (L2 flushed, median of 20; kernel ms, library ms): "
          + "; ".join(f"{k} {v[0]}, {v[1]}" for k, v in out["path_ms"].items()) + f"; card {card}")
    out["collapsed_step_ms"] = collapsed_sisr_step(torch, pt, expand, card)
    return out


def float64_scatter(torch, g, idx):
    """The float64 transpose of the gather and each source's sum of |g| (its
    run's mass), ``g`` ``(d, n[, L])``, ``idx`` ``(n[, L])``."""
    il = idx.long().unsqueeze(0).expand(g.shape)
    ref = torch.zeros(g.shape, dtype=torch.float64, device=g.device).scatter_add_(1, il, g.double())
    mass = torch.zeros(g.shape, dtype=torch.float64, device=g.device).scatter_add_(1, il, g.double().abs())
    return ref, mass


def gradient_path_inputs(torch, expand, g) -> list:
    """``(label, gradient, indices)`` at the shapes where the gradient paths
    launch the backward kernels: K1T at n = 256, d = 1 (13c) and n = 512, d =
    1 and 2 (13b's SISR and APF), the lane kernel at (512, 64), d = 1 and 2
    (13b), each on indices from the forward kernel on random weights."""
    cases = []
    for n, d in ((MLE_N, 1), (SCORE_N, 1), (SCORE_N, 2)):
        gr = torch.randn(d, n, generator=g, device="cuda")
        probs = torch.softmax(torch.randn(n, generator=g, device="cuda"), dim=0)
        cases.append((f"K1T n={n} d={d}", gr,
                      expand.fused_expand(probs, torch.rand((), generator=g, device="cuda"), gr)[1]))
    for d in (1, 2):
        n, lanes = SCORE_N, SCORE_SEEDS
        gr = torch.randn(d, n, lanes, generator=g, device="cuda")
        probs = torch.softmax(torch.randn(n, lanes, generator=g, device="cuda"), dim=0)
        cases.append((f"K2T n={n} L={lanes} d={d}", gr,
                      expand.fused_expand_lanes(probs, torch.rand(lanes, generator=g, device="cuda"), gr)[1]))
    return cases


def library_backward(torch, gr, idx):
    """The one PyTorch call that computes a backward kernel's function:
    ``index_add_`` (``scatter_add_`` over lanes) into a zeroed buffer made
    here, untimed."""
    buf = torch.zeros_like(gr)
    if idx.dim() == 1:
        il = idx.long()
        return lambda: buf.index_add_(1, il, gr)
    il = idx.long().unsqueeze(0).expand(gr.shape)
    return lambda: buf.scatter_add_(1, il, gr)


def collapsed_sisr_step(torch, pt, expand, card, kernel=None, label: str = "") -> float:
    """One line: the host ms of a differentiable SISR step, forward and
    backward, at N = 1e6 on a collapsed cloud (phase 13's AR(1) filtered
    with its level alpha COLLAPSE_ALPHA, far from the truth 0, so every
    observation leaves a handful of particles): COLLAPSE_T steps and the
    log-likelihood's backward, after a warm-up run, the card synced. The
    warm-up run records the longest run of copies each backward call sums.
    ``kernel`` replaces the port's K1T (another tree's, ``--backward-ab``)."""
    y = score_data(torch, pt, COLLAPSE_T, 3)
    kernel = kernel or expand.fused_expand_backward
    original = expand.fused_expand_backward
    longest, calls = [], [0]

    def counted(gr, idx):
        calls[0] += 1
        return kernel(gr, idx)

    def recording(gr, idx):
        longest.append(int(torch.bincount(idx.long()).max()))
        return kernel(gr, idx)

    def run(seed):
        alpha = torch.tensor(COLLAPSE_ALPHA, device="cuda", requires_grad=True)
        model = pt.timeseries.LinearStateSpaceModel(
            pt.timeseries.models.AR(alpha, SCORE_BETA, SCORE_SIGMA, device="cuda"), (1.0, SCORE_OBS_S))
        res = pt.SISR(model, N_PARTICLES, differentiable=True).batch_filter(
            torch.Generator(device="cuda").manual_seed(seed), y)
        res.log_likelihood.backward()
        return float(alpha.grad)

    # the port's wrapper counts its launches on the module's name, which these
    # stand in for while they run: they carry the count, handed back after
    counted.launches = recording.launches = original.launches
    try:
        expand.fused_expand_backward = recording
        run(0)
        counted.launches = recording.launches
        expand.fused_expand_backward = counted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad = run(1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / COLLAPSE_T * 1e3
    finally:
        original.launches = expand.fused_expand_backward.launches
        expand.fused_expand_backward = original
    longest.sort()
    print(f"phase 13a{label}: differentiable SISR at N={N_PARTICLES} on a collapsed cloud (alpha {COLLAPSE_ALPHA}, "
          f"truth 0), T={COLLAPSE_T}: {ms:.3f} ms a step forward and backward (host clock, synced); the warm-up's "
          f"backward calls summed runs of up to {longest[-1] if longest else 0} copies (median "
          f"{longest[len(longest) // 2] if longest else 0}); backward calls {calls[0]}; gradient {grad:.4f}; "
          f"card {card}")
    if not (math.isfinite(grad) and calls[0] > 0):
        raise AssertionError(f"phase 13a: the collapsed SISR step gave gradient {grad} over {calls[0]} backward calls")
    return ms


def backward_ab(torch, pt, expand, card, tree: str) -> int:
    """``--backward-ab TREE``: TREE's two backward kernels (built here from
    TREE's ``csrc`` sources with the port's flags into ``build/ab/``) against
    this tree's, in turns (TREE, this, this, TREE) on one card, L2 flushed,
    median of 20 each: at the gradient paths' shapes (13b, 13c), at the main
    paths' shapes, on a degenerate cloud; then the collapsed SISR step of
    phase 13a in situ with each tree's K1T in the same turns. Each kernel is
    first held to the float64 gate of phase 13a on each input. Prints one
    JSON line."""
    import ctypes

    from pyfilter_tpu_torch.ops import _build

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    started = {}
    for name in ("expand", "expand_lanes"):
        lib = os.path.join(out_dir, f"lib{name}.so")
        src = os.path.join(os.path.abspath(tree), "pyfilter_tpu_torch", "ops", "csrc", f"{name}.cu")
        started[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in started.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{tree}: {name}.cu did not build\n{text}")
        libs[name] = ctypes.CDLL(lib)
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    k1_fn = libs["expand"].pf_expand_backward
    k1_fn.argtypes, k1_fn.restype = [ptr] * 3 + [cint] * 2 + [ptr], cint
    lane_fn = libs["expand_lanes"].pf_expand_lanes_backward
    lane_fn.argtypes, lane_fn.restype = [ptr] * 3 + [cint] * 3 + [ptr], cint

    def old_k1(gr, idx):
        out = torch.empty_like(gr)
        if k1_fn(gr.data_ptr(), idx.data_ptr(), out.data_ptr(), gr.shape[1], gr.shape[0],
                 torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("the other tree's expand backward kernel did not launch")
        return out

    def old_lanes(gr, idx):
        out = torch.empty_like(gr)
        if lane_fn(gr.data_ptr(), idx.data_ptr(), out.data_ptr(), gr.shape[1], gr.shape[2], gr.shape[0],
                   torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("the other tree's lane backward kernel did not launch")
        return out

    g = torch.Generator(device="cuda").manual_seed(29)
    inputs = gradient_path_inputs(torch, expand, g)
    n = N_PARTICLES
    gr = torch.randn(1, n, generator=g, device="cuda")
    probs = torch.softmax(torch.randn(n, generator=g, device="cuda"), dim=0)
    inputs.append((f"K1T n={n} d=1", gr, expand.fused_expand(probs, torch.rand((), generator=g, device="cuda"), gr)[1]))
    inputs.append((f"K1T n={n} d=1 one run", gr, torch.full((n,), n // 2, dtype=torch.int32, device="cuda")))
    n, lanes = SMC2_N, SMC2_K
    gr = torch.randn(2, n, lanes, generator=g, device="cuda")
    probs = torch.softmax(torch.randn(n, lanes, generator=g, device="cuda"), dim=0)
    inputs.append((f"K2T n={n} L={lanes} d=2", gr,
                   expand.fused_expand_lanes(probs, torch.rand(lanes, generator=g, device="cuda"), gr)[1]))
    inputs.append((f"K2T n={n} L={lanes} d=2 one run a lane", gr,
                   torch.full((n, lanes), n // 2, dtype=torch.int32, device="cuda")))
    rows = {}
    for label, gr, idx in inputs:
        lane = idx.dim() == 2
        new = expand.fused_expand_lanes_backward if lane else expand.fused_expand_backward
        old = old_lanes if lane else old_k1
        ref64, mass = float64_scatter(torch, gr, idx)
        for who, fn in (("parent", old), ("change", new)):
            bad = int(((fn(gr, idx).double() - ref64).abs() > 1e-6 * mass).sum())
            if bad:
                raise AssertionError(f"--backward-ab: {who} kernel off the float64 scatter-add at {label} ({bad})")
        t = [time_cold(torch, lambda f=f: f(gr, idx)) for f in (old, new, new, old)]
        rows[label] = {"parent_ms": [t[0], t[3]], "change_ms": [t[1], t[2]],
                       "library_ms": time_cold(torch, library_backward(torch, gr, idx))}
        print(f"--backward-ab {label}: parent {t[0]}, {t[3]} ms; change {t[1]}, {t[2]} ms; library "
              f"{rows[label]['library_ms']} ms")
    steps = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        steps[who].append(collapsed_sisr_step(torch, pt, expand, card, old_k1 if who == "parent" else None,
                                              f" ({who} K1T)"))
    print(json.dumps({"tree": os.path.abspath(tree), "card": card, "rows": rows, "collapsed_step_ms": steps}))
    return 0


def _launch_counts(expand) -> tuple:
    return (expand.fused_expand.launches, expand.fused_expand_lanes.launches, expand.fused_expand_backward.launches,
            expand.fused_expand_lanes_backward.launches)


def _zero_counts(expand) -> None:
    for fn in (expand.fused_expand, expand.fused_expand_lanes, expand.fused_expand_backward,
               expand.fused_expand_lanes_backward):
        fn.launches = 0


def score_gate(torch, pt, expand, card) -> dict:
    """Phase 13b: ``tests/test_differentiable.py``'s score gate at its own
    size on the card: the mean gradient in beta of SISR (ESS threshold 2, a
    resample on every step) and APF log-likelihoods over SCORE_SEEDS runs of
    one lane (K1) and over one run of SCORE_SEEDS lanes (the lane kernel),
    each within 4 SEM + 5% of the float64 Kalman score; the backward kernels
    launched once per resample whose gathered values carry a gradient (all
    but SISR's first); the uncorrected SISR gradient
    further from the score. Returns the launches by kernel."""
    import numpy as np

    y = score_data(torch, pt, SCORE_T, 0)
    h = 1e-6
    exact = (kalman_ar_ll(SCORE_BETA0 + h, y) - kalman_ar_ll(SCORE_BETA0 - h, y)) / (2 * h)
    launches = [0, 0, 0, 0]
    mean_err = {}
    for cls in (pt.SISR, pt.APF):
        kw = {"ess_threshold": 2.0} if cls is pt.SISR else {}
        for flag in ((True, False) if cls is pt.SISR else (True,)):
            for lanes in (0, SCORE_SEEDS):
                _zero_counts(expand)
                t0 = time.perf_counter()
                if lanes:
                    beta = torch.full((lanes,), SCORE_BETA0, device="cuda", requires_grad=True)
                    filt = cls(score_model(pt, beta, "cuda"), SCORE_N, batch_shape=(lanes,), differentiable=flag,
                               **kw)
                    res = filt.batch_filter(torch.Generator(device="cuda").manual_seed(1000), y)
                    res.log_likelihood.sum().backward()
                    grads = beta.grad.cpu().numpy().astype(np.float64)
                else:
                    grads = []
                    for seed in range(SCORE_SEEDS):
                        beta = torch.tensor(SCORE_BETA0, device="cuda", requires_grad=True)
                        filt = cls(score_model(pt, beta, "cuda"), SCORE_N, differentiable=flag, **kw)
                        res = filt.batch_filter(torch.Generator(device="cuda").manual_seed(seed), y)
                        res.log_likelihood.backward()
                        grads.append(float(beta.grad))
                    grads = np.asarray(grads)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = _launch_counts(expand)
                fwd, bwd = (counts[1], counts[3]) if lanes else (counts[0], counts[2])
                mean, sem = float(grads.mean()), float(grads.std(ddof=1) / math.sqrt(len(grads)))
                limit = 4 * sem + 0.05 * abs(exact)
                label = f"{cls.__name__}{'' if flag else ' uncorrected'}, {f'{lanes} lanes' if lanes else f'{SCORE_SEEDS} runs of one lane'}"
                print(f"phase 13b: {label} (N={SCORE_N}, T={SCORE_T}): mean gradient {mean:.6f}, SEM {sem:.6f}, "
                      f"float64 Kalman score {exact:.6f}, gap {mean - exact:+.6f} (limit {limit:.6f}); {wall:.3f} s; "
                      f"forward launches {fwd}, backward launches {bwd}; card {card}")
                if not np.isfinite(grads).all():
                    raise AssertionError(f"phase 13b {label}: non-finite gradients")
                if flag:
                    if not abs(mean - exact) < limit:
                        raise AssertionError(f"phase 13b {label}: mean gradient {mean} is {abs(mean - exact)} from the "
                                             f"score {exact} (> {limit})")
                    # every step resamples; the first step's SISR resample gathers the
                    # initial draws, which do not depend on beta, so no gradient flows
                    # back through it (the APF's gathers its pre-weights too, which do)
                    expected = SCORE_T * (1 if lanes else SCORE_SEEDS)
                    expected_bwd = expected - (1 if lanes else SCORE_SEEDS) * (cls is pt.SISR)
                    if not (fwd == expected and bwd == expected_bwd):
                        raise AssertionError(f"phase 13b {label}: {fwd} forward and {bwd} backward launches for "
                                             f"{expected} resamples ({expected_bwd} carrying a gradient)")
                launches = [a + b for a, b in zip(launches, counts)]
                mean_err[(cls.__name__, flag, lanes)] = abs(mean - exact)
    for lanes in (0, SCORE_SEEDS):
        if not mean_err[("SISR", True, lanes)] < mean_err[("SISR", False, lanes)]:
            raise AssertionError(f"phase 13b: the uncorrected SISR gradient ({'lanes' if lanes else 'one lane'}) is "
                                 "no further from the score than the corrected one")
    return dict(zip(("k1", "lanes", "k1_backward", "lanes_backward"), launches))


def mle_gate(torch, pt, expand, card) -> dict:
    """Phase 13c: ``fit_mle`` at ``test_fit_mle_recovers_beta``'s size on the
    card, within MLE_TOL of the float64 Kalman MLE on a 60-point grid, its
    loss lower at the end. Returns the launches by kernel."""
    import numpy as np

    y = score_data(torch, pt, MLE_T, 5)
    betas = np.linspace(0.4, 0.99, 60)
    mle = float(betas[int(np.argmax([kalman_ar_ll(b, y) for b in betas]))])
    _zero_counts(expand)
    t0 = time.perf_counter()
    res = pt.inference.fit_mle(lambda ctx: mle_builder(pt, ctx), y, lambda b: pt.SISR(b, MLE_N),
                               torch.Generator(device="cuda").manual_seed(11), num_steps=MLE_STEPS,
                               learning_rate=MLE_LR)
    losses = res.losses.cpu().numpy()
    wall = time.perf_counter() - t0
    counts = _launch_counts(expand)
    fitted = float(res.parameters()["beta"])
    print(f"phase 13c: fit_mle(SISR({MLE_N}), T={MLE_T}, {MLE_STEPS} Adam steps, lr {MLE_LR}): beta {fitted:.6f}, "
          f"float64 Kalman MLE {mle:.6f} (gap {fitted - mle:+.6f}, limit {MLE_TOL}); loss first 10 "
          f"{losses[:10].mean():.4f}, last 10 {losses[-10:].mean():.4f}; {wall:.3f} s, {wall / MLE_STEPS * 1e3:.3f} ms "
          f"a step; expand launches {counts[0]}, backward {counts[2]}; card {card}")
    if not (np.isfinite(losses).all() and abs(fitted - mle) < MLE_TOL):
        raise AssertionError(f"phase 13c: fit_mle gave beta {fitted}, the Kalman MLE is {mle}")
    if not losses[-10:].mean() < losses[:10].mean():
        raise AssertionError("phase 13c: fit_mle's loss did not fall")
    if not (counts[0] == counts[2] > 0):
        raise AssertionError(f"phase 13c: {counts[0]} forward and {counts[2]} backward expand launches")
    return dict(zip(("k1", "lanes", "k1_backward", "lanes_backward"), counts))


def nutria_svi(torch, pt, expand, card) -> dict:
    """Phase 13d: the reference's nutria notebook at ``examples/nutria_svi.py``'s
    full size on the card, from ``nutria_start`` (every lane at the priors'
    means) with the guide's initial scale NUTRIA_INIT_SCALE: the loss lower
    over the last 50 steps than the first 50, a finite guide, each
    posterior median within NUTRIA_TOL sds between seeds of the JAX
    package's fits (NUTRIA_JAX), with one mean guide sd as the floor of that
    limit. Returns the launches by kernel."""
    import numpy as np

    y = nutria_data()
    ctx = pt.inference.make_context(generator=torch.Generator(device="cuda").manual_seed(20))
    ctx.set_batch_shape((NUTRIA_SAMPLES,))
    build = lambda c: pt.examples.nutria_builder(c, num_obs=NUTRIA_T)  # noqa: E731
    build(ctx)
    for name, value in nutria_start(NUTRIA_SAMPLES).items():
        ctx.update_parameter(name, value)
    _zero_counts(expand)
    t0 = time.perf_counter()
    res = pt.inference.fit_svi(build, y, lambda b: pt.APF(b, NUTRIA_N),
                               torch.Generator(device="cuda").manual_seed(21),
                               num_steps=NUTRIA_STEPS, num_elbo_samples=NUTRIA_SAMPLES, learning_rate=NUTRIA_LR,
                               context=ctx, init_scale=NUTRIA_INIT_SCALE)
    losses = res.losses.cpu().numpy()
    wall = time.perf_counter() - t0
    counts = _launch_counts(expand)
    quantiles = res.posterior_quantiles()
    print(f"phase 13d: fit_svi(nutria_builder, APF({NUTRIA_N}), T={NUTRIA_T}, {NUTRIA_STEPS} Adam steps, "
          f"{NUTRIA_SAMPLES} ELBO samples, lr {NUTRIA_LR}, init scale {NUTRIA_INIT_SCALE}): {wall:.3f} s, "
          f"{wall / NUTRIA_STEPS * 1e3:.3f} ms a step; loss first 50 {losses[:50].mean():.4f}, last 50 "
          f"{losses[-50:].mean():.4f}; lane kernel launches {counts[1]} (backward {counts[3]}); card {card}")
    if not (np.isfinite(losses).all() and bool(torch.isfinite(res.guide.loc).all())
            and bool(torch.isfinite(res.guide.log_scale).all())):
        raise AssertionError("phase 13d: the guide or the loss is not finite")
    if not losses[-50:].mean() < losses[:50].mean():
        raise AssertionError("phase 13d: the ELBO did not improve")
    expected = NUTRIA_STEPS * NUTRIA_T
    if not (counts[1] == expected and counts[3] == 0 and counts[0] == 0):
        raise AssertionError(f"phase 13d: lane kernel launches {counts[1]} for {expected} APF steps, backward "
                             f"{counts[3]} (the filter runs outside the graph)")
    for name, qs in quantiles.items():
        lo, med, hi = (float(np.asarray(qs[q])) for q in (0.05, 0.5, 0.95))
        j_mean, j_sd, j_guide_sd = NUTRIA_JAX[name]
        limit = max(NUTRIA_TOL * j_sd, j_guide_sd)
        truth = NUTRIA_TRUE[name] ** 2 if name.startswith("sigma") else NUTRIA_TRUE[name]
        gap = med - j_mean
        print(f"  {name:>7s}: median {med: .5f} [5% {lo: .5f}, 95% {hi: .5f}] (truth {truth: .5f}); JAX fits' median "
              f"{j_mean: .5f}, sd between seeds {j_sd:.5f}; gap {gap:+.5f} = {gap / j_sd:+.3f} sds (limit {limit:.5f}"
              f" = max({NUTRIA_TOL} sds, guide sd {j_guide_sd:.5f}))")
        if not abs(gap) < limit:
            raise AssertionError(f"phase 13d: {name}'s posterior median {med} is {gap} from the JAX fits' "
                                 f"(limit {limit})")
    return dict(zip(("k1", "lanes", "k1_backward", "lanes_backward"), counts))


def ou_data(torch, pt):
    """Phase 13e's observations: OU_T steps of the true OU model, simulated by
    the port on the CPU (seed 5)."""
    model = pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.OrnsteinUhlenbeck(*OU_TRUE, device="cpu"),
                                                (1.0, OU_OBS))
    return model.sample_states(torch.Generator().manual_seed(5), OU_T).get_paths()[1].numpy()


def ou_pmmh(torch, pt, y, proposal, seed: int):
    """One phase-13e PMMH fit: the algorithm, its result and seconds."""
    from pyfilter_tpu_torch.filters.particle.proposals import LinearGaussianObservations

    ctx = pt.inference.make_context(generator=torch.Generator(device="cuda").manual_seed(seed))
    filt = pt.APF(lambda c: ou_builder(pt, c), OU_N, proposal=LinearGaussianObservations(), record_states=True)
    alg = pt.inference.PMMH(filt, OU_SAMPLES, num_chains=OU_CHAINS, proposal=proposal, context=ctx,
                            generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    t0 = time.perf_counter()
    state = alg.fit(y, logging=pt.inference.logging.DefaultLogger())
    torch.cuda.synchronize()
    return alg, state, time.perf_counter() - t0


def _host_log_density(kernel, x):
    """``kernel``'s log-density at ``x`` ``(K, D)``, on the host in float64:
    a diagonal Normal's or a MultivariateNormal's (from its loc and scale)."""
    import numpy as np

    x = x.double().cpu().numpy()
    if hasattr(kernel, "scale_tril"):
        loc, tril = kernel.loc.double().cpu().numpy(), kernel.scale_tril.double().cpu().numpy()
        z = np.stack([np.linalg.solve(tril[k], x[k] - loc[k]) for k in range(len(x))])
        return (-0.5 * (z**2).sum(-1) - np.log(np.diagonal(tril, axis1=-2, axis2=-1)).sum(-1)
                - 0.5 * x.shape[-1] * math.log(2 * math.pi))
    loc, scale = kernel.base_dist.loc.double().cpu().numpy(), kernel.base_dist.scale.double().cpu().numpy()
    return (-0.5 * ((x - loc) / scale) ** 2 - np.log(scale) - 0.5 * math.log(2 * math.pi)).sum(-1)


def gradient_transition_gate(torch, alg, state, y) -> None:
    """Phase 13e's gate on the MALA transition: one more update from the
    fit's last state, decided twice by ``pmmh_accept`` with log-uniforms
    PMMH_BRACKET nats below and above the acceptance log-ratio computed on
    the host in float64: the log-likelihoods read back, the priors and their
    Jacobians by formula, and the forward and reverse proposal densities from
    the two kernels' loc and scale (the reverse kernel built on the
    candidate's re-filter with the generator state ``pmmh_accept`` then
    starts from). Every chain must accept below and reject above; the next
    kernel must be the candidate's where it accepted and the current one's
    where it rejected. A dropped or reversed Hastings term moves the card's
    ratio by the term itself."""
    import numpy as np

    from pyfilter_tpu_torch.inference.batch.mcmc.utils import pmmh_accept

    gen = torch.Generator(device="cuda").manual_seed(7)
    ctx, proposal = alg.context, alg._proposal
    kernel = proposal.build(ctx, state, alg.filter, y, gen)
    z = ctx.stack_parameters(constrained=False)
    rvs = kernel.sample(gen, ())
    proposal_ctx = ctx.unstack_parameters(rvs, constrained=False)
    proposal_filter = alg.filter.initialize_model(proposal_ctx)
    new_res = proposal_filter.batch_filter(gen, y)
    build_state = gen.get_state()
    reverse = proposal.build(proposal_ctx, state.replicate(new_res), proposal_filter, y, gen)
    z64, rvs64 = z.double().cpu().numpy(), rvs.double().cpu().numpy()
    hastings = _host_log_density(reverse, z) - _host_log_density(kernel, rvs)
    ratio = (new_res.log_likelihood.double().cpu().numpy() - state.filter_state.log_likelihood.double().cpu().numpy()
             + ou_log_prior(rvs64) - ou_log_prior(z64) + hastings)
    second = hasattr(kernel, "scale_tril")
    for sign, want in ((-1.0, True), (1.0, False)):
        gen.set_state(build_state)
        log_u = torch.tensor(ratio + sign * PMMH_BRACKET, dtype=z.dtype, device=z.device)
        step = pmmh_accept(ctx, state, proposal, kernel, rvs, proposal_ctx, proposal_filter, new_res, log_u, y, gen,
                           mutate_kernel=True)
        accepted = step.accepted.cpu().numpy()
        if not (accepted == want).all():
            raise AssertionError(f"gradient PMMH acceptance {accepted.tolist()} with log u {PMMH_BRACKET} nats "
                                 f"{'below' if want else 'above'} the host's log-ratio {ratio.tolist()}")
        at = (reverse if want else kernel)
        got, ref = (step.proposal_kernel.loc, at.loc) if second else (step.proposal_kernel.base_dist.loc,
                                                                       at.base_dist.loc)
        # the candidate's kernel was built again inside pmmh_accept from the same generator state
        if not torch.allclose(got, ref, rtol=1e-6, atol=0.0):
            raise AssertionError(f"after {'accepting' if want else 'rejecting'} the next kernel is not the "
                                 f"{'candidate' if want else 'current'} one's")
    print(f"  transition gate ({'second' if second else 'first'} order): each of {len(ratio)} chains accepts "
          f"{PMMH_BRACKET} nats below the host's float64 log-ratio {np.round(ratio, 6).tolist()} (Hastings terms "
          f"{np.round(hastings, 6).tolist()}) and rejects above it; the next kernel follows the chain")


def gradient_pmmh(torch, pt, expand, card) -> dict:
    """Phase 13e: PMMH with the gradient proposals of both orders and the
    random walk at the same budget on the OU model; finite chains that
    move, the transition gate of both gradient orders, each proposal's mean
    squared jump distance and the chains' split R-hat and ESS. Returns the
    launches by kernel."""
    import numpy as np

    y = ou_data(torch, pt)
    proposals = (("GradientBasedProposal(2e-2)", pt.inference.GradientBasedProposal(2e-2)),
                 ("GradientBasedProposal(5e-2, second order)",
                  pt.inference.GradientBasedProposal(5e-2, use_second_order=True)),
                 ("RandomWalk(2e-2)", pt.inference.RandomWalk(2e-2)))
    launches = [0, 0, 0, 0]
    msjd = {}
    for name, proposal in proposals:
        _zero_counts(expand)
        alg, state, wall = ou_pmmh(torch, pt, y, proposal, 40)
        counts = _launch_counts(expand)
        launches = [a + b for a, b in zip(launches, counts)]
        arr = state.as_arrays()
        if not all(np.isfinite(v).all() for v in arr.values()):
            raise AssertionError(f"phase 13e {name}: non-finite chains")
        msjd[name] = sum(float(np.mean((v[1:] - v[:-1]) ** 2)) for v in arr.values())
        summary = pt.inference.summarize_chains(state)
        steps = (OU_SAMPLES + 1) * OU_T
        print(f"phase 13e: PMMH(APF({OU_N}, LinearGaussianObservations, record_states), {OU_SAMPLES} samples, "
              f"{OU_CHAINS} chains, {name}), T={OU_T}: {wall:.3f} s; MSJD {msjd[name]:.6g}; lane kernel launches "
              f"{counts[1]} for {steps} APF lane steps; card {card}")
        for p, s in summary.items():
            print(f"  {p:>5s}: mean {float(s['mean']):.5f} sd {float(s['std']):.5f} split R-hat "
                  f"{float(s['rhat']):.4f} ESS {float(s['ess']):.2f}")
        if not msjd[name] > 0:
            raise AssertionError(f"phase 13e {name}: the chains did not move")
        if counts[1] != steps:
            raise AssertionError(f"phase 13e {name}: {counts[1]} lane kernel launches for {steps} APF lane steps")
        if "Gradient" in name:
            gradient_transition_gate(torch, alg, state, y)
    rw = msjd["RandomWalk(2e-2)"]
    print("  MSJD over the random walk's: " + ", ".join(f"{k} {v / rw:.4f}" for k, v in msjd.items() if k != "RandomWalk(2e-2)")
          + " (reported, not gated)")
    return dict(zip(("k1", "lanes", "k1_backward", "lanes_backward"), launches))


def backward_kernel_lines(grads: dict) -> list:
    """The two backward kernels' entries of the ``kernels`` line."""
    lines = []
    for name, key, source in (("expand_backward", "k1", "expand.cu"), ("expand_lanes_backward", "lane",
                                                                         "expand_lanes.cu")):
        paths = {path: c[f"{'k1' if key == 'k1' else 'lanes'}_backward"] for path, c in grads["paths"].items()}
        lines.append({
            "name": name,
            "route": "cuda",
            "source": f"pyfilter_tpu_torch/ops/csrc/{source}",
            "replaces": "pyfilter_tpu/ops/expand.py:297 (port-only: the scatter-add JAX derives for the gather's "
                        "transpose)",
            "launches": sum(paths.values()),
            "launches_by_path": {p: n for p, n in paths.items() if n},
            "max_abs_err": grads[f"{key}_err"],
            "ms": grads[f"{key}_ms"],
            "plain_ms": grads[f"{key}_plain_ms"],
            "bound_ms": grads[f"{key}_bound_ms"],
            "bound_by": "bytes",
            "library_ms": grads[f"{key}_library_ms"],
            "degenerate_ms": grads[f"{key}_degenerate_ms"],
            "library_degenerate_ms": grads[f"{key}_library_degenerate_ms"],
            "path_ms": {k: v for k, v in grads["path_ms"].items() if k.startswith("K1T" if key == "k1" else "K2T")},
        })
    return lines


def gradients(torch, pt, expand, card) -> dict:
    """Phase 13 (module docstring): returns the backward kernels' errors and
    times, and each path's launches by kernel."""
    t_phase = time.perf_counter()
    out = check_backward(torch, pt, expand, card)
    out["paths"] = {"phase 13b": score_gate(torch, pt, expand, card), "phase 13c": mle_gate(torch, pt, expand, card),
                    "phase 13d": nutria_svi(torch, pt, expand, card), "phase 13e": gradient_pmmh(torch, pt, expand, card)}
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s; launches by path {out['paths']}")
    return out


def stream_builder(pt, ctx):
    """Phase 14's model builder (the JAX package's tests/test_score.py
    ``build``): ``beta ~ N(0, 2)``, ``sigma ~ LogNormal(-1, 1)``, the AR(1)
    at STREAM_ALPHA observed with noise STREAM_OBS."""
    def const(v):
        return pt.timeseries.models.parameter(v, ctx.device)

    dist = pt.distributions
    beta = ctx.named_parameter("beta", dist.Normal(const(0.0), const(2.0)))
    sigma = ctx.named_parameter("sigma", dist.LogNormal(const(-1.0), const(1.0)))
    return pt.timeseries.LinearStateSpaceModel(
        pt.timeseries.models.AR(STREAM_ALPHA, beta, sigma, device=ctx.device), (1.0, STREAM_OBS))


def stream_model(pt, device=None):
    """Phase 14's AR(1) at the true parameters, on ``device`` (the card)."""
    return pt.timeseries.LinearStateSpaceModel(
        pt.timeseries.models.AR(STREAM_ALPHA, STREAM_BETA, STREAM_SIGMA, device=device), (1.0, STREAM_OBS))


def stream_data(torch, pt, n_obs: int, seed: int):
    """Observations of phase 14's AR(1) at the true parameters, simulated by
    the port on the CPU."""
    return stream_model(pt, "cpu").sample_states(torch.Generator().manual_seed(seed), n_obs).get_paths()[1].numpy()


def stream_context(torch, pt, device, beta: float, sigma: float):
    """A context of :func:`stream_builder`'s parameters, lane shape (), at
    ``beta`` and ``sigma``."""
    ctx = pt.inference.make_context(generator=torch.Generator(device=device).manual_seed(0), device=device)
    ctx.set_batch_shape(())
    stream_builder(pt, ctx)
    ctx.update_parameter("beta", beta)
    ctx.update_parameter("sigma", sigma)
    return ctx


def kalman_score(y, beta: float, sigma: float, h: float = 1e-6):
    """The float64 score of phase 14's AR(1) at ``(beta, sigma)`` in the
    unconstrained parameters ``(beta, log sigma)`` (the LogNormal prior's
    bijection), by central differences of the Kalman log-likelihood."""
    import numpy as np

    def ll(b, log_s):
        return kalman_ar_ll(b, y, alpha=STREAM_ALPHA, sigma=math.exp(log_s), obs_s=STREAM_OBS)

    ls = math.log(sigma)
    return np.array([(ll(beta + h, ls) - ll(beta - h, ls)) / (2 * h), (ll(beta, ls + h) - ll(beta, ls - h)) / (2 * h)])


def ar_paris_data(n_obs: int = PARIS_AR_T, seed: int = 11):
    """Phase 8's AR(1) (x_0 ~ N(alpha, sigma^2), y = x + obs noise) simulated
    in float64 from numpy ``seed``: the observations and the RTS smoother's
    means and variances at t = 1..T."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x, y = rng.normal(AR_ALPHA, AR_SIGMA), np.zeros(n_obs)
    for t in range(n_obs):
        x = AR_ALPHA + AR_BETA * x + AR_SIGMA * rng.normal()
        y[t] = x + AR_OBS_S * rng.normal()
    sm, sv = rts_ar(y, AR_ALPHA, AR_BETA, AR_SIGMA, AR_OBS_S)
    return y.astype(np.float32), sm, sv


def sv_log_sup(x_min: float = PARIS_SV_XMIN, dt: float = DT) -> float:
    """The stochastic-volatility transition's density bound for a volatility
    above ``x_min`` (tests/test_smoothing_ffbsi.py:232-235): the Verhulst
    diffusion's scale is ``sigma x sqrt(dt)``."""
    return -math.log(SIGMA * x_min * math.sqrt(dt)) - 0.5 * math.log(2 * math.pi)


def observation_time(torch, oes: int):
    """PaRIS's functional ``h(x_prev, x, t) = x`` at the observation times
    ``t = 1, 1 + oes, ...`` (t mod oes == 1), 0 between them."""
    def h(x_prev, x, t):
        return x if t % oes == 1.0 else torch.zeros_like(x)

    return h


def model14(torch, pt, name: str, device):
    """Phase 14's state-space models of the four processes: ``"llt"`` observed
    in both components, ``"cyclical"`` and ``"ucsv"`` in the first,
    ``"trending_ou"`` directly (the JAX package's tests/test_timeseries.py)."""
    models, ts = pt.timeseries.models, pt.timeseries
    first = torch.tensor([[1.0, 0.0]], device=device)
    if name == "llt":
        return ts.LinearStateSpaceModel(models.LocalLinearTrend(*LLT_SIGMA, device=device),
                                        (torch.eye(2, device=device), torch.full((2,), LLT_OBS, device=device)),
                                        event_shape=(2,))
    if name == "cyclical":
        return ts.LinearStateSpaceModel(models.Cyclical(CYC_RHO, CYC_LAMDA, CYC_SIGMA, device=device),
                                        (first, torch.full((1,), CYC_OBS, device=device)), event_shape=(1,))
    if name == "ucsv":
        return ts.LinearStateSpaceModel(models.UCSV(UCSV_SV, device=device),
                                        (first, torch.full((1,), UCSV_OBS, device=device)), event_shape=(1,))
    return ts.LinearStateSpaceModel(models.TrendingOU(*TOU_PARAMS, device=device), (1.0, TOU_OBS))


def system14(name: str) -> tuple:
    """The float64 linear-Gaussian system (:func:`oracle_system`'s form) of
    :func:`model14`'s ``"llt"`` or ``"cyclical"``."""
    import numpy as np

    if name == "llt":
        q = np.diag(np.square(LLT_SIGMA))
        return (np.array([[1.0, 1.0], [0.0, 1.0]]), np.zeros(2), q, np.eye(2), LLT_OBS**2 * np.eye(2), np.zeros(2), q)
    c, s = math.cos(CYC_LAMDA), math.sin(CYC_LAMDA)
    p0 = CYC_SIGMA**2 / (1.0 - CYC_RHO**2) * np.eye(2)
    return (CYC_RHO * np.array([[c, s], [-s, c]]), np.zeros(2), CYC_SIGMA**2 * np.eye(2), np.array([[1.0, 0.0]]),
            np.array([[CYC_OBS**2]]), np.zeros(2), p0)


def simulate_linear(system, n_obs: int, rng):
    """A path ``(x, y)`` of ``system`` (:func:`oracle_system`'s form) in
    float64, drawn from ``rng`` (a numpy generator, or a seed for one)."""
    import numpy as np

    f, b, q, h, r, m0, p0 = system
    rng = np.random.default_rng(rng)
    x, y = np.zeros((n_obs, len(b))), np.zeros((n_obs, h.shape[0]))
    xc = rng.multivariate_normal(m0, p0)
    for t in range(n_obs):
        xc = f @ xc + b + rng.multivariate_normal(np.zeros(len(b)), q)
        x[t] = xc
        y[t] = h @ xc + rng.multivariate_normal(np.zeros(h.shape[0]), r)
    return x, y


def trending_ou_reversion(torch, pt, device, generator) -> tuple:
    """The JAX package's tests/test_timeseries.py:263-278 gate: TOU_PATHS
    paths of TOU_STEPS steps of TrendingOU; the mean over paths of the last
    half against the trend ``gamma + beta t``. Returns the worst gap and its
    limit ``beta / kappa + 0.05``."""
    kappa, gamma, beta, _ = TOU_PARAMS
    proc = pt.timeseries.models.TrendingOU(*TOU_PARAMS, device=device)
    x = proc.initial_sample(generator, (TOU_PATHS,))
    values = []
    for _ in range(TOU_STEPS):
        x = proc.propagate(generator, x)
        values.append(x.value)
    mean = torch.stack(values).double().mean(dim=1).cpu().numpy()  # states at t = 1..TOU_STEPS
    t = range(TOU_STEPS // 2, TOU_STEPS)
    return max(abs(mean[i] - (gamma + beta * i)) for i in t), beta / kappa + 0.05


def ucsv_checks(torch, pt, device, generator) -> tuple:
    """The JAX package's tests/test_timeseries.py:316- gates: the sd of one
    step of log-volatility over 512 particles (within 30% of
    sigma_volatility), and the level RMSE of SISR(UCSV_N) over UCSV_T
    observations of the level (under 0.25). Returns (sd, RMSE, the
    log-likelihood)."""
    proc = pt.timeseries.models.UCSV(UCSV_SV, device=device)
    x0 = proc.initial_sample(generator, (512,))
    x1 = proc.propagate(generator, x0)
    dv_sd = float((x1.value[:, 1] - x0.value[:, 1]).double().std())
    model = model14(torch, pt, "ucsv", device)
    path = model.sample_states(generator, UCSV_T)
    res = pt.SISR(model, UCSV_N, device=device).batch_filter(generator, path.y.cpu().numpy())
    means = res.filter_means[:, 0].double().cpu()
    rmse = float(torch.sqrt(torch.mean((means - path.x[:, 0].double().cpu()) ** 2)))
    return dv_sd, rmse, float(res.log_likelihood)


def counted_sisr(pt):
    """A SISR class whose resample fires, over every copy of its filters (a
    model rebuild copies the filter), add to its one ``fires`` count; it
    keeps the probabilities and values of the last fire (``last``)."""
    class Counted(pt.SISR):
        fires, last = 0, None

        def _resample(self, generator, normalized, ts_state):
            type(self).fires += 1
            type(self).last = (normalized, ts_state.value)
            return super()._resample(generator, normalized, ts_state)

    return Counted


def last_cloud_planes(values):
    """A single-lane cloud ``(n,)`` or ``(n, d)`` as the expand kernel's value
    planes ``(d, n)``."""
    return values.reshape(1, -1) if values.dim() == 1 else values.T


def jacfwd_transition(torch, pt, ctx, build, theta, ev):
    """The transition's score functional by forward mode, ``jacfwd`` of the
    particles' log-density vector in the parameters (the port takes
    ``vmap`` over particles of ``grad``, as the JAX package does): phase
    14(b) times both on one cloud."""
    def h_fn(x_prev, x_cur, t):
        def log_f(th):
            ctx2 = ctx.unstack_parameters(th, constrained=False)
            with ctx2.no_prior_verification():
                model = build(ctx2)
            return model.hidden.build_density(pt.timeseries.TimeseriesState(t - 1.0, x_prev, ev)).log_prob(x_cur)

        return torch.func.jacfwd(log_f)(theta)[:, 0, :]

    return h_fn


def streaming_fit(torch, pt, expand, card, profile: bool = False) -> int:
    """Phase 14(a): fit_mle_streaming at tests/test_score.py:87-104's size.
    Returns the expand kernel's launches."""
    import numpy as np

    build = lambda c: stream_builder(pt, c)  # noqa: E731
    y = stream_data(torch, pt, STREAM_T, seed=8)
    counted = counted_sisr(pt)

    def fit(n_obs, seed):
        return pt.inference.fit_mle_streaming(build, y[:n_obs], lambda b: counted(b, STREAM_N),
                                              torch.Generator(device="cuda").manual_seed(seed), window=STREAM_WINDOW,
                                              learning_rate=STREAM_LR,
                                              context=stream_context(torch, pt, "cuda", *STREAM_START))

    fit(2 * STREAM_WINDOW, 1)  # warm-up: the first forward-mode pass loads torch's decompositions
    _zero_counts(expand)
    counted.fires = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(STREAM_T, 10)
    fitted = res.parameters()
    lls = res.window_log_likelihoods.cpu().numpy()
    wall = time.perf_counter() - t0
    launches, fires = expand.fused_expand.launches, counted.fires
    n_win = STREAM_T // STREAM_WINDOW
    gaps = {"beta": float(fitted["beta"]) - STREAM_BETA, "sigma": float(fitted["sigma"]) - STREAM_SIGMA}
    sync_obs = 2 * STREAM_WINDOW
    syncs = count_syncs(torch, lambda: fit(sync_obs, 11))
    print(f"phase 14a: fit_mle_streaming(SISR({STREAM_N}), T={STREAM_T}, window {STREAM_WINDOW}, lr {STREAM_LR}, start "
          f"beta {STREAM_START[0]}, sigma {STREAM_START[1]}): beta {float(fitted['beta']):.6f}, sigma "
          f"{float(fitted['sigma']):.6f} (gaps {gaps}, limit {STREAM_TOL}); wall {wall:.3f} s, "
          f"{wall / n_win * 1e3:.3f} ms a window, {wall / STREAM_T * 1e3:.4f} ms an observation; resample fires "
          f"{fires} = expand launches {launches}; card {card}")
    print(f"  host syncs per observation by source ({sync_obs} observations): "
          f"{ {k: round(v / sync_obs, 4) for k, v in syncs.items()} }; total {sum(syncs.values()) / sync_obs:.4f}")
    if not (np.isfinite(lls).all() and res.theta_path.shape == (n_win, 2)):
        raise AssertionError(f"phase 14a: window log-likelihoods finite {bool(np.isfinite(lls).all())}, path "
                             f"{tuple(res.theta_path.shape)}")
    if not all(abs(g) < STREAM_TOL for g in gaps.values()):
        raise AssertionError(f"phase 14a: fitted parameters off the truth by {gaps} (limit {STREAM_TOL})")
    if not launches == fires > 0:
        raise AssertionError(f"phase 14a: expand kernel launched {launches} times for {fires} resample fires")
    if profile:
        ops = profile_run(torch, "phase 14a, two streaming windows", lambda: fit(2 * STREAM_WINDOW, 12))
        print(f"  device operations per observation {ops / (2 * STREAM_WINDOW):.2f}")
    return launches


def online_score_phase(torch, pt, expand, card) -> tuple:
    """Phase 14(b): the online score at N = 1e5, one run at the default
    rejection rounds and ONLINE_SEEDS at ONLINE_ROUNDS, against the float64
    Kalman score; the score functional's two ways timed on one cloud; K1 on
    the last cloud. Returns the launches and the
    kernel's difference from its plain version."""
    import numpy as np

    from pyfilter_tpu_torch.filters.particle.smoothing import ffbsi_smooth
    from pyfilter_tpu_torch.inference.score import _score_functionals

    build = lambda c: stream_builder(pt, c)  # noqa: E731
    y = stream_data(torch, pt, ONLINE_T, seed=0)
    exact = kalman_score(y, *ONLINE_AT)
    counted = counted_sisr(pt)

    def run(seed, n_obs=ONLINE_T, max_rounds=16):
        return pt.inference.online_score(build, y[:n_obs], lambda b: counted(b, ONLINE_N),
                                         torch.Generator(device="cuda").manual_seed(seed),
                                         context=stream_context(torch, pt, "cuda", *ONLINE_AT), max_rounds=max_rounds)

    def timed(seed, max_rounds):
        ffbsi_smooth.fallback_passes = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score = run(seed, max_rounds=max_rounds).score.cpu().numpy().astype(np.float64)
        return score, time.perf_counter() - t0, ffbsi_smooth.fallback_passes

    run(99, 10)  # warm-up
    _zero_counts(expand)
    counted.fires = 0
    torch.cuda.reset_peak_memory_stats()
    default_score, default_wall, default_passes = timed(99, 16)
    runs = [timed(100 + seed, ONLINE_ROUNDS) for seed in range(ONLINE_SEEDS)]
    scores, walls, passes = (np.asarray([r[k] for r in runs]) for k in range(3))
    peak = torch.cuda.max_memory_allocated()
    launches, fires = expand.fused_expand.launches, counted.fires
    mean, sem = scores.mean(axis=0), scores.std(axis=0, ddof=1) / math.sqrt(len(scores))
    limit = 4 * sem + 0.05 * np.abs(exact)
    print(f"phase 14b: online_score(SISR({ONLINE_N}), T={ONLINE_T}) at beta {ONLINE_AT[0]}, sigma {ONLINE_AT[1]}: "
          f"default 16 rounds: score {default_score.tolist()}, {default_wall:.3f} s, "
          f"{default_wall / ONLINE_T * 1e3:.4f} ms an observation, {default_passes / ONLINE_T:.2f} fallback passes an "
          f"observation; {ONLINE_ROUNDS} rounds, {ONLINE_SEEDS} seeds: scores {scores.tolist()}; mean {mean.tolist()}, "
          f"SEM {sem.tolist()}; wall per run {walls.tolist()} s, {walls.min() / ONLINE_T * 1e3:.4f} ms an observation "
          f"(best), {passes.mean() / ONLINE_T:.2f} fallback passes an observation; float64 Kalman score "
          f"{exact.tolist()} (per run: rel {ONLINE_RTOL}, abs {ONLINE_ATOL}; mean: 4 SEM + 5% = {limit.tolist()}); "
          f"peak device memory {peak / 2**30:.4f} GiB; resample fires {fires} = expand launches {launches}; "
          f"card {card}")
    scores = np.vstack([default_score, scores])
    # a violated density bound poisons a run's whole estimate with NaN (PaRIS keeps the flag on the device)
    violated = [bool(np.isnan(sc).any()) for sc in scores]
    print(f"  bound violated in {sum(violated)} of {len(violated)} runs (each run's flag: {violated})")
    if not np.isfinite(scores).all():
        raise AssertionError("phase 14b: non-finite scores")
    worst = np.abs(scores - exact) - (ONLINE_ATOL + ONLINE_RTOL * np.abs(exact))
    if not (worst <= 0).all():
        raise AssertionError(f"phase 14b: a run's score is off the Kalman score by {worst.max()} over the tolerance")
    if not (np.abs(mean - exact) < limit).all():
        raise AssertionError(f"phase 14b: mean score {mean} off the Kalman score {exact} by more than {limit}")
    if not launches == fires > 0:
        raise AssertionError(f"phase 14b: expand kernel launched {launches} times for {fires} resample fires")
    probs, values = counted.last
    err = check_on_cloud(torch, expand, probs, last_cloud_planes(values), f"phase 14b's last cloud (n={ONLINE_N})")

    syncs = count_syncs(torch, lambda: run(7, 20))
    print(f"  host syncs per observation by source (20 observations): "
          f"{ {k: round(v / 20, 4) for k, v in syncs.items()} }; total {sum(syncs.values()) / 20:.4f}")

    # the transition's score functional at N = 1e5: vmap(grad) (the port's) and jacfwd
    ctx = stream_context(torch, pt, "cuda", *ONLINE_AT)
    theta = ctx.stack_parameters(constrained=False)
    h_vmap, _ = _score_functionals(ctx, build, theta, 0)
    h_fwd = jacfwd_transition(torch, pt, ctx, build, theta, 0)
    g = torch.Generator(device="cuda").manual_seed(5)
    xp, xc = torch.randn(ONLINE_N, generator=g, device="cuda"), torch.randn(ONLINE_N, generator=g, device="cuda")
    a, b = h_fwd(xp, xc, 4.0), h_vmap(xp, xc, 4.0)
    gap = float(((a - b).abs() / b.abs().clamp(min=1e-3)).max())
    if not gap < 1e-4:
        raise AssertionError(f"phase 14b: vmap(grad) and jacfwd functionals differ by rel {gap}")

    def host_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    fwd_ms, vmap_ms = host_ms(lambda: h_fwd(xp, xc, 4.0)), host_ms(lambda: h_vmap(xp, xc, 4.0))
    print(f"  transition score functional at N={ONLINE_N}: vmap(grad) {vmap_ms:.4f} ms a call, jacfwd {fwd_ms:.4f} ms "
          f"(host clock, synchronized, mean of 20; n_tilde = 2 calls an observation); largest relative gap {gap:.3g}")
    return launches, err


def paris_phase(torch, pt, expand, card) -> tuple:
    """Phase 14(c): PaRIS on the stochastic-volatility model against FFBSi on
    a recorded-intermediary history, and on phase 8's AR model against the
    RTS smoother. Returns the launches and the kernel's difference from its
    plain version."""
    import numpy as np

    from pyfilter_tpu_torch.filters.particle.smoothing import paris

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    counted = counted_sisr(pt)
    _zero_counts(expand)
    cpu_model = pt.examples.stochastic_volatility_model(dt=DT, device="cpu")
    _, y_all = cpu_model.sample_states(torch.Generator().manual_seed(40), PARIS_SV_T * OES).get_paths()
    y = y_all[OES - 1 :: OES].numpy()
    model = pt.examples.stochastic_volatility_model(dt=DT)
    log_sup = sv_log_sup()
    h = observation_time(torch, OES)
    t0 = time.perf_counter()
    est, _, res = paris(counted(model, PARIS_SV_N), gen(41), y, h, n_tilde=2, log_density_sup=log_sup)
    est = float(est)
    paris_wall = time.perf_counter() - t0
    filt_r = counted(model, PARIS_SV_N, record_states=True, record_intermediary=True)
    res_r = filt_r.batch_filter(gen(42), y)
    traj = filt_r.smooth(gen(43), res_r, method="ffbsi", log_density_sup=log_sup)
    m = traj.double().mean(dim=1).cpu().numpy()
    target = float(m[1 + OES * np.arange(len(y))].sum())
    limit = 0.15 * abs(target) + 0.5
    print(f"phase 14c: PaRIS(SISR({PARIS_SV_N})) on the stochastic-volatility model, T={PARIS_SV_T} x {OES} sub-steps, "
          f"bound {log_sup:.6f}: estimate {est:.6f} ({paris_wall:.3f} s), FFBSi functional over the recorded "
          f"sub-steps {target:.6f} (gap {est - target:+.6f}, limit {limit:.6f}); log-likelihood "
          f"{float(res.log_likelihood):.6f}; card {card}")
    if not (math.isfinite(est) and math.isfinite(float(res.log_likelihood))):
        raise AssertionError(f"phase 14c: PaRIS estimate {est} (NaN: the bound guard fired)")
    if not abs(est - target) < limit:
        raise AssertionError(f"phase 14c: PaRIS estimate {est} off the FFBSi functional {target} (> {limit})")

    y_ar, sm_mean, sm_var = ar_paris_data()
    ar_model = pt.timeseries.LinearStateSpaceModel(
        pt.timeseries.models.AR(AR_ALPHA, AR_BETA, AR_SIGMA), (1.0, AR_OBS_S))
    est_ar, stats, res_ar = paris(counted(ar_model, PARIS_AR_N), gen(9), y_ar, lambda xp, xc, t: xc, n_tilde=2)
    target = float(sm_mean.sum())
    tol = max(5.0 * math.sqrt(sm_var.sum() / PARIS_AR_N) + 0.05 * abs(target), 0.6)
    print(f"  PaRIS(SISR({PARIS_AR_N})) on phase 8's AR model, T={PARIS_AR_T}, sum of x_t: {float(est_ar):.6f}, RTS "
          f"{target:.6f} (gap {float(est_ar) - target:+.6f}, limit {tol:.6f})")
    if not abs(float(est_ar) - target) < tol:
        raise AssertionError(f"phase 14c: PaRIS estimate {float(est_ar)} off the RTS sum {target} (> {tol})")
    launches = expand.fused_expand.launches
    if not launches == counted.fires > 0:
        raise AssertionError(f"phase 14c: expand kernel launched {launches} times for {counted.fires} fires")
    probs, values = counted.last
    err = check_on_cloud(torch, expand, probs, last_cloud_planes(values), "phase 14c's last cloud")
    return launches, err


def resamplers_phase(torch, pt, expand, card) -> None:
    """Phase 14(d): SISR with each other resampler at N = 1e5 on phase 12's
    ``"ar"`` under its Kalman gate, and two over lanes; no kernel launches."""
    import numpy as np

    _, y = oracle_data("ar")
    km, kll = kalman_linear(y, oracle_system("ar"))
    model = oracle_model(pt, "ar", "cuda")
    runs = [(scheme, RESAMPLE_N, ()) for scheme in RESAMPLERS]
    runs += [(scheme, RESAMPLE_LANE_N, (RESAMPLE_LANES,)) for scheme in RESAMPLE_LANE_SCHEMES]
    for scheme, n, lanes in runs:
        resampler = getattr(pt.resampling, scheme)
        filt = pt.SISR(model, n, resampling_method=resampler, batch_shape=lanes)
        _zero_counts(expand)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = filt.batch_filter(torch.Generator(device="cuda").manual_seed(3), y[:, 0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels = sum(_launch_counts(expand))
        lls = res.log_likelihood.double().cpu().numpy()
        dev, ll_err = oracle_gate(res.filter_means.cpu().numpy(), lls, km, kll)
        if lanes:  # the lanes' mean log-likelihood: each lane's is one N = 400 estimate
            ll_err = abs(float(lls.mean()) - kll) / abs(kll)
        probs = pt.normalize(res.latest_state.log_weights)
        gen = torch.Generator(device="cuda").manual_seed(4)
        resampler(gen, probs, normalized=True)
        fire_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resampler(gen, probs, normalized=True)
            torch.cuda.synchronize()
            fire_ms.append((time.perf_counter() - t0) * 1e3)
        syncs = sum(count_syncs(torch, lambda: resampler(gen, probs, normalized=True)).values())
        shape = f"{n} x {lanes[0]} lanes" if lanes else f"N={n}"
        print(f"phase 14d: SISR({shape}, {scheme}) on \"ar\", T={ORACLE_T}: median relative deviation {dev:.6f}, "
              f"log-likelihood error {ll_err:.6f} (limit {ORACLE_TOL}); {wall:.3f} s, {filt.n_resamples} resample "
              f"fires; kernel launches {kernels}; a fire {float(np.median(fire_ms)):.4f} ms (host clock, median of "
              f"5), {syncs} host syncs a fire; card {card}")
        if not (dev < ORACLE_TOL and ll_err < ORACLE_TOL):
            raise AssertionError(f"phase 14d: {scheme} ({shape}) fails the Kalman gate: {dev}, {ll_err}")
        if kernels or not filt.n_resamples:
            raise AssertionError(f"phase 14d: {scheme} ({shape}): {kernels} kernel launches, "
                                 f"{filt.n_resamples} resample fires")


def models_phase(torch, pt, expand, card) -> tuple:
    """Phase 14(e): the four models. Returns the launches and the kernel's
    largest difference from its plain version."""
    import numpy as np

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    launches, err = 0, 0.0
    gap, limit = trending_ou_reversion(torch, pt, "cuda", gen(20))
    print(f"phase 14e: TrendingOU{TOU_PARAMS}, {TOU_PATHS} paths of {TOU_STEPS} steps: the last half's mean off the "
          f"trend by {gap:.6f} at worst (limit {limit:.6f})")
    if not gap < limit:
        raise AssertionError(f"phase 14e: TrendingOU off its trend by {gap} (> {limit})")
    dv_sd, rmse, ucsv_ll = ucsv_checks(torch, pt, "cuda", gen(21))
    print(f"  UCSV({UCSV_SV}): one log-volatility step's sd {dv_sd:.6f} (within 30% of {UCSV_SV}); SISR({UCSV_N}) over "
          f"{UCSV_T} observations: level RMSE {rmse:.6f} (limit 0.25), log-likelihood {ucsv_ll:.6f}")
    if not (abs(dv_sd - UCSV_SV) < 0.3 * UCSV_SV and rmse < 0.25 and math.isfinite(ucsv_ll)):
        raise AssertionError(f"phase 14e: UCSV checks {dv_sd}, {rmse}, {ucsv_ll}")
    for seed, name in enumerate(("llt", "cyclical", "trending_ou", "ucsv")):
        if name in ("llt", "cyclical"):
            system = system14(name)
            _, y = simulate_linear(system, MODEL14_T, seed)
        else:
            path = model14(torch, pt, name, "cpu").sample_states(torch.Generator().manual_seed(seed), MODEL14_T)
            y = path.y.numpy()
        counted = counted_sisr(pt)
        filt = counted(model14(torch, pt, name, "cuda"), MODEL14_N)
        _zero_counts(expand)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = filt.batch_filter(gen(30 + seed), y)
        ll = float(res.log_likelihood)
        wall = time.perf_counter() - t0
        k1 = expand.fused_expand.launches
        line = f"  {name}: SISR(N={MODEL14_N}), T={MODEL14_T}: log-likelihood {ll:.6f}; {wall:.3f} s"
        if name in ("llt", "cyclical"):
            km, kll = kalman_linear(y, system)
            dev, ll_err = oracle_gate(res.filter_means.cpu().numpy(), ll, km, kll)
            line += f"; median relative deviation {dev:.6f}, log-likelihood error {ll_err:.6f} (limit {ORACLE_TOL})"
            if not (dev < ORACLE_TOL and ll_err < ORACLE_TOL):
                raise AssertionError(f"phase 14e: {name} fails the Kalman gate: {dev}, {ll_err}")
        print(f"{line}; resample fires {counted.fires} = expand launches {k1}; card {card}")
        if not (math.isfinite(ll) and k1 == counted.fires > 0):
            raise AssertionError(f"phase 14e: {name}: log-likelihood {ll}, {k1} launches for {counted.fires} fires")
        probs, values = counted.last
        err = max(err, check_on_cloud(torch, expand, probs, last_cloud_planes(values), f"phase 14e's {name} cloud"))
        launches += k1
    return launches, err


def single_step_phase(torch, pt, expand, card) -> int:
    """Phase 14(f): ``step`` against ``filter``, ``batch_filter_masked``
    against ``batch_filter`` of the first rows (N = 1e5), ``lane_concat`` and
    ``resample_particles``. Returns the expand kernel's launches."""
    from pyfilter_tpu_torch.filters.base import pad_observations
    from pyfilter_tpu_torch.filters.state import ParticleFilterCorrection

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    y = stream_data(torch, pt, 2 * MASKED_VALID, seed=0)
    model = stream_model(pt)
    filt = pt.SISR(model, MASKED_N)
    _zero_counts(expand)
    state = filt.batch_filter(gen(1), y[:5]).latest_state
    a, b = filt.step(gen(2), y[5], state), filt.filter(gen(2), y[5], state)
    same = all(torch.equal(p, q) for p, q in zip((a.x.value, a.log_weights, a.log_likelihood, a.prev_indices),
                                                 (b.x.value, b.log_weights, b.log_likelihood, b.prev_indices)))
    padded, n_valid = pad_observations(y[:MASKED_VALID])
    masked = filt.batch_filter_masked(gen(3), padded, n_valid)
    plain = filt.batch_filter(gen(3), y[:MASKED_VALID])
    same_masked = (torch.equal(masked.log_likelihood, plain.log_likelihood)
                   and torch.equal(masked.step_log_likelihoods[:n_valid], plain.step_log_likelihoods)
                   and not bool(masked.step_log_likelihoods[n_valid:].any())
                   and torch.equal(masked.latest_state.x.value, plain.latest_state.x.value))
    launches = expand.fused_expand.launches

    parts = [pt.SISR(model, 1000, batch_shape=(k,)).batch_filter(gen(10 + k), y[:3]).latest_state for k in (2, 1, 3)]
    cat = ParticleFilterCorrection.lane_concat(parts)
    idx = pt.resampling.systematic(gen(4), cat.log_weights)
    moved = cat.resample_particles(idx)
    mean, var = pt.utils.get_mean_and_variance(moved.x.value, torch.full_like(moved.log_weights, 1e-3))
    concat_ok = (tuple(cat.x.value.shape) == (1000, 6) and tuple(cat.log_likelihood.shape) == (6,)
                 and torch.equal(cat.x.value, torch.cat([p.x.value for p in parts], dim=1))
                 and torch.equal(cat.log_likelihood, torch.cat([p.log_likelihood for p in parts]))
                 and torch.equal(moved.x.value, torch.gather(cat.x.value, 0, idx.long()))
                 and not bool(moved.log_weights.any()) and torch.equal(moved.prev_indices, idx)
                 and torch.equal(moved.log_likelihood, cat.log_likelihood)
                 and bool(torch.allclose(moved.mean, mean, rtol=1e-5, atol=1e-6))
                 and bool(torch.allclose(moved.variance, var, rtol=1e-5, atol=1e-6)))
    print(f"phase 14f: step == filter from one state (N={MASKED_N}): {same}; batch_filter_masked("
          f"pad_observations(y[:{MASKED_VALID}]), bucket {len(padded)}) == batch_filter(y[:{MASKED_VALID}]), bit "
          f"for bit: {same_masked}; lane_concat of 2 + 1 + 3 lanes and resample_particles: {concat_ok}; expand "
          f"launches {launches}; card {card}")
    if not (same and same_masked and concat_ok):
        raise AssertionError("phase 14f: the single-step API disagrees")
    return launches


def streaming(torch, pt, expand, card, profile: bool = False) -> dict:
    """Phase 14 (module docstring): returns the expand kernel's launches by
    path and its largest difference from its plain version."""
    t_phase = time.perf_counter()
    paths, errs = {}, []
    paths["phase 14a"] = streaming_fit(torch, pt, expand, card, profile=profile)
    paths["phase 14b"], err = online_score_phase(torch, pt, expand, card)
    errs.append(err)
    paths["phase 14c"], err = paris_phase(torch, pt, expand, card)
    errs.append(err)
    resamplers_phase(torch, pt, expand, card)
    paths["phase 14e"], err = models_phase(torch, pt, expand, card)
    errs.append(err)
    paths["phase 14f"] = single_step_phase(torch, pt, expand, card)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s; expand launches by path {paths}")
    return {"paths": paths, "err": max(errs)}


def zoo_fitted(pt, beta: float, sigma: float, device):
    """The example's fitted model: phase 11's AR at the given parameters."""
    return pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.AR(0.0, beta, sigma, device=device),
                                               (1.0, PMMH_OBS))


def zoo_test_data(torch, pt):
    """Phase 15(c)'s second series: PMMH_T steps of the true model (the
    port's simulator on the CPU, the example's seed 4)."""
    model = zoo_fitted(pt, PMMH_TRUE["beta"], PMMH_TRUE["sigma"], "cpu")
    return model.sample_states(torch.Generator().manual_seed(4), PMMH_T).get_paths()[1].numpy()


def kalman_predictive(y, beta: float, sigma: float):
    """The float64 Kalman one-step predictive ``(mean, sd)`` of each
    observation under phase 11's model at ``(beta, sigma)`` (``x_0 ~ N(0,
    sigma^2)``, as :func:`ar_grid_posterior` filters)."""
    import numpy as np

    m, p, mus, sds = 0.0, sigma**2, [], []
    for yt in np.asarray(y, np.float64):
        m, p = beta * m, beta**2 * p + sigma**2
        s = p + PMMH_OBS**2
        mus.append(m)
        sds.append(math.sqrt(s))
        m, p = m + p / s * (yt - m), (1.0 - p / s) * p
    return np.asarray(mus), np.asarray(sds)


def gaussian_crps(y, mu, sd):
    """The closed-form CRPS of ``N(mu, sd^2)`` at ``y``."""
    import numpy as np
    from scipy import stats

    z = (np.asarray(y, np.float64) - mu) / sd
    return sd * (z * (2 * stats.norm.cdf(z) - 1) + 2 * stats.norm.pdf(z) - 1 / math.sqrt(math.pi))


def zoo_tempered(torch, pt, y, device: str, seed: int, counted=None, **kwargs):
    """One ``TemperedSMC(SISR(pmmh_builder, ZOO_N), ZOO_K)`` fit on ``device``
    (context seed ``seed``, algorithm seed ``seed + 1``). Returns the
    algorithm, the result and the wall seconds."""
    from pyfilter_tpu_torch import inference as inf

    filt_cls = counted or pt.SISR
    gen = lambda s: torch.Generator(device=device).manual_seed(s)  # noqa: E731
    alg = inf.TemperedSMC(filt_cls(lambda c: pmmh_builder(pt, c), ZOO_N, device=device), ZOO_K,
                          context=inf.make_context(generator=gen(seed), device=device), generator=gen(seed + 1),
                          device=device, **kwargs)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = alg.fit(y, logging=inf.logging.DefaultLogger())
    return alg, res, time.perf_counter() - t0


def zoo_if2(torch, pt, y, device: str, seed: int, counted=None, iterations: int = ZOO_IF2_ITERS):
    """One ``IF2(SISR(pmmh_builder, ZOO_N), ZOO_K, iterations, ZOO_IF2_SIGMA,
    ZOO_IF2_COOLING)`` fit on ``device`` (seeds as :func:`zoo_tempered`).
    Returns the algorithm, the result and the wall seconds."""
    from pyfilter_tpu_torch import inference as inf

    filt_cls = counted or pt.SISR
    gen = lambda s: torch.Generator(device=device).manual_seed(s)  # noqa: E731
    alg = inf.IF2(filt_cls(lambda c: pmmh_builder(pt, c), ZOO_N, device=device), ZOO_K, num_iterations=iterations,
                  sigma=ZOO_IF2_SIGMA, cooling=ZOO_IF2_COOLING,
                  context=inf.make_context(generator=gen(seed), device=device), generator=gen(seed + 1),
                  device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = alg.fit(y, logging=inf.logging.DefaultLogger())
    return alg, res, time.perf_counter() - t0


def _jax_spread_gate(label: str, got: dict, jax_fits: dict) -> None:
    """Each reading of ``got`` within ZOO_JAX_TOL spreads between seeds of
    the JAX package's fits (``jax_fits``: name -> (mean, sd)), the spread
    scaled by sqrt(1 + 1 / ZOO_JAX_N)."""
    for name, value in got.items():
        mean, sd = jax_fits[name]
        gap = (value - mean) / (sd * math.sqrt(1.0 + 1.0 / ZOO_JAX_N))
        print(f"  {label} {name}: {value:.6f} against the JAX fits' {mean:.6f} (spread {sd:.6f}): {gap:+.3f} "
              f"spreads (limit {ZOO_JAX_TOL})")
        if not abs(gap) < ZOO_JAX_TOL:
            raise AssertionError(f"phase 15: {label} {name} {value} lies {gap} JAX spreads from {mean}")


def batch_zoo(torch, pt, expand, card, profile: bool = False) -> dict:
    """Phase 15 (module docstring): returns the lane kernel's and the expand
    kernel's launches by path and their largest differences from their plain
    versions."""
    import numpy as np

    t_phase = time.perf_counter()
    y = pmmh_data(torch, pt)
    exact = ar_grid_posterior(y)
    counted = counted_sisr(pt)
    out = {"lanes": {}, "k1": {}, "lanes_err": 0.0, "k1_err": 0.0}

    # (a) TemperedSMC
    _zero_counts(expand)
    counted.fires = 0
    alg, res, wall = zoo_tempered(torch, pt, y, "cuda", 40, counted=counted)
    launches, fires = expand.fused_expand_lanes.launches, counted.fires
    stages = len(res.lambdas)
    steps = (1 + 2 * stages) * PMMH_T  # the initial pass, then two MH re-filters a stage
    print(f"phase 15a: TemperedSMC(SISR({ZOO_N}), {ZOO_K}), T={PMMH_T}: {wall:.3f} s, {stages} stages, "
          f"{wall / fires * 1e3:.4f} ms a SISR lane step; ladder {np.round(res.lambdas, 6).tolist()}; acceptance "
          f"{np.round(res.acceptance_rates, 4).tolist()}; log evidence {res.log_evidence:.6f} (grid "
          f"{exact['log_evidence']:.6f}); lane kernel launches {launches} for {fires} lane resample fires "
          f"({steps} lane steps); card {card}")
    if not (res.lambdas[-1] == 1.0 and (np.diff(res.lambdas) > 0).all()):
        raise AssertionError(f"phase 15a: the ladder {res.lambdas.tolist()} does not rise strictly to 1")
    if not launches == fires == steps or expand.fused_expand.launches:
        raise AssertionError(f"phase 15a: lane kernel launched {launches} times for {fires} fires, {steps} steps")
    for name in ("beta", "sigma"):
        s = res.samples[name]
        gap = (float(s.mean()) - exact[name][0]) / float(s.std())
        print(f"  {name}: swarm mean {float(s.mean()):.6f} sd {float(s.std()):.6f}; exact posterior "
              f"{exact[name][0]:.6f} sd {exact[name][1]:.6f}; gap {gap:+.4f} swarm sd (limit {ZOO_POST_SD})")
        if not (np.isfinite(s).all() and abs(gap) < ZOO_POST_SD):
            raise AssertionError(f"phase 15a: {name} posterior mean {gap} swarm sds off the exact posterior")
    ev_gap = res.log_evidence - exact["log_evidence"]
    if not abs(ev_gap) < ZOO_EVIDENCE_NATS:
        raise AssertionError(f"phase 15a: log evidence {res.log_evidence} is {ev_gap} nats off the grid's")
    _jax_spread_gate("15a", {"beta": float(res.samples["beta"].mean()), "sigma": float(res.samples["sigma"].mean()),
                             "log_evidence": res.log_evidence}, ZOO_JAX["tempered"])
    probs, values = counted.last
    out["lanes_err"] = check_on_cloud(torch, expand, probs, values.unsqueeze(0),
                                      f"phase 15a's last lane cloud (n={ZOO_N}, L={probs.shape[1]})")
    out["lanes"]["phase 15a"] = launches
    if profile:
        ctx, filt = alg.context, alg.filter.initialize_model(alg.context)
        theta = ctx.stack_parameters(constrained=False)
        ll, lp = alg._lane_logliks(ctx, filt, theta, y)
        centered = theta - theta.mean(dim=0)
        chol = torch.linalg.cholesky(centered.T @ centered / (ZOO_K - 1) + 1e-8 * torch.eye(2, device="cuda"))
        ops = profile_run(torch, "phase 15a, one stage's MH refresh (2 lane passes)",
                          lambda: alg._mh_refresh(ctx, filt, y, theta, ll, lp, chol, 1.0, 2.38 / math.sqrt(2)))
        print(f"  device operations per SISR lane step {ops / (2 * PMMH_T):.2f}")

    # (b) IF2
    _zero_counts(expand)
    counted.fires = 0
    alg, res, wall = zoo_if2(torch, pt, y, "cuda", 50, counted=counted, iterations=ZOO_IF2_ITERS)
    launches, fires = expand.fused_expand_lanes.launches, counted.fires
    steps = ZOO_IF2_ITERS * PMMH_T
    lls = res.log_likelihoods
    print(f"phase 15b: IF2(SISR({ZOO_N}), {ZOO_K}, {ZOO_IF2_ITERS} passes, sigma {ZOO_IF2_SIGMA}, cooling "
          f"{ZOO_IF2_COOLING}), T={PMMH_T}: {wall:.3f} s, {wall / fires * 1e3:.4f} ms a SISR lane step; MLE beta "
          f"{float(res.mle['beta']):.6f} sigma {float(res.mle['sigma']):.6f} (grid MLE {exact['mle']}); final swarm "
          f"beta sd {float(res.swarm['beta'].std()):.6f}; pass log-likelihoods first 3 {np.round(lls[:3], 4).tolist()}"
          f", last 3 {np.round(lls[-3:], 4).tolist()}; lane kernel launches {launches} for {fires} fires ({steps} "
          f"lane steps); card {card}")
    for name, tol in ZOO_MLE_TOL.items():
        gap = float(res.mle[name]) - exact["mle"][name]
        if not abs(gap) < tol:
            raise AssertionError(f"phase 15b: IF2's {name} {float(res.mle[name])} is {gap} off the grid MLE")
    if not (np.isfinite(lls).all() and lls[-3:].mean() > lls[:3].mean()):
        raise AssertionError(f"phase 15b: pass log-likelihoods do not improve: {lls.tolist()}")
    if not float(res.swarm["beta"].std()) < ZOO_SWARM_SD:
        raise AssertionError(f"phase 15b: final swarm beta sd {float(res.swarm['beta'].std())}")
    if not launches == fires == steps or expand.fused_expand.launches:
        raise AssertionError(f"phase 15b: lane kernel launched {launches} times for {fires} fires, {steps} steps")
    _jax_spread_gate("15b", {n: float(res.mle[n]) for n in ("beta", "sigma")}, ZOO_JAX["if2"])
    probs, values = counted.last
    out["lanes_err"] = max(out["lanes_err"], check_on_cloud(
        torch, expand, probs, values.unsqueeze(0), f"phase 15b's last lane cloud (n={ZOO_N}, L={probs.shape[1]})"))
    out["lanes"]["phase 15b"] = launches
    theta = alg.context.stack_parameters(constrained=False)
    sd = torch.full((2,), ZOO_IF2_SIGMA * ZOO_IF2_COOLING ** (ZOO_IF2_ITERS - 1), device="cuda")
    syncs = count_syncs(torch, lambda: alg._one_pass(theta, y[:20], sd))
    print(f"  host syncs a lane step by source (20 steps of one pass): "
          f"{ {k: round(v / 20, 4) for k, v in syncs.items()} }; total {sum(syncs.values()) / 20:.4f}")
    if profile:
        ops = profile_run(torch, "phase 15b, one IF2 pass", lambda: alg._one_pass(theta, y, sd))
        print(f"  device operations per lane step {ops / PMMH_T:.2f}")

    # (c) PIT and CRPS of the fitted model on a second series
    beta, sigma = float(res.mle["beta"]), float(res.mle["sigma"])
    fitted = zoo_fitted(pt, beta, sigma, "cuda")
    y_test = zoo_test_data(torch, pt)
    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)  # noqa: E731
    filt = counted(fitted, ZOO_N, record_states=True, device="cuda")
    _zero_counts(expand)
    counted.fires = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fres = filt.batch_filter(gen(5), y_test)
    u = pt.filters.predictive_pit(gen(6), fitted, fres, y_test).cpu().numpy()
    c = pt.filters.crps(gen(7), fitted, fres, y_test).cpu().numpy()
    wall = time.perf_counter() - t0
    launches, fires = expand.fused_expand.launches, counted.fires
    mu, sdp = kalman_predictive(y_test, beta, sigma)
    exact_crps = float(gaussian_crps(y_test, mu, sdp).mean())
    print(f"phase 15c: SISR(fitted, {ZOO_N}, record_states=True), PIT and CRPS over T={PMMH_T}: {wall:.3f} s; PIT "
          f"mean {u.mean():.6f} var {u.var():.6f} (uniform 0.5, {1 / 12:.6f}); CRPS mean {c.mean():.6f}, closed form "
          f"{exact_crps:.6f}; expand launches {launches} for {fires} resample fires; card {card}")
    if not (u.shape == c.shape == (PMMH_T,) and ((0.0 <= u) & (u <= 1.0)).all() and np.isfinite(c).all()):
        raise AssertionError("phase 15c: PIT outside [0, 1] or CRPS not finite")
    if not (abs(u.mean() - 0.5) < ZOO_PIT_MEAN and abs(u.var() - 1.0 / 12.0) < ZOO_PIT_VAR):
        raise AssertionError(f"phase 15c: PIT mean {u.mean()} var {u.var()}")
    if not abs(c.mean() - exact_crps) < ZOO_CRPS:
        raise AssertionError(f"phase 15c: CRPS mean {c.mean()} against the closed form's {exact_crps}")
    if not launches == fires > 0 or expand.fused_expand_lanes.launches:
        raise AssertionError(f"phase 15c: expand kernel launched {launches} times for {fires} fires")
    probs, values = counted.last
    out["k1_err"] = check_on_cloud(torch, expand, probs, last_cloud_planes(values),
                                   f"phase 15c's last SISR cloud (n={ZOO_N})")
    out["k1"]["phase 15c"] = launches
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return out


def apf_bias(torch, pt, seeds: int) -> int:
    """``--apf-bias``: :func:`apf_true` (T = N_OBS) over the seeds 100, 101,
    ... on the card and on the CPU: the mean and spread over seeds of each
    run's mean over lanes, and the gap of the two means in standard errors."""
    import numpy as np

    print(card_line())
    y = simulate_obs(N_OBS)
    card, cpu = (np.asarray([float(apf_true(torch, pt, y, device, seed)[1].log_likelihood.double().mean())
                             for seed in range(100, 100 + seeds)]) for device in ("cuda", "cpu"))
    se = math.sqrt(card.var(ddof=1) / len(card) + cpu.var(ddof=1) / len(cpu))
    print(f"card mean {card.mean()} (sd between seeds {card.std(ddof=1)}), CPU mean {cpu.mean()} (sd "
          f"{cpu.std(ddof=1)}); gap {card.mean() - cpu.mean()} = {(card.mean() - cpu.mean()) / se:+.3f} standard "
          f"errors over {seeds} seeds each")
    return 0


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
