"""The harness on the CPU at sizes a test run holds: each cell's window,
check and result line, the references, the byte counts, the trace
reduction, the refusal without a card and the imports."""

from __future__ import annotations

import ast
import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import peaks, run, spec, trace
from benchmark.tests import small

CELLS = list(small.SIZES)
FORBIDDEN = {"jax", "jaxlib", "flax", "pyfilter_tpu"}


@pytest.mark.parametrize("trace_on", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_a_window_and_checks(name, trace_on):
    cell = small.cell(name)
    result = run.run_cell(cell, 2**31 + 7, 0.0, trace_on, "cpu")
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == set(cell.limits)
    assert all(math.isfinite(c["value"]) for c in result["checks"].values())
    if trace_on:
        assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
        counters = [m["name"] for m in cell.per_layer if m["source"] == "program_counter"]
        assert set(counters) <= set(result["metrics"])
        assert len(result["breakdown"]["device_ops"]) <= 10 and len(result["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    json.dumps(result)


def test_same_seed_same_inputs():
    cell = small.cell(CELLS[0])
    make = cell.driver()
    a = make(None, cell.config, cell.traffic, None, cell.reference(), "cpu", 2**33 + 1)
    b = make(None, cell.config, cell.traffic, None, cell.reference(), "cpu", 2**33 + 1)
    c = make(None, cell.config, cell.traffic, None, cell.reference(), "cpu", 2**33 + 2)
    # every seed filters the same series, each seed in its own order
    assert np.array_equal(a.data, c.data) and len(a.data) > 1
    assert np.array_equal(a.order, b.order) and not np.array_equal(a.order, c.order)
    assert np.array_equal(a.dataset(0), b.dataset(0))
    assert a.pass_seeds(3) == b.pass_seeds(3) != a.pass_seeds(4)
    assert a.sample(10) == b.sample(10)


class _Passes:
    """A driver whose passes take no time: the window's pass count alone."""

    def __init__(self, round_passes):
        self.round_passes, self.ran = round_passes, []

    def counters(self):
        return {}

    def sync(self):
        pass

    def run_pass(self, i):
        self.ran.append(i)


@pytest.mark.parametrize("round_passes", [1, 4])
def test_window_runs_whole_rounds_of_the_pool(round_passes):
    w = run.Window(_Passes(round_passes), seconds=0.0).run()
    assert w.passes == round_passes and w.driver.ran == list(range(round_passes))
    assert run.Window(_Passes(round_passes), seconds=0.0, max_passes=1).run().passes == 1
    # every seed fits the same set of the pool's generator seeds in each round
    cell = spec.Cell("sv-notebook.smc2-k16384")
    make = cell.driver()
    rounds = [make(None, cell.config, cell.traffic, None, cell.reference(), "cpu", seed) for seed in (11, 12, 13)]
    k = rounds[0].round_passes
    sets = [sorted(map(tuple, (d.pass_seeds(i) for i in range(r * k, (r + 1) * k)))) for d in rounds for r in (0, 3)]
    assert k == 4 and all(s == sets[0] for s in sets) and len(set(sets[0])) == k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sv_reference_runs_small(dtype):
    ref = spec.module("reference", "sv-notebook")
    cfg = dict(spec.load_json(spec.HERE / "configs" / "sv-notebook.json"), observations=12)
    y = ref.simulate(cfg, np.random.default_rng(1), 2)
    assert y.shape == (2, 12) and np.isfinite(y).all()
    ll, mean = ref.sisr(cfg, y[0], 500, torch.Generator().manual_seed(1), dtype=dtype)
    assert math.isfinite(ll) and 0.5 < mean < 1.5
    out = ref.smc2(cfg, y[0], 32, 20, torch.Generator().manual_seed(2), dtype=dtype)
    assert set(out) == {f"{s}.{p}" for s in ("mean", "sd") for p in ref.PARAMETERS} | {"loglik"}
    assert all(math.isfinite(v) for v in out.values())


def test_ar1_reference_matches_a_dense_kalman():
    ref = spec.module("reference", "ar1-gauss")
    cfg = dict(spec.load_json(spec.HERE / "configs" / "ar1-gauss.json"), observations=6)
    y = ref.simulate(cfg, np.random.default_rng(3), 1)[0].astype(np.float64)
    ll, lag = ref.kalman_rts(cfg, y)
    # the joint Gaussian of (x_0..x_T, y_1..y_T), conditioned directly
    a, b, s, o, n = cfg["alpha"], cfg["beta"], cfg["sigma"], cfg["obs_sd"], len(y)
    mx = np.empty(n + 1)
    mx[0] = a
    for t in range(1, n + 1):
        mx[t] = a + b * mx[t - 1]
    cov = np.empty((n + 1, n + 1))
    var = np.empty(n + 1)
    var[0] = s * s
    for t in range(1, n + 1):
        var[t] = b * b * var[t - 1] + s * s
    for i in range(n + 1):
        for j in range(n + 1):
            cov[i, j] = b ** abs(i - j) * var[min(i, j)]
    h = np.eye(n + 1)[1:]
    syy = h @ cov @ h.T + o * o * np.eye(n)
    r = y - h @ mx
    want = mx + cov @ h.T @ np.linalg.solve(syy, r)
    want_ll = -0.5 * (n * math.log(2 * math.pi) + np.linalg.slogdet(syy)[1] + r @ np.linalg.solve(syy, r))
    assert abs(ll - want_ll) < 1e-10
    # E sum_t x_{t-1} x_t under x | y ~ N(want, post)
    post = cov - cov @ h.T @ np.linalg.solve(syy, h @ cov)
    want_lag = sum(want[t - 1] * want[t] + post[t - 1, t] for t in range(1, n + 1))
    assert abs(lag - want_lag) < 1e-10
    # the trajectories' reading: draws from the exact smoothing law average to it
    draws = np.random.default_rng(0).multivariate_normal(want, post, size=200_000).T
    assert abs(float(ref.lag_product(torch.as_tensor(draws))) - lag) < 0.01
    ll16, lag16 = ref.kalman_rts(cfg, y, dtype=torch.bfloat16)
    assert math.isfinite(ll16) and abs(lag16 - lag) < 0.5


def test_kernel_byte_counts():
    # K1 at n = 1e7, d = 1: probs 4n, u 4, values 4n read; out 4n, idx 4n written
    assert peaks.k1_bytes(10_000_000, 1) == 4 * 10_000_000 * 4 + 4
    assert peaks.k1_bytes(1000, 3) == 4000 + 4 + 12000 + 12000 + 4000
    # K2 at n = 400, L = 16384, d = 2
    n, lanes = 400, 16384
    assert peaks.k2_bytes(n, lanes, 2) == 4 * n * lanes * (1 + 2 + 2 + 1) + 4 * lanes
    assert peaks.least_seconds(3_350_000_000_000) == pytest.approx(1.0)


def test_trace_summary_merges_busy_time_and_names_gaps():
    events = [
        (0, 100, "aten::add", False), (10, 30, "add_kernel", True),
        (25, 40, "copy_kernel", True), (100, 200, "aten::item", False),
        (140, 150, "add_kernel", True), (150, 400, "aten::mul", False),
        (300, 320, "mul_kernel", True),
    ]
    s = trace.summarize_events(events, window_s=400e-6)
    # busy: [10, 40] (two overlapping kernels merged), [140, 150], [300, 320]
    assert s.busy_s == pytest.approx(60e-6) and s.device_ops == 4
    assert s.kernel_seconds(("add_kernel",)) == (pytest.approx(30e-6), 2)
    # the gap 40-140 falls in aten::add (its midpoint 90), 150-300 in aten::mul
    assert dict(s.idle_gaps) == {"aten::add": pytest.approx(100e-6), "aten::mul": pytest.approx(150e-6)}
    assert s.breakdown()["device_ops"][0][0] == "add_kernel"


@pytest.mark.parametrize("trace_flag", ["0", "1"])
def test_no_card_means_no_result(trace_flag):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", "3000000000",
                           "--seconds", "1", "--trace", trace_flag], cwd=spec.ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


_LOAD_ALL = """
import sys
from benchmark import control, peaks, run, sets, spec, trace
for cell in spec.benchmark()["workloads"]:
    c = spec.Cell(cell["name"])
    c.driver(), c.reference(), c.program_model()
    for m in c.per_layer:
        spec.module("metrics", m["name"])
import pyfilter_tpu_torch
print(sorted({n.split(".")[0] for n in sys.modules}))
"""

_LOAD_REFERENCES = """
import sys
from benchmark import spec
for cell in spec.benchmark()["workloads"]:
    spec.Cell(cell["name"]).reference()
print(sorted({n.split(".")[0] for n in sys.modules}))
"""


def _top_level_modules(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
                          check=True)
    return set(ast.literal_eval(proc.stdout.strip().splitlines()[-1]))


def test_harness_and_program_import_no_jax():
    assert not _top_level_modules(_LOAD_ALL) & FORBIDDEN


def test_references_import_nothing_of_the_program():
    assert not _top_level_modules(_LOAD_REFERENCES) & (FORBIDDEN | {"pyfilter_tpu_torch"})
    for path in (spec.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in FORBIDDEN | {"pyfilter_tpu_torch", "benchmark"} for n in names), path


def test_trace_summary_reads_the_profilers_raw_events():
    x = torch.ones(64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.pass"):
            for _ in range(20):
                x = x * 2.0
    s = trace.summarize(prof, window_s=1.0)
    assert s.busy_s == 0.0 and s.device_ops == 0 and s.idle_gaps == []
    names = [name for _, _, name, _ in trace._raw_events(prof)]
    assert "aten::mul" in names and "bench.pass" not in names
