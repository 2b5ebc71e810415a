"""Run one cell of the benchmark and print its result as the last line:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the card, the kernels, the data from ``--seed`` and a
warm-up of every shape the window uses) runs first and is ``setup_s``.
The window then runs whole passes (whole rounds of a pool of fit seeds,
where the traffic mix names one) until ``--seconds`` have elapsed; with
``--trace 1`` it runs under ``torch.profiler`` and stops at the traffic
mix's ``trace_passes``, and the per-layer metrics are read. Once the
window has closed, the program's state is freed and a sample of its
outputs, drawn from the seed, is held against the plain reference: each
compared number is printed beside its limit on standard error and under
``checks`` in the result line.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import spec  # noqa: E402

#: top-level modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "pyfilter_tpu")
NO_CARD, FORBIDDEN_IMPORT = 3, 4


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs():
    """Every build and kernel cache at a fixed directory inside the checkout
    (``build/`` is ignored by git); the port builds its kernels into
    ``build/kernels``."""
    build = spec.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def load_kernels() -> str:
    """Load K1's and K2's libraries, both built together first where
    ``build/kernels`` does not hold them (a checkout's first run). The build
    stays in ``setup_s``; its share is named in the set-up line."""
    from pyfilter_tpu_torch.ops import _build

    built = [name for name, (messages, _) in _build.build_all().items() if messages is not None]
    for name in _build.SOURCES:
        _build.load(name)
    return f"the kernels' libraries ({'built: ' + ', '.join(built) if built else 'found built'})"


class LaunchShapes:
    """Logs the shapes of every K1 and K2 launch at the kernels' Python
    entry (``ops.expand._expand_forward``, ``_expand_lanes_forward``) while
    it is entered, for the rooflines' byte counts."""

    def __init__(self, expand):
        self.expand, self.shapes = expand, {"k1": [], "k2": []}

    def __enter__(self):
        ex, shapes = self.expand, self.shapes
        self.k1, self.k2 = ex._expand_forward, ex._expand_lanes_forward

        def k1(probs, u, v2d):
            shapes["k1"].append((int(probs.shape[0]), int(v2d.shape[0])))
            return self.k1(probs, u, v2d)

        def k2(probs_nl, u, planes):
            shapes["k2"].append((int(probs_nl.shape[0]), int(probs_nl.shape[1]), int(planes.shape[0])))
            return self.k2(probs_nl, u, planes)

        ex._expand_forward, ex._expand_lanes_forward = k1, k2
        return self

    def __exit__(self, *exc):
        self.expand._expand_forward, self.expand._expand_lanes_forward = self.k1, self.k2


class Window:
    """Whole rounds of the driver's ``round_passes`` passes until ``seconds``
    have elapsed, or ``max_passes`` passes."""

    def __init__(self, driver, seconds: float, max_passes: int | None = None):
        self.driver, self.seconds, self.max_passes = driver, seconds, max_passes
        self.round = driver.round_passes

    def run(self):
        import torch

        d = self.driver
        before = d.counters()
        d.sync()
        t0 = time.perf_counter()
        self.pass_s = []
        while True:
            start = time.perf_counter()
            with torch.profiler.record_function("bench.pass"):
                d.run_pass(len(self.pass_s))
            self.pass_s.append(time.perf_counter() - start)
            if self.max_passes and len(self.pass_s) >= self.max_passes:
                break
            if time.perf_counter() - t0 >= self.seconds and len(self.pass_s) % self.round == 0:
                break
        self.elapsed = time.perf_counter() - t0
        self.passes = len(self.pass_s)
        after = d.counters()
        self.counters = {k: after[k] - before[k] for k in after}
        return self


class LayerView:
    """What a per-layer metric reader sees of a traced run."""

    def __init__(self, window: Window, trace, launch_shapes: dict, observations: int, timings: dict):
        self.counters, self.trace = window.counters, trace
        self.launch_shapes, self.observations, self.timings = launch_shapes, observations, timings


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str) -> dict:
    """Set up, run the window, check, and return the result's fields
    (``device`` without the card's name). ``device`` is ``"cuda"`` in a
    benchmark run; the tests drive the rest of a run on ``"cpu"``."""
    import torch

    marks = [("torch and the device count", time.perf_counter())]
    import pyfilter_tpu_torch as pt
    from pyfilter_tpu_torch.ops import expand

    torch.set_num_threads(1)
    marks.append(("the port", time.perf_counter()))
    if torch.device(device).type == "cuda":
        marks.append((load_kernels(), time.perf_counter()))
    driver = cell.driver()(pt, cell.config, cell.traffic, cell.program_model(), cell.reference(), device, seed)
    marks.append(("the data", time.perf_counter()))
    driver.setup()
    driver.sync()
    setup_s = time.perf_counter() - T0
    marks.append(("the program and its warm-up", time.perf_counter()))
    steps = [f"{name} {t - prev:.3f} s" for (name, t), prev in zip(marks, [T0] + [t for _, t in marks])]
    print(f"setup: {setup_s:.3f} s; to import or make {', '.join(steps)}", file=sys.stderr)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    summary, shapes = None, {}
    if trace:
        from benchmark import trace as trace_mod

        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if on_card else [])
        with LaunchShapes(expand) as logged:
            with torch.profiler.profile(activities=acts) as prof:
                window = Window(driver, seconds, int(cell.traffic["trace_passes"])).run()
                closed = time.perf_counter()
            stopped = time.perf_counter()
        shapes = logged.shapes
        summary = trace_mod.summarize(prof, window.elapsed)
        del prof
        print(f"trace: {stopped - closed:.1f} s to stop the profiler, {time.perf_counter() - stopped:.1f} s to read "
              f"its events", file=sys.stderr)
        for secs, count, name in summary.kernel_table():
            print(f"  {secs:12.6f} s {count:8d}x  {name[:120]}", file=sys.stderr)
    else:
        window = Window(driver, seconds).run()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    print(f"window: {window.passes} passes, {window.elapsed:.3f} s; seconds a pass {window.pass_s}; "
          f"counters {window.counters}; {driver.diagnostics()}", file=sys.stderr)
    attempted, failed = driver.finish()
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)

    if trace:
        view = LayerView(window, summary, shapes, driver.observations(window.passes), driver.timings())
        metrics = {}
        for m in cell.per_layer:
            value = spec.module("metrics", m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = driver.end_to_end(window.passes, window.elapsed)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}

    # the reference runs once the window has closed and the peak is read,
    # with the program's state freed
    sample = driver.sample(window.passes)
    outputs = driver.program_outputs(sample)
    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = driver.compare(sample, outputs, cell.limits)
    correct = failed == 0 and all(math.isfinite(v) and v <= limit for _, v, limit in checks)

    dev = {"platform": "gpu", "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return result


class ForbiddenImport(RuntimeError):
    pass


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.Cell(args.workload)
    cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"no result: {args.workload} needs {cell.chips} CUDA device(s), found {found}", file=sys.stderr)
        return NO_CARD
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    except ForbiddenImport as e:
        print(f"no result: the process holds {', '.join(e.args[0])} after the window", file=sys.stderr)
        return FORBIDDEN_IMPORT
    dev = result["device"]
    dev["kind"] = torch.cuda.get_device_name(0)
    dev["power_limit_w"] = power_limit_w()
    result["device"] = {k: dev[k] for k in ("platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s",
                                            "power_limit_w") if k in dev}
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
