"""Read the port's ``pf.`` spans (``pyfilter_tpu_torch.tracing``) from a
``torch.profiler`` trace, and run one cell's traced window to print them:

    python3 -m benchmark.spans --workload <cell> --seed <n> [--passes <k>]

For each span name: its count, the host seconds of its outermost instances
(an instance inside another of the same name is counted once, in the
outer), its host self seconds (outside any ``pf.`` span it encloses), the
device seconds of the operations launched inside it, and the device's idle
seconds inside its outermost instances. A device operation is launched
inside the spans open on the launching thread when its launch call ran:
the host runtime call (``cudaLaunchKernel`` and the like) of the same
correlation id, or, where the trace holds none, the host operation its
linked correlation id names. The device's busy intervals are merged as
``trace.summarize_events`` merges them.

The command runs the cell's set-up, then ``--passes`` passes (the traffic
mix's ``trace_passes`` by default) under the profiler, and prints the span
table on standard error and, as its last line, the table, the share of
device seconds launched inside some span, and the per-layer readings of
:data:`METRICS`.
"""

from __future__ import annotations

import argparse
import bisect
import json
import math
import re
import sys
from dataclasses import asdict, dataclass, field

SPAN_PREFIX = "pf."
_LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
# a runtime or driver call by its name, where the events carry no activity
# type (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cuLaunchKernel``)
_LAUNCH_NAME = re.compile(r"cu(da)?[A-Z]")


@dataclass
class SpanStats:
    count: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_s: float = 0.0
    idle_s: float = 0.0


@dataclass
class SpanTable:
    spans: dict  # span name -> SpanStats
    device_s: float = 0.0  # every device operation's seconds
    covered_s: float = 0.0  # of those, launched inside some span
    unlinked_s: float = 0.0  # of those, whose launch the trace does not hold
    outside: dict = field(default_factory=dict)  # operation name -> seconds launched outside every span

    def rows(self) -> list:
        """``[(name, SpanStats)]``, the most host seconds first."""
        return sorted(self.spans.items(), key=lambda kv: -kv[1].host_s)

    def covered_share(self) -> float | None:
        return 100.0 * self.covered_s / self.device_s if self.device_s > 0 else None


def records(prof):
    """``(kind, name, start us, end us, thread, correlation id, linked id)``
    of a finished ``torch.profiler.profile``'s raw events: ``"span"`` (a
    ``pf.`` range on the host), ``"launch"`` (a runtime or driver call),
    ``"op"`` (another host operation) or ``"device"``."""
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        name, start, end = e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3
        on_device = str(e.device_type()).endswith("CUDA")
        if e.is_user_annotation() or "annotation" in kind:
            if not on_device and name.startswith(SPAN_PREFIX):
                yield "span", name, start, end, e.start_thread_id(), 0, 0
        elif on_device:
            yield "device", name, start, end, 0, e.correlation_id(), e.linked_correlation_id()
        else:
            launch = kind in _LAUNCH_KINDS if kind else bool(_LAUNCH_NAME.match(name))
            yield ("launch" if launch else "op"), name, start, end, e.start_thread_id(), e.correlation_id(), 0


def _merged(intervals) -> tuple:
    """The union of ``(start, end)`` intervals: its starts, its ends and the
    busy length before each."""
    starts, ends, before = [], [], [0.0]
    for start, end in sorted(intervals):
        if ends and start <= ends[-1]:
            ends[-1] = max(ends[-1], end)
            continue
        if ends:
            before.append(before[-1] + ends[-1] - starts[-1])
        starts.append(start)
        ends.append(end)
    return starts, ends, before


def _busy_within(merged, lo: float, hi: float) -> float:
    """Busy length of the union ``merged`` inside ``[lo, hi]``."""
    starts, ends, before = merged

    def upto(t):
        i = bisect.bisect_right(starts, t) - 1
        return 0.0 if i < 0 else before[i] + min(t, ends[i]) - starts[i]

    return upto(hi) - upto(lo) if starts else 0.0


def span_table(recs) -> SpanTable:
    """Reduce :func:`records` (or records of the same form) to a
    :class:`SpanTable`."""
    spans, launches, ops, device = {}, {}, {}, []
    for kind, name, start, end, thread, corr, linked in recs:
        if kind == "span":
            spans.setdefault(thread, []).append((start, end, name))
        elif kind == "launch":
            launches[corr] = (start, thread)
        elif kind == "op":
            ops[corr] = (start, thread)
        else:
            device.append((start, end, corr, linked, name))
    merged = _merged((start, end) for start, end, *_ in device)
    stats, outer = {}, []

    # one sweep a thread: spans nest on a thread, so the open ones form a stack
    chains = {}  # (thread, launch time) -> names of the spans open then
    # each device operation's launch: (host time, thread), or None
    launched = [launches.get(corr) or (ops.get(linked) if linked else None) for _, _, corr, linked, _ in device]
    wanted = {}
    for at in launched:
        if at is not None:
            wanted.setdefault(at[1], set()).add(at[0])
    for thread, own in spans.items():
        events = [(s, 0, i) for i, (s, _, _) in enumerate(own)] + [(e, 2, i) for i, (_, e, _) in enumerate(own)]
        events += [(t, 1, -1) for t in wanted.get(thread, ())]
        events.sort()
        stack, child_s = [], [0.0] * len(own)
        for t, what, i in events:
            if what == 0:
                start, end, name = own[i]
                st = stats.setdefault(name, SpanStats())
                st.count += 1
                if all(own[j][2] != name for j in stack):
                    st.host_s += (end - start) * 1e-6
                    outer.append((start, end, name))
                stack.append(i)
            elif what == 1:
                chains[(thread, t)] = tuple(dict.fromkeys(own[j][2] for j in stack))
            else:
                stack.remove(i)
                start, end, name = own[i]
                stats[name].self_s += (end - start - child_s[i]) * 1e-6
                if stack:
                    child_s[stack[-1]] += end - start

    table = SpanTable(stats)
    for (start, end, _, _, op), at in zip(device, launched):
        secs = (end - start) * 1e-6
        table.device_s += secs
        if at is None:
            table.unlinked_s += secs
            continue
        chain = chains.get((at[1], at[0]), ())
        if chain:
            table.covered_s += secs
        else:
            table.outside[op] = table.outside.get(op, 0.0) + secs
        for name in chain:
            stats[name].device_s += secs
    for start, end, name in outer:
        stats[name].idle_s += (end - start - _busy_within(merged, start, end)) * 1e-6
    return table


def _of_span(name: str, value):
    """A reading of the span ``pf.<name>``: ``value(stats, observations,
    counters)``, or None where the window ran no such span or no device
    operation."""
    def read(table, observations, counters):
        st = table.spans.get(SPAN_PREFIX + name)
        return None if st is None or table.device_s <= 0 else value(st, observations, counters)
    return read


#: per-layer readings of a traced window: name -> f(table, observations,
#: counters moved in the window) -> value or None
METRICS = {
    "filter.gate_syncs_per_obs":
        lambda table, obs, c: c["gate_syncs"] / obs if "gate_syncs" in c else None,
    "filter.propagate_device_ms_per_obs": _of_span("filter.propagate", lambda st, obs, c: st.device_s * 1e3 / obs),
    "filter.correct_device_ms_per_obs": _of_span("filter.correct", lambda st, obs, c: st.device_s * 1e3 / obs),
    "smc2.rejuvenate_ms_per_obs": _of_span("seq.rejuvenate", lambda st, obs, c: st.host_s * 1e3 / obs),
    "smc2.rejuvenate_idle_share": _of_span("seq.rejuvenate", lambda st, obs, c: 100.0 * st.idle_s / st.host_s),
    "ffbsi.fallback_device_ms_per_step":
        _of_span("ffbsi.fallback", lambda st, obs, c: st.device_s * 1e3 / c["backward_steps"]),
    "ffbsi.fallback_idle_share": _of_span("ffbsi.fallback", lambda st, obs, c: 100.0 * st.idle_s / st.host_s),
}


def run_report(cell, seed: int, passes: int, device: str) -> dict:
    """Set up ``cell``, run ``passes`` passes under the profiler, and return
    the report (module docstring)."""
    import torch

    import pyfilter_tpu_torch as pt
    from benchmark import run

    torch.set_num_threads(1)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        run.load_kernels()
    driver = cell.driver()(pt, cell.config, cell.traffic, cell.program_model(), cell.reference(), device, seed)
    driver.setup()
    driver.sync()
    gated = getattr(driver, "filt", None)
    gate_before = getattr(gated, "n_host_syncs", None)
    acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if on_card else [])
    with torch.profiler.profile(activities=acts) as prof:
        window = run.Window(driver, math.inf, passes).run()
    table = span_table(records(prof))
    del prof
    counters = dict(window.counters)
    if gate_before is not None:
        counters["gate_syncs"] = gated.n_host_syncs - gate_before
    observations = driver.observations(window.passes)
    metrics = {name: f(table, observations, counters) for name, f in METRICS.items()}
    return {"workload": cell.name, "seed": seed, "passes": window.passes, "window_s": window.elapsed,
            "pass_s": window.pass_s, "observations": observations, "counters": counters,
            "covered_share": table.covered_share(), "device_s": table.device_s, "unlinked_s": table.unlinked_s,
            "outside": dict(sorted(table.outside.items(), key=lambda kv: -kv[1])[:10]),
            "metrics": {k: v for k, v in metrics.items() if v is not None},
            "spans": {name: asdict(st) for name, st in table.rows()}}


def main(argv=None) -> int:
    from benchmark import run, spec

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--passes", type=int, default=None)
    args = p.parse_args(argv)
    cell = spec.Cell(args.workload)
    run.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print(f"no result: {args.workload} needs a CUDA device", file=sys.stderr)
        return run.NO_CARD
    passes = args.passes or int(cell.traffic["trace_passes"])
    report = run_report(cell, args.seed, passes, "cuda")
    report["device"] = {"kind": torch.cuda.get_device_name(0), "power_limit_w": run.power_limit_w()}
    print(f"{'span':28s} {'count':>8s} {'host s':>10s} {'self s':>10s} {'device s':>10s} {'idle s':>10s}",
          file=sys.stderr)
    for name, st in report["spans"].items():
        print(f"{name:28s} {st['count']:8d} {st['host_s']:10.4f} {st['self_s']:10.4f} {st['device_s']:10.4f} "
              f"{st['idle_s']:10.4f}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
