"""Reduce a ``torch.profiler`` trace of the window to what the metrics read:
device-busy seconds, device operations, device time by kernel name, and the
longest idle gaps of the device by what the host was doing in them."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field

# a gap shorter than this is launch spacing, not idle time worth naming
_GAP_US = 5.0
# how far back among the host operations a gap's midpoint is looked up
_LOOKBACK = 4000
# the longest kernel or operation name a breakdown keeps
_NAME = 160
# the benchmark's own record_function ranges
ANNOTATION_PREFIX = "bench."


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float = 0.0
    device_ops: int = 0
    kernel_s: dict = field(default_factory=dict)  # kernel name -> device seconds
    kernel_count: dict = field(default_factory=dict)  # kernel name -> launches
    idle_gaps: list = field(default_factory=list)  # [(host operation, seconds)], longest first

    def kernel_seconds(self, names) -> tuple:
        """Summed device seconds and launches of the kernels named one of
        ``names`` (as a whole identifier in the traced name)."""
        pattern = re.compile(r"(?<![A-Za-z_])(?:%s)(?![A-Za-z0-9_])" % "|".join(map(re.escape, names)))
        secs, count = 0.0, 0
        for key, s in self.kernel_s.items():
            if pattern.search(key):
                secs += s
                count += self.kernel_count[key]
        return secs, count

    def kernel_table(self, rows: int = 40) -> list:
        """``[(device seconds, launches, name)]``, the longest first."""
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:rows]
        return [(s, self.kernel_count[name], name) for name, s in top]

    def breakdown(self) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:_NAME], s] for name, s in top],
                "idle_gaps": [[name[:_NAME], s] for name, s in self.idle_gaps[:10]]}


def _raw_events(prof):
    """``(start us, end us, name, on the device)`` of every traced
    operation, from the profiler's raw events (``prof.events()`` builds a
    Python object tree, some 80 us an event), ``record_function`` ranges
    left out: the trace mirrors them on the device."""
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if e.is_user_annotation() or "annotation" in kind or e.name().startswith(ANNOTATION_PREFIX):
            continue
        yield e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name(), str(e.device_type()).endswith("CUDA")


def summarize(prof, window_s: float) -> TraceSummary:
    """Read a finished ``torch.profiler.profile``."""
    return summarize_events(_raw_events(prof), window_s)


def summarize_events(events, window_s: float) -> TraceSummary:
    """Reduce ``(start us, end us, name, on the device)`` events: the device
    intervals merged into busy time, the idle gaps between them (inside the
    window) attributed to the innermost host operation running at each
    gap's midpoint ("python" where none was), summed by that name."""
    out = TraceSummary(window_s=window_s)
    device, host = [], []
    for start, end, name, on_device in events:
        (device if on_device else host).append((start, end, name))
    device.sort()
    host.sort()
    kernel_s, kernel_count = defaultdict(float), defaultdict(int)
    busy_us, gaps = 0.0, []
    cur_start = cur_end = None
    for start, end, name in device:
        kernel_s[name] += (end - start) * 1e-6
        kernel_count[name] += 1
        if cur_end is None:
            cur_start, cur_end = start, end
        elif start > cur_end:
            busy_us += cur_end - cur_start
            if start - cur_end >= _GAP_US:
                gaps.append((cur_end, start))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    out.busy_s = busy_us * 1e-6
    out.device_ops = len(device)
    out.kernel_s, out.kernel_count = dict(kernel_s), dict(kernel_count)

    starts = [h[0] for h in host]
    by_host = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        name = "python"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - _LOOKBACK, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by_host[name] += (g1 - g0) * 1e-6
    out.idle_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])
    return out
