"""The span reader (``benchmark/spans.py``) on synthetic events and on a
traced window of each cell at CPU sizes, and the trace summary's
indifference to the port's ``pf.`` spans."""

from __future__ import annotations

import math

import pytest

from benchmark import spans, trace
from benchmark.tests import small

# host spans on thread 1: pass [0, 100] holding step [10, 40]; kernel 1
# launched at 20 (inside both) runs [50, 70]; kernel 2 launched at 60 (inside
# the pass) runs [75, 85]; kernel 3 launched at 150 (outside) runs [150, 160]
RECORDS = [
    ("span", "pf.filter.pass", 0.0, 100.0, 1, 0, 0),
    ("span", "pf.filter.step", 10.0, 40.0, 1, 0, 0),
    ("launch", "cudaLaunchKernel", 20.0, 22.0, 1, 1, 0),
    ("launch", "cudaLaunchKernel", 60.0, 62.0, 1, 2, 0),
    ("launch", "cudaLaunchKernel", 150.0, 151.0, 1, 3, 0),
    ("device", "k1", 50.0, 70.0, 0, 1, 0),
    ("device", "k2", 75.0, 85.0, 0, 2, 0),
    ("device", "k3", 150.0, 160.0, 0, 3, 0),
]


def test_span_table_attributes_device_and_idle_time():
    table = spans.span_table(RECORDS)
    outer, inner = table.spans["pf.filter.pass"], table.spans["pf.filter.step"]
    assert (outer.count, inner.count) == (1, 1)
    assert outer.host_s == pytest.approx(100e-6) and inner.host_s == pytest.approx(30e-6)
    assert outer.self_s == pytest.approx(70e-6) and inner.self_s == pytest.approx(30e-6)
    assert outer.device_s == pytest.approx(30e-6) and inner.device_s == pytest.approx(20e-6)
    # the pass is busy over [50, 70] and [75, 85]; the step not at all
    assert outer.idle_s == pytest.approx(70e-6) and inner.idle_s == pytest.approx(30e-6)
    assert table.device_s == pytest.approx(40e-6) and table.covered_s == pytest.approx(30e-6)
    assert table.covered_share() == pytest.approx(75.0) and table.unlinked_s == 0.0
    assert table.outside == {"k3": pytest.approx(10e-6)}


def test_span_table_links_through_the_operation_without_a_runtime_call():
    """A device operation whose runtime call the trace lacks takes its
    launch from the host operation its linked id names; one with neither is
    counted unlinked; a span nested in one of its own name counts once in
    the host seconds."""
    recs = [
        ("span", "pf.ffbsi.step", 0.0, 50.0, 1, 0, 0),
        ("span", "pf.ffbsi.step", 5.0, 20.0, 1, 0, 0),
        ("op", "aten::add", 10.0, 12.0, 1, 7, 0),
        ("device", "add", 30.0, 40.0, 0, 99, 7),
        ("device", "lost", 60.0, 61.0, 0, 98, 8),
    ]
    table = spans.span_table(recs)
    st = table.spans["pf.ffbsi.step"]
    assert st.count == 2 and st.host_s == pytest.approx(50e-6)
    assert st.self_s == pytest.approx(50e-6)
    assert st.device_s == pytest.approx(10e-6) and st.idle_s == pytest.approx(40e-6)
    assert table.unlinked_s == pytest.approx(1e-6)


class _Event:
    def __init__(self, kind, name, start, end, device, corr=0, linked=0, thread=1):
        self.kind, self._name, self.start, self.end = kind, name, start, end
        self.device, self.corr, self.linked, self.thread = device, corr, linked, thread

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return int(self.start * 1e3)

    def end_ns(self):
        return int(self.end * 1e3)

    def device_type(self):
        return "DeviceType.CUDA" if self.device else "DeviceType.CPU"

    def is_user_annotation(self):
        return "annotation" in self.kind

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def start_thread_id(self):
        return self.thread


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events": lambda _: events})()


EVENTS = [
    _Event("user_annotation", "bench.pass", 0.0, 200.0, False),
    _Event("cpu_op", "aten::mul", 18.0, 30.0, False, corr=11),
    _Event("cuda_runtime", "cudaLaunchKernel", 20.0, 22.0, False, corr=1),
    _Event("cuda_runtime", "cudaLaunchKernel", 60.0, 62.0, False, corr=2),
    _Event("cuda_runtime", "cudaStreamSynchronize", 90.0, 140.0, False, corr=4),
    _Event("kernel", "k1", 50.0, 70.0, True, corr=1, linked=11),
    _Event("kernel", "k2", 75.0, 85.0, True, corr=2),
    _Event("gpu_user_annotation", "bench.pass", 50.0, 85.0, True),
]
PF_SPANS = [
    _Event("user_annotation", "pf.filter.pass", 0.0, 100.0, False),
    _Event("user_annotation", "pf.filter.step", 10.0, 40.0, False),
    _Event("gpu_user_annotation", "pf.filter.pass", 50.0, 85.0, True),
]


def test_records_read_the_profilers_events():
    recs = list(spans.records(_Prof(EVENTS + PF_SPANS)))
    kinds = {(r[0], r[1]) for r in recs}
    assert ("span", "pf.filter.pass") in kinds and ("span", "pf.filter.step") in kinds
    assert ("launch", "cudaLaunchKernel") in kinds and ("op", "aten::mul") in kinds
    assert ("device", "k1") in kinds and not any(r[1] == "bench.pass" for r in recs)
    assert sum(r[0] == "span" for r in recs) == 2  # the device mirror of a span is no span
    table = spans.span_table(recs)
    assert table.spans["pf.filter.step"].device_s == pytest.approx(20e-6)
    assert table.covered_share() == pytest.approx(100.0)


class _EventWithoutKind(_Event):
    """An event of a profiler whose raw events carry no activity type."""

    activity_type = property()


def test_records_find_launches_by_name_without_an_activity_type():
    """K1's launches come from a library of its own: their runtime calls
    link to no host operation, and are found by their correlation id."""
    events = [
        _EventWithoutKind("user_annotation", "pf.filter.resample", 0.0, 50.0, False),
        _EventWithoutKind("", "aten::empty", 2.0, 3.0, False, corr=5),
        _EventWithoutKind("", "cudaLaunchKernel", 10.0, 12.0, False, corr=5),
        _EventWithoutKind("", "cuLaunchKernel", 20.0, 22.0, False, corr=6),
        _EventWithoutKind("", "expand_kernel", 60.0, 70.0, True, corr=5),
        _EventWithoutKind("", "scan_kernel", 70.0, 75.0, True, corr=6),
        _EventWithoutKind("", "Runtime Triggered Module Loading", 80.0, 90.0, False),
        _EventWithoutKind("", "late", 100.0, 101.0, True, corr=7),
    ]
    recs = list(spans.records(_Prof(events)))
    assert [r[0] for r in recs if r[1].startswith("cu")] == ["launch", "launch"]
    assert [r[0] for r in recs if r[1] in ("aten::empty", "Runtime Triggered Module Loading")] == ["op", "op"]
    table = spans.span_table(recs)
    assert table.spans["pf.filter.resample"].device_s == pytest.approx(15e-6)
    assert table.unlinked_s == pytest.approx(1e-6) and table.outside == {}


def test_the_trace_summary_reads_the_same_with_and_without_spans():
    plain, spanned = trace.summarize(_Prof(EVENTS), 0.2), trace.summarize(_Prof(EVENTS + PF_SPANS), 0.2)
    assert plain == spanned
    assert plain.busy_s == pytest.approx(30e-6) and plain.device_ops == 2
    assert [name for name, _ in plain.idle_gaps] == ["python"]


@pytest.mark.parametrize("name", list(small.SIZES))
def test_a_traced_window_reports_its_spans(name):
    """At CPU sizes, with no device operation: every pass's spans, and the
    gate's host reads an observation where the cell runs SISR."""
    report = spans.run_report(small.cell(name), 2**31 + 11, 1, "cpu")
    assert report["device_s"] == 0.0 and report["covered_share"] is None
    counts = {k: v["count"] for k, v in report["spans"].items()}
    if name.endswith("smc2-k16384"):
        assert counts["pf.seq.fit"] == 1 and counts["pf.seq.step"] == report["observations"]
        assert set(report["metrics"]) == set()
    else:
        assert counts["pf.filter.pass"] == 1 and counts["pf.filter.step"] == report["observations"]
        assert report["metrics"] == {"filter.gate_syncs_per_obs": 1.0}
    if name.startswith("ar1-gauss"):
        assert counts["pf.ffbsi.step"] == report["counters"]["backward_steps"]
    assert all(math.isfinite(v["host_s"]) for v in report["spans"].values())
