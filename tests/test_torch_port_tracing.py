"""The port's ``pf.*`` spans (``pyfilter_tpu_torch.tracing``) on the CPU.

Each path runs under ``torch.profiler.profile`` (CPU activity) and its spans,
read from the profiler's raw events, must match the port's own counters one
for one and nest as the layers do: a gate and a resample inside a predict;
a predict, the sub-steps and a correction inside a filter step; a PMMH
transition holding one re-filter. With no profiler a span is a shared no-op
(``record_function`` is never entered), and a run's outputs are bit-equal
with and without a profiler.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import pyfilter_tpu_torch as pt
from pyfilter_tpu_torch import inference as tinf
from pyfilter_tpu_torch import tracing
from pyfilter_tpu_torch import timeseries as tts
from pyfilter_tpu_torch.filters.particle import ffbsi_smooth
from pyfilter_tpu_torch.parallel import _comm

T = 12


def gen(seed):
    return torch.Generator().manual_seed(seed)


def _sv_observations(n_obs):
    """``n_obs`` observations of the SV model (one every ``observe_every_step``
    rows of its sampled path; the rows between are NaN)."""
    model = pt.examples.stochastic_volatility_model(device="cpu")
    ys = model.sample_states(gen(0), n_obs * model.observe_every_step).get_paths()[1].numpy()
    return ys[~np.isnan(ys)]


def _ar_observations(n_obs):
    rng = np.random.default_rng(3)
    x, ys = 0.0, []
    for _ in range(n_obs):
        x = 0.2 + 0.7 * x + 0.4 * rng.normal()
        ys.append(x + 0.25 * rng.normal())
    return np.asarray(ys, np.float32)


def _ar_model():
    return tts.LinearStateSpaceModel(tts.models.AR(0.2, 0.7, 0.4, device="cpu"), (1.0, 0.25))


# -- the paths: each returns (its outputs, what its counters moved by) --------

def _sisr(record_intermediary):
    def run():
        filt = pt.SISR(pt.examples.stochastic_volatility_model(device="cpu"), 300,
                       record_states=record_intermediary, record_intermediary=record_intermediary, device="cpu")
        res = filt.batch_filter(gen(1), _sv_observations(T))
        return (res.log_likelihood, res.filter_means), {"syncs": filt.n_host_syncs, "fires": filt.n_resamples}
    return run


def _smc2(waste_free):
    def run():
        ctx = tinf.make_context(generator=gen(1), device="cpu")
        filt = pt.APF(pt.examples.stochastic_volatility_builder, 32, record_moments=False, device="cpu")
        alg = tinf.SMC2(filt, 48, threshold=0.5, num_steps=2, waste_free=waste_free, context=ctx,
                        generator=gen(2), record_moments=False, device="cpu")
        state = alg.fit(_sv_observations(T))
        k = alg.kernel
        return ((state.w, ctx.stack_parameters(constrained=False)),
                {"rejuvenations": k.n_rejuvenations, "transitions": k.n_transitions, "doublings": k.n_doublings})
    return run


def _ffbsi(batch_shape):
    def run():
        filt = pt.SISR(_ar_model(), 200, record_states=True, batch_shape=batch_shape, device="cpu")
        res = filt.batch_filter(gen(4), _ar_observations(T))
        before = ffbsi_smooth.fallback_passes
        traj = filt.smooth(gen(5), res, method="ffbsi", max_rounds=1, block=37)
        return (traj,), {"fallbacks": ffbsi_smooth.fallback_passes - before}
    return run


PATHS = {
    "sisr": _sisr(False),
    "sisr-substeps-recorded": _sisr(True),
    "smc2": _smc2(False),
    "smc2-waste-free": _smc2(True),
    "ffbsi": _ffbsi(()),
    "ffbsi-lanes": _ffbsi((3,)),
}


def _profiled(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    spans = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("pf.")]
    return out, spans


def _parent(child, spans):
    """The innermost ``pf.`` span that encloses ``child`` on its thread."""
    name, start, end, tid = child
    around = [s for s in spans if s is not child and s[3] == tid and s[1] <= start and end <= s[2]]
    return min(around, key=lambda s: s[2] - s[1])[0] if around else None


def _parents(spans, name):
    return Counter(_parent(s, spans) for s in spans if s[0] == name)


@pytest.mark.parametrize("record_intermediary", [False, True], ids=["substeps", "substeps-recorded"])
def test_sisr_spans_match_its_counters(record_intermediary):
    (_, counts), spans = _profiled(PATHS["sisr-substeps-recorded" if record_intermediary else "sisr"])
    names = Counter(s[0] for s in spans)
    assert names["pf.filter.pass"] == 1
    assert names["pf.filter.step"] == names["pf.filter.predict"] == names["pf.filter.correct"] == T
    assert names["pf.filter.gate"] == counts["syncs"] == T
    assert names["pf.filter.resample"] == counts["fires"] > 0
    assert names["pf.filter.propagate"] == T - 1  # the first observation has no sub-step
    assert _parents(spans, "pf.filter.gate") == {"pf.filter.predict": T}
    assert _parents(spans, "pf.filter.resample") == {"pf.filter.predict": counts["fires"]}
    for name in ("pf.filter.predict", "pf.filter.propagate", "pf.filter.correct"):
        assert set(_parents(spans, name)) == {"pf.filter.step"}
    assert _parents(spans, "pf.filter.step") == {"pf.filter.pass": T}


@pytest.mark.parametrize("path", ["smc2", "smc2-waste-free"])
def test_smc2_spans_match_its_kernel(path):
    (_, counts), spans = _profiled(PATHS[path])
    names = Counter(s[0] for s in spans)
    assert names["pf.seq.fit"] == 1
    assert names["pf.seq.step"] == names["pf.seq.trigger"] == T
    assert names["pf.seq.rejuvenate"] == counts["rejuvenations"] > 0
    assert names["pf.seq.pmmh"] == counts["transitions"] > 0
    assert names["pf.seq.double"] == counts["doublings"]
    assert set(_parents(spans, "pf.seq.step")) == {"pf.seq.fit"}
    assert set(_parents(spans, "pf.seq.trigger")) == {"pf.seq.step"}
    assert set(_parents(spans, "pf.seq.rejuvenate")) == {"pf.seq.step"}
    assert set(_parents(spans, "pf.seq.pmmh")) == {"pf.seq.rejuvenate"}
    # every transition re-filters the history once, in one pass
    refilters = _parents(spans, "pf.filter.pass")
    assert refilters["pf.seq.pmmh"] == counts["transitions"]
    assert refilters["pf.seq.double"] == counts["doublings"]
    assert sum(refilters.values()) == counts["transitions"] + counts["doublings"]
    # the forward steps of the fit, one an observation, outside any pass
    assert _parents(spans, "pf.filter.step")["pf.seq.step"] == T


@pytest.mark.parametrize("path", ["ffbsi", "ffbsi-lanes"])
def test_ffbsi_spans_match_its_counters(path):
    (_, counts), spans = _profiled(PATHS[path])
    names = Counter(s[0] for s in spans)
    assert names["pf.ffbsi.step"] == names["pf.ffbsi.read"] == T
    assert names["pf.ffbsi.fallback"] == counts["fallbacks"] > 0
    assert set(_parents(spans, "pf.ffbsi.read")) == {"pf.ffbsi.step"}
    assert set(_parents(spans, "pf.ffbsi.fallback")) == {"pf.ffbsi.step"}


@pytest.mark.parametrize("path", list(PATHS))
def test_outputs_are_bit_equal_under_a_profiler(path):
    plain, _ = PATHS[path]()
    (traced, _), spans = _profiled(PATHS[path])
    assert spans
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("filter.step") is tracing.span("seq.fit")
    for path in ("sisr-substeps-recorded", "smc2", "ffbsi"):
        PATHS[path]()


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_comm_wrappers_count_and_open_spans(one_rank_group):
    _comm.reset()
    t = torch.arange(6, dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.equal(_comm.all_reduce(t, "sum", one_rank_group), t)
        assert torch.equal(_comm.all_gather(t, one_rank_group), t)
        assert torch.equal(_comm.ring_shift(t, one_rank_group, 1), t)  # one rank: a copy, no exchange
    names = Counter(e.name() for e in prof.profiler.kineto_results.events() if e.name().startswith("pf."))
    assert names == {"pf.comm.all_reduce": 1, "pf.comm.all_gather": 1}
    assert _comm.counts() == {"all_reduce": {"calls": 1, "bytes": 24}, "all_gather": {"calls": 1, "bytes": 24},
                              "ring_shift": {"calls": 0, "bytes": 0}, "host_copies": 0}
    _comm.reset()
