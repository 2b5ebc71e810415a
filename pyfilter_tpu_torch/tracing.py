"""Named spans at the port's layer boundaries, recorded into the running
``torch.profiler`` trace.

:func:`span` opens a ``torch.profiler.record_function`` range named
``"pf." + name`` while a profiler records, and otherwise returns one shared
``contextlib.nullcontext()``: with no profiler a span costs one check of the
profiler's state. There is no switch: any ``torch.profiler.profile`` session
records the spans, beside the host operations and the device activity of
the same trace, on that trace's clock.

Reading a trace (``export_chrome_trace``, or the profiler's raw events):

- a span is a user annotation on the host; its name, start and end are the
  trace's;
- a span's parent is the ``pf.`` span that encloses it on the same thread;
- a request is an outermost ``pf.filter.pass`` (one ``batch_filter``) or
  ``pf.seq.fit`` (one sequential fit), and everything that encloses it on
  its thread belongs to it;
- a device operation belongs to the spans open on the host when its launch
  call (``cudaLaunchKernel`` and the like, the same correlation id) ran.

The spans (module and function of each):

- ``pf.filter.pass``, ``.step``, ``.predict``, ``.propagate``, ``.correct``:
  ``filters/base.py`` ``batch_filter``, one observation's ``_filter``, its
  predict, its uncorrected sub-steps, its correction;
- ``pf.filter.gate``: SISR's host read of its ESS gate;
- ``pf.filter.resample``: ``ParticleFilter._resample_cloud``;
- ``pf.seq.fit``, ``.step``, ``.trigger``, ``.rejuvenate``:
  ``inference/sequential/base.py``;
- ``pf.seq.pmmh``, ``pf.seq.double``: one PMMH transition (its re-filter, a
  ``pf.filter.pass``, and its acceptance read), a doubling of the state
  particles with its re-filter (``inference/sequential/kernels/mh.py``);
- ``pf.ffbsi.step``, ``.read``, ``.fallback``: one FFBSi backward step, its
  host read of the failed draws, one exact fallback pass
  (``filters/particle/smoothing.py``);
- ``pf.comm.<op>``: one exchange of ``parallel/_comm.py``.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function("pf." + name)`` range while a profiler records,
    else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("pf." + name)
    return _OFF
