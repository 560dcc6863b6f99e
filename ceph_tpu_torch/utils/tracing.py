"""Tracing — named spans bridging to torch.profiler.

Twin of `span` in ceph_tpu/utils/tracing.py (ref: src/tracing/*.tp
LTTng tracepoints + src/common/tracer.cc spans). A `span("name")` shows
up in a torch.profiler trace as a `record_function` range beside the
CUDA timeline, which answers "which host stage stalled the launch
pipeline". Spans also time into an optional PerfCounters time_avg key,
record into the flight recorder under a sampled trace context, and tag
the thread for the CPU sampler, exactly as the twin's do.

The capture helpers (`start_trace`, `stop_trace`, `trace`) come with a
later slice.

Usage:
    with span("ecbackend.recover.batch"):
        ...
    with span("osd.op", counters=perf, key="op_latency"):
        ...
"""

from __future__ import annotations

import contextlib
import time

from torch.profiler import record_function

from . import flight_recorder as _fr
from . import profiler as _prof


@contextlib.contextmanager
def span(name: str, counters=None, key: str | None = None):
    """Named span: visible in torch.profiler traces; optionally tincs
    `counters[key]` (a time_avg) with the wall duration; when a SAMPLED
    trace context is active (utils/flight_recorder) — recorded into the
    flight ring under that trace; and, when the CPU sampler is on, tags
    this thread with the span's attribution category. One
    instrumentation point, four consumers, as in the twin."""
    t0 = time.perf_counter() if counters is not None else 0.0
    fspan = _fr.trace_span(name) \
        if _fr.current_sampled() is not None else None
    if fspan is not None:
        fspan.__enter__()
    tagged = _prof.push_span(name)
    try:
        with record_function(name):
            yield
    finally:
        # record even when the body raises — failing/slow-error ops are
        # exactly the ones worth timing (PerfCounters.time() semantics)
        if tagged:
            _prof.pop_span()
        if fspan is not None:
            fspan.__exit__(None, None, None)
        if counters is not None and key is not None:
            counters.tinc(key, time.perf_counter() - t0)
