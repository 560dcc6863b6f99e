"""Tracing — named spans bridging to torch.profiler.

Twin of `span` in ceph_tpu/utils/tracing.py (ref: src/tracing/*.tp
LTTng tracepoints + src/common/tracer.cc spans). A `span("name")` shows
up in a torch.profiler trace as a `record_function` range beside the
CUDA timeline, which answers "which host stage stalled the launch
pipeline". Spans also time into an optional PerfCounters time_avg key,
record into the flight recorder under a sampled trace context, and tag
the thread for the CPU sampler, exactly as the twin's do.

The capture helpers (`start_trace`, `stop_trace`, `trace`) are the
twin's over a torch.profiler capture instead of an XLA profiler session:
the host's ops and spans, and the card's kernels and copies where CUDA
is present, exported as a chrome trace into `log_dir` (open it in
chrome://tracing or Perfetto). Python call events stay off, as the
twin's capture keeps its Python tracer off.

Usage:
    with span("ecbackend.recover.batch"):
        ...
    with span("osd.op", counters=perf, key="op_latency"):
        ...
    start_trace("/tmp/trace")   # capture; one .pt.trace.json a stop
    ...
    stop_trace()
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

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


_session: list = [None, None]        # [torch.profiler.profile, log_dir]


def start_trace(log_dir: str) -> bool:
    """Begin a torch.profiler capture of the host and, where CUDA is
    present, the card (the 'enable tracing' admin-socket toggle).
    Returns False when a capture is already running or the profiler
    cannot start."""
    if _session[0] is not None:
        return False
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=acts)
        prof.start()
    except RuntimeError:
        return False
    _session[0], _session[1] = prof, log_dir
    return True


def stop_trace() -> bool:
    """End the capture and export it into its log_dir as
    `<host>.<pid>.<ns>.pt.trace.json`. Returns False when no capture
    runs or the export fails."""
    prof, log_dir = _session
    if prof is None:
        return False
    _session[0] = _session[1] = None
    try:
        prof.stop()
        out = Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(
            out / f"{socket.gethostname()}.{os.getpid()}."
                  f"{time.time_ns()}.pt.trace.json"))
        return True
    except (RuntimeError, OSError):
        return False


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a whole block: `with trace("/tmp/tr"): run_workload()`."""
    ok = start_trace(log_dir)
    try:
        yield ok
    finally:
        if ok:
            stop_trace()
