"""Tracing — named spans bridging to torch.profiler and an in-memory
capture.

Twin of `span` in ceph_tpu/utils/tracing.py (ref: src/tracing/*.tp
LTTng tracepoints + src/common/tracer.cc spans). A `span("name")` shows
up in a torch.profiler trace as a `record_function` range beside the
CUDA timeline, which answers "which host stage stalled the launch
pipeline". Spans also time into an optional PerfCounters time_avg key,
record into the flight recorder under a sampled trace context, and tag
the thread for the CPU sampler, exactly as the twin's do.

A span with nothing to feed costs one shared null context: no clock
read, no `record_function`, no generator. Something to feed is any of:
counters passed, a torch profiler running, a capture on, a sampled
flight context active, the CPU sampler on.

A capture (`with Capture() as cap`) keeps every span finished while it
is on in memory: name, the enclosing captured span on the same thread, start
and end on the Unix clock in ns (the clock torch.profiler gives its
device timestamps in), the thread's native id, and the span's work
tags (`span("x", bytes_in=...)`). While a capture is on, each run of
Python's cyclic collector is a `python.gc` span with its generation.

Spans made with `ring=False` (the device programs' and kernel
wrappers', inside an op) go to the capture, the torch profiler and
counters only: a sampled op's flight ring and the CPU sampler name
spans by mgr/tracing.CATEGORY_OF, where such a name would count as
`other` and take time from its enclosing span's category.

The capture helpers (`start_trace`, `stop_trace`, `trace`) are the
twin's over a torch.profiler capture instead of an XLA profiler session:
the host's ops and spans, and the card's kernels and copies where CUDA
is present, exported as a chrome trace into `log_dir` (open it in
chrome://tracing or Perfetto), and the span capture of the same stretch
beside it as `<...>.spans.json`. Python call events stay off, as the
twin's capture keeps its Python tracer off.

Usage:
    with span("ecbackend.recover.launch"):
        ...
    with span("osd.op", counters=perf, key="op_latency"):
        ...
    with span("gf_apply", ring=False, B=B, k=k) as sp:
        if sp.on:
            sp.tag(nnz=...)     # a tag worth computing only when kept
    with Capture() as cap:      # cap.records: the finished spans
        ...
    start_trace("/tmp/trace")   # capture; one .pt.trace.json a stop
    ...
    stop_trace()
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import os
import socket
import threading
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import flight_recorder as _fr
from . import profiler as _prof

GC_SPAN = "python.gc"
_fr.declare_span_names(GC_SPAN)

_profiling = torch._C._autograd._profiler_enabled
# the profiler's range in C where torch has it (a few us cheaper a span
# than record_function, which goes through the dispatcher)
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 record_function)


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One finished span of a capture."""
    id: int
    parent: int | None      # the enclosing captured span on the thread
    name: str
    start_ns: int           # Unix clock (time.time_ns)
    end_ns: int
    tid: int                # the thread's native id
    tags: dict


class Capture:
    """Keeps the spans finished while it is on (`with Capture() as
    cap`, or `start()` / `stop()`): `records`, in the order they
    finished."""

    def __init__(self):
        self.records: list[SpanRecord] = []
        self.active = False

    def start(self) -> "Capture":
        with _lock:
            if not self.active:
                self.active = True
                _captures.append(self)
                if len(_captures) == 1:
                    gc.callbacks.append(_on_gc)
        return self

    def stop(self) -> None:
        with _lock:
            if self.active:
                self.active = False
                _captures.remove(self)
                if not _captures:
                    gc.callbacks.remove(_on_gc)

    def __enter__(self) -> "Capture":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def write(self, path) -> None:
        """The records as JSON: {"spans": [record, ...]}."""
        Path(path).write_text(json.dumps(
            {"spans": [dataclasses.asdict(r) for r in self.records]}))


_lock = threading.Lock()
_captures: list[Capture] = []       # the captures on, in start order
_ids = itertools.count(1)
_tls = threading.local()    # .stack: ids of open captured spans; .tid


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _tid() -> int:
    """The thread's native id, asked of the OS once a thread (a system
    call: 10 us on some hosts)."""
    tid = getattr(_tls, "tid", None)
    if tid is None:
        tid = _tls.tid = threading.get_native_id()
    return tid


def _keep(rec: SpanRecord, caps) -> None:
    for cap in caps:
        if cap.active:
            cap.records.append(rec)


_gc_open: dict = {}     # native thread id -> (start ns, captures)


def _on_gc(phase: str, info: dict) -> None:
    tid = _tid()
    if phase == "start":
        _gc_open[tid] = (time.time_ns(), tuple(_captures))
        return
    t0, caps = _gc_open.pop(tid, (None, ()))
    if t0 is None:
        return
    st = _stack()
    _keep(SpanRecord(next(_ids), st[-1] if st else None, GC_SPAN, t0,
                     time.time_ns(), tid,
                     {"generation": info.get("generation"),
                      "collected": info.get("collected")}), caps)


class _Off:
    """The span with nothing to feed: one shared instance."""
    on = False
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **tags) -> None:
        pass


_OFF = _Off()


class _Span:
    on = True
    __slots__ = ("name", "counters", "key", "ring", "tags", "t0", "fspan",
                 "tagged", "rf", "caps", "sid", "parent", "start_ns")

    def __init__(self, name, counters, key, ring, tags):
        self.name, self.counters, self.key = name, counters, key
        self.ring, self.tags = ring, tags

    def tag(self, **tags) -> None:
        """Add work tags known only inside the span."""
        self.tags.update(tags)

    def __enter__(self):
        self.t0 = time.perf_counter() if self.counters is not None \
            else 0.0
        self.fspan = _fr.trace_span(self.name) \
            if self.ring and _fr.current_sampled() is not None else None
        if self.fspan is not None:
            self.fspan.__enter__()
        self.tagged = self.ring and _prof.push_span(self.name)
        self.caps = tuple(_captures)
        if self.caps:
            st = _stack()
            self.sid = next(_ids)
            self.parent = st[-1] if st else None
            st.append(self.sid)
            self.start_ns = time.time_ns()
        self.rf = None
        if _profiling():
            self.rf = _range(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        # record even when the body raises — failing/slow-error ops are
        # exactly the ones worth timing (PerfCounters.time() semantics)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.caps:
            end = time.time_ns()
            st = _stack()
            if st and st[-1] == self.sid:
                st.pop()
            _keep(SpanRecord(self.sid, self.parent, self.name,
                             self.start_ns, end, _tid(), self.tags),
                  self.caps)
        if self.tagged:
            _prof.pop_span()
        if self.fspan is not None:
            self.fspan.__exit__(None, None, None)
        if self.counters is not None and self.key is not None:
            self.counters.tinc(self.key, time.perf_counter() - self.t0)
        return False


def span(name: str, counters=None, key: str | None = None, *,
         ring: bool = True, **tags):
    """Named span: visible in torch.profiler traces; optionally tincs
    `counters[key]` (a time_avg) with the wall duration; kept by the
    captures that are on, with `tags`; with `ring` (the default), when
    a SAMPLED trace context is active (utils/flight_recorder) — recorded
    into the flight ring under that trace, and, when the CPU sampler is
    on, tags this thread with the span's attribution category. One
    instrumentation point, five consumers; with none of them, the
    shared null context."""
    if counters is None and not _captures and not _profiling() and (
            not ring or (not _prof._ACTIVE
                         and _fr.current_sampled() is None)):
        return _OFF
    return _Span(name, counters, key, ring, tags)


_session: list = [None, None, None]  # [profile, log_dir, Capture]


def start_trace(log_dir: str) -> bool:
    """Begin a torch.profiler capture of the host and, where CUDA is
    present, the card (the 'enable tracing' admin-socket toggle), and a
    span capture beside it. Returns False when a capture is already
    running or the profiler cannot start."""
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
    _session[:] = [prof, log_dir, Capture().start()]
    return True


def stop_trace() -> bool:
    """End the capture and export it into its log_dir as
    `<host>.<pid>.<ns>.pt.trace.json`, with its spans as
    `<host>.<pid>.<ns>.spans.json`. Returns False when no capture runs
    or the export fails."""
    prof, log_dir, cap = _session
    if prof is None:
        return False
    _session[:] = [None, None, None]
    cap.stop()
    try:
        prof.stop()
        out = Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        stem = out / f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
        prof.export_chrome_trace(f"{stem}.pt.trace.json")
        cap.write(f"{stem}.spans.json")
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
