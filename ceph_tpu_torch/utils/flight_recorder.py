"""Flight recorder — per-daemon span ring + wire-propagated trace context.

Rebuild of the reference's distributed tracing (ref: src/common/
tracer.cc Jaeger/OpenTelemetry spans carried across the wire in
MOSDOp::otel_trace, plus the blkin/babeltrace lineage): a compact
trace context (trace id, parent span id, sampled flag) rides every
client op as an OPTIONAL, version-gated frame field, every hop appends
its finished spans to a bounded in-memory ring, and a mgr-side
assembler (mgr/tracing.py) stitches the rings into one causal timeline
per trace.

Design points, in the r9 observability plane's idiom:

* SAME instrumentation points — utils/tracing.span() (the jax.profiler
  + PerfCounters double-duty spans) additionally records into the
  flight ring whenever a SAMPLED context is active, so the trace plane
  cannot drift from the counters (one list of span sites, three
  consumers).
* DECLARED span names — like PerfCountersBuilder's counter registry,
  every span name the recorder may emit is declared up front
  (declare_span_names) and the observability smoke test asserts no
  ring ever carries an undeclared name.
* OFF-SAMPLE near-zero cost — with no active sampled context,
  trace_span() is one contextvar read; an UNSAMPLED context (the
  common case: the id travels so slow ops can be retroactively
  assembled, but nothing records eagerly) costs ~17 bytes on the wire
  and nothing else.
* RETROACTIVE slow-op capture — an op that crosses
  osd_op_complaint_time after the sampling decision said no is
  converted from its OpTracker event marks into `retro.*` spans
  (record_tracked), keyed by the trace id the context carried — so
  `ceph_cli trace` can assemble a timeline for an op nobody chose to
  sample. Hops that keep no OpTracker state (store sub-ops) leave
  gaps; the assembler reports them as wire/untraced time (documented
  assembler gap semantics, ARCHITECTURE "Distributed tracing (r15)").
* CLIENT COST FEED — a sampled context from a client carries that
  client's per-target latency EWMAs + complaint set (client_lat /
  client_suspects), which the serving daemon folds into the helper
  cost table the repair-locality planner ranks by (the r14 follow-up:
  cost ranking sees client-observed slowness, not only the daemon's
  own store-op EWMAs).

Timestamps are wall-clock (time.time()): every daemon of this
single-host harness shares the clock, which is what lets the
assembler order spans ACROSS daemons without clock-skew correction
(disclosed in the architecture notes).
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import struct
import threading
import time

from . import profiler as _prof

__all__ = [
    "TraceContext", "FlightRecorder", "trace_span", "activate",
    "current", "current_sampled", "declare_span_names",
    "is_span_declared", "declared_span_names", "new_trace_id",
    "retro_root_id",
]

#: every span name the flight recorder may record — the span-name
#: mirror of perf_counters.declared_counters (the r9 no-undeclared-
#: names invariant, extended to the trace plane per the r15 CI
#: satellite). Call sites declare theirs at import time.
declared_span_names: set[str] = set()
_declared_lock = threading.Lock()


def declare_span_names(*names: str) -> None:
    with _declared_lock:
        declared_span_names.update(names)


def is_span_declared(name: str) -> bool:
    with _declared_lock:
        return name in declared_span_names


# names this module itself emits (the retro.* family from
# record_tracked; retro event names outside the allowlist fold into
# the root span's tags instead of minting undeclared span names).
# retro.subop / retro.store.apply are the r18 replica-hop spans: a
# primary crossing the complaint threshold asks its acting set to
# publish them from their sub-op retro rings (standalone's
# retro_publish store op), closing the r15 gap where replica time
# retro-assembled as "wire".
_RETRO_EVENTS = ("reached_pg", "commit_sent", "done")
declare_span_names("retro.op", "retro.subop", "retro.store.apply",
                   *(f"retro.{e}" for e in _RETRO_EVENTS))


def retro_root_id(trace_id: int) -> int:
    """The DETERMINISTIC span id of a trace's retro.op root: derived
    from the trace id alone, so replicas publishing retro.subop spans
    (which never saw the primary's retro conversion) parent them
    under the same root the primary minted — the assembler then
    subtracts sub-op time from the root's self time instead of
    double-counting it."""
    return ((int(trace_id) ^ 0x9E3779B97F4A7C15)
            & 0x7FFFFFFFFFFFFFFF) | 1


#: ids come from a module-level RNG seeded from the OS, never the
#: global `random` stream — seeded thrash replays must not be
#: perturbed by trace-id draws interleaving into their schedule
_id_rng = random.Random()
_id_lock = threading.Lock()


def new_trace_id() -> int:
    with _id_lock:
        return _id_rng.getrandbits(63) | 1   # never 0 (0 = "no id")


def coin(p: float) -> bool:
    """One sampling draw from the module RNG (never the global
    `random` stream — see _id_rng)."""
    if p <= 0.0:
        return False
    if p >= 1.0:
        return True
    with _id_lock:
        return _id_rng.random() < p


class TraceContext:
    """The compact wire context: (trace_id, parent_span_id, sampled)
    plus the optional client cost snapshot a first-hop sampled op
    carries. parent_span_id is the span id new child spans attach
    under (the caller's active span)."""

    __slots__ = ("trace_id", "parent_span_id", "sampled",
                 "client_lat", "client_suspects")

    def __init__(self, trace_id: int, parent_span_id: int = 0,
                 sampled: bool = False,
                 client_lat: dict[int, float] | None = None,
                 client_suspects: tuple[int, ...] = ()):
        self.trace_id = int(trace_id)
        self.parent_span_id = int(parent_span_id)
        self.sampled = bool(sampled)
        #: osd id -> client-observed read latency EWMA (seconds)
        self.client_lat = client_lat
        self.client_suspects = tuple(client_suspects)

    def child(self, span_id: int) -> "TraceContext":
        """The context a span's body runs under: same trace, this span
        as the parent of whatever records next. The cost snapshot does
        NOT propagate — it is a first-hop payload, folded once."""
        return TraceContext(self.trace_id, span_id, self.sampled)

    # -- wire form (the optional _Blob v2 tail field) -------------------------

    _FLAG_SAMPLED = 0x01
    _FLAG_LAT = 0x02

    def encode(self) -> bytes:
        flags = (self._FLAG_SAMPLED if self.sampled else 0)
        lat = self.client_lat if self.sampled else None
        sus = self.client_suspects if self.sampled else ()
        if lat or sus:
            flags |= self._FLAG_LAT
        out = struct.pack("<QQB", self.trace_id,
                          self.parent_span_id, flags)
        if flags & self._FLAG_LAT:
            lat = lat or {}
            out += struct.pack("<H", len(lat))
            for osd in sorted(lat):
                out += struct.pack("<if", int(osd), float(lat[osd]))
            out += struct.pack("<H", len(sus))
            for osd in sus:
                out += struct.pack("<i", int(osd))
        return out

    @classmethod
    def decode(cls, blob) -> "TraceContext | None":
        """Tolerant decode: a malformed context never kills the op —
        the op executes untraced (the field is advisory metadata)."""
        try:
            tid, parent, flags = struct.unpack_from("<QQB", blob, 0)
            off = 17
            lat = None
            sus: tuple[int, ...] = ()
            if flags & cls._FLAG_LAT:
                (n,) = struct.unpack_from("<H", blob, off)
                off += 2
                lat = {}
                for _ in range(n):
                    osd, v = struct.unpack_from("<if", blob, off)
                    off += 8
                    lat[int(osd)] = float(v)
                (n,) = struct.unpack_from("<H", blob, off)
                off += 2
                sus = struct.unpack_from(f"<{n}i", blob, off) \
                    if n else ()
            if not tid:
                return None
            return cls(tid, parent, bool(flags & cls._FLAG_SAMPLED),
                       client_lat=lat, client_suspects=sus)
        except (struct.error, ValueError, TypeError):
            return None


class FlightRecorder:
    """Bounded ring of finished spans for ONE daemon (the per-daemon
    flight recorder: in-RAM, dies with the process, dumped via the
    `trace dump` asok/wire command and drained incrementally into
    MgrReports for the mgr-side assembler).

    Capacity resolves LIVE through the daemon config
    (osd_trace_ring_size) when one is provided — a committed
    `config set` resizes a running ring on the next record."""

    def __init__(self, daemon: str, capacity: int = 2048, config=None):
        self.daemon = daemon
        self._capacity = int(capacity)
        self._config = config
        self._ring: list[dict] = []
        self._seq = 0            # monotone per-span sequence
        self._shipped = 0        # drain() cursor (MgrReport shipping)
        self._dropped = 0        # evictions total
        self._dropped_unshipped = 0
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        if self._config is not None:
            try:
                return int(self._config.get("osd_trace_ring_size"))
            except (KeyError, ValueError, TypeError):
                pass
        return self._capacity

    def record(self, trace_id: int, span_id: int, parent_id: int,
               name: str, start: float, duration: float,
               tags: dict | None = None) -> None:
        """Append one FINISHED span. `start` is wall-clock seconds,
        `duration` in seconds."""
        span = {
            "trace_id": f"{int(trace_id):016x}",
            "span_id": f"{int(span_id):016x}",
            "parent_id": f"{int(parent_id):016x}",
            "name": name,
            "daemon": self.daemon,
            "start": round(float(start), 6),
            "dur": round(float(duration), 9),
        }
        if tags:
            span["tags"] = tags
        cap = self.capacity
        with self._lock:
            self._seq += 1
            span["seq"] = self._seq
            self._ring.append(span)
            over = len(self._ring) - cap
            if over > 0:
                for s in self._ring[:over]:
                    if s["seq"] > self._shipped:
                        self._dropped_unshipped += 1
                self._dropped += over
                del self._ring[:over]

    def record_tracked(self, op, ctx: TraceContext,
                       desc: str | None = None) -> None:
        """Retroactive capture: convert a FINISHED TrackedOp's event
        marks into spans under the op's carried trace id (the
        complaint-threshold path — the op was never sampled, but its
        OpTracker history exists anyway). One `retro.op` root spanning
        the whole op, one `retro.<event>` child per allowlisted
        inter-event gap; other events fold into the root's tags."""
        if not getattr(op, "done", False):
            return
        dur = op.duration
        end_wall = getattr(op, "t_end_wall", time.time())
        start_wall = end_wall - dur
        # deterministic root id: replica-published retro.subop spans
        # parent under this same id without any coordination
        root = retro_root_id(ctx.trace_id)
        extra = []
        prev_t = 0.0
        for t_rel, ev in op.events:
            if ev == "initiated":
                prev_t = t_rel
                continue
            if ev in _RETRO_EVENTS:
                self.record(ctx.trace_id, new_trace_id(), root,
                            f"retro.{ev}", start_wall + prev_t,
                            max(0.0, t_rel - prev_t))
            else:
                extra.append(f"{ev}@{t_rel:.6f}")
            prev_t = t_rel
        tags = {"desc": desc or getattr(op, "desc", ""),
                "retro": True}
        if extra:
            tags["events"] = extra
        self.record(ctx.trace_id, root, ctx.parent_span_id,
                    "retro.op", start_wall, dur, tags)

    # -- views ----------------------------------------------------------------

    def dump(self, trace_id: str | int | None = None,
             limit: int | None = None) -> dict:
        """The `trace dump` admin command body. `trace_id` filters to
        one trace (hex string or int)."""
        want = None
        if trace_id is not None:
            want = trace_id if isinstance(trace_id, str) \
                else f"{int(trace_id):016x}"
            want = want.lower().removeprefix("0x").rjust(16, "0")
        with self._lock:
            spans = [s for s in self._ring
                     if want is None or s["trace_id"] == want]
            if limit is not None:
                spans = spans[-int(limit):]
            return {"daemon": self.daemon,
                    "capacity": self.capacity,
                    "recorded": self._seq,
                    "dropped": self._dropped,
                    "dropped_unshipped": self._dropped_unshipped,
                    "spans": list(spans)}

    def drain(self, limit: int = 512) -> list[dict]:
        """Spans recorded since the last drain (the MgrReport shipping
        cursor). Bounded per call; evicted-before-shipped spans are
        counted in dropped_unshipped (the gap self-reports)."""
        with self._lock:
            out = [s for s in self._ring if s["seq"] > self._shipped]
            out = out[:int(limit)]
            if out:
                self._shipped = out[-1]["seq"]
            return out

    def pending_ship(self) -> int:
        with self._lock:
            return sum(1 for s in self._ring
                       if s["seq"] > self._shipped)

    def stats(self) -> dict:
        """Ring accounting without the spans (what every MgrReport
        carries so the monitor-side overflow tracker never scrapes
        ring internals)."""
        with self._lock:
            return {"recorded": self._seq,
                    "dropped": self._dropped,
                    "dropped_unshipped": self._dropped_unshipped,
                    "pending": sum(1 for s in self._ring
                                   if s["seq"] > self._shipped)}


# -- ambient context (what makes span() sites trace-aware) --------------------

_CUR: contextvars.ContextVar[TraceContext | None] = \
    contextvars.ContextVar("trace_ctx", default=None)
_REC: contextvars.ContextVar[FlightRecorder | None] = \
    contextvars.ContextVar("trace_rec", default=None)


def current() -> TraceContext | None:
    return _CUR.get()


def current_sampled() -> TraceContext | None:
    """The active context IFF it is sampled and a recorder is bound —
    the one-read fast path every span site checks."""
    ctx = _CUR.get()
    if ctx is not None and ctx.sampled and _REC.get() is not None:
        return ctx
    return None


@contextlib.contextmanager
def activate(ctx: TraceContext | None, recorder: FlightRecorder | None):
    """Install a decoded wire context + the executing daemon's
    recorder for the dynamic extent of op handling. None ctx = no-op
    (the op is untraced)."""
    if ctx is None or recorder is None:
        yield
        return
    t1 = _CUR.set(ctx)
    t2 = _REC.set(recorder)
    try:
        yield
    finally:
        _CUR.reset(t1)
        _REC.reset(t2)


@contextlib.contextmanager
def trace_span(name: str, **tags):
    """Record `name` as a span under the active SAMPLED context (else
    a no-op costing one contextvar read). The body runs under a child
    context so nested spans parent correctly. Sampled or not, the
    name's attribution category tags the executing thread for the r19
    CPU sampler (utils/profiler) — unsampled sub-ops still burn CPU,
    and the flame profile must see store/crypto time the trace plane
    skipped."""
    ctx = _CUR.get()
    if ctx is None or not ctx.sampled:
        tagged = _prof.push_span(name)
        try:
            yield None
        finally:
            if tagged:
                _prof.pop_span()
        return
    rec = _REC.get()
    if rec is None:
        tagged = _prof.push_span(name)
        try:
            yield None
        finally:
            if tagged:
                _prof.pop_span()
        return
    sid = new_trace_id()
    tok = _CUR.set(ctx.child(sid))
    tagged = _prof.push_span(name)
    t0w = time.time()
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        if tagged:
            _prof.pop_span()
        _CUR.reset(tok)
        rec.record(ctx.trace_id, sid, ctx.parent_span_id, name,
                   t0w, time.perf_counter() - t0, tags or None)
