"""Trace assembly — stitch per-daemon flight rings into causal
timelines with critical-path attribution.

The mgr half of the r15 distributed-tracing plane (the role of a
Jaeger collector against the reference's tracer spans): daemons drain
their flight-recorder rings into MgrReports (standalone.py ships a
bounded `spans` list per report; clients flush theirs after op
rounds), every monitor ingests them into a bounded per-trace store,
and `ceph_cli trace <id> / slow / list` renders one ASSEMBLED view —
spans ordered causally across daemons, a queue/crypto/encode/store/
wire attribution summary, and Chrome trace-event JSON for
chrome://tracing / Perfetto.

Gap semantics (disclosed; ARCHITECTURE "Distributed tracing (r15)",
updated r18): spans arrive best-effort — a ring may evict before
shipping, an unsampled hop records nothing. The assembler never
interpolates: time inside the root not covered by any recorded span
is reported as `wire` — which since r18 means WIRE SERIALIZATION plus
untraced host work only: retro traces now cover replica hops too
(sub-op service windows published from the daemons' retro rings as
retro.subop / retro.store.apply spans under the deterministic retro
root), so replica store time no longer masquerades as wire. A trace
whose root never arrived is summarized over its longest span instead.
Wall-clock ordering across daemons leans on the single-host shared
clock.

r18 additionally folds sampled traces into CONTINUOUS critical-path
profiles: per wall-clock interval, the summed per-category self time
across every trace whose root started in that interval — attribution
drift (queue share creeping up, store share exploding after a device
change) becomes a first-class time-series instead of a one-off
`trace <id>` (the 1709.05365 bottleneck-migration lesson). Evicted
traces fold into the profile PERMANENTLY before leaving the LRU, so
the profile's horizon outlives the trace store's.
"""

from __future__ import annotations

import threading

__all__ = ["TraceAssembler", "critical_path", "chrome_trace_events",
           "CATEGORY_OF"]

#: span name -> attribution category. Names not listed fall into
#: "other" (their self-time is still accounted, never silently
#: dropped). The retro.* family maps the OpTracker stage marks onto
#: the same buckets: initiated->reached_pg is queue+dispatch wait,
#: reached_pg->commit_sent is the execute window (encode + store
#: fan-out, indistinguishable retroactively).
CATEGORY_OF = {
    "osd.queue": "queue",
    "rpc.window": "queue",
    "msgr.seal": "crypto",
    "msgr.open": "crypto",
    "ecbackend.write.encode": "encode",
    "ecbackend.read.decode": "encode",
    "ecbackend.recover.stage": "encode",
    "ecbackend.recover.launch": "encode",
    "ecbackend.recover.fetch": "encode",
    "ecbackend.recover.batch": "encode",
    "ecbackend.recover.writeback": "store",
    "store.apply": "store",
    "osd.subop": "store",
    "retro.reached_pg": "queue",
    "retro.commit_sent": "other",
    "retro.done": "other",
    # r18: replica-published retro sub-op spans (the subop retro ring)
    "retro.subop": "store",
    "retro.store.apply": "store",
}

#: every summary carries exactly these keys (schema-pinned by
#: tests/test_bench_schema.py for the bench "trace" block)
CATEGORIES = ("queue", "crypto", "encode", "store", "wire", "other")


def _union_len(intervals: list[tuple[float, float]],
               lo: float, hi: float) -> float:
    """Total length of the union of [start, end) intervals clipped to
    [lo, hi] — robust to overlap from concurrent children (parallel
    sub-op fan-out, hedged duplicates)."""
    clipped = sorted((max(lo, s), min(hi, e)) for s, e in intervals
                     if e > lo and s < hi)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in clipped:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _iv(span: dict) -> tuple[float, float]:
    return (span["start"], span["start"] + span["dur"])


def critical_path(spans: list[dict]) -> dict:
    """Attribution summary over one trace's spans.

    Per-span SELF time = duration minus the union of its direct
    children's intervals (concurrent children never double-subtract);
    self times sum into categories by span name. `wire` = root
    duration minus the union of every NON-root span's interval inside
    the root — the time the op spent between recorded hops (wire
    serialization + any untraced host work; see module docstring)."""
    out = {c: 0.0 for c in CATEGORIES}
    out["total"] = 0.0
    if not spans:
        return {k: round(v, 6) for k, v in out.items()}
    by_id = {s["span_id"]: s for s in spans}
    kids: dict[str, list[dict]] = {}
    roots = []
    for s in spans:
        if s["parent_id"] in by_id:
            kids.setdefault(s["parent_id"], []).append(s)
        else:
            roots.append(s)
    # the root: prefer a client-origin span, else the longest orphan
    root = max(roots or spans,
               key=lambda s: (s["name"].startswith("client."),
                              s["name"] == "retro.op", s["dur"]))
    r_lo, r_hi = _iv(root)
    out["total"] = root["dur"]
    for s in spans:
        if s is root:
            continue
        lo, hi = _iv(s)
        child_ivs = [_iv(c) for c in kids.get(s["span_id"], ())]
        self_t = max(0.0, s["dur"] - _union_len(child_ivs, lo, hi))
        out[CATEGORY_OF.get(s["name"], "other")] += self_t
    covered = _union_len([_iv(s) for s in spans if s is not root],
                         r_lo, r_hi)
    out["wire"] = max(0.0, root["dur"] - covered)
    return {k: round(v, 6) for k, v in out.items()}


def chrome_trace_events(spans: list[dict]) -> list[dict]:
    """Chrome trace-event JSON (the `traceEvents` list): one complete
    "X" event per span, daemons as processes (named via "M" metadata
    events), timestamps in microseconds."""
    daemons = sorted({s["daemon"] for s in spans})
    pid_of = {d: i + 1 for i, d in enumerate(daemons)}
    events = [{"name": "process_name", "ph": "M", "pid": pid_of[d],
               "tid": 0, "args": {"name": d}} for d in daemons]
    for s in sorted(spans, key=lambda s: s["start"]):
        ev = {
            "name": s["name"], "ph": "X", "cat": "ceph_tpu",
            "pid": pid_of[s["daemon"]], "tid": 0,
            "ts": round(s["start"] * 1e6, 3),
            "dur": round(s["dur"] * 1e6, 3),
            "args": {"trace_id": s["trace_id"],
                     "span_id": s["span_id"],
                     "parent_id": s["parent_id"],
                     **(s.get("tags") or {})},
        }
        events.append(ev)
    return events


class TraceAssembler:
    """Bounded per-trace span store + assembled views (one instance
    per monitor, fed from the MgrReport pipe; also used standalone by
    the benches to assemble in-process rings)."""

    def __init__(self, max_traces: int = 512,
                 max_spans_per_trace: int = 4096,
                 config=None, profile_interval: float = 10.0,
                 max_profile_intervals: int = 256):
        self._max_traces = int(max_traces)
        self._max_spans = int(max_spans_per_trace)
        #: trace_id(hex) -> {"spans": [..], "stamp": monotone counter}
        self._traces: dict[str, dict] = {}
        self._tick = 0
        self._lock = threading.Lock()
        # r18 continuous critical-path profile: interval bucket ->
        # settled per-category self-time sums (traces fold here
        # PERMANENTLY on LRU eviction; live traces fold on demand in
        # profile()). Interval tracks mgr_history_interval when a
        # config is given so the profile series aligns with the
        # telemetry plane's metric series.
        self._config = config
        self._profile_interval = float(profile_interval)
        self._max_profile = int(max_profile_intervals)
        self._settled: dict[int, dict] = {}

    def ingest(self, spans: list[dict]) -> None:
        """Fold a daemon's drained spans (dicts in FlightRecorder
        shape). Dedup by (daemon, span_id) so re-shipped spans fold
        idempotently; LRU-evict whole traces past the cap."""
        with self._lock:
            self._tick += 1
            for s in spans:
                if not isinstance(s, dict) or "trace_id" not in s:
                    continue
                ent = self._traces.get(s["trace_id"])
                if ent is None:
                    ent = self._traces[s["trace_id"]] = {
                        "spans": [], "seen": set(), "stamp": 0}
                key = (s.get("daemon"), s.get("span_id"))
                if key in ent["seen"] \
                        or len(ent["spans"]) >= self._max_spans:
                    continue
                ent["seen"].add(key)
                ent["spans"].append(dict(s))
                ent["stamp"] = self._tick
            over = len(self._traces) - self._max_traces
            if over > 0:
                for tid in sorted(self._traces,
                                  key=lambda t:
                                  self._traces[t]["stamp"])[:over]:
                    # settle the evicted trace into the continuous
                    # profile first — the rollup's horizon must
                    # outlive the LRU
                    self._settle_profile_locked(
                        self._traces[tid]["spans"])
                    del self._traces[tid]

    # -- continuous critical-path profile (r18) -------------------------------

    def _iv(self) -> float:
        if self._config is not None:
            try:
                iv = float(self._config.get("mgr_history_interval"))
                if iv > 0:
                    return iv
            except (KeyError, TypeError, ValueError):
                pass
        return self._profile_interval

    def _settle_profile_locked(self, spans: list[dict]) -> None:
        if not spans:
            return
        cp = critical_path(spans)
        bucket = int(min(s["start"] for s in spans) / self._iv())
        row = self._settled.setdefault(
            bucket, {c: 0.0 for c in CATEGORIES}
            | {"total": 0.0, "traces": 0})
        for c in CATEGORIES:
            row[c] += cp.get(c, 0.0)
        row["total"] += cp.get("total", 0.0)
        row["traces"] += 1
        over = len(self._settled) - self._max_profile
        if over > 0:
            for b in sorted(self._settled)[:over]:
                del self._settled[b]

    def profile(self, limit: int = 32) -> dict:
        """Per-interval critical-path attribution series (the
        `profile` mon command / `ceph_cli profile` body): settled
        (evicted) traces + an on-demand fold of every trace still in
        the store. Shares are per-category self time over the
        interval's summed root time — the drift signal."""
        iv = self._iv()
        with self._lock:
            rows = {b: dict(r) for b, r in self._settled.items()}
            live = [list(e["spans"]) for e in self._traces.values()]
        for spans in live:
            if not spans:
                continue
            cp = critical_path(spans)
            bucket = int(min(s["start"] for s in spans) / iv)
            row = rows.setdefault(
                bucket, {c: 0.0 for c in CATEGORIES}
                | {"total": 0.0, "traces": 0})
            for c in CATEGORIES:
                row[c] += cp.get(c, 0.0)
            row["total"] += cp.get("total", 0.0)
            row["traces"] += 1
        out = []
        for b in sorted(rows)[-int(limit):]:
            row = rows[b]
            total = row["total"] or 1e-12
            out.append({
                "bucket": b,
                "t": round(b * iv, 3),
                "traces": row["traces"],
                "self_s": {c: round(row[c], 6) for c in CATEGORIES},
                "total_s": round(row["total"], 6),
                "share": {c: round(row[c] / total, 4)
                          for c in CATEGORIES},
            })
        return {"interval_s": iv, "intervals": out}

    # -- views ----------------------------------------------------------------

    def _spans(self, trace_id: str) -> list[dict]:
        tid = str(trace_id).lower().removeprefix("0x").rjust(16, "0")
        with self._lock:
            ent = self._traces.get(tid)
            return [dict(s) for s in ent["spans"]] if ent else []

    def _summary_locked(self, tid: str) -> dict:
        spans = self._traces[tid]["spans"]
        daemons = sorted({s["daemon"] for s in spans})
        root_dur = max((s["dur"] for s in spans), default=0.0)
        return {"trace_id": tid, "spans": len(spans),
                "daemons": daemons, "duration_s": round(root_dur, 6)}

    def list_traces(self) -> list[dict]:
        with self._lock:
            return sorted((self._summary_locked(t)
                           for t in self._traces),
                          key=lambda e: -e["duration_s"])

    def slow(self, threshold_s: float = 0.0, limit: int = 16) -> list[dict]:
        """Traces ordered slowest-first (the `trace slow` view), with
        their attribution summaries — the cross-daemon complement of
        the per-daemon slow_ops dump."""
        out = []
        for ent in self.list_traces():
            if ent["duration_s"] < threshold_s:
                continue
            spans = self._spans(ent["trace_id"])
            out.append({**ent, "critical_path": critical_path(spans)})
            if len(out) >= limit:
                break
        return out

    def assemble(self, trace_id: str) -> dict:
        """One trace, fully assembled: causally ordered spans, the
        critical-path summary, and Chrome trace-event JSON."""
        spans = self._spans(trace_id)
        spans.sort(key=lambda s: (s["start"], -s["dur"]))
        return {
            "trace_id": str(trace_id).lower().removeprefix("0x")
            .rjust(16, "0"),
            "found": bool(spans),
            "daemons": sorted({s["daemon"] for s in spans}),
            "critical_path": critical_path(spans),
            "spans": spans,
            "chrome": {"traceEvents": chrome_trace_events(spans)},
        }
