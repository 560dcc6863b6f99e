"""Continuous CPU profiling — per-daemon wall-clock sampling with
span-tagged flame attribution (r19).

The counter (r9), trace (r15), and telemetry (r18) planes say *what*
is slow and *when*; this plane says *where the CPU goes*, all the
time, cheaply enough to leave on (the role of the reference's
external `perf`/eBPF continuous profilers, built in because a
TPU-host data path shares ONE core with the control plane and
"attach perf later" loses the moment).

Design:

* A dedicated SAMPLER THREAD wakes `daemon_profile_hz` times a second
  (live central config; 0 = off, the overhead-guard OFF arm) and
  snapshots every thread's Python stack via `sys._current_frames()` —
  wall-clock sampling, so a thread blocked INSIDE a span is visible
  (its samples pin the frame the op waits in). A thread blocked
  outside any span — Condition waits, selector polls, socket accepts:
  the service-loop park positions — is counted as `idle_samples` but
  NOT folded (the py-spy idle heuristic): a 40-thread daemon is >90%
  parked threads at any instant, and folding them buries the op-path
  flame under a constant "other" floor. In the shared-process
  standalone topology every daemon's sampler sees the whole process's
  threads (the host view — the per-daemon dumps overlap); with
  --osd-procs each daemon is its own process and the dumps are truly
  per-daemon.
* Each sample folds into a COLLAPSED STACK (root-first,
  ';'-separated `module:function` frames) under the executing
  thread's active SPAN CATEGORY — the same r15 taxonomy the trace
  critical-path uses (queue/crypto/encode/store/wire + "reactor" for
  messenger loop threads outside any span + "other"), so a flame
  profile and a `trace slow` attribution answer in the SAME units.
  The category comes from a per-thread stack maintained by the span
  instrumentation itself (utils/tracing.span + flight_recorder
  .trace_span push/pop here): a contextvar cannot be read from the
  sampler thread, a plain dict keyed by thread ident can — and
  because the SAME span sites feed it, the profiler's buckets cannot
  drift from the trace plane's.
* Cumulative stack counts tick into an interval-aligned DELTA RING
  (the r18 MetricsHistory shape: bucket = floor(t/interval) on the
  shared host clock, bounded by `daemon_profile_ring`, live config,
  drain_unshipped cursor for the MgrReport pipe) — the mon-side
  ProfileAggregator (mgr/profiles.py) aligns entries across daemons
  without negotiation, and merge is EXACT integer addition.
* The sampler accounts for ITSELF: wall seconds spent inside the
  sampling loop ship with every dump/entry (`busy_s`), so the bench
  `profile` blocks can report sampler overhead instead of asserting
  it away.

Samples are COUNTS of an unbiased wall-clock sampler: category
self-time shares are sample shares. At the default hz on a loaded
1-core box this is trustworthy where timers are not — see
docs/BENCH_METHODOLOGY.md Round-19.
"""

from __future__ import annotations

import sys
import threading
import time

from .perf_counters import dump_delta, fold_delta

__all__ = ["SamplingProfiler", "PROFILE_CATEGORIES", "push_span",
           "pop_span", "category_of", "merge_stacks", "category_split",
           "top_stacks", "collapsed_lines", "speedscope",
           "profile_block"]

#: the r15 critical-path taxonomy (mgr/tracing.CATEGORIES) plus
#: "reactor" — messenger epoll threads sampled outside any span.
#: "wire" stays declared for schema parity with the trace plane even
#: though a CPU sampler attributes no samples to serialization gaps.
PROFILE_CATEGORIES = ("queue", "crypto", "encode", "store", "wire",
                      "reactor", "other")

# -- span-category tagging (fed by the span instrumentation) --------------

#: thread ident -> stack of active span categories. List append/pop
#: and dict get are GIL-atomic; the sampler thread reads tolerantly
#: (a torn read misattributes ONE sample, never crashes).
_SPAN_CATS: dict[int, list[str]] = {}

#: count of SamplingProfilers currently sampling (hz > 0). When zero,
#: push_span is a single int compare — spans stay near-free with the
#: profiler off, like compiled-out tracepoints.
_ACTIVE = 0

_CAT_CACHE: dict[str, str] = {}

#: innermost-frame function names that mean BLOCKED, not on-CPU —
#: Condition/Event waits, selector polls, socket accepts/reads, lock
#: acquires, thread joins (the py-spy idle heuristic). A thread
#: sampled here OUTSIDE any span is parked in a service loop; folding
#: it would drown the op-path signal under a constant "other" floor
#: (an idle 40-thread daemon would be 90%+ waits). Blocked INSIDE a
#: span still folds — where an op waits is exactly what wall-clock
#: span attribution is for.
_IDLE_FUNCS = frozenset({
    "wait", "select", "poll", "accept", "sleep", "join",
    "acquire", "recv", "recv_into", "recvfrom", "read", "readline",
    "readinto", "get", "epoll",
})


def category_of(name: str) -> str:
    """Span name -> attribution category, from the SAME map the trace
    critical-path uses (mgr/tracing.CATEGORY_OF; lazy import keeps
    utils free of an mgr dependency at import time). Unknown names
    are "other" — accounted, never dropped."""
    cat = _CAT_CACHE.get(name)
    if cat is None:
        from ..mgr.tracing import CATEGORY_OF
        cat = CATEGORY_OF.get(name, "other")
        _CAT_CACHE[name] = cat
    return cat


def push_span(name: str) -> bool:
    """Mark `name`'s category active on the calling thread. Returns
    whether a pop is owed (False when no profiler samples — the
    caller must only pop what it pushed, since _ACTIVE can flip
    mid-span)."""
    if not _ACTIVE:
        return False
    tid = threading.get_ident()
    st = _SPAN_CATS.get(tid)
    if st is None:
        st = _SPAN_CATS[tid] = []
    st.append(category_of(name))
    return True


def pop_span() -> None:
    tid = threading.get_ident()
    st = _SPAN_CATS.get(tid)
    if st:
        st.pop()
        if not st:
            _SPAN_CATS.pop(tid, None)


# -- the sampler ----------------------------------------------------------

class SamplingProfiler:
    """Per-daemon wall-clock sampling profiler.

    start() spawns the sampler thread; it idles (one config read per
    poll) while `daemon_profile_hz` is 0 and samples at the live hz
    otherwise — an hz=0 daemon records NOTHING (the off-switch
    invariant tests pin). Cumulative folded stacks are read with
    dump(); maybe_tick()/tick() close interval-aligned delta entries
    into the ring the MgrReport pipe drains (drain_unshipped)."""

    #: frames deeper than this fold into a "..." root — bounds both
    #: sample cost and stack-key cardinality
    MAX_DEPTH = 48

    def __init__(self, name: str, config=None, hz: float = 0.0,
                 ring: int = 64, interval: float = 10.0,
                 now_fn=time.time):
        self.name = name
        self._config = config
        self._hz = float(hz)
        self._ring_len = int(ring)
        self._interval = float(interval)
        self._now = now_fn
        self._lock = threading.Lock()
        # cumulative: category -> collapsed stack -> samples
        self._stacks: dict[str, dict[str, int]] = {}
        self._samples = 0
        self._idle = 0               # blocked-outside-span samples
        self._busy_s = 0.0           # sampler self-time (overhead)
        self._started_at = now_fn()
        # interval ring (MetricsHistory shape)
        self._prev: dict | None = None
        self._prev_t = 0.0
        self._prev_meta = (0, 0.0)   # (samples, busy_s) at snapshot
        self._ring: list[dict] = []
        self._seq = 0
        self._shipped = 0
        self._dropped_unshipped = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._was_on = False

    # -- live config -------------------------------------------------------

    def _opt(self, name: str, fallback):
        if self._config is not None:
            try:
                return self._config.get(name)
            except (KeyError, ValueError, TypeError):
                pass
        return fallback

    @property
    def hz(self) -> float:
        return float(self._opt("daemon_profile_hz", self._hz))

    @property
    def ring_len(self) -> int:
        return int(self._opt("daemon_profile_ring", self._ring_len))

    @property
    def interval(self) -> float:
        return float(self._opt("mgr_history_interval", self._interval))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SamplingProfiler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"profiler-{self.name}")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
        self._set_active(False)

    def _set_active(self, on: bool) -> None:
        global _ACTIVE
        if on and not self._was_on:
            _ACTIVE += 1
            self._was_on = True
        elif not on and self._was_on:
            _ACTIVE -= 1
            self._was_on = False

    def _run(self) -> None:
        my_tid = threading.get_ident()
        while not self._stop.is_set():
            hz = self.hz
            if hz <= 0:
                self._set_active(False)
                self._stop.wait(0.2)   # off: poll the live option
                continue
            self._set_active(True)
            t0 = time.perf_counter()
            try:
                self.sample_once(skip_tids=(my_tid,))
            except Exception:   # noqa: BLE001 — sampling must never
                pass            # kill its own thread
            busy = time.perf_counter() - t0
            with self._lock:
                self._busy_s += busy
            self._stop.wait(max(0.0, 1.0 / hz - busy))

    # -- sampling ----------------------------------------------------------

    def sample_once(self, skip_tids=()) -> int:
        """Take ONE sample of every live thread (tests drive this
        directly for determinism). Returns threads sampled."""
        # thread ident -> name, for the reactor classification of
        # threads outside any span (msgr epoll loops burn CPU in
        # select/dispatch that belongs to no op)
        names = {t.ident: t.name for t in threading.enumerate()}
        n = 0
        for tid, frame in sys._current_frames().items():
            if tid in skip_tids:
                continue
            st = _SPAN_CATS.get(tid)
            if st:
                cat = st[-1]
            else:
                if frame.f_code.co_name in _IDLE_FUNCS:
                    # blocked in a service loop, no span: parked, not
                    # burning CPU — accounted, never folded
                    with self._lock:
                        self._idle += 1
                    continue
                cat = "reactor" if "msgr" in (names.get(tid) or "") \
                    else "other"
            stack = self._collapse(frame)
            with self._lock:
                bucket = self._stacks.setdefault(cat, {})
                bucket[stack] = bucket.get(stack, 0) + 1
                self._samples += 1
            n += 1
        return n

    #: code object -> "module:function" label. Keyed by the code
    #: object itself (bounded by the program's code size; strong refs
    #: keep ids stable) — the per-frame string formatting was the
    #: sampler's hottest line, and a daemon's threads re-sample the
    #: same few hundred frames forever
    _LABELS: dict = {}

    @staticmethod
    def _collapse(frame) -> str:
        """Root-first ';'-joined `module:function` frames (classic
        folded-stack text, the flamegraph.pl / speedscope input
        grain). Line numbers are deliberately dropped: they explode
        key cardinality without changing attribution."""
        labels = SamplingProfiler._LABELS
        parts: list[str] = []
        depth = 0
        while frame is not None and depth < SamplingProfiler.MAX_DEPTH:
            co = frame.f_code
            label = labels.get(co)
            if label is None:
                fn = co.co_filename
                mod = fn[fn.rfind("/") + 1:]
                if mod.endswith(".py"):
                    mod = mod[:-3]
                label = labels[co] = f"{mod}:{co.co_name}"
            parts.append(label)
            frame = frame.f_back
            depth += 1
        if frame is not None:
            parts.append("...")
        parts.reverse()
        return ";".join(parts)

    # -- views -------------------------------------------------------------

    def dump(self) -> dict:
        """Cumulative profile since boot (the asok `profile` body and
        the bench fold input)."""
        with self._lock:
            stacks = {c: dict(s) for c, s in self._stacks.items()}
            samples, idle, busy = (self._samples, self._idle,
                                   self._busy_s)
        return {
            "name": self.name,
            "hz": self.hz,
            "samples": samples,
            "idle_samples": idle,
            "stacks": stacks,
            "sampler_busy_s": round(busy, 6),
            "uptime_s": round(self._now() - self._started_at, 3),
        }

    def stats(self) -> dict:
        """The per-report accounting line (rides MgrReports next to
        the flight ring's): total samples + ring overflow."""
        with self._lock:
            return {"samples": self._samples,
                    "idle_samples": self._idle,
                    "hz": self.hz,
                    "sampler_busy_s": round(self._busy_s, 6),
                    "dropped_unshipped": self._dropped_unshipped}

    # -- the interval ring (r18 MetricsHistory shape) ----------------------

    def maybe_tick(self) -> bool:
        """Close an entry iff the wall-clock interval bucket rolled
        (cheap when idle: one clock read + one divide)."""
        iv = self.interval
        if iv <= 0:
            return False
        now = self._now()
        if self._prev is not None and int(now / iv) \
                == int(self._prev_t / iv):
            return False
        return self.tick(now)

    def tick(self, now: float | None = None) -> bool:
        """Force one delta entry (benches close the final partial
        interval deterministically)."""
        iv = self.interval if self.interval > 0 else self._interval
        now = self._now() if now is None else now
        with self._lock:
            cur = {c: dict(s) for c, s in self._stacks.items()}
            meta = (self._samples, self._busy_s)
            prev, prev_t = self._prev, self._prev_t
            prev_meta = self._prev_meta
            self._prev, self._prev_t = cur, now
            self._prev_meta = meta
            if prev is None:
                return False         # baseline snapshot, no delta yet
            self._seq += 1
            self._ring.append({
                "seq": self._seq,
                "t": round(now, 3),
                "bucket": int(now / iv),
                "interval_s": round(now - prev_t, 3),
                "hz": self.hz,
                "samples": meta[0] - prev_meta[0],
                "busy_s": round(meta[1] - prev_meta[1], 6),
                "stacks": _prune(dump_delta(prev, cur)),
            })
            over = len(self._ring) - self.ring_len
            if over > 0:
                self._dropped_unshipped += sum(
                    1 for e in self._ring[:over]
                    if e["seq"] > self._shipped)
                del self._ring[:over]
        return True

    def drain_unshipped(self, limit: int = 8) -> list[dict]:
        """Entries recorded since the last drain — what one MgrReport
        ships (normally 0-1; bounded for report size)."""
        with self._lock:
            out = [e for e in self._ring if e["seq"] > self._shipped]
            out = out[:int(limit)]
            if out:
                self._shipped = out[-1]["seq"]
            return out


def _prune(stacks: dict) -> dict:
    """Drop zero-count stacks from a delta (an interval that never
    sampled a stack again would otherwise ship it forever)."""
    return {cat: kept
            for cat, bucket in stacks.items()
            if (kept := {s: n for s, n in bucket.items() if n})}


# -- pure merge/render helpers (daemon, monitor, benches, diff tool) ------

def merge_stacks(blocks) -> dict[str, dict[str, int]]:
    """Element-wise integer fold of {category: {stack: n}} blocks —
    merge of merges == merge of all, BIT-EXACTLY (the r18 rule the
    merge tests pin)."""
    out: dict = {}
    for b in blocks:
        if b:
            out = fold_delta(out, b)
    return out


def category_split(stacks: dict) -> dict[str, int]:
    """Samples per category, every declared category present."""
    out = {c: 0 for c in PROFILE_CATEGORIES}
    for cat, bucket in (stacks or {}).items():
        out[cat] = out.get(cat, 0) + sum(bucket.values())
    return out


def top_stacks(stacks: dict, n: int = 10) -> list[dict]:
    """The heaviest collapsed stacks across categories (ties broken
    lexically so the view is deterministic)."""
    rows = [(cnt, cat, stk)
            for cat, bucket in (stacks or {}).items()
            for stk, cnt in bucket.items()]
    rows.sort(key=lambda r: (-r[0], r[1], r[2]))
    return [{"category": cat, "stack": stk, "samples": cnt}
            for cnt, cat, stk in rows[:n]]


def collapsed_lines(stacks: dict) -> list[str]:
    """Folded-stack text (`cat;frame;frame count` per line, sorted) —
    flamegraph.pl / speedscope "import collapsed" input."""
    out = []
    for cat in sorted(stacks or {}):
        for stk in sorted(stacks[cat]):
            out.append(f"{cat};{stk} {stacks[cat][stk]}")
    return out


def speedscope(stacks: dict, name: str = "cpu") -> dict:
    """A valid speedscope JSON document (sampled profile; weights are
    sample counts) from one merged {category: {stack: n}} block."""
    frames: list[dict] = []
    index: dict[str, int] = {}

    def fidx(fname: str) -> int:
        i = index.get(fname)
        if i is None:
            i = index[fname] = len(frames)
            frames.append({"name": fname})
        return i

    samples, weights = [], []
    for cat in sorted(stacks or {}):
        for stk in sorted(stacks[cat]):
            samples.append([fidx(cat)]
                           + [fidx(f) for f in stk.split(";")])
            weights.append(stacks[cat][stk])
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled",
            "name": name,
            "unit": "none",
            "startValue": 0,
            "endValue": total,
            "samples": samples,
            "weights": weights,
        }],
        "name": name,
        "activeProfileIndex": 0,
        "exporter": "ceph_tpu-r19",
    }


def profile_block(dumps, top_n: int = 10) -> dict:
    """The bench `profile` block (schema pinned by
    tests/test_bench_schema.py): fold per-daemon cumulative dumps
    into top-N stacks + the category self-time split + sampler
    overhead accounting."""
    dumps = [d for d in dumps if d]
    merged = merge_stacks(d.get("stacks") for d in dumps)
    samples = sum(int(d.get("samples", 0)) for d in dumps)
    idle = sum(int(d.get("idle_samples", 0)) for d in dumps)
    busy = sum(float(d.get("sampler_busy_s", 0.0)) for d in dumps)
    wall = sum(float(d.get("uptime_s", 0.0)) for d in dumps)
    split = category_split(merged)
    return {
        "daemons": sorted(d.get("name", "?") for d in dumps),
        "hz": max((float(d.get("hz", 0.0)) for d in dumps),
                  default=0.0),
        "samples": samples,
        "idle_samples": idle,
        "categories": split,
        "category_share": {
            c: round(v / samples, 4) if samples else 0.0
            for c, v in split.items()},
        "top_stacks": top_stacks(merged, n=top_n),
        "sampler_overhead": {
            "busy_s": round(busy, 6),
            # busy per daemon-second of wall time: the overhead the
            # ON/OFF guard bounds end to end
            "busy_share": round(busy / wall, 6) if wall > 0 else 0.0,
        },
    }
