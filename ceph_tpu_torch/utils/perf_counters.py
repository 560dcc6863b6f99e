"""PerfCounters — metrics registry.

Rebuild of the reference's counter subsystem (ref:
src/common/perf_counters.{h,cc} — PerfCountersBuilder::add_u64_counter/
add_u64/add_time_avg, PerfCounters::{inc,dec,set,tinc},
PerfCountersCollection dumped over the admin socket as
`perf dump` / scraped by the mgr prometheus module).

Counter kinds:
  * counter   — monotonically increasing u64 (inc)
  * gauge     — settable value (set/inc/dec)
  * time_avg  — (sum_seconds, count) pair; tinc(seconds) adds a sample,
                dump reports sum + count + avg (latency counters)
  * histogram — fixed power-of-two-bucket latency/size histogram
  * lhist     — log2-bucketed LATENCY histogram (r18): bucket i counts
                samples in [2^i, 2^(i+1)) microseconds, fixed
                LHIST_BUCKETS slots covering ~1 µs .. >4000 s. The
                t-digest-lite of the telemetry plane: snapshots merge
                EXACTLY by element-wise bucket addition (dump_delta /
                fold_delta already do this), so a cluster-wide p99 is
                computable from per-daemon dumps with zero loss
                relative to any single merged collector. Declared via
                add_time_avg(..., hist=True): the paired `<key>_hist`
                lhist is fed by the SAME tinc() call, so histogram
                sites can never drift from the time_avg sites.
"""

from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass, field

#: lhist geometry: bucket i holds samples in [2^i, 2^(i+1)) µs.
#: 40 slots span 1 µs .. 2^40 µs (~12.7 days) — every latency this
#: harness can produce lands in a real bucket, the last slot is the
#: overflow clamp. Fixed across the cluster so merge = bucket add.
LHIST_BUCKETS = 40


def lhist_bucket(seconds: float) -> int:
    """Bucket index for one latency sample (µs log2, clamped)."""
    us = seconds * 1e6
    if us < 2.0:
        return 0
    return min(LHIST_BUCKETS - 1, int(us).bit_length() - 1)


def lhist_bucket_le(i: int) -> float:
    """Upper bound of bucket i in SECONDS (the prometheus `le`)."""
    return (1 << (i + 1)) / 1e6


def lhist_quantile(hist: dict, q: float) -> float:
    """Quantile estimate in SECONDS from one lhist dump
    ({"buckets", "sum", "count"}): find the bucket holding the q-th
    sample, interpolate GEOMETRICALLY inside it (log-uniform
    assumption matches the log2 bucketing). Deterministic: the same
    buckets always give the same estimate, so a cluster-merged
    quantile is bit-exactly reproducible from the per-daemon merge."""
    buckets = hist.get("buckets") or []
    total = sum(buckets)
    if total <= 0:
        return 0.0
    rank = q * total
    seen = 0.0
    for i, b in enumerate(buckets):
        if b <= 0:
            continue
        if seen + b >= rank:
            frac = min(1.0, max(0.0, (rank - seen) / b))
            lo_us = float(1 << i) if i else 1.0
            hi_us = float(1 << (i + 1))
            return lo_us * math.pow(hi_us / lo_us, frac) / 1e6
        seen += b
    return lhist_bucket_le(len(buckets) - 1)


def lhist_merge(*hists: dict) -> dict:
    """Exact merge of lhist dumps: element-wise bucket add + sum/count
    add. The merge the mon-side telemetry aggregation runs — and the
    one the bit-exactness test replays by hand."""
    out = {"buckets": [0] * LHIST_BUCKETS, "sum": 0.0, "count": 0}
    for h in hists:
        if not h:
            continue
        for i, b in enumerate(h.get("buckets") or []):
            if i < LHIST_BUCKETS:
                out["buckets"][i] += b
        out["sum"] += h.get("sum", 0.0)
        out["count"] += h.get("count", 0)
    return out


def lhist_quantiles(hist: dict,
                    qs: tuple = (0.5, 0.95, 0.99)) -> dict:
    out = {f"p{round(q * 100)}_ms":
           round(lhist_quantile(hist, q) * 1e3, 3) for q in qs}
    out["count"] = int(hist.get("count", 0) if hist else 0)
    return out


#: process-wide kill switch for lhist feeding (the r18 overhead-guard
#: OFF arm: benches flip it to measure the histograms' cost against
#: the same binary; tinc() itself — the time_avg — is unaffected)
LHIST_ENABLED = True


@dataclass
class _Counter:
    kind: str
    description: str = ""
    value: float = 0
    sum_s: float = 0.0
    count: int = 0
    buckets: list[int] = field(default_factory=list)


#: every (logger name, key) ever declared through PerfCountersBuilder —
#: the reference's "counters exist only if declared in a schema"
#: property, checkable from the outside: a dump/exposition emitting a
#: name absent here was assembled by hand (dynamic/typo'd counter
#: names, the failure mode the smoke test hunts).
declared_counters: dict[str, set] = {}
_declared_lock = threading.Lock()


def is_declared(logger: str, key: str) -> bool:
    with _declared_lock:
        return key in declared_counters.get(logger, ())


class PerfCountersBuilder:
    """Declare-then-freeze, like the reference's builder."""

    def __init__(self, name: str):
        self.name = name
        self._counters: dict[str, _Counter] = {}

    def _declare(self, key: str, counter: _Counter):
        self._counters[key] = counter
        with _declared_lock:
            declared_counters.setdefault(self.name, set()).add(key)
        return self

    def add_u64_counter(self, key: str, description: str = ""):
        return self._declare(key, _Counter("counter", description))

    def add_u64(self, key: str, description: str = ""):
        return self._declare(key, _Counter("gauge", description))

    def add_time_avg(self, key: str, description: str = "",
                     hist: bool = False):
        """hist=True additionally declares `<key>_hist`, a mergeable
        log2 latency histogram fed by the SAME tinc() call — the r18
        one-flag wiring for the hot sites that already carry a
        time_avg (op/subop latency, encode/decode, msgr seal)."""
        self._declare(key, _Counter("time_avg", description))
        if hist:
            self.add_latency_histogram(f"{key}_hist",
                                       description and
                                       f"{description} (log2 µs "
                                       f"buckets, merge = bucket add)")
        return self

    def add_latency_histogram(self, key: str, description: str = ""):
        return self._declare(key, _Counter("lhist", description,
                                           buckets=[0] * LHIST_BUCKETS))

    def add_histogram(self, key: str, description: str = "",
                      n_buckets: int = 32):
        return self._declare(key, _Counter("histogram", description,
                                           buckets=[0] * n_buckets))

    def create_perf_counters(self) -> "PerfCounters":
        return PerfCounters(self.name, self._counters)


class PerfCounters:
    def __init__(self, name: str, counters: dict[str, _Counter]):
        self.name = name
        self._c = counters
        self._lock = threading.Lock()

    def _get(self, key: str, kinds: tuple[str, ...]) -> _Counter:
        c = self._c[key]
        if c.kind not in kinds:
            raise TypeError(f"{self.name}.{key} is {c.kind}, not {kinds}")
        return c

    def inc(self, key: str, by: float = 1) -> None:
        with self._lock:
            self._get(key, ("counter", "gauge")).value += by

    def inc_many(self, pairs) -> None:
        """Batch inc: one lock acquisition for a hot path that bumps
        several counters per event (the msgr frame path)."""
        with self._lock:
            for key, by in pairs:
                self._get(key, ("counter", "gauge")).value += by

    def dec(self, key: str, by: float = 1) -> None:
        with self._lock:
            self._get(key, ("gauge",)).value -= by

    def set(self, key: str, value: float) -> None:
        with self._lock:
            self._get(key, ("gauge",)).value = value

    def tinc(self, key: str, seconds: float) -> None:
        with self._lock:
            c = self._get(key, ("time_avg",))
            c.sum_s += seconds
            c.count += 1
            # paired lhist (declared via add_time_avg(hist=True)):
            # fed inside the SAME lock acquisition — one dict probe +
            # one bit_length when present, nothing when not
            h = self._c.get(key + "_hist")
            if h is not None and LHIST_ENABLED:
                h.buckets[lhist_bucket(seconds)] += 1
                h.sum_s += seconds
                h.count += 1

    def linc(self, key: str, seconds: float) -> None:
        """One latency sample straight into a standalone lhist."""
        if not LHIST_ENABLED:
            return
        with self._lock:
            c = self._get(key, ("lhist",))
            c.buckets[lhist_bucket(seconds)] += 1
            c.sum_s += seconds
            c.count += 1

    def hinc(self, key: str, value: float) -> None:
        """Histogram sample: bucket = floor(log2(value)) clamped."""
        with self._lock:
            c = self._get(key, ("histogram",))
            b = max(0, min(len(c.buckets) - 1,
                           int(value).bit_length() - 1 if value >= 1 else 0))
            c.buckets[b] += 1
            c.sum_s += value  # powers the prometheus _sum series

    def get(self, key: str):
        with self._lock:
            c = self._c[key]
            if c.kind == "time_avg":
                return {"sum": c.sum_s, "count": c.count,
                        "avg": c.sum_s / c.count if c.count else 0.0}
            if c.kind == "lhist":
                return {"buckets": list(c.buckets),
                        "sum": c.sum_s, "count": c.count}
            if c.kind == "histogram":
                return list(c.buckets)
            return c.value

    def time(self, key: str):
        """Context manager feeding a time_avg counter."""
        counters = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                counters.tinc(key, time.perf_counter() - self.t0)
                return False

        return _Timer()

    def dump(self) -> dict:
        out = {}
        with self._lock:
            for key, c in self._c.items():
                if c.kind == "time_avg":
                    out[key] = {"avgcount": c.count, "sum": round(c.sum_s, 9)}
                elif c.kind == "lhist":
                    # dict-of-list shape folds EXACTLY through
                    # dump_delta/fold_delta (buckets element-wise,
                    # sum/count numeric) — what makes per-interval
                    # history deltas and cluster merges lossless
                    out[key] = {"buckets": list(c.buckets),
                                "sum": round(c.sum_s, 9),
                                "count": c.count}
                elif c.kind == "histogram":
                    out[key] = list(c.buckets)
                else:
                    out[key] = c.value
        return out

    def schema(self) -> dict:
        """{key: {"kind", "description"}} — `perf schema` (ref: the
        admin socket's perf schema command); ships on full MgrReports
        so the aggregator can type metrics it never declared."""
        with self._lock:
            return {key: {"kind": c.kind, "description": c.description}
                    for key, c in self._c.items()}

    def reset(self) -> None:
        """`perf reset` (ref: admin_socket perf reset all): zero every
        counter, keeping the declarations."""
        with self._lock:
            for c in self._c.values():
                c.value = 0
                c.sum_s = 0.0
                c.count = 0
                c.buckets = [0] * len(c.buckets)


class PerfCountersCollection:
    """Process-wide registry; `perf dump` equivalent."""

    def __init__(self):
        self._loggers: dict[str, PerfCounters] = {}
        self._lock = threading.Lock()

    def add(self, counters: PerfCounters) -> PerfCounters:
        with self._lock:
            self._loggers[counters.name] = counters
        return counters

    def remove(self, name: str) -> None:
        with self._lock:
            self._loggers.pop(name, None)

    def dump(self) -> dict:
        with self._lock:
            return {name: c.dump() for name, c in self._loggers.items()}

    def reset(self) -> None:
        with self._lock:
            loggers = list(self._loggers.values())
        for c in loggers:
            c.reset()

    def dump_json(self) -> str:
        return json.dumps(self.dump(), sort_keys=True)

    def prometheus_text(self, prefix: str = "ceph_tpu") -> str:
        """Prometheus exposition format over every registered logger —
        the role of the mgr prometheus module's scrape endpoint (ref:
        src/pybind/mgr/prometheus/module.py: counters become
        `<prefix>_<logger>_<key>` with HELP/TYPE headers; time_avg
        maps to a summary's _sum/_count pair; histograms emit one
        `_bucket{le=...}` series per slot)."""
        def clean(s: str) -> str:
            return "".join(ch if ch.isalnum() or ch == "_" else "_"
                           for ch in s)
        lines: list[str] = []
        with self._lock:
            loggers = dict(self._loggers)
        for lname in sorted(loggers):
            pc = loggers[lname]
            with pc._lock:
                items = {k: (c.kind, c.description, c.value, c.sum_s,
                             c.count, list(c.buckets))
                         for k, c in pc._c.items()}
            for key in sorted(items):
                kind, desc, value, sum_s, count, buckets = items[key]
                metric = f"{clean(prefix)}_{clean(lname)}_{clean(key)}"
                if desc:
                    lines.append(f"# HELP {metric} {desc}")
                # full precision: %g truncates to 6 significant digits,
                # which corrupts counters past ~1e6
                val = (str(int(value)) if float(value).is_integer()
                       else repr(float(value)))
                if kind == "counter":
                    lines.append(f"# TYPE {metric} counter")
                    lines.append(f"{metric} {val}")
                elif kind == "gauge":
                    lines.append(f"# TYPE {metric} gauge")
                    lines.append(f"{metric} {val}")
                elif kind == "time_avg":
                    lines.append(f"# TYPE {metric} summary")
                    lines.append(f"{metric}_sum {sum_s!r}")
                    lines.append(f"{metric}_count {count}")
                elif kind == "lhist":
                    # REAL prometheus histogram (r18): cumulative
                    # _bucket series with le in SECONDS (the lhist
                    # bucket's true upper bound), so
                    # histogram_quantile() answers in seconds. Last
                    # slot is the overflow clamp -> +Inf only.
                    lines.append(f"# TYPE {metric} histogram")
                    total = 0
                    for i, b in enumerate(buckets[:-1]):
                        total += b
                        lines.append(
                            f'{metric}_bucket{{le="'
                            f'{lhist_bucket_le(i)!r}"}} {total}')
                    total += buckets[-1] if buckets else 0
                    lines.append(f'{metric}_bucket{{le="+Inf"}} {total}')
                    lines.append(f"{metric}_sum {sum_s!r}")
                    lines.append(f"{metric}_count {total}")
                elif kind == "histogram":
                    # slot i holds samples in [2^i, 2^(i+1)), so the
                    # cumulative le bound is the slot's real upper
                    # value — histogram_quantile() then works in the
                    # sample's units, not bucket indices. The LAST slot
                    # is hinc's overflow clamp (values may exceed its
                    # nominal bound), so it folds into +Inf only.
                    lines.append(f"# TYPE {metric} histogram")
                    total = 0
                    for i, b in enumerate(buckets[:-1]):
                        total += b
                        lines.append(
                            f'{metric}_bucket{{le="{1 << (i + 1)}"}} '
                            f'{total}')
                    total += buckets[-1]
                    lines.append(f'{metric}_bucket{{le="+Inf"}} {total}')
                    lines.append(f"{metric}_sum {sum_s!r}")
                    lines.append(f"{metric}_count {total}")
        return "\n".join(lines) + "\n"


def dump_delta(before: dict, after: dict) -> dict:
    """Counter-delta attribution: `after - before` over two perf-dump
    shaped dicts (numbers subtract, time_avg dicts subtract
    field-wise, histogram lists subtract element-wise, nested logger
    dicts recurse). Keys new in `after` pass through whole. This is
    what rados_bench/recovery_bench emit so every BENCH_* number
    carries its own per-stage breakdown, and what a daemon ships in a
    delta MgrReport."""
    out: dict = {}
    for key, a in after.items():
        b = before.get(key)
        if b is None:
            out[key] = a
        elif isinstance(a, dict):
            out[key] = dump_delta(b, a)
        elif isinstance(a, list):
            out[key] = [x - y for x, y in zip(a, b)] \
                if len(a) == len(b) else a
        else:
            out[key] = a - b
    return out


def fold_delta(base: dict, delta: dict) -> dict:
    """The aggregation-side inverse of dump_delta: fold a delta dump
    onto an accumulated base (numbers add, dicts recurse, histogram
    lists add element-wise). Returns a NEW dict; inputs unchanged."""
    out = dict(base)
    for key, d in delta.items():
        b = out.get(key)
        if b is None:
            out[key] = d
        elif isinstance(d, dict):
            out[key] = fold_delta(b, d)
        elif isinstance(d, list):
            out[key] = [x + y for x, y in zip(b, d)] \
                if len(b) == len(d) else d
        else:
            out[key] = b + d
    return out


class MetricsHistory:
    """Per-daemon ring of interval-aligned counter/histogram DELTAS —
    the retained-history half of the r18 telemetry plane (the role of
    the mgr's per-daemon time-series cache fed by MMgrReport, kept in
    the daemon so `perf history` answers even with no monitor
    reachable).

    Every `mgr_history_interval` seconds (live via config; <= 0
    disables ticking entirely — the overhead-guard OFF arm),
    maybe_tick() snapshots dump_fn() and appends ONE entry holding the
    dump_delta since the previous snapshot, stamped with the
    wall-clock-aligned interval index (`bucket` = floor(t/interval)) —
    the single-host shared clock is what lets the mon-side aggregation
    align entries ACROSS daemons without negotiation. Memory is
    bounded by `mgr_history_len` entries (live too: shrinking the
    option trims a running ring on the next tick)."""

    def __init__(self, dump_fn, config=None, interval: float = 10.0,
                 length: int = 90, now_fn=time.time):
        self._dump_fn = dump_fn
        self._config = config
        self._interval = float(interval)
        self._length = int(length)
        self._now = now_fn
        self._prev: dict | None = None
        self._prev_t = 0.0
        self._ring: list[dict] = []
        self._seq = 0
        self._shipped = 0            # MgrReport drain cursor
        self._lock = threading.Lock()

    def _opt(self, name: str, fallback):
        if self._config is not None:
            try:
                return self._config.get(name)
            except (KeyError, ValueError, TypeError):
                pass
        return fallback

    @property
    def interval(self) -> float:
        return float(self._opt("mgr_history_interval", self._interval))

    @property
    def length(self) -> int:
        return int(self._opt("mgr_history_len", self._length))

    def maybe_tick(self) -> bool:
        """Tick iff the current wall-clock interval bucket is newer
        than the last recorded one. Returns True when an entry was
        appended. Cheap when idle: one clock read + one divide."""
        iv = self.interval
        if iv <= 0:
            return False
        now = self._now()
        if self._prev is not None and int(now / iv) \
                == int(self._prev_t / iv):
            return False
        return self.tick(now)

    def tick(self, now: float | None = None) -> bool:
        """Force one snapshot/delta entry (benches use this to close
        the final partial interval deterministically)."""
        iv = self.interval if self.interval > 0 else self._interval
        now = self._now() if now is None else now
        cur = self._dump_fn()
        with self._lock:
            prev, prev_t = self._prev, self._prev_t
            self._prev, self._prev_t = cur, now
            if prev is None:
                return False         # baseline snapshot, no delta yet
            self._seq += 1
            self._ring.append({
                "seq": self._seq,
                "t": round(now, 3),
                "bucket": int(now / iv),
                "interval_s": round(now - prev_t, 3),
                "delta": dump_delta(prev, cur),
            })
            over = len(self._ring) - self.length
            if over > 0:
                del self._ring[:over]
        return True

    def dump(self, limit: int | None = None) -> dict:
        """The `perf history` admin-command body."""
        with self._lock:
            entries = list(self._ring)
        if limit is not None:
            entries = entries[-int(limit):]
        return {"interval": self.interval, "len": self.length,
                "recorded": self._seq, "entries": entries}

    def drain_unshipped(self, limit: int = 8) -> list[dict]:
        """Entries recorded since the last drain — what one MgrReport
        ships (normally 0 or 1 per report; bounded for report size)."""
        with self._lock:
            out = [e for e in self._ring if e["seq"] > self._shipped]
            out = out[:int(limit)]
            if out:
                self._shipped = out[-1]["seq"]
            return out


# the default process-wide collection (role of CephContext's collection)
g_perf_counters = PerfCountersCollection()
