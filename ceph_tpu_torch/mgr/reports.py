"""MgrReport aggregation — daemon counters to cluster view.

Rebuild of the reference's daemon->mgr stats pipe (ref: MMgrReport in
src/messages/MMgrReport.h + src/mgr/DaemonServer.cc handle_report:
daemons periodically ship their PerfCounters as DELTAS after an
initial full declaration, the mgr folds them into DaemonStateIndex,
and the prometheus module renders the aggregate as text exposition).

Here the aggregation lives in each monitor (this tier has no separate
mgr daemon — disclosed in ARCHITECTURE.md): daemons broadcast reports
to every monitor, each folds independently, and any one of them can
answer `ceph status` / `prometheus`. Wire shape per report:

    {"name": "osd.0", "seq": N, "kind": "full"|"delta",
     "perf": <dump or delta over nested loggers>,
     "schema": {logger: {key: {kind, description}}}   (full only),
     "ops_in_flight": n, "slow_ops": n,
     "pgs": {"1.0": "active+clean", ...}, "epoch": e}

Deltas fold only when seq == last_seq + 1; any gap (monitor restart,
lost report, daemon restart) marks the daemon stale until the next
FULL report re-bases it — daemons interleave a full every
FULL_EVERY reports, so staleness self-heals without acks.
"""

from __future__ import annotations

import threading
import time

from ..utils.perf_counters import fold_delta

#: a daemon re-ships its full dump every Nth report; deltas ride the
#: reports in between (the bounded-delta discipline the PG metadata
#: plane already uses)
FULL_EVERY = 8


class MgrReportAggregator:
    """Per-monitor fold of every daemon's report stream."""

    def __init__(self, now_fn=time.monotonic):
        self._now = now_fn
        self._lock = threading.Lock()
        #: name -> {"perf", "schema", "seq", "stamp", "ops_in_flight",
        #:          "slow_ops", "pgs", "epoch", "synced"}
        self._daemons: dict[str, dict] = {}

    def ingest(self, report: dict) -> None:
        name = report.get("name")
        if not name:
            return
        now = self._now()
        with self._lock:
            ent = self._daemons.setdefault(
                name, {"perf": {}, "schema": {}, "seq": -1,
                       "synced": False, "pgs": {}, "epoch": 0,
                       "pool_bytes": {}, "ops_in_flight": 0,
                       "slow_ops": 0, "stamp": now})
            seq = int(report.get("seq", 0))
            if report.get("kind") == "full":
                ent["perf"] = report.get("perf", {})
                if report.get("schema"):
                    ent["schema"] = report["schema"]
                ent["synced"] = True
            elif ent["synced"] and seq == ent["seq"] + 1:
                ent["perf"] = fold_delta(ent["perf"],
                                         report.get("perf", {}))
            else:
                # gap: this delta extends a base we never saw — wait
                # for the next interleaved full instead of folding
                # garbage (self-heals within FULL_EVERY reports)
                ent["synced"] = False
            ent["seq"] = seq
            ent["stamp"] = now
            for key in ("ops_in_flight", "slow_ops", "pgs", "epoch",
                        "pool_bytes", "pool_objects", "mclock",
                        "statfs", "network"):
                if key in report:
                    ent[key] = report[key]

    # -- views ---------------------------------------------------------------

    def daemons(self) -> dict:
        with self._lock:
            return {n: dict(e) for n, e in self._daemons.items()}

    def report_ages(self) -> dict[str, float]:
        now = self._now()
        with self._lock:
            return {n: now - e["stamp"] for n, e in self._daemons.items()}

    def pg_states(self) -> dict[str, str]:
        """Latest primary-reported state per pgid (the report carrying
        the newest epoch wins a contested pgid — two daemons can both
        claim a PG across an interval change)."""
        with self._lock:
            ents = sorted(self._daemons.values(),
                          key=lambda e: e["epoch"])
        out: dict[str, str] = {}
        for ent in ents:
            out.update(ent.get("pgs") or {})
        return out

    def pool_bytes(self) -> dict[int, int]:
        """Logical bytes per pool summed over every reporting
        primary's claim — the pool-utilization input the
        pg_autoscaler's capacity shares derive from (role of
        pg_stat_t num_bytes aggregation in the mgr)."""
        out: dict[int, int] = {}
        with self._lock:
            claims = [e.get("pool_bytes") or {}
                      for e in self._daemons.values()]
        for claim in claims:
            for pid, b in claim.items():
                pid = int(pid)
                out[pid] = out.get(pid, 0) + int(b)
        return out

    def pool_objects(self) -> dict[int, int]:
        """Object count per pool summed over every reporting primary's
        claim — what quota_max_objects is enforced against (role of
        pg_stat_t num_objects aggregation in the mgr)."""
        out: dict[int, int] = {}
        with self._lock:
            claims = [e.get("pool_objects") or {}
                      for e in self._daemons.values()]
        for claim in claims:
            for pid, n in claim.items():
                pid = int(pid)
                out[pid] = out.get(pid, 0) + int(n)
        return out

    def statfs(self) -> dict[str, dict]:
        """Latest raw statfs claim per reporting OSD ("osd.N" ->
        {"total","used","avail"}) — the r21 capacity ladder's only
        input (the mon never guesses at space it wasn't told about).
        Daemons with no claim (mons, unbounded stores reporting
        total=0) simply appear without a usable ratio."""
        with self._lock:
            return {n: dict(e["statfs"])
                    for n, e in self._daemons.items()
                    if e.get("statfs")}

    def network(self) -> dict[str, dict]:
        """Latest links+flow claim per reporting daemon (r22, the
        NetworkAggregator's raw input — kept here too so a bench or
        test can replay the fold from the same aggregator state)."""
        with self._lock:
            return {n: dict(e["network"])
                    for n, e in self._daemons.items()
                    if e.get("network")}

    def tenants(self) -> dict:
        """Per-tenant mClock accounting summed over every daemon's
        latest `mclock` claim (r20): class "tenant:<entity>" rows fold
        into one row per entity — served/served_cost (grants),
        throttled (limit-bound dequeue passes) and queued depth, plus
        the (ρ, w, λ) profile the class last ran under. The view
        `ceph_cli top` and the workload bench use to say WHICH tenant
        mClock is holding back."""
        out: dict[str, dict] = {}
        with self._lock:
            claims = [e.get("mclock") or {}
                      for e in self._daemons.values()]
        for claim in claims:
            for cls, row in claim.items():
                if not cls.startswith("tenant:"):
                    continue
                entity = cls[len("tenant:"):]
                cur = out.setdefault(
                    entity, {"queued": 0, "served": 0,
                             "served_cost": 0.0, "throttled": 0,
                             "profile": row.get("profile")})
                cur["queued"] += int(row.get("queued", 0))
                cur["served"] += int(row.get("served", 0))
                cur["served_cost"] = round(
                    cur["served_cost"]
                    + float(row.get("served_cost", 0.0)), 3)
                cur["throttled"] += int(row.get("throttled", 0))
                if row.get("profile"):
                    cur["profile"] = row["profile"]
        return out

    def totals(self) -> dict:
        with self._lock:
            return {
                "slow_ops": sum(e.get("slow_ops", 0)
                                for e in self._daemons.values()),
                "ops_in_flight": sum(e.get("ops_in_flight", 0)
                                     for e in self._daemons.values()),
                "daemons_reporting": len(self._daemons),
            }

    def cluster_perf(self) -> dict:
        """Counters summed across daemons per (logger, key) — the
        `perf dump` a monitor can answer for the whole cluster."""
        out: dict = {}
        with self._lock:
            dumps = [e["perf"] for e in self._daemons.values()]
        for dump in dumps:
            out = fold_delta(out, _normalized(dump))
        return out


def _normalized(perf: dict) -> dict:
    """Fold per-daemon logger names ("osd.3") onto their generic
    logger ("osd") so cluster aggregation and exposition don't mint
    one metric family per daemon."""
    out = {}
    for logger, counters in perf.items():
        out[_generic_logger(logger)] = counters
    return out


def _generic_logger(logger: str) -> str:
    head, _, tail = logger.partition(".")
    return head if tail.isdigit() else logger


def _clean(s: str) -> str:
    return "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in s)


def prometheus_text(agg: MgrReportAggregator,
                    prefix: str = "ceph_tpu") -> str:
    """Text exposition over the aggregated REAL daemon counters (ref:
    src/pybind/mgr/prometheus/module.py): one series per (logger, key,
    daemon) with a `daemon` label, typed from the schema the daemons
    declared in their full reports. time_avg renders as a summary's
    _sum/_count; histograms as cumulative power-of-two buckets (the
    PerfCountersCollection.prometheus_text convention)."""
    daemons = agg.daemons()
    lines: list[str] = []
    seen_header: set[str] = set()
    for dname in sorted(daemons):
        ent = daemons[dname]
        schema = ent.get("schema") or {}
        for logger in sorted(ent.get("perf") or {}):
            counters = ent["perf"][logger]
            lschema = schema.get(logger, {})
            glogger = _generic_logger(logger)
            for key in sorted(counters):
                val = counters[key]
                ks = lschema.get(key, {})
                kind = ks.get("kind") or _guess_kind(val)
                metric = f"{_clean(prefix)}_{_clean(glogger)}_{_clean(key)}"
                label = f'{{daemon="{dname}"}}'
                if metric not in seen_header:
                    seen_header.add(metric)
                    if ks.get("description"):
                        lines.append(f"# HELP {metric} "
                                     f"{ks['description']}")
                    lines.append(f"# TYPE {metric} "
                                 f"{_prom_type(kind)}")
                if kind == "time_avg":
                    lines.append(f"{metric}_sum{label} "
                                 f"{val.get('sum', 0)!r}")
                    lines.append(f"{metric}_count{label} "
                                 f"{val.get('avgcount', 0)}")
                elif kind == "lhist":
                    # r18: REAL `# TYPE ... histogram` exposition for
                    # the mergeable latency histograms — cumulative
                    # _bucket/_sum/_count with le in SECONDS, never
                    # flattened to gauges
                    from ..utils.perf_counters import lhist_bucket_le
                    buckets = (val or {}).get("buckets") or []
                    total = 0
                    for i, b in enumerate(buckets[:-1]):
                        total += b
                        lines.append(
                            f'{metric}_bucket{{daemon="{dname}",'
                            f'le="{lhist_bucket_le(i)!r}"}} {total}')
                    total += buckets[-1] if buckets else 0
                    lines.append(f'{metric}_bucket{{daemon="{dname}",'
                                 f'le="+Inf"}} {total}')
                    lines.append(f"{metric}_sum{label} "
                                 f"{(val or {}).get('sum', 0.0)!r}")
                    lines.append(f"{metric}_count{label} {total}")
                elif kind == "histogram":
                    total = 0
                    for i, b in enumerate(val[:-1]):
                        total += b
                        lines.append(
                            f'{metric}_bucket{{daemon="{dname}",'
                            f'le="{1 << (i + 1)}"}} {total}')
                    total += val[-1] if val else 0
                    lines.append(f'{metric}_bucket{{daemon="{dname}",'
                                 f'le="+Inf"}} {total}')
                    lines.append(f"{metric}_count{label} {total}")
                else:
                    v = (str(int(val)) if float(val).is_integer()
                         else repr(float(val)))
                    lines.append(f"{metric}{label} {v}")
    return "\n".join(lines) + "\n"


def _guess_kind(val) -> str:
    if isinstance(val, dict):
        return "lhist" if "buckets" in val else "time_avg"
    if isinstance(val, list):
        return "histogram"
    return "counter"


def _prom_type(kind: str) -> str:
    return {"counter": "counter", "gauge": "gauge",
            "time_avg": "summary", "histogram": "histogram",
            "lhist": "histogram"}[kind]
