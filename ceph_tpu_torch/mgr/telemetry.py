"""Telemetry time-series plane — cluster metric history, mergeable
latency quantiles, SLO burn-rate health, and the observed-client-
latency feed (r18).

The mgr half of the retained-history pipeline (the role the
reference's mgr plays as DaemonStateIndex time-series cache +
prometheus recording rules + the SRE multiwindow burn-rate alerts
layered on top): every daemon keeps a per-interval MetricsHistory
ring (utils/perf_counters.MetricsHistory) and ships freshly recorded
entries in its MgrReports; every monitor runs one TelemetryAggregator
folding those entries into

* CLUSTER time-series — per wall-clock-aligned interval, the folded
  counter deltas per (generic logger, key) plus the per-daemon
  breakdown, bounded to `max_intervals`;
* MERGED latency histograms — lhist deltas add bucket-wise, so the
  cluster p99 is EXACTLY the quantile of the per-daemon merge (no
  approximation stacking; pinned by the bit-exactness test);
* SLO verdicts — declared rules (`mgr_slo_rules`) evaluated per
  interval into a fast window (the newest 2 data intervals — a
  breach "flips within two evaluation intervals" by construction)
  and a slow window (every data interval inside the rule's `over`
  span). Both burn rates ship with each verdict; SLO_BURN fires on a
  hot fast window and clears the first clean interval;
* LATENCY_REGRESSION — drift detection on the same feeds: the newest
  interval's p99 against the median of the trailing baseline
  (arxiv 1709.05365's lesson that online-EC bottlenecks MIGRATE —
  a point-in-time perf dump can't see the drift, history can);
* the observed-client-latency feed — `observed_client_latency()`
  returns merged client-visible quantiles (client-shipped histograms
  when clients report them, the merged OSD op histograms otherwise),
  and `burn_rate()` feeds the balancer movement budget
  (mgr/placement.telemetry_movement_budget): rebalancing yields to
  traffic when the burn is hot (ROADMAP item 5's hook).

Dimensionality, disclosed: series are keyed per (logger, key) with
per-daemon breakdown retained; this harness runs ONE pool (id 1) and
its per-tenant split lives in the mClock dumps, so the pool/tenant
dimensions of `observed_client_latency(pool)` validate-and-collapse
rather than fan out (ARCHITECTURE "Telemetry plane (r18)").
"""

from __future__ import annotations

import re
import threading
import time

from ..utils.perf_counters import (fold_delta, lhist_merge,
                                   lhist_quantile, lhist_quantiles)
from .reports import _generic_logger

__all__ = ["SLORule", "parse_slo_rules", "TelemetryAggregator",
           "FEED_ALIASES"]

#: rule-feed aliases -> (logger, lhist key). The merged-OSD feeds are
#: service-time at the primary (op enter -> reply built); the
#: client_observed feed is the client's own submit->reply frame time
#: (includes wire + windowing), shipped with its trace flushes.
FEED_ALIASES = {
    "client_read": ("osd", "op_r_latency_hist"),
    "client_write": ("osd", "op_w_latency_hist"),
    "client_op": ("osd", "op_latency_hist"),
    "subop": ("osd", "subop_latency_hist"),
    "client_observed": ("client", "op_lat_hist"),
    # r21: wall time mutating ops sat parked behind FULL flags — a
    # COUNT/DURATION feed, not a latency feed: parked time never
    # enters the write-latency feeds (parked ops are not dispatched),
    # and the write-feed verdicts disclose backoff activity instead
    # of letting a capacity stall read as a latency regression
    "full_backoff": ("client", "full_backoff_time_hist"),
}

#: feeds whose verdicts carry the r21 full-backoff disclosure (write
#: paths a FULL flag parks; read feeds keep serving and stay quiet)
_WRITE_FEEDS = frozenset({"client_write", "client_op",
                          "client_observed"})


def _is_write_rule(rule: "SLORule") -> bool:
    """Does this rule watch a feed a FULL flag parks? Matched on the
    resolved (logger, key) so both the alias spelling and an explicit
    `osd.op_w_latency_hist` rule get the disclosure."""
    return any((rule.logger, rule.key) == FEED_ALIASES[f]
               for f in _WRITE_FEEDS)

_UNIT_S = {"us": 1e-6, "ms": 1e-3, "s": 1.0}
_WIN_S = {"s": 1.0, "m": 60.0, "h": 3600.0}

_RULE_RE = re.compile(
    r"^\s*(?P<metric>[A-Za-z0-9_.]+?)_p(?P<q>\d{1,3})\s*<\s*"
    r"(?P<val>\d+(?:\.\d+)?)\s*(?P<unit>us|ms|s)\s+over\s+"
    r"(?P<win>\d+(?:\.\d+)?)\s*(?P<wu>s|m|h)"
    r"(?:\s*\[\s*tenant\s*=\s*(?P<tenant>[A-Za-z0-9_.:@-]+)\s*\])?"
    r"\s*$")

#: the fast burn window, in data intervals: a rule breaches when the
#: newest FAST_INTERVALS intervals with samples all violate — so an
#: injected slowdown flips SLO_BURN within two evaluation intervals,
#: and one clean interval clears it (hysteresis = re-breach needs two
#: hot intervals again)
FAST_INTERVALS = 2


class SLORule:
    """One parsed rule: `client_read_p99 < 50ms over 5m`. r20 adds an
    optional tenant qualifier — `client_observed_p99 < 30ms over 2m
    [tenant=client.interactive]` — which evaluates the rule against
    that tenant's OWN observed-latency feed (the per-tenant snapshots
    the workload engine ships via ingest_client(tenant=...)) instead
    of the cluster merge."""

    __slots__ = ("name", "logger", "key", "q", "threshold_s",
                 "window_s", "tenant")

    def __init__(self, name: str, logger: str, key: str, q: float,
                 threshold_s: float, window_s: float,
                 tenant: str | None = None):
        self.name = name
        self.logger = logger
        self.key = key
        self.q = q
        self.threshold_s = threshold_s
        self.window_s = window_s
        self.tenant = tenant

    def to_dict(self) -> dict:
        out = {"name": self.name, "logger": self.logger,
               "key": self.key, "quantile": self.q,
               "threshold_ms": round(self.threshold_s * 1e3, 3),
               "window_s": self.window_s}
        if self.tenant is not None:
            out["tenant"] = self.tenant
        return out


def parse_slo_rules(text: str) -> list[SLORule]:
    """';'-separated rules; a malformed rule raises ValueError with
    the offending fragment (the config layer surfaces it to the
    operator instead of silently evaluating nothing)."""
    rules: list[SLORule] = []
    for frag in (text or "").split(";"):
        frag = frag.strip()
        if not frag:
            continue
        m = _RULE_RE.match(frag)
        if m is None:
            raise ValueError(f"bad SLO rule {frag!r} (want "
                             f"'<feed>_p<Q> < <val><us|ms|s> over "
                             f"<win><s|m|h>')")
        metric = m.group("metric")
        if metric in FEED_ALIASES:
            logger, key = FEED_ALIASES[metric]
        elif "." in metric:
            logger, _, key = metric.partition(".")
        else:
            raise ValueError(
                f"bad SLO rule {frag!r}: unknown feed {metric!r} "
                f"(aliases: {sorted(FEED_ALIASES)}; or use "
                f"<logger>.<lhist-key>)")
        q = int(m.group("q")) / 100.0
        if not 0.0 < q < 1.0:
            raise ValueError(f"bad SLO rule {frag!r}: quantile "
                             f"p{m.group('q')} out of (0, 100)")
        tenant = m.group("tenant")
        if tenant is not None and metric != "client_observed":
            raise ValueError(
                f"bad SLO rule {frag!r}: [tenant=...] only applies "
                f"to the client_observed feed (per-tenant data comes "
                f"from client-shipped snapshots)")
        name = f"{metric}_p{m.group('q')}"
        if tenant is not None:
            name += f"[{tenant}]"
        rules.append(SLORule(
            name=name, logger=logger, key=key,
            q=q,
            threshold_s=float(m.group("val"))
            * _UNIT_S[m.group("unit")],
            window_s=float(m.group("win")) * _WIN_S[m.group("wu")],
            tenant=tenant))
    return rules


class TelemetryAggregator:
    """Per-monitor fold of every daemon's shipped MetricsHistory
    entries into bounded cluster time-series (+ the client-shipped
    observed-latency histograms and the flight-ring overflow
    tracker). Thread-safe; also used standalone by the benches over
    in-process rings."""

    def __init__(self, config=None, max_intervals: int = 256,
                 now_fn=time.time):
        self._config = config
        self._max = int(max_intervals)
        self._now = now_fn
        self._lock = threading.Lock()
        #: bucket(int) -> {"t", "interval_s", "delta" (cluster fold,
        #: generic loggers), "daemons": {name: per-daemon delta}}
        self._intervals: dict[int, dict] = {}
        #: client name -> cumulative "client" logger dump (the
        #: observed-latency feed; cumulative, monitor computes deltas
        #: implicitly by replacing)
        self._clients: dict[str, dict] = {}
        #: daemon -> (last dropped_unshipped, consecutive growths)
        self._flight: dict[str, tuple[int, int]] = {}
        #: r20 per-tenant observed-latency feed: tenant -> last
        #: cumulative op_lat_hist, and tenant -> bounded ring of
        #: (t, interval-delta hist) points the tenant-qualified SLO
        #: rules evaluate over
        self._tenant_last: dict[str, dict] = {}
        self._tenant_points: dict[str, list] = {}
        #: r21 full-backoff tracking: client -> (last cumulative
        #: backoff count, wall stamp of the last observed GROWTH) —
        #: the write-feed verdicts' disclosure source
        self._backoff: dict[str, tuple[int, float]] = {}

    # -- ingest ---------------------------------------------------------------

    def ingest(self, name: str, entries: list[dict]) -> None:
        """Fold one daemon's shipped history entries (MetricsHistory
        drain shape). Idempotence rides the per-daemon replace: a
        re-shipped entry re-folds, but daemons drain each entry
        exactly once (the cursor), so dups only occur on report
        replay — tolerated as the counters they'd inflate are
        diagnostics, not billing."""
        if not entries:
            return
        with self._lock:
            for e in entries:
                if not isinstance(e, dict) or "bucket" not in e:
                    continue
                delta = _normalize_loggers(e.get("delta") or {})
                ent = self._intervals.get(e["bucket"])
                if ent is None:
                    ent = self._intervals[e["bucket"]] = {
                        "t": e.get("t", 0.0),
                        "interval_s": e.get("interval_s", 0.0),
                        "delta": {}, "daemons": {}}
                ent["delta"] = fold_delta(ent["delta"], delta)
                ent["daemons"][name] = fold_delta(
                    ent["daemons"].get(name, {}), delta)
            over = len(self._intervals) - self._max
            if over > 0:
                for b in sorted(self._intervals,
                                key=lambda b:
                                self._intervals[b]["t"])[:over]:
                    del self._intervals[b]

    def ingest_client(self, name: str, client_perf: dict,
                      tenant: str | None = None) -> None:
        """A client's CUMULATIVE "client" logger dump (ships with its
        trace flushes): newest snapshot wins per client. With
        `tenant=` (r20, the workload engine's per-tenant feed) the
        snapshot ALSO folds into that tenant's interval ring: each
        call appends the op_lat_hist delta vs the previous snapshot
        as one (t, hist) point, so tenant-qualified SLO rules get the
        same interval/burn-window semantics the cluster feeds have."""
        if not isinstance(client_perf, dict):
            return
        with self._lock:
            self._clients[name] = client_perf
            # r21: note full-backoff growth (cumulative time_avg
            # avgcount) — stamps the last interval a client was
            # observed parked, read by the write-feed verdicts
            fb = (client_perf.get("client") or client_perf
                  ).get("full_backoff_time")
            if isinstance(fb, dict):
                try:
                    cur = int(fb.get("avgcount", 0))
                except (TypeError, ValueError):
                    cur = 0
                last, stamp = self._backoff.get(name, (0, 0.0))
                if cur > last:
                    stamp = self._now()
                self._backoff[name] = (cur, stamp)
            if tenant is None:
                return
            hist = (client_perf.get("client") or client_perf
                    ).get("op_lat_hist")
            if not isinstance(hist, dict) or "buckets" not in hist:
                return
            delta = _lhist_sub(hist, self._tenant_last.get(tenant))
            self._tenant_last[tenant] = hist
            if not delta.get("count"):
                return
            ring = self._tenant_points.setdefault(tenant, [])
            ring.append((self._now(), delta))
            del ring[:-self._max]

    def full_backoff_active(self, window_s: float) -> bool:
        """r21: was ANY client observed growing its full-backoff
        counter within the trailing window? The disclosure gate the
        write-feed SLO verdicts and the regression probe consult."""
        cutoff = self._now() - window_s
        with self._lock:
            return any(stamp >= cutoff and cnt > 0
                       for cnt, stamp in self._backoff.values())

    def full_backoff(self) -> dict:
        """Per-client cumulative full-backoff accounting (count +
        total seconds parked) from the newest client snapshots —
        `ceph_cli slo`'s capacity-stall disclosure block."""
        out: dict[str, dict] = {}
        with self._lock:
            for name, perf in self._clients.items():
                fb = (perf.get("client") or perf
                      ).get("full_backoff_time")
                if isinstance(fb, dict) and fb.get("avgcount"):
                    out[name] = {
                        "count": int(fb.get("avgcount", 0)),
                        "total_s": round(float(fb.get("sum", 0.0)), 3)}
        return out

    def note_flight(self, name: str, stats: dict) -> None:
        """Track a daemon's flight-ring `dropped_unshipped` across
        reports: N consecutive observed GROWTHS = persistent overflow
        (the TRACE_RING_OVERFLOW source). A report with no growth
        resets the streak."""
        try:
            cur = int((stats or {}).get("dropped_unshipped", 0))
        except (TypeError, ValueError):
            return
        with self._lock:
            last, streak = self._flight.get(name, (cur, 0))
            if cur > last:
                streak += 1
            elif cur < last:      # daemon restarted: ring reset
                streak = 0
            else:
                streak = 0
            self._flight[name] = (cur, streak)

    def flight_drops(self) -> dict[str, int]:
        """Per-daemon flight-ring dropped_unshipped gauges (newest
        reported value) — surfaced by `ceph_cli top` next to the r19
        sampler gauges so ring overflow is visible BEFORE the
        TRACE_RING_OVERFLOW streak trips."""
        with self._lock:
            return {name: last
                    for name, (last, _streak) in sorted(
                        self._flight.items())}

    # -- views ----------------------------------------------------------------

    def _buckets_locked(self, window_s: float | None = None
                        ) -> list[int]:
        # ordered by WALL TIME, not bucket index: a live
        # mgr_history_interval change rescales the index space, and
        # index-sorted "newest" would interleave the two scales
        bs = sorted(self._intervals,
                    key=lambda b: self._intervals[b]["t"])
        if window_s is not None and bs:
            cutoff = self._now() - window_s
            bs = [b for b in bs
                  if self._intervals[b]["t"] >= cutoff]
        return bs

    def series(self, logger: str, key: str,
               limit: int = 32) -> list[dict]:
        """Per-interval cluster values of one (logger, key), newest
        last. Numbers come back as-is; time_avg deltas as their dict;
        lhist deltas as their {buckets,sum,count} dict."""
        with self._lock:
            out = []
            for b in self._buckets_locked()[-limit:]:
                ent = self._intervals[b]
                val = (ent["delta"].get(logger) or {}).get(key)
                out.append({"bucket": b, "t": ent["t"],
                            "interval_s": ent["interval_s"],
                            "value": val})
            return out

    def per_daemon_hist(self, logger: str, key: str,
                        window_s: float | None = None) -> dict:
        """Per-daemon lhist merged over the window's intervals — the
        operand list of the cluster merge (the bit-exactness test
        re-merges these by hand and compares)."""
        with self._lock:
            out: dict[str, dict] = {}
            for b in self._buckets_locked(window_s):
                for name, d in self._intervals[b]["daemons"].items():
                    h = (d.get(logger) or {}).get(key)
                    if isinstance(h, dict) and "buckets" in h:
                        out[name] = lhist_merge(out.get(name), h)
            return out

    def merged_hist(self, logger: str, key: str,
                    window_s: float | None = None) -> dict:
        """Cluster lhist over the window = exact bucket-add over every
        daemon's entries."""
        with self._lock:
            out: dict = {}
            for b in self._buckets_locked(window_s):
                h = (self._intervals[b]["delta"].get(logger)
                     or {}).get(key)
                if isinstance(h, dict) and "buckets" in h:
                    out = lhist_merge(out, h)
            return out

    def quantiles(self, logger: str, key: str,
                  window_s: float | None = None) -> dict:
        return lhist_quantiles(self.merged_hist(logger, key,
                                                window_s))

    def observed_client_latency(self, pool: int | None = None) -> dict:
        """THE stable feed (ROADMAP item 5): merged client-visible
        latency quantiles. Prefers client-shipped histograms (true
        client-observed: submit -> reply, wire included); falls back
        to the merged OSD client-op service histograms when no client
        reports (source disclosed in the result). `pool` validates
        against this harness's single pool."""
        if pool is not None and int(pool) != 1:
            raise KeyError(f"no pool {pool} (this harness runs pool 1)")
        with self._lock:
            client_hists = [
                (d.get("client") or d).get("op_lat_hist")
                for d in self._clients.values()]
            client_hists = [h for h in client_hists
                            if isinstance(h, dict) and h.get("count")]
        if client_hists:
            merged = lhist_merge(*client_hists)
            return {"source": "client", "pool": 1,
                    **lhist_quantiles(merged)}
        merged = self.merged_hist("osd", "op_latency_hist")
        return {"source": "osd", "pool": 1,
                **lhist_quantiles(merged)}

    def tenant_latency(self) -> dict:
        """Per-tenant observed-latency quantiles merged over each
        tenant's interval ring (r20) — the per-tenant complement of
        observed_client_latency(), empty until the workload engine
        ships tenant-tagged snapshots."""
        with self._lock:
            rings = {t: [h for _t, h in pts]
                     for t, pts in self._tenant_points.items()}
        out = {}
        for tenant, hists in sorted(rings.items()):
            merged: dict = {}
            for h in hists:
                merged = lhist_merge(merged, h)
            out[tenant] = {"intervals": len(hists),
                           **lhist_quantiles(merged)}
        return out

    # -- SLO evaluation -------------------------------------------------------

    def _rules(self) -> list[SLORule]:
        text = ""
        if self._config is not None:
            try:
                text = self._config.get("mgr_slo_rules")
            except (KeyError, TypeError):
                text = ""
        try:
            return parse_slo_rules(text)
        except ValueError:
            return []            # malformed committed value: the
            #                    # config set path already rejected it

    def slo_status(self, rules: list[SLORule] | None = None) -> list[dict]:
        """One verdict per declared rule: per-interval quantiles over
        the rule window, fast/slow burn rates, and the breach flag
        (fast window = newest FAST_INTERVALS data intervals, all
        violating)."""
        out = []
        for rule in (self._rules() if rules is None else rules):
            with self._lock:
                points = []
                if rule.tenant is not None:
                    # tenant-qualified rule: evaluate over that
                    # tenant's own interval ring (r20)
                    cutoff = self._now() - rule.window_s
                    for i, (t, h) in enumerate(
                            self._tenant_points.get(rule.tenant, [])):
                        if t >= cutoff and h.get("count"):
                            points.append(
                                (i, lhist_quantile(h, rule.q),
                                 int(h["count"])))
                else:
                    for b in self._buckets_locked(rule.window_s):
                        ent = self._intervals[b]
                        h = (ent["delta"].get(rule.logger)
                             or {}).get(rule.key)
                        if isinstance(h, dict) and h.get("count"):
                            points.append(
                                (b, lhist_quantile(h, rule.q),
                                 int(h["count"])))
            violated = [q > rule.threshold_s for _b, q, _n in points]
            fast = violated[-FAST_INTERVALS:]
            burn_fast = (sum(fast) / len(fast)) if fast else 0.0
            burn_slow = (sum(violated) / len(violated)) \
                if violated else 0.0
            breach = len(fast) >= FAST_INTERVALS and all(fast)
            verdict = {
                **rule.to_dict(),
                "intervals": len(points),
                "samples": sum(n for _b, _q, n in points),
                "current_ms": round(points[-1][1] * 1e3, 3)
                if points else None,
                "burn_fast": round(burn_fast, 3),
                "burn_slow": round(burn_slow, 3),
                "breach": breach,
            }
            # r21 disclosure: a write-feed verdict evaluated while
            # clients sat in full-backoff says so — the operator reads
            # "capacity stall", not "the write path got slow"
            if _is_write_rule(rule) \
                    and self.full_backoff_active(rule.window_s):
                verdict["full_backoff_active"] = True
            out.append(verdict)
        return out

    def burn_rate(self) -> float:
        """Hottest fast-window burn across declared rules, in [0, 1]
        — what the balancer movement budget shrinks by
        (mgr/placement.telemetry_movement_budget). No rules declared
        -> 0.0 (budget passes through)."""
        return max((v["burn_fast"] for v in self.slo_status()),
                   default=0.0)

    def regressions(self) -> list[dict]:
        """LATENCY_REGRESSION probes over the declared rules' feeds:
        newest data interval's quantile vs the MEDIAN of the trailing
        baseline intervals. Needs >= 3 baseline intervals and >= 16
        samples in the newest (noise floor on a loaded 1-core box);
        factor from mgr_latency_regression_factor (0 disables)."""
        factor = 4.0
        if self._config is not None:
            try:
                factor = float(
                    self._config.get("mgr_latency_regression_factor"))
            except (KeyError, TypeError, ValueError):
                pass
        if factor <= 0:
            return []
        out = []
        for rule in self._rules():
            with self._lock:
                points = []
                for b in self._buckets_locked():
                    h = (self._intervals[b]["delta"]
                         .get(rule.logger) or {}).get(rule.key)
                    if isinstance(h, dict) and h.get("count"):
                        points.append((lhist_quantile(h, 0.99),
                                       int(h["count"])))
            if len(points) < 4 or points[-1][1] < 16:
                continue
            if _is_write_rule(rule) and self.full_backoff_active(
                    max(60.0, rule.window_s)):
                # r21: a capacity stall is not a latency regression —
                # the parked interval is disclosed on the SLO verdict
                # (full_backoff_active) and in `slo`'s full_backoff
                # block instead of tripping LATENCY_REGRESSION
                continue
            baseline = sorted(q for q, _n in points[:-1])
            median = baseline[len(baseline) // 2]
            current = points[-1][0]
            if median > 0 and current > factor * median:
                out.append({
                    "feed": rule.name, "logger": rule.logger,
                    "key": rule.key,
                    "baseline_p99_ms": round(median * 1e3, 3),
                    "current_p99_ms": round(current * 1e3, 3),
                    "factor": round(current / median, 2),
                })
        return out

    # -- health ---------------------------------------------------------------

    def health_checks(self) -> list[dict]:
        """The r18 checks, in mgr/health.py's check shape — folded
        into the monitor's health_checks() output."""
        checks: list[dict] = []
        breaches = [v for v in self.slo_status() if v["breach"]]
        if breaches:
            checks.append({
                "code": "SLO_BURN", "severity": "HEALTH_WARN",
                "summary": f"{len(breaches)} SLO rule(s) burning "
                           f"(fast window hot)",
                "detail": [
                    f"{v['name']}: current "
                    f"{v['current_ms']}ms > {v['threshold_ms']}ms, "
                    f"burn fast={v['burn_fast']} "
                    f"slow={v['burn_slow']} over {v['window_s']}s"
                    for v in breaches]})
        regs = self.regressions()
        if regs:
            checks.append({
                "code": "LATENCY_REGRESSION",
                "severity": "HEALTH_WARN",
                "summary": f"{len(regs)} latency feed(s) regressed "
                           f"vs trailing baseline",
                "detail": [
                    f"{r['feed']}: p99 {r['current_p99_ms']}ms = "
                    f"{r['factor']}x baseline "
                    f"{r['baseline_p99_ms']}ms" for r in regs]})
        with self._lock:
            overflowing = sorted(
                name for name, (_last, streak) in self._flight.items()
                if streak >= 2)
        if overflowing:
            checks.append({
                "code": "TRACE_RING_OVERFLOW",
                "severity": "HEALTH_WARN",
                "summary": f"{len(overflowing)} daemon(s) "
                           f"persistently dropping unshipped trace "
                           f"spans (flight ring too small or reports "
                           f"too slow)",
                "detail": [f"{n} dropped sampled spans before "
                           f"shipping in consecutive reports "
                           f"(raise osd_trace_ring_size or lower "
                           f"mgr_report_interval)"
                           for n in overflowing]})
        return checks

    # -- the operator views (`ceph_cli top / slo`, mon cmds) ------------------

    def dump(self, series_keys: list[tuple[str, str]] | None = None,
             limit: int = 32) -> dict:
        """The `telemetry` mon-command body: interval series for the
        headline keys + merged quantiles + the client feed + SLO
        verdicts. Bench JSON embeds this same shape (schema pinned by
        tests/test_bench_schema.py)."""
        keys = series_keys or [("osd", "op"), ("osd", "subop"),
                               ("ec", "recovered_bytes")]
        hists = [("osd", "op_latency_hist"),
                 ("osd", "subop_latency_hist")]
        return {
            "interval_buckets": len(self._intervals),
            "series": {f"{lg}.{k}": self.series(lg, k, limit)
                       for lg, k in keys},
            "quantiles": {f"{lg}.{k}": self.quantiles(lg, k)
                          for lg, k in hists},
            "observed_client_latency":
                self.observed_client_latency(),
            "slo": self.slo_status(),
        }

    def top(self, reports=None) -> dict:
        """The `ceph_cli top` body: per-daemon rates over the newest
        interval + cluster quantiles + in-flight totals (reports =
        the monitor's MgrReportAggregator, for ops_in_flight)."""
        with self._lock:
            bs = self._buckets_locked()
            newest = self._intervals[bs[-1]] if bs else None
            rows = {}
            if newest:
                iv = max(1e-9, newest["interval_s"])
                for name, d in sorted(newest["daemons"].items()):
                    osd = d.get("osd") or {}
                    lat = osd.get("op_latency") or {}
                    cnt = lat.get("avgcount") or 0
                    rows[name] = {
                        "ops_per_s": round(
                            (osd.get("op") or 0) / iv, 1),
                        "subops_per_s": round(
                            (osd.get("subop") or 0) / iv, 1),
                        "op_ms_avg": round(
                            1e3 * lat.get("sum", 0.0) / cnt, 3)
                        if cnt else 0.0,
                    }
        out = {"interval_s": newest["interval_s"] if newest else None,
               "daemons": rows,
               "cluster": self.quantiles("osd", "op_latency_hist"),
               "observed_client_latency":
                   self.observed_client_latency()}
        tl = self.tenant_latency()
        if tl:
            out["tenant_latency"] = tl
        if reports is not None:
            out["totals"] = reports.totals()
        return out


def _lhist_sub(cur: dict, prev: dict | None) -> dict:
    """Bucket-wise lhist subtraction cur - prev (both cumulative
    dumps). A fresh/reset snapshot (no prev, shorter buckets, or any
    bucket that went DOWN — client restart) deltas against zero, i.e.
    returns cur whole; never a negative histogram."""
    cb = list(cur.get("buckets") or [])
    if prev is None:
        return {"buckets": cb, "sum": float(cur.get("sum", 0.0)),
                "count": int(cur.get("count", 0))}
    pb = list(prev.get("buckets") or [])
    if len(pb) > len(cb):
        return {"buckets": cb, "sum": float(cur.get("sum", 0.0)),
                "count": int(cur.get("count", 0))}
    pb += [0] * (len(cb) - len(pb))
    if any(c < p for c, p in zip(cb, pb)):
        return {"buckets": cb, "sum": float(cur.get("sum", 0.0)),
                "count": int(cur.get("count", 0))}
    return {"buckets": [c - p for c, p in zip(cb, pb)],
            "sum": float(cur.get("sum", 0.0))
            - float(prev.get("sum", 0.0)),
            "count": int(cur.get("count", 0))
            - int(prev.get("count", 0))}


def _normalize_loggers(delta: dict) -> dict:
    """Per-daemon logger names ("osd.3") fold onto their generic
    logger ("osd") so cluster series don't mint one family per
    daemon (mgr/reports._normalized, applied to history deltas)."""
    return {_generic_logger(lg): counters
            for lg, counters in delta.items()}
