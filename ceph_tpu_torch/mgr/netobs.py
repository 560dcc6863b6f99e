"""Network observability plane (r22) — per-link RTT + flow.

Every prior plane (r9 counters, r15 traces, r18 telemetry, r19
profiles) attributes time to DAEMONS; the wire between them was a
blind spot the trace assembler literally labels "wire". This module
closes it with the reference's answer (ref: OSD::dump_osd_network +
the OSD_SLOW_PING_TIME health check off mon_warn_on_slow_ping_time /
mon_warn_on_slow_ping_ratio in src/osd/OSD.cc): measure the heartbeat
frames we already exchange.

Two halves share this file because they share the link-key vocabulary:

* ``LinkTracker`` — the DAEMON half. Each OSD folds heartbeat
  ping→pong round trips (and store sub-op round trips) into per-link
  state keyed ``(peer, channel)``: an r18 ``lhist`` (log2-µs buckets,
  mergeable by exact bucket addition), a responsive EWMA, and a
  two-window min/max. Channels: ``hb`` (MOSDPing round trips — the
  pure wire+dispatch signal) and ``store`` (store sub-op round trips
  — wire plus service time). The tracker's dump rides the MgrReport
  pipe as a side-field (like ``statfs``/``mclock`` — per-peer keys
  are dynamic, so they must NOT be perf-counter names; the r9
  declared-names rule).

* ``NetworkAggregator`` — the MONITOR half. Folds every daemon's
  shipped links+flow claim into the cluster link matrix; serves
  ``dump_osd_network`` (asok + wire + ``ceph_cli netstat``), raises
  ``OSD_SLOW_PING_TIME`` naming the worst links, renders bounded-
  cardinality prometheus exposition (worst-N links by p99, real
  ``# TYPE histogram`` per the r18 rule), and answers the
  ``link_cost(a, b)`` feed the r14 helper ranking, r11 hedge ladder,
  and r17 DownClock evidence consume in place of op-latency-only
  inference.

A link key is DIRECTED: ``osd.0 → osd.3 (hb)`` is osd.0's measurement
of its own ping's round trip through osd.3's fast dispatch. A one-way
delay injected on osd.0's sends toward osd.3 inflates exactly this
key (the reply crosses undelayed — reactor threads never sleep), which
is what lets the health check name one direction of one link.
"""

from __future__ import annotations

import threading
import time

from ..utils import perf_counters as _pc
from ..utils.perf_counters import (LHIST_BUCKETS, lhist_bucket,
                                   lhist_bucket_le, lhist_merge,
                                   lhist_quantiles)

#: EWMA smoothing for the per-link round trip: deliberately MORE
#: responsive than the reference's 1/5/15-minute decaying averages —
#: the health check must flip within two heartbeat grace windows of a
#: real degrade (the thrasher pins this), and at test-scale intervals
#: a slow horizon would sit on stale air. 0.5 converges to >87% of a
#: step change in three pings.
EWMA_ALPHA = 0.5

#: min/max window length (seconds): the tracker keeps the current and
#: previous window, so dump's min/max always cover between one and two
#: windows of history — the reference's "last interval" framing
#: without per-sample memory.
WINDOW_S = 60.0

#: samples a link must carry before the aggregator will judge it slow
#: (one cold outlier during boot must not flip cluster health).
MIN_SAMPLES = 3


def link_key(peer: str, channel: str) -> str:
    """The wire/report encoding of one directed link's far end:
    ``"osd.3|hb"``. Kept flat (not a tuple) so the key survives JSON
    round trips through reports and bench artifacts unchanged."""
    return f"{peer}|{channel}"


def split_link_key(key: str) -> tuple[str, str]:
    peer, _, channel = key.partition("|")
    return peer, channel or "hb"


class LinkTracker:
    """Per-daemon fold of link round-trip samples (the OSD half).

    Thread-safe: ``note`` runs on reactor threads (pong fast
    dispatch) and store RPC completions concurrently; ``dump`` on the
    heartbeat thread. The lock is a leaf."""

    def __init__(self, now_fn=time.monotonic, window_s: float = WINDOW_S,
                 perf=None, perf_key: str = "hb_ping_rtt"):
        self._now = now_fn
        self._window = float(window_s)
        self._lock = threading.Lock()
        #: (peer, channel) -> link entry
        self._links: dict[tuple[str, str], dict] = {}
        # the DECLARED aggregate: every sample also tincs one
        # time_avg+lhist on the daemon's perf logger, so the r9
        # declared-names invariant holds while per-peer detail rides
        # the report side-field
        self._perf = perf
        self._perf_key = perf_key

    def note(self, peer: str, rtt_s: float,
             channel: str = "hb") -> None:
        """Fold one round-trip sample into the (peer, channel) link."""
        if rtt_s < 0:
            return                      # clock skew artifact: drop
        if self._perf is not None and channel == "hb":
            try:
                self._perf.tinc(self._perf_key, rtt_s)
            except KeyError:
                pass                    # harness perf without schema
        now = self._now()
        with self._lock:
            ent = self._links.get((peer, channel))
            if ent is None:
                ent = self._links[(peer, channel)] = {
                    "hist": {"buckets": [0] * LHIST_BUCKETS,
                             "sum": 0.0, "count": 0},
                    "ewma_s": rtt_s, "last_s": rtt_s, "count": 0,
                    "win_start": now, "win_min": rtt_s,
                    "win_max": rtt_s, "prev_min": None,
                    "prev_max": None,
                }
            if now - ent["win_start"] >= self._window:
                ent["prev_min"], ent["prev_max"] = \
                    ent["win_min"], ent["win_max"]
                ent["win_start"] = now
                ent["win_min"] = ent["win_max"] = rtt_s
            ent["count"] += 1
            ent["last_s"] = rtt_s
            ent["ewma_s"] = (EWMA_ALPHA * rtt_s
                             + (1.0 - EWMA_ALPHA) * ent["ewma_s"])
            ent["win_min"] = min(ent["win_min"], rtt_s)
            ent["win_max"] = max(ent["win_max"], rtt_s)
            # the module attribute, read at call time: the benches'
            # OFF arm flips it process-wide (r18 overhead guard)
            if _pc.LHIST_ENABLED:
                h = ent["hist"]
                h["buckets"][lhist_bucket(rtt_s)] += 1
                h["sum"] += rtt_s
                h["count"] += 1

    def ewma_s(self, peer: str) -> float:
        """Worst live EWMA toward `peer` across channels (seconds) —
        the link-cost feed's daemon-local edge (r14 helper blend)."""
        with self._lock:
            return max((e["ewma_s"] for (p, _c), e
                        in self._links.items() if p == peer),
                       default=0.0)

    def dump(self) -> dict:
        """Report/asok shape: {"osd.3|hb": {hist, ewma_ms, last_ms,
        min_ms, max_ms, count}}. min/max span the current + previous
        window. hist buckets are COPIED (the report pipe serializes
        after this returns)."""
        out: dict[str, dict] = {}
        with self._lock:
            for (peer, channel), e in self._links.items():
                lo = e["win_min"] if e["prev_min"] is None \
                    else min(e["win_min"], e["prev_min"])
                hi = e["win_max"] if e["prev_max"] is None \
                    else max(e["win_max"], e["prev_max"])
                out[link_key(peer, channel)] = {
                    "hist": {"buckets": list(e["hist"]["buckets"]),
                             "sum": e["hist"]["sum"],
                             "count": e["hist"]["count"]},
                    "ewma_ms": round(e["ewma_s"] * 1e3, 3),
                    "last_ms": round(e["last_s"] * 1e3, 3),
                    "min_ms": round(lo * 1e3, 3),
                    "max_ms": round(hi * 1e3, 3),
                    "count": e["count"],
                }
        return out

    def clear(self) -> None:
        with self._lock:
            self._links.clear()


class NetworkAggregator:
    """Per-monitor fold of every daemon's links+flow claims (the mon
    half). Constructed beside the TraceAssembler/TelemetryAggregator/
    ProfileAggregator; thread-safe; also driven standalone by the
    benches and unit tests."""

    def __init__(self, config=None, now_fn=time.monotonic):
        self._config = config
        self._now = now_fn
        self._lock = threading.Lock()
        #: daemon name -> {"links": {key: link}, "flow": {peer: flow},
        #:                 "stamp": monotonic}
        self._daemons: dict[str, dict] = {}

    # -- plumbing -------------------------------------------------------------

    def _cfg(self, key: str, default):
        if self._config is None:
            return default
        try:
            v = self._config[key] if not hasattr(self._config, "get") \
                else self._config.get(key)
            return default if v is None else v
        except (KeyError, TypeError):
            return default

    def threshold_ms(self) -> float:
        """The slow-link verdict line, resolved LIVE from config each
        call (a committed `config set` retunes health with no
        restart): mon_warn_on_slow_ping_time (ms) when > 0, else
        mon_warn_on_slow_ping_ratio x osd_heartbeat_grace — exactly
        the reference's fallback."""
        warn = float(self._cfg("mon_warn_on_slow_ping_time", 0.0))
        if warn > 0:
            return warn
        ratio = float(self._cfg("mon_warn_on_slow_ping_ratio", 0.05))
        grace = float(self._cfg("osd_heartbeat_grace", 20.0))
        return ratio * grace * 1e3

    def stale_after_s(self) -> float:
        """Claims older than this never feed verdicts: a dead daemon's
        last report must not pin a slow link (or hide a healed one)
        forever. Two grace windows, floored at 10s for report cadence."""
        grace = float(self._cfg("osd_heartbeat_grace", 20.0))
        return max(10.0, 2.0 * grace)

    # -- ingest ---------------------------------------------------------------

    def ingest(self, name: str, block: dict) -> None:
        """Fold one daemon's report side-field {"links", "flow"}.
        Newest claim per daemon wins (cumulative shapes, like the
        statfs claims)."""
        if not isinstance(block, dict):
            return
        with self._lock:
            self._daemons[name] = {
                "links": dict(block.get("links") or {}),
                "flow": dict(block.get("flow") or {}),
                "stamp": self._now(),
            }

    # -- the matrix -----------------------------------------------------------

    def links(self, fresh_only: bool = True) -> list[dict]:
        """The cluster link matrix as rows: one per directed
        (from, to, channel) with quantiles off the shipped lhist."""
        cutoff = (self._now() - self.stale_after_s()) if fresh_only \
            else float("-inf")
        rows: list[dict] = []
        with self._lock:
            claims = [(n, e) for n, e in self._daemons.items()
                      if e["stamp"] >= cutoff]
        for name, ent in claims:
            for key, link in ent["links"].items():
                peer, channel = split_link_key(key)
                hist = link.get("hist") or {}
                row = {
                    "from": name, "to": peer, "channel": channel,
                    "ewma_ms": float(link.get("ewma_ms", 0.0)),
                    "last_ms": float(link.get("last_ms", 0.0)),
                    "min_ms": float(link.get("min_ms", 0.0)),
                    "max_ms": float(link.get("max_ms", 0.0)),
                    "count": int(link.get("count", 0)),
                    "hist": hist,
                }
                row.update(lhist_quantiles(hist))
                rows.append(row)
        rows.sort(key=lambda r: (-r["ewma_ms"], r["from"], r["to"],
                                 r["channel"]))
        return rows

    def slow_links(self) -> list[dict]:
        """Rows over the live threshold (worst first), each stamped
        with the threshold it breached. Heartbeat channel ONLY: the
        check is OSD_SLOW_PING_TIME — a ping-RTT verdict, like the
        reference's (store sub-op latency rides the same matrix for
        the operator but feeds SLOW_OPS-shaped signals, not this
        one)."""
        thr = self.threshold_ms()
        out = []
        for row in self.links():
            if row["channel"] == "hb" and row["count"] >= MIN_SAMPLES \
                    and row["ewma_ms"] > thr:
                r = dict(row)
                r["threshold_ms"] = thr
                out.append(r)
        return out

    def link_cost(self, a, b) -> int:
        """The feed: directed cost of a→b in INTEGER MICROSECONDS
        (minimum_to_decode_with_cost units, same as _helper_costs) —
        the worst live EWMA `a` has measured toward `b` across
        channels, 0 when unmeasured. Accepts "osd.3" or 3."""
        a, b = _osd_name(a), _osd_name(b)
        with self._lock:
            ent = self._daemons.get(a)
            links = dict(ent["links"]) if ent is not None else {}
        worst = 0.0
        for key, link in links.items():
            peer, _channel = split_link_key(key)
            if peer == b:
                worst = max(worst, float(link.get("ewma_ms", 0.0)))
        return int(worst * 1e3)

    def worst_cost_per_osd(self) -> dict[int, int]:
        """Per-OSD worst cost (µs) over every live link TOUCHING it,
        either direction — the client hedge ladder's pull shape (a
        client reading from osd X pays X's bad links whichever end
        measured them)."""
        out: dict[int, int] = {}
        for row in self.links():
            cost = int(row["ewma_ms"] * 1e3)
            for end in (row["from"], row["to"]):
                osd = _osd_id(end)
                if osd is not None:
                    out[osd] = max(out.get(osd, 0), cost)
        return out

    def flow_totals(self) -> dict:
        """Cluster flow roll-up over every daemon's per-peer ledgers."""
        tot = {"bytes_tx": 0, "frames_tx": 0, "bytes_rx": 0,
               "frames_rx": 0, "stalls": 0, "stall_time_s": 0.0,
               "writeq_bytes": 0, "writeq_frames": 0}
        with self._lock:
            flows = [e["flow"] for e in self._daemons.values()]
        for flow in flows:
            for f in flow.values():
                for k in tot:
                    tot[k] += f.get(k, 0)
        tot["stall_time_s"] = round(tot["stall_time_s"], 6)
        return tot

    # -- operator views -------------------------------------------------------

    def dump(self, limit: int = 64) -> dict:
        """The `dump_osd_network` body (asok + wire + `ceph_cli
        netstat`): the matrix (worst-first, bounded), the slow-link
        verdicts, cluster flow totals, and the live threshold."""
        rows = self.links()
        dropped = max(0, len(rows) - int(limit))
        slim = []
        for row in rows[:int(limit)]:
            r = {k: v for k, v in row.items() if k != "hist"}
            slim.append(r)
        return {
            "threshold_ms": round(self.threshold_ms(), 3),
            "stale_after_s": round(self.stale_after_s(), 3),
            "links": slim,
            "links_total": len(rows),
            "links_dropped": dropped,
            "slow": [{k: v for k, v in r.items() if k != "hist"}
                     for r in self.slow_links()],
            "flow_totals": self.flow_totals(),
            "daemons_reporting": len(self._daemons),
        }

    def health_checks(self) -> list[dict]:
        """OSD_SLOW_PING_TIME in mgr/health.py's check shape, naming
        the worst links (the reference's detail lines name
        back-to-back pairs the same way)."""
        slow = self.slow_links()
        if not slow:
            return []
        thr = slow[0]["threshold_ms"]
        return [{
            "code": "OSD_SLOW_PING_TIME",
            "severity": "HEALTH_WARN",
            "summary": f"{len(slow)} slow heartbeat link(s) "
                       f"(rtt ewma over {round(thr, 1)}ms)",
            "detail": [
                f"{r['from']} -> {r['to']} ({r['channel']}): "
                f"ewma {round(r['ewma_ms'], 1)}ms > "
                f"{round(thr, 1)}ms "
                f"(p99 {r['p99_ms']}ms over {r['count']} pings)"
                for r in slow[:10]],
        }]

    # -- prometheus (bounded cardinality) -------------------------------------

    def prometheus_text(self, prefix: str = "ceph_tpu",
                        limit: int | None = None) -> str:
        """Worst-N links by p99 as REAL `# TYPE histogram` series
        (cumulative _bucket with le in seconds — the r18 rule) plus
        per-link flow counters. N defaults from
        mgr_netobs_prom_links; everything past it is DISCLOSED via
        the _links_dropped gauge, never silently truncated."""
        if limit is None:
            limit = int(self._cfg("mgr_netobs_prom_links", 8))
        rows = self.links()
        rows.sort(key=lambda r: (-r["p99_ms"], r["from"], r["to"],
                                 r["channel"]))
        keep = rows[:max(0, int(limit))]
        m_rtt = f"{prefix}_netobs_link_rtt_seconds"
        lines = [
            f"# HELP {m_rtt} heartbeat/store round trip per directed "
            f"link (worst {len(keep)} of {len(rows)} by p99)",
            f"# TYPE {m_rtt} histogram",
        ]
        for r in keep:
            lab = (f'daemon="{r["from"]}",peer="{r["to"]}",'
                   f'channel="{r["channel"]}"')
            buckets = (r["hist"] or {}).get("buckets") or []
            total = 0
            for i, b in enumerate(buckets[:-1]):
                total += b
                lines.append(f'{m_rtt}_bucket{{{lab},'
                             f'le="{lhist_bucket_le(i)!r}"}} {total}')
            total += buckets[-1] if buckets else 0
            lines.append(f'{m_rtt}_bucket{{{lab},le="+Inf"}} {total}')
            lines.append(f'{m_rtt}_sum{{{lab}}} '
                         f'{(r["hist"] or {}).get("sum", 0.0)!r}')
            lines.append(f'{m_rtt}_count{{{lab}}} {total}')
        m_drop = f"{prefix}_netobs_links_dropped"
        lines.append(f"# HELP {m_drop} links over the worst-N "
                     f"exposition cap (cardinality bound, disclosed)")
        lines.append(f"# TYPE {m_drop} gauge")
        lines.append(f"{m_drop} {max(0, len(rows) - len(keep))}")
        m_tx = f"{prefix}_netobs_peer_bytes_tx"
        m_rx = f"{prefix}_netobs_peer_bytes_rx"
        with self._lock:
            flows = {n: dict(e["flow"])
                     for n, e in self._daemons.items()}
        flow_lines: list[str] = []
        peers_of = {}
        for name, flow in sorted(flows.items()):
            # same cardinality bound: only peers on a kept link
            kept_peers = {r["to"] for r in keep if r["from"] == name}
            peers_of[name] = kept_peers
            for peer in sorted(kept_peers & set(flow)):
                f = flow[peer]
                lab = f'daemon="{name}",peer="{peer}"'
                flow_lines.append(
                    f'{m_tx}{{{lab}}} {int(f.get("bytes_tx", 0))}')
                flow_lines.append(
                    f'{m_rx}{{{lab}}} {int(f.get("bytes_rx", 0))}')
        if flow_lines:
            lines.append(f"# TYPE {m_tx} counter")
            lines.append(f"# TYPE {m_rx} counter")
            lines.extend(flow_lines)
        return "\n".join(lines) + "\n"


def _osd_name(x) -> str:
    return x if isinstance(x, str) else f"osd.{int(x)}"


def _osd_id(name: str) -> int | None:
    if isinstance(name, str) and name.startswith("osd."):
        try:
            return int(name[4:])
        except ValueError:
            return None
    return None


def merge_link_dumps(*dumps: dict) -> dict:
    """Exact merge of LinkTracker dumps by link key: lhist buckets add
    element-wise (the r18 merge), counts add, min/max fold, the ewma
    of the LAST claim wins (EWMAs don't merge; newest is freshest).
    What the bit-exactness test replays by hand against the
    aggregator's matrix."""
    out: dict[str, dict] = {}
    for d in dumps:
        for key, link in (d or {}).items():
            cur = out.get(key)
            if cur is None:
                out[key] = {**link,
                            "hist": lhist_merge(link.get("hist"))}
                continue
            cur["hist"] = lhist_merge(cur["hist"], link.get("hist"))
            cur["count"] = cur.get("count", 0) + link.get("count", 0)
            cur["min_ms"] = min(cur.get("min_ms", float("inf")),
                                link.get("min_ms", float("inf")))
            cur["max_ms"] = max(cur.get("max_ms", 0.0),
                                link.get("max_ms", 0.0))
            cur["ewma_ms"] = link.get("ewma_ms", cur.get("ewma_ms"))
            cur["last_ms"] = link.get("last_ms", cur.get("last_ms"))
    return out
