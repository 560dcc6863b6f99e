"""Health model — cluster checks from the aggregated daemon reports.

Rebuild of the reference's health_check_map_t surface (ref:
src/mon/health_check.h + the producers: OSDMap::check_health for
OSD_DOWN, PGMap health for PG_DEGRADED/PG_AVAILABILITY/SLOW_OPS,
Monitor::get_health_status for MON_DOWN): each check carries a code,
a severity, a one-line summary and detail lines, and the overall
status is the worst surviving severity. Everything here derives from
REAL state — the committed OSDMap, the monitor's own liveness view,
and MgrReport-aggregated daemon counters — never synthesized values.
"""

from __future__ import annotations

HEALTH_OK = "HEALTH_OK"
HEALTH_WARN = "HEALTH_WARN"
HEALTH_ERR = "HEALTH_ERR"


def _check(code: str, severity: str, summary: str,
           detail: list[str]) -> dict:
    return {"code": code, "severity": severity, "summary": summary,
            "detail": detail}


def health_checks(osdmap=None, quorum: list[int] | None = None,
                  mon_members: list[int] | None = None,
                  reports=None, stale_grace: float = 15.0,
                  pg_num: int | None = None,
                  telemetry=None, netobs=None) -> dict:
    """-> {"status", "checks": [check...]}. Any argument may be None
    (a monitor answering before its first map simply has fewer
    producers). `telemetry` (r18, a TelemetryAggregator) contributes
    SLO_BURN / LATENCY_REGRESSION / TRACE_RING_OVERFLOW from the
    retained metric history — quiet unless SLO rules are declared
    (mgr_slo_rules) or a flight ring persistently overflows.
    `netobs` (r22, a NetworkAggregator) contributes
    OSD_SLOW_PING_TIME naming the links whose heartbeat RTT ewma
    crossed the live slow-ping threshold."""
    checks: list[dict] = []

    if telemetry is not None:
        try:
            checks.extend(telemetry.health_checks())
        except Exception:   # noqa: BLE001 — a telemetry bug must not
            pass            # take down status/health itself

    if netobs is not None:
        try:
            checks.extend(netobs.health_checks())
        except Exception:   # noqa: BLE001 — same containment rule
            pass

    if osdmap is not None:
        down = [o for o, up in enumerate(osdmap.osd_up) if not up]
        if down:
            checks.append(_check(
                "OSD_DOWN", HEALTH_WARN,
                f"{len(down)} osds down",
                [f"osd.{o} is down" for o in down]))
        out = [o for o in range(len(osdmap.osd_weight))
               if osdmap.osd_weight[o] == 0]
        if out:
            checks.append(_check(
                "OSD_OUT", HEALTH_WARN,
                f"{len(out)} osds out",
                [f"osd.{o} is out (weight 0)" for o in out]))
        # r21 capacity ladder (ref: OSDMap::check_health OSD_NEARFULL/
        # OSD_BACKFILLFULL/OSD_FULL + PG_POOL_FULL): rendered straight
        # from the COMMITTED map's ladder state — health says exactly
        # what the mon decided, never a re-derivation from raw statfs
        full_state = getattr(osdmap, "osd_full_state", {}) or {}
        for state, code, sev, why in (
                (3, "OSD_FULL", HEALTH_ERR,
                 "at/over mon_osd_full_ratio — client writes parked"),
                (2, "OSD_BACKFILLFULL", HEALTH_WARN,
                 "at/over osd_backfillfull_ratio — recovery into it "
                 "parks"),
                (1, "OSD_NEARFULL", HEALTH_WARN,
                 "at/over mon_osd_nearfull_ratio")):
            osds = sorted(o for o, s in full_state.items()
                          if s == state)
            if osds:
                checks.append(_check(
                    code, sev,
                    f"{len(osds)} osd(s) {code[4:].lower()}",
                    [f"osd.{o} is {why}" for o in osds]))
        full_pools = getattr(osdmap, "full_pools", None) or set()
        if full_pools:
            checks.append(_check(
                "POOL_FULL", HEALTH_ERR,
                f"{len(full_pools)} pool(s) full",
                [f"pool {p} hit its quota "
                 f"(quota_max_bytes="
                 f"{osdmap.pools[p].quota_max_bytes}, "
                 f"quota_max_objects="
                 f"{osdmap.pools[p].quota_max_objects}) — client "
                 f"writes parked"
                 for p in sorted(full_pools) if p in osdmap.pools]))

    if quorum is not None and mon_members is not None:
        missing = sorted(set(mon_members) - set(quorum))
        if missing:
            sev = HEALTH_ERR if len(quorum) <= len(mon_members) // 2 \
                else HEALTH_WARN
            checks.append(_check(
                "MON_DOWN", sev,
                f"{len(missing)}/{len(mon_members)} monitors down",
                [f"mon.{r} is not in quorum" for r in missing]))

    if reports is not None:
        totals = reports.totals()
        if totals["slow_ops"]:
            slow = [f"{name}: {e.get('slow_ops', 0)} slow ops"
                    for name, e in sorted(reports.daemons().items())
                    if e.get("slow_ops")]
            checks.append(_check(
                "SLOW_OPS", HEALTH_WARN,
                f"{totals['slow_ops']} slow ops, oldest past "
                f"osd_op_complaint_time", slow))
        states = reports.pg_states()
        degraded = sorted(pg for pg, st in states.items()
                          if "degraded" in st or "undersized" in st
                          or "down" in st or "incomplete" in st)
        if degraded:
            checks.append(_check(
                "PG_DEGRADED", HEALTH_WARN,
                f"{len(degraded)} pgs degraded",
                [f"pg {pg} is {states[pg]}" for pg in degraded]))
        # PG_EXPOSED (r17): a PG at m-1 surviving redundancy — one
        # more failure loses data. Louder than plain degradation (the
        # repair policy's m-1 override is already rebuilding these
        # first; the check is the operator-visible exposure window)
        exposed = sorted(pg for pg, st in states.items()
                         if "exposed" in st)
        if exposed:
            checks.append(_check(
                "PG_EXPOSED", HEALTH_WARN,
                f"{len(exposed)} pgs at m-1 redundancy (one more "
                f"failure loses data)",
                [f"pg {pg} is {states[pg]}" for pg in exposed]))
        peering = sorted(pg for pg, st in states.items()
                         if "peering" in st or "needs_up_thru" in st)
        if peering:
            checks.append(_check(
                "PG_AVAILABILITY", HEALTH_WARN,
                f"{len(peering)} pgs peering",
                [f"pg {pg} is {states[pg]}" for pg in peering]))
        # PG_STALE: a PG nobody's fresh report claims — its primary
        # stopped reporting (daemon wedged/killed before the map
        # noticed) or no primary claims the pgid at all
        stale_names = [n for n, age in reports.report_ages().items()
                       if age > stale_grace]
        stale_pgs: list[str] = []
        if pg_num is not None:
            claimed = set(states)
            fresh_claimed = {
                pg for name, e in reports.daemons().items()
                if name not in stale_names
                for pg in (e.get("pgs") or {})}
            for ps in range(pg_num):
                pgid = f"1.{ps}"
                if pgid not in fresh_claimed:
                    stale_pgs.append(
                        f"pg {pgid} "
                        + ("last claimed by a stale daemon"
                           if pgid in claimed else "has no primary "
                           "report"))
        if stale_pgs:
            checks.append(_check(
                "PG_STALE", HEALTH_WARN,
                f"{len(stale_pgs)} pgs stale", stale_pgs))

    order = {HEALTH_OK: 0, HEALTH_WARN: 1, HEALTH_ERR: 2}
    status = HEALTH_OK
    for c in checks:
        if order[c["severity"]] > order[status]:
            status = c["severity"]
    return {"status": status, "checks": checks}
