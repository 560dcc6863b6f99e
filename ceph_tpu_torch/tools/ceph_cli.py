"""ceph — cluster status/observability CLI, on the port.

Recreation of the reference's operator surface (ref: src/ceph.in — the
`ceph` admin CLI; `ceph status` / `ceph health` / `ceph pg stat` /
`ceph daemon <id> perf dump` via the admin socket
src/common/admin_socket.cc; `ceph config set/get` via
src/mon/ConfigMonitor.cc; the prometheus scrape via
src/pybind/mgr/prometheus/module.py).

TWO modes:

* LIVE (`--asok-dir DIR`): answer against a RUNNING standalone
  cluster through its daemons' Unix admin sockets — status / health /
  prometheus render from the monitors' MgrReport-aggregated REAL
  counters, and `daemon <name> <cmd>` talks straight to one daemon's
  asok (perf dump, dump_historic_ops, log dump, trace start/stop...).
  The cluster passes its `admin_dir` here (StandaloneCluster prints
  nothing; tests and benches own the handle).
* HERMETIC (default): build a SimCluster from a scenario first, then
  answer against it — the deterministic demo path.

Twin of the JAX package's tools/ceph_cli.py: the hermetic cluster lives
on --device (default the CUDA device); live mode speaks the admin-socket
protocol of utils/admin_socket.py, a byte-identical copy in both
packages, so either package's CLI reads either package's cluster.

  python -m ceph_tpu_torch.tools.ceph_cli status
  python -m ceph_tpu_torch.tools.ceph_cli --scenario osd-failure pg stat
  python -m ceph_tpu_torch.tools.ceph_cli --asok-dir /tmp/ceph-asok-X status
  python -m ceph_tpu_torch.tools.ceph_cli --asok-dir /tmp/ceph-asok-X \\
      health detail
  python -m ceph_tpu_torch.tools.ceph_cli --asok-dir /tmp/ceph-asok-X \\
      prometheus
  python -m ceph_tpu_torch.tools.ceph_cli --asok-dir /tmp/ceph-asok-X \\
      daemon osd.0 perf dump
  python -m ceph_tpu_torch.tools.ceph_cli config set osd_max_backfills 4
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from . import _device, add_device_flag, pool_profile

SCENARIOS = ("healthy", "osd-failure", "mon-loss", "backfill")


# -- live mode: a running standalone cluster over its admin sockets ----------

def live_mon_command(asok_dir: str, kind: str):
    """Hunt the monitors' admin sockets; first answer wins (any
    monitor folds every daemon's MgrReports independently)."""
    import glob
    from ..utils.admin_socket import AdminSocketError, admin_command
    socks = sorted(glob.glob(os.path.join(asok_dir, "mon.*.asok")))
    if not socks:
        raise SystemExit(f"no mon.*.asok under {asok_dir} "
                         f"(is the cluster running?)")
    last = None
    for p in socks:
        try:
            return admin_command(p, kind)
        except (OSError, AdminSocketError) as e:
            last = e
    raise SystemExit(f"no monitor answered {kind!r}: {last}")


def live_daemon_command(asok_dir: str, name: str, cmd: str):
    from ..utils.admin_socket import admin_command
    path = os.path.join(asok_dir, f"{name}.asok")
    if not os.path.exists(path):
        raise SystemExit(f"no admin socket {path}")
    return admin_command(path, cmd)


def cmd_live_status(asok_dir: str, args) -> None:
    st = live_mon_command(asok_dir, "status")
    if args.json:
        print(json.dumps(st, sort_keys=True))
        return
    quorum = st.get("mon_quorum") or []
    print("  cluster:")
    print(f"    health: {st['health']}"
          + (f" ({', '.join(st['checks'])})" if st["checks"] else ""))
    print("  services:")
    print(f"    mon: {len(st['mon_members'])} monitors, quorum "
          f"{quorum}, leader mon.{st['mon_leader']}")
    print(f"    osd: {st['num_osds']} osds: {st['osds_up']} up, "
          f"{st['osds_in']} in (epoch {st['epoch']})")
    print("  data:")
    states = ", ".join(f"{n} {s}" for s, n in
                       sorted(st["pg_states"].items())) or "none "
    print(f"    pgs: {states} ({st['pgs_total']} total)")
    print(f"    io: {st['ops_in_flight']} ops in flight, "
          f"{st['slow_ops']} slow "
          f"({st['daemons_reporting']} daemons reporting)")


def cmd_live_health(asok_dir: str, args, detail: bool) -> None:
    h = live_mon_command(asok_dir,
                         "health detail" if detail else "health")
    if args.json:
        print(json.dumps(h, sort_keys=True))
        return
    print(h["status"])
    for c in h["checks"]:
        print(f"  {c['code']}: {c['summary']}")
        for line in c.get("detail") or []:
            print(f"      {line}")


def cmd_live_trace(asok_dir: str, args) -> None:
    """`ceph_cli trace ...` — the r15 distributed-tracing surface:
    answered from any monitor's TraceAssembler (daemon flight rings
    stitched over the MgrReport pipe)."""
    out = live_mon_command(asok_dir, f"trace {args.trace_arg}")
    if args.chrome is not None:
        if "chrome" not in out:
            raise SystemExit("--chrome needs a trace id "
                             "(`trace <id-hex>`)")
        with open(args.chrome, "w") as f:
            json.dump(out["chrome"], f)
        print(f"wrote {len(out['chrome']['traceEvents'])} events "
              f"to {args.chrome}")
        return
    if args.json:
        print(json.dumps(out, sort_keys=True))
        return
    if "traces" in out:          # slow / list views
        for t in out["traces"]:
            line = (f"  {t['trace_id']}  {t['duration_s'] * 1e3:9.3f} ms "
                    f" spans={t['spans']:<4} "
                    f"daemons={','.join(t['daemons'])}")
            cp = t.get("critical_path")
            if cp:
                parts = ", ".join(
                    f"{k}={cp[k] * 1e3:.2f}ms"
                    for k in ("queue", "crypto", "encode", "store",
                              "wire", "other") if cp.get(k, 0) > 0)
                line += f"\n      [{parts}]"
            print(line)
        if not out["traces"]:
            print("  (no assembled traces yet)")
        return
    # one assembled trace
    if not out.get("found"):
        raise SystemExit(f"trace {args.trace_arg!r} not assembled "
                         f"(evicted, never sampled, or still in "
                         f"flight)")
    cp = out["critical_path"]
    print(f"trace {out['trace_id']}  total "
          f"{cp['total'] * 1e3:.3f} ms  daemons: "
          f"{', '.join(out['daemons'])}")
    print("  attribution: " + ", ".join(
        f"{k}={cp[k] * 1e3:.3f}ms"
        for k in ("queue", "crypto", "encode", "store", "wire",
                  "other")))
    t0 = min((s["start"] for s in out["spans"]), default=0.0)
    for s in out["spans"]:
        print(f"  {(s['start'] - t0) * 1e3:9.3f}ms "
              f"+{s['dur'] * 1e3:8.3f}ms  {s['daemon']:<10} "
              f"{s['name']}")


def cmd_live_top(asok_dir: str, args) -> None:
    """`ceph_cli top` — per-daemon op rates over the newest telemetry
    interval + cluster latency quantiles (the r18 time-series plane's
    live view; answered from any monitor's TelemetryAggregator)."""
    t = live_mon_command(asok_dir, "top")
    if args.json:
        print(json.dumps(t, sort_keys=True))
        return
    cl = t.get("cluster") or {}
    ocl = t.get("observed_client_latency") or {}
    print(f"  cluster op latency: p50 {cl.get('p50_ms')}ms  "
          f"p95 {cl.get('p95_ms')}ms  p99 {cl.get('p99_ms')}ms "
          f"({cl.get('count', 0)} samples)")
    print(f"  observed client latency ({ocl.get('source')}): "
          f"p99 {ocl.get('p99_ms')}ms ({ocl.get('count', 0)} samples)")
    if t.get("totals"):
        tot = t["totals"]
        print(f"  {tot.get('ops_in_flight', 0)} ops in flight, "
              f"{tot.get('slow_ops', 0)} slow, "
              f"{tot.get('daemons_reporting', 0)} daemons reporting")
    print(f"  DAEMON      OPS/S   SUBOPS/S   OP-MS-AVG  "
          f"(interval {t.get('interval_s')}s)")
    for name, row in sorted((t.get("daemons") or {}).items()):
        print(f"  {name:<10} {row['ops_per_s']:>7} "
              f"{row['subops_per_s']:>10} {row['op_ms_avg']:>10}")
    # r20: per-tenant mClock accounting — served grants vs limit-bound
    # passes, so the operator sees WHICH tenant is being throttled
    tenants = t.get("tenants") or {}
    if tenants:
        print(f"  TENANT            SERVED      COST  THROTTLED  "
              f"QUEUED  (res/wgt/lim)")
        for ent, row in sorted(tenants.items()):
            prof = row.get("profile") or {}
            print(f"  {ent:<16} {row.get('served', 0):>7} "
                  f"{row.get('served_cost', 0.0):>9} "
                  f"{row.get('throttled', 0):>10} "
                  f"{row.get('queued', 0):>7}  "
                  f"({prof.get('reservation', 0)}/"
                  f"{prof.get('weight', 0)}/{prof.get('limit', 0)})")
    # r19: per-daemon observability drop gauges — sampler ring +
    # flight ring losses are operator-visible, not silent
    obs = t.get("observability") or {}
    prof = obs.get("profiler") or {}
    fdrops = obs.get("flight_dropped_unshipped") or {}
    if prof or fdrops:
        print(f"  DAEMON          HZ   SAMPLES  PROF-DROP  FLIGHT-DROP")
        for name in sorted(set(prof) | set(fdrops)):
            p = prof.get(name) or {}
            print(f"  {name:<10} {p.get('hz', 0):>7} "
                  f"{p.get('samples', 0):>9} "
                  f"{p.get('dropped_unshipped', 0):>10} "
                  f"{fdrops.get(name, 0):>12}")


def cmd_live_flame(asok_dir: str, args) -> None:
    """`ceph_cli flame [daemon]` — the r19 continuous CPU profile:
    span-tagged wall-clock flame profiles folded from every daemon's
    sampling ring over the MgrReport pipe (any monitor's
    ProfileAggregator answers). --collapsed prints folded-stack text
    (flamegraph.pl grain), --speedscope FILE writes a complete
    speedscope JSON document for https://speedscope.app."""
    arg = args.daemon or ""
    if args.speedscope is not None:
        arg = (arg + " --speedscope").strip()
    elif args.collapsed:
        arg = (arg + " --collapsed").strip()
    out = live_mon_command(asok_dir, f"profile cpu {arg}".rstrip())
    if not out.get("found", True):
        raise SystemExit(
            f"flame: no profile for daemon {out.get('daemon')!r} "
            f"(known: {', '.join(out.get('daemons') or []) or 'none'})")
    if args.speedscope is not None:
        with open(args.speedscope, "w") as f:
            json.dump(out["speedscope"], f)
        doc = out["speedscope"]
        print(f"wrote {len(doc['profiles'][0]['samples'])} stacks "
              f"({doc['profiles'][0]['endValue']} samples) to "
              f"{args.speedscope}")
        return
    if args.json:
        print(json.dumps(out, sort_keys=True))
        return
    if args.collapsed:
        for line in out["collapsed"]:
            print(line)
        return
    total = out.get("samples") or 0
    print(f"  {out['daemon']}: {total} samples from "
          f"{len(out.get('daemons') or [])} daemon(s)")
    share = out.get("category_share") or {}
    print("  attribution: " + ", ".join(
        f"{c}={share.get(c, 0.0):.1%}"
        for c in ("queue", "crypto", "encode", "store", "wire",
                  "reactor", "other") if share.get(c)))
    for row in out.get("top_stacks") or []:
        stk = row["stack"]
        if len(stk) > 64:
            stk = "..." + stk[-61:]
        print(f"  {row['samples']:>7}  [{row['category']}] {stk}")
    st = out.get("stats") or {}
    if st:
        print("  DAEMON          HZ   SAMPLES   DROPPED")
        for name, p in sorted(st.items()):
            print(f"  {name:<10} {p.get('hz', 0):>7} "
                  f"{p.get('samples', 0):>9} "
                  f"{p.get('dropped_unshipped', 0):>9}")


def cmd_live_slo(asok_dir: str, args) -> None:
    """`ceph_cli slo` — declared SLO rules with burn-rate windows
    (mgr_slo_rules; SLO_BURN fires on a hot fast window)."""
    s = live_mon_command(asok_dir, "slo")
    if args.json:
        print(json.dumps(s, sort_keys=True))
        return
    rules = s.get("rules") or []
    if not rules:
        print("  (no SLO rules declared — "
              "`config set mgr_slo_rules ...`)")
        return
    print(f"  cluster burn rate: {s.get('burn_rate')}")
    for r in rules:
        state = "BREACH" if r["breach"] else "ok"
        if r.get("full_backoff_active"):
            state += ", FULL-BACKOFF"   # r21: capacity stall, not a
            #                           # slow write path
        print(f"  {r['name']:<24} < {r['threshold_ms']}ms over "
              f"{r['window_s']}s  current={r['current_ms']}ms  "
              f"burn fast={r['burn_fast']} slow={r['burn_slow']}  "
              f"[{state}]")
    for reg in s.get("regressions") or []:
        print(f"  LATENCY_REGRESSION {reg['feed']}: p99 "
              f"{reg['current_p99_ms']}ms = {reg['factor']}x "
              f"baseline {reg['baseline_p99_ms']}ms")
    for name, row in sorted((s.get("full_backoff") or {}).items()):
        print(f"  full-backoff {name}: {row['count']} parked op(s), "
              f"{row['total_s']}s total")


def cmd_live_df(asok_dir: str, args) -> None:
    """`ceph_cli df` (live) — the r21 capacity plane from any
    monitor's committed map + MgrReport statfs claims: per-OSD
    usage with its ladder state (nearfull/backfillfull/full), the
    cluster FULL flag, and per-pool usage against quotas."""
    d = live_mon_command(asok_dir, "df")
    if args.json:
        print(json.dumps(d, sort_keys=True))
        return
    r = d.get("full_ratios") or {}
    print(f"  epoch {d.get('epoch')}  cluster_full="
          f"{d.get('cluster_full')}  ratios nearfull="
          f"{r.get('nearfull')} backfillfull={r.get('backfillfull')} "
          f"full={r.get('full')} failsafe={r.get('failsafe')}")
    print(f"  RAW: {d.get('total_used_bytes')} / "
          f"{d.get('total_bytes')} B used "
          f"({d.get('total_avail_bytes')} B avail)")
    print("  OSD        TOTAL(B)     USED(B)    AVAIL(B)  RATIO  "
          "STATE")
    for name, o in sorted((d.get("osds") or {}).items()):
        ratio = o.get("ratio")
        print(f"  {name:<8} {o.get('total', 0):>11} "
              f"{o.get('used', 0):>11} {o.get('avail', 0):>11} "
              f"{ratio if ratio is None else format(ratio, '.3f'):>6}"
              f"  {o.get('state', 'ok')}")
    pools = d.get("pools") or {}
    if pools:
        print("  POOL  BYTES      OBJECTS  QUOTA-BYTES  QUOTA-OBJS  "
              "FULL")
        for pid, p in sorted(pools.items()):
            print(f"  {pid:<5} {p.get('bytes', 0):<10} "
                  f"{p.get('objects', 0):<8} "
                  f"{p.get('quota_max_bytes', 0):<12} "
                  f"{p.get('quota_max_objects', 0):<11} "
                  f"{p.get('full', False)}")


def cmd_live_netstat(asok_dir: str, args) -> None:
    """`ceph_cli netstat` — the r22 network observability plane from
    any monitor: the per-link RTT matrix (worst EWMA first), the
    slow-link verdicts against the live threshold, and cluster flow
    totals."""
    n = live_mon_command(asok_dir, "dump_osd_network")
    if args.json:
        print(json.dumps(n, sort_keys=True))
        return
    print(f"  threshold {n.get('threshold_ms')}ms  "
          f"{n.get('daemons_reporting')} daemon(s) reporting  "
          f"{n.get('links_total')} link(s)"
          + (f"  ({n.get('links_dropped')} dropped from view)"
             if n.get("links_dropped") else ""))
    print("  FROM       TO         CHAN   EWMA(ms)   P99(ms)   "
          "MAX(ms)  COUNT")
    for r in n.get("links") or []:
        print(f"  {r['from']:<10} {r['to']:<10} {r['channel']:<6} "
              f"{r['ewma_ms']:>8.3f} {r.get('p99_ms', 0.0):>9.3f} "
              f"{r['max_ms']:>9.3f} {r['count']:>6}")
    for r in n.get("slow") or []:
        print(f"  SLOW: {r['from']} -> {r['to']} ({r['channel']}): "
              f"ewma {r['ewma_ms']}ms > {r['threshold_ms']}ms")
    f = n.get("flow_totals") or {}
    print(f"  flow: tx {f.get('bytes_tx', 0)} B / "
          f"{f.get('frames_tx', 0)} frames, rx {f.get('bytes_rx', 0)} "
          f"B / {f.get('frames_rx', 0)} frames, "
          f"{f.get('stalls', 0)} stall(s) "
          f"({f.get('stall_time_s', 0.0)}s), queued "
          f"{f.get('writeq_bytes', 0)} B")


def cmd_live_profile(asok_dir: str, args) -> None:
    """`ceph_cli profile` — the continuous critical-path profile:
    per-interval queue/crypto/encode/store/wire self-time shares of
    the sampled traces (attribution drift as a time-series)."""
    p = live_mon_command(asok_dir, "profile")
    if args.json:
        print(json.dumps(p, sort_keys=True))
        return
    ivs = p.get("intervals") or []
    if not ivs:
        print("  (no sampled traces folded yet)")
        return
    cats = ("queue", "crypto", "encode", "store", "wire", "other")
    print(f"  interval {p['interval_s']}s; shares per category:")
    print("  BUCKET      TRACES  " + "  ".join(f"{c:>7}" for c in cats))
    for iv in ivs:
        shares = "  ".join(f"{iv['share'].get(c, 0.0):>7.2%}"
                           for c in cats)
        print(f"  {iv['bucket']:<11} {iv['traces']:>6}  {shares}")


def build_cluster(name: str, n_osds: int, pg_num: int, device):
    from ..osd.cluster import SimCluster
    c = SimCluster(n_osds=n_osds, pg_num=pg_num,
                   profile=pool_profile(device),
                   heartbeat_grace=20.0, down_out_interval=60.0,
                   device=device)
    rng = np.random.default_rng(0)
    objs = {f"obj-{i}": rng.integers(0, 256, 600, np.uint8)
            for i in range(4 * pg_num)}
    c.write(objs)
    if name == "osd-failure":
        c.kill_osd(c.pgs[0].acting[0])
        c.tick(30)
        c.tick(90)
        c.tick(30)
    elif name == "mon-loss":
        c.kill_mon(1)
        c.kill_mon(2)
        c.kill_osd(c.pgs[0].acting[0])
        c.tick(30)  # failure observed, map frozen (no quorum)
    elif name == "backfill":
        c.backfill_rate = 1
        victim = c.pgs[0].acting[0]
        c.kill_osd(victim)
        c.tick(30)
        c.tick(90)
        c.revive_osd(victim)
        c.tick(6)
    return c


def cmd_status(c, args) -> None:
    h = c.health()
    states: dict[str, int] = {}
    for s in h["pg_states"].values():
        states[s] = states.get(s, 0) + 1
    if args.json:
        print(json.dumps(h | {"pg_state_counts": states}, default=str))
        return
    q = h["mon_quorum"]
    healthy = not h["pgs_degraded"] and not h["pgs_down"] and q
    mon_line = (f"quorum {q}, leader mon.{h['mon_leader']}"
                if q is not None else "quorum NONE (no majority!)")
    print("  cluster:")
    print(f"    health: {'HEALTH_OK' if healthy else 'HEALTH_WARN'}")
    print("  services:")
    print(f"    mon: {len(c.mons.mons)} monitors, {mon_line}")
    print(f"    osd: {len(c.alive)} osds: {h['osds_up']} up, "
          f"{int((c.osdmap.osd_weight > 0).sum())} in (epoch {h['epoch']})")
    print("  data:")
    print(f"    pgs: " + ", ".join(f"{n} {s}"
                                   for s, n in sorted(states.items())))
    if h["pgs_backfilling"]:
        print(f"    backfilling: {h['pgs_backfilling']} pgs")


def cmd_health(c, args) -> None:
    h = c.health()
    ok = (not h["pgs_degraded"] and not h["pgs_down"]
          and h["mon_quorum"] is not None)
    if args.json:
        print(json.dumps({"status": "HEALTH_OK" if ok else "HEALTH_WARN"}))
        return
    print("HEALTH_OK" if ok else "HEALTH_WARN")
    if h["mon_quorum"] is None:
        print("  MON_DOWN: monitors have no quorum; cluster map frozen")
    if h["pgs_degraded"]:
        print(f"  PG_DEGRADED: {h['pgs_degraded']} pgs degraded")
    if h["pgs_down"]:
        print(f"  PG_AVAILABILITY: {h['pgs_down']} pgs down/incomplete")


def cmd_pg_stat(c, args) -> None:
    h = c.health()
    if args.json:
        print(json.dumps({str(k): v for k, v in h["pg_states"].items()}))
        return
    for ps, state in sorted(h["pg_states"].items()):
        be = c.pgs[ps]
        print(f"  1.{ps}  {state:<28} acting {be.acting} "
              f"objects {len(be.object_sizes)}")


def cmd_df(c, args) -> None:
    """`ceph df` — logical vs raw usage with EC/replication
    amplification (ref: src/mon/PGMap.cc dump_pool_stats_full)."""
    d = c.df()
    if args.json:
        print(json.dumps(d, sort_keys=True))
        return
    cl = d["cluster"]
    print(f"  cluster: {cl['osds']} osds ({cl['osds_in']} in), "
          f"{cl['bytes_used_raw']} B raw used")
    print("  POOL     ID  OBJECTS  CLONES  USED(B)  RAW(B)  AMP")
    for name, p in d["pools"].items():
        print(f"  {name:<8} {p['id']:<3} {p['objects']:<8} "
              f"{p['snap_clones']:<7} {p['bytes_used']:<8} "
              f"{p['bytes_raw']:<7} {p['amplification']}x")


def cmd_osd_df(c, args) -> None:
    """`ceph osd df` — per-OSD weight, up/in state, and PG slot
    counts (ref: OSDMonitor 'osd df' via PGMap per-osd stats)."""
    n = len(c.alive)
    slots = {o: 0 for o in range(n)}
    for ps in range(c.pg_num):
        for osd in c.pgs[ps].acting:
            if 0 <= osd < n:
                slots[osd] += 1
    rows = []
    for o in range(n):
        rows.append({"osd": o,
                     "weight": round(float(c.osdmap.osd_weight[o])
                                     / 0x10000, 4),
                     "up": bool(c.osdmap.osd_up[o]),
                     "in": bool(c.osdmap.osd_weight[o] > 0),
                     "pg_slots": slots[o]})
    if args.json:
        print(json.dumps(rows))
        return
    print("  OSD  WEIGHT  UP     IN     PG-SLOTS")
    for r in rows:
        print(f"  {r['osd']:<4} {r['weight']:<7} "
              f"{str(r['up']):<6} {str(r['in']):<6} {r['pg_slots']}")
    mean = sum(slots.values()) / max(1, n)
    print(f"  mean pg-slots/osd: {mean:.1f}")


def cmd_perf_dump(c, args) -> None:
    print(json.dumps({"cluster": c.perf.dump()}, indent=None if args.json
                     else 2, sort_keys=True))


def cmd_prometheus(c, args) -> None:
    from ..utils.perf_counters import PerfCountersCollection
    coll = PerfCountersCollection()
    coll.add(c.perf)
    sys.stdout.write(coll.prometheus_text())


def cmd_tier(c, args) -> None:
    """The `osd tier add / cache-mode writeback / set-overlay`
    workflow end to end: overlay a replicated cache pool on the
    scenario's base pool, drive I/O through it, show the agent's
    flush/evict behavior and the drain (ref: src/mon/OSDMonitor.cc
    tier commands + PrimaryLogPG agent_work)."""
    import numpy as np
    from ..osd.cachetier import CacheTier
    from ..osd.cluster import SimCluster
    cache = SimCluster(n_osds=4, pg_num=2, profile="replicated size=2",
                       device=c.device)
    tier = CacheTier(c, cache,
                     target_max_bytes=args.target_max_bytes,
                     dirty_ratio=0.4, full_ratio=0.8)
    print(f"tier: cache pool (replicated x2) overlaying base "
          f"(writeback, target_max_bytes={args.target_max_bytes})")
    rng = np.random.default_rng(0)
    objs = {f"tiered-{i}": rng.integers(0, 256, 800, np.uint8)
            for i in range(args.objects)}
    tier.write(objs)
    for name, want in objs.items():
        got = np.asarray(tier.read(name)) if name in tier._size \
            else np.asarray(c.read(name))
        assert (got == want).all(), name
    s = tier.stats()
    print(f"  after {args.objects} writes + reads: "
          f"{s['objects']} cached / {s['cache_bytes']}B "
          f"({s['dirty_bytes']}B dirty), "
          f"flushed={s['tier_flush']} evicted={s['tier_evict']} "
          f"hits={s['tier_hit']}")
    tier.flush_evict_all()
    s = tier.stats()
    print(f"  cache-flush-evict-all: {s['objects']} cached, every "
          f"byte on the base tier")
    for name, want in objs.items():
        assert (np.asarray(c.read(name)) == want).all(), name
    print("  verified: all objects bit-exact from base after drain")


def cmd_config(c, args) -> None:
    from ..mon.monitor import NoQuorum
    try:
        _cmd_config(c, args)
    except NoQuorum as e:
        raise SystemExit(f"Error: no monitor quorum ({e})")
    except ValueError as e:
        raise SystemExit(f"Error: {e}")


def _cmd_config(c, args) -> None:
    if args.action == "set":
        if args.value is None:
            raise SystemExit("config set needs <name> <value>")
        c.config_set(args.name, args.value)
        print(f"set {args.name} = {args.value} "
              f"(mon kv v{c.mons.version()})")
    elif args.action == "get":
        dump = c.mons.config_dump()
        if args.name not in dump:
            raise SystemExit(f"no config value {args.name!r}")
        print(dump[args.name])
    else:  # dump
        print(json.dumps(c.mons.config_dump(), sort_keys=True))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", default="healthy", choices=SCENARIOS)
    ap.add_argument("--num-osds", type=int, default=12)
    ap.add_argument("--pg-num", type=int, default=8)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--asok-dir", default=None,
                    help="LIVE mode: a running standalone cluster's "
                         "admin-socket dir (its .admin_dir); status/"
                         "health/prometheus/perf/pg answer from the "
                         "monitors' MgrReport aggregate instead of a "
                         "hermetic scenario")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("status")
    hp = sub.add_parser("health")
    hp.add_argument("detail", nargs="?", choices=["detail"])
    dm = sub.add_parser(
        "daemon", help="LIVE mode: `ceph daemon <name> <cmd>` against "
                       "one daemon's admin socket")
    dm.add_argument("name", help="daemon name, e.g. osd.0 / mon.1")
    dm.add_argument("daemon_cmd", nargs=argparse.REMAINDER,
                    help="command words, e.g. perf dump")
    tr = sub.add_parser(
        "trace", help="LIVE mode: assembled distributed traces from "
                      "the monitors' span aggregation — `trace slow` "
                      "(slowest traces + critical-path attribution), "
                      "`trace list`, or `trace <id-hex>` (one causal "
                      "timeline; --chrome FILE exports Chrome "
                      "trace-event JSON for chrome://tracing)")
    tr.add_argument("trace_arg", nargs="?", default="slow",
                    help="slow | list | <trace-id-hex>")
    tr.add_argument("--chrome", metavar="FILE", default=None,
                    help="write the trace's Chrome trace-event JSON "
                         "to FILE (requires a trace id)")
    sub.add_parser(
        "top", help="LIVE mode: per-daemon op rates + cluster latency "
                    "quantiles from the r18 telemetry plane")
    sub.add_parser(
        "slo", help="LIVE mode: declared SLO rules with burn-rate "
                    "windows (mgr_slo_rules)")
    sub.add_parser(
        "profile", help="LIVE mode: continuous critical-path profile "
                        "(per-interval attribution shares of sampled "
                        "traces)")
    fl = sub.add_parser(
        "flame", help="LIVE mode: r19 continuous CPU flame profiles "
                      "(span-tagged wall-clock samples folded from "
                      "every daemon's sampling ring); --collapsed "
                      "prints folded-stack text, --speedscope FILE "
                      "writes speedscope JSON")
    fl.add_argument("daemon", nargs="?", default=None,
                    help="one daemon's profile (default: cluster "
                         "fold)")
    fl.add_argument("--collapsed", action="store_true",
                    help="folded-stack text (flamegraph.pl input)")
    fl.add_argument("--speedscope", metavar="FILE", default=None,
                    help="write a speedscope JSON document to FILE")
    sub.add_parser(
        "telemetry", help="LIVE mode: raw telemetry dump (series + "
                          "merged quantiles + SLO verdicts)")
    sub.add_parser(
        "netstat", help="LIVE mode: r22 per-link RTT matrix, "
                        "slow-link verdicts and cluster flow totals "
                        "from the monitors' network aggregate")
    sub.add_parser("df")
    sub.add_parser("osd-df")
    pg = sub.add_parser("pg")
    pg.add_argument("pg_cmd", choices=["stat"])
    perf = sub.add_parser("perf")
    perf.add_argument("perf_cmd", choices=["dump"])
    sub.add_parser("prometheus")
    sub.add_parser("autoscale-status")
    sub.add_parser("balancer")
    tier = sub.add_parser(
        "tier", help="cache-tier demo (osd tier add/cache-mode/"
                     "set-overlay workflow, run end to end)")
    tier.add_argument("--objects", type=int, default=24)
    tier.add_argument("--target-max-bytes", type=int, default=16384)
    cfg = sub.add_parser("config")
    cfg.add_argument("action", choices=["set", "get", "dump"])
    cfg.add_argument("name", nargs="?")
    cfg.add_argument("value", nargs="?")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = _device(args)

    if args.cmd in ("daemon", "trace", "top", "slo", "profile",
                    "flame", "telemetry", "netstat") \
            and not args.asok_dir:
        raise SystemExit(f"`{args.cmd}` needs --asok-dir (live mode "
                         f"only)")
    if args.asok_dir:
        # LIVE mode: no hermetic cluster — answer over admin sockets
        if args.cmd == "status":
            cmd_live_status(args.asok_dir, args)
        elif args.cmd == "health":
            cmd_live_health(args.asok_dir, args,
                            detail=args.detail == "detail")
        elif args.cmd == "prometheus":
            sys.stdout.write(
                live_mon_command(args.asok_dir, "prometheus")["text"])
        elif args.cmd == "perf":
            print(json.dumps(live_mon_command(args.asok_dir,
                                              "perf dump"),
                             indent=None if args.json else 2,
                             sort_keys=True))
        elif args.cmd == "pg":
            daemons = live_mon_command(args.asok_dir, "report dump")
            pgs: dict = {}
            for ent in sorted(daemons.values(),
                              key=lambda e: e.get("epoch", 0)):
                pgs.update(ent.get("pgs") or {})
            if args.json:
                print(json.dumps(pgs, sort_keys=True))
            else:
                for pgid, state in sorted(pgs.items()):
                    print(f"  {pgid}  {state}")
        elif args.cmd == "daemon":
            out = live_daemon_command(args.asok_dir, args.name,
                                      " ".join(args.daemon_cmd))
            print(json.dumps(out, indent=None if args.json else 2,
                             sort_keys=True))
        elif args.cmd == "trace":
            cmd_live_trace(args.asok_dir, args)
        elif args.cmd == "top":
            cmd_live_top(args.asok_dir, args)
        elif args.cmd == "slo":
            cmd_live_slo(args.asok_dir, args)
        elif args.cmd == "df":
            cmd_live_df(args.asok_dir, args)
        elif args.cmd == "profile":
            cmd_live_profile(args.asok_dir, args)
        elif args.cmd == "flame":
            cmd_live_flame(args.asok_dir, args)
        elif args.cmd == "netstat":
            cmd_live_netstat(args.asok_dir, args)
        elif args.cmd == "telemetry":
            print(json.dumps(live_mon_command(args.asok_dir,
                                              "telemetry"),
                             indent=None if args.json else 2,
                             sort_keys=True))
        else:
            raise SystemExit(f"{args.cmd!r} has no live-mode "
                             f"implementation; drop --asok-dir")
        return

    c = build_cluster(args.scenario, args.num_osds, args.pg_num, device)
    if args.cmd == "status":
        cmd_status(c, args)
    elif args.cmd == "health":
        cmd_health(c, args)
    elif args.cmd == "df":
        cmd_df(c, args)
    elif args.cmd == "osd-df":
        cmd_osd_df(c, args)
    elif args.cmd == "pg":
        cmd_pg_stat(c, args)
    elif args.cmd == "perf":
        cmd_perf_dump(c, args)
    elif args.cmd == "prometheus":
        cmd_prometheus(c, args)
    elif args.cmd == "tier":
        cmd_tier(c, args)
    elif args.cmd == "autoscale-status":
        from ..mgr.pg_autoscaler import autoscale_status
        rows = autoscale_status(c.osdmap)
        if args.json:
            print(json.dumps(rows))
        else:
            for r in rows:
                print(f"  pool {r['pool_id']}: pg_num "
                      f"{r['pg_num_current']} -> recommend "
                      f"{r['pg_num_recommended']} "
                      f"({'ADJUST' if r['would_adjust'] else 'ok'}; "
                      f"{r['reason']})")
    elif args.cmd == "balancer":
        import numpy as np
        from ..mgr.balancer import calc_pg_upmaps, device_load
        in_mask = np.asarray(c.osdmap.osd_weight) > 0  # out osds are 0
        before = device_load(c.osdmap, 1)[in_mask]
        moves = calc_pg_upmaps(c.osdmap, 1, max_optimizations=100)
        after = device_load(c.osdmap, 1)[in_mask]
        if moves:
            c._repeer_all()  # upmapped PGs start pg_temp backfills
        result = {"moves": len(moves),
                  "spread_before": int(before.max() - before.min()),
                  "spread_after": int(after.max() - after.min()),
                  "backfills_started": len(c.backfills)}
        if args.json:
            print(json.dumps(result))
        else:
            print(f"  {result['moves']} upmap move(s); per-osd pg "
                  f"spread {result['spread_before']} -> "
                  f"{result['spread_after']}; "
                  f"{result['backfills_started']} backfill(s) started")
    elif args.cmd == "config":
        if args.action in ("set", "get") and not args.name:
            raise SystemExit(f"config {args.action} needs a name")
        cmd_config(c, args)


if __name__ == "__main__":
    main()
