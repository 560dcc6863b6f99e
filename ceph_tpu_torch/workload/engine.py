"""Workload engine — N tenants driving the block path live (r20).

Executes pre-generated per-tenant op streams (streams.py) against a
live cluster, one wire client per cephx tenant entity, one pacing
thread per tenant. The routing contract from the profile grammar:
small overwrites go through `write_at` (the r16 parity-delta RMW
path), log-style writes through `append` (the no-preread tail path),
streaming writes through whole-object `write` (full-stripe encode).

Mid-run faults are the CALLER's job (kill_osd from the bench/test,
the thrasher menu from tools/thrash.py) — the engine just keeps
pacing, counts errors per tenant instead of dying, and timestamps
every completion so latency splits around a fault are computable
after the fact.

Per-tenant attribution read-back:
  - `ingest_clients(tagg)` ships each tenant's client-observed
    latency histogram into the r18 TelemetryAggregator under its
    tenant label (the feed tenant-qualified SLO rules evaluate on);
  - `fold_tenant_mclock(cluster)` folds every live OSD's sched_dump
    `tenant:*` rows into per-entity grant/queue/THROTTLE totals (the
    r20 limit-bound attribution — which tenant mClock is holding
    back, not just who is slow).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from .profiles import TenantProfile
from .streams import Op, OpStream, payload_for


def percentiles(lat: list[float]) -> dict:
    """Same shape as tools/rados_bench.py:percentiles (kept local so
    the package never imports from tools/)."""
    if not lat:
        return {}
    a = np.sort(np.asarray(lat))
    pick = lambda q: float(a[min(len(a) - 1, int(q * len(a)))])  # noqa: E731
    return {"p50_ms": round(pick(0.50) * 1e3, 3),
            "p95_ms": round(pick(0.95) * 1e3, 3),
            "p99_ms": round(pick(0.99) * 1e3, 3),
            "p999_ms": round(pick(0.999) * 1e3, 3),
            "max_ms": round(float(a[-1]) * 1e3, 3)}


class _TenantState:
    __slots__ = ("profile", "entity", "client", "ops", "payload",
                 "lat", "stamps", "errors", "digest", "routed")

    def __init__(self, profile: TenantProfile):
        self.profile = profile
        self.entity = profile.entity
        self.client = None
        self.ops: list[Op] = []
        self.payload = b""
        self.lat: list[float] = []
        self.stamps: list[float] = []
        self.errors = 0
        self.digest = ""
        self.routed: dict = {}


# op failures during an injected fault window count, not raise — the
# same tolerance set the benches use around --recovery-kill
_FAULT_ERRORS = (ConnectionError, OSError, RuntimeError, KeyError)


class WorkloadEngine:
    """Drive tenant profiles against a live StandaloneCluster."""

    def __init__(self, cluster, profiles: list[TenantProfile],
                 seed: int = 0, duration_s: float = 5.0):
        if not profiles:
            raise ValueError("workload engine needs >= 1 profile")
        self.c = cluster
        self.profiles = list(profiles)
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.tenants: dict[str, _TenantState] = {}
        self._t0 = 0.0
        self.elapsed = 0.0

    # -- declarative -> cluster state -----------------------------------------

    def mclock_tenant_table(self) -> str:
        """osd_mclock_scheduler_tenant_profiles value for every
        profile that pins a QoS class ('' when none do)."""
        return ";".join(f"{p.entity}={p.mclock}"
                        for p in self.profiles if p.mclock)

    def slo_rule_text(self) -> str:
        """Tenant-qualified mgr_slo_rules text: each profile's rule
        fragment suffixed with its `[tenant=...]` qualifier (the r20
        grammar extension)."""
        return ";".join(f"{p.slo} [tenant={p.entity}]"
                        for p in self.profiles if p.slo)

    def setup(self) -> None:
        """Create one cephx entity + wire client per tenant, commit
        the mClock tenant table, stage each tenant's object
        namespace, and generate (+digest) every op stream."""
        table = self.mclock_tenant_table()
        admin = self.c.client()
        if table:
            admin.config_set("osd_mclock_scheduler_tenant_profiles",
                             table)
        for p in self.profiles:
            st = _TenantState(p)
            if getattr(self.c, "key_server", None) is not None:
                sec = self.c.create_entity(
                    p.entity, caps={"mon": "allow r",
                                    "osd": "allow rwx"})
                st.client = self.c.client(entity=p.entity,
                                          secret=sec)
            else:
                st.client = self.c.client()
                st.entity = st.client.msgr.name
            st.payload = payload_for(p, self.seed)
            # stage the overwrite/read namespace at full object size
            # (append streams grow their own `wls-` objects from
            # empty, so every append lands on the no-preread path)
            staged = st.payload[:p.object_size]
            st.client.write({self._obj(p, i): staged
                             for i in range(p.objects)})
            stream = OpStream(p, self.seed)
            st.ops = stream.generate(self.duration_s)
            st.digest = OpStream.digest(st.ops)
            st.routed = OpStream.routed_counts(st.ops)
            self.tenants[p.name] = st

    @staticmethod
    def _obj(p: TenantProfile, i: int) -> str:
        return f"wl-{p.name}-{i}"

    @staticmethod
    def _stream_obj(p: TenantProfile, i: int) -> str:
        return f"wls-{p.name}-{i}"

    # -- execution ------------------------------------------------------------

    def _run_tenant(self, st: _TenantState, start: threading.Event):
        p, cl = st.profile, st.client
        start.wait()
        t0 = self._t0
        for op in st.ops:
            delay = t0 + op.t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            ts = time.perf_counter()
            try:
                if op.kind == "read":
                    cl.read(self._obj(p, op.obj))
                elif op.kind == "write_at":
                    cl.write_at(self._obj(p, op.obj), op.offset,
                                st.payload[:op.size])
                elif op.kind == "append":
                    cl.append(self._stream_obj(p, op.obj),
                              st.payload[:op.size])
                else:       # write_full: full-stripe streaming write
                    cl.write({self._obj(p, op.obj):
                              st.payload[:p.object_size]})
            except _FAULT_ERRORS:
                # op raced a fault window (dead primary, map lag):
                # real clients retry; the engine counts and paces on
                st.errors += 1
                continue
            done = time.perf_counter()
            st.lat.append(done - ts)
            st.stamps.append(done)

    def run(self, tick=None, tick_interval: float = 0.5) -> None:
        """Run every tenant to stream completion. `tick()` (optional)
        fires every `tick_interval` seconds on its own thread while
        tenants run — the bench/test hook that ships per-tenant
        client histograms into telemetry at interval cadence."""
        start = threading.Event()
        threads = [threading.Thread(target=self._run_tenant,
                                    args=(st, start), daemon=True)
                   for st in self.tenants.values()]
        for th in threads:
            th.start()
        stop = threading.Event()
        ticker = None
        if tick is not None:
            def _tick_loop():
                while not stop.wait(tick_interval):
                    try:
                        tick()
                    except Exception:   # noqa: BLE001 — a tick racing
                        pass            # a dying daemon never kills IO
            ticker = threading.Thread(target=_tick_loop, daemon=True)
            ticker.start()
        self._t0 = time.perf_counter()
        start.set()
        for th in threads:
            th.join()
        self.elapsed = time.perf_counter() - self._t0
        stop.set()
        if ticker is not None:
            ticker.join(timeout=2.0)
        if tick is not None:
            try:
                tick()      # one closing tick so short runs still
            except Exception:   # noqa: BLE001 — see above
                pass            # land their final interval point

    # -- attribution read-back ------------------------------------------------

    def ingest_clients(self, tagg) -> None:
        """Ship every tenant's client-observed latency histogram into
        the TelemetryAggregator under its tenant label — the feed the
        `[tenant=...]`-qualified SLO rules evaluate against."""
        for st in self.tenants.values():
            tagg.ingest_client(st.client.msgr.name,
                               st.client.perf.dump(),
                               tenant=st.entity)

    @staticmethod
    def fold_tenant_mclock(cluster) -> dict:
        """Per-entity mClock occupancy summed over live daemons'
        sched_dump `tenant:*` rows: queued / served / served_cost /
        THROTTLED (limit-bound dequeue skips) + the committed
        profile. The same fold MgrReportAggregator.tenants() serves
        over the report pipe — read directly here so a bench isn't
        gated on report cadence."""
        out: dict[str, dict] = {}
        for d in cluster.osds.values():
            if d._stop.is_set():
                continue
            try:
                dump = d.sched_dump()
            except Exception:   # noqa: BLE001 — dying daemon drops out
                continue
            for cname, row in dump.items():
                if not cname.startswith("tenant:"):
                    continue
                ent = cname[len("tenant:"):]
                cur = out.setdefault(ent, {
                    "queued": 0, "served": 0, "served_cost": 0.0,
                    "throttled": 0, "profile": row.get("profile")})
                cur["queued"] += row.get("queued", 0)
                cur["served"] += row.get("served", 0)
                cur["served_cost"] += row.get("served_cost", 0.0)
                cur["throttled"] += row.get("throttled", 0)
                if row.get("profile"):
                    cur["profile"] = row["profile"]
        for row in out.values():
            row["served_cost"] = round(row["served_cost"], 3)
        return out

    def results(self, killed_at: float | None = None) -> dict:
        """Per-tenant outcome block: routed op counts, completion/
        error totals, latency percentiles — split pre/post a fault
        timestamp when one is given."""
        out = {}
        for st in self.tenants.values():
            row = {
                "entity": st.entity,
                "klass": st.profile.klass,
                "stream_ops": len(st.ops),
                "ops": len(st.lat),
                "errors": st.errors,
                "routed": st.routed,
                "digest": st.digest,
                **percentiles(st.lat),
            }
            if killed_at is not None:
                pre = [v for t, v in zip(st.stamps, st.lat)
                       if t < killed_at]
                post = [v for t, v in zip(st.stamps, st.lat)
                        if t >= killed_at]
                row["pre_kill"] = percentiles(pre)
                row["post_kill"] = percentiles(post)
            out[st.profile.name] = row
        return out
