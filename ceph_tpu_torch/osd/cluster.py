"""SimCluster — hermetic multi-OSD cluster with failure detection.

Twin of ceph_tpu/osd/cluster.py: the reference's elastic-recovery loop,
in-process (refs:
heartbeats src/osd/OSD.cc handle_osd_ping/maybe_update_heartbeat_peers
with osd_heartbeat_grace; failure reports -> OSDMonitor::prepare_failure
marking down, mon_osd_down_out_interval auto-out (src/mon/OSDMonitor.cc);
map-change re-peering src/osd/PeeringState.cc choose_acting/activate;
the standalone many-daemons-one-host test pattern qa/standalone/
ceph-helpers.sh). The reference's teuthology Thrasher (qa/tasks/
ceph_manager.py) is mirrored by tests/test_cluster.py's
thrash-under-io property test.

Everything runs on a VIRTUAL clock — tick(dt) advances time, delivers
heartbeats, expires grace windows, applies down/out transitions, and
drives recovery — so failure/recovery scenarios are deterministic and
fast. Data lives in MemStores (one per OSD); each PG is a mini-
ECBackend (or ReplicatedBackend) whose acting set tracks the OSDMap.

Every encode, decode, CRC and batched placement runs on the cluster's
device: `device=None` is the CUDA device and raises without one; the
CPU is used only when asked for (`device="cpu"`). The device reaches
the OSDMap's mapper, every PG backend, and the coder that sizes the
pool. `store="tin"` keeps each OSD's shards in a persistent TinStore
under `store_dir` (a new temporary directory when None): kill_osd
drops its RAM state, revive_osd remounts it from its WAL and segments.
"""

from __future__ import annotations

import numpy as np

from ..crush.map import (CRUSH_ITEM_NONE, Tunables, build_hierarchy, ec_rule,
                         replicated_rule)
from ..ec.interface import resolve_device
from ..utils.log import g_log
from ..utils.perf_counters import PerfCountersBuilder
from .ecbackend import ECBackend, ShardSet
from .osdmap import OSDMap, PGPool
from .pgbackend import PGBackend, ReplicatedBackend


class StaleMap(Exception):
    """Op addressed to the wrong/unreachable primary — the OSD's
    'I have a newer map' reply (the client must refresh and resend)."""

    def __init__(self, epoch: int, why: str):
        super().__init__(f"stale map (cluster at epoch {epoch}): {why}")
        self.epoch = epoch


class SimCluster:
    """n_osds OSDs, one EC pool, pg_num PGs, virtual-time failure
    handling."""

    def __init__(self, n_osds: int = 12, profile: str | dict =
                 "plugin=tpu_rs k=4 m=2 impl=bitlinear",
                 pg_num: int = 8, osds_per_host: int = 1,
                 chunk_size: int = 256,
                 heartbeat_interval: float = 6.0,
                 heartbeat_grace: float = 20.0,
                 down_out_interval: float = 600.0,
                 min_down_reporters: int = 2,
                 n_mons: int = 3,
                 hosts_per_rack: int | None = None,
                 store: str = "mem",
                 store_dir: str | None = None,
                 store_compression: str | None = None,
                 device=None):
        self.device = resolve_device(device)
        if hosts_per_rack is None:
            hosts_per_rack = max(4, n_osds)  # one big rack by default
        crush = build_hierarchy(n_osds, osds_per_host=osds_per_host,
                                hosts_per_rack=hosts_per_rack)
        # the reference default (51): plenty of retry headroom once
        # several OSDs are out; the vectorized mapper's while_loop
        # early-exits, so unused rounds cost nothing
        crush.tunables = Tunables(choose_total_tries=51)
        self.osdmap = OSDMap(crush, device=self.device)
        self.cluster = ShardSet()
        # store backend switch (the store_test.cc parameterization):
        # "mem" = RAM MemStore (process death keeps bytes by fiat);
        # "tin" = persistent TinStore (kill really drops RAM and revive
        # really recovers from WAL+checkpoint — measured, not assumed)
        if store not in ("mem", "tin"):
            raise ValueError(f"store={store!r} not in ('mem', 'tin')")
        if store_compression is not None:
            from .tinstore import TinStore
            if store != "tin":
                raise ValueError("store_compression requires "
                                 "store='tin' (MemStore never "
                                 "compresses — a silent no-op would "
                                 "fake a compressed-path test)")
            if store_compression not in TinStore.COMPRESSION_ALGS:
                raise ValueError(
                    f"unknown store_compression "
                    f"{store_compression!r}; use one of "
                    f"{TinStore.COMPRESSION_ALGS}")
        self.store_kind = store
        self.store_dir = store_dir
        if store == "tin":
            import os as _os
            import tempfile
            from .tinstore import TinStore
            if store_dir is None:
                self.store_dir = tempfile.mkdtemp(prefix="tinstore-")
            # verify_reads off INSIDE the cluster: shard integrity is
            # the backend's hinfo CRC layer (verify-on-read + EIO
            # reconstruct), which must see rotten bytes to repair them;
            # TinStore still verifies every object at mount/fsck
            # cache_bytes is deliberately TINY: sim datasets are small,
            # and a cache several times smaller than the working set
            # keeps the chaos/recovery suites exercising the eviction +
            # device-read path, not an accidental RAM mirror
            self.cluster.store_factory = lambda o: TinStore(
                _os.path.join(self.store_dir, f"osd.{o}"),
                verify_reads=False, cache_bytes=32 << 10,
                compression=store_compression,
                # sim-scale blobs are far below the production 4 KiB
                # floor; compress anything that plausibly shrinks
                compression_min_blob=64)
        self.profile = profile
        # pool type switch (ref: pg_pool_t TYPE_REPLICATED vs
        # TYPE_ERASURE; PrimaryLogPG drives either through PGBackend):
        # profile "replicated size=3 [min_size=2]" makes a replicated
        # pool; anything else is an EC profile string
        from ..ec.interface import profile_from_string
        if isinstance(profile, str):
            toks = profile.split()
            if toks and toks[0] == "replicated":  # "replicated size=3"
                prof = {"plugin": "replicated",
                        **profile_from_string(" ".join(toks[1:]))}
            else:
                prof = profile_from_string(profile)
        else:
            prof = dict(profile)
        self.is_erasure = prof.get("plugin", "") != "replicated"
        # the reference's pool creation consumes crush-failure-domain
        # from the EC profile (ref: OSDMonitor pool create ->
        # CrushWrapper rule from profile); honor the same key
        domains = {"osd": 0, "host": 1, "rack": 2}
        fd = prof.get("crush-failure-domain", "host")
        if fd not in domains:
            raise ValueError(f"crush-failure-domain {fd!r} not in "
                             f"{sorted(domains)}")
        choose_type = domains[fd]
        # the domain must actually exist in enough copies, or every PG
        # would come up short at creation with a confusing error
        n_hosts = -(-n_osds // osds_per_host)
        n_domains = {0: n_osds, 1: n_hosts,
                     2: -(-n_hosts // hosts_per_rack)}[choose_type]
        if self.is_erasure:
            from ..ec.registry import factory
            coder = factory(profile, device=self.device)
            self.pool_size = coder.get_chunk_count()
            self.m = coder.get_coding_chunk_count()
            min_size = self.pool_size - self.m
            ec_rule(crush, 1, choose_type=choose_type)
        else:
            self.pool_size = int(prof.get("size", 3))
            min_size = int(prof.get("min_size",
                                    self.pool_size - self.pool_size // 2))
            self.m = self.pool_size - min_size
            replicated_rule(crush, 1, choose_type=choose_type,
                            firstn=True)
        if n_domains < self.pool_size:
            raise ValueError(
                f"crush-failure-domain={fd}: only {n_domains} "
                f"domain(s) in the topology but the pool needs "
                f"{self.pool_size}; add osds/hosts/racks (e.g. "
                f"hosts_per_rack=) or pick a finer domain")
        self.pool_min_size = min_size
        self.osdmap.add_pool(PGPool(1, pg_num=pg_num, size=self.pool_size,
                                    min_size=min_size,
                                    crush_rule=1,
                                    is_erasure=self.is_erasure))
        self.pg_num = pg_num
        self.chunk_size = chunk_size
        # timing / failure model
        self.now = 0.0
        self.hb_interval = heartbeat_interval
        self.hb_grace = heartbeat_grace
        self.down_out_interval = down_out_interval
        self.min_down_reporters = min_down_reporters
        self.alive = np.ones(n_osds, dtype=bool)      # process up?
        self.destroyed: set[int] = set()              # disk gone for good
        # monitor quorum gates every map mutation (ref: OSDMonitor
        # commits through Paxos; no majority -> the map freezes and
        # failure handling stalls cluster-wide)
        from ..mon.monitor import MonitorCluster, NoQuorum
        self._NoQuorum = NoQuorum
        self.mons = MonitorCluster(n_mons)
        self.last_heard = np.zeros((n_osds, n_osds))  # peer hb stamps
        self.down_since: dict[int, float] = {}
        # async backfill state: ps -> {"moves": [(slot, old, new)],
        # "names": objects still to copy, "queued": names already
        # enqueued on the op scheduler}; while a PG backfills, pg_temp
        # keeps the OLD acting set serving I/O (ref: PeeringState
        # requests pg_temp until backfill completes)
        self.backfills: dict[int, dict] = {}
        # pool snapshots (ref: pg_pool_t snap_seq/snaps; PrimaryLogPG
        # make_writeable copy-on-write clones + SnapSet; snaptrim):
        # clones are REGULAR objects (placed/recovered/scrubbed like
        # any other; divergence from the reference disclosed: they
        # hash to their own PG rather than the head's), metadata here
        self.snap_seq = 0
        self.snaps: dict[int, float] = {}          # id -> ctime
        # self-managed snaps (ref: pg_pool_t FLAG_SELFMANAGED_SNAPS;
        # librados selfmanaged_snap_create + per-op SnapContext): ids
        # share the pool seq space, but COW is driven by the snapc the
        # CLIENT sends with each write, not the pool's own snap list —
        # how RBD gets per-image snapshots out of a shared pool. The
        # two modes are mutually exclusive per pool, as upstream.
        self.sm_snaps: set[int] = set()
        self.selfmanaged = False
        # head -> [(clone seq, birth era)]: a clone covers snaps s
        # with birth < s <= seq (the birth rides with the clone so an
        # object born BETWEEN snaps never phantom-exists at the older
        # one, even after the head is removed or recreated)
        self.snapsets: dict[str, list[tuple[int, int]]] = {}
        self.object_births: dict[str, int] = {}    # head -> seq at create
        # watch/notify registry (ref: PrimaryLogPG watch/notify;
        # Objecter::linger): cookie -> callback per object
        self.watches: dict[str, dict[int, object]] = {}
        self._next_cookie = 1
        # object-class KV plane (ref: cls_* methods' omap usage)
        self.obj_kv: dict[str, dict] = {}
        # mClock op scheduler paces background work (ref: src/osd/
        # scheduler/mClockScheduler.cc); backfill copies ride the
        # background_recovery class, whose limit is backfill_rate
        # objects/s in virtual time
        from .scheduler import MClockScheduler
        self.sched = MClockScheduler()
        self.backfill_rate = 32   # objects/s (sets the mclock limit)
        # scrub scheduling (ref: osd_scrub_min_interval /
        # osd_deep_scrub_interval; defaults scaled to virtual time)
        self.scrub_interval = 300.0
        self.deep_scrub_interval = 1800.0
        self.last_scrub: dict[int, float] = {}
        self.last_deep_scrub: dict[int, float] = {}
        self._scrub_queued: set[int] = set()
        self.scrub_reports: dict[int, dict] = {}
        # epoch at which each PG's serving set last changed; client ops
        # carrying an older epoch are rejected with the current map
        # (the reference OSD's require_same_or_newer_map behavior)
        self.pg_changed_epoch: dict[int, int] = {}
        # interval-freshness bookkeeping (the up_thru machinery, ref:
        # osd_info_t::up_thru + PeeringState WaitUpThru): ps -> epoch
        # at which its acting primary last changed (the interval's
        # start). A primary whose map-recorded up_thru lags its
        # interval start holds the PG in "peering" until the monitors
        # commit it (_record_up_thrus).
        self.interval_start: dict[int, int] = {}
        self._pg_primary: dict[int, int] = {}
        # per-op stage tracking on the client path (ref: OpTracker/
        # TrackedOp, dump_historic_ops on the admin socket)
        from ..utils.config import g_conf
        from ..utils.op_tracker import OpTracker
        # thresholds resolve through the process config, so
        # osd_op_complaint_time / osd_op_history_* apply to the sim
        # tier's tracker the same way they do per wire daemon
        self.op_tracker = OpTracker(config=g_conf)
        self.perf = (PerfCountersBuilder("cluster")
                     .add_u64_counter("recovered_objects")
                     .add_u64_counter("log_replayed_objects")
                     .add_u64_counter("backfilled_objects")
                     .add_u64_counter("backfills_completed")
                     .add_u64_counter("revive_full_rebuilds")
                     .add_u64_counter("deferred_replays")
                     .add_u64_counter("osd_marked_down")
                     .add_u64_counter("osd_marked_out")
                     .add_u64_counter("scrubs_shallow")
                     .add_u64_counter("scrubs_deep")
                     .add_u64_counter("scrub_errors")
                     .add_u64("degraded_pgs")
                     .create_perf_counters())
        # PG backends at their initial acting sets
        self.pgs: dict[int, PGBackend] = {}
        for ps in range(pg_num):
            acting = self._acting(ps)
            if any(a == CRUSH_ITEM_NONE for a in acting):
                raise ValueError(f"pg {ps} has unfilled slots at creation; "
                                 f"use more osds/hosts")
            self.pgs[ps] = self._make_backend(f"1.{ps}", acting)
        # the creation interval: every primary records its up_thru
        # through the (fully alive) monitor quorum before I/O starts
        self._refresh_intervals()
        self._record_up_thrus()

    def _make_backend(self, pg: str, acting: list[int]) -> PGBackend:
        if self.is_erasure:
            return ECBackend(self.profile, pg, acting, self.cluster,
                             chunk_size=self.chunk_size, device=self.device)
        return ReplicatedBackend(self.pool_size, pg, acting,
                                 self.cluster, min_size=self.pool_min_size,
                                 device=self.device)

    # -- QoS ----------------------------------------------------------------

    @property
    def backfill_rate(self) -> float:
        return self._backfill_rate

    @backfill_rate.setter
    def backfill_rate(self, objs_per_s: float) -> None:
        """Retune the background_recovery mClock limit (the
        osd_mclock config-change path)."""
        from .scheduler import ClientProfile
        self._backfill_rate = objs_per_s
        self.sched.set_profile(
            "background_recovery",
            ClientProfile(reservation=0.0, weight=5.0,
                          limit=float(objs_per_s)))

    # -- placement helpers --------------------------------------------------

    def _acting(self, ps: int) -> list[int]:
        up, _upp, acting, _actp = self.osdmap.pg_to_up_acting_osds(1, ps)
        return acting

    def _up(self, ps: int) -> list[int]:
        """The CRUSH-mapped target set, ignoring pg_temp overrides —
        what re-peering steers toward (acting may lag behind during
        backfill by design)."""
        return self.osdmap.pg_to_up_acting_osds(1, ps)[0]

    def locate(self, name: str) -> int:
        return self.osdmap.object_to_pg(1, name)[1]

    # -- interval freshness (up_thru) ----------------------------------------

    def _refresh_intervals(self) -> None:
        """Detect acting-primary changes — each one starts a NEW
        INTERVAL for that PG — and stamp the start epoch (the
        PastIntervals bookkeeping, collapsed to the piece up_thru
        needs: who led, since when)."""
        for ps in range(self.pg_num):
            p = self.osdmap.pg_to_up_acting_osds(1, ps)[3]
            if self._pg_primary.get(ps) != p:
                self._pg_primary[ps] = p
                self.interval_start[ps] = self.osdmap.epoch

    def _record_up_thrus(self) -> None:
        """Primaries of fresh intervals get their up_thru recorded
        through the monitor quorum (the MOSDAlive flow, ref:
        OSDMonitor::prepare_alive). No quorum -> nothing is recorded,
        the PG stays in WaitUpThru (client ops park), and the request
        retries on the next tick — monitor loss visibly gates
        activation of new intervals, exactly the reference behavior."""
        for ps in range(self.pg_num):
            p = self._pg_primary.get(ps, -1)
            start = self.interval_start.get(ps, 0)
            if not (0 <= p < len(self.alive)) or not self.alive[p] \
                    or not self.osdmap.osd_up[p] \
                    or self.osdmap.osd_up_thru[p] >= start:
                continue
            try:
                self.mons.record_up_thru(p, start)
            except self._NoQuorum:
                g_log.dout("mon", 0, f"no quorum; up_thru for osd.{p} "
                                     f"(pg 1.{ps}) deferred")
                continue
            self.osdmap.record_up_thru(p, start)
            g_log.dout("mon", 1, f"osd.{p} up_thru {start} recorded "
                                 f"(epoch {self.osdmap.epoch})")

    def _peer_classify(self, ps: int):
        """One classify-only peering pass with the up_thru consult
        (shared by the client-op gate and the health view)."""
        from .peering import peer
        p = self._pg_primary.get(ps, -1)
        up_thru = int(self.osdmap.osd_up_thru[p]) \
            if 0 <= p < len(self.alive) else None
        return peer(self.pgs[ps], self.alive,
                    backfilling=ps in self.backfills,
                    compute_missing=False,
                    interval_start=self.interval_start.get(ps, 0),
                    up_thru=up_thru)

    # -- client I/O ---------------------------------------------------------

    def _apply_write(self, ps: int, kind: str, payload,
                     dead: set[int], snapc: int = 0) -> None:
        """One PG write (full objects or ranges) with the invariants
        every write path must keep: dead OSDs receive nothing (PGLog
        records the gap), and objects written during a backfill are
        (re-)queued for copy — the bytes went to the OLD serving set."""
        be = self.pgs[ps]
        if kind == "write":
            names = set(payload.keys())
        elif kind == "remove":
            names = set(payload)
        else:  # write_ranges
            names = {n for n, _, _ in payload}
        # snapshot copy-on-write (PrimaryLogPG::make_writeable): any
        # mutation of a head whose newest clone predates the newest
        # snap first preserves the current state as a clone. Pool-snap
        # pools use the pool's own seq; selfmanaged pools use the seq
        # the client's SnapContext carries (a writer that knows no
        # snaps preserves nothing — librados semantics).
        if self.snaps:
            self._preserve_clones(names, self.snap_seq)
        elif snapc and self.sm_snaps:
            self._preserve_clones(names, min(snapc, self.snap_seq))
        if kind == "write":
            be.write_objects(payload, dead_osds=dead)
        elif kind == "remove":
            be.remove_objects(payload, dead_osds=dead)
            # per-object side state dies with the object (the
            # reference's omap and watches are object-lifetime): a
            # recreated name must not inherit a dead object's locks,
            # watchers, or birth era. SnapSets survive — clones
            # outlive the head by design.
            for name in names:
                self.obj_kv.pop(name, None)
                self.watches.pop(name, None)
                self.object_births.pop(name, None)
        else:
            be.write_ranges(payload, dead_osds=dead)
        job = self.backfills.get(ps)
        if job is not None:
            job["names"].update(names)

    def _dead_osds(self) -> set[int]:
        return {o for o in range(len(self.alive)) if not self.alive[o]}

    def write(self, objects: dict[str, bytes | np.ndarray],
              snapc: int = 0) -> None:
        # dead processes get no sub-writes; their shards fall behind in
        # the PG log and catch up on revive (ref: a down OSD misses
        # MOSDECSubOpWrite fan-out; PGLog records the gap). One dead-set
        # snapshot serves every PG group of this dispatch (the groups
        # all commit under the same failure view, matching the wire
        # tier's one-op-one-suspect-set semantics), and each group runs
        # the backend's fused encode+CRC launch.
        by_pg: dict[int, dict] = {}
        for name, data in objects.items():
            by_pg.setdefault(self.locate(name), {})[name] = data
        dead = self._dead_osds()
        for ps, group in by_pg.items():
            self._apply_write(ps, "write", group, dead, snapc=snapc)

    def read(self, name: str) -> np.ndarray:
        ps = self.locate(name)
        dead = self._dead_osds()
        return self.pgs[ps].read_object(name, dead_osds=dead)

    def repair_pg(self, ps: int) -> dict:
        """`ceph pg repair 1.<ps>`: scrub + rewrite inconsistent
        shards/replicas from the surviving good copies."""
        rep = self.pgs[ps].repair_pg(dead_osds=self._dead_osds())
        if rep["repaired"]:
            self.scrub_reports.pop(ps, None)  # rot is gone
            g_log.dout("scrub", 1, f"pg 1.{ps} repaired "
                                   f"{rep['repaired']} shard(s)")
        return rep

    # -- PG splitting (pg_num increase) --------------------------------------

    def split_pgs(self, new_pg_num: int) -> dict:
        """Execute a pg_num increase — the split machinery the
        autoscaler's recommendation needs (ref: src/osd/PG.cc split;
        src/mon/OSDMonitor.cc pg_num handling; ceph_stable_mod
        re-bucketing). Sequence:

        1. quorum-gated map mutation (pg_num is monitor state);
        2. children are created ON THEIR PARENT'S acting set and the
           re-bucketed objects move store-LOCALLY (collection split —
           no bytes cross OSDs, both PG logs record the transfer);
        3. _repeer_all() then steers each child toward its own CRUSH
           targets with the standard pg_temp-protected backfill, so
           reads keep working from the parent's OSDs mid-move.

        Requires a settled cluster (no live backfills, every parent
        clean) — the reference likewise splits healthy PGs; the
        autoscaler simply retries later otherwise."""
        old = self.pg_num
        if new_pg_num <= old:
            raise ValueError(f"pg_num {new_pg_num} <= current {old} "
                             f"(merges not supported)")
        if self.backfills:
            raise ValueError("backfills in flight; let the cluster "
                             "settle before splitting")
        dead = self._dead_osds()
        for ps in range(old):
            be = self.pgs[ps]
            if any(o in dead or o not in self.cluster.stores
                   for o in be.acting):
                raise ValueError(f"pg 1.{ps} degraded; heal before "
                                 f"splitting")
            # a live-but-behind shard (revive during quorum loss defers
            # its catch-up) must refuse HERE, while nothing has moved
            # and the map is untouched — split_to's own check would
            # otherwise abort mid-split with children half-created
            for s in range(be.n):
                if be.shard_applied[s] < be.pg_log.head:
                    raise ValueError(
                        f"pg 1.{ps} shard {s} not caught up; heal "
                        f"before splitting")
        if not self._mon_commit(f"pool 1 pg_num {old} -> {new_pg_num}"):
            raise ValueError("no monitor quorum; pg_num change refused")
        from .osdmap import (ceph_stable_mod, pg_num_mask,
                             str_hash_rjenkins)
        old_mask = pg_num_mask(old)
        new_mask = pg_num_mask(new_pg_num)
        children: dict[int, int] = {}
        moved = 0
        # one hash pass per parent buckets every re-homed object (the
        # child ids are deterministic: parent == stable_mod(child, old))
        kids_of: dict[int, list[int]] = {}
        for child_ps in range(old, new_pg_num):
            kids_of.setdefault(
                int(ceph_stable_mod(child_ps, old, old_mask)),
                []).append(child_ps)
        for parent_ps, kids in kids_of.items():
            parent = self.pgs[parent_ps]
            rehome: dict[int, list[str]] = {c: [] for c in kids}
            for n in parent.list_pg_objects():
                tgt = int(ceph_stable_mod(str_hash_rjenkins(n),
                                          new_pg_num, new_mask))
                if tgt != parent_ps:
                    rehome[tgt].append(n)
            for child_ps in kids:
                child = self._make_backend(f"1.{child_ps}",
                                           list(parent.acting))
                moved += parent.split_to(child, rehome[child_ps])
                self.pgs[child_ps] = child
                children[child_ps] = parent_ps
        # flip the map LAST: every re-homed byte is already in its
        # child's collections, so the instant locate() starts routing
        # to children their data is in place (no observable gap, and
        # no abort path can leave pg_num pointing at missing PGs)
        self.osdmap.set_pg_num(1, new_pg_num)
        self.pg_num = new_pg_num
        g_log.dout("osd", 1,
                   f"pool 1 split {old} -> {new_pg_num} pgs; "
                   f"{moved} objects re-homed into "
                   f"{len(children)} children (collection split)")
        # steer children from their parents' OSDs to their own CRUSH
        # targets; pg_temp keeps the parent set serving meanwhile
        self._repeer_all()
        return {"pg_num": new_pg_num, "children": children,
                "objects_moved": moved}

    def apply_autoscale(self, target_pg_per_osd: int = 100,
                        threshold: float = 3.0,
                        max_pg_num: int | None = None) -> dict | None:
        """Run the autoscaler and EXECUTE its recommendation (the
        reference's autoscale `on` mode, vs the advisory `warn` the
        mgr module defaults to; ref: src/pybind/mgr/pg_autoscaler).
        Returns split_pgs()' report, or None when no change is due.
        `max_pg_num` caps the jump (mon_max_pool_pg_num role)."""
        from ..mgr.pg_autoscaler import recommend_pg_num
        rec = recommend_pg_num(self.osdmap, 1, target_pg_per_osd,
                               threshold)
        target = rec["pg_num_recommended"]
        if max_pg_num is not None:
            target = min(target, max_pg_num)
        if not rec["would_adjust"] or target <= self.pg_num:
            return None
        return self.split_pgs(target)

    # -- pool snapshots (PrimaryLogPG snap machinery) ------------------------

    _SNAP_SEP = "@@snap."

    @classmethod
    def _clone_name(cls, name: str, seq: int) -> str:
        return f"{name}{cls._SNAP_SEP}{seq:08x}"

    def _preserve_clones(self, names, eff_seq: int) -> None:
        """COW step: for each head about to mutate, if its state hasn't
        been preserved since snap era `eff_seq` (the newest pool snap,
        or the newest snap the client's SnapContext names), write the
        current bytes as a clone object and record it in the SnapSet."""
        dead = self._dead_osds()
        for name in sorted(names):
            if self._SNAP_SEP in name:
                continue            # clones never re-clone
            ps = self.locate(name)
            be = self.pgs[ps]
            if name not in be.object_sizes:
                # creation: remember the snap era it was born in, so
                # reads at older snaps correctly say "didn't exist"
                self.object_births[name] = eff_seq
                continue
            if self.object_births.get(name, 0) >= eff_seq:
                # born AFTER the newest snap: no snap contains it, so
                # preserving a clone would make it phantom-exist there
                continue
            ss = self.snapsets.setdefault(name, [])
            if ss and ss[-1][0] >= eff_seq:
                continue            # newest snap already has its clone
            data = be.read_object(name, dead_osds=dead)
            clone = self._clone_name(name, eff_seq)
            cps = self.locate(clone)
            self._apply_write(cps, "write", {clone: data}, dead)
            ss.append((eff_seq,
                       self.object_births.get(name, 0)))

    def snap_create(self) -> int:
        """Take a pool snapshot (ref: OSDMonitor pool mksnap ->
        pg_pool_t::add_snap): monitor-quorum-gated seq bump; data is
        preserved lazily by the write-path COW."""
        if self.selfmanaged:
            raise ValueError("pool uses selfmanaged snaps; pool "
                             "snapshots refused (ref: pg_pool_t "
                             "FLAG_SELFMANAGED_SNAPS exclusivity)")
        if not self._mon_commit(f"pool 1 mksnap {self.snap_seq + 1}"):
            raise ValueError("no monitor quorum; snap refused")
        self.snap_seq += 1
        self.snaps[self.snap_seq] = self.now
        return self.snap_seq

    def selfmanaged_snap_create(self) -> int:
        """Allocate a self-managed snap id (ref: librados
        selfmanaged_snap_create -> OSDMonitor pool selfmanaged mksnap).
        No pool-wide COW follows from this alone: clones are made only
        for writes whose SnapContext names the id (`snapc=` on the
        write path) — per-image snapshots for RBD."""
        if self.snaps:
            raise ValueError("pool already has pool snapshots; "
                             "selfmanaged snaps refused")
        if not self._mon_commit(
                f"pool 1 selfmanaged mksnap {self.snap_seq + 1}"):
            raise ValueError("no monitor quorum; snap refused")
        self.selfmanaged = True
        self.snap_seq += 1
        self.sm_snaps.add(self.snap_seq)
        return self.snap_seq

    def selfmanaged_snap_remove(self, sid: int) -> int:
        """Delete a self-managed snap + snaptrim (ref: librados
        selfmanaged_snap_remove). Returns clones trimmed."""
        if sid not in self.sm_snaps:
            raise KeyError(f"no selfmanaged snap {sid}")
        if not self._mon_commit(f"pool 1 selfmanaged rmsnap {sid}"):
            raise ValueError("no monitor quorum; snap removal refused")
        self.sm_snaps.discard(sid)
        return self._snap_trim()

    def _live_snaps(self):
        """Snap ids any clone may still serve (pool + selfmanaged)."""
        return set(self.snaps) | self.sm_snaps

    def snap_read(self, name: str, sid: int) -> np.ndarray:
        """Read an object's state as of snap `sid`: the OLDEST clone
        with seq >= sid, else the unmodified head (ref: PrimaryLogPG
        find_object_context snap resolution via SnapSet.clones)."""
        if sid not in self.snaps and sid not in self.sm_snaps:
            raise KeyError(f"no snap {sid}")
        cands = [seq for seq, birth in self.snapsets.get(name, [])
                 if seq >= sid and birth < sid]   # alive AT the snap
        if cands:
            return self.read(self._clone_name(name, min(cands)))
        ps = self.locate(name)
        if name in self.pgs[ps].object_sizes \
                and self.object_births.get(name, 0) < sid:
            return self.read(name)   # unchanged since before the snap
        raise KeyError(f"{name!r} did not exist at snap {sid}")

    def snap_rollback(self, name: str, sid: int) -> None:
        """rados rollback: write the snap's state back onto the head
        (itself COW-protected, so the pre-rollback head is preserved
        if a newer snap needs it)."""
        self.write({name: self.snap_read(name, sid)})

    def snap_remove(self, sid: int) -> int:
        """Delete a snap + trim clones no live snap reads anymore (the
        snaptrim role; ref: PrimaryLogPG::trim_object). Returns the
        number of clone objects trimmed."""
        if sid not in self.snaps:
            raise KeyError(f"no snap {sid}")
        if not self._mon_commit(f"pool 1 rmsnap {sid}"):
            raise ValueError("no monitor quorum; snap removal refused")
        del self.snaps[sid]
        return self._snap_trim()

    def snap_changed(self, name: str, sid: int) -> bool:
        """Has `name`'s head diverged from its state at snap `sid`?
        Metadata-only (SnapSet + birth eras — the object-map/fast-diff
        role, ref: librbd fast-diff via cls_rbd object map; the slow
        path lists per-object snaps): no data is read or compared."""
        if sid not in self.snaps and sid not in self.sm_snaps:
            raise KeyError(f"no snap {sid}")
        exists_now = name in self.pgs[self.locate(name)].object_sizes
        covered = any(seq >= sid and birth < sid
                      for seq, birth in self.snapsets.get(name, []))
        if covered:
            return True      # a clone was preserved => head mutated
        if not exists_now:
            return False     # didn't exist then (no covering clone),
                             # doesn't exist now
        # head unchanged since before the snap iff it was born earlier
        return self.object_births.get(name, 0) >= sid

    def _snap_trim(self) -> int:
        """Drop clones no live snap reads anymore. Idempotent and
        failure-tolerant: a clone whose removal is refused mid-chaos
        (degraded PG) stays in the SnapSet and is retried on the next
        trim — the snap deletion itself never half-applies."""
        trimmed = 0
        live = self._live_snaps()
        for name, ss in list(self.snapsets.items()):
            keep: list[tuple[int, int]] = []
            prev = 0
            for c, birth in ss:      # ascending; clone c covers snaps
                # (prev_kept, c], minus snaps older than its birth era
                if any(prev < s <= c and s > birth
                       for s in live):
                    keep.append((c, birth))
                    prev = c
                    continue
                try:
                    self.remove(self._clone_name(name, c))
                    trimmed += 1
                except KeyError:
                    trimmed += 1     # already gone: count as trimmed
                except ValueError:
                    keep.append((c, birth))   # PG unwritable: keep the
                    prev = c                  # clone, retry later
            if keep:
                self.snapsets[name] = keep
            else:
                del self.snapsets[name]
        return trimmed

    # -- watch / notify ------------------------------------------------------

    def watch(self, name: str, callback) -> int:
        """Register interest in an object (ref: PrimaryLogPG watch;
        callback(notifier_name, payload) -> optional reply bytes)."""
        ps = self.locate(name)
        if name not in self.pgs[ps].object_sizes:
            raise KeyError(f"no object {name!r}")
        cookie = self._next_cookie
        self._next_cookie += 1
        self.watches.setdefault(name, {})[cookie] = callback
        return cookie

    def unwatch(self, name: str, cookie: int) -> None:
        self.watches.get(name, {}).pop(cookie, None)

    def notify(self, name: str, payload: bytes = b"") -> dict:
        """Invoke every watcher; returns {cookie: reply-or-None}. A
        watcher whose callback raises is reported as None (the
        timed-out-watcher slot in the reference's notify reply)."""
        acks: dict[int, bytes | None] = {}
        for cookie, cb in list(self.watches.get(name, {}).items()):
            try:
                acks[cookie] = cb(name, payload)
            except Exception:        # noqa: BLE001 — a broken watcher
                acks[cookie] = None  # must not kill the notify fan-out
        return acks

    # -- object classes ------------------------------------------------------

    def cls_exec(self, name: str, cls: str, method: str,
                 inp: bytes = b"") -> bytes:
        """Execute a registered object-class method against an object
        at its primary (ref: PrimaryLogPG::do_osd_ops OP_CALL ->
        ClassHandler). Writes made by the method ride the normal
        client path (COW, PG log, EC fan-out included)."""
        from .objclass import cls_call
        return cls_call(self, name, cls, method, inp)

    def remove(self, names: list[str] | str, snapc: int = 0) -> None:
        names = [names] if isinstance(names, str) else list(names)
        by_pg: dict[int, list[str]] = {}
        for name in names:
            by_pg.setdefault(self.locate(name), []).append(name)
        for ps, group in by_pg.items():
            self._apply_write(ps, "remove", group, self._dead_osds(),
                              snapc=snapc)

    # -- client RPC (the primary-OSD session an Objecter talks to) ----------

    def _note_pg_change(self, ps: int) -> None:
        self.pg_changed_epoch[ps] = self.osdmap.epoch

    def client_rpc(self, target_osd: int, epoch: int, kind: str, ps: int,
                   payload, snapc: int = 0):
        """One client op addressed to `target_osd` as pg `ps`'s
        primary, carrying the client's map `epoch`. Raises StaleMap
        when the op's epoch predates the PG's last serving-set change,
        when the target is not the current acting primary, or when its
        process is dead — the signals that make the Objecter refresh +
        retarget (ref: OSD require_same_or_newer_map + map sharing;
        lossy client connections)."""
        with self.op_tracker.create_op(
                f"client_rpc {kind} pg 1.{ps} -> osd.{target_osd}") as op:
            return self._client_rpc_tracked(op, target_osd, epoch, kind,
                                            ps, payload, snapc)

    def _client_rpc_tracked(self, op, target_osd: int, epoch: int,
                            kind: str, ps: int, payload,
                            snapc: int = 0):
        if epoch < self.pg_changed_epoch.get(ps, 0):
            raise StaleMap(self.osdmap.epoch,
                           f"pg 1.{ps} remapped at epoch "
                           f"{self.pg_changed_epoch[ps]}, op carries "
                           f"epoch {epoch}")
        primary = self.osdmap.pg_to_up_acting_osds(1, ps)[3]
        if target_osd < 0 or target_osd != primary:
            raise StaleMap(self.osdmap.epoch,
                           f"pg 1.{ps} primary is osd.{primary}, "
                           f"op sent to osd.{target_osd}")
        if not self.alive[target_osd]:
            raise StaleMap(self.osdmap.epoch,
                           f"osd.{target_osd} is not answering")
        # a PG that peered down/incomplete blocks I/O entirely, and so
        # does one still in WaitUpThru — serving a write before the
        # monitors recorded this interval's up_thru would create a
        # write nobody can later prove happened (the reference parks
        # ops on a waiting list; our client retries until the PG is
        # serviceable again)
        res = self._peer_classify(ps)
        if not res.serviceable:
            raise StaleMap(self.osdmap.epoch,
                           f"pg 1.{ps} is {res.state}; op parked")
        op.mark_event("reached_pg")  # map checks + peering gate passed
        dead = self._dead_osds()
        if kind == "append":
            # tail append (librados rados_append): the PRIMARY owns
            # the authoritative size, so the offset resolves here —
            # two appenders racing through the same primary serialize
            # instead of clobbering. Rides _apply_write as a range
            # write so COW + backfill requeue apply; on an EC pool a
            # tail inside stripe padding takes the r16 append fast
            # path (no pre-read) inside write_ranges.
            name, data = payload
            off = int(self.pgs[ps].object_sizes.get(name, 0))
            self._apply_write(ps, "write_ranges", [(name, off, data)],
                              dead, snapc=snapc)
            op.mark_event("commit_sent")
            return off
        if kind in ("write", "write_ranges", "remove"):
            self._apply_write(ps, kind, payload, dead, snapc=snapc)
            op.mark_event("commit_sent")
            return None
        if kind == "read":
            out = self.pgs[ps].read_objects(payload, dead_osds=dead)
            op.mark_event("reply_sent")
            return out
        raise ValueError(f"unknown client op kind {kind!r}")

    def degraded_read(self, ps: int, names):
        """Degraded-read fast path (the wire tier's `read_degraded`
        analog, ROADMAP item 3): serve a read from any k surviving
        shards RIGHT NOW, bypassing the primary-session and peering
        gates client_rpc enforces — a dead or still-peering primary
        must cost a decode, not a detection + activation wait (the
        degraded-read tail of the online-EC study, arxiv 1709.05365).
        Reads mutate nothing, so no EIO repair writeback either
        (repair=False keeps the re-decode)."""
        with self.op_tracker.create_op(
                f"degraded_read pg 1.{ps}") as op:
            dead = self._dead_osds()
            out = self.pgs[ps].read_objects(names, dead_osds=dead,
                                            repair=False)
            op.mark_event("reply_sent")
            return out

    # -- failure model ------------------------------------------------------

    def kill_osd(self, osd: int) -> None:
        """Process death: store bytes survive, peer stops answering.
        On a persistent store this is REAL SIGKILL semantics — the RAM
        mirror is dropped and only WAL+checkpoint bytes remain; any
        path that still reads the dead store raises instead of quietly
        seeing ghost state."""
        self.alive[osd] = False
        st = self.cluster.stores.get(osd)
        if st is not None:
            st.crash()
        g_log.dout("osd", 1, f"osd.{osd} killed at t={self.now}")

    def destroy_osd(self, osd: int) -> None:
        """Disk loss: kill + drop the store (and its on-disk files)."""
        self.kill_osd(osd)
        st = self.cluster.stores.pop(osd, None)
        if st is not None and st.path is not None:
            import shutil
            shutil.rmtree(st.path, ignore_errors=True)
        self.destroyed.add(osd)

    def revive_osd(self, osd: int) -> None:
        """Process restart with its store intact: the OSD rejoins and
        every PG catches its shard up via PG-log delta replay (ref:
        PeeringState GetLog/GetMissing -> log-based recovery), falling
        back to a full shard rebuild only when the log was trimmed past
        the shard's applied cursor (the backfill case). A destroyed
        store cannot rejoin — recovery re-places its data instead."""
        if osd in self.destroyed:
            raise ValueError(
                f"osd.{osd} was destroyed (disk lost); it cannot rejoin "
                f"with its old identity — let recovery re-place its data")
        st = self.cluster.stores.get(osd)
        if st is not None and st.is_down:
            # persistent store: recover state from WAL+checkpoint (the
            # OSD boot mount; what MemStore keeps by fiat, TinStore
            # must actually replay)
            st.remount()
        self.alive[osd] = True
        self.last_heard[:, osd] = self.now
        if not self.osdmap.osd_up[osd]:
            if not self._mon_commit(f"osd.{osd} up"):
                # the process is back but the map can't record it; the
                # next tick with quorum will (boot message retried)
                return
            self.osdmap.mark_up(osd)
        was_out = self.osdmap.osd_weight[osd] == 0
        self.down_since.pop(osd, None)
        g_log.dout("osd", 1, f"osd.{osd} revived at t={self.now}")
        # every shard left behind (this OSD's, and any whose earlier
        # replay was deferred for lack of live peers) tries to catch up
        # now; reads stay safe meanwhile because ECBackend never serves
        # an object from a shard whose cursor predates its last write
        self._catch_up_all()
        if was_out:
            # rejoin after auto-out: weight restored -> CRUSH moves
            # slots back from their interim holders; those are live
            # sources, so the moves run as pg_temp-protected backfills
            self.osdmap.mark_in(osd)
            g_log.dout("mon", 1, f"osd.{osd} marked in (epoch "
                                 f"{self.osdmap.epoch})")
            self._repeer_all()

    def _catch_up_all(self) -> None:
        """Re-peer every PG (GetInfo -> GetLog -> GetMissing via
        peering.peer) and execute the resulting per-shard missing plan:
        behind live shards replay the log delta, log-trimmed shards get
        a full rebuild. Shards whose PGs lack enough caught-up live
        peers stay deferred (the down/incomplete PG state) and retry on
        the next revive."""
        from .peering import BACKFILL, peer
        for ps in range(self.pg_num):
            be = self.pgs[ps]
            res = peer(be, self.alive, backfilling=ps in self.backfills)
            for slot, plan in sorted(res.missing.items()):
                o = be.acting[slot]
                backfill = plan == BACKFILL
                if backfill:
                    # full rebuild, PLUS purge of objects deleted while
                    # the shard was down (the trimmed log can't name
                    # them, but the shard's own store can)
                    from .ecbackend import shard_cid
                    cid = shard_cid(be.pg, slot)
                    strays = [n for n in
                              self.cluster.osd(o).list_objects(cid)
                              if n not in be.object_sizes]
                    missed = sorted(be.object_sizes) + strays
                else:
                    missed = plan
                if not missed:
                    be.shard_applied[slot] = be.pg_log.head
                    continue
                exclude = {i.slot for i in res.infos
                           if i.slot != slot and not i.alive}
                try:
                    counters = be.recover_shards(
                        [slot], replacement_osds={slot: o}, names=missed,
                        helper_exclude=exclude)
                except ValueError as e:
                    g_log.dout("recovery", 0,
                               f"pg 1.{ps}: osd.{o} catch-up deferred "
                               f"({e})")
                    self.perf.inc("deferred_replays")
                    continue
                if backfill:
                    self.perf.inc("revive_full_rebuilds")
                    self.perf.inc("backfilled_objects",
                                  counters["objects"])
                else:
                    self.perf.inc("log_replayed_objects",
                                  counters["objects"])
                g_log.dout("recovery", 1,
                           f"pg 1.{ps}: osd.{o} "
                           f"{'backfilled' if backfill else 'replayed'} "
                           f"{counters['objects']} objects")

    def tick(self, dt: float = 1.0) -> None:
        """Advance virtual time; deliver heartbeats; run the
        monitor's failure logic; trigger recovery on map changes."""
        steps = max(1, int(round(dt / self.hb_interval)))
        for _ in range(steps):
            self.now += dt / steps
            up = self.alive
            # alive peers hear each other every interval
            self.last_heard[np.ix_(up, up)] = self.now
            # grace expiry: alive i reports silent j
            silent = self.now - self.last_heard > self.hb_grace
            for j in range(len(up)):
                if not self.osdmap.osd_up[j]:
                    continue
                reporters = int(silent[up, j].sum())
                if reporters >= self.min_down_reporters:
                    self._mark_down(j)
            # boot retries FIRST: an OSD revived during monitor quorum
            # loss is alive but still map-down (down_since retained);
            # re-announcing before the down->out pass prevents a
            # spurious mark-out + double repeer of a live OSD the
            # instant quorum heals
            for o in np.nonzero(self.alive & ~self.osdmap.osd_up)[0]:
                if int(o) not in self.destroyed:
                    self.revive_osd(int(o))
            # down long enough -> out -> remap + recover
            for j, since in list(self.down_since.items()):
                if self.now - since >= self.down_out_interval:
                    self._mark_out(j)
            self._progress_backfills()
            self._schedule_scrubs()
            self._pump()
            # close any WaitUpThru window this step opened (mark_down
            # primary changes, backfill cutovers) or a previous quorum
            # loss left behind — the MOSDAlive retry
            self._refresh_intervals()
            self._record_up_thrus()

    # -- monitor plumbing ---------------------------------------------------

    def _mon_commit(self, what: str) -> bool:
        """Commit a map mutation through the monitor quorum; False
        (and no mutation) when the monitors lack a majority."""
        try:
            self.mons.propose("osdmap/last_change",
                              (self.osdmap.epoch + 1, what))
            return True
        except self._NoQuorum:
            g_log.dout("mon", 0, f"no quorum; {what} deferred")
            return False

    def kill_mon(self, rank: int) -> None:
        self.mons.kill(rank)
        g_log.dout("mon", 1, f"mon.{rank} killed")

    def revive_mon(self, rank: int) -> None:
        self.mons.revive(rank)
        g_log.dout("mon", 1, f"mon.{rank} revived")

    def config_set(self, name: str, value) -> None:
        """`ceph config set` analog: VALIDATE, commit through the
        monitor KV, then distribute into the runtime config (the
        ConfigMonitor -> md_config_t observer path). A value the
        schema rejects must never reach the replicated KV — a
        poisoned KV would re-distribute the bad value on every sync."""
        from ..utils.config import g_conf
        declared = name in g_conf.schema
        if declared:
            value = g_conf.schema[name].coerce(value)  # raises on junk
        self.mons.config_set(name, value)  # NoQuorum -> nothing applied
        if declared:
            g_conf.set(name, value, level="mon")
            g_log.dout("mon", 1, f"config set {name} = {value}")

    def _mark_down(self, osd: int) -> None:
        if not self.osdmap.osd_up[osd]:
            return
        if not self._mon_commit(f"osd.{osd} down"):
            return
        self.osdmap.mark_down(osd)
        self.down_since[osd] = self.now
        self.perf.inc("osd_marked_down")
        g_log.dout("mon", 1, f"osd.{osd} marked down (epoch "
                             f"{self.osdmap.epoch})")
        self._update_degraded()

    def _mark_out(self, osd: int) -> None:
        if osd not in self.down_since:
            return
        if not self._mon_commit(f"osd.{osd} out"):
            return
        self.osdmap.mark_out(osd)
        del self.down_since[osd]
        self.perf.inc("osd_marked_out")
        g_log.dout("mon", 1, f"osd.{osd} marked out (epoch "
                             f"{self.osdmap.epoch})")
        self._repeer_all()

    def _update_degraded(self) -> None:
        dead = self._dead_osds()
        degraded = sum(
            1 for ps in range(self.pg_num)
            if any(o in dead for o in self.pgs[ps].acting))
        self.perf.set("degraded_pgs", degraded)

    def _repeer_all(self) -> None:
        """Map changed: every PG re-derives its acting set; shards on
        replaced OSDs are recovered (dead source) or copied (backfill
        from live source)."""
        for ps in range(self.pg_num):
            be = self.pgs[ps]
            new_acting = self._up(ps)
            # reconcile in-flight backfills with the new map: a move
            # whose destination died or is no longer the CRUSH target
            # is cancelled (the old holder simply keeps serving)
            job = self.backfills.get(ps)
            if job is not None:
                kept = [(s, o, n) for (s, o, n) in job["moves"]
                        if self.alive[n] and new_acting[s] == n]
                if len(kept) != len(job["moves"]):
                    g_log.dout("osd", 1, f"pg 1.{ps}: cancelled "
                               f"{len(job['moves']) - len(kept)} stale "
                               f"backfill move(s) on map change")
                job["moves"] = kept
                if not kept:
                    self._drop_backfill_job(ps)
            if new_acting == be.acting:
                continue
            if any(a == CRUSH_ITEM_NONE for a in new_acting):
                g_log.dout("osd", 0, f"pg 1.{ps} undersized after remap")
                continue
            lost, moved = [], []
            for slot, (old, new) in enumerate(zip(be.acting, new_acting)):
                if old == new:
                    continue
                if not self.alive[new]:
                    # destination died but isn't marked down in the map
                    # yet (the kill->grace->report window): writing to
                    # its store would be lost bytes on MemStore and an
                    # outright error on a crashed TinStore. Defer — the
                    # mark-down bumps the map and re-plans this slot.
                    continue
                if self.alive[old] and old in self.cluster.stores:
                    moved.append((slot, old, new))
                else:
                    lost.append((slot, new))
            if lost:
                slots = [s for s, _ in lost]
                repl = {s: n for s, n in lost}
                # never read helper chunks from shards whose OSD is
                # still dead (their stores are stale or gone)
                exclude = {s for s, o in enumerate(be.acting)
                           if s not in slots and
                           (not self.alive[o] or
                            o not in self.cluster.stores)}
                counters = be.recover_shards(slots, replacement_osds=repl,
                                             helper_exclude=exclude)
                self.perf.inc("recovered_objects", counters["objects"])
                self._note_pg_change(ps)
                g_log.dout("recovery", 1,
                           f"pg 1.{ps}: rebuilt {counters['objects']} "
                           f"objects onto {repl}")
            if moved:
                # recovered slots are already flipped; moved slots keep
                # serving from the OLD osd via pg_temp until the copy
                # completes (ref: pg_temp during backfill)
                self._start_backfill(ps, moved)
        self._update_degraded()
        # map change may have started new intervals: their primaries
        # record up_thru NOW (quorum permitting) so a healthy cluster
        # activates synchronously; under quorum loss the PGs stay in
        # WaitUpThru and the tick loop retries
        self._refresh_intervals()
        self._record_up_thrus()

    # -- backfill (async, pg_temp-protected) --------------------------------

    def _start_backfill(self, ps: int, moves: list[tuple[int, int, int]]) \
            -> None:
        from .ecbackend import shard_cid
        from .memstore import Transaction
        be = self.pgs[ps]
        job = self.backfills.setdefault(ps, {"moves": [], "names": set()})
        fresh = False
        for slot, old, new in moves:
            if (slot, old, new) in job["moves"]:
                continue  # already in flight — keep its copy progress
            job["moves"] = [mv for mv in job["moves"] if mv[0] != slot]
            job["moves"].append((slot, old, new))
            fresh = True
            t = Transaction().create_collection(shard_cid(be.pg, slot))
            self.cluster.osd(new).queue_transaction(t)
        if fresh:
            # only a NEW destination needs the full object list; an
            # unchanged in-flight move keeps its remaining set
            job["names"].update(be.object_sizes)
        self.osdmap.set_pg_temp((1, ps), list(be.acting))
        self._note_pg_change(ps)
        g_log.dout("osd", 1, f"pg 1.{ps} backfilling {len(job['moves'])} "
                             f"slot(s); pg_temp keeps old acting serving")

    def _drop_backfill_job(self, ps: int) -> None:
        """Cancel a backfill: clear pg_temp AND purge its queued copy
        ops so cancelled work doesn't burn recovery limit budget."""
        self.osdmap.set_pg_temp((1, ps), [])
        self._note_pg_change(ps)
        del self.backfills[ps]
        self.sched.remove_if("background_recovery",
                             lambda op: op[0] == ps)

    def _progress_backfills(self) -> None:
        """Pump backfill copies through the mClock scheduler (class
        background_recovery, limit = backfill_rate objects/s in virtual
        time), then cut over: flip acting, clear pg_temp. A source that
        died mid-backfill converts that slot to recovery."""
        for ps, job in list(self.backfills.items()):
            be = self.pgs[ps]
            for slot, old, new in list(job["moves"]):
                # a dead destination cancels the move (the old holder
                # keeps serving; a later map change re-plans the slot)
                if not self.alive[new]:
                    job["moves"].remove((slot, old, new))
                    g_log.dout("osd", 1, f"pg 1.{ps}: backfill dest "
                                         f"osd.{new} died; move cancelled")
                    continue
                # sources must still be alive; otherwise recover
                if self.alive[old] and old in self.cluster.stores:
                    continue
                job["moves"].remove((slot, old, new))
                exclude = {s for s, o in enumerate(be.acting)
                           if s != slot and (not self.alive[o]
                                             or o not in self.cluster.stores)}
                try:
                    counters = be.recover_shards(
                        [slot], replacement_osds={slot: new},
                        helper_exclude=exclude)
                except ValueError as e:
                    # not enough live helpers right now: the slot stays
                    # with its (dead) holder, the PG degraded; a later
                    # revive or map change resolves it
                    g_log.dout("recovery", 0,
                               f"pg 1.{ps}: slot {slot} recovery "
                               f"deferred during backfill ({e})")
                    self.perf.inc("deferred_replays")
                    continue
                self.perf.inc("recovered_objects", counters["objects"])
                # acting changed (slot flipped to `new`): keep pg_temp
                # pointing at the real serving set, or clients would be
                # steered at the dead old holder
                self.osdmap.set_pg_temp((1, ps), list(be.acting))
                self._note_pg_change(ps)
            if not job["moves"]:
                # nothing left to copy toward: drop the job without
                # claiming a completed backfill
                self._drop_backfill_job(ps)
                continue
        # enqueue copy ops the scheduler hasn't seen yet
        for ps, job in self.backfills.items():
            queued = job.setdefault("queued", set())
            for name in sorted(set(job["names"]) - queued):
                self.sched.enqueue("background_recovery", (ps, name))
                queued.add(name)

    def _do_backfill_copy(self, ps: int, name: str) -> None:
        from .ecbackend import HINFO_KEY, shard_cid
        from .memstore import Transaction
        job = self.backfills.get(ps)
        if job is None:
            return  # op outlived its backfill (cancelled/done)
        job.setdefault("queued", set()).discard(name)
        if name not in job["names"]:
            return
        job["names"].discard(name)
        be = self.pgs[ps]
        for slot, old, new in job["moves"]:
            src = self.cluster.osd(old)
            dst = self.cluster.osd(new)
            cid = shard_cid(be.pg, slot)
            if not src.exists(cid, name):
                # removed (or never written): propagate the delete so a
                # previously-copied version doesn't survive at the dest
                if dst.exists(cid, name):
                    dst.queue_transaction(Transaction().remove(cid, name))
                continue
            data = src.read(cid, name)
            t = (Transaction()
                 .write(cid, name, 0, data)
                 .truncate(cid, name, len(data))
                 .setattr(cid, name, HINFO_KEY,
                          src.getattr(cid, name, HINFO_KEY)))
            dst.queue_transaction(t)
        self.perf.inc("backfilled_objects")

    def _complete_backfills(self) -> None:
        """Cut over: everything copied and nothing still queued."""
        for ps, job in list(self.backfills.items()):
            if job["names"] or job.get("queued"):
                continue
            be = self.pgs[ps]
            for slot, old, new in job["moves"]:
                be.acting[slot] = new
                be.shard_applied[slot] = be.pg_log.head
            self.osdmap.set_pg_temp((1, ps), [])
            self._note_pg_change(ps)
            del self.backfills[ps]
            self.perf.inc("backfills_completed")
            g_log.dout("osd", 1, f"pg 1.{ps} backfill complete; "
                                 f"pg_temp cleared")

    # -- scrub scheduling ---------------------------------------------------

    def _schedule_scrubs(self) -> None:
        """Enqueue due scrubs on the scrub QoS class (ref: the scrub
        scheduler in src/osd/scrubber/osd_scrub_sched.cc: periodic
        shallow every osd_scrub_min_interval, deep every
        osd_deep_scrub_interval). Degraded/backfilling PGs are skipped
        until healthy, like the reference's active+clean gate."""
        dead = self._dead_osds()
        for ps in range(self.pg_num):
            if ps in self.backfills or ps in self._scrub_queued:
                continue
            if any(o in dead for o in self.pgs[ps].acting):
                continue
            deep_due = (self.now - self.last_deep_scrub.get(ps, 0.0)
                        >= self.deep_scrub_interval)
            shallow_due = (self.now - self.last_scrub.get(ps, 0.0)
                           >= self.scrub_interval)
            if deep_due or shallow_due:
                self.sched.enqueue(
                    "scrub", (ps, "deep" if deep_due else "shallow"))
                self._scrub_queued.add(ps)

    def _do_scrub(self, ps: int, kind: str) -> None:
        self._scrub_queued.discard(ps)
        be = self.pgs[ps]
        dead = self._dead_osds()
        if ps in self.backfills or any(o in dead for o in be.acting):
            return  # went unhealthy while queued; rescheduled when due
        if kind == "deep":
            rep = be.deep_scrub()
            errs = len(rep["inconsistent"]) + len(
                rep.get("digest_mismatch", []))
            self.last_deep_scrub[ps] = self.now
            self.last_scrub[ps] = self.now  # deep subsumes shallow
            self.perf.inc("scrubs_deep")
        else:
            rep = be.shallow_scrub()
            errs = len(rep["errors"])
            self.last_scrub[ps] = self.now
            self.perf.inc("scrubs_shallow")
        if errs:
            self.perf.inc("scrub_errors", errs)
            self.scrub_reports[ps] = rep
            g_log.dout("scrub", 0,
                       f"pg 1.{ps} {kind} scrub: {errs} error(s)")
        else:
            # a clean scrub clears any stale error report — monitoring
            # must not show a repaired PG as inconsistent forever
            self.scrub_reports.pop(ps, None)

    # -- op pump ------------------------------------------------------------

    def _pump(self) -> None:
        """One scheduler drain per tick step: background work (backfill
        copies, scrubs) executes in mClock order until every class is
        limit-bound for this instant of virtual time."""
        for cls, op in self.sched.drain(self.now):
            if cls == "background_recovery":
                self._do_backfill_copy(*op)
            elif cls == "scrub":
                self._do_scrub(*op)
        self._complete_backfills()

    # -- health -------------------------------------------------------------

    def pg_state(self, ps: int) -> str:
        """Current pg_state string from a fresh peering pass (the
        `ceph pg stat` view), up_thru consult included."""
        return self._peer_classify(ps).state

    def health(self) -> dict:
        states = {ps: self.pg_state(ps) for ps in range(self.pg_num)}
        return {
            "epoch": self.osdmap.epoch,
            "mon_quorum": self.mons.quorum(),
            "mon_leader": self.mons.leader(),
            "osds_up": int(self.osdmap.osd_up.sum()),
            "osds_alive": int(self.alive.sum()),
            "pgs_active_clean": sum(
                1 for s in states.values() if s == "active+clean"),
            "pgs_degraded": sum(
                1 for s in states.values() if "degraded" in s),
            "pgs_undersized": sum(
                1 for s in states.values() if "undersized" in s),
            "pgs_backfilling": len(self.backfills),
            "pgs_peering": sum(
                1 for s in states.values() if s.startswith("peering")),
            "pgs_down": sum(
                1 for s in states.values()
                if s in ("down", "incomplete")),
            "pg_states": states,
        }

    def df(self) -> dict:
        """`ceph df` (ref: src/mon/PGMap.cc dump_cluster_stats +
        dump_pool_stats_full): logical bytes, raw bytes after EC/
        replication amplification, object + snapshot-clone counts."""
        objects = clones = 0
        logical = 0
        for ps in range(self.pg_num):
            be = self.pgs[ps]
            for name in be.list_pg_objects():
                sz = be.stat_object(name)
                if self._SNAP_SEP in name:
                    clones += 1
                else:
                    objects += 1
                logical += sz
        k = self.pool_size - self.m
        raw = logical * self.pool_size // max(1, k) if self.is_erasure \
            else logical * self.pool_size
        return {
            "pools": {"default": {
                "id": 1, "objects": objects, "snap_clones": clones,
                "bytes_used": logical, "bytes_raw": raw,
                "amplification": round(raw / logical, 2) if logical
                else (self.pool_size / k if self.is_erasure
                      else float(self.pool_size)),
            }},
            "cluster": {"osds": len(self.alive),
                        "osds_in": int((self.osdmap.osd_weight > 0)
                                       .sum()),
                        "bytes_used_raw": raw},
        }

    def verify_all(self, expected: dict[str, np.ndarray]) -> int:
        """Read every object back and byte-compare; returns count."""
        ok = 0
        for name, data in expected.items():
            got = self.read(name)
            if not np.array_equal(got, np.asarray(data, np.uint8)):
                raise AssertionError(f"data loss: {name}")
            ok += 1
        return ok
