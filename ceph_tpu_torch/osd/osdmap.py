"""OSDMap — the epoch-versioned cluster map: object -> PG -> OSDs.

Twin of ceph_tpu/osd/osdmap.py; the placement layer above CRUSH (ref:
src/osd/OSDMap.{h,cc} — object_locator_to_pg, raw_pg_to_pps via
ceph_stable_mod, _pg_to_raw_osds, pg_to_up_acting_osds with
pg_temp/primary_temp overrides; pool model ref: pg_pool_t in
src/osd/osd_types.h; string hash ref: src/common/ceph_hash.cc
ceph_str_hash_rjenkins).

The per-PG scalar path (`pg_to_up_acting_osds`) runs the host oracle,
as in the twin. The batched path — `pgs_to_up(pool, ps_array)` and its
siblings — pushes the whole PG population through the torch
VectorMapper on the map's device (`device=None`: the CUDA device,
raising without one); sparse pg_temp/primary_temp/upmap overrides are
applied host-side after. Maps made from a map (`shallow_clone`,
`Incremental.apply`) keep its device and share its mapper.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..crush.hash import hash32_2
from ..crush.map import CRUSH_ITEM_NONE, CrushMap
from ..crush.mapper import VectorMapper
from ..crush.oracle import OracleMapper


def ceph_stable_mod(x: int | np.ndarray, b: int, bmask: int):
    """Stable modulo: doubling b reshuffles only the new half of the
    space (what makes pg_num growth cheap)."""
    lo = x & bmask
    return np.where(lo < b, lo, x & (bmask >> 1)) if isinstance(
        x, np.ndarray) else (lo if lo < b else x & (bmask >> 1))


def pg_num_mask(pg_num: int) -> int:
    """Smallest 2^n-1 >= pg_num-1 (the reference's calc_pg_masks)."""
    if pg_num < 1:
        raise ValueError("pg_num must be >= 1")
    return (1 << (pg_num - 1).bit_length()) - 1


def str_hash_rjenkins(s: bytes | str) -> int:
    """Bob Jenkins' lookup2 string hash, the object-name hash (role of
    ceph_str_hash_rjenkins). Shares the mixing round with crush.hash."""
    if isinstance(s, str):
        s = s.encode()
    M = 0xFFFFFFFF

    def mix(a, b, c):
        from ..crush.hash import _mix
        with np.errstate(over="ignore"):
            a, b, c = _mix(np.uint32(a), np.uint32(b), np.uint32(c))
        return int(a), int(b), int(c)

    a = b = 0x9E3779B9
    c = 0
    n = len(s)
    i = 0
    while n - i >= 12:
        a = (a + int.from_bytes(s[i:i + 4], "little")) & M
        b = (b + int.from_bytes(s[i + 4:i + 8], "little")) & M
        c = (c + int.from_bytes(s[i + 8:i + 12], "little")) & M
        a, b, c = mix(a, b, c)
        i += 12
    c = (c + n) & M
    tail = s[i:]
    for idx, shift in ((10, 24), (9, 16), (8, 8)):
        if len(tail) > idx:
            c = (c + (tail[idx] << shift)) & M
    for idx, shift in ((7, 24), (6, 16), (5, 8), (4, 0)):
        if len(tail) > idx:
            b = (b + (tail[idx] << shift)) & M
    for idx, shift in ((3, 24), (2, 16), (1, 8), (0, 0)):
        if len(tail) > idx:
            a = (a + (tail[idx] << shift)) & M
    a, b, c = mix(a, b, c)
    return c


#: per-OSD fullness ladder states carried on the map (r21 capacity
#: plane; ref: osd_state NEARFULL/BACKFILLFULL/FULL in osd_types.h).
#: Absent from osd_full_state == 0 == plenty of room.
FULL_NONE = 0
FULL_NEARFULL = 1
FULL_BACKFILLFULL = 2
FULL_FULL = 3
FULL_STATE_NAMES = {FULL_NEARFULL: "nearfull",
                    FULL_BACKFILLFULL: "backfillfull",
                    FULL_FULL: "full"}


@dataclass
class PGPool:
    """pg_pool_t equivalent: placement parameters of one pool."""
    pool_id: int
    pg_num: int
    size: int                      # replicas / k+m
    min_size: int
    crush_rule: int
    is_erasure: bool = False
    pgp_num: int | None = None
    ec_profile: dict = field(default_factory=dict)
    # pool snapshots (ref: pg_pool_t::snap_seq/snaps — monitor-owned,
    # distributed to OSDs/clients inside the map): sid -> snap name
    snap_seq: int = 0
    snaps: dict = field(default_factory=dict)
    # pool quotas (ref: pg_pool_t::quota_max_bytes/quota_max_objects):
    # the leader compares MgrReport pool aggregates against these and
    # flips the pool's FULL flag on the map; 0 = unlimited
    quota_max_bytes: int = 0
    quota_max_objects: int = 0

    def __post_init__(self):
        if self.pgp_num is None:
            self.pgp_num = self.pg_num
        self.pg_mask = pg_num_mask(self.pg_num)
        self.pgp_mask = pg_num_mask(self.pgp_num)

    def raw_pg_to_pps(self, ps: int | np.ndarray):
        """Placement seed: stable-mod onto pgp_num then mix with the
        pool id (the HASHPSPOOL behavior, the modern default)."""
        m = ceph_stable_mod(ps, self.pgp_num, self.pgp_mask)
        if isinstance(ps, np.ndarray):
            return np.asarray(hash32_2(m.astype(np.uint32),
                                       np.uint32(self.pool_id)))
        return int(hash32_2(np.uint32(m), np.uint32(self.pool_id)))


def _encode_pool(en, p: "PGPool") -> None:
    # v2 appends snap_seq + snaps, v3 quotas; compat 1 (old readers
    # skip the tail via the section length)
    en.start(3, 1)
    en.i32(p.pool_id).u32(p.pg_num).u32(p.size).u32(p.min_size)
    en.i32(p.crush_rule).boolean(p.is_erasure).u32(p.pgp_num)
    en.mapping(p.ec_profile, lambda e2, k: e2.string(k),
               lambda e2, v: e2.string(str(v)))
    en.u64(p.snap_seq)
    en.mapping(p.snaps, lambda e2, k: e2.u64(k),
               lambda e2, v: e2.string(v))
    en.u64(p.quota_max_bytes)
    en.u64(p.quota_max_objects)
    en.finish()


def _decode_pool(dd) -> "PGPool":
    pv = dd.start(3)
    p = PGPool(dd.i32(), dd.u32(), dd.u32(), dd.u32(), dd.i32(),
               dd.boolean(), dd.u32(),
               dd.mapping(lambda e2: e2.string(),
                          lambda e2: e2.string()))
    if pv >= 2:
        p.snap_seq = dd.u64()
        p.snaps = dd.mapping(lambda e2: e2.u64(),
                             lambda e2: e2.string())
    if pv >= 3:
        p.quota_max_bytes = dd.u64()
        p.quota_max_objects = dd.u64()
    dd.finish()
    return p


class OSDMap:
    """Cluster map: CRUSH topology + pools + per-OSD runtime state."""

    def __init__(self, crush: CrushMap, epoch: int = 1, device=None):
        self.crush = crush
        self.epoch = epoch
        self.pools: dict[int, PGPool] = {}
        n = crush.n_devices
        self.osd_weight = np.full(n, 0x10000, dtype=np.int32)  # in/out 16.16
        self.osd_up = np.ones(n, dtype=bool)
        # per-OSD up_thru (ref: osd_info_t::up_thru, recorded by
        # OSDMonitor on MOSDAlive): the newest epoch through which the
        # monitors have PROOF the OSD was up and serving. A primary
        # must get its up_thru recorded at (or past) its interval's
        # start epoch before the PG may go active — so peering can
        # later decide whether a past interval could possibly have
        # served writes (maybe_went_rw) without asking its dead
        # members (ref: PastIntervals::check_new_interval).
        self.osd_up_thru = np.zeros(n, dtype=np.int64)
        self.pg_temp: dict[tuple[int, int], list[int]] = {}
        self.primary_temp: dict[tuple[int, int], int] = {}
        # balancer overrides (ref: OSDMap pg_upmap_items + _apply_upmap)
        self.pg_upmap_items: dict[tuple[int, int],
                                  list[tuple[int, int]]] = {}
        # centralized config KV (role of the ConfigMonitor store, ref:
        # src/mon/ConfigMonitor.cc — `ceph config set` lands here).
        # Re-design: rather than a second PaxosService, the KV rides
        # the same replicated value the monitors already run Paxos
        # over; daemons apply it at their config system's "mon" layer
        # on every map commit (defaults < file < mon < override).
        self.config_kv: dict[str, str] = {}
        # monitor membership (role of the MonMap, ref: src/mon/
        # MonMap.h + MonmapMonitor.cc). Re-design, same pattern as
        # config_kv: rather than a second PaxosService with its own
        # epoch, the member list rides the one replicated value the
        # monitors run Paxos over — membership changes ARE map
        # commits, so quorum math moves atomically with the commit
        # that changes it.
        self.mon_members: list[int] = [0, 1, 2]
        # OSDs an ADMINISTRATOR marked out (`ceph osd out`): sticky
        # across daemon restarts, unlike the failure path's auto-out
        # which a boot reverses (ref: osd_state AUTOOUT vs admin
        # weight changes in OSDMonitor)
        self.osd_admin_out: set[int] = set()
        # r21 capacity plane: per-OSD fullness ladder state (osd ->
        # FULL_NEARFULL/BACKFILLFULL/FULL; absent = fine), the
        # cluster-wide FULL flag (any device at mon_osd_full_ratio —
        # clients park writes), and per-pool FULL flags from quota
        # enforcement (ref: OSDMAP_FULL + pg_pool_t FLAG_FULL)
        self.osd_full_state: dict[int, int] = {}
        self.cluster_full: bool = False
        self.full_pools: set[int] = set()
        self._vm = VectorMapper(crush, device=device)
        self._om = OracleMapper(crush)

    @property
    def device(self):
        """The device the batched placement runs on."""
        return self._vm.device

    # -- wire form (ref: OSDMap::encode/decode) -----------------------------

    def encode(self) -> bytes:
        """Versioned wire form: epoch, crush map, per-OSD runtime state,
        pools, temp overrides (ref: src/osd/OSDMap.cc encode)."""
        from ..utils.encoding import Encoder
        # v2 appends pg_upmap_items, v3 config_kv, v4 mon_members,
        # v5 osd_admin_out, v6 osd_up_thru, v7 the capacity plane
        # (osd_full_state + cluster_full + full_pools); compat stays 1
        # (an old reader skips the tail via the section length — the
        # ENCODE_START contract)
        e = Encoder().start(7, 1)
        e.u32(self.epoch)
        e.blob(self.crush.encode())
        e.list([int(w) for w in self.osd_weight],
               lambda en, w: en.i32(w))
        e.list([bool(u) for u in self.osd_up],
               lambda en, u: en.boolean(u))
        e.list([self.pools[k] for k in sorted(self.pools)], _encode_pool)
        e.mapping(self.pg_temp,
                  lambda en, k: en.i32(k[0]).u32(k[1]),
                  lambda en, v: en.list(v, lambda e2, o: e2.i32(o)))
        e.mapping(self.primary_temp,
                  lambda en, k: en.i32(k[0]).u32(k[1]),
                  lambda en, v: en.i32(v))
        e.mapping(self.pg_upmap_items,
                  lambda en, k: en.i32(k[0]).u32(k[1]),
                  lambda en, v: en.list(
                      v, lambda e2, ft: e2.i32(ft[0]).i32(ft[1])))
        e.mapping(self.config_kv, lambda en, k: en.string(k),
                  lambda en, v: en.string(v))
        e.list(self.mon_members, lambda e2, r: e2.i32(r))
        e.list(sorted(self.osd_admin_out), lambda e2, o: e2.i32(o))
        e.list([int(t) for t in self.osd_up_thru],
               lambda e2, t: e2.u64(t))
        e.mapping({int(o): int(s)
                   for o, s in sorted(self.osd_full_state.items())},
                  lambda e2, o: e2.i32(o), lambda e2, s: e2.u32(s))
        e.boolean(self.cluster_full)
        e.list(sorted(self.full_pools), lambda e2, p: e2.i32(p))
        return e.finish().bytes()

    @classmethod
    def decode(cls, data: bytes, device=None) -> "OSDMap":
        from ..utils.encoding import Decoder
        d = Decoder(data)
        v = d.start(7)
        epoch = d.u32()
        crush = CrushMap.decode(d.blob())
        m = cls(crush, epoch=epoch, device=device)
        weights = d.list(lambda dd: dd.i32())
        ups = d.list(lambda dd: dd.boolean())
        m.osd_weight = np.asarray(weights, dtype=np.int32)
        m.osd_up = np.asarray(ups, dtype=bool)
        for p in d.list(_decode_pool):
            m.pools[p.pool_id] = p
        m.pg_temp = d.mapping(lambda dd: (dd.i32(), dd.u32()),
                              lambda dd: dd.list(lambda e2: e2.i32()))
        m.primary_temp = d.mapping(lambda dd: (dd.i32(), dd.u32()),
                                   lambda dd: dd.i32())
        if v >= 2:
            m.pg_upmap_items = d.mapping(
                lambda dd: (dd.i32(), dd.u32()),
                lambda dd: dd.list(lambda e2: (e2.i32(), e2.i32())))
        if v >= 3:
            m.config_kv = d.mapping(lambda dd: dd.string(),
                                    lambda dd: dd.string())
        if v >= 4:
            m.mon_members = d.list(lambda dd: dd.i32())
        if v >= 5:
            m.osd_admin_out = set(d.list(lambda dd: dd.i32()))
        if v >= 6:
            m.osd_up_thru = np.asarray(d.list(lambda dd: dd.u64()),
                                       dtype=np.int64)
        if v >= 7:
            m.osd_full_state = d.mapping(lambda dd: dd.i32(),
                                         lambda dd: dd.u32())
            m.cluster_full = d.boolean()
            m.full_pools = set(d.list(lambda dd: dd.i32()))
        d.finish()
        return m

    # -- mutators (each bumps the epoch like an inc map) -------------------

    def _bump(self):
        self.epoch += 1
        self.__dict__.pop("_placement_cache", None)

    def add_pool(self, pool: PGPool) -> None:
        if pool.crush_rule not in self.crush.rules:
            raise ValueError(f"pool rule {pool.crush_rule} not in crush map")
        self.pools[pool.pool_id] = pool
        self._bump()

    def mark_down(self, osd: int) -> None:
        self.osd_up[osd] = False
        self.clean_pg_upmaps()
        self._bump()

    def mark_up(self, osd: int) -> None:
        self.osd_up[osd] = True
        self._bump()

    def record_up_thru(self, osd: int, epoch: int | None = None) -> None:
        """Record that `osd` was up through `epoch` (default: the
        current epoch) — the OSDMonitor's MOSDAlive handling (ref:
        OSDMonitor::prepare_alive -> osd_info_t::up_thru). Monotone
        and idempotent: a stale or duplicate request rebases to a
        no-op on the proposal pipe."""
        epoch = self.epoch if epoch is None else int(epoch)
        if not self.osd_up[osd] or self.osd_up_thru[osd] >= epoch:
            return
        self.osd_up_thru[osd] = epoch
        self._bump()

    def mark_out(self, osd: int) -> None:
        self.osd_weight[osd] = 0
        self.clean_pg_upmaps()
        self._bump()

    def config_set(self, key: str, value: str) -> None:
        """Centralized `ceph config set` (ref: ConfigMonitor::
        prepare_command): idempotent — an unchanged value does not
        bump the epoch, so a replayed/duplicate op rebases to a
        no-op on the monitors' proposal pipe."""
        value = str(value)
        if self.config_kv.get(key) == value:
            return
        self.config_kv[key] = value
        self._bump()

    def mon_join(self, rank: int) -> None:
        """Admit a monitor to the quorum (ref: MonmapMonitor handling
        MMonJoin). Idempotent: a duplicate rebases to a no-op."""
        if rank in self.mon_members:
            return
        self.mon_members = sorted(self.mon_members + [rank])
        self._bump()

    def mon_leave(self, rank: int) -> None:
        """Remove a monitor from the quorum (`ceph mon remove`) —
        idempotent like mon_join."""
        if rank not in self.mon_members:
            return
        self.mon_members = [r for r in self.mon_members if r != rank]
        self._bump()

    def config_rm(self, key: str) -> None:
        """Centralized `ceph config rm` — idempotent like config_set."""
        if key not in self.config_kv:
            return
        del self.config_kv[key]
        self._bump()

    def set_pg_upmap_items(self, pg: tuple[int, int],
                           items: list[tuple[int, int]]) -> None:
        """Balancer override: per-PG (from_osd, to_osd) redirects
        (ref: `ceph osd pg-upmap-items`). Empty list clears."""
        if items:
            self.pg_upmap_items[pg] = [(int(f), int(t)) for f, t in items]
        else:
            self.pg_upmap_items.pop(pg, None)
        self._bump()

    def set_pg_upmap_bulk(self, updates: dict) -> None:
        """Apply MANY per-PG upmap overrides as ONE map epoch — the
        shape a balancer round lands in the real cluster (one monitor
        commit carries the whole batch, not one epoch per PG). Empty
        item lists clear their entries."""
        if not updates:
            return
        for pg, items in updates.items():
            if items:
                self.pg_upmap_items[pg] = [(int(f), int(t))
                                           for f, t in items]
            else:
                self.pg_upmap_items.pop(pg, None)
        self._bump()

    def clean_pg_upmaps(self) -> None:
        """Drop upmap entries that can no longer be honored (ref:
        OSDMap::clean_pg_upmaps + OSDMonitor maybe_remove_pg_upmaps,
        run on map changes so stale balancer decisions never pin data
        to dead devices): a redirect dies when its target OSD is out
        OR down (a down target cannot serve the shard it pins), and a
        whole entry dies when its pool is gone or its ps outgrew the
        pool's pg space."""
        for pg, items in list(self.pg_upmap_items.items()):
            pool = self.pools.get(pg[0])
            if pool is None or pg[1] >= pool.pg_num:
                del self.pg_upmap_items[pg]
                continue
            kept = [(f, t) for f, t in items
                    if t < len(self.osd_weight)
                    and self.osd_weight[t] > 0 and self.osd_up[t]]
            if len(kept) != len(items):
                if kept:
                    self.pg_upmap_items[pg] = kept
                else:
                    del self.pg_upmap_items[pg]

    def remove_pool(self, pool_id: int) -> None:
        """Delete a pool and every per-PG override keyed to it (ref:
        OSDMonitor pool deletion -> OSDMap::Incremental old_pools).
        Idempotent: removing an absent pool is a no-op."""
        if pool_id not in self.pools:
            return
        del self.pools[pool_id]
        for d in (self.pg_temp, self.primary_temp, self.pg_upmap_items):
            for pg in [k for k in d if k[0] == pool_id]:
                del d[pg]
        self._bump()

    def mark_in(self, osd: int, weight: float = 1.0) -> None:
        self.osd_weight[osd] = int(weight * 0x10000)
        self._bump()

    def pool_mksnap(self, pool_id: int, name: str) -> None:
        """Take a named pool snapshot (ref: OSDMonitor pool mksnap ->
        pg_pool_t::add_snap). Idempotent by NAME so the same request
        queued on several monitors commits exactly one snap."""
        p = self.pools[pool_id]
        if name in p.snaps.values():
            return
        p.snap_seq += 1
        p.snaps[p.snap_seq] = name
        self._bump()

    def pool_rmsnap(self, pool_id: int, name: str) -> None:
        p = self.pools[pool_id]
        sids = [s for s, n in p.snaps.items() if n == name]
        if not sids:
            return
        for s in sids:
            del p.snaps[s]
        self._bump()

    def set_pg_temp(self, pg: tuple[int, int], acting: list[int]) -> None:
        if acting:
            self.pg_temp[pg] = list(acting)
        else:
            self.pg_temp.pop(pg, None)
        self._bump()

    def set_pg_num(self, pool_id: int, pg_num: int) -> None:
        """Grow a pool's pg_num (and pgp_num with it) — the map half of
        a PG split (ref: src/mon/OSDMonitor.cc pg_num handling). The
        stable_mod hash space makes this cheap: surviving parents keep
        their ps (stable_mod is the identity below the old pg_num), so
        only split-off children remap. Shrinking (PG merge) is not
        supported."""
        pool = self.pools[pool_id]
        if pg_num < pool.pg_num:
            raise ValueError(f"pg_num {pg_num} < current {pool.pg_num}: "
                             f"merges not supported")
        if pg_num == pool.pg_num:
            return
        pool.pg_num = pool.pgp_num = pg_num
        pool.pg_mask = pool.pgp_mask = pg_num_mask(pg_num)
        self._bump()

    def set_primary_temp(self, pg: tuple[int, int], osd: int | None) -> None:
        if osd is None:
            self.primary_temp.pop(pg, None)
        else:
            self.primary_temp[pg] = osd
        self._bump()

    # -- capacity plane (r21) -----------------------------------------------

    def full_state_of(self, osd: int) -> int:
        """Ladder state of one OSD (FULL_NONE when unlisted)."""
        return self.osd_full_state.get(int(osd), FULL_NONE)

    def set_full_states(self, osd_states: dict[int, int],
                        cluster_full: bool,
                        full_pools) -> None:
        """Commit the leader's evaluated ladder in ONE epoch (per-OSD
        states + cluster flag + quota-tripped pools). Idempotent: the
        closure rebases to a no-op when the committed map already
        carries the same evaluation — the ladder re-runs every leader
        tick and must not churn epochs."""
        osd_states = {int(o): int(s) for o, s in osd_states.items()
                      if int(s) != FULL_NONE}
        cluster_full = bool(cluster_full)
        full_pools = {int(p) for p in full_pools}
        if (osd_states == self.osd_full_state
                and cluster_full == self.cluster_full
                and full_pools == self.full_pools):
            return
        self.osd_full_state = osd_states
        self.cluster_full = cluster_full
        self.full_pools = full_pools
        self._bump()

    def set_pool_quota(self, pool_id: int, max_bytes: int,
                       max_objects: int) -> None:
        """`ceph osd pool set-quota` — idempotent like config_set."""
        p = self.pools[pool_id]
        max_bytes, max_objects = int(max_bytes), int(max_objects)
        if (p.quota_max_bytes, p.quota_max_objects) \
                == (max_bytes, max_objects):
            return
        p.quota_max_bytes = max_bytes
        p.quota_max_objects = max_objects
        self._bump()

    # -- object -> PG -------------------------------------------------------

    def object_to_pg(self, pool_id: int, name: bytes | str) -> tuple[int, int]:
        pool = self.pools[pool_id]
        ps = ceph_stable_mod(str_hash_rjenkins(name), pool.pg_num,
                             pool.pg_mask)
        return (pool_id, ps)

    # -- PG -> OSDs ---------------------------------------------------------

    def _raw_pg_to_osds(self, pool: PGPool, ps: int) -> list[int]:
        pps = pool.raw_pg_to_pps(ps)
        out = self._om.do_rule(pool.crush_rule, pps, self.osd_weight,
                               pool.size)
        return (out + [CRUSH_ITEM_NONE] * pool.size)[:pool.size]

    def _apply_upmap(self, pool_id: int, ps: int,
                     raw: list[int]) -> list[int]:
        """pg_upmap_items overrides (ref: OSDMap::_apply_upmap): each
        (from, to) pair redirects that OSD's slot for this PG — the
        balancer's fine-grained placement override."""
        items = self.pg_upmap_items.get((pool_id, ps))
        if not items:
            return raw
        out = list(raw)
        for frm, to in items:
            if to in out:
                continue  # a duplicate target would break slot sets
            for i, o in enumerate(out):
                if o == frm:
                    out[i] = to
                    break
        return out

    def _up_from_raw(self, raw: list[int]) -> list[int]:
        """raw -> up: down OSDs become NONE holes (EC keeps slot order;
        the reference filters in _raw_to_up_osds)."""
        return [o if (o != CRUSH_ITEM_NONE and o < len(self.osd_up)
                      and self.osd_up[o]) else CRUSH_ITEM_NONE for o in raw]

    @staticmethod
    def _primary_of(osds: list[int]) -> int:
        for o in osds:
            if o != CRUSH_ITEM_NONE:
                return o
        return -1

    def pg_to_up_acting_osds(self, pool_id: int, ps: int):
        """Returns (up, up_primary, acting, acting_primary) — the full
        override pipeline: raw CRUSH -> drop down OSDs -> pg_temp /
        primary_temp. Memoized per epoch: placement is pure in the map
        state, and the wire tier recomputes it on every client op and
        daemon dispatch (the CRUSH walk dominated the plain-mode rados
        bench profile); any mutation clears the cache via _bump."""
        cache = self.__dict__.setdefault("_placement_cache", {})
        hit = cache.get((pool_id, ps))
        if hit is not None:
            return hit
        pool = self.pools[pool_id]
        raw = self._apply_upmap(pool_id, ps,
                                self._raw_pg_to_osds(pool, ps))
        up = self._up_from_raw(raw)
        up_primary = self._primary_of(up)
        acting = self.pg_temp.get((pool_id, ps), up)
        acting_primary = self.primary_temp.get((pool_id, ps),
                                               self._primary_of(acting))
        out = (up, up_primary, acting, acting_primary)
        cache[(pool_id, ps)] = out
        return out

    def pg_to_acting_osds(self, pool_id: int, ps: int) -> list[int]:
        return self.pg_to_up_acting_osds(pool_id, ps)[2]

    # -- batched PG -> OSDs (the device path) -------------------------------

    def pgs_to_raw(self, pool_id: int, ps: np.ndarray | None = None):
        """Raw CRUSH output for ALL (or the given) PGs of a pool in one
        vectorized launch: NO upmap overlay, NO down-filtering — the
        balancer's ground truth (a down-but-in member still owns its
        slot, and failure-domain math must derive from it)."""
        pool = self.pools[pool_id]
        if ps is None:
            ps = np.arange(pool.pg_num, dtype=np.uint32)
        ps = np.asarray(ps, np.uint32)
        pps = pool.raw_pg_to_pps(ps)
        raw = self._vm.do_rule(pool.crush_rule, pps, self.osd_weight,
                               pool.size).cpu().numpy()
        return raw[:, :pool.size].copy()

    def pgs_to_up(self, pool_id: int, ps: np.ndarray | None = None):
        """Map ALL (or the given) PGs of a pool in one vectorized launch.

        Returns (B, size) int32 UP sets with CRUSH_ITEM_NONE holes.
        Like the scalar path, pg_temp does NOT affect up — it only
        overrides acting (see pgs_to_acting).
        """
        pool = self.pools[pool_id]
        if ps is None:
            ps = np.arange(pool.pg_num, dtype=np.uint32)
        ps = np.asarray(ps, np.uint32)
        raw = self.pgs_to_raw(pool_id, ps)
        if self.pg_upmap_items:
            # sparse host-side overlay (like pg_temp in pgs_to_acting):
            # upmaps are rare relative to pg_num
            pos_of = {int(p): i for i, p in enumerate(ps)}
            for (pid, s), items in self.pg_upmap_items.items():
                if pid != pool_id or s not in pos_of:
                    continue
                raw[pos_of[s]] = self._apply_upmap(
                    pid, s, [int(o) for o in raw[pos_of[s]]])
        # down OSDs -> NONE
        down_lut = ~self.osd_up
        idx = np.clip(raw, 0, len(self.osd_up) - 1)
        is_down = np.where(raw >= 0, down_lut[idx], False)
        return np.where(is_down, np.int32(CRUSH_ITEM_NONE), raw)

    def pgs_to_acting(self, pool_id: int, ps: np.ndarray | None = None):
        """Batched acting sets: up overridden by the sparse pg_temp
        entries (host-side; backfill state is rare and transient)."""
        pool = self.pools[pool_id]
        if ps is None:
            ps = np.arange(pool.pg_num, dtype=np.uint32)
        ps = np.asarray(ps, np.uint32)
        acting = self.pgs_to_up(pool_id, ps).copy()
        for (pid, s), override in self.pg_temp.items():
            if pid == pool_id:
                hit = np.nonzero(ps == s)[0]
                if hit.size:
                    row = (list(override) + [CRUSH_ITEM_NONE] * pool.size)
                    acting[hit[0]] = row[:pool.size]
        return acting

    def pg_stats(self, pool_id: int):
        """Placement summary over the whole pool: per-OSD PG counts and
        degraded (holey) PG count — what `ceph osd df` surfaces."""
        up = self.pgs_to_up(pool_id)
        real = up[up != CRUSH_ITEM_NONE]
        counts = np.bincount(real, minlength=len(self.osd_up))
        degraded = int((up == CRUSH_ITEM_NONE).any(axis=1).sum())
        return {"pg_per_osd": counts, "degraded_pgs": degraded}

    # -- cloning / comparison ------------------------------------------------

    def shallow_clone(self) -> "OSDMap":
        """Structural copy sharing the (immutable-in-practice) CRUSH
        map and its compiled mappers: O(n_osds) array copies + dict
        copies, no re-decode. This is what an incremental apply
        mutates so readers holding the old map object never see a
        half-applied epoch."""
        c = object.__new__(OSDMap)
        c.crush = self.crush
        c.epoch = self.epoch
        c.pools = {
            pid: PGPool(p.pool_id, p.pg_num, p.size, p.min_size,
                        p.crush_rule, p.is_erasure, p.pgp_num,
                        dict(p.ec_profile), p.snap_seq, dict(p.snaps),
                        p.quota_max_bytes, p.quota_max_objects)
            for pid, p in self.pools.items()}
        c.osd_weight = self.osd_weight.copy()
        c.osd_up = self.osd_up.copy()
        c.osd_up_thru = self.osd_up_thru.copy()
        c.pg_temp = {k: list(v) for k, v in self.pg_temp.items()}
        c.primary_temp = dict(self.primary_temp)
        c.pg_upmap_items = {k: list(v)
                            for k, v in self.pg_upmap_items.items()}
        c.config_kv = dict(self.config_kv)
        c.mon_members = list(self.mon_members)
        c.osd_admin_out = set(self.osd_admin_out)
        c.osd_full_state = dict(self.osd_full_state)
        c.cluster_full = self.cluster_full
        c.full_pools = set(self.full_pools)
        c._vm = self._vm
        c._om = self._om
        return c


def same_state(a: "OSDMap", b: "OSDMap") -> bool:
    """Canonical (order-insensitive) equality of two maps — what the
    incremental-map property tests pin: a follower that applied the
    delta chain must be indistinguishable from the leader. Byte
    equality of encode() is NOT required (mapping sections ride dict
    insertion order, which legitimately differs across histories)."""
    if a.epoch != b.epoch or a.pools != b.pools:
        return False
    if a.osd_weight.tolist() != b.osd_weight.tolist() \
            or a.osd_up.tolist() != b.osd_up.tolist() \
            or a.osd_up_thru.tolist() != b.osd_up_thru.tolist():
        return False
    if a.pg_temp != b.pg_temp or a.primary_temp != b.primary_temp \
            or a.pg_upmap_items != b.pg_upmap_items:
        return False
    if a.config_kv != b.config_kv or a.mon_members != b.mon_members \
            or a.osd_admin_out != b.osd_admin_out:
        return False
    if a.osd_full_state != b.osd_full_state \
            or a.cluster_full != b.cluster_full \
            or a.full_pools != b.full_pools:
        return False
    return (a.crush is b.crush) or a.crush.encode() == b.crush.encode()


class Incremental:
    """OSDMap delta — the epoch-to-epoch wire unit (ref: src/osd/
    OSDMap.h OSDMap::Incremental — new_up_client/new_weight/new_state,
    new_pg_temp, new_pg_upmap_items, new_pools/old_pools, fullmap
    fallback; distributed by the monitors so map churn at 10k OSDs
    ships deltas instead of full maps).

    Construction is diff-based (`Incremental.diff(old, new)`): the
    monitors' mutate closures already produce the post-change map, so
    the delta is derived rather than accumulated — one code path no
    matter which mutator ran. A CRUSH topology change (rare: device
    add at the crush level) falls back to carrying the full map blob,
    exactly the reference's `fullmap` member.

    Erase sentinels: pg_temp/pg_upmap_items erase as empty lists,
    primary_temp as -1 — the same convention the mutators use.
    """

    def __init__(self, epoch: int, base_epoch: int):
        self.epoch = epoch
        self.base_epoch = base_epoch
        self.full_blob: bytes | None = None
        self.new_up: list[int] = []
        self.new_down: list[int] = []
        self.new_weights: dict[int, int] = {}
        self.new_up_thru: dict[int, int] = {}
        self.new_pools: list[PGPool] = []
        self.removed_pools: list[int] = []
        self.new_pg_temp: dict[tuple[int, int], list[int]] = {}
        self.new_primary_temp: dict[tuple[int, int], int] = {}
        self.new_pg_upmap_items: dict[tuple[int, int],
                                      list[tuple[int, int]]] = {}
        self.new_config: dict[str, str] = {}
        self.removed_config: list[str] = []
        self.new_mon_members: list[int] | None = None
        self.new_admin_out: list[int] | None = None
        # r21 capacity plane: full-replacement deltas (the state is
        # O(n_osds) at worst, and a partial merge could resurrect a
        # cleared flag) — presence-boolean encoded like mon_members
        self.new_full_state: dict[int, int] | None = None
        self.new_cluster_full: bool | None = None
        self.new_full_pools: list[int] | None = None

    # -- construction --------------------------------------------------------

    @classmethod
    def diff(cls, old: "OSDMap", new: "OSDMap") -> "Incremental":
        inc = cls(new.epoch, old.epoch)
        crush_same = (old.crush is new.crush) \
            or old.crush.encode() == new.crush.encode()
        if not crush_same or len(old.osd_up) != len(new.osd_up):
            # topology changed: ship the full map (the reference's
            # Incremental::fullmap escape hatch)
            inc.full_blob = new.encode()
            return inc
        for o in np.nonzero(old.osd_up != new.osd_up)[0]:
            (inc.new_up if new.osd_up[o] else inc.new_down).append(int(o))
        for o in np.nonzero(old.osd_weight != new.osd_weight)[0]:
            inc.new_weights[int(o)] = int(new.osd_weight[o])
        for o in np.nonzero(old.osd_up_thru != new.osd_up_thru)[0]:
            inc.new_up_thru[int(o)] = int(new.osd_up_thru[o])
        for pid, p in new.pools.items():
            if old.pools.get(pid) != p:
                inc.new_pools.append(p)
        inc.removed_pools = sorted(pid for pid in old.pools
                                   if pid not in new.pools)
        for attr, out, erase in (
                ("pg_temp", inc.new_pg_temp, []),
                ("primary_temp", inc.new_primary_temp, -1),
                ("pg_upmap_items", inc.new_pg_upmap_items, [])):
            od, nd = getattr(old, attr), getattr(new, attr)
            for k, v in nd.items():
                if od.get(k) != v:
                    out[k] = v
            for k in od:
                if k not in nd:
                    out[k] = erase
        for k, v in new.config_kv.items():
            if old.config_kv.get(k) != v:
                inc.new_config[k] = v
        inc.removed_config = sorted(k for k in old.config_kv
                                    if k not in new.config_kv)
        if old.mon_members != new.mon_members:
            inc.new_mon_members = list(new.mon_members)
        if old.osd_admin_out != new.osd_admin_out:
            inc.new_admin_out = sorted(new.osd_admin_out)
        if old.osd_full_state != new.osd_full_state:
            inc.new_full_state = dict(new.osd_full_state)
        if old.cluster_full != new.cluster_full:
            inc.new_cluster_full = new.cluster_full
        if old.full_pools != new.full_pools:
            inc.new_full_pools = sorted(new.full_pools)
        return inc

    # -- application ---------------------------------------------------------

    def apply(self, m: "OSDMap") -> "OSDMap":
        """Apply onto `m` (must sit at base_epoch) and return the
        post-change map. The delta path mutates `m` IN PLACE —
        callers wanting atomicity clone first (shallow_clone); the
        full-map fallback returns a fresh decode on `m`'s device."""
        if m.epoch != self.base_epoch:
            raise ValueError(f"incremental base {self.base_epoch} "
                             f"!= map epoch {m.epoch}")
        if self.full_blob is not None:
            return OSDMap.decode(self.full_blob, device=m.device)
        for o in self.new_up:
            m.osd_up[o] = True
        for o in self.new_down:
            m.osd_up[o] = False
        for o, w in self.new_weights.items():
            m.osd_weight[o] = w
        for o, t in self.new_up_thru.items():
            m.osd_up_thru[o] = t
        for p in self.new_pools:
            m.pools[p.pool_id] = p
        for pid in self.removed_pools:
            m.pools.pop(pid, None)
        for pg, v in self.new_pg_temp.items():
            if v:
                m.pg_temp[pg] = list(v)
            else:
                m.pg_temp.pop(pg, None)
        for pg, o in self.new_primary_temp.items():
            if o >= 0:
                m.primary_temp[pg] = o
            else:
                m.primary_temp.pop(pg, None)
        for pg, items in self.new_pg_upmap_items.items():
            if items:
                m.pg_upmap_items[pg] = [(int(f), int(t))
                                        for f, t in items]
            else:
                m.pg_upmap_items.pop(pg, None)
        for k, v in self.new_config.items():
            m.config_kv[k] = v
        for k in self.removed_config:
            m.config_kv.pop(k, None)
        if self.new_mon_members is not None:
            m.mon_members = list(self.new_mon_members)
        if self.new_admin_out is not None:
            m.osd_admin_out = set(self.new_admin_out)
        if self.new_full_state is not None:
            m.osd_full_state = dict(self.new_full_state)
        if self.new_cluster_full is not None:
            m.cluster_full = self.new_cluster_full
        if self.new_full_pools is not None:
            m.full_pools = set(self.new_full_pools)
        m.epoch = self.epoch
        m.__dict__.pop("_placement_cache", None)
        return m

    # -- wire form -----------------------------------------------------------

    def encode(self) -> bytes:
        from ..utils.encoding import Encoder
        e = Encoder().start(2, 1)
        e.u32(self.epoch).u32(self.base_epoch)
        e.boolean(self.full_blob is not None)
        if self.full_blob is not None:
            e.blob(self.full_blob)
            return e.finish().bytes()
        def enc_pg(en, k):
            en.i32(k[0]).u32(k[1])
        e.list(self.new_up, lambda en, o: en.i32(o))
        e.list(self.new_down, lambda en, o: en.i32(o))
        e.mapping(self.new_weights, lambda en, k: en.i32(k),
                  lambda en, v: en.i32(v))
        e.mapping(self.new_up_thru, lambda en, k: en.i32(k),
                  lambda en, v: en.u64(v))
        e.list(self.new_pools, _encode_pool)
        e.list(self.removed_pools, lambda en, p: en.i32(p))
        e.mapping(self.new_pg_temp, enc_pg,
                  lambda en, v: en.list(v, lambda e2, o: e2.i32(o)))
        e.mapping(self.new_primary_temp, enc_pg,
                  lambda en, v: en.i32(v))
        e.mapping(self.new_pg_upmap_items, enc_pg,
                  lambda en, v: en.list(
                      v, lambda e2, ft: e2.i32(ft[0]).i32(ft[1])))
        e.mapping(self.new_config, lambda en, k: en.string(k),
                  lambda en, v: en.string(v))
        e.list(self.removed_config, lambda en, k: en.string(k))
        e.boolean(self.new_mon_members is not None)
        if self.new_mon_members is not None:
            e.list(self.new_mon_members, lambda en, r: en.i32(r))
        e.boolean(self.new_admin_out is not None)
        if self.new_admin_out is not None:
            e.list(self.new_admin_out, lambda en, o: en.i32(o))
        e.boolean(self.new_full_state is not None)
        if self.new_full_state is not None:
            e.mapping({int(o): int(s)
                       for o, s in sorted(self.new_full_state.items())},
                      lambda e2, o: e2.i32(o), lambda e2, s: e2.u32(s))
        e.boolean(self.new_cluster_full is not None)
        if self.new_cluster_full is not None:
            e.boolean(self.new_cluster_full)
        e.boolean(self.new_full_pools is not None)
        if self.new_full_pools is not None:
            e.list(self.new_full_pools, lambda e2, p: e2.i32(p))
        return e.finish().bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Incremental":
        from ..utils.encoding import Decoder
        d = Decoder(data)
        v = d.start(2)
        inc = cls(d.u32(), d.u32())
        if d.boolean():
            inc.full_blob = d.blob()
            d.finish()
            return inc
        def dec_pg(dd):
            return (dd.i32(), dd.u32())
        inc.new_up = d.list(lambda dd: dd.i32())
        inc.new_down = d.list(lambda dd: dd.i32())
        inc.new_weights = d.mapping(lambda dd: dd.i32(),
                                    lambda dd: dd.i32())
        inc.new_up_thru = d.mapping(lambda dd: dd.i32(),
                                    lambda dd: dd.u64())
        inc.new_pools = d.list(_decode_pool)
        inc.removed_pools = d.list(lambda dd: dd.i32())
        inc.new_pg_temp = d.mapping(
            dec_pg, lambda dd: dd.list(lambda e2: e2.i32()))
        inc.new_primary_temp = d.mapping(dec_pg, lambda dd: dd.i32())
        inc.new_pg_upmap_items = d.mapping(
            dec_pg,
            lambda dd: dd.list(lambda e2: (e2.i32(), e2.i32())))
        inc.new_config = d.mapping(lambda dd: dd.string(),
                                   lambda dd: dd.string())
        inc.removed_config = d.list(lambda dd: dd.string())
        if d.boolean():
            inc.new_mon_members = d.list(lambda dd: dd.i32())
        if d.boolean():
            inc.new_admin_out = d.list(lambda dd: dd.i32())
        if v >= 2:
            if d.boolean():
                inc.new_full_state = d.mapping(lambda dd: dd.i32(),
                                               lambda dd: dd.u32())
            if d.boolean():
                inc.new_cluster_full = d.boolean()
            if d.boolean():
                inc.new_full_pools = d.list(lambda dd: dd.i32())
        d.finish()
        return inc
