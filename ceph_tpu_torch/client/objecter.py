"""Objecter — the client-side placement + retry layer.

Rebuild of the reference's client op path (ref: src/osdc/Objecter.cc
op_submit -> _calc_target -> _op_submit: the client computes
object -> PG -> primary OSD from ITS OWN cached OSDMap, sends the op,
and when the cluster has moved on — wrong primary, down OSD, newer
epoch — it refreshes its map, recomputes the target, and RESENDS
without the caller ever noticing; librados ref: src/librados/
IoCtxImpl.cc rados_write/rados_read on top of it).

The sim transport is SimCluster.client_rpc, which behaves like a
primary OSD session: it rejects ops addressed to the wrong primary
with StaleMap (the reference OSD shares its newer map with the
sender) and refuses connections to dead processes (lossy client
connection). All data-plane batching stays intact: a write dict is
grouped per PG and each PG's group is one batched submission."""

from __future__ import annotations

import numpy as np

from ..utils.perf_counters import PerfCountersBuilder


class ObjecterError(RuntimeError):
    pass


class Objecter:
    """Client session against a SimCluster."""

    MAX_ATTEMPTS = 8

    def __init__(self, cluster, inflight_op_bytes: int = 100 << 20):
        import threading
        from ..utils.throttle import Throttle
        self.cluster = cluster
        # SimCluster's PG state is not thread-safe; dispatch serializes
        # under one lock (the reference Objecter likewise holds its
        # rwlock across _op_submit). The throttle is taken OUTSIDE the
        # lock so backpressure applies to concurrent callers.
        # RLock: IoCtx's direct cluster accessors (stat, listings,
        # snap ops, cls execute) serialize through this same lock so
        # aio worker threads can't race them on thread-unsafe PG
        # state; reentrancy lets a cls method or watch callback call
        # back into the client without deadlocking
        self._dispatch_lock = threading.RLock()
        # client-side backpressure (ref: Objecter's op_throttle_bytes /
        # objecter_inflight_op_bytes): payload bytes are charged before
        # dispatch and released after the reply; a flood of writes
        # blocks the caller instead of ballooning memory
        self.op_throttle = Throttle("objecter_bytes", inflight_op_bytes)
        self.perf = (PerfCountersBuilder("objecter")
                     .add_u64_counter("op_send")
                     .add_u64_counter("op_resend")
                     .add_u64_counter("map_refresh")
                     .add_u64_counter("op_degraded",
                                      "reads served through the "
                                      "degraded fast path (primary "
                                      "dead/parked; any-k decode)")
                     .add_u64_counter("throttle_blocked_bytes")
                     .add_time_avg("op_latency",
                                   "submit-to-reply wall time incl. "
                                   "resends")
                     .create_perf_counters())
        self._epoch = -1
        self._primaries: dict[int, int] = {}
        self._refresh()

    # -- map view -----------------------------------------------------------

    def _refresh(self) -> None:
        """Pull the current OSDMap (the MOSDMap subscription analog).
        Under the (reentrant) dispatch lock: the map + pg_num are
        mutated multi-step by splits/autoscale on the driving thread,
        and aio workers must neither read torn state here nor
        interleave the epoch/primaries update pair."""
        with self._dispatch_lock:
            om = self.cluster.osdmap
            self._epoch = om.epoch
            self._primaries = {
                ps: om.pg_to_up_acting_osds(1, ps)[3]
                for ps in range(self.cluster.pg_num)}
        self.perf.inc("map_refresh")

    def _calc_target(self, name: str) -> tuple[int, int]:
        """object -> (ps, primary osd) from the CACHED map view
        (Objecter::_calc_target)."""
        with self._dispatch_lock:
            ps = self.cluster.osdmap.object_to_pg(1, name)[1]
            return ps, self._primaries.get(ps, -1)

    # -- op submission ------------------------------------------------------

    @staticmethod
    def _payload_bytes(kind: str, payload) -> int:
        if kind == "write":
            return sum(len(np.asarray(v, np.uint8).reshape(-1))
                       if not isinstance(v, (bytes, bytearray)) else len(v)
                       for v in payload.values())
        if kind == "write_ranges":
            return sum(len(np.asarray(d, np.uint8).reshape(-1))
                       if not isinstance(d, (bytes, bytearray)) else len(d)
                       for _, _, d in payload)
        if kind == "append":
            _name, data = payload
            return (len(data) if isinstance(data, (bytes, bytearray))
                    else len(np.asarray(data, np.uint8).reshape(-1)))
        return 0  # reads are charged on the reply side in the reference

    def _submit(self, kind: str, ps: int, payload,
                snapc: int = 0) -> object:
        """Send one PG-targeted op; retarget + resend on staleness
        (the while loop is _op_submit's resend-on-new-map path).
        `snapc` is the newest snap id the caller's SnapContext names
        (selfmanaged-snap pools; 0 = no snaps follow this writer)."""
        from ..utils.tracing import span
        cost = self._payload_bytes(kind, payload)
        if cost and not self.op_throttle.get_or_fail(cost):
            self.perf.inc("throttle_blocked_bytes", cost)
            self.op_throttle.get(cost)  # block until in-flight drains
        try:
            with span(f"objecter.{kind}", counters=self.perf,
                      key="op_latency"):
                return self._submit_inner(kind, ps, payload, snapc)
        finally:
            if cost:
                self.op_throttle.put(cost)

    def _submit_inner(self, kind: str, ps: int, payload, snapc: int):
        from ..osd.cluster import StaleMap
        for attempt in range(self.MAX_ATTEMPTS):
            primary = self._primaries.get(ps, -1)
            self.perf.inc("op_send")
            if attempt:
                self.perf.inc("op_resend")
            try:
                with self._dispatch_lock:
                    return self.cluster.client_rpc(
                        primary, self._epoch, kind, ps, payload,
                        snapc=snapc)
            except StaleMap:
                self._refresh()
                if kind == "read":
                    got = self._maybe_degraded_read(ps, payload)
                    if got is not None:
                        return got
        raise ObjecterError(
            f"op on pg {ps} still untargetable after "
            f"{self.MAX_ATTEMPTS} attempts (epoch {self._epoch})")

    def _maybe_degraded_read(self, ps: int, names):
        """Degraded-read fast path (ROADMAP item 3): when the FRESH
        map still offers no serviceable primary — the primary process
        is dead but not yet detected, or the PG is parked in
        peering/WaitUpThru — a read is served immediately from any k
        surviving shards instead of burning the resend budget waiting
        for detection + activation (mutations still wait: they need
        the durable primary path). Returns None when the normal
        retarget should proceed, and falls back to the retry loop if
        the degraded decode itself cannot complete (below min_size)."""
        with self._dispatch_lock:
            primary = self._primaries.get(ps, -1)
            healthy = (0 <= primary < len(self.cluster.alive)
                       and self.cluster.alive[primary]
                       and self.cluster._peer_classify(ps).serviceable)
            if healthy:
                return None            # a plain retarget will do
            try:
                out = self.cluster.degraded_read(ps, names)
            except (ValueError, KeyError) as e:
                if isinstance(e, KeyError):
                    raise              # no such object is definitive
                return None            # not decodable: keep retrying
        self.perf.inc("op_degraded")
        return out

    def write(self, objects: dict[str, bytes | np.ndarray],
              snapc: int = 0) -> None:
        by_pg: dict[int, dict] = {}
        for name, data in objects.items():
            ps, _ = self._calc_target(name)
            by_pg.setdefault(ps, {})[name] = data
        for ps, group in by_pg.items():
            self._submit("write", ps, group, snapc=snapc)

    def write_at(self, name: str, offset: int,
                 data: bytes | np.ndarray, snapc: int = 0) -> None:
        ps, _ = self._calc_target(name)
        self._submit("write_ranges", ps, [(name, offset, data)],
                     snapc=snapc)

    def append(self, name: str, data: bytes | np.ndarray,
               snapc: int = 0) -> int:
        """Tail append — the primary resolves the current object size
        server-side and lands the bytes there (librados rados_append;
        r16's append fast path skips the pre-read when the tail lands
        in stripe padding). Returns the offset the data landed at."""
        ps, _ = self._calc_target(name)
        return self._submit("append", ps, (name, data), snapc=snapc)

    def _by_pg(self, names: list[str]) -> dict[int, list[str]]:
        by_pg: dict[int, list[str]] = {}
        for name in names:
            ps, _ = self._calc_target(name)
            by_pg.setdefault(ps, []).append(name)
        return by_pg

    def remove(self, names: list[str] | str, snapc: int = 0) -> None:
        names_l = [names] if isinstance(names, str) else list(names)
        for ps, group in self._by_pg(names_l).items():
            self._submit("remove", ps, group, snapc=snapc)

    def read(self, names: list[str] | str) -> dict[str, np.ndarray]:
        single = isinstance(names, str)
        names_l = [names] if single else list(names)
        out: dict[str, np.ndarray] = {}
        for ps, group in self._by_pg(names_l).items():
            out.update(self._submit("read", ps, group))
        return out[names] if single else out
