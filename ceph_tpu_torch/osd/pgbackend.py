"""PGBackend — the shared half of the per-PG backends.

Twin of ceph_tpu/osd/pgbackend.py (ref: src/osd/PGBackend.h). The
shared machinery — per-slot store plumbing, the PG mutation log with
per-shard applied cursors (staleness gating), the min-size write gate,
shallow scrub — lives here; ECBackend (osd/ecbackend.py) lays shards
out across the acting set. ReplicatedBackend comes with a later slice.

Data and metadata stay on the host (MemStore); the batched CRCs run on
the backend's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..csum.kernels import crc32c_blocks
from ..ops.rs_kernels import run_bucketed
from .memstore import MemStore, Transaction
from .pglog import PGLog
from .stripe import HashInfo, as_flat_u8

HINFO_KEY = "hinfo_key"  # same xattr name role as the reference


def to_device(arr, device) -> torch.Tensor:
    """Host uint8 rows (an array, or a tensor already made) -> a tensor
    on `device`."""
    if not isinstance(arr, torch.Tensor):
        arr = np.ascontiguousarray(arr, np.uint8)
        if not arr.flags.writeable:
            arr = arr.copy()
        arr = torch.from_numpy(arr)
    return arr.to(device)


def shard_cid(pg: str, shard: int) -> str:
    """Collection name of one PG shard (role of spg_t's shard id)."""
    return f"{pg}s{shard}"


class PGBackend:
    """Common base: store plumbing + PG-log bookkeeping (ref:
    src/osd/PGBackend.h contract; log semantics ref: src/osd/PGLog.h)."""

    #: live slots a write needs before it may proceed (the pool
    #: min_size gate); subclasses set it in __init__
    min_live: int = 1

    def _init_common(self, pg: str, acting: list[int], cluster,
                     ensure_collections: bool = True) -> None:
        self.pg = pg
        self.acting = list(acting)
        self.n = len(acting)
        self.cluster = cluster
        if ensure_collections:
            # ensure_collections=False builds a READ-ONLY view (the
            # degraded-read fast path): no store mutation, and no txn
            # to an acting member that may be dead-but-not-yet-marked
            # (the collections already exist on every real member)
            for shard, osd in enumerate(self.acting):
                t = Transaction().create_collection(shard_cid(pg, shard))
                self.cluster.osd(osd).queue_transaction(t)
        self.object_sizes: dict[str, int] = {}  # authoritative size info
        # mutation log + per-shard applied cursor (ref: PGLog /
        # peering's last_update per shard): a shard that missed writes
        # replays just the delta on rejoin
        self.pg_log = PGLog()
        self.shard_applied = [0] * self.n
        self.object_versions: dict[str, int] = {}  # name -> last version

    # -- shared helpers ------------------------------------------------------

    def _store(self, shard: int) -> MemStore:
        return self.cluster.osd(self.acting[shard])

    def _live_slots(self, dead_osds: set[int] | None) -> list[int]:
        dead = dead_osds or set()
        return [s for s in range(self.n) if self.acting[s] not in dead]

    def _log_write(self, name: str, live: list[int]) -> None:
        """Append to the PG log and advance the applied cursor of every
        shard that received this write (down shards stay behind and
        replay the delta on rejoin).

        The cursor only advances CONTIGUOUSLY: a live-but-behind shard
        (revived, replay still pending) receives the new bytes but
        keeps its old cursor, else its gap would silently close and
        reads could select it as fresh for objects it missed (the
        reference keeps last_update + an explicit missing set; our
        conservative cursor re-replays a little instead)."""
        v = self.pg_log.append(name)
        self.object_versions[name] = v
        for s in live:
            if self.shard_applied[s] == v - 1:
                self.shard_applied[s] = v

    def _fresh_for(self, names: list[str], shards: list[int]) -> list[int]:
        """Shards (from `shards`) whose applied cursor covers the last
        write of every object in `names` — a shard that was down across
        a write holds STALE bytes for it and must not serve reads or
        helper gathers until it replays (ref: peering's missing-set)."""
        need = max((self.object_versions.get(n, 0) for n in names),
                   default=0)
        return [s for s in shards if self.shard_applied[s] >= need]

    def _fanout_txns(self, items) -> None:
        """Apply [(shard, Transaction)] across the acting set,
        PIPELINED where the store supports it (RemoteStore at the wire
        tier): every txn is transmitted before any ack is awaited, so
        the fan-out costs one overlapped round trip instead of
        len(items) sequential ones (the reference dispatches its
        MOSDECSubOpWrite sub-ops in parallel too). Durability point
        unchanged — this returns only after EVERY shard acked, and a
        shard failure raises exactly like the sequential loop did.
        In-process stores (MemStore/TinStore) take the sync path."""
        waits: list = []
        first_err: BaseException | None = None
        for shard, t in items:
            st = self._store(shard)
            submit = getattr(st, "queue_transaction_async", None)
            try:
                if submit is not None:
                    waits.append(submit(t))
                else:
                    st.queue_transaction(t)
            except (ConnectionError, OSError) as e:
                first_err = first_err or e
        for h in waits:
            try:
                h.result()
            except (ConnectionError, OSError) as e:
                first_err = first_err or e
        if first_err is not None:
            raise first_err

    def _check_min_size(self, live: list[int]) -> None:
        """Writes need >= min_live receiving slots or the PG goes
        inactive and blocks I/O (the pool min_size gate). Counts
        DISTINCT OSDs, not slots: mid-backfill an OSD can temporarily
        hold two slots, and two copies on one disk are one failure
        domain, not two."""
        distinct = len({self.acting[s] for s in live})
        if distinct < self.min_live:
            raise ValueError(
                f"PG below min_size: {distinct} live shards < "
                f"min_size={self.min_live}; write refused (pg inactive)")

    @staticmethod
    def _batched_crcs(blocks, device: torch.device) -> np.ndarray:
        """One batched CRC call on `device` for a (B, L) stack of byte
        rows -> (B,) uint32 CRCs (raw register, seed -1 — the HashInfo
        convention). The row count is bucketed to a power of two, as in
        the twin."""
        crcs = run_bucketed(
            lambda b: crc32c_blocks(b, init=0xFFFFFFFF, xorout=0),
            to_device(blocks, device))
        return crcs.cpu().numpy().astype(np.uint32)

    def _remove_strays(self, dead: set[int]) -> int:
        """Remove per-slot leftover objects the PG's metadata no
        longer knows: divergent dead-interval writes kept by a member
        that rejoined as a NON-primary (only the restoring primary
        runs the divergent-log rewind), or delete leftovers a trimmed
        log can never replay. Ref: PrimaryLogPG's stray/unexpected
        object handling on scrub repair."""
        removed = 0
        for s in range(self.n):
            if self.acting[s] in dead:
                continue
            st = self._store(s)
            cid = shard_cid(self.pg, s)
            strays = [n for n in st.list_objects(cid)
                      if not n.startswith("__")
                      and n not in self.object_sizes]
            if not strays:
                continue
            t = Transaction()   # one combined txn (one wire frame)
            for name in strays:
                t.remove(cid, name)
            st.queue_transaction(t)
            removed += len(strays)
        return removed

    # -- contract (ref: PGBackend.h pure virtuals) ---------------------------

    def write_objects(self, objects, dead_osds=None) -> None:
        raise NotImplementedError

    def write_ranges(self, ops, dead_osds=None) -> None:
        raise NotImplementedError

    def write_at(self, name: str, offset: int, data,
                 dead_osds: set[int] | None = None) -> None:
        self.write_ranges([(name, offset, data)], dead_osds)

    def append_objects(self, appends, dead_osds=None) -> None:
        """Append streams: each name's bytes land at its current tail
        (creating absent objects at offset 0). On an EC pool a tail
        landing inside the padded stripe is the RMW append fast path:
        the pre-image is zeros by the layout rule, so no read phase
        and only the tail data shard + m parity shards move."""
        self.write_ranges(
            [(name, self.object_sizes.get(name, 0), data)
             for name, data in appends.items()], dead_osds)

    def read_objects(self, names, dead_osds=None) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def read_object(self, name: str,
                    dead_osds: set[int] | None = None) -> np.ndarray:
        return self.read_objects([name], dead_osds)[name]

    def remove_objects(self, names, dead_osds=None) -> None:
        """Delete objects from every live slot. A remove is a LOGGED
        mutation (ref: pg_log_entry_t DELETE): a shard that was down
        across it replays the delete on rejoin instead of resurrecting
        a stale copy."""
        live = self._live_slots(dead_osds)
        self._check_min_size(live)
        names = list(names)
        # validate the whole batch before mutating anything (the
        # recover_shards convention): a bad name mid-batch must not
        # leave a half-applied, half-logged delete
        for name in names:
            if name not in self.object_sizes:
                raise KeyError(f"no object {name!r}")
        # ONE combined txn per shard for the whole batch (the window's
        # store-apply unit — the per-name loop cost B*n transactions
        # and B*n wire frames where n now suffice; ROADMAP item 2b's
        # `store.apply` wall), fanned out pipelined
        seen: set[str] = set()
        doomed: list[str] = []
        for name in names:
            if name not in seen:
                seen.add(name)
                doomed.append(name)
        txns = []
        for s in live:
            t = Transaction()
            for name in doomed:
                t.remove(shard_cid(self.pg, s), name)
            txns.append((s, t))
        self._fanout_txns(txns)
        for name in doomed:
            del self.object_sizes[name]
            self._log_write(name, live)

    def stat_object(self, name: str) -> int:
        """Logical object size (the rados_stat role)."""
        return self.object_sizes[name]

    def list_pg_objects(self) -> list[str]:
        return sorted(self.object_sizes)

    def split_to(self, child: "PGBackend", names) -> int:
        """PG split, the data half (ref: src/osd/PG.cc split machinery;
        on-disk it is a LOCAL collection split — no bytes cross OSDs):
        move `names`' shards store-locally from this PG's collections
        into `child`'s, carrying the hinfo xattrs, and log the transfer
        on both sides (child: create entries; parent: delete entries)
        so later delta-rejoins replay exactly. The child must start on
        the parent's acting set — relocation to its own CRUSH targets
        is the cluster layer's pg_temp-protected backfill, afterwards.

        Caller contract: every shard caught up (a clean PG) — enforced
        here because a behind shard would silently split a stale copy.
        """
        if child.acting != self.acting:
            raise ValueError("split child must start on the parent's "
                             "acting set")
        for s in range(self.n):
            if self.shard_applied[s] < self.pg_log.head:
                raise ValueError(
                    f"shard {s} is behind (applied "
                    f"{self.shard_applied[s]} < head {self.pg_log.head}); "
                    f"split requires a clean PG")
        moved = [n for n in names if n in self.object_sizes]
        for s in range(self.n):
            st = self._store(s)
            src = shard_cid(self.pg, s)
            dst = shard_cid(child.pg, s)
            t = Transaction()
            for name in moved:
                if not st.exists(src, name):
                    # clean PG + absent store entry = the zero-length
                    # convention; mirror it on the child WITH an empty
                    # hinfo — deep scrub reads the xattr unguarded
                    t.touch(dst, name).truncate(dst, name, 0)
                    t.setattr(dst, name, HINFO_KEY,
                              HashInfo(1, 0, [0xFFFFFFFF]).to_bytes())
                    continue
                data = st.read(src, name)
                t.write(dst, name, 0, data).truncate(dst, name, len(data))
                try:
                    t.setattr(dst, name, HINFO_KEY,
                              st.getattr(src, name, HINFO_KEY))
                except KeyError:
                    pass    # zero-length objects may carry no hinfo
                t.remove(src, name)
            st.queue_transaction(t)
        live = list(range(self.n))
        for name in moved:
            child.object_sizes[name] = self.object_sizes.pop(name)
            child._log_write(name, live)
            self.object_versions.pop(name, None)
            self._log_write(name, live)   # the parent-side DELETE entry
        return len(moved)

    def _replay_deletes(self, lost: list[int], names) -> list[str]:
        """Split a recovery name list: apply deletes for names the PG
        no longer knows (their last log entry was a remove) to the
        recovering slots, and return the names still to rebuild.

        Batched per slot: ONE listing + ONE combined remove txn
        instead of a per-name exists+remove pair — at the wire tier
        the per-name form cost 2B round trips per recovering slot."""
        keep = [n for n in names if n in self.object_sizes]
        dels = [n for n in names if n not in self.object_sizes]
        if dels:
            for s in lost:
                cid = shard_cid(self.pg, s)
                present = set(self._store(s).list_objects(cid))
                doomed = [n for n in dels if n in present]
                if not doomed:
                    continue
                t = Transaction()
                for name in doomed:
                    t.remove(cid, name)
                self._store(s).queue_transaction(t)
        return keep

    def recover_shards(self, lost_shards, replacement_osds=None,
                       batch: int = 128, verify_hinfo: bool = True,
                       names=None, helper_exclude=None) -> dict:
        raise NotImplementedError

    def _mark_caught_up(self, lost: list[int], full_plan: bool,
                        provided: set) -> None:
        """Advance recovered slots' applied cursors to the log head —
        but only when the recovered names cover the slot's whole
        missing set. A narrower caller-supplied subset must not mark
        objects it never touched as fresh (that would defeat
        _fresh_for's staleness gate). Shared by both backends so the
        gate can't silently diverge."""
        for s in lost:
            missing = self.pg_log.missing_since(self.shard_applied[s])
            if missing is None:           # log trimmed: backfill must
                missing = self.object_sizes   # have covered everything
            if full_plan or set(missing) <= provided:
                self.shard_applied[s] = self.pg_log.head

    def deep_scrub(self) -> dict:
        raise NotImplementedError

    # -- shallow scrub (shared) ----------------------------------------------

    def _expected_shard_len(self, object_size: int) -> int:
        """Bytes slot s should hold for an object of `object_size`
        logical bytes (replicated: the full object; EC: the shard)."""
        raise NotImplementedError

    def shallow_scrub(self, skip_slots: set[int] | None = None) -> dict:
        """Metadata-only audit — no data reads (ref: the scrubber's
        shallow pass compares object set, sizes, and attrs across
        shards; src/osd/scrubber/pg_scrubber.cc). Checks every slot
        against the authoritative object map: presence, stored length,
        hinfo attr presence + its recorded length, and flags stray
        objects the PG doesn't know about."""
        skip = skip_slots or set()
        errors: list[tuple[str, int, str]] = []  # (name, slot, what)
        checked = 0
        for s in range(self.n):
            if s in skip:
                continue
            store = self._store(s)
            cid = shard_cid(self.pg, s)
            on_disk = set(store.list_objects(cid))
            for name, osize in self.object_sizes.items():
                checked += 1
                # a shard that missed this object's last write is
                # legitimately behind, not inconsistent
                if self.shard_applied[s] < self.object_versions.get(
                        name, 0):
                    continue
                if name not in on_disk:
                    errors.append((name, s, "missing"))
                    continue
                want = self._expected_shard_len(osize)
                have = store.stat(cid, name)
                if have != want:
                    errors.append((name, s, f"size {have} != {want}"))
                try:
                    hb = store.getattr(cid, name, HINFO_KEY)
                except KeyError:
                    errors.append((name, s, "no hinfo attr"))
                    continue
                hinfo = HashInfo.from_bytes(hb)
                if hinfo.total_chunk_size != want:
                    errors.append(
                        (name, s, f"hinfo len {hinfo.total_chunk_size} "
                                  f"!= {want}"))
            for stray in on_disk - set(self.object_sizes):
                # "__"-prefixed names are PG-internal bookkeeping
                # (stripe journal, standalone __pg_meta__): never
                # client data, never stray
                if stray.startswith("__"):
                    continue
                # a behind shard may hold an object whose delete it
                # hasn't replayed yet — lag, not corruption (same
                # excuse the missing/size checks apply above)
                if self.shard_applied[s] < self.object_versions.get(
                        stray, 0):
                    continue
                errors.append((stray, s, "stray object"))
        return {"checked": checked, "errors": errors}
