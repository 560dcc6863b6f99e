"""MemStore — the in-memory transactional object store.

Rebuild of the reference's test/fake backend (ref: src/os/memstore/
MemStore.{h,cc}; transactional API ref: src/os/ObjectStore.h —
ObjectStore::Transaction op-codes OP_WRITE/OP_TRUNCATE/OP_SETATTR/
OP_RM... applied atomically by queue_transaction). This is the store
the hermetic recovery/cluster tests run against, exactly as the
reference's store_test.cc runs one suite against MemStore and
BlueStore.

Objects live in collections (one per PG shard); each object holds byte
data (a numpy uint8 array), xattrs (small bytes: hinfo lives here), and
an omap dict. Transactions collect ops and apply all-or-nothing: any
op that fails validation aborts the whole batch before any mutation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class _Object:
    data: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.uint8))
    xattrs: dict[str, bytes] = field(default_factory=dict)
    omap: dict[bytes, bytes] = field(default_factory=dict)


class Transaction:
    """Ordered op list; build with the helpers, apply via
    MemStore.queue_transaction."""

    def __init__(self):
        self.ops: list[tuple] = []

    def create_collection(self, cid: str):
        self.ops.append(("mkcoll", cid))
        return self

    def remove_collection(self, cid: str):
        self.ops.append(("rmcoll", cid))
        return self

    def touch(self, cid: str, oid: str):
        self.ops.append(("touch", cid, oid))
        return self

    def write(self, cid: str, oid: str, offset: int, data):
        if int(offset) < 0:
            raise ValueError(f"write offset {offset} < 0")
        # frombuffer reads memoryviews/bytes directly — bytes(data)
        # here would add a SECOND full copy per shard write on the
        # subop hot path (the .copy() below is the one that must
        # stay: a transaction owns its bytes, the aliasing contract)
        arr = (np.frombuffer(data, dtype=np.uint8).copy()
               if isinstance(data, (bytes, bytearray, memoryview))
               else np.asarray(data, np.uint8).copy())
        if arr.ndim != 1:
            raise ValueError(f"write data must be flat bytes, got {arr.shape}")
        self.ops.append(("write", cid, oid, int(offset), arr))
        return self

    def xor(self, cid: str, oid: str, offset: int, data):
        """XOR `data` into the object at `offset`, zero-extending past
        EOF (ref: the parity-delta apply of EC partial-stripe
        overwrites — MOSDECSubOpWrite carrying ECTransaction deltas).
        XOR into a zero-extended region degenerates to a plain write,
        so the op also serves delta writes past the old tail."""
        if int(offset) < 0:
            raise ValueError(f"xor offset {offset} < 0")
        arr = (np.frombuffer(data, dtype=np.uint8).copy()
               if isinstance(data, (bytes, bytearray, memoryview))
               else np.asarray(data, np.uint8).copy())
        if arr.ndim != 1:
            raise ValueError(f"xor data must be flat bytes, got {arr.shape}")
        self.ops.append(("xor", cid, oid, int(offset), arr))
        return self

    def truncate(self, cid: str, oid: str, size: int):
        if int(size) < 0:
            raise ValueError(f"truncate size {size} < 0")
        self.ops.append(("truncate", cid, oid, int(size)))
        return self

    def remove(self, cid: str, oid: str):
        self.ops.append(("remove", cid, oid))
        return self

    def setattr(self, cid: str, oid: str, key: str, value: bytes):
        self.ops.append(("setattr", cid, oid, key, bytes(value)))
        return self

    def rmattr(self, cid: str, oid: str, key: str):
        self.ops.append(("rmattr", cid, oid, key))
        return self

    def omap_set(self, cid: str, oid: str, kv: dict[bytes, bytes]):
        self.ops.append(("omap_set", cid, oid, dict(kv)))
        return self

    def omap_rmkeys(self, cid: str, oid: str, keys):
        """Remove specific omap keys (ref: src/os/ObjectStore.h
        OP_OMAP_RMKEYS) — without this, KV entries could only grow or
        die with the object."""
        self.ops.append(("omap_rmkeys", cid, oid,
                         [bytes(k) for k in keys]))
        return self

    def omap_clear(self, cid: str, oid: str):
        """Drop every omap key (ref: OP_OMAP_CLEAR)."""
        self.ops.append(("omap_clear", cid, oid))
        return self


class MemStore:
    """All state in RAM; crash-consistency is trivially atomic because
    transactions apply under a copy-validate-commit discipline."""

    #: no on-disk footprint (the lifecycle contract shared w/ TinStore)
    path: str | None = None

    def __init__(self, capacity_bytes: int = 0):
        self.collections: dict[str, dict[str, _Object]] = {}
        self.committed_txns = 0
        #: capacity ceiling in bytes; 0 = unbounded (no statfs ratio,
        #: no ENOSPC). Live-shrinkable via set_capacity — the r21
        #: disk_full injection path.
        self.capacity_bytes = int(capacity_bytes)
        #: deterministic ENOSPC injection hook: fn(point) called at
        #: "txn.apply" before any mutation; raising OSError there
        #: aborts the whole batch (nothing applied — trivially atomic)
        self._fault = None

    # -- lifecycle (shared store contract; see tinstore.TinStore) -----------
    # RAM-only semantics: "process death keeps bytes by fiat", so
    # crash/remount are no-ops and the store is never down.

    @property
    def is_down(self) -> bool:
        return False

    def crash(self) -> None:
        pass

    def remount(self) -> None:
        pass

    # -- capacity (r21 capacity plane; contract shared w/ TinStore) ---------

    def set_capacity(self, nbytes: int) -> None:
        """Live capacity change (shrinkable below current usage — the
        ratio then reads > 1.0 and every new mutation ENOSPCs, which
        is exactly what the disk_full fault stream wants)."""
        self.capacity_bytes = int(nbytes)

    def set_fault(self, fn) -> None:
        self._fault = fn

    def used_bytes(self) -> int:
        total = 0
        for coll in self.collections.values():
            for o in coll.values():
                total += len(o.data)
                total += sum(len(v) for v in o.xattrs.values())
                total += sum(len(k) + len(v)
                             for k, v in o.omap.items())
        return total

    def statfs(self) -> dict:
        """Bytes total/used/avail (the ObjectStore::statfs contract).
        total == 0 means unbounded: the mon ladder never computes a
        ratio for such a store."""
        used = self.used_bytes()
        total = int(self.capacity_bytes)
        return {"total": total, "used": used,
                "avail": max(0, total - used) if total else 0}

    def _txn_grow_bytes(self, txn: Transaction) -> int:
        """Conservative upper bound of bytes this batch can ADD —
        growth is what ENOSPC gates; frees inside the same batch are
        deliberately not credited (a real allocator can't reuse them
        until commit either)."""
        grow = 0
        for op in txn.ops:
            kind = op[0]
            if kind in ("write", "xor"):
                grow += len(op[4])
            elif kind == "truncate":
                grow += op[3]
            elif kind == "setattr":
                grow += len(op[4])
            elif kind == "omap_set":
                grow += sum(len(k) + len(v) for k, v in op[3].items())
        return grow

    # -- transaction apply --------------------------------------------------

    def queue_transaction(self, txn: Transaction) -> None:
        self._validate(txn)
        if self._fault is not None:
            # injection point BEFORE any mutation: an injected ENOSPC
            # aborts with nothing applied (atomic by construction)
            self._fault("txn.apply")
        cap = self.capacity_bytes
        grow = self._txn_grow_bytes(txn) if cap else 0
        # zero-growth batches (deletes, truncate-down, omap rm) pass
        # even when usage already exceeds a shrunk capacity: freeing
        # space is how a full store recovers
        if cap and grow and self.used_bytes() + grow > cap:
            import errno
            raise OSError(errno.ENOSPC,
                          f"memstore over capacity ({cap} bytes)")
        for op in txn.ops:
            self._apply(op)
        self.committed_txns += 1

    def _validate(self, txn: Transaction) -> None:
        # simulate the ObjectStore contract: ops referencing missing
        # collections are caller bugs -> abort before mutating anything
        cols = set(self.collections)
        for op in txn.ops:
            kind = op[0]
            if kind == "mkcoll":
                cols.add(op[1])
            elif kind == "rmcoll":
                if op[1] not in cols:
                    raise KeyError(f"rmcoll: no collection {op[1]!r}")
                cols.discard(op[1])
            else:
                if op[1] not in cols:
                    raise KeyError(f"{kind}: no collection {op[1]!r}")

    def _obj(self, cid: str, oid: str, create: bool = False) -> _Object:
        coll = self.collections[cid]
        if oid not in coll:
            if not create:
                raise KeyError(f"no object {cid}/{oid}")
            coll[oid] = _Object()
        return coll[oid]

    def _apply(self, op: tuple) -> None:
        kind = op[0]
        if kind == "mkcoll":
            self.collections.setdefault(op[1], {})
        elif kind == "rmcoll":
            self.collections.pop(op[1])
        elif kind == "touch":
            self._obj(op[1], op[2], create=True)
        elif kind == "write":
            _, cid, oid, off, data = op
            o = self._obj(cid, oid, create=True)
            end = off + len(data)
            if end > len(o.data):
                grown = np.zeros(end, dtype=np.uint8)
                grown[:len(o.data)] = o.data
                o.data = grown
            o.data[off:end] = data
        elif kind == "xor":
            _, cid, oid, off, data = op
            o = self._obj(cid, oid, create=True)
            end = off + len(data)
            if end > len(o.data):
                grown = np.zeros(end, dtype=np.uint8)
                grown[:len(o.data)] = o.data
                o.data = grown
            o.data[off:end] ^= data
        elif kind == "truncate":
            _, cid, oid, size = op
            o = self._obj(cid, oid, create=True)
            if size == len(o.data):
                pass    # the write-then-truncate-to-length pattern on
                #         every shard subop: already exact, and the
                #         .copy() below would re-copy the whole object
            elif size <= len(o.data):
                o.data = o.data[:size].copy()
            else:
                grown = np.zeros(size, dtype=np.uint8)
                grown[:len(o.data)] = o.data
                o.data = grown
        elif kind == "remove":
            self.collections[op[1]].pop(op[2], None)
        elif kind == "setattr":
            self._obj(op[1], op[2], create=True).xattrs[op[3]] = op[4]
        elif kind == "rmattr":
            # tolerant like remove: a missing object is a no-op, so the
            # all-or-nothing apply contract can't break mid-transaction
            o = self.collections[op[1]].get(op[2])
            if o is not None:
                o.xattrs.pop(op[3], None)
        elif kind == "omap_set":
            self._obj(op[1], op[2], create=True).omap.update(op[3])
        elif kind == "omap_rmkeys":
            # tolerant like rmattr: a missing object/key is a no-op so
            # the all-or-nothing apply contract can't break mid-batch
            o = self.collections[op[1]].get(op[2])
            if o is not None:
                for k in op[3]:
                    o.omap.pop(k, None)
        elif kind == "omap_clear":
            o = self.collections[op[1]].get(op[2])
            if o is not None:
                o.omap.clear()
        else:
            raise ValueError(f"unknown op {kind!r}")

    # -- reads --------------------------------------------------------------

    def read(self, cid: str, oid: str, offset: int = 0,
             length: int | None = None) -> np.ndarray:
        o = self._obj(cid, oid)
        if length is None:
            return o.data[offset:].copy()
        return o.data[offset:offset + length].copy()

    def read_batch(self, cid: str, oids: list[str], length: int,
                   out: np.ndarray | None = None) -> np.ndarray:
        """(len(oids), length) stack of equal-length objects in one
        copy each (the recovery staging path reads B objects per shard;
        per-object read() would copy twice — once into the temporary,
        once into the caller's stack). Pass `out` (any (len(oids),
        length) uint8 view) to fill the caller's buffer directly."""
        if out is None:
            out = np.empty((len(oids), length), np.uint8)
        for i, oid in enumerate(oids):
            d = self._obj(cid, oid).data
            if len(d) != length:
                # a stale/partially-written shard must fail LOUDLY
                # here — zero-filling would hand the decoder garbage
                # that writeback then stamps with matching CRCs
                raise ValueError(
                    f"read_batch: {oid!r} is {len(d)} bytes, "
                    f"expected {length}")
            out[i] = d
        return out

    def stat(self, cid: str, oid: str) -> int:
        return len(self._obj(cid, oid).data)

    def getattr(self, cid: str, oid: str, key: str) -> bytes:
        return self._obj(cid, oid).xattrs[key]

    def exists(self, cid: str, oid: str) -> bool:
        return cid in self.collections and oid in self.collections[cid]

    def list_objects(self, cid: str, start_after: str | None = None,
                     limit: int | None = None) -> list[str]:
        """Flat-dict listing: sorts the WHOLE collection per call —
        O(n log n) in collection size no matter how small the page
        (the linear baseline TinStore's KV-plane paginated iterator
        replaces; store_bench's `list` workload measures the gap)."""
        names = sorted(self.collections.get(cid, {}))
        if start_after is not None:
            import bisect
            names = names[bisect.bisect_right(names, start_after):]
        return names if limit is None else names[:limit]

    def list_collections(self) -> list[str]:
        return sorted(self.collections)

    def omap_iter(self, cid: str, oid: str,
                  start_after: bytes | None = None,
                  limit: int | None = None) -> list[tuple[bytes, bytes]]:
        """Ordered omap page — flat-dict cost: sorts the whole omap
        per call (same linear baseline as list_objects)."""
        om = self._obj(cid, oid).omap
        keys = sorted(om)
        if start_after is not None:
            import bisect
            keys = keys[bisect.bisect_right(keys, bytes(start_after)):]
        if limit is not None:
            keys = keys[:limit]
        return [(k, om[k]) for k in keys]
