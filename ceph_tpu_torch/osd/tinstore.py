"""TinStore — the persistent, crash-consistent ObjectStore.

A file-backed store behind the exact ObjectStore interface MemStore
implements, so every backend/cluster path runs unchanged on either
(the reference parameterizes one suite over MemStore and BlueStore the
same way; ref: src/test/objectstore/store_test.cc).

Design (the load-bearing slice of the reference's L4, ref:
src/os/bluestore/BlueStore.cc _do_write/_do_read/_kv_sync_thread,
BitmapAllocator, _verify_csum, BlueStore::fsck; transactional contract
ref: src/os/ObjectStore.h Transaction/queue_transaction):

* BLOCK PLANE. Object bytes live in `block.dev`, a flat data device,
  in extents handed out by an in-RAM extent allocator (4 KiB units,
  first-fit free list with coalescing — the BitmapAllocator role).
  Data writes are COPY-ON-WRITE: a write stages the object's new
  bytes into a FRESH extent (never over live data), so torn data
  writes can't damage committed state. The freelist is not persisted;
  it is derived at mount from the live extent map (and fsck audits
  the same derivation for overlaps/bounds).
* KV METADATA PLANE. All metadata — collections, object records
  (extent refs, sizes, crcs, xattrs), and omap — lives in TinDB
  (`ceph_tpu/kv`), the ordered-KV store playing RocksDB's role under
  BlueStore. Three prefixes:
      "C" / cid                 -> b""            (collection exists)
      "O" / cid NUL oid         -> object record  (versioned encode)
      "M" / cid NUL oid NUL key -> omap value     (one entry per key)
  Because the KV space is ORDERED, object listing and omap iteration
  are prefix-bounded iterator walks — paginated listings cost
  O(page), not O(collection) (the flat-dict linear scan this plane
  replaces). Every queue_transaction first pwrites its staged data
  extents, then submits ONE atomic TinDB batch (= one crc32c-sealed
  WAL record in `wal.log`) carrying the metadata mutation, and only
  then applies to the in-RAM mirror. A transaction is wholly in the
  KV WAL or absent; a crash between data pwrite and KV submit leaves
  only unreferenced extents, which the derived allocator reclaims at
  mount. `flush()` per commit = process-kill consistency;
  `o_dsync=True` adds fsync (machine-crash consistency).
* RAM MIRROR. Object records (NOT omap) are mirrored in a dict for
  O(1) hot-path reads (the BlueStore onode cache role); the mirror is
  rebuilt from the KV plane at mount and is never the durability
  story. Omap lives only in TinDB and is read through ordered
  iterators.
* BOUNDED BUFFER CACHE. Reads are served from an LRU byte cache with
  a hard byte budget (`cache_bytes`); misses pread the device. The
  serving plane is NOT a store-sized RAM mirror: datasets many times
  the cache budget serve correctly with eviction (BlueStore's
  2Q/buffer cache role, simplified to LRU).
* SEGMENT FLUSH (the checkpoint role). When the KV WAL exceeds
  `wal_max_bytes` (or TinDB's memtable budget fills), the memtable is
  flushed to a sorted immutable segment, the MANIFEST swaps
  atomically, and the WAL resets. Flush cost is O(memtable) —
  independent of both data volume and total metadata volume; leveled
  compaction folds segments down in the background of the write path.
* INLINE COMPRESSION (opt-in). With `compression=` ("zlib"/"lzma"),
  blobs >= compression_min_blob that shrink to at most
  compression_required_ratio of raw are stored COMPRESSED (the
  BlueStore bluestore_compression_* decision, mode=aggressive): the
  device holds the compressed stream in a smaller extent, metadata
  carries (calg, clen, ccrc) alongside the logical crc, reads verify
  the stored bytes, inflate (bounded by the logical size — a bomb
  fails, it doesn't OOM), then verify the logical crc. Blobs that
  don't earn their keep stay raw; reads are transparent either way.
* VERIFY-ON-READ. Each object's crc32c (native C kernel, parity with
  ceph_crc32c) is computed when its bytes are staged and re-checked
  when a read misses the cache (and on every read of cached bytes);
  mismatch raises `TinStoreCorruption` (the _verify_csum -EIO
  analog). `collections[...][...].data` exposes the device bytes as
  a writable memmap view — in-place pokes are REAL on-disk
  corruption (they bypass WAL and crc, and invalidate the cache so
  the next read sees the damage).
* RECOVERY. mount() = TinDB mount (manifest -> segments -> WAL
  replay, torn tail truncated, mid-log damage fatal), then rebuild
  the RAM mirror from the "C"/"O" prefixes and derive the allocator
  from the surviving extent map.
* LEGACY FORWARD REPLAY. Stores written by the pre-KV TinStore
  (`ckpt` checkpoint + metadata-op WAL) are detected at mount (no
  MANIFEST) and migrated forward: legacy checkpoint + WAL are
  replayed in memory, the resulting state is written as TinDB's
  first segment, and the MANIFEST lands with covered_seq set past
  every legacy record — so the legacy WAL (same record framing) is
  seq-skipped, never misparsed. Crash before the MANIFEST: the
  legacy store is intact and migration re-runs. Crash after: the KV
  store is live. Either way nothing is lost.
* FSCK. TinStore.fsck(path) re-reads everything offline: the KV
  plane (manifest seal, segment seals + ordering, WAL chain) via
  TinDB.fsck, a cross-check of KV against the block plane (omap
  entries must have an object record, object records a collection,
  extents in-bounds and disjoint), and every object's data crc
  straight from the device. Legacy stores get the legacy audit.

Process-kill semantics for the chaos tests: crash() drops RAM state
and file handles with NO flush (what SIGKILL leaves behind);
remount() recovers purely from disk. SimCluster(store="tin") routes
kill/revive through these, so thrash survival is a measured property
of the WAL + block plane, not an axiom of the sim.
"""

from __future__ import annotations

import os
import struct
import threading
from collections import OrderedDict
from collections.abc import Mapping

import numpy as np

from ..kv import TinDB, TinDBCorruption, host_crc32c
from ..kv.tindb import Segment, scan_wal, write_segment
from ..utils.encoding import Decoder, Encoder, EncodingError
from .memstore import MemStore, Transaction, _Object  # noqa: F401 — _Object
#                      re-exported for store-agnostic test helpers

_CKPT_VERSION = 3   # final LEGACY checkpoint version (pre-KV stores)
_OBJ_VERSION = 1    # "O"-record encode version
_ALLOC_UNIT = 4096


class TinStoreCorruption(IOError):
    """Checksum/structure mismatch on the read path (-EIO analog)."""


def _crc32c(data) -> int:
    """Whole-buffer crc32c, raw-register convention (seed 0xFFFFFFFF,
    no final inversion) — shared with the KV plane's seals."""
    b = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
    return host_crc32c(b)


# -- wire transaction (de)serialization --------------------------------------
# Full-data form: MStoreOp frames ship entire Transactions between
# daemons (a peer can't dereference our device offsets). The metadata
# plane uses TinDB batches; the meta-op codec below survives only for
# legacy (pre-KV) store migration.

def _encode_op(e: Encoder, op: tuple) -> None:
    kind = op[0]
    e.string(kind)
    if kind in ("mkcoll", "rmcoll"):
        e.string(op[1])
    elif kind in ("touch", "remove", "omap_clear"):
        e.string(op[1]).string(op[2])
    elif kind in ("write", "xor"):
        # data by REFERENCE (no tobytes copy): the buffer rides the
        # encoder's segment list; wire callers keep it alive/unmodified
        # until the frame is acked (the bufferlist aliasing contract),
        # WAL callers join immediately via bytes()
        import numpy as _np
        data = _np.ascontiguousarray(op[4], _np.uint8)
        e.string(op[1]).string(op[2]).u64(op[3]) \
            .blob_ref(memoryview(data).cast("B"))
    elif kind == "truncate":
        e.string(op[1]).string(op[2]).u64(op[3])
    elif kind == "setattr":
        e.string(op[1]).string(op[2]).string(op[3]).blob(op[4])
    elif kind == "rmattr":
        e.string(op[1]).string(op[2]).string(op[3])
    elif kind == "omap_set":
        e.string(op[1]).string(op[2])
        e.mapping(op[3], Encoder.blob, Encoder.blob)
    elif kind == "omap_rmkeys":
        e.string(op[1]).string(op[2])
        e.list(op[3], Encoder.blob)
    else:
        raise EncodingError(f"unknown op {kind!r}")


def _decode_op(d: Decoder) -> tuple:
    kind = d.string()
    if kind in ("mkcoll", "rmcoll"):
        return (kind, d.string())
    if kind in ("touch", "remove", "omap_clear"):
        return (kind, d.string(), d.string())
    if kind in ("write", "xor"):
        cid, oid, off = d.string(), d.string(), d.u64()
        # d.blob() already copied the bytes out of the frame; the op
        # tuple owns them exclusively, so wrapping without a second
        # .copy() is safe (read-only array — stores only read op data)
        data = np.frombuffer(d.blob(), dtype=np.uint8)
        return (kind, cid, oid, off, data)
    if kind == "truncate":
        return (kind, d.string(), d.string(), d.u64())
    if kind == "setattr":
        return (kind, d.string(), d.string(), d.string(), d.blob())
    if kind == "rmattr":
        return (kind, d.string(), d.string(), d.string())
    if kind == "omap_set":
        return (kind, d.string(), d.string(),
                d.mapping(Decoder.blob, Decoder.blob))
    if kind == "omap_rmkeys":
        return (kind, d.string(), d.string(), d.list(Decoder.blob))
    raise EncodingError(f"unknown op {kind!r}")


def _encode_txn(txn: Transaction) -> bytes:
    e = Encoder()
    e.start(1, 1)
    e.list(txn.ops, _encode_op)
    e.finish()
    return e.bytes()


def _encode_txn_iov(txn: Transaction) -> list:
    """Segment-list form for the wire path: shard data buffers
    travel by reference from the transaction straight through
    MStoreOp framing to sendmsg — zero payload copies."""
    e = Encoder()
    e.start(1, 1)
    e.list(txn.ops, _encode_op)
    e.finish()
    return e.segments()


def _decode_txn(body: bytes) -> Transaction:
    d = Decoder(body)
    d.start(1)
    txn = Transaction()
    txn.ops = d.list(_decode_op)
    d.finish()
    return txn


# -- LEGACY metadata-op (de)serialization -------------------------------------
# The pre-KV TinStore WAL carried these records; the codec survives so
# mount() can forward-replay old stores into the KV plane (and so the
# tests can fabricate legacy stores to prove that path).

def _encode_meta_op(e: Encoder, op: tuple) -> None:
    kind = op[0]
    if kind == "setext":
        e.string(kind)
        e.string(op[1]).string(op[2])
        e.u64(op[3]).u64(op[4]).u64(op[5]).u32(op[6])
    elif kind == "setextc":
        # compressed extent: a DISTINCT kind (not extra fields on
        # setext) so stores written before compression existed replay
        # unchanged
        e.string(kind)
        e.string(op[1]).string(op[2])
        e.u64(op[3]).u64(op[4]).u64(op[5]).u32(op[6])
        e.string(op[7]).u64(op[8]).u32(op[9])
    else:
        _encode_op(e, op)


def _decode_meta_op(d: Decoder) -> tuple:
    kind = d.string()
    if kind == "setext":
        return (kind, d.string(), d.string(),
                d.u64(), d.u64(), d.u64(), d.u32())
    if kind == "setextc":
        return (kind, d.string(), d.string(),
                d.u64(), d.u64(), d.u64(), d.u32(),
                d.string(), d.u64(), d.u32())
    if kind in ("mkcoll", "rmcoll"):
        return (kind, d.string())
    if kind in ("touch", "remove", "omap_clear"):
        return (kind, d.string(), d.string())
    if kind == "setattr":
        return (kind, d.string(), d.string(), d.string(), d.blob())
    if kind == "rmattr":
        return (kind, d.string(), d.string(), d.string())
    if kind == "omap_set":
        return (kind, d.string(), d.string(),
                d.mapping(Decoder.blob, Decoder.blob))
    if kind == "omap_rmkeys":
        return (kind, d.string(), d.string(), d.list(Decoder.blob))
    raise EncodingError(f"unknown meta op {kind!r}")


def _encode_meta_txn(ops: list[tuple]) -> bytes:
    e = Encoder()
    e.start(1, 1)
    e.list(ops, _encode_meta_op)
    e.finish()
    return e.bytes()


def _decode_meta_txn(body: bytes) -> list[tuple]:
    d = Decoder(body)
    d.start(1)
    ops = d.list(_decode_meta_op)
    d.finish()
    return ops


# -- block plane --------------------------------------------------------------

class ExtentAllocator:
    """First-fit free-extent list over the flat data device, 4 KiB
    allocation units, coalescing frees (ref: src/os/bluestore/
    AvlAllocator.cc behaviorally; the freelist is derived, not
    persisted — mount/fsck rebuild it from the live extent map)."""

    def __init__(self, device_size: int = 0):
        self.device_size = int(device_size)
        self._free: list[list[int]] = (
            [[0, self.device_size]] if self.device_size else [])

    @staticmethod
    def round_up(n: int) -> int:
        return (int(n) + _ALLOC_UNIT - 1) // _ALLOC_UNIT * _ALLOC_UNIT

    def used_bytes(self) -> int:
        return self.device_size - sum(ln for _, ln in self._free)

    def reserve(self, off: int, length: int) -> None:
        """Mark [off, off+length) used (mount derivation). Raises
        TinStoreCorruption if any part is not free — that's an extent
        overlap or out-of-device reference in the metadata."""
        if length <= 0:
            return
        end = off + length
        if off < 0 or end > self.device_size:
            raise TinStoreCorruption(
                f"extent [{off},{end}) outside device "
                f"(size {self.device_size})")
        for i, (foff, flen) in enumerate(self._free):
            fend = foff + flen
            if foff <= off and end <= fend:
                repl = []
                if foff < off:
                    repl.append([foff, off - foff])
                if end < fend:
                    repl.append([end, fend - end])
                self._free[i:i + 1] = repl
                return
        raise TinStoreCorruption(
            f"extent [{off},{end}) overlaps another allocation")

    def alloc(self, nbytes: int) -> tuple[int, int]:
        """Return (doff, dlen) with dlen = round_up(nbytes). Grows the
        device (caller must ftruncate to self.device_size after).
        Zero bytes need no extent: empty objects must not pin units."""
        if nbytes <= 0:
            return 0, 0
        need = self.round_up(nbytes)
        for i, (foff, flen) in enumerate(self._free):
            if flen >= need:
                if flen == need:
                    del self._free[i]
                else:
                    self._free[i] = [foff + need, flen - need]
                return foff, need
        doff = self.device_size
        self.device_size += need
        return doff, need

    def free(self, off: int, length: int) -> None:
        if length <= 0:
            return
        # insert sorted, coalesce neighbors
        import bisect
        idx = bisect.bisect_left(self._free, [off, length])
        self._free.insert(idx, [off, length])
        merged = []
        for seg in self._free:
            if merged and merged[-1][0] + merged[-1][1] >= seg[0]:
                merged[-1][1] = max(merged[-1][1],
                                    seg[0] + seg[1] - merged[-1][0])
            else:
                merged.append(seg)
        self._free = merged


class _BufferCache:
    """LRU byte cache with a hard budget — the bounded serving plane.
    Objects larger than the whole budget bypass the cache."""

    def __init__(self, budget: int):
        self.budget = int(budget)
        self.total = 0
        self.hits = 0
        self.misses = 0
        self._lru: OrderedDict[tuple, np.ndarray] = OrderedDict()

    def get(self, key) -> np.ndarray | None:
        arr = self._lru.get(key)
        if arr is None:
            self.misses += 1
            return None
        self._lru.move_to_end(key)
        self.hits += 1
        return arr

    def put(self, key, arr: np.ndarray) -> None:
        self.drop(key)
        if arr.nbytes > self.budget:
            return
        self._lru[key] = arr
        self.total += arr.nbytes
        while self.total > self.budget and self._lru:
            _, old = self._lru.popitem(last=False)
            self.total -= old.nbytes

    def drop(self, key) -> None:
        old = self._lru.pop(key, None)
        if old is not None:
            self.total -= old.nbytes

    def drop_coll(self, cid: str) -> None:
        for key in [k for k in self._lru if k[0] == cid]:
            self.drop(key)

    def clear(self) -> None:
        self._lru.clear()
        self.total = 0


class _TinObject:
    """RAM-mirror record: where the bytes live, how big, their crc.
    Compressed blobs (calg != "") additionally carry the STORED
    length (clen) and a crc over the stored bytes (ccrc) — the
    BlueStore per-blob compressed_length + csum-on-stored-data pair;
    `crc` is always over the LOGICAL bytes. Omap is NOT mirrored —
    it lives only in the KV plane; `has_omap` is a write-path hint
    (True may be stale after rmkeys/clear; False is always exact)."""

    __slots__ = ("size", "doff", "dlen", "crc", "xattrs",
                 "calg", "clen", "ccrc", "has_omap")

    def __init__(self, size=0, doff=0, dlen=0, crc=0,
                 xattrs=None, calg="", clen=0, ccrc=0,
                 has_omap=False):
        self.size, self.doff, self.dlen, self.crc = size, doff, dlen, crc
        self.xattrs: dict[str, bytes] = xattrs if xattrs is not None else {}
        self.calg, self.clen, self.ccrc = calg, clen, ccrc
        self.has_omap = has_omap

    @property
    def stored_len(self) -> int:
        return self.clen if self.calg else self.size

    def copy(self) -> "_TinObject":
        return _TinObject(self.size, self.doff, self.dlen, self.crc,
                          dict(self.xattrs), self.calg, self.clen,
                          self.ccrc, self.has_omap)


def _encode_obj(o: _TinObject) -> bytes:
    """The "O" KV record (versioned like every on-disk structure)."""
    e = Encoder()
    e.start(_OBJ_VERSION, _OBJ_VERSION)
    e.u64(o.size).u64(o.doff).u64(o.dlen).u32(o.crc)
    e.string(o.calg).u64(o.clen).u32(o.ccrc)
    e.mapping(o.xattrs, Encoder.string, Encoder.blob)
    e.finish()
    return e.bytes()


def _decode_obj(b: bytes) -> _TinObject:
    d = Decoder(b)
    d.start(_OBJ_VERSION)
    size, doff, dlen, crc = d.u64(), d.u64(), d.u64(), d.u32()
    calg, clen, ccrc = d.string(), d.u64(), d.u32()
    xattrs = d.mapping(Decoder.string, Decoder.blob)
    d.finish()
    return _TinObject(size, doff, dlen, crc, xattrs, calg, clen, ccrc)


def _okey(cid: str, oid: str) -> bytes:
    return cid.encode() + b"\x00" + oid.encode()


def _mkey(cid: str, oid: str, key: bytes) -> bytes:
    return cid.encode() + b"\x00" + oid.encode() + b"\x00" + bytes(key)


# -- collections view (test/scrub poke surface) -------------------------------

class _OmapView(Mapping):
    """Ordered read view of one object's omap, served straight from
    the KV plane's prefix-bounded iterator (keys ascend)."""

    __slots__ = ("_st", "_cid", "_oid")

    def __init__(self, st: "TinStore", cid: str, oid: str):
        self._st, self._cid, self._oid = st, cid, oid

    def __getitem__(self, key: bytes) -> bytes:
        v = self._st._db.get("M", _mkey(self._cid, self._oid, key))
        if v is None:
            raise KeyError(key)
        return v

    def __iter__(self):
        pre = _okey(self._cid, self._oid) + b"\x00"
        for k, _v in self._st._db.iterate(
                "M", start=pre, end=pre[:-1] + b"\x01"):
            yield k[len(pre):]

    def items(self):
        pre = _okey(self._cid, self._oid) + b"\x00"
        for k, v in self._st._db.iterate(
                "M", start=pre, end=pre[:-1] + b"\x01"):
            yield k[len(pre):], v

    def __len__(self):
        return sum(1 for _ in self)


class _ObjProxy:
    """MemStore-_Object-shaped view of one object. `.data` is a
    writable memmap straight onto the device extent: in-place pokes
    are genuine on-disk corruption (no WAL, no crc update); the cache
    entry is invalidated so the next read sees the damage."""

    __slots__ = ("_st", "_cid", "_oid")

    def __init__(self, st: "TinStore", cid: str, oid: str):
        self._st, self._cid, self._oid = st, cid, oid

    def _meta(self) -> _TinObject:
        return self._st._alive()[self._cid][self._oid]

    @property
    def data(self) -> np.ndarray:
        o = self._meta()
        self._st._cache.drop((self._cid, self._oid))
        if o.size == 0:
            return np.zeros(0, dtype=np.uint8)
        # the STORED bytes (compressed blobs expose the compressed
        # stream): pokes are device-plane damage either way, caught
        # by ccrc (compressed) or crc (raw) on the next read
        return np.memmap(self._st._dev_path, dtype=np.uint8, mode="r+",
                         offset=o.doff, shape=(o.stored_len,))

    @property
    def xattrs(self) -> dict[str, bytes]:
        return self._meta().xattrs

    @property
    def omap(self) -> _OmapView:
        self._meta()                 # KeyError propagates
        return _OmapView(self._st, self._cid, self._oid)


class _CollView(Mapping):
    def __init__(self, st: "TinStore", cid: str):
        self._st, self._cid = st, cid

    def _coll(self):
        return self._st._alive()[self._cid]

    def __getitem__(self, oid: str) -> _ObjProxy:
        self._coll()[oid]            # KeyError propagates
        return _ObjProxy(self._st, self._cid, oid)

    def __iter__(self):
        return iter(self._coll())

    def __len__(self):
        return len(self._coll())


class _CollectionsView(Mapping):
    def __init__(self, st: "TinStore"):
        self._st = st

    def __getitem__(self, cid: str) -> _CollView:
        self._st._alive()[cid]       # KeyError propagates
        return _CollView(self._st, cid)

    def __iter__(self):
        return iter(self._st._alive())

    def __len__(self):
        return len(self._st._alive())


# -- the store ----------------------------------------------------------------

class TinStore:
    """File-backed ObjectStore: block-plane data device + extent
    allocator, TinDB ordered-KV metadata plane (WAL + segments +
    manifest), bounded LRU buffer cache, crc32c verify-on-read.
    Interface == MemStore."""

    COMPRESSION_ALGS = ("zlib", "lzma")

    def __init__(self, path: str, o_dsync: bool = False,
                 verify_reads: bool = True,
                 wal_max_bytes: int = 64 << 20,
                 cache_bytes: int = 64 << 20,
                 kv_memtable_bytes: int = 4 << 20,
                 kv_fanout: int = 4,
                 compression: str | None = None,
                 compression_min_blob: int = 4096,
                 compression_required_ratio: float = 0.875,
                 capacity_bytes: int = 0):
        if compression is not None \
                and compression not in self.COMPRESSION_ALGS:
            raise ValueError(f"unknown compression {compression!r}; "
                             f"use one of {self.COMPRESSION_ALGS}")
        self.path = path
        self.o_dsync = o_dsync
        self.verify_reads = verify_reads
        self.wal_max_bytes = wal_max_bytes
        self.cache_bytes = cache_bytes
        self.kv_memtable_bytes = kv_memtable_bytes
        self.kv_fanout = kv_fanout
        # inline compression (ref: BlueStore _do_write compression
        # decision: bluestore_compression_{algorithm,min_blob_size,
        # required_ratio}): blobs >= min_blob that shrink to at most
        # required_ratio of raw are stored compressed; everything
        # else stays raw. Reads are transparent either way.
        self.compression = compression
        self.compression_min_blob = compression_min_blob
        self.compression_required_ratio = compression_required_ratio
        self.compress_stats = {"compressed_blobs": 0, "raw_blobs": 0,
                               "logical_bytes": 0, "stored_bytes": 0}
        self._lock = threading.RLock()
        self._meta: dict[str, dict[str, _TinObject]] | None = None
        self._alloc = ExtentAllocator()
        self._cache = _BufferCache(cache_bytes)
        self._db: TinDB | None = None
        self._dev_fd: int | None = None
        self.committed_txns = 0
        #: capacity ceiling in bytes over device extents + WAL; 0 =
        #: unbounded. Live-shrinkable (set_capacity) for the r21
        #: disk_full injection path — enforcement is in _stage, BEFORE
        #: the allocator grows the device.
        self.capacity_bytes = int(capacity_bytes)
        #: deterministic ENOSPC injection: fn(point) raised-from at
        #: "txn.apply" (here) and every TinDB hook point (wal.append,
        #: flush.*, compact.*) — survives remounts (rewired in mount)
        self._fault = None
        os.makedirs(path, exist_ok=True)
        self.mount()

    # -- paths ---------------------------------------------------------------

    @property
    def _wal_path(self) -> str:
        return os.path.join(self.path, "wal.log")

    @property
    def _ckpt_path(self) -> str:
        """LEGACY (pre-KV) checkpoint path — only read for migration."""
        return os.path.join(self.path, "ckpt")

    @property
    def _dev_path(self) -> str:
        return os.path.join(self.path, "block.dev")

    # -- lifecycle -----------------------------------------------------------

    @staticmethod
    def _is_legacy(path: str) -> bool:
        """Pre-KV layout: no MANIFEST, but a checkpoint and/or WAL
        already exists (a fresh empty directory is NOT legacy)."""
        if os.path.exists(os.path.join(path, "MANIFEST")):
            return False
        if os.path.exists(os.path.join(path, "ckpt")):
            return True
        wal = os.path.join(path, "wal.log")
        try:
            return os.path.getsize(wal) > 0
        except OSError:
            return False

    def mount(self) -> None:
        """Mount the KV metadata plane (migrating a legacy store
        forward first), rebuild the RAM mirror, derive the allocator
        from the surviving extent map, open the device."""
        with self._lock:
            self._cache = _BufferCache(self.cache_bytes)
            self._dev_fd = os.open(self._dev_path,
                                   os.O_RDWR | os.O_CREAT, 0o644)
            try:
                if self._is_legacy(self.path):
                    self._migrate_legacy()
                try:
                    self._db = TinDB(
                        self.path, o_dsync=self.o_dsync,
                        memtable_max_bytes=self.kv_memtable_bytes,
                        fanout=self.kv_fanout, wal_name="wal.log")
                except TinDBCorruption as e:
                    raise TinStoreCorruption(str(e)) from None
                # fault hook survives remounts: each mount builds a
                # fresh TinDB, so the injection fn must be rewired or
                # a revive would silently disarm the chaos stream
                self._db._fault = getattr(self, "_fault", None)
                self._meta = {}
                self._load_mirror()
                self._derive_allocator()
            except Exception:
                os.close(self._dev_fd)
                self._dev_fd = None
                self._meta = None
                raise

    def _load_mirror(self) -> None:
        """RAM mirror (collections + object records + has_omap hints)
        rebuilt from the KV plane — O(metadata), the onode-cache warm
        load. Omap VALUES stay in the DB."""
        meta = self._meta
        for k, _v in self._db.iterate("C"):
            meta.setdefault(k.decode(), {})
        for k, v in self._db.iterate("O"):
            cid_b, oid_b = k.split(b"\x00", 1)
            try:
                obj = _decode_obj(v)
            except EncodingError as e:
                raise TinStoreCorruption(
                    f"bad object record {k!r}: {e}") from None
            meta.setdefault(cid_b.decode(), {})[oid_b.decode()] = obj
        for k, _v in self._db.iterate("M"):
            cid_b, oid_b, _mk = k.split(b"\x00", 2)
            o = meta.get(cid_b.decode(), {}).get(oid_b.decode())
            if o is not None:
                o.has_omap = True
        cnt = self._db.get("S", b"committed_txns")
        self.committed_txns = (struct.unpack("<Q", cnt)[0]
                               if cnt is not None else 0)

    def _derive_allocator(self) -> None:
        dev_size = os.fstat(self._dev_fd).st_size
        # metadata may reference past a file whose tail grow raced a
        # crash — impossible forward (grow precedes WAL append), so a
        # larger-than-file reference is corruption; reserve() raises.
        span = ExtentAllocator.round_up(dev_size)
        alloc = ExtentAllocator(span)
        for coll in self._meta.values():
            for o in coll.values():
                if o.dlen:
                    alloc.reserve(o.doff, o.dlen)
        if span > dev_size:
            os.ftruncate(self._dev_fd, span)
        self._alloc = alloc

    @property
    def is_down(self) -> bool:
        """True between crash()/umount() and the next (re)mount()."""
        return self._meta is None

    def crash(self) -> None:
        """SIGKILL semantics: drop RAM state and handles, NO flush.
        Only bytes already written to the files survive."""
        with self._lock:
            if self._db is not None:
                self._db.crash()
            if self._dev_fd is not None:
                try:
                    os.close(self._dev_fd)
                except OSError:
                    pass
                self._dev_fd = None
            self._meta = None
            self._cache.clear()

    def remount(self) -> None:
        """Restart after crash(): recover purely from disk."""
        self.mount()

    def umount(self) -> None:
        """Clean shutdown: flush the memtable then release handles."""
        with self._lock:
            self._alive()
            self._db.umount()
            os.close(self._dev_fd)
            self._dev_fd = None
            self._meta = None
            self._cache.clear()

    def _alive(self) -> dict[str, dict[str, _TinObject]]:
        if self._meta is None:
            raise RuntimeError(f"TinStore {self.path} is down "
                               f"(crashed/umounted; remount() first)")
        return self._meta

    # -- capacity (r21 capacity plane; contract shared w/ MemStore) ----------

    def set_capacity(self, nbytes: int) -> None:
        """Live capacity change; shrinking below current usage makes
        the ratio read > 1.0 and every staging alloc ENOSPC — the
        disk_full fault stream's lever."""
        with self._lock:
            self.capacity_bytes = int(nbytes)

    def set_fault(self, fn) -> None:
        """Install the deterministic injection hook on the store AND
        its KV plane (wal.append / flush.* / compact.* points)."""
        with self._lock:
            self._fault = fn
            if self._db is not None:
                self._db._fault = fn

    def used_bytes(self) -> int:
        """Allocated device extents + unflushed WAL — what counts
        against capacity. Sealed KV segments are deliberately excluded
        (they are O(metadata), bounded by compaction; documented in
        ARCHITECTURE's capacity-plane section)."""
        with self._lock:
            used = self._alloc.used_bytes()
            if self._db is not None and not self._db.is_down:
                used += self._db.wal_size()
            return used

    def statfs(self) -> dict:
        """Bytes total/used/avail (ObjectStore::statfs). total == 0
        means unbounded: the mon ladder never computes a ratio."""
        used = self.used_bytes()
        total = int(self.capacity_bytes)
        return {"total": total, "used": used,
                "avail": max(0, total - used) if total else 0}

    # -- legacy (pre-KV) store migration -------------------------------------

    def _migrate_legacy(self) -> None:
        """Forward replay: legacy ckpt + meta-op WAL -> one TinDB
        segment + MANIFEST with covered_seq past every legacy record
        (same WAL framing, so the old records are seq-skipped, never
        body-parsed). Crash before the MANIFEST lands = legacy store
        intact, migration re-runs; after = KV store live."""
        colls, omaps, committed, last_seq = \
            self._legacy_load(self.path, truncate_torn=True)
        items: dict[bytes, bytes] = {
            b"S\x00committed_txns": struct.pack("<Q", committed)}
        for cid, coll in colls.items():
            items[b"C\x00" + cid.encode()] = b""
            for oid, o in coll.items():
                items[b"O\x00" + _okey(cid, oid)] = _encode_obj(o)
        for (cid, oid), om in omaps.items():
            for k, v in om.items():
                items[b"M\x00" + _mkey(cid, oid, k)] = v
        seg_path = os.path.join(self.path, "seg-00000001.tdb")
        write_segment(seg_path, ((k, items[k]) for k in sorted(items)))
        db = TinDB(self.path, wal_name="wal.log", mount=False)
        db._covered_seq = last_seq
        db._next_seg = 2
        db._levels = [[Segment(seg_path)]]
        db._write_manifest()            # the commit point
        db.crash()
        try:
            os.unlink(self._ckpt_path)  # cosmetic; ignored once KV
        except OSError:
            pass

    @staticmethod
    def _legacy_load(path: str, truncate_torn: bool):
        """Read a pre-KV store's state: (collections, omaps,
        committed_txns, last_wal_seq). Raises TinStoreCorruption on
        damage (same contract the legacy mount had)."""
        colls: dict[str, dict[str, _TinObject]] = {}
        omaps: dict[tuple[str, str], dict[bytes, bytes]] = {}
        committed = 0
        base_seq = 0
        ckpt = os.path.join(path, "ckpt")
        try:
            with open(ckpt, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            raw = None
        if raw is not None:
            if len(raw) < 4:
                raise TinStoreCorruption(f"{ckpt}: truncated")
            (crc,) = struct.unpack_from("<I", raw, len(raw) - 4)
            if host_crc32c(raw[:-4]) != crc:
                raise TinStoreCorruption(f"{ckpt}: file seal "
                                         f"crc mismatch")
            d = Decoder(raw[:-4])
            try:
                v = d.start(_CKPT_VERSION)
                base_seq = d.u64()
                committed = d.u64()
                for _ in range(d.u32()):
                    cid = d.string()
                    coll = colls.setdefault(cid, {})
                    for _ in range(d.u32()):
                        oid = d.string()
                        size, doff, dlen, ocrc = (d.u64(), d.u64(),
                                                  d.u64(), d.u32())
                        xattrs = d.mapping(Decoder.string, Decoder.blob)
                        omap = d.mapping(Decoder.blob, Decoder.blob)
                        if v >= 3:
                            calg, clen, ccrc = (d.string(), d.u64(),
                                                d.u32())
                        else:
                            calg, clen, ccrc = "", 0, 0
                        coll[oid] = _TinObject(size, doff, dlen, ocrc,
                                               xattrs, calg, clen, ccrc)
                        if omap:
                            omaps[(cid, oid)] = omap
                d.finish()
            except EncodingError as e:
                raise TinStoreCorruption(f"{ckpt}: {e}") from None
        wal_path = os.path.join(path, "wal.log")
        seq = base_seq
        gen = scan_wal(wal_path)
        while True:
            try:
                rseq, body = next(gen)
            except StopIteration as stop:
                good_bytes, torn, err = stop.value
                if err:
                    raise TinStoreCorruption(
                        f"{wal_path}: {err} (mid-log corruption; "
                        f"run fsck)")
                if torn and truncate_torn:
                    with open(wal_path, "ab") as f:
                        f.truncate(good_bytes)
                break
            if rseq <= base_seq:
                continue                     # checkpoint covers it
            if rseq != seq + 1:
                raise TinStoreCorruption(
                    f"{wal_path}: seq jump {seq} -> {rseq}")
            try:
                ops = _decode_meta_txn(body)
            except EncodingError as e:
                raise TinStoreCorruption(
                    f"{wal_path}: record {rseq}: {e}") from None
            for op in ops:
                TinStore._legacy_apply(colls, omaps, op)
            committed += 1
            seq = rseq
        return colls, omaps, committed, seq

    @staticmethod
    def _legacy_apply(colls, omaps, op: tuple) -> None:
        kind = op[0]
        if kind == "mkcoll":
            colls.setdefault(op[1], {})
        elif kind == "rmcoll":
            coll = colls.pop(op[1], {})
            for oid in coll:
                omaps.pop((op[1], oid), None)
        elif kind == "touch":
            colls[op[1]].setdefault(op[2], _TinObject())
        elif kind in ("setext", "setextc"):
            _, cid, oid, doff, dlen, size, crc = op[:7]
            o = colls[cid].setdefault(oid, _TinObject())
            o.doff, o.dlen, o.size, o.crc = doff, dlen, size, crc
            if kind == "setextc":
                o.calg, o.clen, o.ccrc = op[7], op[8], op[9]
            else:
                o.calg, o.clen, o.ccrc = "", 0, 0
        elif kind == "remove":
            colls[op[1]].pop(op[2], None)
            omaps.pop((op[1], op[2]), None)
        elif kind == "setattr":
            colls[op[1]].setdefault(op[2], _TinObject()) \
                .xattrs[op[3]] = op[4]
        elif kind == "rmattr":
            o = colls[op[1]].get(op[2])
            if o is not None:
                o.xattrs.pop(op[3], None)
        elif kind == "omap_set":
            colls[op[1]].setdefault(op[2], _TinObject())
            omaps.setdefault((op[1], op[2]), {}).update(op[3])
        elif kind == "omap_rmkeys":
            om = omaps.get((op[1], op[2]))
            if om is not None:
                for k in op[3]:
                    om.pop(k, None)
        elif kind == "omap_clear":
            omaps.pop((op[1], op[2]), None)
        else:
            raise TinStoreCorruption(f"unknown legacy meta op {kind!r}")

    # -- flush (the checkpoint role) -----------------------------------------

    def checkpoint(self) -> None:
        """Flush the KV memtable to a sorted segment and reset the
        WAL (the metadata-checkpoint role; cost O(memtable))."""
        with self._lock:
            self._alive()
            self._db.flush()

    # -- transactional write path -------------------------------------------

    def queue_transaction(self, txn: Transaction) -> None:
        with self._lock:
            self._alive()
            self._validate(txn)
            if self._fault is not None:
                # injection point BEFORE any staging: an injected
                # ENOSPC aborts with nothing allocated or written
                self._fault("txn.apply")
            staged: dict[tuple[str, str], np.ndarray] = {}
            # objects removed EARLIER IN THIS TXN: a later write must
            # start from empty, not resurrect the pre-txn bytes
            # (MemStore applies ops in order; staging must match)
            gone: set[tuple[str, str]] = set()
            gone_colls: set[str] = set()
            new_extents: list[tuple[int, int]] = []
            meta_ops: list[tuple] = []
            try:
                for op in txn.ops:
                    kind = op[0]
                    if kind == "remove":
                        gone.add((op[1], op[2]))
                        staged.pop((op[1], op[2]), None)
                    elif kind == "rmcoll":
                        # stays in gone_colls even if re-created later
                        # in the txn: the fresh collection is EMPTY,
                        # pre-txn objects must not show through it
                        gone_colls.add(op[1])
                        for key in [k for k in staged if k[0] == op[1]]:
                            del staged[key]
                    if kind in ("write", "xor"):
                        _, cid, oid, woff, data = op
                        cur = self._staged_bytes(staged, gone,
                                                 gone_colls, cid, oid)
                        end = woff + len(data)
                        if end > len(cur):
                            grown = np.zeros(end, dtype=np.uint8)
                            grown[:len(cur)] = cur
                            cur = grown
                        else:
                            cur = cur.copy()
                        if kind == "xor":
                            cur[woff:end] ^= data
                        else:
                            cur[woff:end] = data
                        meta_ops.append(self._stage(
                            staged, new_extents, cid, oid, cur))
                    elif kind == "truncate":
                        _, cid, oid, size = op
                        cur = self._staged_bytes(staged, gone,
                                                 gone_colls, cid, oid)
                        if size <= len(cur):
                            cur = cur[:size].copy()
                        else:
                            grown = np.zeros(size, dtype=np.uint8)
                            grown[:len(cur)] = cur
                            cur = grown
                        meta_ops.append(self._stage(
                            staged, new_extents, cid, oid, cur))
                    else:
                        meta_ops.append(op)
            except Exception:
                for doff, dlen in new_extents:
                    self._alloc.free(doff, dlen)
                raise
            if self.o_dsync and new_extents:
                os.fsync(self._dev_fd)     # data durable BEFORE the WAL
            try:
                self._db.submit_transaction(self._kv_txn_for(meta_ops))
            except OSError:
                # ENOSPC on the WAL append (r21): the KV plane rolled
                # its seq/tail back and nothing references the staged
                # extents — free them so the abort is atomic live,
                # not just after a remount re-derives the allocator
                for doff, dlen in new_extents:
                    self._alloc.free(doff, dlen)
                raise
            for op in meta_ops:
                self._apply_meta(op)
            for key, arr in staged.items():
                cid, oid = key
                if cid in self._meta and oid in self._meta[cid]:
                    self._cache.put(key, arr)
            self.committed_txns += 1
            if self._db.wal_size() >= self.wal_max_bytes:
                try:
                    self._db.flush()
                except OSError:
                    # ENOSPC (real or injected) on the post-commit
                    # flush: the txn above already committed — the
                    # memtable/WAL stay whole and the next txn retries
                    # the flush once space returns
                    pass

    def _kv_txn_for(self, meta_ops: list[tuple]):
        """Translate one metadata-op batch into ONE TinDB transaction
        (the BlueStore txc->t WriteBatch build). Object records are
        re-encoded whole per touch (they're small — extent refs +
        xattrs); omap entries map 1:1 onto "M" keys; range deletes
        cover collection/object teardown."""
        kvt = self._db.transaction()
        kvt.set("S", b"committed_txns",
                struct.pack("<Q", self.committed_txns + 1))
        work: dict[tuple[str, str], _TinObject | None] = {}

        def getobj(cid, oid, create):
            key = (cid, oid)
            if key in work:
                o = work[key]
            else:
                cur = self._meta.get(cid, {}).get(oid)
                o = cur.copy() if cur is not None else None
            if o is None and create:
                o = _TinObject()
            work[key] = o
            return o

        def put(cid, oid, o):
            kvt.set("O", _okey(cid, oid), _encode_obj(o))

        for op in meta_ops:
            kind = op[0]
            if kind == "mkcoll":
                kvt.set("C", op[1].encode(), b"")
            elif kind == "rmcoll":
                cid = op[1]
                kvt.rmkey("C", cid.encode())
                kvt.rmkeys_by_prefix("O", cid.encode() + b"\x00")
                kvt.rmkeys_by_prefix("M", cid.encode() + b"\x00")
                for key in [k for k in work if k[0] == cid]:
                    work[key] = None
            elif kind == "touch":
                _, cid, oid = op
                put(cid, oid, getobj(cid, oid, create=True))
            elif kind in ("setext", "setextc"):
                _, cid, oid, doff, dlen, size, crc = op[:7]
                o = getobj(cid, oid, create=True)
                o.doff, o.dlen, o.size, o.crc = doff, dlen, size, crc
                if kind == "setextc":
                    o.calg, o.clen, o.ccrc = op[7], op[8], op[9]
                else:
                    o.calg, o.clen, o.ccrc = "", 0, 0
                put(cid, oid, o)
            elif kind == "remove":
                _, cid, oid = op
                prior = getobj(cid, oid, create=False)
                work[(cid, oid)] = None
                kvt.rmkey("O", _okey(cid, oid))
                if prior is not None and prior.has_omap:
                    kvt.rmkeys_by_prefix(
                        "M", _okey(cid, oid) + b"\x00")
            elif kind == "setattr":
                _, cid, oid, k, v = op
                o = getobj(cid, oid, create=True)
                o.xattrs[k] = v
                put(cid, oid, o)
            elif kind == "rmattr":
                _, cid, oid, k = op
                o = getobj(cid, oid, create=False)
                if o is not None:
                    o.xattrs.pop(k, None)
                    put(cid, oid, o)
            elif kind == "omap_set":
                _, cid, oid, kv = op
                o = getobj(cid, oid, create=True)
                if not o.has_omap:
                    o.has_omap = True
                put(cid, oid, o)
                for k, v in kv.items():
                    kvt.set("M", _mkey(cid, oid, k), v)
            elif kind == "omap_rmkeys":
                _, cid, oid, keys = op
                if getobj(cid, oid, create=False) is not None:
                    for k in keys:
                        kvt.rmkey("M", _mkey(cid, oid, k))
            elif kind == "omap_clear":
                _, cid, oid = op
                o = getobj(cid, oid, create=False)
                if o is not None and o.has_omap:
                    kvt.rmkeys_by_prefix(
                        "M", _okey(cid, oid) + b"\x00")
            else:
                raise ValueError(f"unknown meta op {kind!r}")
        return kvt

    def _staged_bytes(self, staged, gone, gone_colls,
                      cid, oid) -> np.ndarray:
        key = (cid, oid)
        if key in staged:
            return staged[key]
        if key in gone or cid in gone_colls:
            return np.zeros(0, dtype=np.uint8)
        coll = self._meta.get(cid, {})
        if oid in coll:
            return self._object_bytes(cid, oid)
        return np.zeros(0, dtype=np.uint8)

    @staticmethod
    def _compress(alg: str, raw: bytes) -> bytes:
        if alg == "zlib":
            import zlib
            return zlib.compress(raw, 3)
        import lzma
        return lzma.compress(raw, preset=0)

    @staticmethod
    def _decompress(alg: str, stored: bytes, logical_size: int) -> bytes:
        """Bounded decompress: never inflate past the metadata's
        logical size (a corrupt/bombed blob fails, it doesn't OOM)."""
        if alg == "zlib":
            import zlib
            dec = zlib.decompressobj()
        else:
            import lzma
            dec = lzma.LZMADecompressor()
        out = dec.decompress(stored, logical_size + 1)
        return out

    def _stage(self, staged, new_extents, cid, oid,
               arr: np.ndarray) -> tuple:
        """COW the object's new bytes into a fresh extent; return the
        setext/setextc metadata op. Nothing commits until the KV
        batch. Compression happens HERE (the _do_write decision):
        the device and the crc-on-stored-bytes see compressed data,
        the cache and the logical crc see raw data."""
        stored = arr.tobytes()
        calg = ""
        if self.compression is not None \
                and len(arr) >= self.compression_min_blob:
            comp = self._compress(self.compression, stored)
            if len(comp) <= self.compression_required_ratio * len(arr):
                stored, calg = comp, self.compression
        # capacity gate BEFORE the allocator grows the device: the
        # raise unwinds through queue_transaction's except path, which
        # frees every extent this txn already staged — the ENOSPC
        # abort is atomic (nothing hit the KV plane yet)
        if self.capacity_bytes:
            need = ExtentAllocator.round_up(max(1, len(stored)))
            if self.used_bytes() + need > self.capacity_bytes:
                import errno
                raise OSError(
                    errno.ENOSPC,
                    f"tinstore over capacity "
                    f"({self.capacity_bytes} bytes)")
        doff, dlen = self._alloc.alloc(len(stored))
        if self._alloc.device_size > os.fstat(self._dev_fd).st_size:
            os.ftruncate(self._dev_fd, self._alloc.device_size)
        if stored:
            os.pwrite(self._dev_fd, stored, doff)
        new_extents.append((doff, dlen))
        staged[(cid, oid)] = arr
        st = self.compress_stats
        st["logical_bytes"] += len(arr)
        st["stored_bytes"] += len(stored)
        if calg:
            st["compressed_blobs"] += 1
            return ("setextc", cid, oid, doff, dlen, len(arr),
                    _crc32c(arr), calg, len(stored),
                    _crc32c(np.frombuffer(stored, np.uint8)))
        st["raw_blobs"] += 1
        return ("setext", cid, oid, doff, dlen, len(arr), _crc32c(arr))

    def _validate(self, txn: Transaction) -> None:
        # the ObjectStore contract: ops referencing missing
        # collections are caller bugs -> abort before mutating anything
        cols = set(self._meta)
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

    def _apply_meta(self, op: tuple) -> None:
        """Apply one metadata op to the RAM mirror (the KV plane got
        the same mutation in the committed batch); frees replaced
        extents back to the allocator and maintains the cache."""
        meta = self._meta
        kind = op[0]
        if kind == "mkcoll":
            meta.setdefault(op[1], {})
        elif kind == "rmcoll":
            coll = meta.pop(op[1])
            for o in coll.values():
                if o.dlen:
                    self._alloc.free(o.doff, o.dlen)
            self._cache.drop_coll(op[1])
        elif kind == "touch":
            meta[op[1]].setdefault(op[2], _TinObject())
        elif kind in ("setext", "setextc"):
            _, cid, oid, doff, dlen, size, crc = op[:7]
            o = meta[cid].setdefault(oid, _TinObject())
            if o.dlen and (o.doff, o.dlen) != (doff, dlen):
                self._alloc.free(o.doff, o.dlen)
            o.doff, o.dlen, o.size, o.crc = doff, dlen, size, crc
            if kind == "setextc":
                o.calg, o.clen, o.ccrc = op[7], op[8], op[9]
            else:
                o.calg, o.clen, o.ccrc = "", 0, 0
        elif kind == "remove":
            o = meta[op[1]].pop(op[2], None)
            if o is not None and o.dlen:
                self._alloc.free(o.doff, o.dlen)
            self._cache.drop((op[1], op[2]))
        elif kind == "setattr":
            meta[op[1]].setdefault(op[2], _TinObject()) \
                .xattrs[op[3]] = op[4]
        elif kind == "rmattr":
            o = meta[op[1]].get(op[2])
            if o is not None:
                o.xattrs.pop(op[3], None)
        elif kind == "omap_set":
            # keys live in the KV plane; mirror only existence + hint
            o = meta[op[1]].setdefault(op[2], _TinObject())
            o.has_omap = True
        elif kind in ("omap_rmkeys", "omap_clear"):
            pass                             # KV-plane-only mutation
        else:
            raise ValueError(f"unknown meta op {kind!r}")

    # -- reads (bounded cache + verify-on-read) ------------------------------

    def _object_bytes(self, cid: str, oid: str) -> np.ndarray:
        """Full object bytes via the cache; miss = device pread +
        crc verify + insert (LRU eviction keeps the budget)."""
        key = (cid, oid)
        arr = self._cache.get(key)
        o = self._meta[cid][oid]
        if arr is not None and len(arr) == o.size:
            if self.verify_reads:
                self._verify(cid, oid, arr, o.crc)
            return arr
        if o.size == 0:
            return np.zeros(0, dtype=np.uint8)
        raw = os.pread(self._dev_fd, o.stored_len, o.doff)
        if o.calg:
            # verify the STORED bytes first (device-plane damage is
            # caught before the decompressor sees it), then inflate
            # and verify the logical crc
            if self.verify_reads \
                    and _crc32c(np.frombuffer(raw, np.uint8)) != o.ccrc:
                raise TinStoreCorruption(
                    f"{cid}/{oid}: stored-bytes crc mismatch "
                    f"(compressed blob, verify-on-read)")
            try:
                raw = self._decompress(o.calg, raw, o.size)
            except Exception as e:   # noqa: BLE001 — corrupt stream
                raise TinStoreCorruption(
                    f"{cid}/{oid}: decompress failed: {e}") from None
            if len(raw) != o.size:
                raise TinStoreCorruption(
                    f"{cid}/{oid}: decompressed {len(raw)} bytes, "
                    f"expected {o.size}")
        arr = np.frombuffer(raw, dtype=np.uint8)
        if self.verify_reads:
            self._verify(cid, oid, arr, o.crc)
        self._cache.put(key, arr)
        return arr

    def _verify(self, cid: str, oid: str, arr: np.ndarray,
                want: int) -> None:
        got = _crc32c(arr)
        if got != want:
            raise TinStoreCorruption(
                f"{cid}/{oid}: crc {got:#x} != expected {want:#x} "
                f"(verify-on-read)")

    def read(self, cid: str, oid: str, offset: int = 0,
             length: int | None = None) -> np.ndarray:
        with self._lock:
            coll = self._alive().get(cid)
            if coll is None or oid not in coll:
                raise KeyError(f"no object {cid}/{oid}")
            data = self._object_bytes(cid, oid)
            if length is None:
                return data[offset:].copy()
            return data[offset:offset + length].copy()

    def stat(self, cid: str, oid: str) -> int:
        with self._lock:
            coll = self._alive().get(cid)
            if coll is None or oid not in coll:
                raise KeyError(f"no object {cid}/{oid}")
            return coll[oid].size

    def getattr(self, cid: str, oid: str, key: str) -> bytes:
        with self._lock:
            coll = self._alive().get(cid)
            if coll is None or oid not in coll:
                raise KeyError(f"no object {cid}/{oid}")
            return coll[oid].xattrs[key]

    def exists(self, cid: str, oid: str) -> bool:
        with self._lock:
            meta = self._alive()
            return cid in meta and oid in meta[cid]

    # -- ordered listings (served from the KV plane) -------------------------

    def list_objects(self, cid: str, start_after: str | None = None,
                     limit: int | None = None) -> list[str]:
        """Ordered object listing from the KV plane's prefix-bounded
        iterator. With (start_after, limit) this is a PAGE: cost
        O(page + log segments), independent of collection size — the
        sublinear listing the flat-dict scan couldn't give (ref:
        BlueStore::collection_list's rocksdb iterator walk)."""
        with self._lock:
            if cid not in self._alive():
                return []
            pre = cid.encode() + b"\x00"
            start = pre if start_after is None \
                else pre + start_after.encode() + b"\x00"
            it = self._db.iterate("O", start=start,
                                  end=pre[:-1] + b"\x01")
        out: list[str] = []
        for k, _v in it:
            out.append(k[len(pre):].decode())
            if limit is not None and len(out) >= limit:
                break
        return out

    def list_collections(self) -> list[str]:
        with self._lock:
            self._alive()
            return [k.decode() for k, _v in self._db.iterate("C")]

    def omap_iter(self, cid: str, oid: str,
                  start_after: bytes | None = None,
                  limit: int | None = None) -> list[tuple[bytes, bytes]]:
        """Ordered omap page for one object (the DBObjectMap
        get_iterator role): prefix-bounded, O(page)."""
        with self._lock:
            coll = self._alive().get(cid)
            if coll is None or oid not in coll:
                raise KeyError(f"no object {cid}/{oid}")
            pre = _okey(cid, oid) + b"\x00"
            start = pre if start_after is None \
                else pre + bytes(start_after) + b"\x00"
            it = self._db.iterate("M", start=start,
                                  end=pre[:-1] + b"\x01")
        out: list[tuple[bytes, bytes]] = []
        for k, v in it:
            out.append((k[len(pre):], v))
            if limit is not None and len(out) >= limit:
                break
        return out

    @property
    def collections(self) -> _CollectionsView:
        """MemStore-shaped state access — the tests and scrub paths
        poke objects through this; `.data` mutations write the device
        in place, bypassing the WAL and crc on purpose (that's what
        corruption IS)."""
        self._alive()
        return _CollectionsView(self)

    def cache_stats(self) -> dict:
        return {"budget": self._cache.budget, "bytes": self._cache.total,
                "hits": self._cache.hits, "misses": self._cache.misses}

    def kv_stats(self) -> dict:
        """KV-plane introspection (segment/level/memtable shape)."""
        with self._lock:
            self._alive()
            return {**self._db.segment_stats(), **self._db.stats}

    @property
    def kv_perf(self):
        """The mounted TinDB's declared PerfCounters (None when the
        store is down) — a daemon nests this under "tindb" in its
        perf dump."""
        db = self._db
        return db.perf if db is not None else None

    def compact(self) -> None:
        """Full KV compaction (the ceph-kvstore-tool compact role)."""
        with self._lock:
            self._alive()
            self._db.compact()

    # -- fsck ----------------------------------------------------------------

    @staticmethod
    def fsck(path: str) -> dict:
        """Offline integrity audit (ref: BlueStore::fsck): the KV
        plane (manifest seal, segment seals + ordering, WAL chain via
        TinDB.fsck), KV-vs-block cross-checks (omap rows need an
        object record, object records a collection, extents in-bounds
        and disjoint), and every object's data crc read straight from
        the device — without mutating anything. Legacy (pre-KV)
        stores get the equivalent legacy audit."""
        report = {"objects": 0, "bad_objects": [], "wal_records": 0,
                  "torn_tail": False, "errors": [], "extent_errors": [],
                  "device_bytes": 0, "used_bytes": 0,
                  "format": "kv", "kv": {}, "omap_keys": 0}
        if TinStore._is_legacy(path):
            report["format"] = "legacy"
            try:
                colls, omaps, _committed, _seq = \
                    TinStore._legacy_load(path, truncate_torn=False)
            except TinStoreCorruption as e:
                report["errors"].append(str(e))
                return report
            report["omap_keys"] = sum(len(m) for m in omaps.values())
            TinStore._audit_block_plane(path, colls, report)
            return report
        kv = TinDB.fsck(path)
        report["kv"] = kv
        report["wal_records"] = kv["wal_records"]
        report["torn_tail"] = kv["torn_tail"]
        report["errors"].extend(kv["errors"])
        if kv["errors"]:
            return report
        try:
            snap = TinDB.open_readonly(path)
        except TinDBCorruption as e:
            report["errors"].append(str(e))
            return report
        colls: dict[str, dict[str, _TinObject]] = {}
        for k, _v in snap.iterate("C"):
            colls.setdefault(k.decode(), {})
        for k, v in snap.iterate("O"):
            cid_b, oid_b = k.split(b"\x00", 1)
            cid = cid_b.decode()
            if cid not in colls:
                report["errors"].append(
                    f"object record {cid}/{oid_b.decode()} has no "
                    f"collection record")
                colls.setdefault(cid, {})
            try:
                colls[cid][oid_b.decode()] = _decode_obj(v)
            except EncodingError as e:
                report["errors"].append(f"bad object record {k!r}: {e}")
        for k, _v in snap.iterate("M"):
            cid_b, oid_b, _mk = k.split(b"\x00", 2)
            report["omap_keys"] += 1
            if oid_b.decode() not in colls.get(cid_b.decode(), {}):
                report["errors"].append(
                    f"omap key for missing object "
                    f"{cid_b.decode()}/{oid_b.decode()}")
        TinStore._audit_block_plane(path, colls, report)
        return report

    @staticmethod
    def _audit_block_plane(path: str, colls, report: dict) -> None:
        """Extent + data-crc audit shared by the kv and legacy fsck
        paths: every referenced extent in-bounds and disjoint
        (reserve() raises on violation), every object's stored bytes
        re-checksummed straight from the device."""
        try:
            dev_size = os.path.getsize(os.path.join(path, "block.dev"))
        except OSError:
            dev_size = 0
        audit = ExtentAllocator(ExtentAllocator.round_up(dev_size))
        report["device_bytes"] = dev_size
        try:
            dev_fd = os.open(os.path.join(path, "block.dev"),
                             os.O_RDONLY)
        except OSError:
            dev_fd = None
        try:
            for cid, coll in colls.items():
                for oid, o in coll.items():
                    report["objects"] += 1
                    if o.dlen:
                        try:
                            audit.reserve(o.doff, o.dlen)
                        except TinStoreCorruption as e:
                            report["extent_errors"].append(
                                f"{cid}/{oid}: {e}")
                            continue
                    if o.size and dev_fd is not None:
                        raw = os.pread(dev_fd, o.stored_len, o.doff)
                        sarr = np.frombuffer(raw, np.uint8)
                        if o.calg:
                            # stored-bytes seal first, then inflate
                            # and audit the logical crc too
                            if _crc32c(sarr) != o.ccrc:
                                report["bad_objects"].append(
                                    f"{cid}/{oid}")
                                continue
                            try:
                                raw = TinStore._decompress(
                                    o.calg, raw, o.size)
                            except Exception:  # noqa: BLE001
                                report["bad_objects"].append(
                                    f"{cid}/{oid}")
                                continue
                            if len(raw) != o.size:
                                report["bad_objects"].append(
                                    f"{cid}/{oid}")
                                continue
                            sarr = np.frombuffer(raw, np.uint8)
                        if _crc32c(sarr) != o.crc:
                            report["bad_objects"].append(f"{cid}/{oid}")
        finally:
            if dev_fd is not None:
                os.close(dev_fd)
        report["used_bytes"] = audit.used_bytes()
