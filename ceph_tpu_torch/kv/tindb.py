"""TinDB — LSM-lite ordered KV store (the RocksDB-over-BlueFS role).

The load-bearing slice of the reference's metadata engine (ref:
src/kv/RocksDBStore.cc behaviorally; durability contract ref:
BlueStore::_kv_sync_thread — a metadata mutation is committed when its
WAL record is on disk, everything else is rebuildable):

* MEMTABLE. Mutations land in a plain dict (None value = tombstone);
  ordered reads sort the memtable keys on demand. The memtable is
  BOUNDED (`memtable_max_bytes`), so that sort is O(bounded), never
  O(database) — the property the listing benchmark measures.
* WAL. Every submit_transaction appends ONE length-prefixed,
  crc32c-sealed record (same `<magic, seq, len> body crc` framing as
  the r5 TinStore WAL, crc via ceph_tpu/csum's raw-register crc32c)
  and flushes before the memtable mutates. A batch is wholly in the
  WAL or absent; a torn tail append is truncated at mount; a bad crc
  FOLLOWED by more records is real corruption and fails the mount.
* SEGMENTS. When the memtable exceeds its budget (or on flush()),
  its sorted contents — tombstones included, they must mask older
  segments — are written to an immutable `seg-*.tdb` file: sorted
  entries, a sparse index block (every Nth key → file offset) for
  point/seek reads, and a whole-file crc32c seal. Then the MANIFEST
  is atomically replaced (covered-seq advances) and the WAL resets.
* LEVELS + COMPACTION. The MANIFEST holds a list of levels; level 0
  collects flush segments (newest last, overlapping allowed), deeper
  levels hold one merged run each. When a level reaches `fanout`
  segments, the whole level is k-way merged with the level below it
  into one new run (newer source wins per key); tombstones are
  dropped only when the output lands on the deepest level (nothing
  older left to mask). Readers never block: segments are immutable,
  and replaced segments keep serving open snapshots through their
  still-open fds after the files are unlinked.
* RECOVERY. mount() = read MANIFEST (crc-sealed, atomically renamed)
  → open+verify its segments → delete orphan segment files (a crash
  between segment write and manifest swap leaves those) → replay WAL
  records with seq > covered_seq into the memtable. Crash anywhere
  = exact state at the last committed batch.
* SNAPSHOTS. snapshot() freezes (memtable copy, segment list) —
  point-in-time get/iterate that later writes/compactions can't
  disturb (the rocksdb GetSnapshot role).
* FSCK. TinDB.fsck(path) audits offline: manifest seal, every
  segment's seal + strict key ordering + index-block consistency,
  WAL chain, and reports orphan segment files — mutating nothing.

Crash-injection for the chaos tests: `db._fault = fn` gets called
with a named point (e.g. "compact.segments-written") and may raise —
the TinStore/TinDB chaos cases use it to SIGKILL mid-compaction and
prove remount+fsck come back clean on either side of the swap.
"""

from __future__ import annotations

import heapq
import os
import struct
import threading

from .interface import (KeyValueDB, KVTransaction, combine_key,
                        prefix_range)

_REC_MAGIC = 0x544E4952            # "RINT" — same framing as the r5
_REC_HDR = struct.Struct("<IQI")   # TinStore WAL (magic, seq, body_len)
_SEG_MAGIC = 0x47455354            # "TSEG"
_SEG_HDR = struct.Struct("<II")    # magic, version
_SEG_ENTRY = struct.Struct("<IBI")  # klen, flags, vlen
_SEG_FOOTER = struct.Struct("<QQI")  # index_off, n_entries, seal crc
_SEG_VERSION = 1
_INDEX_EVERY = 64
_TOMBSTONE = 1


class TinDBCorruption(IOError):
    """Checksum/structure mismatch in the KV plane (-EIO analog)."""


_crc_impl = None


def host_crc32c(data, seed: int = 0xFFFFFFFF) -> int:
    """Raw-register crc32c (seed 0xFFFFFFFF, no final inversion) —
    native C fast path, ceph_tpu.csum pure-python fallback. Chainable
    through `seed` for incremental seals."""
    global _crc_impl
    if _crc_impl is None:
        try:
            from ..native import lib
            L = lib()

            def _crc_impl(b, s, _L=L):
                return int(_L.ec_crc32c(s, b, len(b)))
        except Exception:          # no toolchain: correctness over speed
            from ..csum.reference import ceph_crc32c

            def _crc_impl(b, s):
                return int(ceph_crc32c(s, b))
    return _crc_impl(bytes(data), seed)


# -- WAL record framing (shared scan used by TinDB and legacy replay) ---------

def append_wal_record(f, seq: int, body: bytes, o_dsync: bool) -> None:
    rec = _REC_HDR.pack(_REC_MAGIC, seq, len(body)) + body
    rec += struct.pack("<I", host_crc32c(rec))
    f.write(rec)
    f.flush()                      # survives process kill
    if o_dsync:
        os.fsync(f.fileno())       # survives machine crash


def _valid_record_after(raw: bytes, start: int) -> bool:
    """Is there any crc-valid record at/after `start`? Resyncs on the
    magic. This is what tells a corrupt TAIL (recoverable — the torn-
    append class: truncate to the last sealed record) from MID-LOG
    corruption (fatal — later sealed records would be silently
    dropped by a truncation)."""
    magic = struct.pack("<I", _REC_MAGIC)
    n = len(raw)
    pos = raw.find(magic, start)
    while pos != -1:
        if pos + _REC_HDR.size + 4 <= n:
            _m, _seq, blen = _REC_HDR.unpack_from(raw, pos)
            end = pos + _REC_HDR.size + blen + 4
            if end <= n:
                (crc,) = struct.unpack_from("<I", raw, end - 4)
                if host_crc32c(raw[pos:end - 4]) == crc:
                    return True
        pos = raw.find(magic, pos + 1)
    return False


def scan_wal(path: str):
    """Yield (seq, body) for every valid record; StopIteration.value
    is the (good_bytes, torn_tail, error) triple. A record that fails
    its seal (bad magic, bad crc, short) is a TORN TAIL when no valid
    record follows it — a torn or partially-persisted last append,
    recovered by truncating to the last sealed record — and mid-log
    CORRUPTION (error, nothing truncated) when sealed records follow:
    truncating there would silently drop committed data."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return 0, False, None
    off = 0
    n = len(raw)
    while off < n:
        if off + _REC_HDR.size + 4 > n:
            return off, True, None           # torn header
        magic, seq, blen = _REC_HDR.unpack_from(raw, off)
        if magic != _REC_MAGIC:
            if not _valid_record_after(raw, off + 1):
                return off, True, None       # corrupt last record
            return off, False, f"bad magic at {off}"
        end = off + _REC_HDR.size + blen + 4
        if end > n:
            return off, True, None           # torn body
        (crc,) = struct.unpack_from("<I", raw, end - 4)
        if host_crc32c(raw[off:end - 4]) != crc:
            if end >= n or not _valid_record_after(raw, off + 1):
                return off, True, None       # corrupt last record
            return off, False, f"crc mismatch at {off}"
        yield seq, raw[off + _REC_HDR.size:end - 4]
        off = end
    return off, False, None


def _encode_batch(ops: list[tuple]) -> bytes:
    """WAL body for one txn: expanded point ops only (range deletes
    are expanded against live state at submit so replay is blind)."""
    out = bytearray()
    out += struct.pack("<I", len(ops))
    for op in ops:
        if op[0] == "set":
            out += struct.pack("<BI", 1, len(op[1])) + op[1]
            out += struct.pack("<I", len(op[2])) + op[2]
        else:                                  # ("rm", key)
            out += struct.pack("<BI", 2, len(op[1])) + op[1]
    return bytes(out)


def _decode_batch(body: bytes) -> list[tuple]:
    ops: list[tuple] = []
    try:
        (n,) = struct.unpack_from("<I", body, 0)
        off = 4
        for _ in range(n):
            kind, klen = struct.unpack_from("<BI", body, off)
            off += 5
            key = body[off:off + klen]
            if len(key) != klen:
                raise ValueError("short key")
            off += klen
            if kind == 1:
                (vlen,) = struct.unpack_from("<I", body, off)
                off += 4
                val = body[off:off + vlen]
                if len(val) != vlen:
                    raise ValueError("short value")
                off += vlen
                ops.append(("set", key, val))
            elif kind == 2:
                ops.append(("rm", key))
            else:
                raise ValueError(f"unknown batch op {kind}")
        if off != len(body):
            raise ValueError("trailing bytes in batch")
    except (struct.error, ValueError) as e:
        raise TinDBCorruption(f"bad WAL batch: {e}") from None
    return ops


# -- sorted immutable segment -------------------------------------------------

class Segment:
    """One immutable sorted run on disk. Readers go through a sparse
    in-RAM index (every Nth key → offset) + pread, so a point lookup
    or bounded scan touches O(index + window) bytes, not the file."""

    def __init__(self, path: str, verify: bool = True):
        self.path = path
        self.fd = os.open(path, os.O_RDONLY)
        try:
            self._load_footer(verify)
        except Exception:
            os.close(self.fd)
            self.fd = -1
            raise

    def _load_footer(self, verify: bool) -> None:
        size = os.fstat(self.fd).st_size
        if size < _SEG_HDR.size + _SEG_FOOTER.size:
            raise TinDBCorruption(f"{self.path}: truncated segment")
        magic, ver = _SEG_HDR.unpack(os.pread(self.fd, _SEG_HDR.size, 0))
        if magic != _SEG_MAGIC:
            raise TinDBCorruption(f"{self.path}: bad segment magic")
        if ver > _SEG_VERSION:
            raise TinDBCorruption(f"{self.path}: segment v{ver} from "
                                  f"a newer writer")
        foot = os.pread(self.fd, _SEG_FOOTER.size,
                        size - _SEG_FOOTER.size)
        self.index_off, self.n_entries, seal = _SEG_FOOTER.unpack(foot)
        if verify:
            body = os.pread(self.fd, size - 4, 0)
            if host_crc32c(body) != seal:
                raise TinDBCorruption(f"{self.path}: segment seal "
                                      f"crc mismatch")
        if not (_SEG_HDR.size <= self.index_off
                <= size - _SEG_FOOTER.size):
            raise TinDBCorruption(f"{self.path}: index offset "
                                  f"out of bounds")
        raw = os.pread(self.fd, size - _SEG_FOOTER.size - self.index_off,
                       self.index_off)
        self.index_keys: list[bytes] = []
        self.index_offs: list[int] = []
        try:
            (cnt,) = struct.unpack_from("<I", raw, 0)
            off = 4
            for _ in range(cnt):
                (klen,) = struct.unpack_from("<I", raw, off)
                off += 4
                self.index_keys.append(bytes(raw[off:off + klen]))
                off += klen
                (eoff,) = struct.unpack_from("<Q", raw, off)
                self.index_offs.append(eoff)
                off += 8
        except struct.error:
            raise TinDBCorruption(f"{self.path}: bad index block") \
                from None

    def close(self) -> None:
        if self.fd >= 0:
            try:
                os.close(self.fd)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass
            self.fd = -1

    def __del__(self):  # snapshots may outlive the manifest reference
        self.close()

    def _read_entry(self, off: int):
        """(key, value|None, next_off) at file offset `off`, or None
        at the index block boundary."""
        if off >= self.index_off:
            return None
        hdr = os.pread(self.fd, _SEG_ENTRY.size, off)
        if len(hdr) < _SEG_ENTRY.size:
            raise TinDBCorruption(f"{self.path}: torn entry at {off}")
        klen, flags, vlen = _SEG_ENTRY.unpack(hdr)
        off += _SEG_ENTRY.size
        key = os.pread(self.fd, klen, off)
        off += klen
        if flags & _TOMBSTONE:
            return key, None, off
        val = os.pread(self.fd, vlen, off)
        if len(key) != klen or len(val) != vlen:
            raise TinDBCorruption(f"{self.path}: torn entry payload")
        return key, val, off + vlen

    def _seek_off(self, key: bytes) -> int:
        """File offset of the first entry with entry.key >= key."""
        import bisect
        i = bisect.bisect_right(self.index_keys, key) - 1
        off = self.index_offs[i] if i >= 0 else _SEG_HDR.size
        while True:
            ent = self._read_entry(off)
            if ent is None or ent[0] >= key:
                return off
            off = ent[2]

    def get(self, key: bytes):
        """(found, value|None-for-tombstone)."""
        if not self.index_keys and self.n_entries == 0:
            return False, None
        ent = self._read_entry(self._seek_off(key))
        if ent is not None and ent[0] == key:
            return True, ent[1]
        return False, None

    def iterate(self, start: bytes | None = None,
                end: bytes | None = None):
        """Yield (key, value|None) ascending in [start, end).
        Tombstones are yielded — merging layers need them."""
        off = _SEG_HDR.size if start is None else self._seek_off(start)
        while True:
            ent = self._read_entry(off)
            if ent is None:
                return
            key, val, off = ent
            if end is not None and key >= end:
                return
            yield key, val


def write_segment(path: str, items) -> int:
    """Write sorted (key, value|None) pairs as a sealed segment;
    returns the entry count. fsyncs before returning — the MANIFEST
    that references this file lands only after the bytes are real."""
    crc = 0xFFFFFFFF
    n = 0
    index = bytearray()
    with open(path, "wb") as f:
        def emit(b: bytes):
            nonlocal crc
            f.write(b)
            crc = host_crc32c(b, crc)

        emit(_SEG_HDR.pack(_SEG_MAGIC, _SEG_VERSION))
        off = _SEG_HDR.size
        n_index = 0
        for key, val in items:
            if n % _INDEX_EVERY == 0:
                index += struct.pack("<I", len(key)) + key
                index += struct.pack("<Q", off)
                n_index += 1
            flags = _TOMBSTONE if val is None else 0
            vlen = 0 if val is None else len(val)
            ent = _SEG_ENTRY.pack(len(key), flags, vlen) + key
            if val is not None:
                ent += val
            emit(ent)
            off += len(ent)
            n += 1
        index_off = off
        emit(struct.pack("<I", n_index) + bytes(index))
        emit(struct.pack("<QQ", index_off, n))
        f.write(struct.pack("<I", crc))
        f.flush()
        os.fsync(f.fileno())
    return n


# -- merge machinery ----------------------------------------------------------

def _merge_layers(layers, keep_tombstones=True):
    """K-way merge of (key, value|None) iterators, layers[0] newest;
    for equal keys the NEWEST layer wins. Yields ascending."""
    heap = []
    iters = []
    for rank, it in enumerate(layers):
        iters.append(it)
        try:
            k, v = next(it)
            heap.append((k, rank, v))
        except StopIteration:
            pass
    heapq.heapify(heap)
    last_key = None
    while heap:
        k, rank, v = heapq.heappop(heap)
        try:
            nk, nv = next(iters[rank])
            heapq.heappush(heap, (nk, rank, nv))
        except StopIteration:
            pass
        if k == last_key:
            continue                          # an older layer's value
        last_key = k
        if v is None and not keep_tombstones:
            continue
        yield k, v


def _mem_iter(mem: dict, start=None, end=None):
    keys = sorted(k for k in mem
                  if (start is None or k >= start)
                  and (end is None or k < end))
    for k in keys:
        yield k, mem[k]


# -- snapshot -----------------------------------------------------------------

class TinDBSnapshot:
    """Frozen read view: memtable copy + pinned segment objects.
    Segments are immutable and keep their fds open, so a compaction
    unlinking the files underneath cannot disturb this view."""

    def __init__(self, mem: dict, segments: list[Segment]):
        self._mem = mem                       # already a copy
        self._segments = segments             # newest first

    def get(self, prefix: str, key: bytes) -> bytes | None:
        full = combine_key(prefix, key)
        if full in self._mem:
            return self._mem[full]
        for seg in self._segments:
            found, val = seg.get(full)
            if found:
                return val
        return None

    def iterate(self, prefix: str, start: bytes | None = None,
                end: bytes | None = None):
        lo, hi = prefix_range(prefix)
        if start is not None:
            lo = combine_key(prefix, start)
        if end is not None:
            hi = combine_key(prefix, end)
        hi = hi or None                       # b"" successor = +inf
        plen = len(prefix.encode()) + 1
        layers = [_mem_iter(self._mem, lo, hi)]
        layers += [seg.iterate(lo, hi) for seg in self._segments]
        for k, v in _merge_layers(layers, keep_tombstones=False):
            yield k[plen:], v


# -- the store ----------------------------------------------------------------

class TinDB(KeyValueDB):
    """LSM-lite KeyValueDB over one directory (WAL + MANIFEST +
    seg-*.tdb). Thread-safe behind one RLock (the rocksdb write-mutex
    role at this scale)."""

    MANIFEST_VERSION = 1

    def __init__(self, path: str, o_dsync: bool = False,
                 memtable_max_bytes: int = 4 << 20,
                 fanout: int = 4,
                 wal_name: str = "wal.log",
                 mount: bool = True):
        self.path = path
        self.o_dsync = o_dsync
        self.memtable_max_bytes = memtable_max_bytes
        self.fanout = max(2, int(fanout))
        self.wal_name = wal_name
        self._lock = threading.RLock()
        self._mem: dict[bytes, bytes | None] | None = None
        self._mem_bytes = 0
        self._levels: list[list[Segment]] = []
        self._seq = 0                  # last written WAL seq
        self._covered_seq = 0          # WAL seqs <= this live in segments
        self._next_seg = 1
        self._wal_f = None
        self._fault = None             # crash-injection hook (tests)
        self.stats = {"gets": 0, "iterators": 0, "flushes": 0,
                      "compactions": 0, "submitted": 0,
                      "wal_replayed": 0}
        # declared counter mirror of `stats` plus byte/time detail —
        # what a daemon nests under "tindb" in its perf dump and what
        # MgrReports aggregate (the RocksDB statistics -> perf
        # counters bridge the reference's BlueStore maintains)
        from ..utils.perf_counters import PerfCountersBuilder
        self.perf = (PerfCountersBuilder("tindb")
                     .add_u64_counter("wal_records",
                                      "transaction batches appended")
                     .add_u64_counter("wal_bytes",
                                      "bytes appended to the WAL")
                     .add_u64_counter("wal_replayed",
                                      "records replayed at mount")
                     .add_u64_counter("flushes", "memtable flushes")
                     .add_u64_counter("compactions", "level merges")
                     .add_u64_counter("gets", "point lookups")
                     .add_u64_counter("iterators", "range scans opened")
                     .add_time_avg("submit_time",
                                   "submit_transaction wall time")
                     .add_time_avg("compact_time",
                                   "per-merge compaction wall time")
                     .create_perf_counters())
        os.makedirs(path, exist_ok=True)
        if mount:
            self.mount()

    # -- paths ---------------------------------------------------------------

    @property
    def _wal_path(self) -> str:
        return os.path.join(self.path, self.wal_name)

    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.path, "MANIFEST")

    def _seg_path(self, seg_id: int) -> str:
        return os.path.join(self.path, f"seg-{seg_id:08d}.tdb")

    # -- manifest ------------------------------------------------------------

    def _write_manifest(self) -> None:
        from ..utils.encoding import Encoder
        e = Encoder()
        e.start(self.MANIFEST_VERSION, self.MANIFEST_VERSION)
        e.u64(self._covered_seq)
        e.u64(self._next_seg)
        e.u32(len(self._levels))
        for level in self._levels:
            e.list([os.path.basename(s.path) for s in level],
                   Encoder.string)
        e.finish()
        body = e.bytes()
        body += struct.pack("<I", host_crc32c(body))
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(body)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path)

    @classmethod
    def _read_manifest(cls, path: str):
        """(covered_seq, next_seg, levels-as-filenames) or None when
        absent. Raises TinDBCorruption on a bad seal."""
        from ..utils.encoding import Decoder, EncodingError
        try:
            with open(os.path.join(path, "MANIFEST"), "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        if len(raw) < 4:
            raise TinDBCorruption(f"{path}/MANIFEST: truncated")
        (crc,) = struct.unpack_from("<I", raw, len(raw) - 4)
        if host_crc32c(raw[:-4]) != crc:
            raise TinDBCorruption(f"{path}/MANIFEST: seal crc mismatch")
        d = Decoder(raw[:-4])
        try:
            d.start(cls.MANIFEST_VERSION)
            covered = d.u64()
            next_seg = d.u64()
            levels = [d.list(Decoder.string) for _ in range(d.u32())]
            d.finish()
        except EncodingError as e:
            raise TinDBCorruption(f"{path}/MANIFEST: {e}") from None
        return covered, next_seg, levels

    # -- lifecycle -----------------------------------------------------------

    def mount(self) -> None:
        with self._lock:
            self._mem = {}
            self._mem_bytes = 0
            self._levels = []
            man = self._read_manifest(self.path)
            if man is None:
                self._covered_seq = 0
                self._next_seg = 1
                self._write_manifest()       # claims the directory
            else:
                self._covered_seq, self._next_seg, names = man
                for level_names in names:
                    self._levels.append(
                        [Segment(os.path.join(self.path, n))
                         for n in level_names])
            live = {os.path.basename(s.path)
                    for lvl in self._levels for s in lvl}
            for fn in os.listdir(self.path):
                # crash between segment write and manifest swap
                # leaves an orphan run; reclaim it
                if fn.startswith("seg-") and fn.endswith(".tdb") \
                        and fn not in live:
                    try:
                        os.unlink(os.path.join(self.path, fn))
                    except OSError:
                        pass
            self._seq = self._covered_seq
            self._replay_wal()
            self._wal_f = open(self._wal_path, "ab")

    def _replay_wal(self) -> None:
        gen = scan_wal(self._wal_path)
        while True:
            try:
                seq, body = next(gen)
            except StopIteration as stop:
                good_bytes, torn, err = stop.value
                if err:
                    raise TinDBCorruption(
                        f"{self._wal_path}: {err} (mid-log corruption; "
                        f"run fsck)")
                if torn:
                    with open(self._wal_path, "ab") as f:
                        f.truncate(good_bytes)
                return
            if seq <= self._covered_seq:
                continue                     # segments cover it
            if seq != self._seq + 1:
                raise TinDBCorruption(
                    f"{self._wal_path}: seq jump {self._seq} -> {seq}")
            for op in _decode_batch(body):
                self._mem_apply(op)
            self.stats["wal_replayed"] += 1
            self.perf.inc("wal_replayed")
            self._seq = seq

    def crash(self) -> None:
        """SIGKILL semantics: drop RAM and handles, flush nothing."""
        with self._lock:
            if self._wal_f is not None:
                try:
                    self._wal_f.close()
                except OSError:
                    pass
                self._wal_f = None
            for lvl in self._levels:
                for seg in lvl:
                    seg.close()
            self._levels = []
            self._mem = None
            self._mem_bytes = 0

    def umount(self) -> None:
        """Clean shutdown: flush the memtable, release handles."""
        with self._lock:
            self.flush()
            self.crash()

    @property
    def is_down(self) -> bool:
        return self._mem is None

    def _alive(self) -> dict:
        if self._mem is None:
            raise RuntimeError(f"TinDB {self.path} is down "
                               f"(crashed/umounted; mount() first)")
        return self._mem

    def _hook(self, point: str) -> None:
        if self._fault is not None:
            self._fault(point)

    # -- writes --------------------------------------------------------------

    def _mem_apply(self, op: tuple) -> None:
        key = op[1]
        old = self._mem.get(key)
        if old is not None:
            self._mem_bytes -= len(key) + len(old)
        elif key in self._mem:
            self._mem_bytes -= len(key)
        if op[0] == "set":
            self._mem[key] = op[2]
            self._mem_bytes += len(key) + len(op[2])
        else:
            self._mem[key] = None            # tombstone masks segments
            self._mem_bytes += len(key)

    def _expand(self, txn: KVTransaction) -> list[tuple]:
        """Resolve range deletes into point tombstones against the
        state visible at their position in the batch (rocksdb
        DeleteRange is an optimization of exactly this semantics)."""
        out: list[tuple] = []
        overlay: dict[bytes, bytes | None] = {}
        for op in txn.ops:
            if op[0] in ("set", "rm"):
                out.append(op)
                overlay[op[1]] = op[2] if op[0] == "set" else None
                continue
            _, lo, hi = op
            hi_b = hi or None                # b"" successor = +inf
            doomed = set()
            for k in self._scan_full(lo, hi_b):
                if overlay.get(k, k) is not None:   # not deleted earlier
                    doomed.add(k)
            for k, v in overlay.items():
                if v is not None and k >= lo \
                        and (hi_b is None or k < hi_b):
                    doomed.add(k)
            for k in sorted(doomed):
                out.append(("rm", k))
                overlay[k] = None
        return out

    def _scan_full(self, lo: bytes, hi: bytes | None):
        """Live full keys in [lo, hi) (tombstones resolved)."""
        layers = [_mem_iter(self._mem, lo, hi)]
        for lvl in self._levels:
            layers += [seg.iterate(lo, hi) for seg in reversed(lvl)]
        for k, v in _merge_layers(layers, keep_tombstones=False):
            yield k

    def submit_transaction(self, txn: KVTransaction) -> None:
        import time as _time
        t0 = _time.perf_counter()
        with self._lock:
            self._alive()
            ops = self._expand(txn)
            body = _encode_batch(ops)
            self._hook("wal.append")
            # the append must be ATOMIC against ENOSPC (r21): seq only
            # advances once the record is durably on disk, and a
            # partial append (f.write stops mid-record when the device
            # fills) is truncated back to the sealed prefix —
            # shrinking a file needs no space. Without the rollback a
            # failed append left _seq advanced past the last durable
            # record (fatal seq-jump on replay) and without the
            # truncate a LATER successful append would bury garbage
            # mid-log (fatal "bad magic", not the recoverable torn
            # tail).
            start = self._wal_f.tell()
            try:
                append_wal_record(self._wal_f, self._seq + 1, body,
                                  self.o_dsync)
            except OSError:
                try:
                    self._wal_f.truncate(start)
                    self._wal_f.seek(start)
                except OSError:
                    pass    # crash-before-truncate = torn tail, which
                    #         scan_wal already recovers
                raise
            self._seq += 1
            for op in ops:
                self._mem_apply(op)
            self.stats["submitted"] += 1
            self.perf.inc_many(
                (("wal_records", 1),
                 ("wal_bytes", _REC_HDR.size + len(body) + 4)))
            if self._mem_bytes >= self.memtable_max_bytes:
                try:
                    self.flush()
                except OSError:
                    # ENOSPC flushing a full memtable: the txn above
                    # already committed to the WAL — swallow, keep
                    # accepting (bounded by the WAL) and retry the
                    # flush on a later submit
                    pass
        self.perf.tinc("submit_time", _time.perf_counter() - t0)

    # -- flush + compaction --------------------------------------------------

    def _all_segments(self) -> list[Segment]:
        """Newest-first flat view (L0 newest-last, deeper = older)."""
        out: list[Segment] = []
        if self._levels:
            out.extend(reversed(self._levels[0]))
            for lvl in self._levels[1:]:
                out.extend(reversed(lvl))
        return out

    def flush(self) -> None:
        """Memtable -> new L0 segment, MANIFEST swap, WAL reset.
        Crash windows: before the swap -> old manifest + full WAL
        (orphan segment reclaimed at mount); after the swap, before
        the reset -> covered_seq makes replay skip the stale records.
        Either way state is exact."""
        with self._lock:
            self._alive()
            if self._mem:
                seg_id = self._next_seg
                self._next_seg += 1
                path = self._seg_path(seg_id)
                try:
                    write_segment(path, ((k, self._mem[k])
                                         for k in sorted(self._mem)))
                    self._hook("flush.segment-written")
                except OSError:
                    # ENOSPC mid-segment (r21): unlink the partial
                    # run and abort — memtable, WAL and manifest are
                    # untouched, so the flush simply retries later
                    # (the seg-id gap is harmless; mount reclaims any
                    # leftover as an orphan)
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    raise
                if not self._levels:
                    self._levels.append([])
                self._levels[0].append(Segment(path))
                self.stats["flushes"] += 1
                self.perf.inc("flushes")
            # covered_seq must equal the last written seq whenever the
            # WAL is truncated — even for an empty memtable (a no-op
            # batch still consumed a seq; replay after the reset must
            # not see a seq jump)
            if self._covered_seq != self._seq or self._mem:
                self._covered_seq = self._seq
                self._write_manifest()
                self._hook("flush.manifest-swapped")
            self._mem = {}
            self._mem_bytes = 0
            if self._wal_f is not None:
                self._wal_f.close()
            self._wal_f = open(self._wal_path, "wb")
            self.maybe_compact()

    def maybe_compact(self) -> None:
        with self._lock:
            while any(len(lvl) >= self.fanout for lvl in self._levels):
                for i, lvl in enumerate(self._levels):
                    if len(lvl) >= self.fanout:
                        try:
                            self.compact_level(i)
                        except OSError:
                            # ENOSPC: compaction is advisory — the
                            # flush that triggered us already
                            # committed; retry on a later flush
                            return
                        break

    def compact_level(self, i: int) -> None:
        """Merge level i and level i+1 into ONE run on level i+1
        (newer wins per key; tombstones dropped iff the output is the
        deepest level). Readers are never blocked: old segments stay
        readable through open fds until their objects die."""
        import time as _time
        t0 = _time.perf_counter()
        with self._lock:
            self._alive()
            if i >= len(self._levels) or not self._levels[i]:
                return
            below = self._levels[i + 1] if i + 1 < len(self._levels) \
                else []
            victims = list(self._levels[i]) + list(below)
            deepest = all(not lvl for lvl in self._levels[i + 2:])
            layers = [seg.iterate() for seg in reversed(self._levels[i])]
            layers += [seg.iterate() for seg in reversed(below)]
            seg_id = self._next_seg
            self._next_seg += 1
            path = self._seg_path(seg_id)
            try:
                write_segment(path, _merge_layers(
                    layers, keep_tombstones=not deepest))
                self._hook("compact.segments-written")
            except OSError:
                # ENOSPC mid-merge (r21): unlink the partial output
                # and abort — levels and manifest untouched, every
                # victim still live; the merge retries later
                try:
                    os.unlink(path)
                except OSError:
                    pass
                raise
            merged = Segment(path)
            if i + 1 >= len(self._levels):
                self._levels.append([])
            self._levels[i] = []
            self._levels[i + 1] = [merged]
            self._write_manifest()
            self._hook("compact.manifest-swapped")
            for seg in victims:
                try:
                    os.unlink(seg.path)
                except OSError:
                    pass
            self.stats["compactions"] += 1
            self.perf.inc("compactions")
        self.perf.tinc("compact_time", _time.perf_counter() - t0)

    def compact(self) -> None:
        """Full compaction (the `ceph-kvstore-tool compact` role):
        flush, then merge everything down to one run."""
        with self._lock:
            self.flush()
            while sum(1 for lvl in self._levels if lvl) > 1 \
                    or (self._levels and len(self._levels[0]) > 1):
                lo = next(j for j, lvl in enumerate(self._levels)
                          if lvl)
                self.compact_level(lo)

    # -- reads ---------------------------------------------------------------

    def get(self, prefix: str, key: bytes) -> bytes | None:
        with self._lock:
            self._alive()
            self.stats["gets"] += 1
            self.perf.inc("gets")
            full = combine_key(prefix, key)
            if full in self._mem:
                return self._mem[full]
            for seg in self._all_segments():
                found, val = seg.get(full)
                if found:
                    return val
            return None

    def iterate(self, prefix: str, start: bytes | None = None,
                end: bytes | None = None):
        """Ordered, prefix-bounded scan. Iterates over a SNAPSHOT
        taken at call time (memtable copy + pinned segments), so
        concurrent writes/flushes/compactions can't corrupt the walk."""
        with self._lock:
            self._alive()
            self.stats["iterators"] += 1
            self.perf.inc("iterators")
            snap = self.snapshot()
        return snap.iterate(prefix, start, end)

    def snapshot(self) -> TinDBSnapshot:
        with self._lock:
            self._alive()
            return TinDBSnapshot(dict(self._mem), self._all_segments())

    def wal_size(self) -> int:
        with self._lock:
            self._alive()
            return self._wal_f.tell()

    @classmethod
    def open_readonly(cls, path: str,
                      wal_name: str = "wal.log") -> TinDBSnapshot:
        """Offline point-in-time view for fsck/inspection tools:
        manifest + segments + in-memory WAL replay, with NO mutation
        (no manifest claim, no torn-tail truncation, no orphan
        cleanup). Raises TinDBCorruption on structural damage."""
        man = cls._read_manifest(path)
        if man is None:
            raise TinDBCorruption(f"{path}/MANIFEST: missing")
        covered, _next_seg, levels = man
        seg_levels = [[Segment(os.path.join(path, n)) for n in lvl]
                      for lvl in levels]
        mem: dict[bytes, bytes | None] = {}
        seq = covered
        gen = scan_wal(os.path.join(path, wal_name))
        while True:
            try:
                rseq, body = next(gen)
            except StopIteration as stop:
                _, _torn, err = stop.value
                if err:
                    raise TinDBCorruption(
                        f"{path}/{wal_name}: {err}")
                break
            if rseq <= covered:
                continue
            if rseq != seq + 1:
                raise TinDBCorruption(
                    f"{path}/{wal_name}: seq jump {seq} -> {rseq}")
            for op in _decode_batch(body):
                mem[op[1]] = op[2] if op[0] == "set" else None
            seq = rseq
        flat: list[Segment] = []
        if seg_levels:
            flat.extend(reversed(seg_levels[0]))
            for lvl in seg_levels[1:]:
                flat.extend(reversed(lvl))
        return TinDBSnapshot(mem, flat)

    def segment_stats(self) -> dict:
        with self._lock:
            return {
                "levels": [[os.path.basename(s.path) for s in lvl]
                           for lvl in self._levels],
                "segments": sum(len(lvl) for lvl in self._levels),
                "entries": sum(s.n_entries for lvl in self._levels
                               for s in lvl),
                "memtable_keys": len(self._mem or ()),
                "memtable_bytes": self._mem_bytes,
                "wal_seq": self._seq,
                "covered_seq": self._covered_seq,
            }

    # -- fsck ----------------------------------------------------------------

    @staticmethod
    def fsck(path: str, wal_name: str = "wal.log") -> dict:
        """Offline audit: manifest seal, segment seals + strict key
        order + index consistency, WAL chain, orphan files. Mutates
        nothing."""
        report = {"segments": 0, "entries": 0, "wal_records": 0,
                  "torn_tail": False, "errors": [], "orphans": []}
        try:
            man = TinDB._read_manifest(path)
        except TinDBCorruption as e:
            report["errors"].append(str(e))
            return report
        if man is None:
            report["errors"].append(f"{path}/MANIFEST: missing")
            return report
        covered, _next_seg, levels = man
        live = {n for lvl in levels for n in lvl}
        for fn in sorted(os.listdir(path)):
            if fn.startswith("seg-") and fn.endswith(".tdb") \
                    and fn not in live:
                report["orphans"].append(fn)
        for lvl in levels:
            for name in lvl:
                report["segments"] += 1
                try:
                    seg = Segment(os.path.join(path, name))
                except (TinDBCorruption, OSError) as e:
                    report["errors"].append(str(e))
                    continue
                prev = None
                n = 0
                try:
                    for k, _v in seg.iterate():
                        if prev is not None and k <= prev:
                            report["errors"].append(
                                f"{name}: keys out of order")
                            break
                        prev = k
                        n += 1
                except TinDBCorruption as e:
                    report["errors"].append(str(e))
                else:
                    if n != seg.n_entries:
                        report["errors"].append(
                            f"{name}: footer says {seg.n_entries} "
                            f"entries, scanned {n}")
                    report["entries"] += n
                seg.close()
        gen = scan_wal(os.path.join(path, wal_name))
        seq = covered
        while True:
            try:
                rseq, body = next(gen)
            except StopIteration as stop:
                _, torn, err = stop.value
                report["torn_tail"] = torn
                if err:
                    report["errors"].append(err)
                break
            if rseq <= covered:
                continue
            if rseq != seq + 1:
                report["errors"].append(f"wal seq jump {seq} -> {rseq}")
                break
            try:
                _decode_batch(body)
            except TinDBCorruption as e:
                report["errors"].append(f"wal record {rseq}: {e}")
                break
            seq = rseq
            report["wal_records"] += 1
        return report
