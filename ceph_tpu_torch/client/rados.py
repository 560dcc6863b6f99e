"""librados-shaped client API + radosstriper analog.

Rebuild of the reference's public object API (ref: src/librados/
librados.cc `rados_write/rados_write_full/rados_read/rados_remove/
rados_stat`, RadosClient/IoCtxImpl split; python binding shape ref:
src/pybind/rados/rados.pyx — Rados.open_ioctx -> IoCtx methods) and of
the client-side striper (ref: src/libradosstriper/
RadosStriperImpl.cc — a logical byte stream striped round-robin in
stripe_unit pieces across stripe_count rados objects of object_size
each; the layout ref: libradosstriper's default one-object-set
striping, same math as ECUtil's round-robin but client-side).

Everything routes through the Objecter (retry/retarget on map change),
so callers get the same semantics librados users get: write during a
remap lands correctly without caller involvement.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .objecter import Objecter


class Completion:
    """An in-flight async op (the rados_completion_t role, ref:
    src/librados/AioCompletionImpl.h): wait_for_complete blocks,
    is_complete polls, get_return_value yields the op's result (and
    re-raises its failure — librados returns the negative errno the
    same way)."""

    def __init__(self, callback=None):
        self._ev = threading.Event()
        self._cb = callback
        self._result = None
        self._exc: BaseException | None = None
        self._done = False

    def _finish(self, result, exc) -> None:
        self._result, self._exc = result, exc
        self._done = True       # value readable (e.g. FROM the cb)
        if self._cb is not None:
            try:
                self._cb(self)
            except Exception:   # noqa: BLE001 — a broken user callback
                pass            # must not kill the completion thread
        # signaled only AFTER the callback ran — librados order: a
        # wait_for_complete/aio_flush returning guarantees callbacks
        # finished too (aggregates built in callbacks are whole)
        self._ev.set()

    def is_complete(self) -> bool:
        return self._ev.is_set()

    def wait_for_complete(self, timeout: float | None = None) -> bool:
        return self._ev.wait(timeout)

    def get_return_value(self):
        if not self._done:
            self._ev.wait()
        if self._exc is not None:
            raise self._exc
        return self._result


class Rados:
    """Cluster handle (the RadosClient role)."""

    def __init__(self, cluster, aio_threads: int = 4):
        self.cluster = cluster
        self._objecter = Objecter(cluster)
        # the finisher/op thread pool behind aio_* (ref: librados'
        # Objecter op threads + the AioCompletion finisher): ops run
        # here, completions fire from here; created LAZILY so sync-only
        # handles never spawn threads. The Objecter serializes
        # dispatch under its own (reentrant) lock, so concurrency is
        # safe; aio buys PIPELINING of staging/callback work.
        self._aio_threads = aio_threads
        self._aio: ThreadPoolExecutor | None = None
        self._aio_lock = threading.Lock()
        self._aio_inflight: set = set()

    def shutdown(self) -> None:
        """rados_shutdown: drain in-flight aio and join the worker
        threads. The handle stays usable for SYNC ops afterwards; a
        later aio op lazily rebuilds the pool."""
        with self._aio_lock:
            pool, self._aio = self._aio, None
        if pool is not None:
            pool.shutdown(wait=True)

    def open_ioctx(self, pool: str = "default") -> "IoCtx":
        # the sim carries one pool (id 1); named lookup mirrors
        # rados_ioctx_create's pool-name resolution
        if pool not in ("default", "1"):
            raise ValueError(f"no pool {pool!r}")
        return IoCtx(self, pool)

    def stat_cluster(self) -> dict:
        return self.cluster.health()


def sim_clock(ioctx: "IoCtx") -> float:
    """The sim cluster's VIRTUAL clock when present — 0.0 included
    (an `or time.time()` would silently mix wall-clock into virtual
    time and break age math); wall time only without a sim cluster.
    Shared by every service layer (RGW mtimes, FS mtimes)."""
    import time
    now = getattr(ioctx.rados.cluster, "now", None)
    return time.time() if now is None else now


class IoCtx:
    """Per-pool I/O context (IoCtxImpl)."""

    def __init__(self, rados: Rados, pool: str):
        self.rados = rados
        self.pool = pool
        self._ob = rados._objecter

    # -- object ops (librados C API names) ----------------------------------

    def write_full(self, name: str, data: bytes | np.ndarray,
                   snapc: int = 0) -> None:
        self._ob.write({name: data}, snapc=snapc)

    def write(self, name: str, data: bytes | np.ndarray,
              offset: int = 0, snapc: int = 0) -> None:
        self._ob.write_at(name, offset, data, snapc=snapc)

    def append(self, name: str, data: bytes | np.ndarray,
               snapc: int = 0) -> int:
        """rados_append: bytes land at the object's current tail (the
        primary resolves the size server-side, so concurrent appenders
        serialize there). Returns the landed offset. On an EC pool a
        tail inside stripe padding takes the r16 no-preread fast
        path."""
        return self._ob.append(name, data, snapc=snapc)

    def read(self, name: str, length: int | None = None,
             offset: int = 0, snap: int | None = None) -> bytes:
        """`snap` reads the object's state as of that pool snapshot
        (the rados_ioctx_snap_set_read role, per-call instead of
        sticky context)."""
        if snap is None:
            arr = self._ob.read(name)
        else:
            with self._ob._dispatch_lock:
                arr = self.rados.cluster.snap_read(name, snap)
        if length is None:
            return arr[offset:].tobytes()
        return arr[offset:offset + length].tobytes()

    def read_many(self, names) -> dict[str, bytes]:
        """Batched reads: one submission per PG, each decoded in one
        batched launch (the aio_read-batch role; wire-tier Client
        .read_many parity). Rides the Objecter, so the degraded-read
        fast path covers these too — a dead primary costs a decode
        from surviving shards, not a detection wait."""
        got = self._ob.read(list(names))
        return {n: arr.tobytes() for n, arr in got.items()}

    def remove(self, name: str, snapc: int = 0) -> None:
        self._ob.remove(name, snapc=snapc)

    def stat(self, name: str) -> int:
        """Object size in bytes (rados_stat's pmtime is meaningless in
        virtual time). Serialized with in-flight aio — PG state is
        not thread-safe (see Objecter._dispatch_lock)."""
        with self._ob._dispatch_lock:
            ps = self.rados.cluster.locate(name)
            return self.rados.cluster.pgs[ps].stat_object(name)

    def list_objects(self) -> list[str]:
        with self._ob._dispatch_lock:
            c = self.rados.cluster
            return sorted(n for ps in range(c.pg_num)
                          for n in c.pgs[ps].list_pg_objects())

    # -- async ops (rados_aio_*, ref: librados.cc rados_aio_write/
    #    rados_aio_read/rados_aio_flush over AioCompletionImpl) -------------

    def _aio_submit(self, fn, callback) -> Completion:
        comp = Completion(callback)
        r = self.rados

        def run():
            try:
                comp._finish(fn(), None)
            except BaseException as e:   # noqa: BLE001 — surfaces via
                comp._finish(None, e)    # get_return_value, as errno
            finally:
                with r._aio_lock:
                    r._aio_inflight.discard(comp)
        # pool-get + inflight-add + submit under ONE lock window: a
        # concurrent shutdown() between them would otherwise leave a
        # registered-but-never-run completion that hangs aio_flush
        # forever (shutdown swaps the pool out under the same lock)
        with r._aio_lock:
            if r._aio is None:
                r._aio = ThreadPoolExecutor(
                    max_workers=r._aio_threads,
                    thread_name_prefix="rados-aio")
            r._aio_inflight.add(comp)
            try:
                r._aio.submit(run)
            except RuntimeError:
                r._aio_inflight.discard(comp)
                raise
        return comp

    def aio_write_full(self, name: str, data: bytes,
                       callback=None, snapc: int = 0) -> Completion:
        data = bytes(data)   # snapshot the buffer at submit time
        return self._aio_submit(
            lambda: self.write_full(name, data, snapc=snapc) or len(data),
            callback)

    def aio_write(self, name: str, data: bytes, offset: int = 0,
                  callback=None, snapc: int = 0) -> Completion:
        data = bytes(data)
        return self._aio_submit(
            lambda: self.write(name, data, offset=offset,
                               snapc=snapc) or len(data),
            callback)

    def aio_read(self, name: str, length: int | None = None,
                 offset: int = 0, callback=None) -> Completion:
        return self._aio_submit(
            lambda: self.read(name, length=length, offset=offset),
            callback)

    def aio_remove(self, name: str, callback=None,
                   snapc: int = 0) -> Completion:
        return self._aio_submit(
            lambda: self.remove(name, snapc=snapc), callback)

    def aio_flush(self, comps: list[Completion] | None = None) -> None:
        """Barrier: wait until outstanding aio completes (ref:
        rados_aio_flush). With a list, waits those; with None, every
        op in flight at the moment of the call (ops submitted AFTER
        the flush began are not covered, as upstream)."""
        if comps is None:
            with self.rados._aio_lock:
                comps = list(self.rados._aio_inflight)
        for c in comps:
            c.wait_for_complete()

    # -- pool snapshots (rados_ioctx_snap_*) --------------------------------

    def snap_create(self) -> int:
        with self._ob._dispatch_lock:
            return self.rados.cluster.snap_create()

    def snap_remove(self, snap_id: int) -> int:
        with self._ob._dispatch_lock:
            return self.rados.cluster.snap_remove(snap_id)

    def snap_rollback(self, name: str, snap_id: int) -> None:
        with self._ob._dispatch_lock:
            self.rados.cluster.snap_rollback(name, snap_id)

    def snap_list(self) -> list[int]:
        with self._ob._dispatch_lock:
            return sorted(self.rados.cluster.snaps)

    # -- selfmanaged snaps (rados_ioctx_selfmanaged_snap_*) -----------------

    def selfmanaged_snap_create(self) -> int:
        with self._ob._dispatch_lock:
            return self.rados.cluster.selfmanaged_snap_create()

    def selfmanaged_snap_remove(self, snap_id: int) -> int:
        with self._ob._dispatch_lock:
            return self.rados.cluster.selfmanaged_snap_remove(snap_id)

    def snap_changed(self, name: str, snap_id: int) -> bool:
        """Fast-diff primitive: head diverged from its state at the
        snap? (metadata-only; ref: librbd fast-diff / object map)"""
        with self._ob._dispatch_lock:
            return self.rados.cluster.snap_changed(name, snap_id)

    # -- watch / notify (rados_watch3/rados_notify2) ------------------------

    def watch(self, name: str, callback) -> int:
        with self._ob._dispatch_lock:
            return self.rados.cluster.watch(name, callback)

    def unwatch(self, name: str, cookie: int) -> None:
        with self._ob._dispatch_lock:
            self.rados.cluster.unwatch(name, cookie)

    def notify(self, name: str, payload: bytes = b"") -> dict:
        with self._ob._dispatch_lock:
            return self.rados.cluster.notify(name, payload)

    # -- object classes (rados_exec) ----------------------------------------

    def execute(self, name: str, cls: str, method: str,
                inp: bytes = b"") -> bytes:
        with self._ob._dispatch_lock:
            return self.rados.cluster.cls_exec(name, cls, method, inp)


class RadosStriper:
    """Client-side striping over rados objects (libradosstriper).

    A logical byte stream `soid` maps to objects `{soid}.{q:016x}`:
    logical offset L lives in stripe-unit su = (L // stripe_unit),
    which round-robins onto object (su % stripe_count) within an
    object set of stripe_count objects; object sets advance every
    stripe_count * object_size logical bytes. Size is tracked in a
    striper metadata object (the striper's size xattr role).
    """

    def __init__(self, ioctx: IoCtx, stripe_unit: int = 1 << 16,
                 stripe_count: int = 4, object_size: int = 1 << 22,
                 full_stripe_writes: bool = False):
        if object_size % stripe_unit:
            raise ValueError("object_size must be a multiple of "
                             "stripe_unit")
        if stripe_count < 1 or stripe_unit < 1:
            raise ValueError("bad striping parameters")
        self.io = ioctx
        self.su = stripe_unit
        self.sc = stripe_count
        self.osz = object_size
        # r20 routing knob: False (default) sends each piece as a
        # range write (write_at -> the r16 parity-delta/append fast
        # path on EC pools); True forces the pre-r16 full-stripe
        # fallback (read-merge-write_full per piece object) — kept as
        # the A/B baseline the bench amplification cells measure
        # against and as an escape hatch.
        self.full_stripe_writes = bool(full_stripe_writes)
        #: soids this instance knows are DENSE (only ever tail-
        #: appended from empty) — the only streams append() may route
        #: through the server-side-offset rados append op; a sparse
        #: write evicts (server tail != expected piece offset there)
        self._dense: set[str] = set()
        # the size/hwm metadata update is a read-modify-write spanning
        # two ops; concurrent aio writers to one striped object could
        # interleave and lose a size extension. RLock: truncate holds
        # it across its own RMW while its zeroing calls write()
        self._meta_locks: dict[str, threading.RLock] = {}
        self._meta_locks_guard = threading.Lock()

    def _meta_lock(self, soid: str) -> threading.RLock:
        with self._meta_locks_guard:
            return self._meta_locks.setdefault(soid, threading.RLock())

    def _obj(self, soid: str, q: int) -> str:
        return f"{soid}.{q:016x}"

    def _meta(self, soid: str) -> str:
        return f"{soid}.meta"

    def _extents(self, offset: int, length: int):
        """Yield (object index, object offset, logical offset, len)
        pieces covering [offset, offset+length)."""
        units_per_set = self.sc * (self.osz // self.su)
        pos = offset
        end = offset + length
        while pos < end:
            su_idx = pos // self.su
            intra = pos % self.su
            take = min(self.su - intra, end - pos)
            obj_set, in_set = divmod(su_idx, units_per_set)
            obj_in_set = in_set % self.sc
            row = in_set // self.sc          # stripe row within the set
            q = obj_set * self.sc + obj_in_set
            ooff = row * self.su + intra
            yield q, ooff, pos, take
            pos += take

    def piece_extents(self, q: int, upto: int):
        """Logical (offset, len) extents mapping to piece object q,
        clamped to [0, upto) — the inverse of the _extents walk. Lives
        here so ONE class owns the striping geometry (RBD clone
        copy-up and diff depend on it)."""
        rows = self.osz // self.su
        units_per_set = self.sc * rows
        obj_set, obj_in_set = divmod(q, self.sc)
        for row in range(rows):
            unit = obj_set * units_per_set + row * self.sc + obj_in_set
            loff = unit * self.su
            if loff >= upto:
                break
            yield loff, min(self.su, upto - loff)

    def _read_meta(self, soid: str,
                   snap: int | None = None) -> tuple[int, int]:
        """(logical size, high-water-mark size). The hwm tracks the
        LARGEST size the stream ever had, so remove() can find pieces
        a later truncate-shrink left behind (zeroed but extant). Old
        8-byte metas (pre-hwm) read back hwm == size."""
        try:
            raw = bytes(self.io.read(self._meta(soid), snap=snap))
        except KeyError:
            raise KeyError(f"no striped object {soid!r}")
        size = int.from_bytes(raw[:8], "little")
        hwm = int.from_bytes(raw[8:16], "little") if len(raw) >= 16 \
            else size
        return size, max(size, hwm)

    def _write_meta(self, soid: str, size: int, hwm: int,
                    snapc: int = 0) -> None:
        self.io.write_full(self._meta(soid),
                           size.to_bytes(8, "little")
                           + hwm.to_bytes(8, "little"), snapc=snapc)

    def size(self, soid: str, snap: int | None = None) -> int:
        return self._read_meta(soid, snap=snap)[0]

    def write(self, soid: str, data: bytes | np.ndarray,
              offset: int = 0, snapc: int = 0) -> None:
        arr = np.frombuffer(bytes(data), dtype=np.uint8) \
            if isinstance(data, (bytes, bytearray, memoryview)) \
            else np.asarray(data, np.uint8).reshape(-1)
        if self.full_stripe_writes:
            self._write_full_stripe(soid, arr, offset, snapc)
        else:
            for q, ooff, lpos, ln in self._extents(offset, len(arr)):
                piece = arr[lpos - offset:lpos - offset + ln]
                self.io.write(self._obj(soid, q), piece, offset=ooff,
                              snapc=snapc)
        with self._meta_lock(soid):
            try:
                cur, hwm = self._read_meta(soid)
            except KeyError:
                cur = hwm = 0
            if offset > cur:
                # a hole opened below the tail: the stream is no
                # longer dense, append() must stop trusting the
                # server-side tail to equal the computed piece offset
                self._dense.discard(soid)
            new = max(cur, offset + len(arr))
            if new != cur:
                self._write_meta(soid, new, max(hwm, new), snapc=snapc)

    def _write_full_stripe(self, soid: str, arr: np.ndarray,
                           offset: int, snapc: int) -> None:
        """The full-stripe fallback: read-merge-write_full every piece
        object the range touches (each rados write re-encodes the
        whole object — the k+m wire fan-out the r16 delta path
        avoids). Kept selectable so the benches can measure the
        amplification win on the SAME workload."""
        by_obj: dict[int, list] = {}
        for q, ooff, lpos, ln in self._extents(offset, len(arr)):
            by_obj.setdefault(q, []).append((ooff, lpos, ln))
        for q in sorted(by_obj):
            name = self._obj(soid, q)
            try:
                cur = np.frombuffer(self.io.read(name),
                                    dtype=np.uint8)
            except KeyError:
                cur = np.zeros(0, dtype=np.uint8)
            need = max(len(cur),
                       max(ooff + ln for ooff, _, ln in by_obj[q]))
            buf = np.zeros(need, dtype=np.uint8)
            buf[:len(cur)] = cur
            for ooff, lpos, ln in by_obj[q]:
                buf[ooff:ooff + ln] = arr[lpos - offset:
                                          lpos - offset + ln]
            self.io.write_full(name, buf, snapc=snapc)

    def append(self, soid: str, data: bytes | np.ndarray,
               snapc: int = 0) -> int:
        """Tail append on the logical stream; returns the offset the
        bytes landed at. DENSE streams (only ever appended from
        empty by this instance) ride the rados append op — the
        primary resolves each piece's tail server-side and the r16
        append-into-padding fast path skips the pre-read. Streams
        with holes (or inherited from elsewhere) take the plain
        write_at path at the same logical offset, which is equally
        correct and still delta-eligible."""
        arr = np.frombuffer(bytes(data), dtype=np.uint8) \
            if isinstance(data, (bytes, bytearray, memoryview)) \
            else np.asarray(data, np.uint8).reshape(-1)
        with self._meta_lock(soid):
            try:
                cur, hwm = self._read_meta(soid)
            except KeyError:
                cur = hwm = 0
            dense = (cur == 0 and hwm == 0) or soid in self._dense
            if dense and not self.full_stripe_writes:
                for q, ooff, lpos, ln in self._extents(cur, len(arr)):
                    piece = arr[lpos - cur:lpos - cur + ln]
                    self.io.append(self._obj(soid, q), piece,
                                   snapc=snapc)
                self._dense.add(soid)
                new = cur + len(arr)
                self._write_meta(soid, new, max(hwm, new),
                                 snapc=snapc)
            else:
                self.write(soid, arr, offset=cur, snapc=snapc)
            return cur

    def read(self, soid: str, length: int | None = None,
             offset: int = 0, snap: int | None = None) -> bytes:
        total = self.size(soid, snap=snap)
        if length is None:
            length = max(0, total - offset)
        length = min(length, max(0, total - offset))
        out = np.zeros(length, dtype=np.uint8)
        if not length:
            return b""
        cache: dict[str, np.ndarray] = {}
        for q, ooff, lpos, ln in self._extents(offset, length):
            name = self._obj(soid, q)
            if name not in cache:
                try:
                    cache[name] = np.frombuffer(
                        self.io.read(name, snap=snap), dtype=np.uint8)
                except KeyError:
                    cache[name] = np.zeros(0, dtype=np.uint8)
            obj = cache[name]
            piece = obj[ooff:ooff + ln]
            out[lpos - offset:lpos - offset + len(piece)] = piece
        return out.tobytes()

    def truncate(self, soid: str, new_size: int,
                 zero_chunk: int = 1 << 20, snapc: int = 0) -> None:
        """Shrink (or grow) the logical stream. A shrink ZEROES the
        discarded range before dropping the size, so a later re-grow
        reads zeros there, not resurrected bytes (the block-device
        contract; the reference trims/zeroes objects)."""
        if new_size < 0:
            raise ValueError(f"truncate to {new_size} < 0")
        self._dense.discard(soid)   # object tails now exceed the
        #                             logical size; append() must
        #                             compute offsets again
        with self._meta_lock(soid):
            old, hwm = self._read_meta(soid)
            if new_size < old:
                pos = new_size
                while pos < old:
                    n = min(zero_chunk, old - pos)
                    self.write(soid, b"\x00" * n, offset=pos,
                               snapc=snapc)
                    pos += n
            self._write_meta(soid, new_size, max(hwm, new_size),
                             snapc=snapc)

    def remove(self, soid: str, snapc: int = 0) -> None:
        # walk to the HIGH-WATER mark, not the current size: a
        # truncate-shrink keeps (zeroed) pieces past the new boundary
        # that a size-bounded walk would leak forever
        _, hwm = self._read_meta(soid)
        qs = {q for q, _, _, _ in self._extents(0, max(hwm, 1))}
        for q in sorted(qs):
            try:
                self.io.remove(self._obj(soid, q), snapc=snapc)
            except KeyError:
                pass  # sparse stripe: unit never written
        self.io.remove(self._meta(soid), snapc=snapc)
        self._dense.discard(soid)
        with self._meta_locks_guard:
            self._meta_locks.pop(soid, None)
