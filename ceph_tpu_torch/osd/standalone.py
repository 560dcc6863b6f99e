"""Standalone cluster — the control plane on REAL wire traffic.

Where SimCluster models the cluster in-process under virtual time,
this module runs it the way the reference's qa/standalone tier does
(ref: qa/standalone/ceph-helpers.sh run_osd/run_mon/wait_for_clean):
N OSD daemons + 3 monitors + clients as independent endpoints on
localhost, every interaction a typed, CRC/AES-GCM-protected frame on
the Messenger — nothing reaches around the wire:

* client I/O:      MOSDOp / MOSDOpReply        (ref: MOSDOp.h)
* shard writes:    MStoreOp / MStoreReply       (the MOSDECSubOpWrite
  role: the PG primary fans per-shard store transactions out to the
  OSDs that own them; reads pull helper shards back the same way)
* liveness:        MOSDPing / MOSDPingReply     (ref: MOSDPing.h)
* failure reports: MOSDFailure -> monitor       (ref: MOSDFailure.h)
* map commits:     MMonCollect / MMonLast / MMonBegin / MMonAcceptPn /
  MMonCommit / MMonNack — multi-phase Paxos with rank-stamped proposal
  numbers (ref: src/mon/Paxos.cc collect/last/begin/accept/commit)
* map fan-out:     MOSDMap epoch + full encoded OSDMap (MOSDMap.h)
* boot:            MOSDBoot                     (ref: MOSDBoot.h)

Key design points, and what they re-validate from the in-process sim:

* The PG backends are the SAME ECBackend/ReplicatedBackend classes —
  unchanged — but their ShardSet hands out RemoteStore proxies, so
  every queue_transaction/read/getattr/exists a backend performs
  becomes a blocking RPC to the OSD that owns the bytes (its own
  shard short-circuits to the local store). The "exactly-once,
  lossless" messenger guarantees are thereby exercised under real
  workload ordering, not just test_msgr's synthetic schedules.
* PG metadata travels WITH the data (the reference's transactions
  carry pg_log entries to every shard): after each write the primary
  persists {object_sizes, versions, pg_log, cursors} as an omap blob
  on every live shard, so a surviving acting member can take over as
  primary from its local copy after the old primary dies.
* Failure detection is emergent: OSDs ping each other in real time,
  report unanswered peers to the monitor leader, the leader commits
  down+out through its quorum and broadcasts the new epoch; primaries
  then recover the lost slot onto the CRUSH replacement — every step
  as frames.
* Op ordering: client ops execute under ONE daemon lock — a TOTAL
  order per primary, a strict superset of the reference's guarantee
  (PrimaryLogPG::execute_ctx orders per object within a PG; ops on
  different objects/PGs may interleave there). Every ordering the
  reference promises holds here by construction; what this tier does
  NOT model is the reference's cross-PG op CONCURRENCY (OSDShard
  queues) — per-PG parallel dispatch is a scaling concern of the
  CPU daemon, deliberately traded away in a tier whose batched data
  plane does its parallelism inside device launches (SURVEY §2.7 P2).

Scope: this tier proves the wire transport under daemon death AND
the monitor control plane on the same wire — rank election over ping
liveness, multi-phase Paxos map commits whose safety holds under
network partitions and dual-leader windows (pn arbitration, not
election correctness — see MonDaemon), leader death, revived-leader
resync (collect doubles as store sync), and injected partitions
(Messenger.set_blocked / StandaloneCluster.partition) all run as
frames. The in-process mon/monitor.py layer remains the synchronous
model used by the sim tier. Secure mode composes: pass secret= to
run the whole cluster over AES-GCM sessions.

Twin of ceph_tpu/osd/standalone.py, line for line apart from the
device's path through it. `StandaloneCluster(device=None)` resolves
`None` to the CUDA device (and raises without one; the tests pass
`"cpu"`) and hands it to every OSDDaemon, MonDaemon and Client. Every
piece of device state is made there: the coder the pool is sized from,
every OSDMap (built or decoded) and its placement, the PG backends
(every encode, RMW parity delta, degraded-read decode, recovery decode
and CRC32C on that device), and the source side of a ranged shard pull.
With `osd_procs=True` each OSD daemon is its own OS process
(osd/multiproc.py) on the cluster's device.
"""

from __future__ import annotations

import struct
import threading
import time

import numpy as np

from ..msgr.messenger import Message, Messenger, register_message
from ..utils.encoding import Decoder, Encoder
from ..utils.flight_recorder import current as _trace_current
from ..utils.flight_recorder import declare_span_names
from .ecbackend import ECBackend, ShardSet, shard_cid
from .memstore import MemStore, Transaction
from .osdmap import (FULL_BACKFILLFULL, FULL_FULL, FULL_NEARFULL,
                     FULL_STATE_NAMES, Incremental, OSDMap, PGPool)
from .pgbackend import ReplicatedBackend
from .pglog import PGLog, divergent_names, share_history
from .tinstore import _decode_txn, _encode_txn, _encode_txn_iov

PG_META_KEY = b"pg_meta"
#: delta-meta omap key (same omap object as PG_META_KEY): entries
#: appended since the last full base blob — see OSDDaemon._meta_extra
PG_META_DELTA_KEY = b"pg_meta_delta"
#: full-base persist cadence: a delta may cover at most this many
#: entries before the next write re-ships the full blob
_META_DELTA_MAX = 32

# every span name this module's hops may record into a flight ring
# (the r9 no-undeclared-names invariant, extended to the trace plane;
# ecbackend's span() sites declare themselves through the same call —
# the observability smoke asserts no ring carries an undeclared name)
declare_span_names(
    "client.op", "client.hedge",
    "osd.queue", "osd.op", "osd.subop", "store.apply",
    "osd.recovery_round",
    "osd.repair_policy", "osd.repair_throttle",
    "msgr.seal",
    "ecbackend.write.encode", "ecbackend.read.decode",
    "ecbackend.recover.stage", "ecbackend.recover.launch",
    "ecbackend.recover.fetch", "ecbackend.recover.writeback",
    "ecbackend.recover.batch",
)


# -- typed frames (0x30 block) ----------------------------------------------

class _Blob(Message):
    """Shared shape: (req_id, ok, kind, payload-bytes). `blob` may be
    one buffer or a segment list (Encoder.segments output): either way
    it is appended BY REFERENCE, so an op body carrying object data
    crosses the encode + framing path without a copy. Decoded messages
    always carry contiguous bytes.

    `trace` (r15) is an OPTIONAL, VERSION-GATED tail field carrying a
    distributed-tracing context (ref: MOSDOp::otel_trace riding the
    message): a frame without one encodes the v1 section BIT-IDENTICAL
    to the pre-r15 wire (pinned by tests/test_msgr_frames.py), a frame
    with one encodes v2/compat-1 — a legacy decoder's finish() skips
    the field, a new decoder reads it only when the writer declared
    v >= 2 AND bytes remain in the section (legacy-sender interop)."""

    def __init__(self, req_id: int, ok: bool = True, kind: str = "",
                 blob=b"", err: str = "", trace=None):
        self.req_id, self.ok = req_id, ok
        self.kind, self.blob, self.err = kind, blob, err
        self.trace = trace           # TraceContext | None

    def encode_payload(self, e: Encoder) -> None:
        if self.trace is None:
            (e.start(1, 1).u64(self.req_id).boolean(self.ok)
             .string(self.kind).blob_ref(self.blob).string(self.err)
             .finish())
            return
        (e.start(2, 1).u64(self.req_id).boolean(self.ok)
         .string(self.kind).blob_ref(self.blob).string(self.err)
         .blob(self.trace.encode()).finish())

    @classmethod
    def decode_payload(cls, d: Decoder) -> "_Blob":
        v = d.start(2)
        m = cls(d.u64(), d.boolean(), d.string(), d.blob(), d.string())
        if v >= 2 and d.remaining_in_section() >= 4:
            raw = d.blob()
            if raw:
                from ..utils.flight_recorder import TraceContext
                m.trace = TraceContext.decode(raw)
        d.finish()
        return m


@register_message
class MStoreOp(_Blob):
    type_id = 0x30


@register_message
class MStoreReply(_Blob):
    type_id = 0x31


@register_message
class MOSDOp(_Blob):
    type_id = 0x32


@register_message
class MOSDOpReply(_Blob):
    type_id = 0x33


@register_message
class MOSDPing(Message):
    type_id = 0x34

    def __init__(self, stamp: float):
        self.stamp = stamp

    def encode_payload(self, e: Encoder) -> None:
        e.start(1, 1).f64(self.stamp).finish()

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MOSDPing":
        d.start(1)
        m = cls(d.f64())
        d.finish()
        return m


@register_message
class MOSDPingReply(MOSDPing):
    type_id = 0x35


@register_message
class MOSDFailure(Message):
    """A failure report — or its CANCELLATION when `alive` (ref:
    MOSDFailure FLAG_ALIVE: the reporter heard the peer again and
    retracts; without retraction a transient stall's stale report
    could later combine with one more false report into a spurious
    down-mark)."""

    type_id = 0x36

    def __init__(self, failed: int, alive: bool = False):
        self.failed = failed
        self.alive = alive

    def encode_payload(self, e: Encoder) -> None:
        e.start(2, 1).i32(self.failed).boolean(self.alive).finish()

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MOSDFailure":
        v = d.start(2)
        m = cls(d.i32(), d.boolean() if v >= 2 else False)
        d.finish()
        return m


@register_message
class MOSDBoot(MOSDFailure):
    type_id = 0x37          # payload: the booting osd id


@register_message
class MOSDAlive(Message):
    """up_thru request (ref: MOSDAlive -> OSDMonitor::prepare_alive):
    `osd` asks the monitors to record that it is up through map epoch
    `want` — the activation proof its fresh primary intervals need
    before they may serve I/O (PeeringState WaitUpThru)."""

    type_id = 0x48

    def __init__(self, osd: int, want: int):
        self.osd, self.want = osd, want

    def encode_payload(self, e: Encoder) -> None:
        e.start(1, 1).i32(self.osd).u64(self.want).finish()

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MOSDAlive":
        d.start(1)
        m = cls(d.i32(), d.u64())
        d.finish()
        return m


@register_message
class MMonPropose(Message):
    type_id = 0x38

    def __init__(self, epoch: int, map_bytes: bytes):
        self.epoch, self.map_bytes = epoch, map_bytes

    def encode_payload(self, e: Encoder) -> None:
        e.start(1, 1).u32(self.epoch).blob(self.map_bytes).finish()

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMonPropose":
        d.start(1)
        m = cls(d.u32(), d.blob())
        d.finish()
        return m


@register_message
class MMonAccept(Message):
    type_id = 0x39

    def __init__(self, epoch: int):
        self.epoch = epoch

    def encode_payload(self, e: Encoder) -> None:
        e.start(1, 1).u32(self.epoch).finish()

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMonAccept":
        d.start(1)
        m = cls(d.u32())
        d.finish()
        return m


@register_message
class MOSDMapMsg(MMonPropose):
    type_id = 0x3A          # same shape: epoch + encoded map


@register_message
class MOSDIncMapMsg(MMonPropose):
    """Incremental map fan-out (ref: MOSDMap carrying incremental_maps
    instead of maps): epoch + encoded OSDMap.Incremental whose
    base_epoch rides inside. Subscribers that can't chain it (gap,
    fresh boot) ask for a full map with MOSDMapRequest."""
    type_id = 0x4C


@register_message
class MOSDMapRequest(MMonAccept):
    """Subscriber -> monitor full-map request (the on-request half of
    the full-map-every-Nth-epoch cadence): payload is the requester's
    current epoch; any monitor answers with its committed full map."""
    type_id = 0x4D


@register_message
class MMonSyncReq(MMonAccept):
    type_id = 0x3B          # payload: requester's current epoch


# Multi-phase Paxos frames (ref: src/mon/Paxos.cc collect/last/begin/
# accept/commit; OP_COLLECT..OP_COMMIT in Paxos.h). Proposal numbers
# are rank-stamped (pn = n*256 + rank) so they are globally unique and
# totally ordered across proposers.

@register_message
class MMonCollect(Message):
    type_id = 0x3C

    def __init__(self, pn: int):
        self.pn = pn

    def encode_payload(self, e: Encoder) -> None:
        e.start(1, 1).u64(self.pn).finish()

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMonCollect":
        d.start(1)
        m = cls(d.u64())
        d.finish()
        return m


@register_message
class MMonLast(Message):
    """Peon's collect reply: its promise for `pn`, any accepted-but-
    uncommitted value, and its committed map (epoch 0 = none) so a
    stale or fresh leader catches up from the quorum it gathers."""

    type_id = 0x3D

    def __init__(self, pn: int, accepted_pn: int, accepted_epoch: int,
                 accepted_blob: bytes, committed_epoch: int,
                 committed_blob: bytes):
        self.pn = pn
        self.accepted_pn = accepted_pn
        self.accepted_epoch = accepted_epoch
        self.accepted_blob = accepted_blob
        self.committed_epoch = committed_epoch
        self.committed_blob = committed_blob

    def encode_payload(self, e: Encoder) -> None:
        (e.start(1, 1).u64(self.pn).u64(self.accepted_pn)
         .u32(self.accepted_epoch).blob(self.accepted_blob)
         .u32(self.committed_epoch).blob(self.committed_blob).finish())

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMonLast":
        d.start(1)
        m = cls(d.u64(), d.u64(), d.u32(), d.blob(), d.u32(), d.blob())
        d.finish()
        return m


@register_message
class MMonBegin(Message):
    type_id = 0x3E

    def __init__(self, pn: int, epoch: int, map_bytes: bytes):
        self.pn, self.epoch, self.map_bytes = pn, epoch, map_bytes

    def encode_payload(self, e: Encoder) -> None:
        (e.start(1, 1).u64(self.pn).u32(self.epoch)
         .blob(self.map_bytes).finish())

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMonBegin":
        d.start(1)
        m = cls(d.u64(), d.u32(), d.blob())
        d.finish()
        return m


@register_message
class MMonAcceptPn(Message):
    type_id = 0x3F

    def __init__(self, pn: int, epoch: int):
        self.pn, self.epoch = pn, epoch

    def encode_payload(self, e: Encoder) -> None:
        e.start(1, 1).u64(self.pn).u32(self.epoch).finish()

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMonAcceptPn":
        d.start(1)
        m = cls(d.u64(), d.u32())
        d.finish()
        return m


@register_message
class MMonCommit(MMonPropose):
    type_id = 0x40          # same shape: epoch + encoded map


@register_message
class MMonNack(Message):
    """Refusal carrying the REFUSED pn, the refuser's promise and its
    committed state: the rejected proposer adopts the committed map
    and, if the nack is for its CURRENT round (stale replayed nacks
    must not abort a later healthy round), abandons and re-collects
    at a higher pn (the Paxos 'learn you lost' path)."""

    type_id = 0x41

    def __init__(self, nacked: int, promised: int, committed_epoch: int,
                 committed_blob: bytes):
        self.nacked = nacked
        self.promised = promised
        self.committed_epoch = committed_epoch
        self.committed_blob = committed_blob

    def encode_payload(self, e: Encoder) -> None:
        (e.start(1, 1).u64(self.nacked).u64(self.promised)
         .u32(self.committed_epoch).blob(self.committed_blob).finish())

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMonNack":
        d.start(1)
        m = cls(d.u64(), d.u64(), d.u32(), d.blob())
        d.finish()
        return m


@register_message
class MPoolOp(Message):
    """Client pool mutation — mksnap/rmsnap by NAME (ref: MPoolOp.h,
    OSDMonitor::prepare_pool_op). Broadcast to every monitor like
    MOSDBoot; name-idempotence makes the queue-everywhere pattern
    commit exactly one snap. The client observes the result through
    its map subscription (pg_pool_t.snaps rides the OSDMap)."""

    type_id = 0x42

    def __init__(self, kind: str, snap_name: str):
        self.kind, self.snap_name = kind, snap_name

    def encode_payload(self, e: Encoder) -> None:
        e.start(1, 1).string(self.kind).string(self.snap_name).finish()

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MPoolOp":
        d.start(1)
        m = cls(d.string(), d.string())
        d.finish()
        return m


@register_message
class MPoolQuotaOp(Message):
    """`ceph osd pool set-quota` over the wire (r21, ref: OSDMonitor
    prepare_command POOL_SET quota_max_bytes/objects): quotas ride
    the committed map like every pool attribute, so the capacity
    ladder's quota evaluation reads from Paxos state, never from a
    side channel. Broadcast to every monitor; value-idempotent."""

    type_id = 0x4E

    def __init__(self, pool_id: int, max_bytes: int, max_objects: int):
        self.pool_id = pool_id
        self.max_bytes, self.max_objects = max_bytes, max_objects

    def encode_payload(self, e: Encoder) -> None:
        (e.start(1, 1).u32(self.pool_id).u64(self.max_bytes)
         .u64(self.max_objects).finish())

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MPoolQuotaOp":
        d.start(1)
        m = cls(d.u32(), d.u64(), d.u64())
        d.finish()
        return m


@register_message
class MConfigOp(Message):
    """Centralized config mutation — `ceph config set/rm` (ref:
    MMonCommand routed to ConfigMonitor::prepare_command). Broadcast
    to every monitor like MPoolOp; value-idempotence (OSDMap.config_set
    bumps nothing when unchanged) makes queue-everywhere commit exactly
    one change. Daemons observe it through their map subscription and
    apply it at their config's "mon" layer."""

    type_id = 0x43

    def __init__(self, kind: str, key: str, value: str = ""):
        self.kind, self.key, self.value = kind, key, value

    def encode_payload(self, e: Encoder) -> None:
        e.start(1, 1).string(self.kind).string(self.key) \
            .string(self.value).finish()

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MConfigOp":
        d.start(1)
        m = cls(d.string(), d.string(), d.string())
        d.finish()
        return m


def _daemon_authorize(verifier, req: dict, peer: str, req_id: int,
                      authed: dict, export_fn) -> "MAuthReply":
    """Shared daemon-side MAuthOp('authorize') handling (OSDs and
    monitors): run the challenge round, auto-refresh rotating secrets
    once when the presented secret_id is newer than this daemon's
    window (the fetch-from-mon-on-newer-sid behavior), bind the
    session on success."""
    import json as _json

    from ..auth import AuthError, NeedChallenge

    def _try() -> "MAuthReply":
        got = verifier.verify(req, peer=peer)
        authed[peer] = {"entity": got["entity"], "caps": got["caps"]}
        return MAuthReply(req_id, True, "authorize",
                          _json.dumps({"reply_mac":
                                       got["reply_mac"].hex()})
                          .encode())
    try:
        try:
            return _try()
        except NeedChallenge:
            raise
        except AuthError as e:
            if "rotated out" in str(e):
                verifier.refresh(export_fn())
                return _try()
            raise
    except NeedChallenge as nc:
        return MAuthReply(req_id, False, "authorize",
                          err=f"EAGAIN:challenge:{nc.challenge}")
    except Exception as e:   # noqa: BLE001 — reply, don't die
        return MAuthReply(req_id, False, "authorize",
                          err=f"{type(e).__name__}:{e}")


@register_message
class MMonJoin(Message):
    """Monitor membership change request (ref: MMonJoin.h; `ceph mon
    add/remove`): rank + direction. Queued like any map mutation;
    the leader commits it through Paxos, so quorum math changes
    atomically with the committed map."""

    type_id = 0x46

    def __init__(self, rank: int, join: bool):
        self.rank, self.join = rank, join

    def encode_payload(self, e: Encoder) -> None:
        e.start(1, 1).i32(self.rank).boolean(self.join).finish()

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMonJoin":
        d.start(1)
        m = cls(d.i32(), d.boolean())
        d.finish()
        return m


@register_message
class MOsdAdmin(Message):
    """`ceph osd out/in/reweight` over the wire (ref: OSDMonitor
    prepare_command OSD_OUT/OSD_IN/OSD_REWEIGHT): admin-plane
    broadcast, quorum-committed like pool/config ops. weight is
    16.16 fixed-point over 0x10000 (the reference's convention)."""

    type_id = 0x47

    def __init__(self, kind: str, osd: int, weight: float = 1.0):
        if not 0.0 <= weight <= 1.0:
            # the reference clamps reweight to [0,1]; refusing at
            # construction beats a struct.error deep in the codec
            raise ValueError(f"osd weight {weight} outside [0, 1]")
        self.kind, self.osd, self.weight = kind, osd, weight

    def encode_payload(self, e: Encoder) -> None:
        (e.start(1, 1).string(self.kind).i32(self.osd)
         .u32(int(self.weight * 0x10000)).finish())

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MOsdAdmin":
        d.start(1)
        m = cls(d.string(), d.i32(), d.u32() / 0x10000)
        d.finish()
        return m


@register_message
class MAuthOp(_Blob):
    """cephx traffic (ref: MAuth/MAuthReply): kind selects the auth
    method (hello / authenticate / tickets against a monitor;
    authorize against an OSD); blob is the JSON request with byte
    fields hex-armored."""
    type_id = 0x44


@register_message
class MAuthReply(_Blob):
    type_id = 0x45


@register_message
class MMgrReport(_Blob):
    """Daemon -> monitor stats report (ref: MMgrReport.h): kind is
    "full" or "delta", blob is the JSON report the MgrReportAggregator
    ingests (perf dump/delta + op stats + primary-claimed PG states).
    Broadcast to every monitor fire-and-forget; each folds its own
    aggregate, so any monitor can answer `ceph status`."""

    type_id = 0x49


@register_message
class MMonCmd(_Blob):
    """Read-only monitor command (the MMonCommand slice observability
    needs): kind names the command (status / health / health detail /
    prometheus / perf dump / report dump); the reply blob is JSON."""

    type_id = 0x4A


@register_message
class MMonCmdReply(_Blob):
    type_id = 0x4B


# -- request/reply plumbing --------------------------------------------------

class _PendingCall:
    """One in-flight rpc: event + slot accounting. wait() returns the
    reply or raises ConnectionError on timeout — exactly call()'s
    contract, split so callers can have MANY of these on the wire."""

    __slots__ = ("_rpc", "rid", "peer", "nbytes", "_ev", "_replies",
                 "_released", "_waiters")

    def __init__(self, rpc: "_Rpc", rid: int, peer: str, nbytes: int):
        self._rpc = rpc
        self.rid, self.peer, self.nbytes = rid, peer, nbytes
        self._ev = threading.Event()
        self._replies: list = []
        self._released = False
        self._waiters: list[threading.Event] = []

    def wait(self, timeout: float = 10.0):
        try:
            if not self._ev.wait(timeout):
                self._rpc.perf.inc("op_timeout")
                raise ConnectionError(f"rpc to {self.peer} timed out")
            rep = self._replies[0]
            if isinstance(rep, BaseException):
                raise rep
            return rep
        finally:
            self._rpc._retire(self)

    # -- hedged-read surface: wait-any without retiring -----------------------

    def ready(self, timeout: float | None = 0.0) -> bool:
        """Reply (or transport error) arrived? Unlike wait(), does NOT
        retire the handle — the hedging client polls many handles and
        claims only the winner."""
        return self._ev.wait(timeout)

    def take(self):
        """Claim a ready() handle: the reply, or raises its transport
        error. Retires exactly like wait() — call once."""
        try:
            rep = self._replies[0]
            if isinstance(rep, BaseException):
                raise rep
            return rep
        finally:
            self._rpc._retire(self)

    def cancel(self) -> None:
        """Abandon the op: frees the window slot NOW and drops any
        late reply on the floor (_on_reply pops the table entry, so a
        straggler reply no longer matches). The hedging client's
        loser-cancellation path; retiring twice is a no-op, so a
        cancel racing the reply is safe either way."""
        self._rpc._retire(self)

    def add_waiter(self, ev: threading.Event) -> None:
        """Signal `ev` (too) on completion — the wait-any primitive the
        hedge loop blocks on instead of polling."""
        self._waiters.append(ev)
        if self._ev.is_set():   # completion raced the registration
            ev.set()

    def _notify(self) -> None:
        self._ev.set()
        for ev in self._waiters:
            ev.set()

    def fail(self, err: BaseException) -> None:
        self._replies.append(err)
        self._notify()


class _Rpc:
    """Request/reply over the messenger: correlation ids + per-request
    events; reply handlers route by req_id, so completions match OUT
    OF ORDER. submit() opens a windowed in-flight op (the Objecter's
    seq-tagged pipeline role); call() is submit()+wait() — one op per
    round trip, the pre-window behavior.

    The window (ops cap + byte budget) bounds how much a caller may
    pipeline: submit() BLOCKS while the window is full (backpressure,
    the objecter_inflight_op_bytes role) and a completion — in any
    order — frees its slot. window=0 disables the cap (daemon-internal
    rpc must never backpressure dispatch threads against each other)."""

    def __init__(self, msgr: Messenger, reply_type: int,
                 window: int = 0, window_bytes: int = 0):
        from ..utils.perf_counters import PerfCountersBuilder
        self.msgr = msgr
        self._lock = threading.Lock()
        self._next = 1
        self._pending: dict[int, _PendingCall] = {}
        self.window = int(window)
        self.window_bytes = int(window_bytes)
        self._win = threading.Condition(self._lock)
        self._inflight = 0
        self._inflight_bytes = 0
        # op-window observability (the objecter_ops / objecter_bytes
        # counters the reference's Objecter logger carries): occupancy
        # gauges, submit/reply counters, and the backpressure stall
        # time a full window cost submitters
        self.perf = (PerfCountersBuilder("rpc")
                     .add_u64_counter("op_send", "ops submitted")
                     .add_u64_counter("op_reply", "replies matched")
                     .add_u64_counter("op_timeout", "waits timed out")
                     .add_u64_counter("op_send_bytes",
                                      "payload bytes submitted")
                     .add_u64_counter("window_stalls",
                                      "submits that blocked on a "
                                      "full window")
                     .add_u64("inflight_ops", "ops on the wire now")
                     .add_u64("inflight_bytes",
                              "payload bytes on the wire now")
                     .add_time_avg("window_stall_time",
                                   "backpressure wait per stalled "
                                   "submit")
                     .create_perf_counters())
        msgr.register_handler(reply_type, self._on_reply)

    def _on_reply(self, peer: str, msg) -> None:
        with self._lock:
            # pop, not get: an abandoned handle (caller gave up before
            # the late reply landed) must not leak its table entry
            ent = self._pending.pop(msg.req_id, None)
            if ent is not None:
                # the slot frees the moment the ack arrives (not when
                # the waiter gets scheduled): the window refills at
                # wire speed even with a slow consumer
                self._release_locked(ent)
        if ent is not None:
            self.perf.inc("op_reply")
            ent._replies.append(msg)
            ent._notify()

    def _release_locked(self, ent: _PendingCall) -> None:
        if ent._released:
            return
        ent._released = True
        self._inflight -= 1
        self._inflight_bytes -= ent.nbytes
        self.perf.set("inflight_ops", self._inflight)
        self.perf.set("inflight_bytes", self._inflight_bytes)
        self._win.notify_all()

    def _retire(self, ent: _PendingCall) -> None:
        with self._lock:
            self._pending.pop(ent.rid, None)
            self._release_locked(ent)

    def submit(self, peer: str, make_msg,
               nbytes: int = 0) -> _PendingCall:
        """make_msg(req_id) -> Message. Transmits and returns the
        pending handle immediately (blocking first while the window is
        full). The reply — or a transport error — is delivered through
        handle.wait()."""
        with self._lock:
            if self.window:
                t0 = None
                while (self._inflight >= self.window
                       or (self.window_bytes and self._inflight
                           and self._inflight_bytes + nbytes
                           > self.window_bytes)):
                    if t0 is None:
                        t0 = time.perf_counter()
                    self._win.wait()
                if t0 is not None:
                    # backpressure accounting: how long a full window
                    # held this submitter (the stall the r8 bench
                    # could only guess at)
                    self.perf.inc("window_stalls")
                    self.perf.tinc("window_stall_time",
                                   time.perf_counter() - t0)
            rid = self._next
            self._next += 1
            ent = _PendingCall(self, rid, peer, nbytes)
            self._pending[rid] = ent
            self._inflight += 1
            self._inflight_bytes += nbytes
            self.perf.inc_many((("op_send", 1),
                                ("op_send_bytes", nbytes)))
            self.perf.set("inflight_ops", self._inflight)
            self.perf.set("inflight_bytes", self._inflight_bytes)
        try:
            self.msgr.send(peer, make_msg(rid))
        except KeyError:
            # unknown endpoint (peer not wired yet / torn down):
            # a TRANSPORT failure, never to be confused with an
            # application-level KeyError reply ("no such omap
            # key") — peering quorum counts only peers that
            # actually ANSWERED
            self._retire(ent)
            ent.fail(ConnectionError(
                f"rpc to {peer}: endpoint unknown"))
        except (OSError, ConnectionError) as e:
            # the lossless messenger queues + replays on reconnect, so
            # most transport errors never surface here; a hard refusal
            # (partition injection) does — fail the handle, not the
            # batch
            self._retire(ent)
            ent.fail(ConnectionError(f"rpc to {peer}: {e}"))
        return ent

    def call(self, peer: str, make_msg, timeout: float = 10.0):
        """make_msg(req_id) -> Message. Returns the reply or raises
        ConnectionError on timeout (the caller treats the peer as
        suspect — the OSD op timeout role)."""
        return self.submit(peer, make_msg).wait(timeout)


class _AsyncStoreOp:
    """In-flight MStoreOp with the same error surface as
    RemoteStore._call: result() maps the reply like the sync path,
    including the one cephx re-authorize retry on a cold session."""

    def __init__(self, rs: "RemoteStore", kind: str, body: bytes):
        self._rs, self._kind, self._body = rs, kind, body
        self._pending = rs._submit(kind, body)

    def result(self) -> bytes:
        rs = self._rs
        rep = self._pending.wait(rs._timeout)
        if not rep.ok and rep.err == "EPERM:unauthenticated" \
                and rs._authorize is not None:
            # first store op to this peer since (re)boot: run the
            # osd->osd cephx round, then retry once
            rs._authorize(rs._peer)
            rep = rs._submit(self._kind, self._body).wait(rs._timeout)
        if rep.ok:
            return rep.blob
        if rep.err.startswith("KeyError"):
            raise KeyError(rep.err[9:] or rep.err)
        raise ConnectionError(f"store op {self._kind} on {rs._peer}: "
                              f"{rep.err}")


class _ReadvOp:
    """In-flight readv: result() -> (data bytes, attrs list | None),
    with _AsyncStoreOp's error surface (incl. the one cephx
    re-authorize retry)."""

    def __init__(self, rs: "RemoteStore", body: bytes, want_attrs: bool):
        self._op = _AsyncStoreOp(rs, "readv", body)
        self._want_attrs = want_attrs

    def result(self) -> tuple[bytes, list[bytes] | None]:
        d = Decoder(self._op.result())
        data = d.blob()
        attrs = d.list(Decoder.blob)
        return data, (attrs if self._want_attrs else None)


class _ReadvRangesOp:
    """In-flight ranged readv (the sub-chunk pull frame): result() ->
    (data bytes, range CRC list | None, source-flagged bad row
    indices), same error surface as _AsyncStoreOp."""

    def __init__(self, rs: "RemoteStore", body: bytes, want_crcs: bool):
        self._op = _AsyncStoreOp(rs, "readv_ranges", body)
        self._want_crcs = want_crcs

    def result(self) -> tuple[bytes, list[int] | None, list[int]]:
        d = Decoder(self._op.result())
        data = d.blob()
        crcs = d.list(Decoder.u32)
        bad = d.list(Decoder.u32)
        return data, (crcs if self._want_crcs else None), bad


class _RmwFetchOp:
    """In-flight combined RMW prepare fetch: result() -> per item
    (attr_present, attr bytes, [range bytes]), same error surface as
    _AsyncStoreOp (incl. the one cephx re-authorize retry)."""

    def __init__(self, rs: "RemoteStore", body: bytes):
        self._op = _AsyncStoreOp(rs, "rmw_fetch", body)

    def result(self) -> list[tuple[bool, bytes, list[bytes]]]:
        d = Decoder(self._op.result())
        return d.list(lambda dd: (dd.boolean(), dd.blob(),
                                  dd.list(Decoder.blob)))


class RemoteStore:
    """ObjectStore proxy: the MOSDECSubOpWrite/Read role. Every method
    is one MStoreOp frame to the OSD owning the physical store."""

    path = None

    def __init__(self, rpc: _Rpc, peer: str, timeout: float = 10.0,
                 authorize=None, on_latency=None):
        self._rpc = rpc
        self._peer = peer
        self._timeout = timeout
        self._authorize = authorize   # cephx: establish session, retry
        # on_latency(peer, seconds): per-reply round-trip report — the
        # owning daemon folds it into its peer-latency EWMA, which the
        # repair planner consumes as per-helper read costs
        self._on_latency = on_latency

    def _submit(self, kind: str, body):
        # trace propagation (r15/r18): whatever context is active on
        # THIS thread (a client op mid-fan-out, a recovery round
        # mid-pull) rides the sub-op frame. Sampled contexts make the
        # helper's spans land under the same trace eagerly; since r18
        # an UNSAMPLED context travels too (17 bytes) so the serving
        # hop can remember its window in the sub-op retro ring — what
        # lets a later slow-op retro assembly cover replicas instead
        # of reporting their time as wire. Absent context costs one
        # contextvar read and zero wire bytes.
        ctx = _trace_current()
        return self._rpc.submit(
            self._peer,
            lambda rid: MStoreOp(rid, True, kind, body, trace=ctx))

    def _call(self, kind: str, body: bytes = b"") -> bytes:
        for attempt in range(2):
            t0 = time.perf_counter()
            rep = self._submit(kind, body).wait(self._timeout)
            if self._on_latency is not None:
                self._on_latency(self._peer,
                                 time.perf_counter() - t0)
            if rep.ok:
                return rep.blob
            if (rep.err == "EPERM:unauthenticated"
                    and self._authorize is not None and attempt == 0):
                # first store op to this peer since (re)boot: run the
                # osd->osd cephx round, then retry once
                self._authorize(self._peer)
                continue
            break
        if rep.err.startswith("KeyError"):
            raise KeyError(rep.err[9:] or rep.err)
        raise ConnectionError(f"store op {kind} on {self._peer}: "
                              f"{rep.err}")

    @staticmethod
    def _co(cid: str, oid: str = "", extra=None) -> bytes:
        e = Encoder()
        e.string(cid).string(oid)
        if extra is not None:
            extra(e)
        return e.bytes()

    def queue_transaction(self, txn: Transaction) -> None:
        self._call("txn", _encode_txn_iov(txn))

    def queue_transaction_async(self, txn: Transaction):
        """Pipelined txn: transmit now, ack later. Returns a handle
        whose .result() blocks until the peer committed (same
        durability point as the sync path — callers wait ALL handles
        before acking upward) and raises exactly what queue_transaction
        would. The PG fan-out uses this so n shard sub-ops cost one
        overlapped round trip instead of n sequential ones (the
        reference's parallel MOSDECSubOpWrite dispatch)."""
        return _AsyncStoreOp(self, "txn", _encode_txn_iov(txn))

    def read(self, cid: str, oid: str, offset: int = 0,
             length: int | None = None) -> np.ndarray:
        body = self._co(cid, oid, lambda e: e.i64(offset)
                        .i64(-1 if length is None else length))
        return np.frombuffer(self._call("read", body), np.uint8).copy()

    def readv_submit(self, cid: str, oids: list[str], length: int,
                     attr_key: str | None = None) -> "_ReadvOp":
        """Pipelined multi-object fetch: ONE readv frame carries every
        row (+ optional per-row attr) for `oids`; transmit now, collect
        later. The recovery runner submits one of these per (PG,
        helper shard) before awaiting any — pulls from different
        source OSDs overlap (the windowed PULL)."""
        body = self._co(cid, "", lambda e: e.string(attr_key or "")
                        .i64(length).list(list(oids), Encoder.string))
        return _ReadvOp(self, body, attr_key is not None)

    def readv_ranges_submit(self, cid: str, oids: list[str],
                            length: int, ranges,
                            attr_key: str | None = None
                            ) -> "_ReadvRangesOp":
        """Pipelined sub-chunk fetch (the repair-locality planner's
        wire frame): ONE frame names the (offset, length) ranges every
        row ships — the helper moves only the planned bytes. With
        `attr_key` the SOURCE verifies each full shard against its
        stored hinfo (rot detection stays intact without the receiver
        ever seeing the whole row) and ships per-row crc32c over the
        planned bytes for the receiver's fold verify."""
        body = self._co(cid, "", lambda e: e.string(attr_key or "")
                        .i64(length)
                        .list([(int(o), int(ln)) for o, ln in ranges],
                              lambda en, r: en.i64(r[0]).i64(r[1]))
                        .list(list(oids), Encoder.string))
        return _ReadvRangesOp(self, body, attr_key is not None)

    def rmw_fetch_submit(self, cid: str, attr_key: str,
                         items) -> "_RmwFetchOp":
        """Pipelined combined RMW prepare fetch (r17): ONE frame per
        participant shard carries, for every delta job in the wave,
        the hinfo attr probe AND the touched pre-image sub-ranges —
        collapsing the 1+m tiny sequential getattrs plus per-span
        pre-reads that used to precede every partial-stripe fan-out
        into one overlapped round trip per shard.
        items: [(name, [(off, len), ...])] — ranges may be empty
        (attr-only probe: parity shards and growth participants)."""
        def enc(e: Encoder) -> None:
            e.string(attr_key)
            e.list(list(items), lambda en, it: (
                en.string(it[0])
                .list([(int(o), int(ln)) for o, ln in it[1]],
                      lambda e2, r: e2.i64(r[0]).i64(r[1]))))
        return _RmwFetchOp(self, self._co(cid, "", enc))

    def stat(self, cid: str, oid: str) -> int:
        return Decoder(self._call("stat", self._co(cid, oid))).i64()

    def getattr(self, cid: str, oid: str, key: str) -> bytes:
        return self._call(
            "getattr", self._co(cid, oid, lambda e: e.string(key)))

    def exists(self, cid: str, oid: str) -> bool:
        return bool(self._call("exists", self._co(cid, oid))[0])

    def exists_submit(self, cid: str, oid: str) -> "_AsyncStoreOp":
        """Pipelined existence probe: transmit now, collect later —
        the stripe-journal replay scan probes every shard in ONE
        overlapped round trip instead of n sequential ones."""
        return _AsyncStoreOp(self, "exists", self._co(cid, oid))

    def list_objects(self, cid: str) -> list[str]:
        d = Decoder(self._call("ls", self._co(cid)))
        return d.list(Decoder.string)

    def omap_get(self, cid: str, oid: str, key: bytes) -> bytes:
        return self._call(
            "omap_get", self._co(cid, oid, lambda e: e.blob(key)))

    def omap_iter(self, cid: str, oid: str,
                  start_after: bytes | None = None,
                  limit: int | None = None) -> list[tuple[bytes, bytes]]:
        """Ordered omap page — the stripe-journal replay scan's frame
        (one page per call, same contract as the local stores)."""
        body = self._co(cid, oid, lambda e: e
                        .boolean(start_after is not None)
                        .blob(start_after or b"")
                        .i64(-1 if limit is None else int(limit)))
        d = Decoder(self._call("omap_iter", body))
        return d.list(lambda dd: (dd.blob(), dd.blob()))


# -- daemons -----------------------------------------------------------------

class _PgClsView:
    """SimCluster-shaped facade over ONE PG at its primary so object
    classes (objclass.py ClsHandle) run unchanged at the wire tier
    (ref: PrimaryLogPG::do_osd_ops OP_CALL — the method executes at
    the object's primary; its writes ride the normal fan-out path,
    COW and PG log included)."""

    def __init__(self, daemon: "OSDDaemon", ps: int, be):
        self._d, self._ps, self._be = daemon, ps, be
        self.pgs = {ps: be}

    def locate(self, name: str) -> int:
        return self._ps

    def read(self, name: str):
        return self._be.read_object(
            name, dead_osds=set(self._d.suspect))

    def write(self, objects: dict) -> None:
        d = self._d
        d._snap_guard(self._ps, self._be, objects)
        self._be.write_objects(
            {k: bytes(np.asarray(v, np.uint8).tobytes())
             if not isinstance(v, (bytes, bytearray)) else bytes(v)
             for k, v in objects.items()},
            dead_osds=set(d.suspect))
        # the cls branch of _client_op persists once after cls_call

    def remove(self, names) -> None:
        names = [names] if isinstance(names, str) else list(names)
        self._d._delete_objects(self._ps, self._be, names)

    @property
    def obj_kv(self) -> dict:
        return self._d.obj_kv.setdefault(self._ps, {})


class _RecoveryRound:
    """One mClock-governed pass of the cross-PG recovery runner: every
    grant executes ONE fused batch under the daemon lock then yields
    (re-enqueues itself, after osd_recovery_sleep), so client ops
    interleave between batches instead of waiting out the whole
    rebuild. The runner's push window is sized by the recovery
    reservation knobs: osd_recovery_max_active in-flight pushes,
    osd_recovery_max_active * osd_recovery_max_chunk bytes."""

    def __init__(self, daemon: "OSDDaemon", entries):
        from .ecbackend import RecoveryRunner
        self.d = daemon
        self.entries = entries            # [(ps, plan, dead osd ids)]
        self.plans = {ps: plan for ps, plan, _ in entries}
        self.dead: set[int] = set()
        for _ps, _plan, dead in entries:
            self.dead |= dead
        cfg = daemon.config
        max_active = int(cfg["osd_recovery_max_active"])
        # r17: the integrity mode resolves through config (auto keeps
        # the pre-r17 native-detect; 'device' forces the fused
        # decode+fold on-device; 'host' asserts the native crc path
        # when the lib is present — the storm bench verifies rebuilt
        # bytes against the full-decode oracle in both modes)
        from .ecbackend import _host_crc_available
        integ = str(cfg["osd_recovery_integrity"]).lower()
        host_crc = (False if integ == "device"
                    else True if integ == "host"
                    and _host_crc_available(daemon.device) else None)
        self.runner = RecoveryRunner(
            [plan for _ps, plan, _dead in entries],
            batch=int(cfg["osd_recovery_batch"]),
            perf=daemon.ec_perf,
            push_window_ops=max_active,
            push_window_bytes=max_active
            * int(cfg["osd_recovery_max_chunk"]),
            host_crc=host_crc)
        self.failed = False
        # r15: recovery rounds get their own sampled trace context
        # (rate-gated) — every fused batch then records its stage/
        # launch/fetch/writeback spans, and the readv/readv_ranges
        # helper pulls carry the context to their sources, whose
        # osd.subop spans land under the same trace.
        from ..utils.flight_recorder import (TraceContext, coin,
                                             new_trace_id)
        self.trace_ctx = None
        try:
            rate = float(cfg["osd_trace_recovery_sample_rate"])
        except (KeyError, ValueError):
            rate = 0.0
        if coin(rate):
            self.trace_ctx = TraceContext(new_trace_id(), 0,
                                          sampled=True)

    def lost_of(self, ps: int) -> list[int]:
        return self.plans[ps].lost

    def shard(self):
        """All of a round's grants ride ONE op shard (the lowest
        member PG's) so a client op waits behind at most one batch of
        its own shard; other shards never see the round."""
        return self.d._shard_of(min(self.plans))

    def next_cost(self) -> float:
        """One grant's work in client-op cost units (bytes-scaled, the
        osd_mclock_cost_per_byte role)."""
        return max(1.0, self.runner.next_cost()
                   / float(self.d.config["osd_recovery_max_chunk"]))

    def __call__(self) -> None:
        # each grant executes one fused batch under the round's trace
        # context (if sampled): the stage/launch/fetch/writeback spans
        # and the helper pulls' osd.subop spans all land in one trace
        from ..utils.flight_recorder import activate, trace_span
        with activate(self.trace_ctx,
                      self.d.flight if self.trace_ctx is not None
                      else None):
            with trace_span("osd.recovery_round",
                            pgs=sorted(self.plans)):
                self._grant()

    def _domain_throttle(self) -> float:
        """r17 per-failure-domain repair budget: the next batch's
        helper bytes draw from token buckets keyed by each helper's
        CRUSH rack. Returns 0.0 (granted) or the seconds to defer —
        the grant re-queues instead of executing, so enforcement rides
        the existing mClock background_recovery path and one rack's
        burst cannot saturate another rack's uplinks. Budgets resolve
        through config at every grant (live retune)."""
        d = self.d
        mbps = float(d.config["osd_repair_domain_budget_mbps"])
        if mbps <= 0 or d.osdmap is None:
            return 0.0
        helpers = self.runner.next_helper_osds()
        if not helpers:
            return 0.0
        nbytes = float(self.runner.next_cost())
        crush = d.osdmap.crush
        share = nbytes / len(helpers)
        domain_bytes: dict = {}
        for o in helpers:
            dom = crush.domain_of(int(o))
            domain_bytes[dom] = domain_bytes.get(dom, 0.0) + share
        wait = d.domain_budgets.request(
            domain_bytes, mbps * 1e6,
            float(d.config["osd_repair_domain_burst_mb"]) * 1e6,
            time.monotonic())
        if wait > 0.0:
            d.repair_policy._count("repair_domain_throttles")
            from ..utils.flight_recorder import trace_span
            with trace_span("osd.repair_throttle",
                            wait_ms=int(wait * 1000),
                            domains=len(domain_bytes)):
                pass
        return wait

    def _grant(self) -> None:
        d = self.d
        wait = self._domain_throttle()
        if wait > 0.0:
            # out of domain tokens: yield the shard worker and come
            # back when the bucket has refilled (bounded nap so a
            # live budget raise is picked up promptly)
            t = threading.Timer(min(wait, 0.5), self._requeue)
            t.daemon = True
            t.start()
            return
        # the daemon lock plus EVERY member PG's lock (ascending —
        # the one global order): a fused batch may touch any plan's
        # PG, and client ops on other shards hold only pg locks now
        locks = [d._pg_lock(ps) for ps in sorted(self.plans)]
        try:
            with d._lock:
                for lk in locks:
                    lk.acquire()
                try:
                    if self.runner.step():
                        pass                # yield below
                    else:
                        self.runner.finish()
                        self._settle_locked()
                        return
                finally:
                    for lk in reversed(locks):
                        lk.release()
        except (ValueError, ConnectionError, OSError, KeyError) as e:
            # helper died / push refused mid-round: park it — the next
            # reconcile re-plans the leftover names against the fresh
            # map (plan.remaining tracks exactly what didn't land)
            self.failed = True
            import errno as _errno
            if isinstance(e, OSError) and e.errno == _errno.ENOSPC:
                # r21: writeback hit a full store — same park contract
                # (cursors intact, the re-plan retries once space or a
                # better target shows up), but counted separately so
                # the capacity plane can see recovery being starved
                d.repair_policy._count("repair_enospc_parked")
            d.c.log(f"{d.name}: recovery round deferred: {e}")
            return
        sleep = float(d.config["osd_recovery_sleep"])
        if sleep > 0 and not d._stop.is_set():
            t = threading.Timer(sleep, self._requeue)
            t.daemon = True
            t.start()
        else:
            self._requeue()

    def _requeue(self) -> None:
        if self.d._stop.is_set():
            return
        self.d._sched_enqueue("background_recovery", self,
                              self.next_cost(), shard=self.shard())

    def _settle_locked(self) -> None:
        d = self.d
        d.suspect -= self.dead
        now_m = time.monotonic()
        for ps, _plan, _dead in self.entries:
            if d._recovering.get(ps) is self:
                d._recovering.pop(ps, None)
            # r17 exposure accounting: the stripe left m-1 when its
            # rebuild landed — close its time-at-m-1 interval
            d.repair_policy.note_exposure(ps, False, now=now_m)
            try:
                d._persist_meta(ps)
            except (ConnectionError, OSError, KeyError) as e:
                d.c.log(f"{d.name}: pg 1.{ps} post-recovery persist "
                        f"deferred: {e}")
        d.perf.inc("recovery_rounds")
        d._note_repair_gauges()


class _OpShard:
    """One op-queue shard (ref: OSD::ShardedOpWQ shard): its own
    mClock scheduler + condition + worker thread. Ops hash to a shard
    by PG id (OSDDaemon._shard_of), so one PG's ops drain FIFO on one
    worker — per-PG ordering needs no cross-shard coordination."""

    def __init__(self, daemon: "OSDDaemon", idx: int):
        from .scheduler import MClockScheduler
        self.d = daemon
        self.idx = idx
        self.sched = MClockScheduler(daemon._mclock_profiles())
        self.cv = threading.Condition()
        self._thread = threading.Thread(
            target=self._worker_loop, daemon=True,
            name=f"{daemon.name}-shard{idx}")

    def start(self) -> None:
        self._thread.start()

    def enqueue(self, cls: str, item, cost: float = 1.0) -> None:
        with self.cv:
            self.sched.enqueue(cls, item, cost)
            self.cv.notify()

    def _worker_loop(self) -> None:
        """Drain this shard's mClock queue in tag order. Every item is
        a callable; recovery rounds re-enqueue themselves after each
        batch grant, so a queued client op never waits behind more
        than ONE recovery batch (the p95-bounding property the
        scheduler exists for), and only within its own shard."""
        d = self.d
        while not d._stop.is_set():
            with self.cv:
                now = time.monotonic()
                got = self.sched.dequeue(now)
                if got is None:
                    nxt = self.sched.next_eligible(now)
                    self.cv.wait(
                        0.5 if nxt is None
                        else min(0.5, max(0.001, nxt - now)))
                    continue
            _cls, item = got
            d.perf.inc("op_shard_grants")
            try:
                item()
            except Exception as e:   # noqa: BLE001 — the worker must
                # survive any op; the item owns its own error reply
                d.c.log(f"{d.name}: op shard {self.idx} item "
                        f"failed: {e!r}")
            d._note_shard_gauges()


class _BatchJoin:
    """Reply assembly for a `batch` frame whose sub-ops span shards:
    each shard executes its slots FIFO (per-PG order holds), the LAST
    shard to finish encodes the reply in original slot order and
    sends it — one frame in, one frame out, exactly like the
    single-shard path."""

    def __init__(self, daemon: "OSDDaemon", peer: str, msg,
                 n_slots: int, n_groups: int,
                 t_enq: float | None = None):
        self.d, self.peer, self.msg = daemon, peer, msg
        self.slots: list = [None] * n_slots
        self._left = n_groups
        self._lock = threading.Lock()
        self.t_enq = t_enq

    def run(self, items: list) -> None:
        """items: [(slot, kind, body)] — one shard's share."""
        with self.d._trace_enter(self.msg, self.t_enq):
            self._run_inner(items)

    def _run_inner(self, items: list) -> None:
        for slot, kind, body in items:
            try:
                blob = self.d._one_client_op(self.peer, kind, body)
                self.slots[slot] = (True, blob, "")
            except Exception as err:   # noqa: BLE001 — per-sub-op
                # fault isolation (the client maps each slot back to
                # its op's retry state)
                self.slots[slot] = (False, b"",
                                    f"{type(err).__name__}:{err}")
        with self._lock:
            self._left -= 1
            done = self._left == 0
        if not done:
            return
        e = Encoder()
        e.u32(len(self.slots))
        for ok, blob, err in self.slots:
            e.boolean(ok).blob_ref(blob).string(err)
        try:
            self.d.msgr.send(self.peer, MOSDOpReply(
                self.msg.req_id, True, self.msg.kind, e.bytes()))
        except (KeyError, OSError, ConnectionError):
            pass


class OSDDaemon:
    """One OSD endpoint: local store + the PGs it primaries."""

    def __init__(self, osd_id: int, cluster: "StandaloneCluster",
                 device=None):
        from ..ec.interface import resolve_device
        self.osd_id = osd_id
        self.c = cluster
        self.device = resolve_device(device)
        self.name = f"osd.{osd_id}"
        self.store = cluster.make_store(osd_id)
        self.msgr = Messenger(self.name, secret=cluster.secret,
                              compress=cluster.compress,
                              workers=cluster.msgr_workers,
                              uds=cluster.msgr_uds)
        self.rpc = _Rpc(self.msgr, MStoreReply.type_id)
        self.osdmap: OSDMap | None = None
        self.backends: dict[int, object] = {}     # ps -> PGBackend
        # per-PG snapshot + object-class state; rides _persist_meta so
        # a primary takeover restores it with the rest of the PG
        self.snapsets: dict[int, dict[str, list]] = {}
        self.births: dict[int, dict[str, int]] = {}
        self.obj_kv: dict[int, dict[str, dict]] = {}
        # divergent names whose rewind was deferred (helpers not
        # reachable during the restoring reconcile); retried on every
        # later reconcile until clean
        self._rewind_pending: dict[int, set[str]] = {}
        self._restore_backoff: dict[int, float] = {}
        # per-PG delta-meta window: (entries since last full base
        # persist, base pg_log head) — see _meta_extra
        self._meta_delta: dict[int, tuple[list, int]] = {}
        # interval-freshness bookkeeping (the up_thru machinery, ref:
        # PeeringState WaitUpThru): per primaried pg, the map acting
        # we last processed and the epoch its interval began. While
        # osd_up_thru[self] lags an interval's start, that PG is
        # PRE-ACTIVE: no restore, no recovery, no client I/O — only a
        # MOSDAlive request to the monitors. The activation persist
        # (_persist_meta's epoch stamp) therefore happens strictly
        # AFTER the up_thru commit, which grounds the (epoch, head)
        # meta ranking in map-provable interval freshness: an interval
        # whose primary died pre-activation left neither an up_thru
        # claim nor an epoch-stamped blob, so later peering neither
        # waits on it nor trusts it.
        self._interval_start: dict[int, int] = {}
        self._last_acting: dict[int, list[int]] = {}
        # scheduled scrub bookkeeping (per primaried pg; ref: the
        # scrubber's per-PG schedule, osd_scrub_min_interval /
        # osd_deep_scrub_interval)
        self._last_scrub: dict[int, float] = {}
        self._last_deep: dict[int, float] = {}
        self.scrub_reports: dict[int, dict] = {}
        # per-daemon layered config (ref: md_config_t per daemon). The
        # cluster's tuned knobs act as the conf-file layer; the
        # centralized KV riding the committed OSDMap lands at the
        # "mon" layer on every map fold (_apply_central_config), so
        # the full precedence chain default < file < mon < override
        # is live on a running daemon and observers fire on commit.
        # Built BEFORE observability: the OpTracker resolves its
        # complaint/history thresholds through this config live.
        from ..utils.config import Config
        self.config = Config()
        self.config.load_file({
            "osd_heartbeat_interval": cluster.hb_interval,
            "osd_heartbeat_grace": cluster.hb_grace,
            "osd_op_num_shards": cluster.op_shards,
            "msgr_reactor_workers": cluster.msgr_workers,
        })
        self._cfg_applied: dict[str, str] = {}
        # admin-socket observability (ref: OpTracker/TrackedOp +
        # PerfCounters served by `ceph daemon osd.N <cmd>`)
        self._init_observability()
        self.suspect: set[int] = set()            # osd ids (local view)
        self._lock = threading.RLock()
        self._store_lock = threading.Lock()
        # per peer, when the oldest ping still unanswered went out
        # (ref: OSD::heartbeat_check's ping_history): a peer fails on
        # an unanswered ping older than the grace, so a heartbeat
        # thread that stalled itself (sent nothing) judges no peer
        self._ping_unacked: dict[int, float] = {}
        # per-peer store-op round-trip EWMA (seconds): the repair
        # planner's per-helper read costs — suspects and slow peers
        # rank behind fast trusted ones instead of uniform-cost picks
        self._peer_lat: dict[int, float] = {}
        # CLIENT-observed per-osd latency (r15, the r14 follow-up):
        # sampled ops carry the client hedge ladder's EWMA/complaint
        # snapshot; folded here as osd -> (seconds, wall stamp) so
        # _helper_costs ranks by the slower of the daemon's own view
        # and what clients actually experienced. Stamped so a stale
        # client claim ages out instead of pinning costs forever.
        self._client_lat: dict[int, tuple[float, float]] = {}
        self._reported: set[int] = set()
        self._stop = threading.Event()
        # cephx (ref: OSD::ms_verify_authorizer): rotating secrets are
        # fetched at boot (stand-in: exported straight from the
        # cluster's KeyServer); per-peer sessions are established by
        # MAuthOp("authorize") and die with the process
        self._authed: dict[str, dict] = {}
        self.verifier = None
        self._cauth = None
        if cluster.key_server is not None:
            from ..auth import ServiceVerifier
            self.verifier = ServiceVerifier(
                "osd", cluster.key_server.export_rotating("osd"))
        self._start()

    def _start(self) -> None:
        """Register handlers + start the heartbeat thread (shared by
        __init__ and revive so the two can't silently diverge)."""
        # the daemon's live admin socket (ref: admin_socket.cc asok
        # per daemon): same dispatcher as the wire `admin` op, but
        # reachable without a client, a map, or cephx — the operator's
        # side door into a wedged daemon
        # mClock-governed SHARDED op admission (ref: src/osd/
        # scheduler/mClockScheduler.cc wired into OSD::op_shardedwq
        # with osd_op_num_shards shards): client ops and recovery
        # batch grants hash by PG id to a shard; each shard drains its
        # own scheduler in tag order on its own worker — per-PG
        # ordering is a queue invariant (one PG, one shard, one FIFO)
        # while independent PGs dispatch concurrently, and
        # background_recovery competes with (instead of head-of-line-
        # blocking) the client ops of its shard. Built fresh here
        # (empty queues per boot), and BEFORE any handler registers —
        # a map or op frame may land the moment the messenger knows
        # the type. mClock reservations are PER SHARD (the
        # reference's documented osd_op_num_shards caveat).
        self.num_op_shards = max(1, int(
            self.config["osd_op_num_shards"]))
        self.op_shards = [_OpShard(self, i)
                          for i in range(self.num_op_shards)]
        # compat alias: shard 0's scheduler (single-shard daemons
        # behave exactly like the pre-shard tree)
        self.op_sched = self.op_shards[0].sched
        self._sched_cv = self.op_shards[0].cv
        # per-PG execution locks: client ops serialize within their
        # PG only; reconcile/recovery take the PG locks of the PGs
        # they mutate (always AFTER self._lock — one global order)
        self._pg_locks: dict[int, threading.RLock] = {}
        self._pg_locks_guard = threading.Lock()
        self._recovering: dict[int, "_RecoveryRound"] = {}
        # r21: PGs whose rebuild is parked because a replacement
        # target sits at/over backfillfull (one counter tick per
        # park transition, not per reconcile beat)
        self._bff_parked: set[int] = set()
        # r17 repair policy plane: per-peer DownClocks + parked
        # rebuilds + exposure accounting, and the per-failure-domain
        # repair token buckets. Built per boot (in-RAM policy state
        # dies with the process — a restarted primary is eager about
        # peers whose down window it cannot date; see
        # RepairPolicy.observe_map).
        from .repairpolicy import RepairPolicy
        from .scheduler import DomainBudgets
        self.repair_policy = RepairPolicy(config=self.config,
                                          perf=self.perf,
                                          now_fn=time.monotonic)
        self.domain_budgets = DomainBudgets()
        for sh in self.op_shards:
            sh.start()
        from ..utils.admin_socket import AdminSocket
        self.asok = AdminSocket(self.c.asok_path(self.name))
        for _cmd in self._ADMIN_CMDS:
            self.asok.register(_cmd,
                               lambda args, c=_cmd:
                               self._admin_obj((c + " " + args).strip()))
        self.asok.start()
        m = self.msgr
        m.register_handler(MStoreOp.type_id, self._on_store_op)
        m.register_handler(MOSDOp.type_id, self._on_client_op)
        m.register_handler(MOSDPing.type_id, self._on_ping)
        m.register_handler(MOSDPingReply.type_id, self._on_pong)
        # map folds run a full reconcile (meta gathers, shard moves —
        # BLOCKING remote rpc): queued dispatch, never on a reactor,
        # or the fold would deadlock against its own replies
        m.register_handler(MOSDMapMsg.type_id, self._on_map,
                           fast=False)
        m.register_handler(MOSDIncMapMsg.type_id, self._on_inc_map,
                           fast=False)
        if self.verifier is not None:
            from ..auth import ClientAuth
            m.register_handler(MAuthOp.type_id, self._on_auth)
            # this daemon's own principal, for osd->osd store traffic
            # (sessions and rpc die with the process: built in _start
            # so a revive gets fresh ones)
            self.auth_rpc = _Rpc(self.msgr, MAuthReply.type_id)
            self._cauth = ClientAuth(
                _WireAuth(self.c, self.auth_rpc), self.name,
                self.c.osd_secrets[self.osd_id])
            # single-flight background ticket refresher: dispatch-path
            # authorize (the meta gather, the shard fan-out) must
            # NEVER hunt monitors itself — see _authorize_peer
            self._ticket_gate = threading.Lock()
            # pre-warm tickets OFF the dispatch path: peer store reads
            # happen inside map/op dispatch, and a monitor hunt there
            # (seconds, worse across a partition) stalls the dispatch
            # thread — pings queue up behind it and peers mark this
            # daemon down, cascading into fake failures. The reference
            # likewise fetches rotating secrets/tickets on its own
            # monc thread, not in fast dispatch.
            def _prewarm():
                for _ in range(10):
                    if self._stop.is_set():
                        return
                    try:
                        self._cauth.fetch_tickets(["osd"])
                        return
                    except Exception:   # noqa: BLE001 — mons booting
                        self._stop.wait(0.5)
            threading.Thread(target=_prewarm, daemon=True).start()
        self._hb = threading.Thread(target=self._heartbeat_loop,
                                    daemon=True)
        self._hb.start()

    def _spawn_ticket_refresh(self) -> None:
        """Kick ONE background fetch_tickets (no-op when one is
        already running). Dispatch threads call this instead of
        fetching inline — the deferral costs one reconcile retry,
        the inline hunt can cost the whole daemon (see
        _authorize_peer)."""
        if not self._ticket_gate.acquire(blocking=False):
            # single-flight: someone is already fetching — this wait
            # is the cheap outcome the counter exists to prove
            self.perf.inc("cephx_refresh_coalesced")
            return
        self.perf.inc("cephx_refresh_kicked")

        def _go():
            try:
                self._cauth.fetch_tickets(["osd"])
            except Exception:    # noqa: BLE001 — mons down/partition:
                pass             # the next deferral re-kicks us
            finally:
                self._ticket_gate.release()
        threading.Thread(target=_go, daemon=True).start()

    def _authorize_peer(self, peer: str) -> None:
        """osd->osd cephx (ref: OSD heartbeat/cluster messengers carry
        cephx authorizers too): used by RemoteStore on first contact.

        Runs on DISPATCH threads (the meta gather inside _on_map, the
        write fan-out inside _on_client_op) while self._lock is held —
        so it must never hunt monitors: the monitor's auth reply can
        be head-of-line-blocked behind an undelivered map frame on
        the same connection, whose reader is waiting for self._lock.
        Under a map-commit storm (boot, up_thru activation rounds)
        that livelocks the whole daemon. Cold cache -> fail fast,
        refresh in the background, let the reconcile retry."""
        if not self._cauth.has_ticket("osd"):
            self.perf.inc("authorize_deferred")
            self._spawn_ticket_refresh()
            raise ConnectionError(
                f"{self.name}: osd service ticket not warm; authorize "
                f"to {peer} deferred (background refresh kicked)")
        _wire_authorize(self._cauth, self.auth_rpc, peer, "osd",
                        async_refresh=self._spawn_ticket_refresh)

    # -- mClock op admission -------------------------------------------------

    # the reference's built-in profile split (osd_mclock_profile):
    # (reservation, weight, limit) per class, ops/s-space with cost
    # scaled so one recovery batch counts its bytes, not "one op"
    _MCLOCK_BUILTIN = {
        "high_client_ops": {
            "client": (50.0, 10.0, 0.0),
            "background_recovery": (25.0, 5.0, 100.0),
            "background_best_effort": (0.0, 2.0, 0.0),
            "scrub": (0.0, 1.0, 50.0)},
        "balanced": {
            "client": (50.0, 5.0, 0.0),
            "background_recovery": (50.0, 5.0, 150.0),
            "background_best_effort": (0.0, 2.0, 0.0),
            "scrub": (0.0, 1.0, 50.0)},
        "high_recovery_ops": {
            "client": (30.0, 2.0, 0.0),
            "background_recovery": (60.0, 10.0, 0.0),
            "background_best_effort": (0.0, 2.0, 0.0),
            "scrub": (0.0, 1.0, 50.0)},
    }

    #: per-tenant class namespace inside the scheduler — one class per
    #: client entity, so heavy tenants (and their hedged duplicates)
    #: compete under their own (ρ, w, λ) tags
    _TENANT_CLS = "tenant:"

    def _mclock_profiles(self) -> dict:
        """(ρ, w, λ) per op class, resolved LIVE through this daemon's
        layered config: osd_mclock_profile picks a built-in split;
        `custom` reads the osd_mclock_scheduler_* knobs (the reference's
        config-change path, no restart)."""
        from .scheduler import ClientProfile
        name = str(self.config["osd_mclock_profile"])
        if name == "custom":
            cfg = self.config
            table = {
                "client": (cfg["osd_mclock_scheduler_client_res"],
                           cfg["osd_mclock_scheduler_client_wgt"],
                           cfg["osd_mclock_scheduler_client_lim"]),
                "background_recovery": (
                    cfg["osd_mclock_scheduler_background_recovery_res"],
                    cfg["osd_mclock_scheduler_background_recovery_wgt"],
                    cfg["osd_mclock_scheduler_background_recovery_lim"]),
                "background_best_effort": (0.0, 2.0, 0.0),
                "scrub": (0.0, 1.0, 50.0)}
        else:
            table = self._MCLOCK_BUILTIN.get(
                name, self._MCLOCK_BUILTIN["high_client_ops"])
        return {cls: ClientProfile(reservation=r, weight=w, limit=lim)
                for cls, (r, w, lim) in table.items()}

    def _tenant_profile(self, entity: str):
        """Resolve one client entity's (ρ, w, λ): the per-entity table
        first, then the tenant default, then the aggregate client
        class split (equal-share per entity). All three resolve LIVE
        through config, so `ceph config set
        osd_mclock_scheduler_tenant_profiles ...` retunes a running
        daemon's tenants on the next fold."""
        from .scheduler import parse_profile, parse_profile_table
        try:
            table = parse_profile_table(
                self.config["osd_mclock_scheduler_tenant_profiles"])
            if entity in table:
                return table[entity]
            dflt = str(
                self.config["osd_mclock_scheduler_tenant_default"]
            ).strip()
            if dflt:
                return parse_profile(dflt)
        except (KeyError, ValueError) as e:
            self.c.log(f"{self.name}: bad tenant QoS config ignored: "
                       f"{e}")
        return self._mclock_profiles()["client"]

    def _client_class(self, peer: str, shard: "_OpShard") -> str:
        """mClock class of one client op: per-tenant, keyed by the
        cephx entity bound to the peer's session (the authenticated
        identity; caps already gated it) — the transport peer name
        without cephx. Registers the class on first contact with the
        op's shard (each shard tags its own tenants)."""
        sess = self._authed.get(peer)
        entity = sess["entity"] if sess is not None else peer
        cls = self._TENANT_CLS + entity
        with shard.cv:
            shard.sched.ensure_class(cls, self._tenant_profile(entity))
        return cls

    def _refresh_mclock_profiles(self) -> None:
        """Re-resolve the (ρ, w, λ) table after a config change (called
        from the central-config fold — cheaper and lifetime-safer than
        per-key observers across revives). Live per-tenant classes are
        re-resolved too, on every shard."""
        try:
            profiles = self._mclock_profiles()
        except (KeyError, ValueError) as e:
            self.c.log(f"{self.name}: bad mclock config ignored: {e}")
            return
        for sh in self.op_shards:
            with sh.cv:
                for cls, prof in profiles.items():
                    q = sh.sched._classes.get(cls)
                    if q is not None and q.profile != prof:
                        sh.sched.set_profile(cls, prof)
                for cls in sh.sched.class_names():
                    if cls.startswith(self._TENANT_CLS):
                        entity = cls[len(self._TENANT_CLS):]
                        sh.sched.ensure_class(
                            cls, self._tenant_profile(entity))

    # -- shard routing --------------------------------------------------------

    def _shard_of(self, ps: int) -> "_OpShard":
        """PG -> shard (the OSD::ShardedOpWQ hash): stable for the
        daemon's lifetime, so one PG's ops always drain FIFO on one
        worker."""
        return self.op_shards[ps % self.num_op_shards]

    @staticmethod
    def _op_ps(body) -> int:
        """Peek the PG id every client-op body leads with (the
        Encoder's raw little-endian u32) without a full decode."""
        try:
            return struct.unpack_from("<I", body, 0)[0]
        except struct.error:
            return 0

    def _pg_lock(self, ps: int) -> threading.RLock:
        with self._pg_locks_guard:
            lk = self._pg_locks.get(ps)
            if lk is None:
                lk = self._pg_locks[ps] = threading.RLock()
            return lk

    def _sched_enqueue(self, cls: str, item, cost: float = 1.0,
                       shard: "_OpShard | None" = None) -> None:
        (shard or self.op_shards[0]).enqueue(cls, item, cost)
        self._note_shard_gauges()

    def _note_shard_gauges(self) -> None:
        """Declared occupancy gauges over the shard set: total queued
        depth + grant imbalance (max-min served across shards — the
        hash-skew signal the bench JSON carries)."""
        depths = [len(sh.sched) for sh in self.op_shards]
        served = [sum(q.served for q in sh.sched._classes.values())
                  for sh in self.op_shards]
        self.perf.set("op_shard_depth", sum(depths))
        self.perf.set("op_shard_imbalance",
                      max(served) - min(served) if served else 0)

    def shard_dump(self) -> dict:
        """Per-shard scheduler occupancy (the `dump_op_shards` admin
        view; rados_bench ships it as per-shard attribution)."""
        return {f"shard_{sh.idx}": sh.sched.dump()
                for sh in self.op_shards}

    def sched_dump(self) -> dict:
        """Class -> occupancy MERGED across shards (the pre-shard
        `dump_mclock` shape: tools and tests iterate class names at
        the top level)."""
        out: dict = {}
        for sh in self.op_shards:
            for cls, row in sh.sched.dump().items():
                cur = out.get(cls)
                if cur is None:
                    out[cls] = dict(row)
                else:
                    cur["queued"] += row["queued"]
                    cur["served"] += row["served"]
                    cur["served_cost"] = round(
                        cur["served_cost"] + row["served_cost"], 3)
                    cur["throttled"] += row.get("throttled", 0)
        return out

    # -- store service (the SubOp executor) ---------------------------------

    _STORE_READ_KINDS = frozenset(
        {"read", "readv", "readv_ranges", "rmw_fetch", "stat",
         "getattr", "exists", "ls", "omap_get", "omap_iter",
         "retro_publish"})

    def _on_store_op(self, peer: str, msg: MStoreOp) -> None:
        # the store plane is ticket-gated exactly like the client op
        # plane — without this, MOSDOp's EPERM gate would be decorative
        # (any peer could reach shard bytes via raw MStoreOp frames)
        if self.verifier is not None:
            deny = self._auth_gate(
                peer,
                "r" if msg.kind in self._STORE_READ_KINDS else "w")
            if deny is not None:
                try:
                    self.msgr.send(peer, MStoreReply(
                        msg.req_id, False, msg.kind, err=deny))
                except (KeyError, OSError, ConnectionError):
                    pass
                return
        try:
            # r18: retro span publication is a daemon-level command,
            # not a store op — answer before the store lock
            if msg.kind == "retro_publish":
                d = Decoder(msg.blob)
                e = Encoder()
                e.u32(self._retro_publish(d.u64()))
                rep = MStoreReply(msg.req_id, True, msg.kind,
                                  e.bytes())
                try:
                    self.msgr.send(peer, rep)
                except (KeyError, OSError, ConnectionError):
                    pass
                return
            # r15: a sampled context on the frame puts this hop's
            # spans under the originating trace — osd.subop covers the
            # whole service (store-lock wait + reply encode), with the
            # store apply itself a nested child, so the assembler can
            # split store time from sub-op queueing.
            from ..utils.flight_recorder import activate, trace_span
            ctx = msg.trace if msg.trace is not None \
                and msg.trace.sampled else None
            t0w, t0 = time.time(), time.perf_counter()
            apply_s = 0.0
            with activate(ctx, self.flight if ctx is not None
                          else None):
                with trace_span("osd.subop", kind=msg.kind):
                    with self.perf.time("subop_latency"):
                        with self._store_lock:
                            ta = time.perf_counter()
                            with trace_span("store.apply"):
                                blob = self._store_op(msg.kind,
                                                      msg.blob)
                            apply_s = time.perf_counter() - ta
            # r18: an UNSAMPLED context still carries the trace id —
            # remember this hop's window so a later slow-op retro
            # assembly covers the replica too (the sampled case
            # already recorded eagerly above)
            if msg.trace is not None and not msg.trace.sampled:
                self._subop_note(msg.trace, msg.kind, t0w,
                                 time.perf_counter() - t0, apply_s)
            self.perf.inc_many((("subop", 1),
                                ("subop_in_bytes", len(msg.blob)),
                                ("subop_out_bytes", len(blob))))
            rep = MStoreReply(msg.req_id, True, msg.kind, blob)
        except KeyError as e:
            rep = MStoreReply(msg.req_id, False, msg.kind,
                              err=f"KeyError:{e}")
        except Exception as e:   # noqa: BLE001 — fault isolation: the
            # daemon must answer, not die, on a bad op
            rep = MStoreReply(msg.req_id, False, msg.kind,
                              err=f"{type(e).__name__}:{e}")
        try:
            self.msgr.send(peer, rep)
        except (KeyError, OSError, ConnectionError):
            pass                 # requester died; nothing to tell

    def _store_op(self, kind: str, body: bytes) -> bytes:
        st = self.store
        if kind == "txn":
            st.queue_transaction(_decode_txn(body))
            return b""
        d = Decoder(body)
        cid, oid = d.string(), d.string()
        if kind == "read":
            off, ln = d.i64(), d.i64()
            arr = st.read(cid, oid, off, None if ln < 0 else ln)
            return arr.tobytes()
        if kind == "readv":
            # multi-object shard fetch: ONE frame returns many equal-
            # length rows (+ their hinfo attrs) — the recovery pull
            # unit (ref: MOSDPGPull carrying a PullOp vector; the
            # per-object read() path costs B round trips per helper
            # shard per batch)
            attr_key = d.string()
            length = d.i64()
            names = d.list(Decoder.string)
            rows = []
            for name in names:
                arr = st.read(cid, name)
                if len(arr) != length:
                    # a stale/partial shard must fail LOUDLY — zero-
                    # filling would hand the decoder garbage that
                    # writeback then stamps with matching CRCs
                    raise ValueError(
                        f"readv: {name!r} is {len(arr)} bytes, "
                        f"expected {length}")
                rows.append(np.asarray(arr, np.uint8))
            e = Encoder()
            e.blob(b"".join(r.tobytes() for r in rows))
            e.list([st.getattr(cid, n, attr_key) for n in names]
                   if attr_key else [], Encoder.blob)
            return e.bytes()
        if kind == "readv_ranges":
            # sub-chunk shard fetch (repair-locality planner): ship
            # only the planned (offset, length) ranges of every row.
            # The full-row hinfo verify + range CRCs happen HERE at
            # the source (readv_ranges_host) — the receiver fold-
            # verifies the shipped bytes and plans around any row the
            # source flagged rotten.
            from .ecbackend import readv_ranges_host
            attr_key = d.string()
            length = d.i64()
            ranges = d.list(lambda dd: (dd.i64(), dd.i64()))
            names = d.list(Decoder.string)
            rows, crcs, bad = readv_ranges_host(
                st, cid, names, length, ranges, attr_key or None,
                device=self.device)
            e = Encoder()
            e.blob(rows.tobytes())
            e.list([int(c) for c in crcs] if crcs is not None else [],
                   Encoder.u32)
            e.list([int(b) for b in bad], Encoder.u32)
            return e.bytes()
        if kind == "rmw_fetch":
            # combined RMW prepare fetch (r17): per delta job, the
            # hinfo attr (present flag + bytes) and the touched
            # pre-image sub-ranges, in ONE frame per participant
            # shard — the reply mirrors the item order. A short read
            # (write past the old tail) returns the short bytes; the
            # receiver zero-pads, exactly like the old per-span read.
            attr_key = d.string()
            items = d.list(lambda dd: (
                dd.string(), dd.list(lambda d2: (d2.i64(), d2.i64()))))
            e = Encoder()

            def one(en: Encoder, item) -> None:
                name, ranges = item
                try:
                    attr, ok = st.getattr(cid, name, attr_key), True
                except KeyError:
                    attr, ok = b"", False
                en.boolean(ok).blob(attr)
                en.list([np.asarray(st.read(cid, name, off, ln),
                                    np.uint8).tobytes()
                         for off, ln in ranges], Encoder.blob)
            e.list(items, one)
            return e.bytes()
        if kind == "stat":
            return Encoder().i64(st.stat(cid, oid)).bytes()
        if kind == "getattr":
            return st.getattr(cid, oid, d.string())
        if kind == "exists":
            return b"\x01" if st.exists(cid, oid) else b"\x00"
        if kind == "ls":
            return Encoder().list(st.list_objects(cid),
                                  Encoder.string).bytes()
        if kind == "omap_get":
            key = d.blob()
            obj = st.collections[cid].get(oid)
            if obj is None or key not in obj.omap:
                raise KeyError(f"{cid}/{oid}:{key!r}")
            return obj.omap[key]
        if kind == "omap_iter":
            has_start = d.boolean()
            start = d.blob()
            limit = d.i64()
            page = st.omap_iter(cid, oid,
                                start_after=start if has_start else None,
                                limit=None if limit < 0 else limit)
            e = Encoder()
            e.list(page, lambda en, kv: en.blob(kv[0]).blob(kv[1]))
            return e.bytes()
        raise ValueError(f"unknown store op {kind!r}")

    # -- PG hosting ----------------------------------------------------------

    def _shard_set(self) -> ShardSet:
        def factory(osd_id: int):
            if osd_id == self.osd_id:
                return self.store
            return RemoteStore(self.rpc, f"osd.{osd_id}",
                               timeout=self.c.op_timeout,
                               authorize=self._authorize_peer
                               if self.verifier is not None else None,
                               on_latency=self._note_peer_latency)
        return ShardSet(store_factory=factory)

    def _note_peer_latency(self, peer: str, dt: float) -> None:
        """Fold one store-op round trip into the peer's latency EWMA
        (the r11 client ladder's 0.75/0.25 blend, daemon-side)."""
        if not peer.startswith("osd."):
            return
        osd = int(peer[4:])
        prev = self._peer_lat.get(osd)
        self._peer_lat[osd] = dt if prev is None \
            else 0.75 * prev + 0.25 * dt
        # r22: the same sample feeds the link plane's "store" channel
        # (wire + service time, vs the hb channel's wire + dispatch)
        if bool(self.config["osd_network_observability"]):
            self.link_tracker.note(peer, dt, channel="store")

    #: client-observed latency claims older than this are ignored (a
    #: one-off slow window must not bias helper picks for hours)
    _CLIENT_LAT_TTL = 30.0

    def _note_client_costs(self, ctx) -> None:
        """Fold a sampled op's client cost snapshot (per-osd read
        EWMAs + the client's live complaint set) into this daemon's
        helper cost table. Complaints fold as a 1s-equivalent floor —
        well above any healthy round trip, well below the down
        surcharge — so a client-suspected helper ranks last among the
        live ones without being treated as dead."""
        now = time.monotonic()
        for osd, lat in (ctx.client_lat or {}).items():
            osd = int(osd)
            prev = self._client_lat.get(osd)
            blend = float(lat) if prev is None \
                else 0.75 * prev[0] + 0.25 * float(lat)
            self._client_lat[osd] = (blend, now)
        for osd in ctx.client_suspects:
            cur = self._client_lat.get(int(osd))
            base = cur[0] if cur is not None else 0.0
            self._client_lat[int(osd)] = (max(base, 1.0), now)

    def _helper_costs(self, be) -> dict[int, int]:
        """Per-slot read costs for the repair-locality planner
        (minimum_to_decode_with_cost units: integer microseconds).
        Real signals, not uniform guesses: the peer-latency EWMA from
        actual store-op round trips, the CLIENT-observed EWMAs sampled
        ops shipped (r15 — the slower of the two views wins, so a
        helper that answers its peers fast but stalls clients still
        ranks behind), plus a prohibitive surcharge for anyone in the
        down/slow complaint memory — such slots are usually excluded
        outright, but a cost keeps ties deterministic when they must
        serve."""
        n_osds = len(self.osdmap.osd_up) if self.osdmap is not None \
            else 0
        now = time.monotonic()
        costs: dict[int, int] = {}
        for s, osd in enumerate(be.acting):
            if osd == self.osd_id:
                cost = 0                  # our own store is free
            else:
                lat = self._peer_lat.get(osd, 0.001)
                claim = self._client_lat.get(osd)
                if claim is not None \
                        and now - claim[1] < self._CLIENT_LAT_TTL:
                    lat = max(lat, claim[0])
                # r22 link-cost feed: the heartbeat-RTT EWMA toward
                # this helper joins the blend — slowest view wins, so
                # a degraded WIRE ranks a helper down even while its
                # store answers the few ops that do arrive quickly
                hb = self.link_tracker.ewma_s(f"osd.{osd}")
                if hb > lat:
                    lat = hb
                    self.perf.inc("net_helper_penalties")
                cost = int(lat * 1e6)
            if osd in self.suspect or (
                    _valid_osd(osd, n_osds)
                    and self.osdmap is not None
                    and not self.osdmap.osd_up[osd]):
                cost += 1_000_000_000
            costs[s] = cost
        return costs

    def _acting(self, ps: int) -> list[int]:
        return self.osdmap.pg_to_up_acting_osds(1, ps)[2]

    def _make_backend(self, ps: int, acting: list[int],
                      ensure_collections: bool = True):
        if self.c.is_erasure:
            return ECBackend(self.c.profile, f"1.{ps}", acting,
                             self._shard_set(),
                             chunk_size=self.c.chunk_size,
                             perf=self.ec_perf,
                             ensure_collections=ensure_collections,
                             device=self.device)
        return ReplicatedBackend(self.c.pool_size, f"1.{ps}", acting,
                                 self._shard_set(),
                                 min_size=self.c.pool_min_size,
                                 ensure_collections=ensure_collections,
                                 device=self.device)

    def _persist_meta(self, ps: int) -> None:
        """Ship the PG's FULL metadata to every live shard as omap
        (the pg_log-rides-with-the-transaction discipline, ref: PGLog
        entries inside ObjectStore::Transaction). Clears the delta key
        in the same transaction — the base subsumes it (see
        _meta_extra for the delta scheme)."""
        be = self.backends[ps]
        blob = self._encode_meta(ps)
        self._meta_delta[ps] = ([], be.pg_log.head)
        # fan the omap txns out PIPELINED: transmit to every live
        # shard first, then wait each ack — one overlapped round trip
        # instead of len(acting) sequential ones (failure handling
        # unchanged: an unreachable shard is suspected, not fatal)
        waits: list[tuple[int, object]] = []
        for s, osd in enumerate(be.acting):
            if osd in self.suspect:
                continue
            t = Transaction().omap_set(shard_cid(be.pg, s), "__pg_meta__",
                                       {PG_META_KEY: blob,
                                        PG_META_DELTA_KEY: b""})
            st = be.cluster.osd(osd)
            submit = getattr(st, "queue_transaction_async", None)
            try:
                if submit is not None:
                    waits.append((osd, submit(t)))
                else:
                    st.queue_transaction(t)
            except (ConnectionError, OSError):
                self.suspect.add(osd)
        for osd, h in waits:
            try:
                h.result()
            except (ConnectionError, OSError):
                self.suspect.add(osd)

    def _encode_meta_delta(self, ps: int) -> bytes:
        """The bounded per-write metadata record: entries appended
        since the last FULL base persist, plus the current applied
        cursors. O(delta window) per write where the base blob is
        O(objects in PG) — the difference between a flat and a
        quadratically-degrading write path at scale. `base_head` pins
        which base the delta extends; a reader ignores a delta whose
        base doesn't match (defensive — the clearing txn makes the
        pair atomic per shard)."""
        be = self.backends[ps]
        entries, base_head = self._meta_delta[ps]
        e = Encoder()
        e.start(1, 1)
        e.u64(self.osdmap.epoch if self.osdmap is not None else 0)
        e.u64(base_head)
        e.list(be.shard_applied, lambda en, v: en.u64(v))
        e.list(entries, lambda en, t: en.string(t[0]).u64(t[1])
               .u64(t[2]))
        e.finish()
        return e.bytes()

    @staticmethod
    def _decode_meta_delta(blob: bytes):
        """-> (epoch, base_head, shard_applied, [(name, ver, size)])
        or None for an absent/corrupt delta."""
        if not blob:
            return None
        try:
            d = Decoder(blob)
            d.start(1)
            epoch = d.u64()
            base_head = d.u64()
            applied = d.list(Decoder.u64)
            entries = d.list(lambda dd: (dd.string(), dd.u64(),
                                         dd.u64()))
            d.finish()
        except Exception:        # noqa: BLE001 — corrupt delta: the
            return None          # base alone is still a candidate
        return (epoch, base_head, applied, entries)

    def _encode_meta(self, ps: int) -> bytes:
        """v4 envelope: the v3 body, zlib-wrapped. The blob ships to
        every live shard on EVERY write (it rides the write fan-out
        txn) and grows with the PG's object count — deflating the
        name/int-table body ~4-5x keeps the metadata bytes a small
        fraction of the data bytes at bench scale. compat=4: the
        body layout moved, so a pre-v4 reader must refuse (its
        _meta_rank treats the refusal as no-candidate) rather than
        misparse."""
        import zlib
        inner = self._encode_meta_v3(ps)
        e = Encoder()
        e.start(4, 4).blob(zlib.compress(inner, 1)).finish()
        return e.bytes()

    @staticmethod
    def _meta_decoder(blob: bytes) -> tuple[Decoder, int]:
        """Open a persisted meta blob, unwrapping the v4 zlib envelope
        when present; returns (decoder positioned at the v3-era
        fields, version<=3). Raises on corrupt/unknown blobs — every
        caller already treats decode failure as 'no candidate'."""
        d = Decoder(blob)
        v = d.start(4)
        if v >= 4:
            import zlib
            d = Decoder(zlib.decompress(d.blob()))
            v = d.start(3)
        return d, v

    def _encode_meta_v3(self, ps: int) -> bytes:
        import json as _json
        be = self.backends[ps]
        e = Encoder()
        # v2 appends snapsets/births/cls-kv (compat 1: a v1 reader
        # skips the tail via the section length); v3 leads with the
        # map epoch the blob was persisted under — takeover precedence
        # is (epoch, head), NOT bare head, so a revived ex-primary's
        # divergent log from an older interval can never win peering
        # (ref: PeeringState find_best_info's last_epoch_started
        # precedence)
        e.start(3, 1)
        e.u64(self.osdmap.epoch if self.osdmap is not None else 0)
        e.mapping(be.object_sizes, Encoder.string,
                  lambda en, v: en.u64(v))
        e.mapping(be.object_versions, Encoder.string,
                  lambda en, v: en.u64(v))
        e.blob(be.pg_log.encode())
        e.list(be.shard_applied, lambda en, v: en.u64(v))
        e.list(be.acting, lambda en, v: en.i32(v))
        e.mapping(self.snapsets.get(ps, {}), Encoder.string,
                  lambda en, v: en.list(
                      v, lambda e2, t: e2.u64(t[0]).u64(t[1])))
        e.mapping(self.births.get(ps, {}), Encoder.string,
                  lambda en, v: en.u64(v))
        e.mapping(self.obj_kv.get(ps, {}), Encoder.string,
                  lambda en, v: en.blob(
                      _json.dumps(v, sort_keys=True).encode()))
        e.finish()
        return e.bytes()

    @staticmethod
    def _meta_rank(pair) -> tuple[int, int] | None:
        """(epoch, head) precedence key of a persisted (base, delta)
        meta pair, or None for a corrupt candidate. Epoch FIRST: a
        newer interval's state beats any head from an older one — the
        divergent-log guard (ref: find_best_info). A delta extending
        this base advances the effective head (and carries the newer
        persist epoch); a delta pinned to a DIFFERENT base head is
        stale pairing and is ignored."""
        base, delta_blob = pair
        try:
            d, v = OSDDaemon._meta_decoder(base)
            epoch = d.u64() if v >= 3 else 0
            d.mapping(Decoder.string, Decoder.u64)
            d.mapping(Decoder.string, Decoder.u64)
            head = PGLog.decode(d.blob()).head
        except Exception:        # noqa: BLE001 — a corrupt candidate
            return None          # must not block takeover
        delta = OSDDaemon._decode_meta_delta(delta_blob) \
            if delta_blob else None
        if delta is not None and delta[1] == head and delta[3]:
            epoch = max(epoch, delta[0])
            head = max(head, delta[3][-1][1])
        return (epoch, head)

    def _load_meta(self, ps: int, acting: list[int],
                   suspect_extra: set[int] | None = None
                   ) -> tuple[bytes | None, bytes | None, bool]:
        """Find the FRESHEST persisted PG metadata: gather the blob
        from the local shard AND every reachable acting member, decode
        each, and keep the one with the highest (epoch, head) — a
        local copy can be stale (skipped by _persist_meta while
        transiently suspect) or DIVERGENT (this daemon died holding
        writes that never committed; bare-head precedence would
        resurrect them). Returns (best, best_local, quorum_ok): the
        local winner rides along so the caller can rewind divergent
        local entries against the authoritative log; quorum_ok says a
        MAJORITY of the up acting members answered the gather —
        restoring from fewer (only our own blob, peers not answering
        yet after a revive) could adopt a divergent dead-interval log
        as authoritative (ref: PeeringState GetInfo needs a quorum
        before the PG may go active)."""
        pgid = f"1.{ps}"
        # suspect_extra: callers' dead-peer hints (a degraded read's
        # routed-around primary) — skipped like suspects, but NEVER
        # recorded into self.suspect (the hint is per-op and untrusted)
        skip = set(self.suspect) | (suspect_extra or set())
        local_blobs: list[tuple[bytes, bytes | None]] = []
        remote_blobs: list[tuple[bytes, bytes | None]] = []
        heard = {self.osd_id}
        for s in range(len(acting)):
            obj = self.store.collections.get(
                shard_cid(pgid, s), {}).get("__pg_meta__")
            if obj is not None and PG_META_KEY in obj.omap:
                local_blobs.append(
                    (obj.omap[PG_META_KEY],
                     obj.omap.get(PG_META_DELTA_KEY)))
        n_osds = len(self.osdmap.osd_up) if self.osdmap is not None \
            else 0
        for osd in dict.fromkeys(acting):   # each peer once, in order
            if osd == self.osd_id or osd in skip \
                    or not _valid_osd(osd, n_osds):
                continue
            rs = RemoteStore(
                self.rpc, f"osd.{osd}", timeout=1.0,
                authorize=self._authorize_peer
                if self.verifier is not None else None)
            # a previous interval may have slotted this peer anywhere:
            # ask for EVERY slot's blob, not just the one our acting
            # assigns it (a slot-addressed miss reads as "no blob" and
            # silently crowns a divergent local log)
            for s in range(len(acting)):
                try:
                    base = rs.omap_get(shard_cid(pgid, s),
                                       "__pg_meta__", PG_META_KEY)
                    heard.add(osd)
                    try:
                        delta = rs.omap_get(shard_cid(pgid, s),
                                            "__pg_meta__",
                                            PG_META_DELTA_KEY)
                    except KeyError:
                        delta = None   # base-only shard (pre-delta)
                    remote_blobs.append((base, delta))
                except KeyError:
                    heard.add(osd)   # answered: no blob at this slot
                except (ConnectionError, OSError):
                    # unreachable: SUSPECT it (the store-op failure
                    # convention) so the next gather skips it instead
                    # of re-paying the timeout — an unpartitioned
                    # reconcile must never be starved by timeout loops
                    # against partitioned peers (that starves the
                    # heartbeat thread and stalls failure detection)
                    self.suspect.add(osd)
                    break

        def pick(pairs):
            best, best_rank = None, (-1, -1)
            for pair in pairs:
                rank = self._meta_rank(pair)
                if rank is not None and rank > best_rank:
                    best, best_rank = pair, rank
            return best

        up_members = {o for o in acting
                      if _valid_osd(o, n_osds)
                      and (o == self.osd_id or self.osdmap.osd_up[o])}
        need = len(up_members) // 2 + 1
        quorum_ok = len(heard & up_members) >= need
        if not quorum_ok:
            # the gather starved below quorum: clear the suspicion on
            # map-up members so the backoff retry RE-PROBES them
            # instead of skipping them forever. A suspicion set during
            # the boot thundering-herd (every daemon gathering from
            # every other at once, cold secure sessions) would
            # otherwise wedge this restore permanently once map
            # traffic goes quiet — we are not serving anyway, so
            # re-paying the probe timeout is the right price.
            self.suspect -= {o for o in up_members if o != self.osd_id}
        best_local = pick(local_blobs)
        # remotes first: on an (epoch, head) TIE the majority side
        # must win, never this daemon's own (possibly divergent) copy
        best = pick(remote_blobs + local_blobs)
        return best, best_local, quorum_ok

    @staticmethod
    def _apply_meta_delta(delta_blob, sizes: dict, versions: dict,
                          log: PGLog, applied: list) -> list:
        """Replay a delta window over decoded base metadata: append
        the (name, version, size) entries past the base head and adopt
        the delta's applied cursors. Ignores an absent/corrupt delta
        or one pinned to a different base (stale pairing). Returns the
        effective shard_applied list."""
        delta = OSDDaemon._decode_meta_delta(delta_blob) \
            if delta_blob else None
        if delta is None:
            return applied
        _, base_head, d_applied, entries = delta
        if base_head != log.head:
            return applied       # delta extends a different base
        for name, ver, size in entries:
            if ver <= log.head:
                continue         # defensive: never rewind
            log.append_entry(ver, name)
            versions[name] = ver
            sizes[name] = size
        if len(d_applied) == len(applied):
            applied = [max(a, b) for a, b in zip(applied, d_applied)]
        return applied

    def _restore_backend(self, ps: int, acting: list[int]):
        """Primary takeover: rebuild the PG from persisted metadata.
        The backend is restored with the acting set the metadata was
        recorded against — _reconcile then sees old != new and runs
        the recovery that re-creates the changed slots (the GetLog/
        GetMissing outcome)."""
        blob, local_blob, quorum_ok = self._load_meta(ps, acting)
        if not quorum_ok:
            # we could not hear a majority of the up acting members:
            # restoring now could crown a divergent local log — or
            # start a VIRGIN history whose first persist would beat
            # the unreachable peers' real data on epoch precedence.
            # Stay un-activated; the heartbeat reconcile retries
            # until the gather reaches quorum.
            self.c.log(f"{self.name}: pg 1.{ps} restore deferred "
                       f"(info gather below quorum)")
            return None
        be = self._make_backend(ps, acting)
        be.restored_from_blob = blob is not None
        if blob is None:
            return be            # virgin PG: nothing written yet
        import json as _json
        base, delta_blob = blob
        d, v = self._meta_decoder(base)
        if v >= 3:
            d.u64()              # persist epoch (used by _meta_rank)
        be.object_sizes = d.mapping(Decoder.string, Decoder.u64)
        be.object_versions = d.mapping(Decoder.string, Decoder.u64)
        be.pg_log = PGLog.decode(d.blob())
        applied = d.list(Decoder.u64)
        meta_acting = d.list(Decoder.i32)
        if v >= 2:
            self.snapsets[ps] = d.mapping(
                Decoder.string,
                lambda dd: dd.list(lambda e2: (e2.u64(), e2.u64())))
            self.births[ps] = d.mapping(Decoder.string, Decoder.u64)
            self.obj_kv[ps] = {
                k: _json.loads(b) for k, b in d.mapping(
                    Decoder.string, Decoder.blob).items()}
        d.finish()
        # roll the delta window forward over the base (the entries
        # persisted since the last full blob — see _meta_extra)
        applied = self._apply_meta_delta(
            delta_blob, be.object_sizes, be.object_versions,
            be.pg_log, applied)
        # adopt the RECORDED acting so the reconcile pass recovers any
        # slot whose OSD has since changed (collections for the new
        # set already exist — _make_backend created them above)
        be.acting = list(meta_acting)
        be.shard_applied = list(applied)
        # divergent-log rewind (ref: PGLog::merge_log): this daemon's
        # own persisted log may hold entries the authoritative blob
        # does not — writes from a dead interval that never committed.
        # Those objects must be rolled back to authoritative state,
        # never served from the tainted local copy.
        if local_blob is not None and local_blob != blob:
            try:
                lbase, ldelta = local_blob
                ld, lv = self._meta_decoder(lbase)
                if lv >= 3:
                    ld.u64()
                lsizes = ld.mapping(Decoder.string, Decoder.u64)
                lvers = ld.mapping(Decoder.string, Decoder.u64)
                local_log = PGLog.decode(ld.blob())
                self._apply_meta_delta(ldelta, lsizes, lvers,
                                       local_log, [])
            except Exception:    # noqa: BLE001 — corrupt local blob:
                local_log = None  # nothing credible to rewind
            if local_log is not None:
                div = divergent_names(local_log, be.pg_log)
                if div and not share_history(local_log, be.pg_log):
                    # no entry agreement at all: interval
                    # DISCONTINUITY, not a stale tail — removing the
                    # "divergent" objects could delete the only copies
                    # (full-acting-set outage then virgin restart).
                    # QUARANTINE the bytes into a side collection:
                    # out of the data path AND out of repair's stray
                    # sweep (which would otherwise delete them on the
                    # next routine `pg repair`).
                    self._quarantine_divergent(ps, be, div)
                elif div:
                    try:
                        self._rewind_divergent(ps, be, div)
                    except Exception as e:  # noqa: BLE001 — a failed
                        # rewind must not block the takeover; retry on
                        # the next reconcile
                        self.c.log(f"{self.name}: pg 1.{ps} rewind "
                                   f"errored ({e}); queued for retry")
                        self._rewind_pending.setdefault(
                            ps, set()).update(div)
        # stripe-journal replay (r16): a primary crash mid-RMW leaves
        # intents on the participating shards — settle them (forward
        # or back, never torn) BEFORE this backend serves a single op.
        # Map-known-down and suspected OSDs are skipped up front (a
        # sync scan frame to a dead peer would stall a whole
        # op_timeout); shards that fail mid-scan are skipped the same
        # way, and the next reconcile's restore retries them.
        try:
            down = {o for o in range(len(self.osdmap.osd_up))
                    if not self.osdmap.osd_up[o]}
            rep = be.stripe_journal_replay(
                dead_osds=down | set(self.suspect))
            if rep["entries"]:
                self.c.log(f"{self.name}: pg 1.{ps} stripe-journal "
                           f"replay: {rep}")
        except (ConnectionError, OSError, KeyError) as e:
            self.c.log(f"{self.name}: pg 1.{ps} stripe-journal "
                       f"replay deferred: {e}")
        return be

    def _quarantine_divergent(self, ps: int, be,
                              names: list[str]) -> None:
        """Move dead-interval objects that share NO history with the
        authoritative log into `<pgid>.quarantine` on this daemon's
        own store — preserved for the operator (ceph_objectstore_tool
        export/inspect), invisible to reads, scrub, and the repair
        stray sweep."""
        from .pgbackend import HINFO_KEY
        pgid = f"1.{ps}"
        qcid = f"{pgid}.quarantine"
        moved = 0
        for name in sorted(names):
            for s in range(be.n):
                cid = shard_cid(be.pg, s)
                if not self.store.exists(cid, name):
                    continue
                data = self.store.read(cid, name)
                qoid = f"{name}@s{s}"
                t = (Transaction().create_collection(qcid)
                     .write(qcid, qoid, 0, data)
                     # truncate: a prior incident's longer quarantined
                     # copy must not leave stale tail bytes under the
                     # same oid
                     .truncate(qcid, qoid, len(data))
                     .remove(cid, name))
                try:
                    # preserve the integrity metadata with the bytes:
                    # the operator verifies the export against hinfo
                    hb = self.store.getattr(cid, name, HINFO_KEY)
                    t.setattr(qcid, qoid, HINFO_KEY, hb)
                except KeyError:
                    pass   # a raw dead-interval write may lack hinfo
                self.store.queue_transaction(t)
                moved += 1
        self.c.log(f"{self.name}: pg {pgid} local history shares no "
                   f"entries with the authoritative log; quarantined "
                   f"{moved} shard object(s) to {qcid} (operator: "
                   f"ceph_objectstore_tool export/inspect)")

    def _rewind_divergent(self, ps: int, be, names: list[str]) -> None:
        """Roll back writes only this daemon's dead interval logged
        (ref: PGLog merge_log divergent handling + missing-set repair).
        A name the authoritative history knows is ROLLED FORWARD from
        the authoritative copies (rewriting every shard converges the
        tainted one); a name it never committed is REMOVED from this
        daemon's own store — serving or resurrecting it would
        acknowledge a write the cluster never accepted. Leftovers are
        scanned across ALL of the PG's local collections: the
        takeover interval re-slotted the PG, so the divergent bytes
        sit in whatever slot this daemon held in the DEAD interval,
        not necessarily one the authoritative acting still assigns
        to it."""
        pending = self._rewind_pending.setdefault(ps, set())
        for name in sorted(names):
            if name in be.object_sizes:
                try:
                    data = be.read_objects(
                        [name], dead_osds={self.osd_id})[name]
                    be.write_objects(
                        {name: bytes(np.asarray(data, np.uint8)
                                     .tobytes())},
                        dead_osds=set(self.suspect))
                    pending.discard(name)
                    self.c.log(f"{self.name}: pg 1.{ps} rewound "
                               f"divergent {name!r} from "
                               f"authoritative copies")
                except Exception as e:   # noqa: BLE001 — retried on
                    pending.add(name)    # the next reconcile
                    self.c.log(f"{self.name}: pg 1.{ps} divergent "
                               f"{name!r} rewind deferred: {e}")
                continue
            for s in range(be.n):
                cid = shard_cid(be.pg, s)
                if self.store.exists(cid, name):
                    self.store.queue_transaction(
                        Transaction().remove(cid, name))
            pending.discard(name)
            self.c.log(f"{self.name}: pg 1.{ps} discarded divergent "
                       f"uncommitted {name!r}")
        if not pending:
            self._rewind_pending.pop(ps, None)

    def _on_map(self, peer: str, msg: MOSDMapMsg) -> None:
        with self._lock:
            if self.osdmap is not None \
                    and msg.epoch <= self.osdmap.epoch:
                return
            self._adopt_map_locked(OSDMap.decode(msg.map_bytes,
                                                 device=self.device))

    def _on_inc_map(self, peer: str, msg: MOSDIncMapMsg) -> None:
        """Delta fan-out arm of the map subscription: chain the
        incremental when it extends our epoch exactly; on any gap
        (fresh boot, missed broadcast, partition heal) ask the sender
        for a full map instead of guessing. The apply mutates a
        shallow CLONE and swaps — readers holding self.osdmap never
        see a half-applied epoch."""
        with self._lock:
            cur = self.osdmap
            if cur is not None and msg.epoch <= cur.epoch:
                return
            if cur is not None and msg.epoch == cur.epoch + 1:
                inc = Incremental.decode(msg.map_bytes)
                if inc.base_epoch == cur.epoch:
                    self.perf.inc("map_incs_applied")
                    self._adopt_map_locked(
                        inc.apply(cur.shallow_clone()))
                    return
            self.perf.inc("map_full_requests")
        try:
            self.msgr.send(peer, MOSDMapRequest(
                self.osdmap.epoch if self.osdmap is not None else 0))
        except (KeyError, OSError, ConnectionError):
            pass

    def _adopt_map_locked(self, newmap: OSDMap) -> None:
        """Land a newer map (full decode or chained incremental) —
        caller holds self._lock and has checked epoch monotonicity."""
        self.osdmap = newmap
        # an OSD the map marks UP again is no longer suspect and
        # may be REPORTED again on its next real failure (else a
        # revived OSD's second death would never reach the mon)
        now = time.monotonic()
        for osd in self.c.osd_ids():
            if osd != self.osd_id and not self.osdmap.osd_up[osd]:
                # no pings go to a down peer: its next life starts a
                # fresh unanswered-ping clock
                self._ping_unacked.pop(osd, None)
            if osd != self.osd_id and self.osdmap.osd_up[osd]:
                if osd in self._reported or osd in self.suspect:
                    self._ping_unacked.pop(osd, None)
                self._reported.discard(osd)
                self.suspect.discard(osd)
        # r17: fold the committed liveness into the repair policy's
        # DownClocks BEFORE reconciling — a down mark starts a
        # deferral window, a revive cancels the parked work and queues
        # the cursor re-check the reconcile below will consume. Only
        # an ADMIN out (`osd out`, sticky) confirms instantly: the
        # harness's automatic down+out rides EVERY down mark and is
        # exactly the transient evidence the delay exists to absorb.
        self.repair_policy.observe_map(
            self.osdmap.osd_up,
            out_osds=sorted(getattr(self.osdmap, "osd_admin_out",
                                    None) or ()),
            now=now, suspect=self.suspect)
        self._apply_central_config()
        self._reconcile()
        self.perf.set("osdmap_epoch", self.osdmap.epoch)
        self.perf.set("numpg", len(self.backends))

    def _apply_central_config(self) -> None:
        """Land the committed map's config KV at this daemon's "mon"
        config layer (ConfigMonitor -> md_config_t flow): sets fire
        observers only on resolved-value change, removed keys fall
        back to the file/default layers, unknown keys are logged and
        skipped (a newer cluster may ship options this daemon doesn't
        declare — the reference warns and continues the same way)."""
        kv = self.osdmap.config_kv
        for key, value in kv.items():
            if self._cfg_applied.get(key) == value:
                continue
            try:
                self.config.set(key, value, level="mon")
            except (KeyError, ValueError) as e:
                self.c.log(f"{self.name}: central config "
                           f"{key}={value!r} ignored: {e}")
            self._cfg_applied[key] = value
        for key in [k for k in self._cfg_applied if k not in kv]:
            try:
                self.config.rm(key, level="mon")
            except KeyError:
                pass
            del self._cfg_applied[key]
        # QoS knobs may have moved: re-resolve the mClock profile table
        # (live, no restart — the osd_mclock config-change path)
        self._refresh_mclock_profiles()

    def _reconcile(self) -> None:
        """Map changed: adopt/recover the PGs this daemon primaries
        (the PeeringState Get* exchange outcome, driven from the
        authoritative persisted metadata). Recovery is PLANNED here but
        EXECUTED by the mClock worker: every primaried PG's plan joins
        ONE cross-PG round whose fused batches interleave with client
        ops (the pre-r10 tree ran one blocking recover_shards per PG
        inside this loop, holding the daemon lock for the whole
        rebuild)."""
        new_plans: list[tuple[int, object, set[int]]] = []
        for ps in range(self.c.pg_num):
            # per-PG lock INSIDE the daemon lock (one global order):
            # client ops of this PG are excluded while its backend/
            # meta move; other PGs' ops keep flowing
            with self._pg_lock(ps):
                self._reconcile_pg(ps, new_plans)
        if new_plans:
            # r17 risk order: most exposed stripes first (fewest
            # surviving redundancy shards), r14 helper cost second,
            # PG id last — the runner drains batches in plan order,
            # so this IS the exposure schedule. 'pgid' keeps the
            # pre-r17 order selectable (the exposure A/B the bench
            # measures) but still counts the inversions it ships.
            from .repairpolicy import order_plans
            new_plans = order_plans(
                new_plans, self._plan_redundancy,
                mode=str(self.config["osd_repair_queue_order"]),
                counter=self.repair_policy._count)
            now_m = time.monotonic()
            for ps, plan, _dead in new_plans:
                self.repair_policy.note_exposure(
                    ps, self._plan_redundancy(ps, plan) <= 1,
                    now=now_m)
            rnd = _RecoveryRound(self, new_plans)
            for ps, _plan, _dead in new_plans:
                self._recovering[ps] = rnd
            self._sched_enqueue("background_recovery", rnd,
                                rnd.next_cost(), shard=rnd.shard())
        self._note_repair_gauges()

    def _plan_redundancy(self, ps: int, plan) -> int:
        """Surviving redundancy of one planned rebuild: failures the
        PG can still absorb while the plan is queued (EC: m - lost;
        replicated: spare copies). The risk key's first component."""
        be = self.backends.get(ps)
        if be is None:
            return 0
        return (be.n - be.min_live) - len(getattr(plan, "lost", ()))

    def _note_repair_gauges(self) -> None:
        self.perf.set("repair_parked_pgs",
                      len(self.repair_policy.parked))
        self.perf.set("repair_exposed_pgs",
                      self.repair_policy.exposed_pgs())

    def _reconcile_pg(self, ps: int, new_plans: list) -> None:
        """One PG's slice of _reconcile. Caller holds self._lock and
        the PG lock."""
        acting = self._acting(ps)
        if not acting or acting[0] != self.osd_id:
            if self.backends.pop(ps, None) is not None:
                # not ours (anymore): the new primary restores
                # snap/cls state from the PG metadata
                self.snapsets.pop(ps, None)
                self.births.pop(ps, None)
                self.obj_kv.pop(ps, None)
                self.scrub_reports.pop(ps, None)
                self._last_scrub.pop(ps, None)
                self._last_deep.pop(ps, None)
                self._meta_delta.pop(ps, None)
            self._interval_start.pop(ps, None)
            self._last_acting.pop(ps, None)
            # not our PG: drop any repair-policy bookkeeping for it
            # (the new primary re-derives its own)
            self.repair_policy.note_planned(ps)
            self.repair_policy.take_recheck(ps)
            self.repair_policy.note_exposure(ps, False,
                                             now=time.monotonic())
            return
        # interval detection: any acting change starts a NEW
        # INTERVAL whose primary must re-prove freshness — its
        # up_thru must reach the interval's start epoch before the
        # PG restores/recovers/serves (WaitUpThru; ref:
        # PeeringState::adjust_need_up_thru)
        if self._last_acting.get(ps) != acting:
            self._last_acting[ps] = list(acting)
            self._interval_start[ps] = self.osdmap.epoch
        need_ut = self._interval_start.get(ps, 0)
        if int(self.osdmap.osd_up_thru[self.osd_id]) < need_ut:
            self._request_up_thru(need_ut)
            return
        be = self.backends.get(ps)
        if be is None:
            now_m = time.monotonic()
            if now_m < self._restore_backoff.get(ps, 0.0):
                return          # recent below-quorum gather:
            #                     don't re-pay its RPC timeouts
            #                     on every map/heartbeat tick
            try:
                be = self._restore_backend(ps, acting)
            except (ConnectionError, OSError, KeyError) as e:
                # transient transport/auth trouble mid-restore
                # (cold tickets fail fast, a helper died): defer
                # with the same backoff as a below-quorum gather
                self.c.log(f"{self.name}: pg 1.{ps} restore "
                           f"deferred ({e})")
                self._restore_backoff[ps] = now_m + 2.0
                return
            if be is None:      # info gather below quorum:
                self._restore_backoff[ps] = now_m + 2.0
                return          # retried by the heartbeat tick
            self._restore_backoff.pop(ps, None)
            self.backends[ps] = be
            if getattr(be, "restored_from_blob", False):
                # ACTIVATION (the last_epoch_started role): stamp
                # this interval's epoch onto the acting members
                # BEFORE recovery starts or I/O is served — a
                # member of the old interval rejoining mid-
                # takeover must find the new interval's claim on
                # the quorum, or its longer dead-interval log
                # would win the info gather and resurrect
                # uncommitted writes (ref: PeeringState::activate)
                try:
                    self._persist_meta(ps)
                except Exception as e:  # noqa: BLE001
                    self.c.log(f"{self.name}: pg 1.{ps} "
                               f"activation persist failed: {e}")
        elif self._rewind_pending.get(ps):
            # a deferred divergent rewind retries on every map
            # change until its helpers are reachable
            self._rewind_divergent(
                ps, be, sorted(self._rewind_pending[ps]))
        if be.acting == acting:
            self._snap_trim(ps, be)   # snaps may have left the map
            # r17 lazy repair, the payoff branch: a parked OSD revived
            # inside its window and the map folded back to the old
            # acting — cancel cost is a CURSOR re-check, not a rebuild
            recheck = self.repair_policy.take_recheck(ps)
            if recheck:
                self._revive_recheck(ps, be, recheck, new_plans)
            rnd = self._recovering.get(ps)
            if rnd is not None and getattr(rnd, "failed", False):
                # a round died mid-way (helper lost, push refused):
                # re-plan THIS pg in full — helpers re-validate
                # against the current map, already-landed objects
                # re-verify cheaply through the fused pipeline
                n_osds = len(self.osdmap.osd_up)
                exclude = {
                    s for s, o in enumerate(be.acting)
                    if s not in rnd.lost_of(ps)
                    and (not _valid_osd(o, n_osds)
                         or o in self.suspect
                         or not self.osdmap.osd_up[o])}
                try:
                    plan = be.plan_recovery(
                        rnd.lost_of(ps), helper_exclude=exclude,
                        helper_costs=self._helper_costs(be))
                    self._recovering[ps] = None   # round pending
                    new_plans.append((ps, plan, set()))
                except (ValueError, ConnectionError, KeyError) as e:
                    self.c.log(f"{self.name}: pg 1.{ps} recovery "
                               f"retry deferred: {e}")
                    if isinstance(e, ValueError):
                        self._unsuspect_helpers(ps, be, rnd.lost_of(ps))
            if ps not in self._recovering:
                self._catch_up_lagging(ps, be, new_plans)
        if be.acting != acting:
            # a changed slot whose old OSD is still up is a MOVE
            # (CRUSH re-slotted a live member: copy the shard
            # bytes); only a dead old OSD is a LOSS (decode-rebuild
            # from helpers). Conflating them would overrun m.
            lost, moves = [], []
            n_osds = len(self.osdmap.osd_up)
            for s, (o, n) in enumerate(zip(be.acting, acting)):
                if o == n:
                    continue
                if not _valid_osd(n, n_osds):
                    # CRUSH couldn't fill this slot in the current
                    # (degraded) epoch — acting carries the
                    # ITEM_NONE sentinel. Addressing "osd.<2^31>"
                    # would KeyError mid-dispatch; leave the slot
                    # where it is and retry on a better map.
                    continue
                if _valid_osd(o, n_osds) \
                        and self.osdmap.osd_up[o] \
                        and o not in self.suspect:
                    moves.append((s, o, n))
                else:
                    # dead old holder — or a hole: a slot born
                    # unfillable has no old bytes anywhere and
                    # must decode-rebuild, not copy
                    lost.append(s)
            # r17 lazy repair: while EVERY dead old holder is inside
            # its osd_repair_delay window (down_deferred) and no
            # override fires (m-1 exposure, stripe budget, out mark),
            # PARK this PG's rebuild — plan nothing, move nothing.
            # Holes (slots born unfillable) never defer: there is no
            # OSD to wait for. Deferral re-evaluates on every map fold
            # and heartbeat reconcile, so the window expiring, a
            # second failure, or a revive all resolve it within a beat.
            if lost:
                dead_hold = {be.acting[s] for s in lost
                             if _valid_osd(be.acting[s], n_osds)}
                holes = len(dead_hold) < len(lost)
                fresh_park = ps not in self.repair_policy.parked
                if (not holes
                        and self.repair_policy.should_defer(
                            ps, dead_hold, len(lost),
                            be.n - be.min_live,
                            max(1, len(be.object_sizes)))):
                    if fresh_park:
                        self.c.log(
                            f"{self.name}: pg 1.{ps} rebuild parked "
                            f"(lazy repair, dead={sorted(dead_hold)}, "
                            f"delay="
                            f"{self.config['osd_repair_delay']}s)")
                    return
            # r21 capacity gate: a rebuild writes a full shard into
            # every replacement target — parking while a target sits
            # at/over backfillfull is what keeps recovery from driving
            # a nearly-full OSD through the FULL cliff. Re-evaluated
            # every reconcile (flag clears / CRUSH repoints resolve it
            # within a beat); an m-1 stripe overrides — losing the
            # stripe is strictly worse than the space risk.
            if lost:
                blocked = sorted(
                    acting[s] for s in lost
                    if _valid_osd(acting[s], n_osds)
                    and self.osdmap.full_state_of(acting[s])
                    >= FULL_BACKFILLFULL)
                if blocked:
                    urgent = (be.n - be.min_live) - len(lost) <= 1
                    if not urgent:
                        if ps not in self._bff_parked:
                            self._bff_parked.add(ps)
                            self.repair_policy._count(
                                "repair_backfillfull_parked")
                            self.c.log(
                                f"{self.name}: pg 1.{ps} rebuild "
                                f"parked (targets {blocked} "
                                f"backfillfull)")
                        return
                    self.c.log(f"{self.name}: pg 1.{ps} rebuild into "
                               f"backfillfull {blocked} (m-1 urgent "
                               f"override)")
                self._bff_parked.discard(ps)
            # an acting change subsumes any queued revive re-check
            # (the move/loss handling below re-derives freshness)
            self.repair_policy.take_recheck(ps)
            try:
                for s, o, n in moves:
                    self._move_shard(be, s, o, n)
                if lost:
                    self.repair_policy.note_planned(ps)
                    repl = {s: acting[s] for s in lost}
                    dead = {be.acting[s] for s in lost}
                    exclude = {
                        s for s, o in enumerate(be.acting)
                        if s not in lost
                        and (not _valid_osd(o, n_osds)
                             or o in self.suspect
                             or not self.osdmap.osd_up[o])}
                    # plan now (validates helpers, repoints the
                    # lost slots so new client writes reach the
                    # rebuilding store directly); the mClock
                    # worker executes the batches. The recovering
                    # marker goes up IN THE SAME locked breath as
                    # the acting mutation — wait_for_clean polls
                    # unlocked and must never see a repointed
                    # acting without the in-flight marker.
                    # Replicated pools have no fused decode plan:
                    # their push-based recover_shards runs inline
                    # (the pre-r10 path; copies, not decodes).
                    if hasattr(be, "plan_recovery"):
                        plan = be.plan_recovery(
                            lost, replacement_osds=repl,
                            helper_exclude=exclude,
                            helper_costs=self._helper_costs(be))
                        self._recovering[ps] = None  # round pending
                        new_plans.append((ps, plan, dead))
                    else:
                        be.recover_shards(lost,
                                          replacement_osds=repl,
                                          helper_exclude=exclude)
                        self.suspect -= dead
                        self.perf.inc("recovery_rounds")
                self._persist_meta(ps)
            except (ValueError, ConnectionError, KeyError) as e:
                self.c.log(f"{self.name}: pg 1.{ps} recovery "
                           f"deferred: {e}")
                if isinstance(e, ValueError):
                    self._unsuspect_helpers(ps, be, lost)

    def _unsuspect_helpers(self, ps: int, be, lost) -> None:
        """A rebuild that found too few helpers while it excluded peers
        the map holds up only because this daemon suspects them: clear
        those suspicions, so that the next reconcile (a heartbeat's,
        within a second) plans with them, as the metadata gather's
        starved quorum does. Suspicion from a store op that timed out
        under load otherwise stands until the next map epoch, and once
        the maps go quiet the PG never recovers; a peer that really is
        unreachable fails the round's fetch instead, until the
        monitors mark it down. Caller holds self._lock and the PG
        lock."""
        n_osds = len(self.osdmap.osd_up)
        cleared = sorted(
            o for s, o in enumerate(be.acting)
            if s not in lost and o != self.osd_id and o in self.suspect
            and _valid_osd(o, n_osds) and self.osdmap.osd_up[o])
        if cleared:
            self.suspect.difference_update(cleared)
            self.c.log(f"{self.name}: pg 1.{ps} rebuild short of "
                       f"helpers: suspicion of up {cleared} cleared")

    def _revive_recheck(self, ps: int, be, revived: set[int],
                        new_plans: list) -> None:
        """Cancel cost of lazy repair: for every slot whose OSD came
        back inside its deferral window, walk the PG log from the
        slot's applied cursor (the cursor/version re-check). A quiet
        window proves the shard current — ZERO bytes move, counted in
        repair_cancel_noop. Writes that landed inside the window
        replay through the existing names= delta-recovery path (only
        the missed objects, not a rebuild). A log trimmed past the
        cursor cannot prove either way and falls back to a full plan.
        Caller holds self._lock and the PG lock."""
        slots = [s for s, o in enumerate(be.acting) if o in revived]
        if not slots:
            self.repair_policy.note_recheck(0)
            return
        names: set[str] | None = set()
        for s in slots:
            missing = be.pg_log.missing_since(be.shard_applied[s])
            if missing is None:
                names = None            # log trimmed: full rebuild
                break
            names.update(missing)
        if names is not None and not names:
            self.repair_policy.note_recheck(0)
            self.c.log(f"{self.name}: pg 1.{ps} parked rebuild "
                       f"cancelled by revive (cursor re-check clean, "
                       f"0 bytes)")
            return
        n_catchup = len(names) if names is not None \
            else len(be.object_sizes)
        self.repair_policy.note_recheck(n_catchup)
        try:
            if hasattr(be, "plan_recovery"):
                plan = be.plan_recovery(
                    slots,
                    names=sorted(names) if names is not None else None,
                    helper_costs=self._helper_costs(be))
                self._recovering[ps] = None      # round pending
                new_plans.append((ps, plan, set()))
            else:
                be.recover_shards(
                    slots,
                    names=sorted(names) if names is not None else None)
                self.perf.inc("recovery_rounds")
            self.c.log(f"{self.name}: pg 1.{ps} revive catch-up: "
                       f"{n_catchup} object(s) missed inside the "
                       f"window")
        except (ValueError, ConnectionError, KeyError) as e:
            self.c.log(f"{self.name}: pg 1.{ps} revive catch-up "
                       f"deferred: {e}")

    def _lagging_slots(self, be) -> list[int]:
        """Acting slots whose OSD is up and unsuspected but whose
        applied cursor is behind the PG log head: they missed writes
        acked while their OSD was suspected (writes skip suspects)."""
        n_osds = len(self.osdmap.osd_up)
        return [s for s, o in enumerate(be.acting)
                if _valid_osd(o, n_osds) and self.osdmap.osd_up[o]
                and o not in self.suspect
                and be.shard_applied[s] < be.pg_log.head]

    def _catch_up_lagging(self, ps: int, be, new_plans: list) -> None:
        """Replay the objects a lagging slot missed through the names=
        delta recovery, as a revive's cursor re-check does. Without it
        the slot stays stale for good: a cursor with a gap never
        advances on later writes, so reads and scrubs route around the
        shard while the PG reports clean. Caller holds self._lock and
        the PG lock."""
        slots = self._lagging_slots(be)
        if not slots:
            return
        names: set[str] | None = set()
        for s in slots:
            missing = be.pg_log.missing_since(be.shard_applied[s])
            if missing is None:
                names = None            # log trimmed: full rebuild
                break
            names.update(missing)
        todo = sorted(names) if names is not None else None
        n_osds = len(self.osdmap.osd_up)
        exclude = {s for s, o in enumerate(be.acting)
                   if s not in slots
                   and (not _valid_osd(o, n_osds) or o in self.suspect
                        or not self.osdmap.osd_up[o])}
        try:
            if hasattr(be, "plan_recovery"):
                plan = be.plan_recovery(
                    slots, names=todo, helper_exclude=exclude,
                    helper_costs=self._helper_costs(be))
                self._recovering[ps] = None      # round pending
                new_plans.append((ps, plan, set()))
            else:
                be.recover_shards(slots, names=todo)
                self.perf.inc("recovery_rounds")
            self.c.log(f"{self.name}: pg 1.{ps} catch-up of lagging "
                       f"slots {slots}: "
                       f"{len(todo) if todo is not None else 'all'} "
                       f"object(s)")
        except (ValueError, ConnectionError, KeyError) as e:
            self.c.log(f"{self.name}: pg 1.{ps} catch-up deferred: {e}")

    def _request_up_thru(self, want: int) -> None:
        """Ask every monitor to record our up_thru through `want` (the
        MOSDAlive flow): broadcast so whoever leads proposes; the
        committed map comes back via the normal subscription and the
        next reconcile finds the interval activatable. Re-sent on
        every reconcile while the window is open — a request consumed
        by a monitor that lost leadership must not strand the PG."""
        for mon_name in self.c.mon_names():
            try:
                self.msgr.send(mon_name, MOSDAlive(self.osd_id, want))
            except (KeyError, OSError, ConnectionError):
                pass

    def _move_shard(self, be, slot: int, old_osd: int,
                    new_osd: int) -> None:
        """Backfill-by-copy for a re-slotted LIVE member: pull the
        shard's bytes from the old holder, push to the new one — all
        as store-op frames (the backfill push role)."""
        from .pgbackend import HINFO_KEY
        cid = shard_cid(be.pg, slot)
        src = be.cluster.osd(old_osd)
        dst = be.cluster.osd(new_osd)
        t = Transaction().create_collection(cid)
        moved_objs = moved_bytes = 0
        for name in be.list_pg_objects():
            if not src.exists(cid, name):
                continue
            data = np.asarray(src.read(cid, name), np.uint8)
            t.write(cid, name, 0, data).truncate(cid, name, len(data))
            moved_objs += 1
            moved_bytes += len(data)
            try:
                t.setattr(cid, name, HINFO_KEY,
                          src.getattr(cid, name, HINFO_KEY))
            except KeyError:
                pass
        dst.queue_transaction(t)
        # repair-traffic accounting (r17): backfill copies are repair
        # bytes too — the storm bench sums them with recovered_bytes
        self.perf.inc_many((("move_objects", moved_objs),
                            ("move_bytes", moved_bytes)))
        be.acting[slot] = new_osd
        self.c.log(f"{self.name}: pg {be.pg} slot {slot} moved "
                   f"osd.{old_osd} -> osd.{new_osd}")

    # -- client ops ----------------------------------------------------------

    def _init_observability(self) -> None:
        """Fresh OpTracker + PerfCounters — called at boot AND on
        revive (in-RAM observability dies with the process, like a
        real restart); ONE list of counter keys so the two paths
        cannot drift. The OpTracker resolves its thresholds through
        this daemon's layered config (osd_op_complaint_time /
        osd_op_history_*), so a committed `config set` retunes it
        live."""
        from ..utils.flight_recorder import FlightRecorder
        from ..utils.op_tracker import OpTracker
        from ..utils.perf_counters import PerfCountersBuilder
        from .ecbackend import ec_perf_counters
        self.op_tracker = OpTracker(config=self.config)
        # per-daemon flight recorder (r15): bounded ring of finished
        # trace spans, in-RAM like the rest of the observability plane
        # (dies with the process; rebuilt here on revive). Dumped via
        # `trace dump`, drained into MgrReports for the mon assembler.
        self.flight = FlightRecorder(self.name, config=self.config)
        b = PerfCountersBuilder(f"osd.{self.osd_id}")
        for key in ("op", "op_r", "op_w", "op_in_bytes",
                    "op_out_bytes"):
            b.add_u64_counter(key)
        (b.add_u64_counter("subop", "store sub-ops served")
         .add_u64_counter("subop_in_bytes", "store sub-op bytes in")
         .add_u64_counter("subop_out_bytes", "store sub-op bytes out")
         .add_u64_counter("recovery_rounds",
                          "reconcile-driven recovery passes")
         .add_u64_counter("cephx_refresh_kicked",
                          "background ticket refreshes started")
         .add_u64_counter("cephx_refresh_coalesced",
                          "refresh requests folded into an already "
                          "running single-flight fetch")
         .add_u64_counter("authorize_deferred",
                          "dispatch-path authorizes failed fast on a "
                          "cold ticket cache")
         .add_u64_counter("mgr_reports_tx", "MgrReports shipped")
         .add_u64_counter("op_degraded_read",
                          "objects served through the degraded-read "
                          "fast path (any-k decode, peering bypassed)")
         .add_u64_counter("degraded_view_builds",
                          "read-only degraded views built (meta "
                          "gather + decode, non-primary serves)")
         .add_time_avg("degraded_read_time",
                       "degraded-read service time (gather + any-k "
                       "decode)")
         .add_u64_counter("op_shard_grants",
                          "ops granted by shard workers (all shards; "
                          "per-shard split in dump_op_shards)")
         .add_u64("op_shard_depth",
                  "ops queued across all op shards right now")
         .add_u64("op_shard_imbalance",
                  "grant spread across shards (max-min served — the "
                  "PG-hash skew signal)")
         .add_u64_counter("move_objects",
                          "objects copied by backfill-by-copy shard "
                          "moves (a re-slotted LIVE member)")
         .add_u64_counter("move_bytes",
                          "bytes copied by backfill-by-copy shard "
                          "moves (with ec.recovered_bytes and "
                          "ec.recover_wire_bytes: the repair-traffic "
                          "total the r17 policy plane prices)")
         .add_u64("repair_parked_pgs",
                  "PGs whose rebuild is parked behind "
                  "osd_repair_delay right now (lazy repair)")
         .add_u64("repair_exposed_pgs",
                  "PGs at m-1 surviving redundancy right now (the "
                  "PG_EXPOSED health source; risk ordering drains "
                  "these first)")
         .add_u64("numpg", "PGs this daemon primaries")
         .add_u64("osdmap_epoch", "newest folded map epoch")
         .add_u64_counter("map_incs_applied",
                          "incremental OSDMaps chained onto the "
                          "current epoch (delta fan-out path)")
         .add_u64_counter("map_full_requests",
                          "full-map requests sent after an "
                          "unchainable incremental (gap/fresh boot)")
         .add_time_avg("op_latency",
                       "client op wall time (tracker enter to reply "
                       "built)", hist=True)
         .add_time_avg("op_r_latency",
                       "read-kind client op wall time (the "
                       "client_read SLO feed)", hist=True)
         .add_time_avg("op_w_latency",
                       "write-kind client op wall time (the "
                       "client_write SLO feed)", hist=True)
         .add_time_avg("subop_latency", "store sub-op service time",
                       hist=True)
         .add_u64("trace_dropped_unshipped",
                  "flight-ring spans evicted before an MgrReport "
                  "shipped them (persistent growth -> "
                  "TRACE_RING_OVERFLOW)")
         .add_u64_counter("retro_subop_published",
                          "retro.subop spans published from the "
                          "sub-op retro ring on a peer's slow-op "
                          "fan-out")
         .add_u64_counter("writes_rejected_full",
                          "mutating client ops bounced for capacity "
                          "(failsafe hard-stop or map FULL flag) — "
                          "each bounce parks the client, it never "
                          "surfaces as an op_error")
         # r22 network observability: the DECLARED aggregate over all
         # peer links (per-link detail is dynamic-keyed, so it rides
         # the MgrReport "network" side-field, never counter names)
         .add_time_avg("hb_ping_rtt",
                       "heartbeat ping round trip, all peer links "
                       "folded (per-link lhists ride the report's "
                       "network block into the mon NetworkAggregator)",
                       hist=True)
         .add_u64_counter("net_helper_penalties",
                          "helper-cost slots where the hb-RTT link "
                          "feed (r22) raised the cost above the "
                          "store/client view — the planner saw the "
                          "wire, not just the service time"))
        # r17 repair-policy counters: declared from the policy
        # module's ONE list so the daemon schema and the policy's own
        # counter dict cannot drift (the r9 declared-names rule)
        from .repairpolicy import POLICY_COUNTERS
        for key in POLICY_COUNTERS:
            b.add_u64_counter(key, "repair policy plane (r17) — see "
                                   "osd/repairpolicy.py")
        self.perf = b.create_perf_counters()
        # ONE "ec" logger shared by every PG backend this daemon
        # hosts (per-PG loggers would explode the metric space)
        self.ec_perf = ec_perf_counters()
        # MgrReport delta stream state (see mgr/reports.py)
        self._mgr_seq = 0
        self._mgr_last_perf: dict | None = None
        self._mgr_last_sent = 0.0
        # r18 telemetry plane: per-interval counter/histogram deltas,
        # bounded, live-tuned (mgr_history_interval/_len); entries
        # drain into MgrReports, `perf history` answers locally
        from ..utils.perf_counters import MetricsHistory
        self.metrics_history = MetricsHistory(self.perf_dump_all,
                                              config=self.config)
        # r19 continuous CPU profiling: a dedicated sampler thread
        # folds every thread's stack into span-tagged collapsed
        # stacks at daemon_profile_hz (live; 0 = off). In-RAM like
        # the rest of the plane — a revive gets a fresh profile.
        from ..utils.profiler import SamplingProfiler
        self.profiler = SamplingProfiler(self.name,
                                         config=self.config).start()
        # r22 network observability: per-(peer, channel) RTT fold —
        # in-RAM like the rest of the plane (a revive measures fresh;
        # _init_observability runs on both paths). Pong fast dispatch
        # and store RPC completions feed it; the heartbeat ships it.
        from ..mgr.netobs import LinkTracker
        self.link_tracker = LinkTracker(perf=self.perf)
        # peers currently flagged slow-link (hysteresis for the r17
        # DownClock evidence: flag at threshold, clear at half)
        self._slow_links: set[int] = set()
        # r18 sub-op retro ring (the r15 replica gap): completed store
        # sub-ops remembered by carried trace id so a primary's slow-op
        # retro assembly can pull this hop's timing after the fact
        # (retro_publish). In-RAM, dies with the process like the
        # flight ring.
        self._subop_ring: list[dict] = []
        self._subop_ring_lock = threading.Lock()

    # -- perf dump assembly (admin socket + wire admin op + MgrReport) -------

    def perf_dump_all(self) -> dict:
        """Every logger this daemon owns, keyed the way `ceph daemon
        osd.N perf dump` shows them. Assembled ONLY from declared
        PerfCounters dumps — the counter-name smoke test depends on
        that."""
        out = {self.perf.name: self.perf.dump(),
               "msgr": self.msgr.perf.dump(),
               "rpc": self.rpc.perf.dump(),
               "ec": self.ec_perf.dump()}
        if self._cauth is not None:
            out["cephx"] = self._cauth.perf.dump()
        kvp = getattr(self.store, "kv_perf", None)
        if kvp is not None:
            out["tindb"] = kvp.dump()
        return out

    def perf_schema_all(self) -> dict:
        out = {self.perf.name: self.perf.schema(),
               "msgr": self.msgr.perf.schema(),
               "rpc": self.rpc.perf.schema(),
               "ec": self.ec_perf.schema()}
        if self._cauth is not None:
            out["cephx"] = self._cauth.perf.schema()
        kvp = getattr(self.store, "kv_perf", None)
        if kvp is not None:
            out["tindb"] = kvp.schema()
        return out

    def perf_reset_all(self) -> None:
        self.perf.reset()
        self.msgr.perf.reset()
        self.rpc.perf.reset()
        self.ec_perf.reset()
        if self._cauth is not None:
            self._cauth.perf.reset()
        kvp = getattr(self.store, "kv_perf", None)
        if kvp is not None:
            kvp.reset()
        # the delta stream re-bases: a reset between two deltas would
        # otherwise ship huge negative deltas the aggregator folds
        # into nonsense
        self._mgr_last_perf = None

    _READ_KINDS = frozenset({"read", "readv", "read_degraded",
                             "snap_read", "admin"})

    _ADMIN_CMDS = ("perf dump", "perf reset", "perf schema",
                   "perf history",
                   "dump_historic_ops",
                   "dump_historic_ops_by_duration",
                   "dump_ops_in_flight", "slow_ops", "pg stat",
                   "pg clean",
                   "dump_mclock", "dump_op_shards", "dump_scrubs",
                   "dump_repair", "dump_osd_network",
                   "log dump",
                   "config show",
                   "config diff", "trace start", "trace stop",
                   "trace dump", "profile",
                   "status")

    def _pg_states(self) -> dict:
        """pg_state strings for the PGs this daemon primaries, through
        the GetInfo/GetLog/GetMissing classifier (the `ceph pg stat`
        slice a primary can answer; ref: PeeringState pg_state_t
        names). Caller holds self._lock."""
        from .peering import peer as _peer
        if self.osdmap is None:
            return {}
        alive = [bool(u) and o not in self.suspect
                 for o, u in enumerate(self.osdmap.osd_up)]
        my_ut = int(self.osdmap.osd_up_thru[self.osd_id])
        n_osds = len(alive)
        out = {}
        for ps, be in sorted(self.backends.items()):
            state = _peer(
                be, alive, compute_missing=False,
                interval_start=self._interval_start.get(ps, 0),
                up_thru=my_ut).state
            # r17: "+exposed" marks a PG at m-1 surviving redundancy
            # (one more failure loses data) — the PG_EXPOSED health
            # source, and what risk-ordered recovery drains first
            lost = sum(1 for o in be.acting
                       if not _valid_osd(o, n_osds) or not alive[o])
            if lost and (be.n - be.min_live) - lost <= 1:
                state += "+exposed"
            out[f"1.{ps}"] = state
        return out

    def _pool_bytes(self) -> dict:
        """Logical bytes per pool across the PGs this daemon primaries
        (the pg_stat_t num_bytes slice the autoscaler's capacity
        shares derive from; primaries-only so the cluster aggregate
        counts each object once, not size times). Caller holds
        self._lock. JSON-string pool keys — the report rides JSON."""
        total = sum(sum(be.object_sizes.values())
                    for be in self.backends.values())
        return {"1": int(total)} if self.backends else {}

    def _pool_objects(self) -> dict:
        """Object count per pool across primaried PGs (the
        pg_stat_t num_objects slice quota_max_objects is enforced
        against at the mon). Caller holds self._lock."""
        total = sum(len(be.object_sizes)
                    for be in self.backends.values())
        return {"1": int(total)} if self.backends else {}

    def _failsafe_gate(self, ps: int) -> None:
        """r21 osd_failsafe_full_ratio hard-stop (ref: OSDService::
        check_failsafe_full): statfs ratio at/over the failsafe bounces
        every mutating client op with the retryable park pattern. Local
        statfs only — deliberately map-independent, so it holds during
        the stale-map window before the mon ladder commits FULL."""
        try:
            st = self.store.statfs()
        except Exception:
            return
        total = int(st.get("total", 0))
        if not total:
            return                      # unbounded store: no ladder
        ratio = float(self.config["osd_failsafe_full_ratio"])
        if int(st.get("used", 0)) < ratio * total:
            return
        self.perf.inc("writes_rejected_full")
        raise RuntimeError(
            f"pg 1.{ps} osd.{self.osd_id} failsafe full "
            f"({st['used']}/{total} >= {ratio:.2f}, "
            f"epoch {self.osdmap.epoch})")

    def _admin_obj(self, cmd: str):
        """ONE dispatcher for both admin surfaces — the wire `admin`
        MOSDOp and the Unix admin socket (ref: src/common/
        admin_socket.cc registering OpTracker/PerfCounters/log
        commands) — so the two can't drift."""
        from ..utils.log import g_log
        if cmd == "perf dump":
            return self.perf_dump_all()
        if cmd == "perf schema":
            return self.perf_schema_all()
        if cmd == "perf reset":
            self.perf_reset_all()
            return {"success": True}
        if cmd.startswith("perf history"):
            # the r18 metric-history ring: per-interval deltas,
            # optional trailing-entry limit
            arg = cmd[len("perf history"):].strip()
            return self.metrics_history.dump(
                limit=int(arg) if arg else None)
        if cmd == "dump_historic_ops":
            return self.op_tracker.dump_historic_ops()
        if cmd == "dump_historic_ops_by_duration":
            return self.op_tracker.dump_historic_ops(by_duration=True)
        if cmd == "dump_ops_in_flight":
            return self.op_tracker.dump_ops_in_flight()
        if cmd == "slow_ops":
            return {"slow_ops": self.op_tracker.slow_ops(),
                    "complaint_time": self.op_tracker.complaint_time}
        if cmd == "log dump":
            # the gathered ring (more detail than was ever printed) —
            # during chaos runs the Thrasher's seed-stamped events are
            # in here, so this reconstructs the fault timeline
            return {"lines": g_log.dump_recent()}
        if cmd == "config show":
            return self.config.dump()
        if cmd == "config diff":
            return self.config.diff()
        if cmd.startswith("trace dump"):
            # the flight-recorder ring (r15): finished per-op trace
            # spans, optionally filtered to one trace id (hex)
            arg = cmd[len("trace dump"):].strip() or None
            return self.flight.dump(trace_id=arg)
        if cmd.startswith("profile"):
            # the r19 CPU sampler's cumulative span-tagged profile
            # (this daemon only; the cluster fold is the monitors'
            # `profile cpu`). `profile --collapsed` emits folded-
            # stack text instead of the raw category->stack counts.
            from ..utils.profiler import (category_split,
                                          collapsed_lines)
            dump = self.profiler.dump()
            if "--collapsed" in cmd:
                return {"name": self.name,
                        "collapsed": collapsed_lines(dump["stacks"])}
            dump["categories"] = category_split(dump["stacks"])
            return dump
        if cmd.startswith("trace start"):
            from ..utils.tracing import start_trace
            log_dir = cmd[len("trace start"):].strip() \
                or f"/tmp/{self.name}-trace"
            return {"started": start_trace(log_dir), "dir": log_dir}
        if cmd == "trace stop":
            from ..utils.tracing import stop_trace
            return {"stopped": stop_trace()}
        if cmd == "dump_mclock":
            # per-class occupancy + grants, tenant classes included,
            # MERGED across op shards (the pre-shard shape — tools
            # iterate class names at the top level)
            return self.sched_dump()
        if cmd == "dump_op_shards":
            # per-shard detail: the hash-spread view the merged
            # dump_mclock deliberately hides
            return self.shard_dump()
        if cmd == "dump_scrubs":
            with self._lock:   # heartbeat inserts concurrently
                return {"scrubs": {f"1.{ps}": r for ps, r in
                                   sorted(self.scrub_reports.items())}}
        if cmd == "dump_repair":
            # the r17 repair policy plane: DownClocks, parked
            # rebuilds, exposure + deferral counters, and the
            # per-failure-domain token buckets
            with self._lock:
                return {"policy": self.repair_policy.dump(),
                        "domains": self.domain_budgets.dump()}
        if cmd == "dump_osd_network":
            # the r22 link plane, THIS daemon's slice (ref: the
            # identically named OSD admin command): its own measured
            # links + flow ledger + any active injected degrades.
            # The cluster matrix is the monitors' dump_osd_network.
            return {
                "name": self.name,
                "threshold_ms": round(
                    self._slow_ping_threshold_s() * 1e3, 3),
                "links": self.link_tracker.dump(),
                "flow": self.msgr.flow_dump(),
                "slow_links": sorted(self._slow_links),
                "link_delays": self.msgr.link_delays(),
            }
        if cmd == "status":
            with self._lock:
                return {
                    "name": self.name,
                    "osdmap_epoch": self.osdmap.epoch
                    if self.osdmap is not None else 0,
                    "num_pgs": len(self.backends),
                    "suspect": sorted(self.suspect),
                    "store": type(self.store).__name__,
                }
        if cmd == "pg stat":
            with self._lock:
                return {"pgs": self._pg_states()}
        if cmd == "pg clean":
            # per-primaried-PG cleanliness, the wait_for_clean slice
            # one daemon can answer — the multi-process harness polls
            # this over the asok (it cannot reach into a child's RAM)
            with self._lock:
                if self.osdmap is None:
                    return {}
                out = {}
                for ps, be in self.backends.items():
                    acting = self._acting(ps)
                    out[f"1.{ps}"] = (bool(acting)
                                      and acting[0] == self.osd_id
                                      and be.acting == acting
                                      and ps not in self._recovering
                                      and not self._lagging_slots(be))
                return out
        raise ValueError(f"unknown admin command {cmd!r}; "
                         f"known: {list(self._ADMIN_CMDS)}")

    def _admin_cmd(self, cmd: str) -> bytes:
        """`ceph daemon osd.N <cmd>` over the wire."""
        import json as _json
        return _json.dumps(self._admin_obj(cmd), sort_keys=True,
                           default=str).encode()

    def _on_auth(self, peer: str, msg: MAuthOp) -> None:
        """Session establishment (ref: CephxAuthorizeHandler via
        ms_verify_authorizer): verify the presented service ticket
        (challenge round first — anti-replay), bind (entity, caps) to
        the transport peer, prove possession of the rotating secret
        back (mutual auth)."""
        import json as _json
        rep = _daemon_authorize(
            self.verifier, _json.loads(msg.blob.decode()), peer,
            msg.req_id, self._authed,
            lambda: self.c.key_server.export_rotating("osd"))
        try:
            self.msgr.send(peer, rep)
        except (KeyError, OSError, ConnectionError):
            pass

    def _auth_gate(self, peer: str, need: str) -> str | None:
        """None = allowed; else the EPERM reply string. ONE gate for
        both the client-op and store planes — RemoteStore._call and
        Client._op string-match these exact errors for their
        re-authorize retries (ref: OSDCap is_capable)."""
        sess = self._authed.get(peer)
        if sess is None:
            return "EPERM:unauthenticated"
        caps = sess["caps"].get("osd")
        # this tier serves ONE pool, named "default" (pool id 1), so
        # pool-scoped grants (`allow rw pool=default`) resolve here
        if caps is None or not caps.allows(need, pool="default"):
            return (f"EPERM:denied need {need} "
                    f"(entity {sess['entity']})")
        return None

    @staticmethod
    def _op_need(kind: str) -> str:
        return "x" if kind == "cls" else \
            ("r" if kind in OSDDaemon._READ_KINDS else "w")

    def _on_client_op(self, peer: str, msg: MOSDOp) -> None:
        sub_ops: list[tuple[str, bytes]] | None = None
        if msg.kind == "batch":
            # coalesced dispatch (one frame, many PG ops — the client
            # groups small ops to the same primary): decode sub-ops up
            # front so caps are gated per sub-op need before anything
            # executes
            try:
                d = Decoder(msg.blob)
                sub_ops = d.list(
                    lambda dd: (dd.string(), dd.blob()))
            except Exception as e:   # noqa: BLE001 — reply, don't die
                try:
                    self.msgr.send(peer, MOSDOpReply(
                        msg.req_id, False, msg.kind,
                        err=f"{type(e).__name__}:{e}"))
                except (KeyError, OSError, ConnectionError):
                    pass
                return
        if self.verifier is not None:
            needs = {self._op_need(k) for k, _ in sub_ops} \
                if sub_ops is not None else {self._op_need(msg.kind)}
            deny = next((d for d in (self._auth_gate(peer, n)
                                     for n in sorted(needs))
                         if d is not None), None)
            if deny is not None:
                try:
                    self.msgr.send(peer, MOSDOpReply(
                        msg.req_id, False, msg.kind, err=deny))
                except (KeyError, OSError, ConnectionError):
                    pass
                return
        if msg.kind == "admin":
            # the operator side door bypasses the op queue (like the
            # asok): it must answer even when the queue is wedged.
            # Own thread — some admin views take the daemon lock,
            # which a mid-reconcile fold can hold for remote-rpc
            # timescales, and a reactor must never wait that out
            def _serve_admin():
                try:
                    d = Decoder(msg.blob)
                    rep = MOSDOpReply(msg.req_id, True, msg.kind,
                                      self._admin_cmd(d.string()))
                except Exception as e:  # noqa: BLE001 — reply, don't
                    rep = MOSDOpReply(msg.req_id, False, msg.kind,
                                      err=f"{type(e).__name__}:{e}")
                try:
                    self.msgr.send(peer, rep)
                except (KeyError, OSError, ConnectionError):
                    pass
            threading.Thread(target=_serve_admin, daemon=True).start()
            return
        # mClock SHARDED admission: PG ops hash by their leading PG id
        # to an op shard and queue under their QoS class; each shard
        # worker drains in tag order — during recovery a client op
        # waits behind at most one recovery batch grant OF ITS SHARD,
        # not the whole rebuild, and ops to independent PGs dispatch
        # concurrently. Client ops land in their PER-TENANT class (one
        # per client entity per shard), so a heavy tenant — hedged
        # duplicates and degraded decodes included — competes under
        # its own (ρ, w, λ) tags instead of starving the rest.
        t_enq = time.time()     # r15: the osd.queue span's start mark
        if sub_ops is None:
            shard = self._shard_of(self._op_ps(msg.blob))
            cls = "scrub" if msg.kind in ("deep_scrub", "repair") \
                else self._client_class(peer, shard)
            self._sched_enqueue(
                cls, lambda: self._serve_client_op(peer, msg, None,
                                                   t_enq=t_enq),
                shard=shard)
            return
        # batch frame: split the sub-ops by shard (a batch groups by
        # PRIMARY, so one frame may span PGs in different shards);
        # every shard executes its slots FIFO — per-PG order holds —
        # and the last shard to finish assembles + sends the reply
        groups: dict[int, list] = {}
        for slot, (kind, body) in enumerate(sub_ops):
            sh = self._shard_of(self._op_ps(body))
            groups.setdefault(sh.idx, []).append((slot, kind, body))
        if len(groups) == 1:
            shard = self.op_shards[next(iter(groups))]
            cls = self._client_class(peer, shard)
            self._sched_enqueue(
                cls, lambda: self._serve_client_op(peer, msg, sub_ops,
                                                   t_enq=t_enq),
                shard=shard)
            return
        join = _BatchJoin(self, peer, msg, len(sub_ops), len(groups),
                          t_enq=t_enq)
        for idx, items in groups.items():
            shard = self.op_shards[idx]
            cls = self._client_class(peer, shard)
            self._sched_enqueue(
                cls, lambda items=items: join.run(items), shard=shard)

    def _trace_enter(self, msg, t_enq: float | None):
        """One op frame's trace arrival on a shard worker: fold the
        client's cost snapshot (sampled first hops carry it), record
        the mClock queue wait as an `osd.queue` span, and return the
        activate() context manager execution should run under (a
        no-op manager when the frame is untraced)."""
        from ..utils.flight_recorder import activate
        ctx = msg.trace
        if ctx is None:
            return activate(None, None)
        if ctx.client_lat or ctx.client_suspects:
            self._note_client_costs(ctx)
        if ctx.sampled and t_enq is not None:
            from ..utils.flight_recorder import new_trace_id
            self.flight.record(ctx.trace_id, new_trace_id(),
                               ctx.parent_span_id, "osd.queue",
                               t_enq, max(0.0, time.time() - t_enq),
                               {"kind": msg.kind})
        return activate(ctx, self.flight)

    def _maybe_retro_trace(self, op, ctx, ps: int | None = None) -> None:
        """Retroactive capture (r15): an UNSAMPLED op that crossed the
        live complaint threshold converts its OpTracker events into
        retro.* ring spans under the carried trace id — `ceph_cli
        trace <id>` can then assemble a timeline nobody sampled.

        r18 closes the replica gap: the primary additionally asks the
        PG's acting set to publish matching retro.subop spans from
        their sub-op retro rings (fire-and-forget retro_publish store
        frames; the spans drain through each replica's OWN MgrReports
        under the deterministic retro root id), so the assembled
        timeline covers client + primary + replicas instead of
        reporting replica time as wire."""
        if (ctx is None or ctx.sampled or not op.done
                or op.duration <= self.op_tracker.complaint_time):
            return
        self.flight.record_tracked(op, ctx)
        if ps is None \
                or int(self.config["osd_subop_retro_ring"]) <= 0:
            return
        with self._lock:
            be = self.backends.get(ps)
            acting = list(dict.fromkeys(be.acting)) if be is not None \
                else []
        e = Encoder()
        e.u64(ctx.trace_id)
        body = e.bytes()
        n = len(self.osdmap.osd_up) if self.osdmap is not None else 0
        for o in acting:
            if not _valid_osd(o, n) or o == self.osd_id:
                continue
            try:
                # submit-and-cancel: the frame is transmitted now, the
                # window slot freed immediately, the reply dropped —
                # the publish happens replica-side regardless, and a
                # dead replica costs nothing here
                self.rpc.submit(
                    f"osd.{o}",
                    lambda rid, b=body: MStoreOp(rid, True,
                                                 "retro_publish",
                                                 b)).cancel()
            except (KeyError, OSError, ConnectionError):
                continue

    def _subop_note(self, ctx, kind: str, start_wall: float,
                    dur: float, apply_s: float) -> None:
        """Remember one completed UNSAMPLED sub-op keyed by its
        carried trace id (the minimal OpTracker-style event ring of
        the r18 satellite) — retro_publish converts matches into
        flight-ring spans when the origin op turns out slow."""
        cap = int(self.config["osd_subop_retro_ring"])
        if cap <= 0:
            return
        rec = {"tid": ctx.trace_id, "parent": ctx.parent_span_id,
               "kind": kind, "start": start_wall,
               "dur": dur, "apply": apply_s}
        with self._subop_ring_lock:
            self._subop_ring.append(rec)
            over = len(self._subop_ring) - cap
            if over > 0:
                del self._subop_ring[:over]

    def _retro_publish(self, trace_id: int) -> int:
        """Publish this daemon's remembered sub-op windows for one
        trace into its flight ring as retro.subop (+ nested
        retro.store.apply) spans under the deterministic retro root —
        they reach the monitors' assemblers through the normal
        MgrReport drain."""
        from ..utils.flight_recorder import new_trace_id, retro_root_id
        root = retro_root_id(trace_id)
        with self._subop_ring_lock:
            matches = [r for r in self._subop_ring
                       if r["tid"] == trace_id]
        for r in matches:
            sid = new_trace_id()
            self.flight.record(trace_id, sid, root, "retro.subop",
                               r["start"], r["dur"],
                               {"kind": r["kind"], "retro": True})
            if r["apply"] > 0:
                # the apply is the service tail (store-lock wait
                # precedes it)
                self.flight.record(
                    trace_id, new_trace_id(), sid,
                    "retro.store.apply",
                    r["start"] + max(0.0, r["dur"] - r["apply"]),
                    r["apply"])
        if matches:
            self.perf.inc("retro_subop_published", len(matches))
        return len(matches)

    def _serve_client_op(self, peer: str, msg: MOSDOp,
                         sub_ops, t_enq: float | None = None) -> None:
        with self._trace_enter(msg, t_enq):
            self._serve_client_op_inner(peer, msg, sub_ops)

    def _serve_client_op_inner(self, peer: str, msg: MOSDOp,
                               sub_ops) -> None:
        try:
            if sub_ops is not None:
                # per-sub-op fault isolation: one bad sub-op fails its
                # slot, not the frame (the client maps each slot back
                # to its op's retry state)
                e = Encoder()
                e.u32(len(sub_ops))
                for kind, body in sub_ops:
                    try:
                        sub_blob = self._one_client_op(peer, kind, body)
                        e.boolean(True).blob_ref(sub_blob).string("")
                    except Exception as err:   # noqa: BLE001
                        e.boolean(False).blob(b"").string(
                            f"{type(err).__name__}:{err}")
                blob = e.bytes()
            else:
                blob = self._one_client_op(peer, msg.kind, msg.blob)
            rep = MOSDOpReply(msg.req_id, True, msg.kind, blob)
        except Exception as e:   # noqa: BLE001 — reply, don't die
            rep = MOSDOpReply(msg.req_id, False, msg.kind,
                              err=f"{type(e).__name__}:{e}")
        try:
            self.msgr.send(peer, rep)
        except (KeyError, OSError, ConnectionError):
            pass

    def _one_client_op(self, peer: str, kind: str, body: bytes) -> bytes:
        from ..utils.flight_recorder import current
        from ..utils.tracing import span
        ps = self._op_ps(body)
        is_read = kind in self._READ_KINDS
        t0 = time.perf_counter()
        with span("osd.op", counters=self.perf, key="op_latency"):
            with self.op_tracker.create_op(
                    f"osd_op({kind}) client={peer}") as op:
                # DEBUG latency injection (osd_inject_op_delay, live
                # central config): the deterministic slowness source
                # the SLO-burn tests drive — inside the tracked op so
                # history/complaints/histograms all see it, before
                # the PG lock so independent PGs aren't convoyed
                inject = float(self.config["osd_inject_op_delay"])
                if inject > 0:
                    time.sleep(inject)
                # DEBUG CPU burn (osd_inject_cpu_burn, r19): a busy
                # spin INSIDE the osd.op span — the deterministic hot
                # loop the profile-attribution tests drive. The r15
                # taxonomy puts osd.op self-time in "other", so the
                # burn must surface there in the flame profile (and
                # in profile_diff's regression verdict)
                burn = float(self.config["osd_inject_cpu_burn"])
                if burn > 0:
                    t_burn = time.perf_counter() + burn
                    while time.perf_counter() < t_burn:
                        pass
                # per-PG execution lock, not the daemon lock: ops to
                # independent PGs really do run concurrently across
                # shards; reconcile/recovery exclude themselves per PG
                # (they take self._lock THEN the PG locks they touch)
                with self._pg_lock(ps):
                    op.mark_event("reached_pg")
                    blob = self._client_op(kind, body)
                op.mark_event("commit_sent")
        # r18: the read/write split the client_read/client_write SLO
        # feeds merge (same sample the op_latency pair took)
        self.perf.tinc("op_r_latency" if is_read else "op_w_latency",
                       time.perf_counter() - t0)
        self._maybe_retro_trace(op, current(), ps)
        self.perf.inc_many(
            (("op", 1),
             ("op_r" if is_read else "op_w", 1),
             ("op_in_bytes", len(body)),
             ("op_out_bytes", len(blob))))
        return blob

    SNAP_SEP = "@@snap."

    def _check_snapc(self, snapc: int) -> None:
        """Mutating client ops carry the client's snap context (ref:
        MOSDOp's SnapContext): if the client knows a newer snap_seq
        than this primary's map, executing now would skip the COW for
        that snap — refuse so the client retries after the map
        broadcast lands (there is no cross-connection ordering
        between mon→osd maps and client→osd ops)."""
        if snapc > self.osdmap.pools[1].snap_seq:
            raise RuntimeError(
                f"map lag: op snapc {snapc} > pool snap_seq "
                f"{self.osdmap.pools[1].snap_seq} "
                f"(epoch {self.osdmap.epoch})")

    def _snap_guard(self, ps: int, be, names) -> None:
        """Write-path COW (ref: PrimaryLogPG::make_writeable): before
        the FIRST mutation of a head after each pool snap, preserve
        its bytes as a clone object in the SAME PG (the reference
        keeps clones in the head's PG too — same hash, different snap
        id; the name suffix stands in for the snapid field)."""
        seq = self.osdmap.pools[1].snap_seq
        births = self.births.setdefault(ps, {})
        sets_ = self.snapsets.setdefault(ps, {})
        for name in sorted(names):
            if self.SNAP_SEP in name:
                continue            # clones never re-clone
            if name not in be.object_sizes:
                # creation: remember the snap era it was born in, so
                # reads at older snaps correctly say "didn't exist"
                births[name] = seq
                continue
            if births.get(name, 0) >= seq:
                continue            # born after the newest snap
            ss = sets_.setdefault(name, [])
            if ss and ss[-1][0] >= seq:
                continue            # newest snap already preserved
            data = be.read_object(name, dead_osds=set(self.suspect))
            clone = f"{name}{self.SNAP_SEP}{seq:08x}"
            be.write_objects({clone: bytes(np.asarray(data, np.uint8)
                                           .tobytes())},
                             dead_osds=set(self.suspect))
            ss.append((seq, births.get(name, 0)))

    def _snap_resolve(self, ps: int, be, name: str, sid: int):
        """State of `name` as of snap `sid`: the OLDEST clone with
        seq >= sid that existed at the snap, else the unmodified head
        (ref: PrimaryLogPG find_object_context SnapSet resolution)."""
        if sid not in self.osdmap.pools[1].snaps:
            if sid > self.osdmap.pools[1].snap_seq:
                # the client knows a newer snap than this primary's
                # map: TRANSIENT lag (mon->osd vs client->osd frames
                # have no ordering) — retryable, like _check_snapc
                raise RuntimeError(
                    f"map lag: snap {sid} > pool snap_seq "
                    f"{self.osdmap.pools[1].snap_seq}")
            raise KeyError(f"no snap {sid}")   # genuinely removed
        ss = self.snapsets.get(ps, {}).get(name, [])
        cands = [seq for seq, birth in ss if seq >= sid and birth < sid]
        if cands:
            clone = f"{name}{self.SNAP_SEP}{min(cands):08x}"
            return be.read_object(clone, dead_osds=set(self.suspect))
        if name in be.object_sizes \
                and self.births.get(ps, {}).get(name, 0) < sid:
            return be.read_object(name, dead_osds=set(self.suspect))
        raise KeyError(f"{name!r} did not exist at snap {sid}")

    def _snap_trim(self, ps: int, be) -> None:
        """Drop clones no live snap reads anymore (the snaptrim role,
        ref: PrimaryLogPG::trim_object) — driven off the committed
        map's pool.snaps on every map change. Failure-tolerant: a
        refused removal keeps the clone for the next trim."""
        live = self.osdmap.pools[1].snaps
        sets_ = self.snapsets.get(ps)
        if not sets_:
            return
        changed = False
        for name, ss in list(sets_.items()):
            keep: list[tuple[int, int]] = []
            prev = 0
            for c, birth in ss:  # ascending; clone c covers snaps
                # (prev_kept, c], minus snaps older than its birth era
                if any(prev < s <= c and s > birth for s in live):
                    keep.append((c, birth))
                    prev = c
                    continue
                try:
                    be.remove_objects(
                        [f"{name}{self.SNAP_SEP}{c:08x}"],
                        dead_osds=set(self.suspect))
                    changed = True
                except (KeyError, ConnectionError, OSError):
                    keep.append((c, birth))
                    prev = c
            if keep:
                sets_[name] = keep
            else:
                del sets_[name]
                changed = True
        if changed:
            self._persist_meta(ps)

    def _delete_objects(self, ps: int, be, names: list[str]) -> None:
        """ONE delete path for the wire op and the cls shim:
        COW-preserve heads a live snap still needs (make_writeable
        before the delete), logged remove, per-object side state
        dropped. IDEMPOTENT: already-absent names are skipped — a
        client retrying a delete whose reply was lost must see
        success, not KeyError (write/read are naturally retry-safe;
        delete earns it by tolerating ENOENT, the reference's rados
        semantics for a replayed delete)."""
        present = [n for n in names if n in be.object_sizes]
        if present:
            self._snap_guard(ps, be, present)
            be.remove_objects(present, dead_osds=set(self.suspect))
        for name in names:
            self.obj_kv.get(ps, {}).pop(name, None)
            self.births.get(ps, {}).pop(name, None)

    def _client_op(self, kind: str, body: bytes) -> bytes:
        import json as _json
        d = Decoder(body)
        ps = d.u32()
        if kind == "read_degraded":
            # degraded-read fast path: served by ANY reachable acting
            # member — the not-primary and WaitUpThru gates below
            # deliberately do not apply (a read mutates nothing and
            # the serving view is read-only; see _degraded_read_op)
            return self._degraded_read_op(ps, d)
        be = self.backends.get(ps)
        if be is None:
            raise RuntimeError(f"not primary for pg 1.{ps} "
                               f"(epoch {self.osdmap.epoch})")
        need_ut = self._interval_start.get(ps, 0)
        if int(self.osdmap.osd_up_thru[self.osd_id]) < need_ut:
            # WaitUpThru: serving a write before the monitors recorded
            # this interval's up_thru would create an interval nobody
            # can later prove went rw — park the op (client retries
            # until the committed map unblocks us)
            raise RuntimeError(
                f"pg 1.{ps} peering (wait_up_thru {need_ut}, "
                f"epoch {self.osdmap.epoch})")
        if kind in ("write", "write_at", "append"):
            # r21 failsafe hard-stop: the LOCAL store ratio, not the
            # map — a full disk must never take another byte even
            # when this daemon's map is stale. Deletes ("remove")
            # pass: freeing space is how a full cluster recovers.
            # The raise is the retryable park shape (like WaitUpThru):
            # the client parks the op, nothing surfaces as op_error.
            self._failsafe_gate(ps)
        if kind == "write":
            self._check_snapc(d.u64())
            objs = d.mapping(Decoder.string, Decoder.blob)
            self._snap_guard(ps, be, objs)

            def _meta_extra(wave_names):
                # the PG metadata rides the write fan-out transaction
                # itself (the pg_log-inside-the-transaction
                # discipline): one wave persists bytes AND the
                # metadata that proves them, halving the write path's
                # frame count vs the old separate _persist_meta pass.
                # Steady state ships a BOUNDED DELTA (entries since
                # the last full blob + applied cursors, O(window));
                # the full O(objects-in-PG) base goes out every
                # _META_DELTA_MAX entries — without this, per-write
                # metadata cost grows linearly with PG object count
                # and the write path degrades quadratically over a
                # sustained workload. Snap-era state (snapsets/births
                # beyond era 0) isn't delta-encoded: any pool with
                # snaps takes the full-persist path every time,
                # keeping COW restore semantics byte-identical.
                ent, base_head = self._meta_delta.get(ps, ([], -1))
                ent = ent + [(n, be.object_versions[n],
                              be.object_sizes[n]) for n in wave_names]
                full = (base_head < 0
                        or len(ent) >= _META_DELTA_MAX
                        or self.osdmap.pools[1].snap_seq > 0
                        or self.snapsets.get(ps)
                        or self.obj_kv.get(ps))
                if full:
                    blob = self._encode_meta(ps)
                    self._meta_delta[ps] = ([], be.pg_log.head)
                    kv = {PG_META_KEY: blob, PG_META_DELTA_KEY: b""}
                else:
                    self._meta_delta[ps] = (ent, base_head)
                    kv = {PG_META_DELTA_KEY:
                          self._encode_meta_delta(ps)}

                def add(shard, t):
                    t.omap_set(shard_cid(be.pg, shard),
                               "__pg_meta__", kv)
                return add
            fused = isinstance(be, ECBackend)
            kw = {"shard_txn_extra": _meta_extra} if fused else {}
            try:
                be.write_objects(objs, dead_osds=set(self.suspect),
                                 **kw)
            except (ConnectionError, OSError):
                # a shard holder died mid-fan-out: mark it suspect and
                # retry once degraded; the client write must not bounce
                self._mark_suspects(be)
                be.write_objects(objs, dead_osds=set(self.suspect),
                                 **kw)
            if not fused:
                self._persist_meta(ps)
            return b""
        if kind in ("write_at", "append"):
            # partial-stripe writes (r16): the backend routes each op
            # through the parity-delta RMW fast path (journaled, only
            # touched + parity shards move) or the full-stripe ladder
            self._check_snapc(d.u64())
            trips = d.list(lambda dd: (dd.string(), dd.u64(),
                                       dd.blob()))
            self._snap_guard(ps, be, [n for n, _o, _b in trips])
            ops = [(n, be.object_sizes.get(n, 0) if kind == "append"
                    else off, blob) for n, off, blob in trips]
            try:
                be.write_ranges(ops, dead_osds=set(self.suspect))
            except (ConnectionError, OSError):
                # a shard holder died mid-fan-out: suspect it and
                # retry once degraded — the delta path refuses a
                # degraded stripe, so the retry rides the full-stripe
                # RMW (and the journal's abort + superseded-version
                # guard keep any half-logged intents inert)
                self._mark_suspects(be)
                be.write_ranges(ops, dead_osds=set(self.suspect))
            self._persist_meta(ps)
            return b""
        if kind == "remove":
            self._check_snapc(d.u64())
            names = d.list(Decoder.string)
            try:
                self._delete_objects(ps, be, names)
            except (ConnectionError, OSError):
                # a shard holder died mid-fan-out: suspect it and
                # retry once degraded (the write path's rule;
                # _delete_objects is idempotent so the retry is safe)
                self._mark_suspects(be)
                self._delete_objects(ps, be, names)
            self._persist_meta(ps)
            return b""
        if kind == "read":
            name = d.string()
            data = be.read_objects(
                [name], dead_osds=set(self.suspect),
                helper_costs=self._helper_costs(be))[name]
            return np.asarray(data, np.uint8).tobytes()
        if kind == "readv":
            # batched read: ONE decode launch serves the whole name
            # group (read_objects stacks equal-length groups), where
            # per-name ops would launch one decode each
            names = d.list(Decoder.string)
            for n in names:
                if n not in be.object_sizes:
                    raise KeyError(n)
            got = be.read_objects(names, dead_osds=set(self.suspect),
                                  helper_costs=self._helper_costs(be))
            e = Encoder()
            e.list([np.asarray(got[n], np.uint8).tobytes()
                    for n in names], Encoder.blob_ref)
            return e.bytes()
        if kind == "snap_read":
            name, sid = d.string(), d.u64()
            data = self._snap_resolve(ps, be, name, sid)
            return np.asarray(data, np.uint8).tobytes()
        if kind == "rollback":
            # rados rollback: write the snap's state back onto the
            # head — itself COW-protected, so the pre-rollback head
            # is preserved if a newer snap needs it
            self._check_snapc(d.u64())
            name, sid = d.string(), d.u64()
            data = self._snap_resolve(ps, be, name, sid)
            self._snap_guard(ps, be, [name])
            be.write_objects(
                {name: np.asarray(data, np.uint8).tobytes()},
                dead_osds=set(self.suspect))
            self._persist_meta(ps)
            return b""
        if kind == "deep_scrub":
            res = be.deep_scrub(dead_osds=set(self.suspect))
            return _json.dumps(res, sort_keys=True).encode()
        if kind == "repair":
            res = be.repair_pg(dead_osds=set(self.suspect))
            self._persist_meta(ps)
            return _json.dumps(res, sort_keys=True).encode()
        if kind == "cls":
            from .objclass import cls_call
            self._check_snapc(d.u64())
            name, cname, method = d.string(), d.string(), d.string()
            out = cls_call(_PgClsView(self, ps, be), name, cname,
                           method, d.blob())
            self._persist_meta(ps)   # kv mutations ride the metadata
            return out
        raise ValueError(f"unknown client op {kind!r}")

    # -- degraded-read fast path (server side) -------------------------------

    def _degraded_view(self, ps: int, hints: set[int]):
        """READ-ONLY backend over the freshest quorum-visible PG
        metadata — what lets a surviving acting shard serve reads
        while the primary is down, unreachable, or still peering
        (WaitUpThru), instead of parking them behind activation and
        recovery (ROADMAP item 3; the online-EC characterization's
        degraded-read tail, arxiv 1709.05365).

        Correctness leans on the meta-rides-the-write discipline: an
        ACKED write persisted its (base, delta) metadata on every live
        shard in the same transaction wave as the bytes, so the
        freshest pair a MAJORITY gather can see always covers it —
        serving from that pair is read-your-acked-writes consistent.
        The view is rebuilt per op (never cached): a primary may have
        activated elsewhere and served writes since any cached gather.
        No collections are created, nothing is persisted, EIO repairs
        are disabled — only an activated primary mutates shards.
        Raises RuntimeError (retryable at the client) when the gather
        cannot reach quorum."""
        acting = self._acting(ps)
        blob, _local, quorum_ok = self._load_meta(
            ps, acting, suspect_extra=hints)
        if not quorum_ok:
            raise RuntimeError(f"pg 1.{ps} degraded read deferred "
                               f"(meta gather below quorum)")
        be = self._make_backend(ps, acting, ensure_collections=False)
        if blob is None:
            return be            # virgin PG: the name check KeyErrors
        base, delta_blob = blob
        d, v = self._meta_decoder(base)
        if v >= 3:
            d.u64()              # persist epoch (ranking already used it)
        be.object_sizes = d.mapping(Decoder.string, Decoder.u64)
        be.object_versions = d.mapping(Decoder.string, Decoder.u64)
        be.pg_log = PGLog.decode(d.blob())
        applied = d.list(Decoder.u64)
        meta_acting = d.list(Decoder.i32)
        # the v2 tail (snapsets/births/cls-kv) is deliberately not
        # decoded: plain reads need sizes/versions/cursors only;
        # snap_read stays on the activated-primary path
        applied = self._apply_meta_delta(
            delta_blob, be.object_sizes, be.object_versions,
            be.pg_log, applied)
        # adopt the RECORDED acting: that is the set the cursors (and
        # the shard bytes) were written against
        be.acting = list(meta_acting)
        be.shard_applied = list(applied)
        return be

    def _degraded_read_op(self, ps: int, d: Decoder) -> bytes:
        """Serve a `read_degraded` op: fetch any k fresh surviving
        shards and decode on device through the process-wide fused
        programs (r10), skipping every down/suspected/hinted member.
        The hint list carries the OSDs the client is routing around
        (its timed-out primary) — honored for this op only, never
        recorded into self.suspect. Reply encoding matches `readv`
        (list of blobs, in name order)."""
        names = d.list(Decoder.string)
        hints = {int(h) for h in d.list(Decoder.i32)}
        n_osds = len(self.osdmap.osd_up)
        dead = ({o for o in range(n_osds)
                 if not self.osdmap.osd_up[o]}
                | set(self.suspect) | hints)
        dead.discard(self.osd_id)   # our own store always answers us
        be = self.backends.get(ps)
        need_ut = self._interval_start.get(ps, 0)
        if be is not None \
                and int(self.osdmap.osd_up_thru[self.osd_id]) >= need_ut:
            # we ARE the activated primary: the normal engine serves
            # (a hedged duplicate landing here costs one decode, and
            # EIO repair stays on — we own the shards)
            src, repair = be, True
        else:
            self.perf.inc("degraded_view_builds")
            src, repair = self._degraded_view(ps, hints), False
        for n in names:
            if n not in src.object_sizes:
                raise KeyError(n)
        with self.perf.time("degraded_read_time"):
            try:
                # the repair-locality planner serves the degraded
                # gather too: a single-shard LRC loss touches one
                # local group instead of any-k, cost-biased by the
                # same complaint/latency memory as recovery
                got = src.read_objects(
                    names, dead_osds=dead, repair=repair,
                    helper_costs=self._helper_costs(src))
            except KeyError as e:
                # names were just checked, so this KeyError is a
                # SHARD-level store miss: the meta already names a
                # repointed, still-rebuilding slot (recovery in
                # flight) whose store lacks this object. Transient —
                # surface as retryable, never as no-such-object.
                raise RuntimeError(
                    f"pg 1.{ps} degraded read raced recovery ({e}); "
                    f"retry") from None
        self.perf.inc("op_degraded_read", len(names))
        e = Encoder()
        e.list([np.asarray(got[n], np.uint8).tobytes()
                for n in names], Encoder.blob_ref)
        return e.bytes()

    def _mark_suspects(self, be) -> None:
        n_osds = len(self.osdmap.osd_up) if self.osdmap is not None \
            else 0
        for osd in set(be.acting):
            if osd == self.osd_id or osd in self.suspect \
                    or not _valid_osd(osd, n_osds):
                continue
            try:
                self.rpc.call(f"osd.{osd}",
                              lambda rid: MStoreOp(rid, True, "exists",
                                                   RemoteStore._co("x")),
                              timeout=1.0)
            except (ConnectionError, KeyError, OSError):
                self.suspect.add(osd)

    # -- liveness ------------------------------------------------------------

    def _on_ping(self, peer: str, msg: MOSDPing) -> None:
        try:
            self.msgr.send(peer, MOSDPingReply(msg.stamp))
        except (KeyError, OSError, ConnectionError):
            pass

    def _on_pong(self, peer: str, msg: MOSDPingReply) -> None:
        if peer.startswith("osd."):
            now = time.monotonic()
            self._ping_unacked.pop(int(peer[4:]), None)
            # r22: the reply echoes OUR monotonic send stamp, so the
            # round trip needs no wire change and no clock agreement
            # (even cross-process CLOCK_MONOTONIC is one clock here).
            # Fast dispatch: the fold is a leaf-locked bucket add.
            if bool(self.config["osd_network_observability"]):
                self.link_tracker.note(peer, now - msg.stamp,
                                       channel="hb")

    def _maybe_scheduled_scrub(self) -> None:
        """Background scrub scheduling (ref: PG scrub scheduling off
        osd_scrub_min_interval / osd_deep_scrub_interval; the sim
        tier schedules in virtual time, this one on the heartbeat).
        Per primaried PG: shallow at osd_scrub_interval, deep at
        osd_deep_scrub_interval; results land in scrub_reports
        (served by the `dump_scrubs` admin command) and auto_repair
        honors osd_scrub_auto_repair."""
        ival = float(self.config["osd_scrub_interval"])
        deep_ival = float(self.config["osd_deep_scrub_interval"])
        if ival <= 0 and deep_ival <= 0:
            return
        if not self._lock.acquire(blocking=False):
            return                # never stall the heartbeat
        try:
            now = time.monotonic()
            # at most ONE PG per beat (a multi-PG deep sweep under the
            # daemon lock would block client ops for its whole
            # duration), and the MOST OVERDUE due PG wins — first-due
            # in dict order would starve later PGs whenever the
            # interval is shorter than n_pgs * heartbeat_interval
            due = []
            for ps, be in self.backends.items():
                deep_due = deep_ival > 0 and \
                    now - self._last_deep.get(ps, 0.0) >= deep_ival
                shallow_due = ival > 0 and \
                    now - self._last_scrub.get(ps, 0.0) >= ival
                if deep_due or shallow_due:
                    due.append((self._last_scrub.get(ps, 0.0), ps,
                                be, deep_due))
            if due:
                _, ps, be, deep_due = min(due)
                # stamp the ATTEMPT first: a persistently failing
                # scrub retries at its interval, not every beat
                # (the _restore_backoff lesson)
                self._last_scrub[ps] = now
                if deep_due:
                    self._last_deep[ps] = now
                # PG lock: client ops no longer ride the daemon lock,
                # so the scrub read sweep must exclude them itself
                with self._pg_lock(ps):
                    self._run_scheduled_scrub(ps, be, deep_due, now)
        finally:
            self._lock.release()

    def _run_scheduled_scrub(self, ps: int, be, deep_due: bool,
                             now: float) -> None:
        """Execute one due scrub. Caller holds self._lock + the PG
        lock (see _maybe_scheduled_scrub)."""
        try:
            if deep_due:
                rep = be.deep_scrub(
                    dead_osds=set(self.suspect))
                rep["kind"] = "deep"
                found = (rep["inconsistent"]
                         or rep.get("digest_mismatch"))
                if found and bool(
                        self.config["osd_scrub_auto_repair"]):
                    be.repair_pg(dead_osds=set(self.suspect))
                    rep["auto_repaired"] = True
            else:
                rep = be.shallow_scrub(
                    skip_slots={s for s, o in
                                enumerate(be.acting)
                                if o in self.suspect})
                rep["kind"] = "shallow"
            rep["at"] = now
            self.scrub_reports[ps] = rep
            bad = (rep.get("inconsistent") or rep.get("errors")
                   or rep.get("digest_mismatch"))
            if bad:
                self.c.log(f"{self.name}: scheduled "
                           f"{rep['kind']} scrub pg 1.{ps}: "
                           f"{len(bad)} inconsistenc(ies)")
        except Exception as e:   # noqa: BLE001 — scrub must
            self.c.log(f"{self.name}: scheduled scrub pg "
                       f"1.{ps} failed: {e}")  # not kill hb

    def _heartbeat_loop(self) -> None:
        beat = 0
        # interval/grace resolve through the daemon config each beat,
        # so a committed `config set osd_heartbeat_*` retunes a RUNNING
        # daemon (the md_config_obs_t role, no restart)
        while not self._stop.wait(self.config["osd_heartbeat_interval"]):
            beat += 1
            if beat % 4 == 0 and self.osdmap is not None \
                    and not self.osdmap.osd_up[self.osd_id]:
                # the map says we're down but we're clearly running:
                # re-assert boot until a committed map shows us up
                # (ref: OSD::start_boot retry — a single MOSDBoot can
                # be consumed by a monitor that loses leadership, or
                # race the down-mark commit; retrying self-heals both)
                for mon_name in self.c.mon_names():
                    try:
                        self.msgr.send(mon_name, MOSDBoot(self.osd_id))
                    except (KeyError, OSError, ConnectionError):
                        pass
            if beat % 4 == 0 and self.osdmap is not None \
                    and self._lock.acquire(blocking=False):
                try:
                    # retry deferred recoveries (a reconcile is cheap
                    # when everything already matches the map)
                    self._reconcile()
                except Exception as e:  # noqa: BLE001 — the heartbeat
                    self.c.log(f"{self.name}: reconcile retry "
                               f"failed: {e!r}")   # thread must not die
                finally:
                    self._lock.release()
            now = time.monotonic()
            for osd in self.c.osd_ids():
                if osd == self.osd_id:
                    continue
                if self.osdmap is not None \
                        and not self.osdmap.osd_up[osd]:
                    # the map already says down: pinging would only
                    # grow the lossless queue without bound and flood
                    # the peer with stale pings on revive
                    continue
                self._ping_unacked.setdefault(osd, time.monotonic())
                try:
                    # stamp per send, not per sweep: an injected link
                    # delay sleeps THIS thread before the transmit, so
                    # a sweep-wide stamp would charge peer k's delay to
                    # every peer pinged after it (r22 netobs needs the
                    # RTT attributed to exactly the degraded link)
                    self.msgr.send(f"osd.{osd}",
                                   MOSDPing(time.monotonic()))
                except (KeyError, OSError, ConnectionError):
                    pass
                # silence counts from the oldest unanswered ping, not
                # from the last reply: a beat that came late (this
                # thread blocked on a PG lock behind a recovery batch,
                # a starved process) sent no pings, and its peers'
                # quiet then is ours, not theirs
                stale = now - self._ping_unacked.get(osd, now) \
                    > self.config["osd_heartbeat_grace"]
                if stale and osd not in self._reported:
                    self._reported.add(osd)
                    self.suspect.add(osd)
                    # heartbeat silence is the DownClock's suspect
                    # evidence (map still up — repair parks nothing
                    # yet; the mon's down mark starts the window)
                    self.repair_policy.note_suspect(osd)
                    # broadcast to EVERY monitor: whoever currently
                    # leads acts, so leader failover needs no OSD-side
                    # coordination (the reference forwards via the
                    # session mon the same way)
                    for mon_name in self.c.mon_names():
                        try:
                            self.msgr.send(mon_name, MOSDFailure(osd))
                        except (KeyError, OSError, ConnectionError):
                            pass
                elif not stale and osd in self._reported:
                    # the peer answered our PINGS again before any
                    # down-mark committed: clear the heartbeat
                    # suspicion and retract OUR report at the
                    # monitors — a transient stall (scheduler hiccup,
                    # load) must not degrade the peer forever. Gated
                    # on _reported, not suspect: store-RPC-failure
                    # suspicion (_mark_suspects) is different
                    # evidence that ping liveness does not refute.
                    self.suspect.discard(osd)
                    self._reported.discard(osd)
                    self.c.log(f"{self.name}: osd.{osd} answered "
                               "again; retracting failure report")
                    for mon_name in self.c.mon_names():
                        try:
                            self.msgr.send(mon_name,
                                           MOSDFailure(osd, alive=True))
                        except (KeyError, OSError, ConnectionError):
                            pass
                # r22: a link whose RTT ewma crosses the slow-ping
                # line is DownClock suspect evidence (r17) — the peer
                # is alive but its wire is sick, so repair planning
                # should treat it warily. Hysteresis: flag at the
                # threshold, clear at half, one policy note per flip.
                if bool(self.config["osd_network_observability"]):
                    thr_s = self._slow_ping_threshold_s()
                    ewma = self.link_tracker.ewma_s(f"osd.{osd}")
                    if ewma > thr_s:
                        if osd not in self._slow_links:
                            self._slow_links.add(osd)
                            self.repair_policy.note_slow_link(osd)
                            self.c.log(
                                f"{self.name}: slow link to osd.{osd}"
                                f" (rtt ewma {ewma * 1e3:.1f}ms > "
                                f"{thr_s * 1e3:.1f}ms)")
                    elif ewma < thr_s / 2 \
                            and osd in self._slow_links:
                        self._slow_links.discard(osd)
                        # heartbeat-silence suspicion is separate
                        # evidence; only clear when it isn't active
                        if osd not in self.suspect:
                            self.repair_policy.clock(
                                osd).clear_suspect()
            try:
                # r18: close the current metric-history interval (if
                # its wall-clock boundary passed) BEFORE reporting so
                # the fresh entry ships on this same beat
                self.metrics_history.maybe_tick()
                # r19: same rule for the CPU sampler's profile ring
                self.profiler.maybe_tick()
                self._maybe_mgr_report()
            except Exception as e:  # noqa: BLE001 — stats shipping
                # must never kill the heartbeat thread
                self.c.log(f"{self.name}: mgr report failed: {e!r}")
            # scrub LAST — after pings AND the report: this beat's
            # pings are already out so a long deep scrub cannot push
            # our liveness past peers' grace, and the report shipped
            # first so the same scrub cannot starve the MgrReport
            # pipe either (r22: the mon's slow-link verdict reads our
            # link claims; a multi-second TinStore deep scrub parked
            # here used to freeze them mid-degrade)
            self._maybe_scheduled_scrub()

    def _slow_ping_threshold_s(self) -> float:
        """The slow-link line in SECONDS, the same resolution the mon
        NetworkAggregator uses (mon_warn_on_slow_ping_time ms when
        set, else ratio x grace) — daemon and mon judge one line."""
        warn_ms = float(self.config["mon_warn_on_slow_ping_time"])
        if warn_ms > 0:
            return warn_ms / 1e3
        return (float(self.config["mon_warn_on_slow_ping_ratio"])
                * float(self.config["osd_heartbeat_grace"]))

    def _maybe_mgr_report(self) -> None:
        """Periodically ship this daemon's counters + op stats + the
        PG states it primaries to every monitor (the MMgrReport flow,
        ref: DaemonServer::handle_report): FULL dump every Nth report,
        bounded DELTA in between — the aggregator re-bases on fulls,
        so lost reports and monitor restarts self-heal without acks."""
        import json as _json

        from ..mgr.reports import FULL_EVERY
        from ..utils.perf_counters import dump_delta
        now = time.monotonic()
        if now - self._mgr_last_sent \
                < float(self.config["mgr_report_interval"]):
            return
        self._mgr_last_sent = now
        perf = self.perf_dump_all()
        self._mgr_seq += 1
        full = (self._mgr_last_perf is None
                or self._mgr_seq % FULL_EVERY == 0)
        report = {
            "name": self.name,
            "seq": self._mgr_seq,
            "kind": "full" if full else "delta",
            "perf": perf if full
            else dump_delta(self._mgr_last_perf, perf),
            "ops_in_flight": len(self.op_tracker._in_flight),
            "slow_ops": len(self.op_tracker.slow_ops()),
            "epoch": self.osdmap.epoch
            if self.osdmap is not None else 0,
            # r20: merged mClock class occupancy rides every report so
            # the mon-side aggregate (and `ceph_cli top`) can attribute
            # WHICH tenant is being throttled, not just who is slow
            "mclock": self.sched_dump(),
        }
        if full:
            report["schema"] = self.perf_schema_all()
        # r15: drain freshly finished flight-recorder spans into the
        # same pipe (bounded per report; the mon-side TraceAssembler
        # stitches rings across daemons into causal timelines)
        spans = self.flight.drain(512)
        if spans:
            report["spans"] = spans
        # r18: freshly recorded metric-history intervals ride along
        # (normally 0-1 entries per report) into the monitors'
        # TelemetryAggregators, plus the flight ring's overflow
        # accounting (the TRACE_RING_OVERFLOW source — a declared
        # gauge AND a report field, so the aggregation never scrapes
        # ring internals)
        history = self.metrics_history.drain_unshipped()
        if history:
            report["history"] = history
        fstats = self.flight.stats()
        self.perf.set("trace_dropped_unshipped",
                      fstats["dropped_unshipped"])
        report["flight"] = fstats
        # r19: freshly closed profile-ring intervals (span-tagged
        # stack deltas) + the sampler's accounting ride the same pipe
        # into the monitors' ProfileAggregators
        report["profile"] = {
            "entries": self.profiler.drain_unshipped(),
            "stats": self.profiler.stats()}
        # r21 capacity plane: raw statfs on EVERY report (the store
        # has its own lock — no daemon-lock hazard). The mon ladder
        # only ever acts on these claims, never on local guesses.
        try:
            report["statfs"] = self.store.statfs()
        except Exception:
            pass
        # r22 network plane: per-link RTT state + per-peer flow ride
        # every report (side-field like statfs/mclock — per-peer keys
        # are dynamic, so they must never be counter names). The OFF
        # arm (osd_network_observability=false) ships nothing, which
        # is what the overhead-parity bench measures against.
        if bool(self.config["osd_network_observability"]):
            report["network"] = {
                "links": self.link_tracker.dump(),
                "flow": self.msgr.flow_dump(),
            }
        self._mgr_last_perf = perf
        # PG states want the daemon lock; never stall the heartbeat
        # for them — a busy beat ships without, and the aggregator
        # keeps the previous claim
        if self._lock.acquire(blocking=False):
            try:
                report["pgs"] = self._pg_states()
                report["pool_bytes"] = self._pool_bytes()
                report["pool_objects"] = self._pool_objects()
            finally:
                self._lock.release()
        blob = _json.dumps(report, separators=(",", ":")).encode()
        self.perf.inc("mgr_reports_tx")
        for mon_name in self.c.mon_names():
            try:
                self.msgr.send(mon_name,
                               MMgrReport(0, True, report["kind"],
                                          blob))
            except (KeyError, OSError, ConnectionError):
                pass

    def kill(self) -> None:
        """SIGKILL: stop answering everything, drop RAM state."""
        self._stop.set()
        self.profiler.stop()
        self.asok.stop()
        self.msgr.shutdown()
        self.store.crash()

    def revive(self) -> "OSDDaemon":
        """Fresh process, same disk: remount and boot."""
        self.store.remount()
        fresh = OSDDaemon.__new__(OSDDaemon)
        fresh.__dict__.update(self.__dict__)
        fresh.msgr = Messenger(self.name, secret=self.c.secret,
                               compress=self.c.compress,
                               workers=self.c.msgr_workers,
                               uds=self.c.msgr_uds)
        fresh.rpc = _Rpc(fresh.msgr, MStoreReply.type_id)
        fresh.backends = {}
        fresh.snapsets = {}
        fresh.births = {}
        fresh.obj_kv = {}
        fresh._interval_start = {}
        fresh._last_acting = {}
        fresh.suspect = set()
        fresh._ping_unacked = {}
        fresh._peer_lat = {}
        fresh._client_lat = {}
        fresh._reported = set()
        fresh._stop = threading.Event()
        # auth sessions die with the process; rotating secrets are
        # re-fetched at boot (a revived daemon must not honor tickets
        # from before a rotation it slept through). _start() rebuilds
        # the daemon's own ClientAuth + auth rpc on the new messenger.
        fresh._authed = {}
        fresh._init_observability()
        if fresh.verifier is not None:
            from ..auth import ServiceVerifier
            fresh.verifier = ServiceVerifier(
                "osd", self.c.key_server.export_rotating("osd"))
        fresh._start()
        return fresh


class _MonConfigView:
    """Read-only config resolver for a monitor (r18): committed-map
    config KV (coerced through the option schema) over g_conf's
    file/default layers. Monitors never carried a per-daemon Config;
    the telemetry plane's live options (mgr_slo_rules,
    mgr_history_interval, ...) need the committed layer visible."""

    def __init__(self, mon: "MonDaemon"):
        self._mon = mon

    def get(self, name: str):
        from ..utils.config import g_conf
        osdmap = self._mon.osdmap
        kv = osdmap.config_kv if osdmap is not None else {}
        if name in kv:
            opt = g_conf.schema.get(name)
            return opt.coerce(kv[name]) if opt is not None \
                else kv[name]
        return g_conf.get(name)

    def __getitem__(self, name: str):
        return self.get(name)


class MonDaemon:
    """Monitor endpoint. The lowest rank BELIEVED ALIVE leads (rank
    election over real ping frames — ref: src/mon/Elector.cc's
    lowest-rank-wins outcome, with liveness standing in for the
    propose/ack rounds); map commits go through MULTI-PHASE Paxos over
    real frames (ref: src/mon/Paxos.cc collect/last/begin/accept/
    commit): a leader first COLLECTs a majority of promises at a
    rank-stamped proposal number — learning the quorum's committed
    state and re-driving any accepted-but-uncommitted value — and only
    then BEGINs new values; peons accept only at or above their
    promised pn. Safety does not rest on the election: two monitors
    that both believe they lead (boot grace, partition) arbitrate by
    pn, and a value accepted by a majority is visible to every later
    collect quorum (intersection), so a committed epoch can never be
    displaced. A minority-side leader never gets its collect majority,
    so it can neither commit nor adopt uncommitted state as durable.
    OSD reports are broadcast to every monitor and QUEUED by all of
    them; whoever currently leads proposes (a queued mutation whose
    precondition the committed map already satisfies rebases to a
    no-op), so leadership moves drop nothing."""

    def __init__(self, rank: int, cluster: "StandaloneCluster",
                 osdmap: OSDMap | None = None, device=None):
        from ..ec.interface import resolve_device
        self.rank = rank
        self.c = cluster
        self.device = resolve_device(device)
        self.name = f"mon.{rank}"
        self.msgr = Messenger(self.name, secret=cluster.secret,
                              compress=cluster.compress,
                              workers=cluster.msgr_workers,
                              uds=cluster.msgr_uds)
        self.osdmap = osdmap            # the COMMITTED map, only
        # -- acceptor state (the peon role) --
        self._promised = 0              # highest pn promised
        self._accepted: tuple[int, int, bytes] | None = None
        #                               # (pn, epoch, blob) uncommitted
        # -- proposer state (the leader role) --
        self._pn = 0                    # pn held after collect quorum
        self._pn_seen = 0               # highest pn observed anywhere
        self._collecting: list | None = None   # [pn, responders, best]
        self._inflight: tuple[int, int, bytes, list] | None = None
        #                               # (pn, epoch, blob, mutations)
        self._accepts: set[str] = set()
        # Serialized proposal pipe (one begin in flight at a time):
        # queued mutate closures rebase onto the LATEST committed map
        # before proposing, so in-flight proposals can never collide
        # on an epoch key or silently drop each other's mutations.
        self._mutations: list = []
        self._reporters: dict[int, set[str]] = {}
        # epoch -> encoded Incremental for recent consecutive commits
        # (the delta fan-out source; bounded, full maps cover evictions)
        self._inc_cache: dict[int, bytes] = {}
        self._lock = threading.RLock()
        self._peer_pong: dict[int, float] = {}
        # peers start PRESUMED ALIVE for one grace window: a freshly
        # (re)started monitor must not claim leadership over a living
        # lower rank it simply hasn't heard from yet (dual-leader
        # window). Death is proven by grace expiry, not assumed.
        self._boot = time.monotonic()
        self._stop = threading.Event()
        # observability: paxos/mon counters + the per-monitor
        # MgrReport aggregate every daemon broadcasts into (the mgr
        # DaemonStateIndex role — this tier has no separate mgr
        # daemon, disclosed in ARCHITECTURE.md)
        from ..mgr.reports import MgrReportAggregator
        from ..utils.perf_counters import PerfCountersBuilder
        self.perf = (PerfCountersBuilder(f"mon.{rank}")
                     .add_u64_counter("paxos_collects",
                                      "collect rounds started")
                     .add_u64_counter("paxos_begins",
                                      "begin batches proposed")
                     .add_u64_counter("paxos_commits",
                                      "commits this monitor drove")
                     .add_u64_counter("paxos_commits_folded",
                                      "commits learned from peers")
                     .add_u64_counter("paxos_nacks_rx",
                                      "rounds lost to a nack")
                     .add_u64_counter("map_broadcasts",
                                      "map fan-outs to subscribers")
                     .add_u64_counter("map_inc_broadcasts",
                                      "incremental (delta) map "
                                      "fan-outs to subscribers")
                     .add_u64_counter("map_full_serves",
                                      "full maps served on request "
                                      "(inc chain gap at a subscriber)")
                     .add_u64_counter("mgr_reports_rx",
                                      "MgrReports ingested")
                     .add_u64_counter("mon_cmds",
                                      "read-only commands answered")
                     .add_u64_counter("full_flag_flips",
                                      "capacity-ladder commits: any "
                                      "per-OSD nearfull/backfillfull/"
                                      "full state, the cluster FULL "
                                      "flag, or a pool-quota flag "
                                      "changed in the map")
                     .add_u64("osdmap_epoch", "committed map epoch")
                     .create_perf_counters())
        self.mgr = MgrReportAggregator()
        # r18: a monitor config view layering the COMMITTED map's
        # config KV over g_conf defaults — what lets `config set
        # mgr_slo_rules ...` retune a running monitor's telemetry
        # evaluation (daemons get the same via their own layered
        # config; monitors never built one)
        self.conf_view = _MonConfigView(self)
        # r15: per-monitor trace assembler — every monitor stitches
        # the span streams riding the MgrReport pipe independently,
        # so any one of them can answer `ceph_cli trace`; r18 gives it
        # the config view so its continuous critical-path profile
        # aligns with the telemetry plane's history intervals
        from ..mgr.tracing import TraceAssembler
        self.traces = TraceAssembler(config=self.conf_view)
        # r18 telemetry plane: every monitor independently folds the
        # history entries riding MgrReports into cluster time-series,
        # merged quantiles, SLO burn verdicts, and the observed-
        # client-latency feed
        from ..mgr.telemetry import TelemetryAggregator
        self.telemetry = TelemetryAggregator(config=self.conf_view)
        from ..utils.perf_counters import MetricsHistory
        self.metrics_history = MetricsHistory(
            lambda: {self.perf.name: self.perf.dump(),
                     "msgr": self.msgr.perf.dump()},
            config=self.conf_view)
        # r19 continuous profiling: every monitor folds the profile
        # entries riding MgrReports into cluster/per-daemon flame
        # profiles, and is a profiled citizen itself (its own sampler
        # ticks on the self-report cadence)
        from ..mgr.profiles import ProfileAggregator
        from ..utils.profiler import SamplingProfiler
        self.profiles = ProfileAggregator(config=self.conf_view)
        self.profiler = SamplingProfiler(self.name,
                                         config=self.conf_view).start()
        # r22 network observability: every monitor independently folds
        # the links+flow claims riding MgrReports into the cluster
        # link matrix — serves dump_osd_network, raises
        # OSD_SLOW_PING_TIME, and feeds link_cost to the consumers
        from ..mgr.netobs import NetworkAggregator
        self.netobs = NetworkAggregator(config=self.conf_view)
        self._mgr_seq = 0
        self._mgr_last_sent = 0.0
        from ..utils.admin_socket import AdminSocket
        self.asok = AdminSocket(cluster.asok_path(self.name))
        for _cmd in ("status", "health", "health detail", "prometheus",
                     "perf dump", "perf schema", "report dump",
                     "mon_status", "log dump", "autoscale status",
                     "telemetry", "slo", "top", "profile", "df",
                     "dump_osd_network"):
            self.asok.register(_cmd,
                               lambda args, c=_cmd: self._mon_cmd_obj(c))
        # argumented: `trace slow` / `trace list` / `trace <id-hex>`
        self.asok.register(
            "trace",
            lambda args: self._mon_cmd_obj(("trace " + args).strip()),
            "assembled distributed traces: slow | list | <trace-id>")
        # argumented; longest-prefix dispatch keeps it ahead of the
        # bare `profile` (the r18 critical-path series)
        self.asok.register(
            "profile cpu",
            lambda args: self._mon_cmd_obj(
                ("profile cpu " + args).strip()),
            "cluster CPU flame profiles (r19): [daemon] "
            "[--collapsed|--speedscope]")
        self.asok.start()
        m = self.msgr
        m.register_handler(MMgrReport.type_id, self._on_mgr_report)
        m.register_handler(MMonCmd.type_id, self._on_mon_cmd)
        m.register_handler(MOSDFailure.type_id, self._on_failure)
        m.register_handler(MOSDBoot.type_id, self._on_boot)
        m.register_handler(MOSDAlive.type_id, self._on_alive)
        m.register_handler(MMonCollect.type_id, self._on_collect)
        m.register_handler(MMonLast.type_id, self._on_last)
        m.register_handler(MMonBegin.type_id, self._on_begin)
        m.register_handler(MMonAcceptPn.type_id, self._on_accept)
        m.register_handler(MMonCommit.type_id, self._on_commit)
        m.register_handler(MMonNack.type_id, self._on_nack)
        m.register_handler(MMonSyncReq.type_id, self._on_sync_req)
        m.register_handler(MOSDMapRequest.type_id, self._on_map_request)
        m.register_handler(MMonJoin.type_id, self._on_mon_join)
        m.register_handler(MOsdAdmin.type_id, self._on_osd_admin)
        # cephx service (ref: AuthMonitor + CephxServiceHandler).
        # Every monitor serves auth against the shared KeyServer (its
        # state is cluster bootstrap config here; KeyServer paxos
        # replication is out of this tier's scope, disclosed).
        self.auth_svc = None
        self.verifier = None
        self._authed: dict[str, dict] = {}
        if cluster.key_server is not None:
            from ..auth import AuthService, ServiceVerifier
            self.auth_svc = AuthService(cluster.key_server)
            # the monitor is itself a ticket-gated service: admin ops
            # (pool snaps, central config) need a mon ticket with w
            self.verifier = ServiceVerifier(
                "mon", cluster.key_server.export_rotating("mon"))
            m.register_handler(MAuthOp.type_id, self._on_auth)
        m.register_handler(MPoolOp.type_id, self._on_pool_op)
        m.register_handler(MPoolQuotaOp.type_id, self._on_pool_quota)
        m.register_handler(MConfigOp.type_id, self._on_config_op)
        m.register_handler(MOSDPing.type_id, self._on_ping)
        m.register_handler(MOSDPingReply.type_id, self._on_pong)
        self._hb = threading.Thread(target=self._mon_hb_loop,
                                    daemon=True)
        self._hb.start()

    # -- election (rank + liveness, gated on monmap membership) --------------

    def _members(self) -> list[int]:
        """Quorum membership from the COMMITTED map (the monmap role).
        Before any map is known (cluster bootstrap), every constructed
        monitor is presumed a member."""
        if self.osdmap is not None:
            return self.osdmap.mon_members
        return [m.rank for m in self.c.mons]

    def _alive_ranks(self) -> set[int]:
        mem = set(self._members())
        now = time.monotonic()
        alive = {self.rank} & mem
        for mon in self.c.mons:
            r = mon.rank
            if r == self.rank or r not in mem:
                continue
            last = self._peer_pong.get(r, self._boot)
            if now - last <= self.c.hb_grace:
                alive.add(r)
        return alive

    def is_leader(self) -> bool:
        """Lowest alive MEMBER leads; a removed monitor can never lead
        (nor count itself toward any quorum) even while its process
        is still running."""
        alive = self._alive_ranks()
        return bool(alive) and self.rank == min(alive)

    def _on_ping(self, peer: str, msg: MOSDPing) -> None:
        if peer.startswith("mon."):
            # a ping from a monitor proves it alive RIGHT NOW — record
            # it so a revived lower rank is seen leading within one of
            # ITS heartbeats instead of one of ours (shrinks the
            # dual-leader window to the revive→first-ping gap)
            self._peer_pong[int(peer[4:])] = time.monotonic()
        try:
            self.msgr.send(peer, MOSDPingReply(msg.stamp))
        except (KeyError, OSError, ConnectionError):
            pass

    def _on_pong(self, peer: str, msg: MOSDPingReply) -> None:
        if peer.startswith("mon."):
            self._peer_pong[int(peer[4:])] = time.monotonic()

    def _mon_hb_loop(self) -> None:
        # ping FIRST, wait after: a freshly revived monitor must
        # announce itself before the first interval elapses, or the
        # old leader keeps leading a full heartbeat longer than needed
        while not self._stop.is_set():
            if getattr(self.c, "mons", None) is None:
                # cluster constructor still building the quorum
                self._stop.wait(0.02)
                continue
            for mon in self.c.mons:
                if mon.rank == self.rank or mon._stop.is_set():
                    continue
                try:
                    self.msgr.send(mon.name,
                                   MOSDPing(time.monotonic()))
                except (KeyError, OSError, ConnectionError):
                    pass
            # drive the Paxos machine: a leader retransmits its
            # outstanding collect/begin (their frames may have died
            # with a connection — both are idempotent at the peon),
            # collects when it holds no pn, proposes when the pipe is
            # idle. A NON-leader abandons proposer state so it can't
            # duel the real leader's pn (its mutations requeue and
            # re-propose if leadership ever returns).
            if self.is_leader():
                # r21 capacity ladder: only the leader evaluates — a
                # queued mutation from a stale evaluation rebases to a
                # no-op against the committed map anyway
                try:
                    self._capacity_tick()
                except Exception:  # noqa: BLE001 — the ladder must
                    pass           # never kill the mon heartbeat
                with self._lock:
                    col = self._collecting
                    infl = self._inflight
                    active = self._pn != 0
                if col is not None:
                    self._send_peers(MMonCollect(col[0]))
                elif infl is not None:
                    self._send_peers(MMonBegin(*infl[:3]))
                elif not active:
                    self._start_collect()
                else:
                    self._try_propose()
            else:
                with self._lock:
                    if self._collecting is not None \
                            or self._inflight is not None or self._pn:
                        self._abandon_locked()
                    # prune queued mutations the committed map already
                    # carries: a mon that never leads must not hoard
                    # no-op closures forever
                    if self._mutations and self.osdmap is not None:
                        base = self.osdmap
                        raw = base.encode()
                        keep = []
                        for mutate in self._mutations:
                            cand = OSDMap.decode(raw,
                                                 device=self.device)
                            mutate(cand)
                            if cand.epoch != base.epoch:
                                keep.append(mutate)
                        self._mutations = keep
            try:
                self._self_report(broadcast=True)
            except Exception:    # noqa: BLE001 — observability must
                pass             # never kill the mon heartbeat
            if self._stop.wait(self.c.hb_interval):
                return

    # -- shared helpers ------------------------------------------------------

    def _majority(self) -> int:
        return len(self._members()) // 2 + 1

    def _send_peers(self, msg: Message) -> None:
        for mon in self.c.mons:
            if mon is not self and not mon._stop.is_set():
                try:
                    self.msgr.send(mon.name, msg)
                except (KeyError, OSError, ConnectionError):
                    pass

    def _committed_pair(self) -> tuple[int, bytes]:
        """Caller holds the lock. (0, b'') = no committed map yet."""
        if self.osdmap is None:
            return 0, b""
        return self.osdmap.epoch, self.osdmap.encode()

    def _fold_committed_locked(self, epoch: int, blob: bytes) -> None:
        """Adopt a COMMITTED map learned from a peer (Last/Nack/
        Commit frames carry one). Commit adoption is always safe —
        a majority durably accepted it — and monotonic by epoch."""
        if epoch and (self.osdmap is None or epoch > self.osdmap.epoch):
            old = self.osdmap
            self.osdmap = OSDMap.decode(blob, device=self.device)
            self._note_inc_locked(old, self.osdmap)
        if self._accepted is not None and self.osdmap is not None \
                and self._accepted[1] <= self.osdmap.epoch:
            self._accepted = None    # superseded by a commit
        if self._inflight is not None and self.osdmap is not None \
                and self._inflight[1] <= self.osdmap.epoch:
            # our in-flight value's epoch just committed (ours or a
            # rival's body): the round is over — requeue its mutations
            # for a rebase so late replayed accepts can't resurrect it
            self._mutations = self._inflight[3] + self._mutations
            self._inflight = None
            self._accepts = set()

    def _abandon_below_locked(self, pn: int) -> None:
        """Caller holds the lock, having just promised `pn`. ANY of
        our proposer rounds below it — held pn, outstanding collect,
        in-flight begin — can no longer win and must die NOW: a
        collect completed after the higher promise would let us
        begin/self-accept BELOW our own promise, downgrading the
        accepted-pn of a value a later quorum relies on (acceptor
        monotonicity is what the safety argument rests on)."""
        if (self._pn and self._pn < pn) \
                or (self._collecting is not None
                    and self._collecting[0] < pn) \
                or (self._inflight is not None
                    and self._inflight[0] < pn):
            self._abandon_locked()

    def _abandon_locked(self) -> None:
        """Caller holds the lock. Drop proposer state; REQUEUE any
        in-flight mutations at the front of the pipe (each mutate
        closure re-checks its precondition, so one the winning leader
        already committed rebases to a no-op). A lost round must never
        silently drop a mutation: a lost MOSDBoot would leave a
        revived OSD down forever (it boots exactly once)."""
        if self._inflight is not None:
            self._mutations = self._inflight[3] + self._mutations
        self._inflight = None
        self._collecting = None
        self._accepts = set()
        self._pn = 0

    # -- acceptor (peon) side ------------------------------------------------

    def _on_collect(self, peer: str, msg: MMonCollect) -> None:
        reply: Message
        with self._lock:
            self._pn_seen = max(self._pn_seen, msg.pn)
            if msg.pn >= self._promised:
                self._promised = msg.pn
                self._abandon_below_locked(msg.pn)
                apn, aep, ablob = self._accepted or (0, 0, b"")
                cep, cblob = self._committed_pair()
                reply = MMonLast(msg.pn, apn, aep, ablob, cep, cblob)
            else:
                reply = MMonNack(msg.pn, self._promised,
                                 *self._committed_pair())
        try:
            self.msgr.send(peer, reply)
        except (KeyError, OSError, ConnectionError):
            pass

    def _on_begin(self, peer: str, msg: MMonBegin) -> None:
        reply: Message
        with self._lock:
            self._pn_seen = max(self._pn_seen, msg.pn)
            committed = self.osdmap.epoch if self.osdmap else 0
            if msg.pn < self._promised or msg.epoch <= committed:
                # promised a higher round, or the value's epoch is
                # already committed (stale/replayed begin): refuse,
                # teaching the proposer our promise + committed map
                reply = MMonNack(msg.pn, self._promised,
                                 *self._committed_pair())
            else:
                self._promised = msg.pn
                self._abandon_below_locked(msg.pn)
                self._accepted = (msg.pn, msg.epoch, msg.map_bytes)
                reply = MMonAcceptPn(msg.pn, msg.epoch)
        try:
            self.msgr.send(peer, reply)
        except (KeyError, OSError, ConnectionError):
            pass

    def _on_commit(self, peer: str, msg: MMonCommit) -> None:
        with self._lock:
            fresh = self.osdmap is None \
                or msg.epoch > self.osdmap.epoch
            self._fold_committed_locked(msg.epoch, msg.map_bytes)
        if fresh:
            self.perf.inc("paxos_commits_folded")
            self.perf.set("osdmap_epoch", msg.epoch)
            # peons broadcast too: if the committing leader dies
            # between its commit fan-out and its subscriber fan-out,
            # subscribers would otherwise strand on the old epoch
            # until the next commit (subscribers dedup by epoch)
            self._broadcast(msg.epoch)

    def _on_osd_admin(self, peer: str, msg: MOsdAdmin) -> None:
        """`ceph osd out/in/reweight` (ref: OSDMonitor::
        prepare_command): idempotent weight mutations through the
        same Paxos pipe as everything else; cephx-gated like every
        admin broadcast."""
        if self.osdmap is None:
            return
        if self._mon_admin_denied(peer, f"osd {msg.kind} {msg.osd}"):
            return
        kind, osd, weight = msg.kind, msg.osd, msg.weight
        if not 0 <= osd < len(self.osdmap.osd_weight):
            # bounds-check BEFORE queueing: an IndexError inside the
            # proposal pipe would drop co-queued mutations, and a
            # negative id would numpy-wrap onto the wrong OSD
            self.c.log(f"{self.name}: REJECT osd admin {kind} "
                       f"osd.{osd} (no such osd)")
            return
        self.c.log(f"{self.name}: osd admin {kind} osd.{osd}")

        def mutate(m: OSDMap) -> None:
            w = int(weight * 0x10000)
            if kind == "out":
                # ADMIN out is sticky: a later boot must not reverse
                # it the way it reverses the failure path's auto-out
                if m.osd_weight[osd] != 0:
                    m.mark_out(osd)
                    m.osd_admin_out.add(osd)
                elif osd not in m.osd_admin_out:
                    m.osd_admin_out.add(osd)
                    m._bump()
            elif kind == "in" and (m.osd_weight[osd] == 0
                                   or osd in m.osd_admin_out):
                m.osd_admin_out.discard(osd)
                if m.osd_weight[osd] == 0:
                    m.mark_in(osd, weight)
                else:
                    m._bump()
            elif kind == "reweight" and m.osd_weight[osd] != w:
                if w == 0:
                    # weight-to-zero must behave like `osd out`:
                    # mark_out also clears pg_upmap entries that
                    # would keep pinning slots to the drained OSD
                    # (upmap redirection bypasses CRUSH's zero-weight
                    # rejection), and it's sticky like out
                    m.mark_out(osd)
                    m.osd_admin_out.add(osd)
                else:
                    m.osd_weight[osd] = w
                    # a positive admin reweight is an explicit 'in':
                    # clear the sticky admin-out flag so a later
                    # failure auto-out can be reversed by boot again
                    m.osd_admin_out.discard(osd)
                    m._bump()
        self._commit(mutate)

    def _on_mon_join(self, peer: str, msg: MMonJoin) -> None:
        """Membership change (ref: MonmapMonitor::prepare_join): queue
        the idempotent mutation; whoever leads commits it. Quorum math
        (_members/_majority/election) follows the COMMITTED map, so
        the change takes effect exactly at commit — Paxos
        reconfiguration by committing the new config through the old
        quorum."""
        if self.osdmap is None:
            return
        rank, join = msg.rank, msg.join
        self.c.log(f"{self.name}: mon.{rank} "
                   f"{'joins' if join else 'leaves'} (from {peer})")

        def mutate(m: OSDMap) -> None:
            if join:
                m.mon_join(rank)
            else:
                m.mon_leave(rank)
        self._commit(mutate)

    def _on_auth(self, peer: str, msg: MAuthOp) -> None:
        """cephx endpoint (ref: AuthMonitor::prep_auth): hello /
        authenticate mint the auth ticket; tickets mints per-service
        tickets. Byte fields travel hex-armored in JSON."""
        import json as _json
        if msg.kind == "authorize":
            rep = _daemon_authorize(
                self.verifier, _json.loads(msg.blob.decode()), peer,
                msg.req_id, self._authed,
                lambda: self.c.key_server.export_rotating("mon"))
            try:
                self.msgr.send(peer, rep)
            except (KeyError, OSError, ConnectionError):
                pass
            return
        try:
            req = _json.loads(msg.blob.decode())
            svc = self.auth_svc
            if msg.kind == "hello":
                sc = svc.hello(req["entity"], bytes.fromhex(req["cc"]))
                out = {"sc": sc.hex()}
            elif msg.kind == "authenticate":
                out = svc.authenticate(req["entity"],
                                       bytes.fromhex(req["cc"]),
                                       bytes.fromhex(req["proof"]))
            elif msg.kind == "tickets":
                out = svc.get_service_tickets(
                    req["ticket"], bytes.fromhex(req["nonce"]),
                    bytes.fromhex(req["mac"]), req["services"])
            else:
                raise ValueError(f"unknown auth op {msg.kind!r}")
            rep = MAuthReply(msg.req_id, True, msg.kind,
                             _json.dumps(out).encode())
        except Exception as e:   # noqa: BLE001 — reply, don't die
            rep = MAuthReply(msg.req_id, False, msg.kind,
                             err=f"{type(e).__name__}:{e}")
        try:
            self.msgr.send(peer, rep)
        except (KeyError, OSError, ConnectionError):
            pass

    def _on_sync_req(self, peer: str, msg) -> None:
        """A revived monitor asks for the current map; answer with the
        COMMITTED map only (an accepted-but-uncommitted value must
        never be served as durable state — the mon store sync role,
        ref: src/mon/Monitor.cc sync_start)."""
        with self._lock:
            epoch, blob = self._committed_pair()
        if epoch:
            try:
                self.msgr.send(peer, MMonCommit(epoch, blob))
            except (KeyError, OSError, ConnectionError):
                pass

    # -- observability (MgrReport aggregation + read-only commands) ----------

    def _on_mgr_report(self, peer: str, msg: MMgrReport) -> None:
        import json as _json
        try:
            report = _json.loads(msg.blob.decode())
            # r15: span streams ride the same pipe — fold them into
            # the trace assembler. Pure-trace reports (client flushes)
            # must NOT touch the perf aggregation (they carry no
            # counters and would churn the daemon staleness state).
            if report.get("spans"):
                self.traces.ingest(report["spans"])
            # r18: history entries, flight overflow accounting, and
            # client-shipped observed-latency histograms feed the
            # telemetry plane (same pipe, independent consumers)
            if report.get("history"):
                self.telemetry.ingest(report.get("name", "?"),
                                      report["history"])
            if report.get("flight") is not None:
                self.telemetry.note_flight(report.get("name", "?"),
                                           report["flight"])
            # r19: span-tagged profile deltas feed the flame
            # aggregation (same pipe, independent consumer)
            if report.get("profile"):
                self.profiles.ingest(report.get("name", "?"),
                                     report["profile"])
            if report.get("client_perf"):
                self.telemetry.ingest_client(report.get("name", "?"),
                                             report["client_perf"])
            # r22: links+flow claims feed the link matrix (same pipe,
            # independent consumer)
            if report.get("network"):
                self.netobs.ingest(report.get("name", "?"),
                                   report["network"])
            if report.get("kind") != "trace":
                self.mgr.ingest(report)
            self.perf.inc("mgr_reports_rx")
        except (ValueError, UnicodeDecodeError):
            pass                 # malformed report: drop, don't die

    def _self_report(self, broadcast: bool = False) -> None:
        """The monitor is a daemon too: fold its own counters into its
        aggregator (no wire hop — local ingest) and, on the
        mgr_report_interval cadence, ship them to peer monitors as a
        normal MMgrReport — so ANY monitor's `ceph status`/prometheus
        covers the whole control plane, not just itself. Broadcasts
        are throttled like OSD reports: a 12-daemon bench showed
        unthrottled per-beat self-reports (dump + schema + sealed
        frames ×peers ×4 Hz) costing real percent of the one core the
        data plane shares."""
        from ..utils.config import g_conf
        now = time.monotonic()
        if broadcast and now - self._mgr_last_sent \
                < float(g_conf["mgr_report_interval"]):
            return
        self._mgr_last_sent = now
        self._mgr_seq += 1
        report = {
            "name": self.name, "seq": self._mgr_seq, "kind": "full",
            "perf": {self.perf.name: self.perf.dump(),
                     "msgr": self.msgr.perf.dump()},
            "schema": {self.perf.name: self.perf.schema(),
                       "msgr": self.msgr.perf.schema()},
        }
        # r18: the monitor is a telemetry citizen too — on the
        # broadcast cadence, tick its own history ring, fold fresh
        # entries into its OWN aggregator (no wire hop) and ship them
        # to peers with the report
        if broadcast:
            try:
                self.metrics_history.maybe_tick()
                history = self.metrics_history.drain_unshipped()
                if history:
                    report["history"] = history
                    self.telemetry.ingest(self.name, history)
                # r19: the monitor's own CPU profile rides the same
                # cadence — folded locally, shipped to peers
                self.profiler.maybe_tick()
                pblock = {"entries": self.profiler.drain_unshipped(),
                          "stats": self.profiler.stats()}
                report["profile"] = pblock
                self.profiles.ingest(self.name, pblock)
                # r22: the monitor is a flow citizen too — it measures
                # no heartbeat links (empty links), but its per-peer
                # msgr ledger belongs in the cluster flow totals
                nblock = {"links": {}, "flow": self.msgr.flow_dump()}
                report["network"] = nblock
                self.netobs.ingest(self.name, nblock)
            except Exception:   # noqa: BLE001 — observability must
                pass            # not break the monitor's reporting
        self.mgr.ingest(report)
        if broadcast:
            import json as _json
            self._send_peers(MMgrReport(
                0, True, "full",
                _json.dumps(report,
                            separators=(",", ":")).encode()))

    def _mon_read_denied(self, peer: str) -> bool:
        """Read-only command gate: any mon session with r (the MonCap
        `allow r` the reference requires for status). The asok path
        never comes through here — local filesystem access IS the
        operator credential there, like the reference's asok."""
        if self.verifier is None:
            return False
        sess = self._authed.get(peer)
        caps = sess["caps"].get("mon") if sess else None
        return caps is None or not caps.allows("r")

    def _health_obj(self, detail: bool = True) -> dict:
        from ..mgr.health import health_checks
        from ..utils.config import g_conf
        res = health_checks(
            osdmap=self.osdmap,
            quorum=sorted(self._alive_ranks()),
            mon_members=self._members(),
            reports=self.mgr,
            stale_grace=float(g_conf["mgr_stale_report_grace"]),
            pg_num=self.c.pg_num,
            telemetry=self.telemetry,
            netobs=self.netobs)
        if not detail:
            for c in res["checks"]:
                c.pop("detail", None)
        return res

    def _status_obj(self) -> dict:
        alive = sorted(self._alive_ranks())
        with self._lock:
            epoch = self.osdmap.epoch if self.osdmap is not None else 0
            osds_up = int(sum(self.osdmap.osd_up)) \
                if self.osdmap is not None else 0
            osds_in = int(sum(1 for w in self.osdmap.osd_weight
                              if w > 0)) \
                if self.osdmap is not None else 0
            n_osds = len(self.osdmap.osd_up) \
                if self.osdmap is not None else 0
        counts: dict[str, int] = {}
        for st in self.mgr.pg_states().values():
            counts[st] = counts.get(st, 0) + 1
        health = self._health_obj(detail=False)
        return {
            "health": health["status"],
            "checks": [c["code"] for c in health["checks"]],
            "epoch": epoch,
            "num_osds": n_osds, "osds_up": osds_up,
            "osds_in": osds_in,
            "mon_members": self._members(),
            "mon_quorum": alive,
            "mon_leader": min(alive) if alive else None,
            "pg_states": counts,
            "pgs_total": self.c.pg_num,
            **self.mgr.totals(),
        }

    def _capacity_tick(self) -> None:
        """r21 full-ratio ladder (ref: OSDMonitor::update_full_status
        + get_full_ratios): leader-only heartbeat evaluation. Folds
        every OSD's latest statfs claim through the committed ratio
        ladder (mon_osd_nearfull_ratio / osd_backfillfull_ratio /
        mon_osd_full_ratio) into per-OSD states, derives the cluster
        FULL flag (any OSD at full) and pool-quota flags
        (quota_max_bytes/objects vs the MgrReport pool aggregates),
        and commits ONLY deltas — a queued closure rebases to a no-op
        when the committed map already agrees, so a quiet cluster
        proposes nothing."""
        if self.osdmap is None:
            return
        near = float(self.conf_view["mon_osd_nearfull_ratio"])
        bff = float(self.conf_view["osd_backfillfull_ratio"])
        full = float(self.conf_view["mon_osd_full_ratio"])
        states: dict[int, int] = {}
        up = self.osdmap.osd_up
        for name, st in self.mgr.statfs().items():
            if not name.startswith("osd."):
                continue
            osd_id = int(name[4:])
            if osd_id < len(up) and not up[osd_id]:
                # down OSD: its last claim is frozen history, not
                # capacity — a dead reporter must not hold a ladder
                # rung (ref: OSDMonitor skips down/out in
                # get_full_osd_counts)
                continue
            total = int(st.get("total", 0))
            if total <= 0:
                continue               # unbounded store: no ratio
            ratio = int(st.get("used", 0)) / total
            if ratio >= full:
                states[int(name[4:])] = FULL_FULL
            elif ratio >= bff:
                states[int(name[4:])] = FULL_BACKFILLFULL
            elif ratio >= near:
                states[int(name[4:])] = FULL_NEARFULL
        cluster_full = any(s >= FULL_FULL for s in states.values())
        pool_bytes = self.mgr.pool_bytes()
        pool_objects = self.mgr.pool_objects()
        full_pools: set[int] = set()
        for pid, p in self.osdmap.pools.items():
            qb, qo = int(p.quota_max_bytes), int(p.quota_max_objects)
            if (qb and pool_bytes.get(pid, 0) >= qb) \
                    or (qo and pool_objects.get(pid, 0) >= qo):
                full_pools.add(pid)
        cur = self.osdmap
        if (cur.osd_full_state == states
                and cur.cluster_full == cluster_full
                and cur.full_pools == full_pools):
            return
        self.perf.inc("full_flag_flips")
        self._commit(lambda m, s=dict(states), cf=cluster_full,
                     fp=tuple(sorted(full_pools)):
                     m.set_full_states(dict(s), cf, set(fp)))

    def _df_obj(self) -> dict:
        """`ceph df` (r21): per-OSD statfs + committed ladder state +
        per-pool usage vs quota — rendered from the same two sources
        the ladder itself uses (MgrReport claims, committed map), so
        the operator sees exactly what the mon decided from."""
        m = self.osdmap
        stat = self.mgr.statfs()
        osds: dict[str, dict] = {}
        tot_b = used_b = 0
        for name in sorted(stat):
            st = stat[name]
            total = int(st.get("total", 0))
            used = int(st.get("used", 0))
            ent = {"total": total, "used": used,
                   "avail": int(st.get("avail", 0)),
                   "ratio": round(used / total, 4) if total else 0.0}
            if name.startswith("osd.") and m is not None:
                ent["state"] = FULL_STATE_NAMES.get(
                    m.full_state_of(int(name[4:])), "ok")
            tot_b += total
            used_b += used
            osds[name] = ent
        pool_bytes = self.mgr.pool_bytes()
        pool_objects = self.mgr.pool_objects()
        pools: dict[str, dict] = {}
        if m is not None:
            for pid, p in sorted(m.pools.items()):
                pools[str(pid)] = {
                    "bytes": int(pool_bytes.get(pid, 0)),
                    "objects": int(pool_objects.get(pid, 0)),
                    "quota_max_bytes": int(p.quota_max_bytes),
                    "quota_max_objects": int(p.quota_max_objects),
                    "full": pid in m.full_pools}
        return {
            "epoch": m.epoch if m is not None else 0,
            "cluster_full": bool(m.cluster_full)
            if m is not None else False,
            "full_ratios": {
                "nearfull": float(
                    self.conf_view["mon_osd_nearfull_ratio"]),
                "backfillfull": float(
                    self.conf_view["osd_backfillfull_ratio"]),
                "full": float(self.conf_view["mon_osd_full_ratio"]),
                "failsafe": float(
                    self.conf_view["osd_failsafe_full_ratio"])},
            "total_bytes": tot_b,
            "total_used_bytes": used_b,
            "total_avail_bytes": max(0, tot_b - used_b),
            "osds": osds,
            "pools": pools,
        }

    def _mon_cmd_obj(self, kind: str):
        """ONE dispatcher for the wire MMonCmd and the monitor's admin
        socket — the `ceph status / health / prometheus` surface,
        rendered from the committed map + this monitor's own liveness
        view + MgrReport-aggregated REAL daemon counters."""
        from ..mgr import reports as _reports
        from ..utils.log import g_log
        self.perf.inc("mon_cmds")
        self.perf.set("osdmap_epoch",
                      self.osdmap.epoch if self.osdmap is not None
                      else 0)
        self._self_report()      # answer with our own counters fresh
        if kind == "status":
            return self._status_obj()
        if kind == "health":
            return self._health_obj(detail=False)
        if kind == "health detail":
            return self._health_obj(detail=True)
        if kind == "df":
            return self._df_obj()
        if kind == "prometheus":
            # r22: the link plane's bounded-cardinality exposition
            # (worst-N by p99) appends to the counter exposition
            return {"text": _reports.prometheus_text(self.mgr)
                    + self.netobs.prometheus_text()}
        if kind == "dump_osd_network" or kind == "netstat":
            # r22: the cluster link matrix (ref: the OSD-level
            # dump_osd_network, served cluster-wide here because the
            # aggregator already holds every daemon's claim)
            return self.netobs.dump()
        if kind == "perf dump":
            return {"cluster": self.mgr.cluster_perf(),
                    self.name: {self.perf.name: self.perf.dump(),
                                "msgr": self.msgr.perf.dump()}}
        if kind == "perf schema":
            return {self.perf.name: self.perf.schema(),
                    "msgr": self.msgr.perf.schema()}
        if kind == "report dump":
            return self.mgr.daemons()
        if kind == "mon_status":
            alive = sorted(self._alive_ranks())
            return {"rank": self.rank, "members": self._members(),
                    "quorum": alive,
                    "leader": min(alive) if alive else None,
                    "is_leader": self.is_leader(),
                    "epoch": self.osdmap.epoch
                    if self.osdmap is not None else 0}
        if kind == "log dump":
            return {"lines": g_log.dump_recent()}
        if kind == "autoscale status":
            from ..mgr.pg_autoscaler import autoscale_from_reports
            if self.osdmap is None:
                return []
            return autoscale_from_reports(self.mgr, self.osdmap)
        if kind == "telemetry":
            # r18: cluster time-series + merged quantiles + the
            # observed-client-latency feed + SLO verdicts
            return self.telemetry.dump()
        if kind == "slo":
            return {"rules": self.telemetry.slo_status(),
                    "burn_rate": self.telemetry.burn_rate(),
                    "regressions": self.telemetry.regressions(),
                    # r21: per-client capacity-stall accounting, so a
                    # flat write feed during a FULL window reads as
                    # "parked", not "idle" or "regressed"
                    "full_backoff": self.telemetry.full_backoff()}
        if kind == "top":
            # per-daemon rates over the newest history interval; the
            # r19 observability drop gauges ride along (sampler +
            # flight-ring loss is an operator-visible condition, not
            # a silent one)
            out = self.telemetry.top(reports=self.mgr)
            out["observability"] = {
                "flight_dropped_unshipped":
                    self.telemetry.flight_drops(),
                "profiler": self.profiles.stats(),
            }
            # r20: per-tenant mClock grant/throttle accounting folded
            # from the daemons' mclock report claims
            out["tenants"] = self.mgr.tenants()
            return out
        if kind == "profile cpu" or kind.startswith("profile cpu "):
            # r19 flame profiles: cluster/per-daemon span-tagged CPU
            # attribution from the daemons' sampling rings
            return self.profiles.cpu_cmd(
                kind[len("profile cpu"):].strip())
        if kind == "profile":
            # continuous critical-path attribution series (sampled
            # traces folded per interval — the drift view)
            return self.traces.profile()
        if kind == "trace list":
            return {"traces": self.traces.list_traces()}
        if kind == "trace slow":
            # slowest assembled traces with their critical-path
            # attribution — the cross-daemon complement of slow_ops
            return {"traces": self.traces.slow()}
        if kind.startswith("trace "):
            # `trace <id-hex>`: one assembled causal timeline +
            # attribution summary + Chrome trace-event JSON
            return self.traces.assemble(kind[len("trace "):].strip())
        raise ValueError(f"unknown mon command {kind!r}")

    def _on_mon_cmd(self, peer: str, msg: MMonCmd) -> None:
        import json as _json
        if self._mon_read_denied(peer):
            rep = MMonCmdReply(msg.req_id, False, msg.kind,
                               err="EPERM:need mon r")
        else:
            try:
                rep = MMonCmdReply(
                    msg.req_id, True, msg.kind,
                    _json.dumps(self._mon_cmd_obj(msg.kind),
                                sort_keys=True, default=str).encode())
            except Exception as e:   # noqa: BLE001 — reply, don't die
                rep = MMonCmdReply(msg.req_id, False, msg.kind,
                                   err=f"{type(e).__name__}:{e}")
        try:
            self.msgr.send(peer, rep)
        except (KeyError, OSError, ConnectionError):
            pass

    # -- proposer (leader) side ----------------------------------------------

    def _next_pn_locked(self) -> int:
        n = (self._pn_seen >> 8) + 1
        pn = (n << 8) | self.rank
        self._pn_seen = pn
        return pn

    def _start_collect(self) -> None:
        with self._lock:
            if self._collecting is not None:
                return
            pn = self._next_pn_locked()
            # self-promise: we are one acceptor of our own round, and
            # promising our own pn keeps a lower concurrent collector
            # from splitting us off its quorum
            self._promised = max(self._promised, pn)
            self._collecting = [pn, set(), None]
        self.perf.inc("paxos_collects")
        self._send_peers(MMonCollect(pn))

    def _on_last(self, peer: str, msg: MMonLast) -> None:
        begin = None
        with self._lock:
            self._pn_seen = max(self._pn_seen, msg.accepted_pn)
            col = self._collecting
            if col is None or col[0] != msg.pn:
                return           # stale round
            if int(peer[4:]) not in self._members():
                return           # non-member promise must not count
                                 # toward a collect quorum
            if col[0] < self._promised:
                # we promised a rival's higher pn mid-collect: this
                # round is dead (belt to _abandon_below_locked)
                self._abandon_locked()
                return
            col[1].add(peer)
            self._fold_committed_locked(msg.committed_epoch,
                                        msg.committed_blob)
            committed = self.osdmap.epoch if self.osdmap else 0
            if msg.accepted_pn and msg.accepted_epoch > committed \
                    and (col[2] is None or msg.accepted_pn > col[2][0]):
                col[2] = (msg.accepted_pn, msg.accepted_epoch,
                          msg.accepted_blob)
            if len(col[1]) + 1 < self._majority():
                return
            # collect quorum: we hold the round. Any value accepted by
            # a majority is guaranteed visible here (quorum
            # intersection) — re-drive the highest-pn uncommitted one
            # under OUR pn before proposing anything new, or a
            # committed-elsewhere value could be lost.
            self._pn = col[0]
            self._collecting = None
            best = col[2]
            if self._accepted is not None \
                    and self._accepted[1] > committed \
                    and (best is None or self._accepted[0] > best[0]):
                best = self._accepted
            if best is not None and best[1] > committed:
                self._inflight = (self._pn, best[1], best[2], [])
                self._accepts = set()
                self._accepted = (self._pn, best[1], best[2])
                begin = MMonBegin(self._pn, best[1], best[2])
        if begin is not None:
            self._send_peers(begin)
        else:
            self._try_propose()

    def _on_accept(self, peer: str, msg: MMonAcceptPn) -> None:
        committed = None
        with self._lock:
            if self._inflight is None or self._inflight[0] != msg.pn \
                    or self._inflight[1] != msg.epoch:
                return           # superseded / already committed
            if int(peer[4:]) not in self._members():
                return           # non-member accept must not count
            self._accepts.add(peer)
            # commit once, on reaching a majority (self included) —
            # only NOW does the proposer's own map advance
            # (propose-then-commit: a quorum-less leader's mutation
            # must never become its local state, or a later store
            # sync would make it durable without a majority)
            if len(self._accepts) + 1 < self._majority():
                return
            pn, epoch, blob, muts = self._inflight
            self._inflight = None
            self._accepts = set()
            if self.osdmap is not None and epoch <= self.osdmap.epoch:
                # a newer commit folded in while the accepts were in
                # flight (partition heal replays them late): NEVER
                # regress the committed map — requeue for rebase
                self._mutations = muts + self._mutations
            else:
                old = self.osdmap
                self.osdmap = OSDMap.decode(blob, device=self.device)
                self._note_inc_locked(old, self.osdmap)
                if self._accepted is not None \
                        and self._accepted[1] <= epoch:
                    self._accepted = None
                committed = (epoch, blob)
        if committed is not None:
            self.perf.inc("paxos_commits")
            self.perf.set("osdmap_epoch", committed[0])
            self._send_peers(MMonCommit(*committed))
            self._broadcast(committed[0])
            self._try_propose()

    def _on_nack(self, peer: str, msg: MMonNack) -> None:
        """We lost a round (higher promise out there) or proposed a
        stale epoch: adopt the refuser's committed map, stand down,
        and let the next heartbeat re-collect at a higher pn if we
        still lead. A nack for some EARLIER round (replayed across a
        heal) still teaches the committed map but must not abort the
        current healthy round."""
        with self._lock:
            if int(peer[4:]) not in self._members():
                # a non-member (e.g. a freshly booted, not-yet-joined
                # monitor whose promised pn a rogue collect raised)
                # must not abort a member round — same filter as
                # _on_last/_on_accept
                return
            self._pn_seen = max(self._pn_seen, msg.promised)
            self._fold_committed_locked(msg.committed_epoch,
                                        msg.committed_blob)
            current = msg.nacked and (
                (self._collecting is not None
                 and self._collecting[0] == msg.nacked)
                or (self._inflight is not None
                    and self._inflight[0] == msg.nacked)
                or self._pn == msg.nacked)
            if current:
                self._abandon_locked()
        if current:
            self.perf.inc("paxos_nacks_rx")

    def _commit(self, mutate) -> None:
        """Queue `mutate` on the serialized proposal pipe; the map
        advances only when a majority accepts (see _on_accept)."""
        with self._lock:
            self._mutations.append(mutate)
        if self.is_leader():
            self._try_propose()

    def _try_propose(self) -> None:
        """Start the next begin batch if the pipe is idle and we hold
        a collected pn: rebase every queued mutation onto the LATEST
        committed map, propose the combined candidate. A batch whose
        mutations all rebase to no-ops (the committed map already
        carries them) is dropped."""
        begin = None
        with self._lock:
            if self._inflight is not None or not self._pn \
                    or self._collecting is not None \
                    or not self._mutations or self.osdmap is None:
                return
            candidate = OSDMap.decode(
                self.osdmap.encode(), device=self.device)
            batch = self._mutations
            self._mutations = []
            kept = []
            for mutate in batch:
                try:
                    mutate(candidate)
                    kept.append(mutate)
                except Exception as e:   # noqa: BLE001 — one poison
                    # mutation must not destroy its co-queued batch
                    # (nor the proposal pipe): drop it and rebuild
                    # the candidate (it may be HALF-mutated), then
                    # replay the survivors
                    self.c.log(f"{self.name}: DROP mutation "
                               f"({type(e).__name__}: {e})")
                    candidate = OSDMap.decode(
                        self.osdmap.encode(), device=self.device)
                    for ok_mut in kept:
                        ok_mut(candidate)
            batch = kept
            if candidate.epoch == self.osdmap.epoch:
                return
            epoch, blob = candidate.epoch, candidate.encode()
            self._inflight = (self._pn, epoch, blob, batch)
            self._accepts = set()
            self._accepted = (self._pn, epoch, blob)  # self-accept
            begin = MMonBegin(self._pn, epoch, blob)
        self.perf.inc("paxos_begins")
        self._send_peers(begin)

    def _note_inc_locked(self, old: OSDMap | None,
                         new: OSDMap) -> None:
        """Derive + cache the delta for a freshly adopted consecutive
        epoch (caller holds the lock). Non-consecutive adoption (store
        sync across a gap) just doesn't cache — subscribers on the
        old epoch will request a full map."""
        if old is None or new.epoch != old.epoch + 1:
            return
        self._inc_cache[new.epoch] = Incremental.diff(old, new).encode()
        while len(self._inc_cache) > 32:
            del self._inc_cache[min(self._inc_cache)]

    def _broadcast(self, epoch: int) -> None:
        """Fan the committed epoch to every subscriber: a DELTA when
        this monitor holds the consecutive incremental and the epoch
        is off the full-map cadence, the full map otherwise (ref:
        OSDMonitor send_incremental — full every Nth epoch or on
        request, deltas in between)."""
        from ..utils.config import g_conf
        with self._lock:
            if self.osdmap is None or self.osdmap.epoch != epoch:
                return
            inc = self._inc_cache.get(epoch)
            full_every = max(1, int(g_conf["mon_osdmap_full_every"]))
            if inc is not None and epoch % full_every:
                cls_, blob, ctr = MOSDIncMapMsg, inc, "map_inc_broadcasts"
            else:
                cls_, blob, ctr = (MOSDMapMsg, self.osdmap.encode(),
                                   "map_broadcasts")
        self.perf.inc(ctr)
        for peer in self.c.map_subscribers():
            try:
                self.msgr.send(peer, cls_(epoch, blob))
            except (KeyError, OSError, ConnectionError):
                pass

    def _on_map_request(self, peer: str, msg: MOSDMapRequest) -> None:
        """Serve the full committed map to a subscriber that could not
        chain an incremental (gap, fresh boot) — the on-request half
        of the full-map cadence."""
        with self._lock:
            if self.osdmap is None or self.osdmap.epoch <= msg.epoch:
                return
            epoch, blob = self.osdmap.epoch, self.osdmap.encode()
        self.perf.inc("map_full_serves")
        try:
            self.msgr.send(peer, MOSDMapMsg(epoch, blob))
        except (KeyError, OSError, ConnectionError):
            pass

    def _on_failure(self, peer: str, msg: MOSDFailure) -> None:
        # EVERY mon queues the mutation (reports are broadcast to all):
        # only the current leader proposes, so whoever leads when the
        # pipe drains carries it — a report consumed by a monitor that
        # loses leadership a beat later is not lost, and a duplicate
        # rebases to a no-op against the committed map.
        if self.osdmap is None:
            return
        with self._lock:
            osd = msg.failed
            if msg.alive:
                # retraction: the reporter heard the peer again
                self._reporters.get(osd, set()).discard(peer)
                return
            if not self.osdmap.osd_up[osd]:
                return
            rep = self._reporters.setdefault(osd, set())
            rep.add(peer)
            if len(rep) < self.c.min_reporters:
                return
            del self._reporters[osd]
        self.c.log(f"{self.name}: marking osd.{osd} down+out "
                   f"({self.c.min_reporters} reporters)")

        def mutate(m: OSDMap) -> None:
            # precondition re-checked so a rebase onto a map that
            # already carries the mark is a no-op, not a double bump
            if m.osd_up[osd]:
                m.mark_down(osd)
                m.mark_out(osd)
        self._commit(mutate)

    def _on_boot(self, peer: str, msg: MOSDBoot) -> None:
        if self.osdmap is None:
            return
        osd = msg.failed
        self.c.log(f"{self.name}: osd.{osd} boots")

        def mutate(m: OSDMap) -> None:
            if not m.osd_up[osd]:
                m.mark_up(osd)
            # boot reverses the failure path's auto-out, NEVER an
            # administrator's sticky `osd out` (ref: AUTOOUT flag)
            if m.osd_weight[osd] == 0 and osd not in m.osd_admin_out:
                m.mark_in(osd)
        self._commit(mutate)

    def _on_alive(self, peer: str, msg: MOSDAlive) -> None:
        """up_thru request (ref: OSDMonitor::prepare_alive): record
        the claimed epoch through the same Paxos pipe as every other
        map mutation — the commit IS the activation permission the
        requesting primary is waiting on. Monotone/idempotent, so a
        duplicate or stale request rebases to a no-op."""
        if self.osdmap is None:
            return
        osd, want = msg.osd, msg.want
        if not _valid_osd(osd, len(self.osdmap.osd_up)):
            return

        def mutate(m: OSDMap) -> None:
            m.record_up_thru(osd, want)
        self._commit(mutate)

    def _mon_admin_denied(self, peer: str, what: str) -> bool:
        """Admin-plane gate (ref: MonCap check in
        Monitor::_allowed_command): with cephx on, pool/config
        mutations from peers without a mon session carrying w are
        DROPPED (these frames are fire-and-forget broadcasts; the
        client's commit-wait surfaces the refusal as a timeout).
        Daemon-internal traffic (failure reports, boots, paxos) stays
        ungated at this tier — it rides the transport-level shared
        secret when one is configured."""
        if self.verifier is None:
            return False
        sess = self._authed.get(peer)
        caps = sess["caps"].get("mon") if sess else None
        if caps is None or not caps.allows("w"):
            self.c.log(f"{self.name}: DROP {what} from {peer} "
                       f"(mon caps: "
                       f"{'none' if sess is None else 'no w'})")
            return True
        return False

    def _on_pool_op(self, peer: str, msg: MPoolOp) -> None:
        if self.osdmap is None:
            return
        if self._mon_admin_denied(peer, f"pool op {msg.kind}"):
            return
        kind, snap = msg.kind, msg.snap_name
        self.c.log(f"{self.name}: pool op {kind} {snap!r} from {peer}")

        def mutate(m: OSDMap) -> None:
            # both are name-idempotent: a duplicate rebases to a no-op
            if kind == "mksnap":
                m.pool_mksnap(1, snap)
            elif kind == "rmsnap":
                m.pool_rmsnap(1, snap)
        self._commit(mutate)

    def _on_pool_quota(self, peer: str, msg: MPoolQuotaOp) -> None:
        """`ceph osd pool set-quota` (r21): commit the quota onto the
        map; the leader's next capacity tick evaluates it against the
        MgrReport pool aggregates and raises/clears POOL_FULL."""
        if self.osdmap is None:
            return
        if self._mon_admin_denied(peer, f"pool quota {msg.pool_id}"):
            return
        if msg.pool_id not in self.osdmap.pools:
            self.c.log(f"{self.name}: REJECT pool quota "
                       f"(no pool {msg.pool_id})")
            return
        self.c.log(f"{self.name}: pool {msg.pool_id} quota "
                   f"bytes={msg.max_bytes} objects={msg.max_objects} "
                   f"from {peer}")
        self._commit(lambda m, p=msg.pool_id, b=msg.max_bytes,
                     o=msg.max_objects: m.set_pool_quota(p, b, o))

    def _on_config_op(self, peer: str, msg: MConfigOp) -> None:
        """Centralized config mutation (the ConfigMonitor role): the
        KV rides the same Paxos-committed value as the map, so a
        `config set` is durable exactly when a majority accepted it
        and every daemon observes it through its map subscription."""
        if self.osdmap is None:
            return
        if self._mon_admin_denied(peer, f"config {msg.kind} {msg.key}"):
            return
        kind, key, value = msg.kind, msg.key, msg.value
        self.c.log(f"{self.name}: config {kind} {key}={value!r} "
                   f"from {peer}")

        def mutate(m: OSDMap) -> None:
            # value-idempotent: a duplicate rebases to a no-op
            if kind == "set":
                m.config_set(key, value)
            elif kind == "rm":
                m.config_rm(key)
        self._commit(mutate)

    def kill(self) -> None:
        self._stop.set()
        self.profiler.stop()
        self.asok.stop()
        self.msgr.shutdown()


class _WireAuth:
    """ClientAuth's transport: the three monitor-side auth methods as
    MAuthOp frames against whichever monitor answers (ref: MonClient
    hunting across monitors). The last answering monitor is sticky so
    a hello/authenticate pair lands on the SAME AuthService (each
    monitor keeps its own outstanding-challenge table)."""

    def __init__(self, cluster: "StandaloneCluster", rpc: _Rpc):
        self.c = cluster
        self.rpc = rpc
        self._sticky: str | None = None

    def _call(self, method: str, payload: dict) -> dict:
        import json as _json
        from ..auth import AuthError
        last = None
        mons = self.c.mon_names()
        if self._sticky in mons:
            mons.remove(self._sticky)
            mons.insert(0, self._sticky)
        for mon in mons:
            try:
                # short per-monitor timeout: a dead/partitioned
                # monitor must cost the hunt ~2s, not stall a caller
                # (possibly a daemon dispatch thread) for 5+
                rep = self.rpc.call(
                    mon, lambda rid: MAuthOp(
                        rid, True, method,
                        _json.dumps(payload).encode()),
                    timeout=2.0)
            except (ConnectionError, KeyError, OSError) as e:
                last = str(e)
                if self._sticky == mon:
                    self._sticky = None
                continue            # hunt the next monitor
            if rep.ok:
                self._sticky = mon
                return _json.loads(rep.blob.decode())
            raise AuthError(rep.err)   # auth refusal is terminal
        raise ConnectionError(f"no monitor answered auth: {last}")

    def hello(self, entity: str, cc: bytes) -> bytes:
        return bytes.fromhex(
            self._call("hello", {"entity": entity, "cc": cc.hex()})["sc"])

    def authenticate(self, entity: str, cc: bytes, proof: bytes) -> dict:
        return self._call("authenticate",
                          {"entity": entity, "cc": cc.hex(),
                           "proof": proof.hex()})

    def get_service_tickets(self, ticket: dict, nonce: bytes,
                            mac: bytes, services: list) -> dict:
        return self._call("tickets",
                          {"ticket": ticket, "nonce": nonce.hex(),
                           "mac": mac.hex(), "services": services})


def _valid_osd(osd: int, n_osds: int) -> bool:
    """False for CRUSH_ITEM_NONE holes / out-of-range ids: a degraded
    epoch's acting set can carry the 2^31-1 sentinel where no OSD
    could be chosen, and addressing "osd.<sentinel>" (or indexing
    osd_up with it) must never happen (shared by reconcile, suspect
    probing, and client primary lookup; peering.py applies the same
    predicate to its own sets)."""
    return 0 <= osd < n_osds


def _wire_authorize(cauth, rpc: _Rpc, peer: str, service: str,
                    async_refresh=None) -> None:
    """Present a `service` ticket to `peer` over MAuthOp("authorize"),
    running the daemon's anti-replay challenge round, then verify its
    mutual-auth proof; refresh the ticket once if its sealing secret
    rotated out. Shared by clients (osd + mon sessions) and by OSDs
    authorizing to peer OSDs. `async_refresh` marks a DISPATCH-PATH
    caller: a needed ticket refresh is delegated to it (background)
    and this attempt fails fast with ConnectionError instead of
    hunting monitors inline (see OSDDaemon._authorize_peer)."""
    import json as _json
    from ..auth import AuthError
    server_challenge = None
    refreshed = False
    for _ in range(4):
        # key snapshot: the reply must verify against the key that
        # built THIS authorizer — a concurrent ticket refresh (the
        # daemon prewarm thread, another dispatch thread) must not
        # turn a correct daemon reply into a fake mutual-auth failure
        az, key = cauth.authorizer_with_key(
            service, server_challenge=server_challenge)
        try:
            # short timeout: this can run from a daemon's dispatch
            # thread (peer store reads); a dead peer must not stall it
            rep = rpc.call(
                peer, lambda rid: MAuthOp(rid, True, "authorize",
                                          _json.dumps(az).encode()),
                timeout=2.0)
        except (ConnectionError, KeyError, OSError):
            return   # peer unreachable; the caller's op loop retargets
        if rep.ok:
            got = _json.loads(rep.blob.decode())
            if not cauth.verify_reply(
                    service, az, bytes.fromhex(got["reply_mac"]),
                    key=key):
                raise AuthError(
                    f"{peer} failed mutual auth (does not hold the "
                    "rotating secret)")
            return
        if rep.err.startswith("EAGAIN:challenge:"):
            server_challenge = rep.err.rsplit(":", 1)[1]
            continue
        if "rotated out" in rep.err and not refreshed:
            if async_refresh is not None:
                async_refresh()
                raise ConnectionError(
                    f"{service} ticket rotated out; refresh kicked, "
                    f"authorize to {peer} deferred")
            cauth.fetch_tickets([service])
            refreshed, server_challenge = True, None
            continue
        raise AuthError(rep.err)
    raise AuthError(f"authorize to {peer} did not converge")


class _WireOp:
    """One client op's retry state inside _run_ops.

    `names` (read kinds only) lets the op be re-issued as a
    `read_degraded` frame to a non-primary acting shard — the hedged /
    degraded dispatch paths; mutating ops never carry names and are
    never duplicated. `avoid` collects targets that transport-failed
    for THIS op; `try_degraded` marks that the primary path is parked
    (peering / not-primary / timed out) and the next round should go
    straight to a surviving shard."""

    __slots__ = ("kind", "ps", "body_fn", "blob", "last", "done",
                 "fatal", "names", "avoid", "try_degraded",
                 "full_wait", "full_pin_t")

    def __init__(self, kind: str, ps: int, body_fn, names=None):
        self.kind, self.ps, self.body_fn = kind, ps, body_fn
        self.blob: bytes = b""
        self.last = None
        self.done = False
        self.fatal: BaseException | None = None
        self.names: list[str] | None = names
        self.avoid: set[str] = set()
        self.try_degraded = False
        # r21: the map epoch an OSD failsafe-full bounce parked this
        # op at — the op sits out every round until a NEWER epoch
        # shows up (capacity-ladder commits bump it), then probes
        # once. full_pin_t (monotonic seconds at pin time) bounds the
        # park: a bounce whose cause clears before the ladder ever
        # commits it (sub-report-beat full window) produces NO newer
        # epoch, so a stale pin must eventually probe on its own
        self.full_wait: int | None = None
        self.full_pin_t: float | None = None


class _TracedCall:
    """A _PendingCall plus the client-side root span of its trace:
    whatever way the handle retires (wait / take / cancel / timeout),
    the span records EXACTLY ONCE — sampled frames record always,
    unsampled ones retroactively when they crossed the client's
    complaint threshold (the slow-op path `trace <id>` assembles)."""

    __slots__ = ("_cl", "_p", "ctx", "_name", "_tags", "_t0w",
                 "_t0m", "_done")

    def __init__(self, client: "Client", pend: _PendingCall,
                 ctx, name: str, tags: dict | None):
        self._cl, self._p, self.ctx = client, pend, ctx
        self._name, self._tags = name, tags
        self._t0w, self._t0m = time.time(), time.monotonic()
        self._done = False

    def _finish(self) -> None:
        ctx = self.ctx
        if self._done or ctx is None:
            return
        self._done = True
        dur = time.monotonic() - self._t0m
        retro = not ctx.sampled
        if retro and dur <= self._cl.op_tracker.complaint_time:
            return
        tags = dict(self._tags or {})
        if retro:
            tags["retro"] = True
        self._cl.flight.record(ctx.trace_id, ctx.parent_span_id, 0,
                               self._name, self._t0w, dur, tags)

    # the _PendingCall surface the dispatch/hedge loops drive --------------

    def wait(self, timeout: float = 10.0):
        try:
            return self._p.wait(timeout)
        finally:
            self._finish()

    def ready(self, timeout: float | None = 0.0) -> bool:
        return self._p.ready(timeout)

    def take(self):
        try:
            return self._p.take()
        finally:
            self._finish()

    def cancel(self) -> None:
        self._p.cancel()
        self._finish()

    def add_waiter(self, ev: threading.Event) -> None:
        self._p.add_waiter(ev)


class Client:
    """librados over the wire: locate the PG from the cached map, talk
    to its primary, retry on map change / primary death. Ops dispatch
    through a windowed in-flight pipeline (`window` ops / `window_bytes`
    payload budget) with per-primary frame coalescing — see
    _run_ops."""

    #: read kinds a client may duplicate (hedge) or re-route to a
    #: surviving shard as `read_degraded` — NEVER mutations (exactly-
    #: once would break) and not snap_read (snap state lives only at
    #: the activated primary)
    _HEDGE_KINDS = frozenset({"read", "readv"})

    def __init__(self, cluster: "StandaloneCluster", name: str = "client",
                 entity: str = "client.admin",
                 secret: bytes | None = None,
                 window: int | None = None,
                 window_bytes: int = 64 << 20,
                 hedge_delay_ms: float | None = None,
                 trace_sample_rate: float | None = None, device=None):
        from ..ec.interface import resolve_device
        from ..utils.flight_recorder import FlightRecorder
        from ..utils.op_tracker import OpTracker
        from ..utils.perf_counters import PerfCountersBuilder
        self.c = cluster
        self.device = resolve_device(device)
        self.msgr = Messenger(name, secret=cluster.secret,
                              compress=cluster.compress,
                              workers=cluster.msgr_workers,
                              uds=cluster.msgr_uds)
        self.rpc = _Rpc(self.msgr, MOSDOpReply.type_id,
                        window=cluster.op_window if window is None
                        else window,
                        window_bytes=window_bytes)
        self.osdmap: OSDMap | None = None
        self._lock = threading.Lock()
        # hedged-read knob: None resolves through the committed
        # central config (client_hedge_delay_ms) with the schema
        # default (0 = auto from latency history, < 0 = off)
        self.hedge_delay_ms = hedge_delay_ms
        # read-frame latency history: the OpTracker the auto hedge
        # delay derives from (submit->reply wall time per read frame)
        self.op_tracker = OpTracker(history_size=64,
                                    complaint_time=5.0)
        # r15 distributed tracing: the client is the trace ORIGIN — it
        # stamps a compact context on every op frame (live-resolved
        # sample rate decides eager recording; hedged/degraded
        # dispatches are always sampled) and keeps its own flight ring
        # of client.op/client.hedge root spans, flushed to the
        # monitors' assemblers after op rounds.
        self.trace_sample_rate = trace_sample_rate
        self.flight = FlightRecorder(name)
        self.last_trace_id: int = 0     # newest SAMPLED trace stamped
        self._trace_flushed = 0.0
        self._perf_shipped_count = 0    # op_lat samples last shipped
        self.perf = (PerfCountersBuilder("client")
                     .add_u64_counter("hedge_issued",
                                      "duplicate shard reads sent "
                                      "after the hedge delay")
                     .add_u64_counter("hedge_wins",
                                      "ops settled by the hedged "
                                      "duplicate first")
                     .add_u64_counter("hedge_losses",
                                      "hedges beaten by the primary "
                                      "reply (loser cancelled)")
                     .add_u64_counter("hedge_cancelled",
                                      "in-flight frames abandoned "
                                      "after the other side won or "
                                      "the round timed out")
                     .add_u64_counter("degraded_dispatch",
                                      "reads sent straight to a "
                                      "surviving shard (primary "
                                      "down/parked)")
                     .add_u64_counter("degraded_served",
                                      "ops settled by a degraded "
                                      "shard reply")
                     .add_u64_counter("link_cost_refreshes",
                                      "r22 link-cost feed pulls from "
                                      "the mon link matrix (TTL-"
                                      "gated, background)")
                     .add_u64_counter("link_cost_demotions",
                                      "fallback/hedge candidates "
                                      "ranked down because the link "
                                      "feed's cost exceeded the "
                                      "client's own EWMA view")
                     .add_time_avg("op_lat",
                                   "client-observed frame time "
                                   "(submit -> reply, wire and "
                                   "window wait included) — the r18 "
                                   "observed_client_latency feed",
                                   hist=True)
                     .add_time_avg("full_backoff_time",
                                   "wall time mutating ops sat parked "
                                   "behind a FULL cluster/pool flag "
                                   "or an OSD failsafe bounce (the "
                                   "RADOS full-wait contract: parked, "
                                   "never errored) — the SLO plane "
                                   "discloses these intervals instead "
                                   "of charging them to write latency",
                                   hist=True)
                     .create_perf_counters())
        # r21 FULL_TRY (ref: CEPH_OSD_FLAG_FULL_TRY): an admin client
        # sets this to push mutations through a map-level FULL flag
        # (deletes already pass — they free space); the OSD failsafe
        # still bounces when the local disk truly has no room
        self.full_try = False
        # per-target read-latency EWMA: orders the fallback/hedge
        # candidates ("next-best shard")
        self._lat_ewma: dict[str, float] = {}
        # complaint memory: targets that transport-failed or lost to a
        # hedge outright, pinned to the map epoch that named them —
        # later reads skip the hedge delay and go straight degraded
        # until a newer map (or a successful reply) clears the entry
        self._tgt_suspect: dict[str, int] = {}
        # r22 link-cost feed: worst measured cost per OSD (µs) pulled
        # from the mon link matrix — MEASURED wire health joining the
        # client's own op-latency inference in the fallback/hedge
        # ordering. TTL-gated and refreshed on a background thread
        # (single-flight): the read path only ever consults the cache.
        self._link_costs: dict[int, int] = {}
        self._link_costs_at = -1e9
        self._link_gate = threading.Lock()
        self.msgr.register_handler(MOSDMapMsg.type_id, self._on_map)
        self.msgr.register_handler(MOSDIncMapMsg.type_id,
                                   self._on_inc_map)
        # read-only monitor commands (status/health/prometheus) ride
        # their own correlation space
        self.mon_rpc = _Rpc(self.msgr, MMonCmdReply.type_id)
        self._cauth = None
        if cluster.key_server is not None:
            from ..auth import ClientAuth
            self.auth_rpc = _Rpc(self.msgr, MAuthReply.type_id)
            self._cauth = ClientAuth(
                _WireAuth(cluster, self.auth_rpc), entity,
                cluster.admin_secret if secret is None else secret)

    def _authorize(self, osd_name: str) -> None:
        _wire_authorize(self._cauth, self.auth_rpc, osd_name, "osd")

    def _ensure_mon_sessions(self) -> None:
        """Authorize with every live monitor before an admin broadcast
        (pool/config ops are dropped from unauthenticated peers).
        Re-run per call: monitor restarts silently void sessions, and
        admin ops are rare enough that one authorize round-trip per
        monitor is noise."""
        if self._cauth is None:
            return
        for mon in self.c.mon_names():
            _wire_authorize(self._cauth, self.auth_rpc, mon, "mon")

    def _on_map(self, peer: str, msg: MOSDMapMsg) -> None:
        with self._lock:
            if self.osdmap is None or msg.epoch > self.osdmap.epoch:
                self.osdmap = OSDMap.decode(msg.map_bytes,
                                            device=self.device)

    def _on_inc_map(self, peer: str, msg: MOSDIncMapMsg) -> None:
        """Clients ride the same delta subscription as OSDs: chain a
        consecutive incremental onto a clone, otherwise request the
        full map from the sending monitor."""
        with self._lock:
            cur = self.osdmap
            if cur is not None and msg.epoch <= cur.epoch:
                return
            if cur is not None and msg.epoch == cur.epoch + 1:
                inc = Incremental.decode(msg.map_bytes)
                if inc.base_epoch == cur.epoch:
                    self.osdmap = inc.apply(cur.shallow_clone())
                    return
            req_epoch = cur.epoch if cur is not None else 0
        try:
            self.msgr.send(peer, MOSDMapRequest(req_epoch))
        except (KeyError, OSError, ConnectionError):
            pass

    def _primary(self, ps: int) -> str:
        acting = self.osdmap.pg_to_up_acting_osds(1, ps)[2]
        if not acting or not _valid_osd(acting[0],
                                        len(self.osdmap.osd_up)):
            # empty, or an ITEM_NONE hole in a degraded epoch: no
            # serviceable primary — retry on the next map
            raise ConnectionError(f"pg 1.{ps} has no acting primary")
        return f"osd.{acting[0]}"

    def daemon(self, osd: int, cmd: str, timeout: float = 10.0):
        """`ceph daemon osd.N <cmd>` — daemon-addressed admin command
        (perf dump / dump_historic_ops / dump_ops_in_flight /
        slow_ops), served from the target's OpTracker/PerfCounters."""
        import json as _json
        e = Encoder()
        e.string(cmd)
        target = f"osd.{osd}"
        rep = self.rpc.call(
            target, lambda rid: MOSDOp(rid, True, "admin", e.bytes()),
            timeout=timeout)
        if not rep.ok and rep.err == "EPERM:unauthenticated" \
                and self._cauth is not None:
            self._authorize(target)
            rep = self.rpc.call(
                target,
                lambda rid: MOSDOp(rid, True, "admin", e.bytes()),
                timeout=timeout)
        if not rep.ok:
            if rep.err.startswith("EPERM:denied"):
                raise PermissionError(rep.err)   # the _op contract
            raise RuntimeError(f"admin {cmd!r} on osd.{osd}: "
                               f"{rep.err}")
        return _json.loads(rep.blob)

    def mon_command(self, kind: str, timeout: float = 10.0):
        """Read-only monitor command (`ceph status` / `health` /
        `health detail` / `prometheus` / `perf dump` / `report dump`):
        hunts the monitors in order, answers from the first one's
        MgrReport aggregate. With cephx on, establishes mon sessions
        first (the commands need mon r)."""
        import json as _json
        self._ensure_mon_sessions()
        last = None
        for mon in self.c.mon_names():
            try:
                rep = self.mon_rpc.call(
                    mon, lambda rid: MMonCmd(rid, True, kind),
                    timeout=timeout)
            except (ConnectionError, KeyError, OSError) as e:
                last = str(e)
                continue             # hunt the next monitor
            if rep.ok:
                return _json.loads(rep.blob)
            if rep.err.startswith("EPERM"):
                raise PermissionError(rep.err)
            raise RuntimeError(f"mon command {kind!r}: {rep.err}")
        raise ConnectionError(f"no monitor answered {kind!r}: {last}")

    def status(self) -> dict:
        return self.mon_command("status")

    def health(self, detail: bool = False) -> dict:
        return self.mon_command("health detail" if detail
                                else "health")

    def prometheus_text(self) -> str:
        return self.mon_command("prometheus")["text"]

    def _op(self, kind: str, ps: int, body_fn, timeout=None,
            retries=30, retry_sleep=0.3, names=None) -> bytes:
        op = _WireOp(kind, ps, body_fn, names=names)
        self._run_ops([op], timeout=timeout, retries=retries,
                      retry_sleep=retry_sleep)
        return op.blob

    def _encode_op_body(self, op: "_WireOp") -> list:
        e = Encoder()
        e.u32(op.ps)
        op.body_fn(e)
        return e.segments()

    def _settle(self, op: "_WireOp", ok: bool, blob: bytes, err: str,
                tgt: str, need_auth: set) -> None:
        """Fold one reply (or batch sub-reply) into the op's retry
        state — the same decision table the sequential _op loop ran."""
        if ok:
            op.blob, op.done = blob, True
            return
        op.last = err
        if err == "EPERM:unauthenticated":
            # first contact with this daemon (or it restarted):
            # establish the cephx session and retry the op
            need_auth.add(tgt)
            return
        if err.startswith("EPERM:denied"):
            # caps refusal is deterministic; retrying is useless
            op.fatal = PermissionError(err)
            return
        if err.startswith("ClsError:"):
            # a class method REFUSED the op (EBUSY-style):
            # deterministic, retrying can't change the answer
            from .objclass import ClsError
            op.fatal = ClsError(err[9:])
            return
        if err.startswith("KeyError"):
            # no-such-object is deterministic at the primary that
            # answered: retry sleeps cannot make a deleted object
            # reappear
            op.fatal = KeyError(err[9:] or err)
            return
        if "failsafe full" in err:
            # r21: the OSD's local hard-stop. Park until a NEWER map
            # could have changed the picture (capacity-ladder commits
            # bump the epoch) — the op never burns retry budget and
            # never surfaces while parked (the RADOS full-wait
            # contract); a fresh epoch probes exactly once.
            op.full_wait = self.osdmap.epoch \
                if self.osdmap is not None else 0
            op.full_pin_t = time.monotonic()
            return
        # anything else is transport-shaped: retarget and retry
        if op.kind in self._HEDGE_KINDS \
                and ("peering" in err or "not primary" in err):
            # the mapped primary exists but cannot serve yet
            # (WaitUpThru / restore pending): route the next round
            # straight to a surviving shard as a degraded read
            # instead of sleeping out the peering window
            op.try_degraded = True

    #: kinds the FULL flags park — writes that ADD bytes; "remove"
    #: deliberately passes (freeing space is how a full cluster
    #: recovers — the implicit FULL_TRY every delete carries)
    _FULL_WAIT_KINDS = frozenset({"write", "write_at", "append"})

    #: longest a failsafe-bounced op parks without a newer map before
    #: probing again anyway — liveness for full windows too short for
    #: the ladder to ever commit (each probe costs one retry round, so
    #: a persistently-failsafe cluster still errors out eventually
    #: instead of wedging the client forever)
    _FAILSAFE_REPROBE_S = 2.0

    def _full_parked(self, op: "_WireOp") -> bool:
        """r21: does this op sit out the current dispatch round?
        True while (a) an OSD failsafe bounce pinned it to an epoch
        the cached map hasn't passed yet, or (b) the map flies the
        cluster FULL flag or the pool's quota-full flag (full_try
        clients push through the map flags, never the failsafe)."""
        m = self.osdmap
        if m is None:
            return False
        if op.full_wait is not None:
            if m.epoch > op.full_wait:
                op.full_wait = None    # newer map: probe again
            elif op.full_pin_t is not None and \
                    time.monotonic() - op.full_pin_t \
                    >= self._FAILSAFE_REPROBE_S:
                # stale-map liveness valve: a failsafe bounce whose
                # cause cleared before any MgrReport reached the mon
                # never produces a newer epoch — probe anyway after a
                # bounded park; a store still at failsafe just
                # re-bounces and re-pins (slow periodic probe)
                op.full_wait = None
            else:
                return True
        if op.kind not in self._FULL_WAIT_KINDS or self.full_try:
            return False
        return m.cluster_full or 1 in m.full_pools

    def _full_backoff(self, base_sleep: float) -> None:
        """One parked-write beat: re-probe the map from a monitor
        (flag clears arrive as ordinary map fan-out; the request
        covers a client the broadcast missed), then a jittered sleep.
        The whole interval lands in full_backoff_time — the telemetry
        plane discloses it instead of charging it to write latency."""
        import random as _random
        t0 = time.monotonic()
        self._request_map()
        time.sleep(base_sleep * (0.5 + _random.random()))
        self.perf.tinc("full_backoff_time", time.monotonic() - t0)

    def _request_map(self) -> None:
        """Ask the first reachable monitor for a map newer than ours
        (it answers only when it has one)."""
        with self._lock:
            epoch = self.osdmap.epoch if self.osdmap is not None else 0
        for mon in self.c.mon_names():
            try:
                self.msgr.send(mon, MOSDMapRequest(epoch))
                break
            except (KeyError, OSError, ConnectionError):
                continue

    # -- degraded / hedged read dispatch --------------------------------------

    def _hedge_delay_s(self) -> float | None:
        """Resolve the live hedge delay: constructor override, else
        the committed central config, else the schema default. > 0 =
        fixed seconds; None = hedging off; 0/auto derives from this
        client's OpTracker read-latency history (a generous multiple
        of recent p95, floored so healthy clusters almost never hedge
        and capped below the op timeout so a hedge still has time to
        win)."""
        raw = self.hedge_delay_ms
        if raw is None and self.osdmap is not None:
            raw = self.osdmap.config_kv.get("client_hedge_delay_ms")
        if raw is None:
            raw = 0.0
        try:
            raw = float(raw)
        except ValueError:
            return None
        if raw < 0:
            return None
        if raw > 0:
            return raw / 1e3
        hist = sorted(self.op_tracker.recent_durations(32))
        lo, hi = 0.15, max(0.15, self.c.op_timeout / 2.0)
        if not hist:
            return hi
        p95 = hist[min(len(hist) - 1, int(0.95 * len(hist)))]
        return min(max(4.0 * p95, lo), hi)

    # -- distributed tracing (r15): context stamping --------------------------

    def _trace_rate(self) -> float:
        """Live sample rate: constructor override, else the committed
        central config (client_trace_sample_rate), else the schema
        default. < 0 disables context stamping entirely (frames revert
        to the bit-identical v1 encoding)."""
        raw = self.trace_sample_rate
        if raw is None and self.osdmap is not None:
            raw = self.osdmap.config_kv.get("client_trace_sample_rate")
        if raw is None:
            raw = 0.01
        try:
            return float(raw)
        except (TypeError, ValueError):
            return 0.01

    def _make_trace_ctx(self, force: bool = False):
        """The context one op frame carries, or None when stamping is
        off. `force` (hedged/degraded dispatches) samples
        unconditionally — those are exactly the multi-hop latency
        stories the tracing plane exists for. A SAMPLED first hop also
        ships this client's per-target latency EWMAs + live complaint
        set, which the serving daemon folds into its repair-planner
        cost table (the r14 follow-up)."""
        from ..utils.flight_recorder import (TraceContext, coin,
                                             new_trace_id)
        rate = self._trace_rate()
        if rate < 0:
            return None
        sampled = force or coin(rate)
        lat = None
        suspects: tuple[int, ...] = ()
        if sampled:
            lat = {int(t[4:]): v for t, v in self._lat_ewma.items()
                   if t.startswith("osd.")}
            suspects = tuple(sorted(
                int(t[4:]) for t in self._tgt_suspect
                if t.startswith("osd.")))
            ctx = TraceContext(new_trace_id(), new_trace_id(), True,
                               client_lat=lat or None,
                               client_suspects=suspects)
            self.last_trace_id = ctx.trace_id
            return ctx
        # unsampled: the id still travels, so every daemon can
        # retroactively assemble this op if it turns out slow
        return TraceContext(new_trace_id(), new_trace_id(), False)

    def _flush_trace_spans(self, force: bool = False) -> None:
        """Ship this client's freshly finished spans — plus its
        CUMULATIVE observed-latency counters (r18: the true
        client-side half of observed_client_latency) — to the
        monitors (clients have no MgrReport heartbeat — they flush
        after op rounds, throttled)."""
        import json as _json
        now = time.monotonic()
        if not force and now - self._trace_flushed < 1.0:
            return
        perf = self.perf.dump()
        new_samples = (perf.get("op_lat") or {}).get("avgcount", 0) \
            != self._perf_shipped_count
        if not self.flight.pending_ship() and not new_samples:
            return
        self._trace_flushed = now
        self._perf_shipped_count = \
            (perf.get("op_lat") or {}).get("avgcount", 0)
        spans = self.flight.drain(512)
        blob = _json.dumps({"name": self.msgr.name, "kind": "trace",
                            "spans": spans, "client_perf": perf},
                           separators=(",", ":")).encode()
        for mon in self.c.mon_names():
            try:
                self.msgr.send(mon, MMgrReport(0, True, "trace", blob))
            except (KeyError, OSError, ConnectionError):
                pass

    #: link-cost feed cache TTL (seconds): the matrix only changes on
    #: the report cadence, so pulling faster buys nothing
    _LINK_COST_TTL = 5.0

    def _maybe_refresh_link_costs(self) -> None:
        """Kick ONE background pull of the mon link matrix when the
        cache aged out (r22). Never blocks the caller: a read-path
        consumer racing a dead monitor must not inherit the mon-hunt
        timeout — it uses the stale cache and the refresh lands for
        the next op."""
        now = time.monotonic()
        if now - self._link_costs_at < self._LINK_COST_TTL:
            return
        if not self._link_gate.acquire(blocking=False):
            return                  # a pull is already in flight

        def _pull():
            try:
                d = self.mon_command("dump_osd_network", timeout=5.0)
                costs: dict[int, int] = {}
                for row in d.get("links") or []:
                    cost = int(float(row.get("ewma_ms", 0.0)) * 1e3)
                    for end in (row.get("from"), row.get("to")):
                        if isinstance(end, str) \
                                and end.startswith("osd."):
                            try:
                                o = int(end[4:])
                            except ValueError:
                                continue
                            costs[o] = max(costs.get(o, 0), cost)
                self._link_costs = costs
                self.perf.inc("link_cost_refreshes")
            except Exception:   # noqa: BLE001 — no mon, no feed: the
                pass            # client's own EWMAs still order reads
            finally:
                # stamp AFTER the attempt (success or not): a dead
                # quorum retries at TTL cadence, not per read
                self._link_costs_at = time.monotonic()
                self._link_gate.release()

        threading.Thread(target=_pull, daemon=True).start()

    def _read_fallback(self, ps: int, avoid: set[str]) -> str | None:
        """Next-best acting shard for a degraded/hedged read: an
        acting member that is up in OUR map and not in `avoid`,
        preferring the one with the best recent latency — the WORSE of
        the client's own per-target EWMA and the mon link matrix's
        measured cost (r22), so a shard behind a degraded wire ranks
        down even when this client hasn't personally paid it yet —
        then acting order."""
        self._maybe_refresh_link_costs()
        acting = self.osdmap.pg_to_up_acting_osds(1, ps)[2]
        n = len(self.osdmap.osd_up)
        cands = []
        for rank, o in enumerate(dict.fromkeys(acting)):
            if not _valid_osd(o, n) or not self.osdmap.osd_up[o]:
                continue
            name = f"osd.{o}"
            if name in avoid or self._target_suspected(name):
                continue
            # unmeasured targets rank after measured ones, in acting
            # order — "next-best" prefers a shard we know answers
            # fast. The link feed COUNTS as measurement: it is a real
            # RTT some daemon paid, not a guess.
            own = self._lat_ewma.get(name)
            feed = self._link_costs.get(o)
            if own is None and feed is None:
                key = float("inf")
            elif own is None:
                key = feed / 1e6
            else:
                key = own if feed is None else max(own, feed / 1e6)
                if feed is not None and feed / 1e6 > own:
                    self.perf.inc("link_cost_demotions")
            cands.append((key, rank, name))
        if not cands:
            return None
        return min(cands)[2]

    def _note_latency(self, tgt: str, dt: float) -> None:
        prev = self._lat_ewma.get(tgt)
        self._lat_ewma[tgt] = dt if prev is None \
            else 0.75 * prev + 0.25 * dt
        # r18: the same sample feeds the mergeable client-observed
        # histogram (ships with trace flushes -> the monitors'
        # observed_client_latency feed)
        self.perf.tinc("op_lat", dt)
        self._tgt_suspect.pop(tgt, None)   # it answered: complaint over

    def _suspect_target(self, tgt: str) -> None:
        if self.osdmap is not None:
            self._tgt_suspect[tgt] = self.osdmap.epoch

    def _target_suspected(self, tgt: str) -> bool:
        epoch = self._tgt_suspect.get(tgt)
        if epoch is None:
            return False
        if self.osdmap is None or self.osdmap.epoch != epoch:
            # a newer map re-earns trust (the primary may have moved
            # or revived); one slow round trip re-proves it either way
            self._tgt_suspect.pop(tgt, None)
            return False
        return True

    def _submit_degraded(self, op: "_WireOp", tgt: str,
                         hints: set[str],
                         span_name: str = "client.op") -> _TracedCall:
        """One read re-issued as a `read_degraded` frame: names plus
        the osd ids being routed around (the server skips them in its
        meta gather and decode instead of re-paying their timeouts).
        Degraded/hedged dispatches are ALWAYS-SAMPLED trace origins
        (the multi-hop tail stories the tracing plane exists for)."""
        e = Encoder()
        e.u32(op.ps)
        e.list(op.names, Encoder.string)
        e.list(sorted(int(t[4:]) for t in hints
                      if t.startswith("osd.")),
               lambda en, v: en.i32(v))
        body = e.bytes()
        ctx = self._make_trace_ctx(force=True)
        pend = self.rpc.submit(
            tgt, lambda rid: MOSDOp(rid, True, "read_degraded", body,
                                    trace=ctx),
            nbytes=len(body))
        tags = {"tgt": tgt, "ops": len(op.names), "degraded": True}
        return _TracedCall(self, pend, ctx, span_name, tags)

    def _settle_degraded(self, op: "_WireOp", ok: bool, blob: bytes,
                         err: str, tgt: str, need_auth: set) -> None:
        """Fold a read_degraded reply: the server answers in readv
        encoding (list of blobs), so a single-name `read` op unwraps
        its one blob; `readv` ops pass through unchanged."""
        self._settle(op, ok, blob, err, tgt, need_auth)
        if op.done:
            if op.kind == "read":
                op.blob = Decoder(op.blob).list(Decoder.blob)[0]
            self.perf.inc("degraded_served")

    def _fold_frame_reply(self, tgt: str, group: list["_WireOp"], rep,
                          need_auth: set, skip=()) -> None:
        """Fold one primary-frame reply into its ops' retry state
        (the decision table of the sequential loop), skipping ops a
        hedge already settled."""
        if rep.ok and len(group) > 1:
            d = Decoder(rep.blob)
            subs = d.list(lambda dd: (dd.boolean(), dd.blob(),
                                      dd.string()))
            for op, (ok, blob, err) in zip(group, subs):
                if op not in skip:
                    self._settle(op, ok, blob, err, tgt, need_auth)
        elif rep.ok:
            if group[0] not in skip:
                self._settle(group[0], True, rep.blob, "", tgt,
                             need_auth)
        else:
            for op in group:
                if op not in skip:
                    self._settle(op, False, b"", rep.err, tgt,
                                 need_auth)

    def _await_hedged(self, tgt: str, group: list["_WireOp"],
                      pend: _PendingCall, t0: float, deadline: float,
                      hedge_at: float, need_auth: set) -> None:
        """First-complete-wins wait for one read frame: if the primary
        reply is not in by `hedge_at`, duplicate every still-open op
        to its next-best shard as a degraded read; whichever answer
        lands first settles each op, losers are cancelled (window slot
        freed, late reply dropped), and every handle retires exactly
        once."""
        hedges: list[tuple["_WireOp", str, _PendingCall]] = []
        if not pend.ready(max(0.0, hedge_at - time.monotonic())):
            for op in group:
                alt = self._read_fallback(op.ps, op.avoid | {tgt})
                if alt is None:
                    continue
                self.perf.inc("hedge_issued")
                hedges.append((op, alt, self._submit_degraded(
                    op, alt, op.avoid | {tgt},
                    span_name="client.hedge")))
        ev = threading.Event()
        pend.add_waiter(ev)
        for _op, _alt, hp in hedges:
            hp.add_waiter(ev)
        primary_open = True
        won_by_hedge: set[int] = set()   # id(op) settled by a hedge
        while True:
            progressed = False
            if primary_open and pend.ready(0.0):
                primary_open = False
                progressed = True
                try:
                    rep = pend.take()
                except (ConnectionError, KeyError, OSError) as err:
                    self._suspect_target(tgt)
                    for op in group:
                        if id(op) in won_by_hedge or op.done:
                            continue
                        op.last = str(err)
                        op.avoid.add(tgt)
                        op.try_degraded = True
                else:
                    self._note_latency(tgt, time.monotonic() - t0)
                    self._fold_frame_reply(
                        tgt, group, rep, need_auth,
                        skip={op for op in group
                              if id(op) in won_by_hedge})
            still = []
            for op, alt, hp in hedges:
                if op.done or op.fatal is not None:
                    # the primary settled it first: cancel the loser
                    hp.cancel()
                    self.perf.inc("hedge_losses")
                    progressed = True
                    continue
                if hp.ready(0.0):
                    progressed = True
                    try:
                        hrep = hp.take()
                    except (ConnectionError, KeyError, OSError) as err:
                        op.last = str(err)
                        op.avoid.add(alt)
                    else:
                        self._settle_degraded(op, hrep.ok, hrep.blob,
                                              hrep.err, alt, need_auth)
                        if op.done:
                            won_by_hedge.add(id(op))
                            self.perf.inc("hedge_wins")
                    continue
                still.append((op, alt, hp))
            hedges = still
            open_ops = any(not op.done and op.fatal is None
                           for op in group)
            if primary_open and not open_ops:
                # every op settled by hedges before the primary said a
                # word: cancel it AND remember the complaint — later
                # reads go straight degraded instead of re-paying the
                # hedge delay every op while this map epoch lasts
                pend.cancel()
                self.perf.inc("hedge_cancelled")
                self._suspect_target(tgt)
                primary_open = False
                progressed = True
            if not primary_open and not hedges:
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                if primary_open:
                    pend.cancel()
                    self.perf.inc("hedge_cancelled")
                    self._suspect_target(tgt)
                    for op in group:
                        if op.done or op.fatal is not None \
                                or id(op) in won_by_hedge:
                            continue
                        op.last = f"rpc to {tgt} timed out"
                        op.avoid.add(tgt)
                        op.try_degraded = True
                for op, alt, hp in hedges:
                    hp.cancel()
                    self.perf.inc("hedge_cancelled")
                    if not op.done and op.fatal is None:
                        op.last = f"hedge to {alt} timed out"
                return
            if not progressed:
                ev.wait(min(remaining, 0.05))
                ev.clear()

    def _run_ops(self, ops: list["_WireOp"], timeout=None,
                 retries=30, retry_sleep=0.3) -> None:
        """Pipelined dispatch of many ops: every round, outstanding
        ops are grouped by their CURRENT primary, ops sharing a
        primary coalesce into one `batch` frame, and all frames go
        out through the windowed rpc before any reply is awaited — so
        a client batch really has window-many ops on the wire (the
        Objecter's in-flight pipeline, ref: src/osdc/Objecter.cc
        op_submit + the objecter_inflight_ops window). Retry/error
        semantics per op are identical to the old one-op loop.

        Reads additionally get graceful degradation (the degraded-read
        fast path, ROADMAP item 3):
        * DEGRADED DISPATCH — a read whose primary is down in the map,
          parked in peering, or has already transport-failed goes
          straight to the next-best acting shard as a `read_degraded`
          frame instead of sleeping out detection + peering;
        * HEDGING — a read frame with no reply after the hedge delay
          (live via client_hedge_delay_ms; auto mode derives it from
          this client's OpTracker history) is duplicated to the
          next-best shard; the first complete answer wins and the
          loser is cancelled (slot freed, late reply dropped).
        Both paths ride the same windowed rpc, so in-flight accounting
        stays exactly-once per handle; mutations never hedge.

        HOMELESS ops (ref: Objecter's homeless session): a round in
        which no outstanding op's PG has a primary in our map spends
        none of the retry budget while maps keep arriving — a live
        primary marked down under load re-boots within a few epochs,
        and 30 quick rounds would fail its reads before that commit
        lands. The round counts again once no newer epoch has come for
        `timeout` seconds, or the homeless stretch has lasted four
        times that."""
        if timeout is None:
            timeout = self.c.op_timeout + 8.0   # server-side retry room
        rounds = 0
        # (epoch, when it was first seen) and the homeless stretch's start
        map_seen = (self.osdmap.epoch if self.osdmap is not None else 0,
                    time.monotonic())
        homeless_since = None
        while rounds < retries:
            outstanding = [op for op in ops
                           if not op.done and op.fatal is None]
            if not outstanding:
                break
            # r21 full-wait (ref: Objecter::_maybe_request_map +
            # the pool/cluster FULL pause): a mutating op parks —
            # undisplayed, unerrored, retry budget untouched — while
            # the cached map flies a FULL flag over its pool/cluster,
            # or while an OSD failsafe bounce pins it to the bounced
            # epoch. A round where EVERY outstanding op is parked
            # sleeps a jittered beat + re-probes the map instead of
            # dispatching; the ops resume exactly-once when a newer
            # epoch clears the gate.
            parked = [op for op in outstanding
                      if self._full_parked(op)]
            if parked and len(parked) == len(outstanding):
                self._full_backoff(retry_sleep)
                continue
            if parked:
                outstanding = [op for op in outstanding
                               if not self._full_parked(op)]
            rounds += 1
            hedge_s = self._hedge_delay_s()
            by_tgt: dict[str, list[_WireOp]] = {}
            deg_ops: list[tuple[_WireOp, str]] = []
            homeless = True
            for op in outstanding:
                tgt = None
                try:
                    tgt = self._primary(op.ps)
                    homeless = False
                except ConnectionError as e:
                    op.last = str(e)   # no primary yet
                if op.kind in self._HEDGE_KINDS and op.names is not None \
                        and (tgt is None or op.try_degraded
                             or tgt in op.avoid
                             or self._target_suspected(tgt)):
                    alt = self._read_fallback(op.ps, op.avoid)
                    if alt is not None:
                        deg_ops.append((op, alt))
                        continue
                if tgt is None:
                    continue           # wait for a serviceable map
                by_tgt.setdefault(tgt, []).append(op)
            handles = []
            for tgt, group in by_tgt.items():
                # r15: every frame carries a trace context (the id
                # travels so slow ops assemble retroactively; the
                # sampled flag — probabilistic — gates eager span
                # recording at every hop). _TracedCall records the
                # client.op root span however the handle retires.
                ctx = self._make_trace_ctx()
                if len(group) == 1:
                    op = group[0]
                    body = self._encode_op_body(op)
                    nbytes = sum(len(s) for s in body)
                    pend = self.rpc.submit(
                        tgt, lambda rid, k=op.kind, b=body, tr=ctx:
                        MOSDOp(rid, True, k, b, trace=tr),
                        nbytes=nbytes)
                else:
                    # coalesce: one frame carries every outstanding op
                    # for this primary (small-op dispatch stops paying
                    # a round trip per PG)
                    e = Encoder()
                    e.u32(len(group))
                    for op in group:
                        e.string(op.kind)
                        e.blob_ref(self._encode_op_body(op))
                    body = e.segments()
                    nbytes = sum(len(s) for s in body)
                    pend = self.rpc.submit(
                        tgt, lambda rid, b=body, tr=ctx:
                        MOSDOp(rid, True, "batch", b, trace=tr),
                        nbytes=nbytes)
                pend = _TracedCall(self, pend, ctx, "client.op",
                                   {"tgt": tgt, "ops": len(group)})
                handles.append((tgt, group, pend, time.monotonic()))
            deg_handles = []
            for op, alt in deg_ops:
                self.perf.inc("degraded_dispatch")
                # the hint set carries every complained-about target
                # too, so the serving shard's meta gather skips the
                # dead primary instead of re-paying its timeout
                deg_handles.append((alt, op, self._submit_degraded(
                    op, alt, op.avoid | set(self._tgt_suspect))))
            need_auth: set[str] = set()
            for tgt, group, pend, t0 in handles:
                hedgeable = (
                    hedge_s is not None
                    and all(o.kind in self._HEDGE_KINDS
                            and o.names is not None for o in group))
                track = all(o.kind in self._HEDGE_KINDS
                            for o in group)
                frame_op = self.op_tracker.create_op(
                    f"client_read -> {tgt} x{len(group)}") \
                    if track else None
                if hedgeable:
                    self._await_hedged(tgt, group, pend, t0,
                                       t0 + timeout, t0 + hedge_s,
                                       need_auth)
                    if frame_op is not None:
                        frame_op.finish()
                    continue
                try:
                    rep = pend.wait(timeout)
                except (ConnectionError, KeyError, OSError) as err:
                    self._suspect_target(tgt)
                    for op in group:
                        op.last = str(err)
                        op.avoid.add(tgt)
                        if op.kind in self._HEDGE_KINDS:
                            op.try_degraded = True
                    continue
                finally:
                    if frame_op is not None:
                        frame_op.finish()
                self._note_latency(tgt, time.monotonic() - t0)
                self._fold_frame_reply(tgt, group, rep, need_auth)
            for alt, op, pend in deg_handles:
                try:
                    rep = pend.wait(timeout)
                except (ConnectionError, KeyError, OSError) as err:
                    op.last = str(err)
                    op.avoid.add(alt)
                    continue
                self._settle_degraded(op, rep.ok, rep.blob, rep.err,
                                      alt, need_auth)
            for tgt in need_auth:
                try:
                    self._authorize(tgt)
                except PermissionError:
                    raise          # caps refusal is deterministic
                except (ConnectionError, KeyError, OSError):
                    pass   # daemon unreachable: the round retries
            remaining = [op for op in ops
                         if not op.done and op.fatal is None]
            if not remaining:
                break
            now = time.monotonic()
            epoch = self.osdmap.epoch if self.osdmap is not None else 0
            if epoch != map_seen[0]:
                map_seen = (epoch, now)
            if not homeless:
                homeless_since = None
            elif homeless_since is None:
                homeless_since = now
            if homeless and now - map_seen[1] < timeout \
                    and now - homeless_since < 4 * timeout:
                rounds -= 1            # wait for a map with a primary
                self._request_map()
            if not need_auth:
                time.sleep(retry_sleep)   # map may be in flight
        self._flush_trace_spans()
        for op in ops:
            if op.fatal is not None and not isinstance(op.fatal,
                                                       KeyError):
                raise op.fatal
        for op in ops:
            if op.fatal is not None:
                raise op.fatal
        for op in ops:
            if not op.done:
                raise ConnectionError(
                    f"op {op.kind} pg 1.{op.ps} failed: {op.last}")

    def _snapc(self) -> int:
        """The client's snap context (ref: MOSDOp SnapContext): every
        mutating op carries the newest snap_seq this client has seen
        so a map-lagging primary refuses rather than skipping COW."""
        return self.osdmap.pools[1].snap_seq

    def write(self, objects: dict[str, bytes]) -> None:
        by_pg: dict[int, dict[str, bytes]] = {}
        for name, data in objects.items():
            ps = self.osdmap.object_to_pg(1, name)[1]
            by_pg.setdefault(ps, {})[name] = bytes(data)
        # one op per PG, ALL pipelined through the window (and ops
        # landing on the same primary coalesce into one frame); the
        # data blobs ride by reference from here to sendmsg
        self._run_ops([
            _WireOp("write", ps,
                    lambda e, g=group: e.u64(self._snapc()).mapping(
                        g, Encoder.string, Encoder.blob_ref))
            for ps, group in by_pg.items()])

    def write_at(self, name: str, offset: int, data: bytes) -> None:
        """Partial overwrite (the rados write-at-offset role): the
        primary serves it through the parity-delta RMW fast path when
        the stripe is clean — only the touched data shard(s) + m
        parity shards move on its fan-out — laddering to the
        full-stripe RMW otherwise."""
        ps = self.osdmap.object_to_pg(1, name)[1]
        self._op("write_at", ps,
                 lambda e: e.u64(self._snapc()).list(
                     [(name, int(offset), bytes(data))],
                     lambda en, t: en.string(t[0]).u64(t[1])
                     .blob_ref(t[2])))

    def append(self, name: str, data: bytes) -> None:
        """Append to a stream object: lands at the primary-known tail
        (the append-optimized layout — successive appends ride the
        RMW fast path with no pre-image read at all)."""
        ps = self.osdmap.object_to_pg(1, name)[1]
        self._op("append", ps,
                 lambda e: e.u64(self._snapc()).list(
                     [(name, 0, bytes(data))],
                     lambda en, t: en.string(t[0]).u64(t[1])
                     .blob_ref(t[2])))

    def read(self, name: str) -> bytes:
        ps = self.osdmap.object_to_pg(1, name)[1]
        return self._op("read", ps,
                        lambda e: e.string(name), names=[name])

    def read_many(self, names) -> dict[str, bytes]:
        """Batched reads: ONE multi-name op per PG (the daemon decodes
        the whole group in one batched launch), all PG ops pipelined
        through the window with per-primary coalescing (the librados
        aio_read batch role). Raises KeyError if any name is absent."""
        names = list(names)
        by_pg: dict[int, list[str]] = {}
        for name in names:
            ps = self.osdmap.object_to_pg(1, name)[1]
            by_pg.setdefault(ps, []).append(name)
        ops = {ps: _WireOp("readv", ps,
                           lambda e, g=group: e.list(g, Encoder.string),
                           names=group)
               for ps, group in by_pg.items()}
        self._run_ops(list(ops.values()))
        out: dict[str, bytes] = {}
        for ps, group in by_pg.items():
            blobs = Decoder(ops[ps].blob).list(Decoder.blob)
            out.update(zip(group, blobs))
        return {n: out[n] for n in names}

    def remove(self, names) -> None:
        """Delete objects (a LOGGED mutation: a shard down across
        the delete replays it on rejoin instead of resurrecting a
        stale copy — the pg_log_entry_t DELETE semantics the backend
        already enforces)."""
        names = [names] if isinstance(names, str) else list(names)
        by_pg: dict[int, list[str]] = {}
        for name in names:
            ps = self.osdmap.object_to_pg(1, name)[1]
            by_pg.setdefault(ps, []).append(name)
        self._run_ops([
            _WireOp("remove", ps,
                    lambda e, g=group: e.u64(self._snapc()).list(
                        g, Encoder.string))
            for ps, group in by_pg.items()])

    # -- pool snapshots over the wire ----------------------------------------

    def _mon_cast(self, msg: Message) -> None:
        """Broadcast to every monitor (queue-everywhere: whoever leads
        proposes; idempotent mutations commit exactly once)."""
        for mon in self.c.mon_names():
            try:
                self.msgr.send(mon, msg)
            except (KeyError, OSError, ConnectionError):
                pass

    def _pool_op(self, kind: str, snap: str) -> None:
        self._ensure_mon_sessions()
        self._mon_cast(MPoolOp(kind, snap))

    def snap_create(self, name: str, timeout: float = 15.0) -> int:
        """Named pool snapshot: monitor-quorum-committed (the snap
        rides pg_pool_t in the OSDMap), observed via this client's
        map subscription. Returns the snap id."""
        self._pool_op("mksnap", name)
        self.c._wait(
            lambda: self.osdmap is not None
            and name in self.osdmap.pools[1].snaps.values(),
            timeout, f"snap {name!r} committed")
        return next(s for s, n in self.osdmap.pools[1].snaps.items()
                    if n == name)

    def snap_remove(self, name: str, timeout: float = 15.0) -> None:
        self._pool_op("rmsnap", name)
        self.c._wait(
            lambda: self.osdmap is not None
            and name not in self.osdmap.pools[1].snaps.values(),
            timeout, f"snap {name!r} removed")

    def snap_read(self, name: str, sid: int) -> bytes:
        ps = self.osdmap.object_to_pg(1, name)[1]
        return self._op("snap_read", ps,
                        lambda e: e.string(name).u64(sid), retries=6)

    def snap_rollback(self, name: str, sid: int) -> None:
        ps = self.osdmap.object_to_pg(1, name)[1]
        self._op("rollback", ps,
                 lambda e: e.u64(self._snapc()).string(name).u64(sid),
                 retries=6)

    # -- osd administration over the wire ------------------------------------

    def osd_out(self, osd: int, timeout: float = 15.0) -> None:
        """`ceph osd out N`: weight to 0, committed through quorum;
        CRUSH steers the OSD's slots elsewhere and backfill follows."""
        self._ensure_mon_sessions()
        self._mon_cast(MOsdAdmin("out", osd))
        self.c._wait(
            lambda: self.osdmap is not None
            and self.osdmap.osd_weight[osd] == 0,
            timeout, f"osd.{osd} marked out")

    def osd_in(self, osd: int, weight: float = 1.0,
               timeout: float = 15.0) -> None:
        self._ensure_mon_sessions()
        self._mon_cast(MOsdAdmin("in", osd, weight))
        self.c._wait(
            lambda: self.osdmap is not None
            and self.osdmap.osd_weight[osd] > 0,
            timeout, f"osd.{osd} marked in")

    def osd_reweight(self, osd: int, weight: float,
                     timeout: float = 15.0) -> None:
        self._ensure_mon_sessions()
        self._mon_cast(MOsdAdmin("reweight", osd, weight))
        want = int(weight * 0x10000)
        self.c._wait(
            lambda: self.osdmap is not None
            and self.osdmap.osd_weight[osd] == want,
            timeout, f"osd.{osd} reweighted")

    def pool_set_quota(self, max_bytes: int = 0, max_objects: int = 0,
                       pool_id: int = 1,
                       timeout: float = 15.0) -> None:
        """`ceph osd pool set-quota` (r21) — quorum-committed onto the
        map; 0 clears that bound. POOL_FULL raises/clears on the
        leader's next capacity tick (it needs the MgrReport pool
        aggregates, so the flag follows the quota by up to a beat)."""
        self._ensure_mon_sessions()
        self._mon_cast(MPoolQuotaOp(pool_id, int(max_bytes),
                                    int(max_objects)))
        self.c._wait(
            lambda: self.osdmap is not None
            and pool_id in self.osdmap.pools
            and self.osdmap.pools[pool_id].quota_max_bytes
            == int(max_bytes)
            and self.osdmap.pools[pool_id].quota_max_objects
            == int(max_objects),
            timeout, f"pool {pool_id} quota committed")

    # -- centralized config over the wire ------------------------------------

    def config_set(self, key: str, value, timeout: float = 15.0) -> None:
        """`ceph config set` — quorum-committed, observed through the
        map subscription (ref: ConfigMonitor::prepare_command)."""
        value = str(value)
        self._ensure_mon_sessions()
        self._mon_cast(MConfigOp("set", key, value))
        self.c._wait(
            lambda: self.osdmap is not None
            and self.osdmap.config_kv.get(key) == value,
            timeout, f"config {key}={value!r} committed")

    def config_rm(self, key: str, timeout: float = 15.0) -> None:
        self._ensure_mon_sessions()
        self._mon_cast(MConfigOp("rm", key))
        self.c._wait(
            lambda: self.osdmap is not None
            and key not in self.osdmap.config_kv,
            timeout, f"config {key} removed")

    def config_get(self, key: str) -> str | None:
        """The committed central value (None = not centrally set)."""
        if self.osdmap is None:
            return None
        return self.osdmap.config_kv.get(key)

    # -- scrub / repair / object classes over the wire -----------------------

    def deep_scrub(self, ps: int) -> dict:
        import json as _json
        return _json.loads(self._op("deep_scrub", ps, lambda e: None))

    def repair_pg(self, ps: int) -> dict:
        import json as _json
        return _json.loads(self._op("repair", ps, lambda e: None))

    def cls_exec(self, name: str, cls: str, method: str,
                 inp: bytes = b"") -> bytes:
        ps = self.osdmap.object_to_pg(1, name)[1]
        return self._op("cls", ps,
                        lambda e: e.u64(self._snapc()).string(name)
                        .string(cls).string(method).blob(inp))

    def shutdown(self) -> None:
        self.msgr.shutdown()


class StandaloneCluster:
    """Orchestrates the endpoints; the qa/standalone helpers' role."""

    def __init__(self, n_osds: int = 6,
                 profile: str = "plugin=tpu_rs k=2 m=1 impl=bitlinear",
                 pg_num: int = 4, store: str = "mem",
                 store_dir: str | None = None,
                 secret: bytes | None = None,
                 compress: str | None = None, cephx: bool = False,
                 hb_interval: float = 0.25, hb_grace: float = 1.2,
                 min_reporters: int = 2, op_timeout: float = 8.0,
                 chunk_size: int = 256, verbose: bool | None = None,
                 op_window: int = 8, admin_dir: str | None = None,
                 op_shards: int = 1, msgr_workers: int = 1,
                 osd_procs: bool = False, msgr_uds: bool = True,
                 store_capacity: int = 0, device=None):
        import os as _os
        if verbose is None:
            verbose = bool(_os.environ.get("STANDALONE_VERBOSE"))
        from ..crush.map import Tunables, build_hierarchy, ec_rule, \
            replicated_rule
        from ..ec.interface import profile_from_string, resolve_device
        from ..ec.registry import factory
        # the device of every daemon's backends, maps and CRCs
        self.device = resolve_device(device)
        self.secret = secret
        self.compress = compress
        # cephx realm (ref: AuthMonitor bootstrap + client.admin
        # keyring): entity secrets + rotating service secrets live in
        # one KeyServer every monitor serves from
        self.key_server = None
        self.admin_secret = None
        if cephx:
            from ..auth import KeyServer
            ks = KeyServer()
            self.key_server = ks
            self.admin_secret = ks.create_entity(
                "client.admin",
                caps={"mon": "allow *", "osd": "allow rwx"})
            ks.current_secret("auth")
            ks.current_secret("osd")
            ks.current_secret("mon")
            # every OSD daemon is itself a cephx principal (ref: the
            # osd.N keyring bootstrap-osd creates): shard fan-out and
            # peer meta reads authorize with osd service tickets
            self.osd_secrets = {
                o: ks.create_entity(f"osd.{o}",
                                    caps={"mon": "allow rw",
                                          "osd": "allow rwx"})
                for o in range(n_osds)}
        self.hb_interval, self.hb_grace = hb_interval, hb_grace
        self.min_reporters = min_reporters
        self.op_timeout = op_timeout
        # concurrency shape (r13): op-queue shards per OSD daemon
        # (osd_op_num_shards) + epoll reactor threads per messenger
        self.op_shards = max(1, int(op_shards))
        self.msgr_workers = max(1, int(msgr_workers))
        # Unix-domain messenger sockets by default: same frames and
        # handshake, ~2.5x the loopback-TCP bulk throughput on this
        # kernel (the whole harness is single-host by construction)
        self.msgr_uds = bool(msgr_uds)
        # client-side in-flight op window (ops; see Client/_Rpc —
        # 0 disables pipelining, restoring one-op-per-round-trip)
        self.op_window = op_window
        self.chunk_size = chunk_size
        self.verbose = verbose
        self.profile = profile
        toks = profile.split()
        self.is_erasure = toks[0] != "replicated"
        crush = build_hierarchy(n_osds, osds_per_host=1,
                                hosts_per_rack=max(4, n_osds))
        crush.tunables = Tunables(choose_total_tries=51)
        if self.is_erasure:
            coder = factory(profile, device=self.device)
            self.pool_size = coder.get_chunk_count()
            self.pool_min_size = coder.get_data_chunk_count()
            ec_rule(crush, 1, choose_type=1)
        else:
            prof = profile_from_string(" ".join(toks[1:]))
            self.pool_size = int(prof.get("size", 3))
            self.pool_min_size = int(prof.get(
                "min_size", self.pool_size - self.pool_size // 2))
            replicated_rule(crush, 1, choose_type=1, firstn=True)
        osdmap = OSDMap(crush, device=self.device)
        osdmap.add_pool(PGPool(1, pg_num=pg_num, size=self.pool_size,
                               min_size=self.pool_min_size,
                               crush_rule=1,
                               is_erasure=self.is_erasure))
        self.pg_num = pg_num
        self.n_osds = n_osds
        self.store_kind = store
        # r21: per-OSD byte budget (0 = unbounded — statfs reports
        # total 0 and the mon ladder never computes a ratio); the
        # osd_store_capacity_bytes config role for the harness tier
        self.store_capacity = int(store_capacity)
        self.store_dir = store_dir
        if store == "tin" and store_dir is None:
            import tempfile
            self.store_dir = tempfile.mkdtemp(prefix="standalone-tin-")
        # the run dir for daemon admin sockets (the /var/run/ceph
        # role): every daemon binds <dir>/<name>.asok. Kept short —
        # AF_UNIX paths cap at ~107 bytes.
        if admin_dir is None:
            import tempfile
            admin_dir = tempfile.mkdtemp(prefix="ceph-asok-")
        self.admin_dir = admin_dir
        self.mons = [MonDaemon(r, self, device=self.device)
                     for r in range(3)]
        self.mons[0].osdmap = osdmap
        for m in self.mons[1:]:
            m.osdmap = OSDMap.decode(osdmap.encode(), device=self.device)
        # multi-process OSDs (r13): each daemon in its own OS process
        # — the only way N daemons use N cores under the GIL. Spawn
        # all children first (imports overlap), then collect ready.
        self.osd_procs = bool(osd_procs)
        if self.osd_procs:
            from .multiproc import OSDProcHandle
            self.osds = {o: OSDProcHandle(self, o)
                         for o in range(n_osds)}
            for h in self.osds.values():
                h.wait_ready()
        else:
            # each daemon's heartbeat thread reads osd_ids() from its
            # first beat on, while later daemons are still being built
            # (seconds for 12 daemons on a card): an empty roster until
            # all exist, or those threads die on the missing attribute
            # and their OSDs never report a failure
            self.osds = {}
            self.osds = {o: OSDDaemon(o, self, device=self.device)
                         for o in range(n_osds)}
        self.clients: list[Client] = []
        self._wire_peers()
        # initial map fan-out (the boot subscription)
        self.mons[0]._broadcast(osdmap.epoch)
        if self.osd_procs:
            # children's RAM is unreachable: poll their admin sockets
            # for a folded epoch instead of reading d.osdmap
            from ..utils.admin_socket import AdminSocketError

            def _fanned_out() -> bool:
                for h in self.osds.values():
                    try:
                        if h.asok("status",
                                  timeout=5.0)["osdmap_epoch"] < 1:
                            return False
                    except (OSError, AdminSocketError, ValueError):
                        return False
                return True
            self._wait(_fanned_out, 60, "initial map fan-out")
        else:
            self._wait(lambda: all(d.osdmap is not None
                                   for d in self.osds.values()), 10,
                       "initial map fan-out")

    # -- topology ------------------------------------------------------------

    def log(self, msg: str) -> None:
        # every cluster event also lands in the gathered log ring, so
        # `ceph daemon <name> log dump` reconstructs the timeline
        from ..utils.log import dout
        dout("osd", 4, f"standalone: {msg}")
        if self.verbose:
            print(f"standalone: {msg}", flush=True)

    def asok_path(self, name: str) -> str:
        import os as _os
        return _os.path.join(self.admin_dir, f"{name}.asok")

    def osd_ids(self) -> list[int]:
        return list(self.osds)

    def mon_names(self) -> list[str]:
        return [m.name for m in self.mons if not m._stop.is_set()]

    def map_subscribers(self) -> list[str]:
        subs = [d.name for d in self.osds.values()
                if not d._stop.is_set()]
        subs += [c.msgr.name for c in self.clients]
        return subs

    def make_store(self, osd_id: int):
        if self.store_kind == "tin":
            import os
            from .tinstore import TinStore
            # small cache on purpose: wire-tier datasets outgrow it,
            # proving the device-read path under real traffic
            return TinStore(os.path.join(self.store_dir,
                                         f"osd.{osd_id}"),
                            verify_reads=False,
                            cache_bytes=64 << 10,
                            capacity_bytes=self.store_capacity)
        return MemStore(capacity_bytes=self.store_capacity)

    def _wire_peers(self) -> None:
        every = ([(d.name, d.msgr) for d in self.osds.values()]
                 + [(m.name, m.msgr) for m in self.mons]
                 + [(c.msgr.name, c.msgr) for c in self.clients])
        for name_a, msgr_a in every:
            for name_b, msgr_b in every:
                if name_a != name_b:
                    msgr_a.add_peer(name_b, msgr_b.addr)

    def client(self, entity: str = "client.admin",
               secret: bytes | None = None,
               hedge_delay_ms: float | None = None,
               trace_sample_rate: float | None = None) -> Client:
        cl = Client(self, f"client.{len(self.clients)}",
                    entity=entity, secret=secret,
                    hedge_delay_ms=hedge_delay_ms,
                    trace_sample_rate=trace_sample_rate,
                    device=self.device)
        self.clients.append(cl)
        self._wire_peers()
        # subscribe: any mon will answer with the current map
        self.mons[0]._broadcast(self.mons[0].osdmap.epoch)
        self._wait(lambda: cl.osdmap is not None, 10, "client map")
        return cl

    # -- cephx administration -------------------------------------------------

    def create_entity(self, name: str,
                      caps: dict[str, str]) -> bytes:
        """`ceph auth get-or-create` role: mint an entity keyring."""
        return self.key_server.create_entity(name, caps)

    def rotate_service_secrets(self, service: str = "osd") -> None:
        """Rotate + push to live daemons (ref: the monitor's periodic
        rotating-secret refresh daemons pick up via MAuth). Old
        tickets stay valid through the keep-window; beyond it daemons
        answer 'rotated out' and clients re-fetch."""
        self.key_server.rotate(service)
        rot = self.key_server.export_rotating(service)
        daemons = list(self.osds.values()) if service == "osd" \
            else self.mons if service == "mon" else []
        for d in daemons:
            if d._stop.is_set():
                continue
            if getattr(d, "verifier", None) is not None:
                d.verifier.refresh(rot)
            elif hasattr(d, "push_rotating"):
                # multi-process OSD (r15 parity): the rotated secrets
                # cross the child's control pipe — stdin, never argv —
                # and refresh the child's in-RAM verifier, exactly the
                # push an in-process daemon gets
                d.push_rotating(service, rot)

    # -- fault injection ------------------------------------------------------

    def kill_osd(self, osd: int) -> None:
        self.log(f"SIGKILL osd.{osd}")
        self.osds[osd].kill()

    def revive_osd(self, osd: int) -> None:
        self.log(f"revive osd.{osd}")
        fresh = self.osds[osd].revive()
        self.osds[osd] = fresh
        self._wire_peers()   # registers fresh's new address everywhere
        if self.osd_procs:
            fresh.boot()     # the child announces itself to the mons
            return
        for mon_name in self.mon_names():
            try:
                fresh.msgr.send(mon_name, MOSDBoot(osd))
            except (KeyError, OSError, ConnectionError):
                pass

    def _endpoints(self) -> list:
        eps = [(m.name, m.msgr) for m in self.mons
               if not m._stop.is_set()]
        eps += [(d.name, d.msgr) for d in self.osds.values()
                if not d._stop.is_set()]
        eps += [(c.msgr.name, c.msgr) for c in self.clients]
        return eps

    def inject_socket_failures(self, every: int, osds=None,
                               seed: int | None = None) -> None:
        """Enable ms_inject_socket_failures on the given OSD daemons
        (default: all alive): every Nth send tears the live socket
        down first, so the whole data+control plane runs through
        reconnect+replay continuously. 0 disables. `seed` resets each
        daemon's injection RNG/counters deterministically (per-daemon
        derived seeds) so a logged thrash seed replays the same
        teardown schedule."""
        targets = osds if osds is not None else list(self.osds)
        for o in targets:
            d = self.osds[o]
            if not d._stop.is_set():
                if seed is not None:
                    d.msgr.seed_injection(seed * 131 + o)
                d.msgr.set_inject_socket_failures(every)

    def inject_delays(self, every: int, max_ms: float, osds=None,
                      seed: int | None = None) -> None:
        """Enable ms_inject_delay on the given OSD daemons (default:
        all alive): uniform [0, max_ms] sleep before every Nth
        transmit. `seed` makes the per-daemon delay draws
        deterministic (see inject_socket_failures)."""
        targets = osds if osds is not None else list(self.osds)
        for o in targets:
            d = self.osds[o]
            if not d._stop.is_set():
                if seed is not None:
                    d.msgr.seed_injection(seed * 131 + o)
                d.msgr.set_inject_delay(every, max_ms)

    def link_degrade(self, from_osd: int, to_osd: int,
                     delay_ms: float, jitter_ms: float = 0.0,
                     seed: int | None = None) -> None:
        """r22: degrade the DIRECTED link osd.from→osd.to — every
        non-reactor transmit from_osd makes toward to_osd sleeps
        delay_ms plus uniform [0, jitter_ms] first (heartbeat pings
        included; the pong crosses back undelayed). delay_ms <= 0
        heals this link. `seed` re-seeds the sender's injection RNG
        so the jitter schedule replays (same derivation as
        inject_socket_failures)."""
        d = self.osds[from_osd]
        if d._stop.is_set():
            return
        self.log(f"link_degrade: osd.{from_osd} -> osd.{to_osd} "
                 f"+{delay_ms}ms jitter {jitter_ms}ms")
        if seed is not None:
            d.msgr.seed_injection(seed * 131 + from_osd)
        d.msgr.set_link_delay(f"osd.{to_osd}", delay_ms, jitter_ms)

    def heal_link_degrades(self) -> None:
        """Clear every injected link degrade, every endpoint."""
        self.log("link_degrade: healed")
        for _, msgr in self._endpoints():
            msgr.clear_link_delays()

    def partition(self, *groups) -> None:
        """Install a network partition (the partition-injection
        role, SURVEY §4): endpoints named in different groups cannot
        exchange frames — enforced at BOTH ends of every cross-group
        pair. Endpoints in no group stay fully connected (so a
        mon-only split leaves OSD traffic alone, like a switch fault
        between the mon racks)."""
        sets = [set(g) for g in groups]
        named = set().union(*sets) if sets else set()
        self.log(f"partition: {[sorted(s) for s in sets]}")
        for name, msgr in self._endpoints():
            mine = next((s for s in sets if name in s), None)
            msgr.set_blocked(named - mine if mine is not None
                             else set())

    def heal_partition(self) -> None:
        """Remove every injected block; queued frames replay."""
        self.log("partition: healed")
        for _, msgr in self._endpoints():
            msgr.set_blocked(set())

    def kill_mon(self, rank: int) -> None:
        """SIGKILL a monitor; the quorum machinery and leadership
        election carry on without it (2 of 3 still commit)."""
        self.log(f"SIGKILL mon.{rank}")
        self.mons[rank].kill()

    # -- monitor membership (`ceph mon add/remove`) ---------------------------

    def add_mon(self, timeout: float = 20.0) -> int:
        """Grow the quorum: boot a new monitor, store-sync it, commit
        its membership through the OLD quorum (ref: `ceph mon add` +
        MonmapMonitor::prepare_join). Returns the new rank."""
        rank = len(self.mons)
        self.log(f"add mon.{rank}")
        fresh = MonDaemon(rank, self, device=self.device)
        self.mons.append(fresh)
        self._wire_peers()
        for mon in self.mons:
            if mon is not fresh and not mon._stop.is_set():
                try:
                    fresh.msgr.send(mon.name, MMonSyncReq(0))
                except (KeyError, OSError, ConnectionError):
                    pass
        self._wait(lambda: fresh.osdmap is not None, timeout,
                   f"mon.{rank} bootstrap sync")
        self._cast_mon_join(MMonJoin(rank, True))
        self._wait(
            lambda: any(not m._stop.is_set() and m.osdmap is not None
                        and rank in m.osdmap.mon_members
                        for m in self.mons), timeout,
            f"mon.{rank} membership committed")
        return rank

    def _cast_mon_join(self, msg: MMonJoin) -> None:
        """Deliver a membership change to EVERY live monitor. A
        messenger has no loopback (a daemon is never its own peer),
        so a single-source broadcast can't reach the sender itself —
        fatal when the current LEADER is the one being removed (only
        the leader proposes). All live pairs cross-send instead, so
        each monitor, leader included, hears it from someone."""
        live = [m for m in self.mons if not m._stop.is_set()]
        for src in live:
            for dst in live:
                if src is dst:
                    continue
                try:
                    src.msgr.send(dst.name, msg)
                except (KeyError, OSError, ConnectionError):
                    pass

    def remove_mon(self, rank: int, timeout: float = 20.0) -> None:
        """Shrink the quorum: commit the member's departure through
        the current quorum, then stop its process (ref: `ceph mon
        remove`). A removed-but-running monitor can no longer lead or
        vote — membership rides the committed map."""
        self.log(f"remove mon.{rank}")
        target = self.mons[rank]
        self._cast_mon_join(MMonJoin(rank, False))
        self._wait(
            lambda: any(not m._stop.is_set() and m.osdmap is not None
                        and rank not in m.osdmap.mon_members
                        for m in self.mons), timeout,
            f"mon.{rank} removal committed")
        target.kill()

    def revive_mon(self, rank: int) -> None:
        """Restart a monitor: fresh endpoint, DURABLE Paxos state.
        The reference mon's acceptor state (promised pn, accepted-but-
        uncommitted value) and committed map live in its on-disk store
        and survive a restart — modeled here by carrying them from the
        killed daemon. Forgetting an acceptance would let two bodies
        commit for one epoch: the accept quorum that committed X must
        still REMEMBER X when a later collect quorum intersects it.
        A store sync from surviving peers then catches the committed
        map up BEFORE it may lead."""
        self.log(f"revive mon.{rank}")
        old = self.mons[rank]
        peers_epoch = max(
            (m.osdmap.epoch for m in self.mons
             if m is not old and not m._stop.is_set()
             and m.osdmap is not None), default=0)
        fresh = MonDaemon(rank, self, osdmap=old.osdmap,
                          device=self.device)
        fresh._promised = old._promised
        fresh._accepted = old._accepted
        fresh._pn_seen = old._pn_seen
        self.mons[rank] = fresh
        self._wire_peers()
        for mon in self.mons:
            if mon is not fresh and not mon._stop.is_set():
                try:
                    fresh.msgr.send(mon.name, MMonSyncReq(0))
                except (KeyError, OSError, ConnectionError):
                    pass
        # wait for the sync to land (peers answer with their committed
        # map); if no peer is alive there is no quorum anyway and the
        # revived mon stays where its own store left it
        if any(not m._stop.is_set() for m in self.mons
               if m is not fresh):
            self._wait(lambda: fresh.osdmap is not None
                       and fresh.osdmap.epoch >= peers_epoch, 10,
                       f"mon.{rank} store sync")
        del old

    # -- barriers -------------------------------------------------------------

    def _wait(self, pred, timeout: float, what: str) -> None:
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            if pred():
                return
            time.sleep(0.05)
        import os as _os
        if _os.environ.get("STANDALONE_DEBUG"):
            import faulthandler
            import sys as _sys
            print(f"=== STANDALONE_DEBUG: '{what}' timed out; "
                  f"all thread stacks:", file=_sys.stderr, flush=True)
            faulthandler.dump_traceback(file=_sys.stderr)
        raise TimeoutError(f"standalone: {what} not reached "
                           f"in {timeout}s")

    def wait_for_down(self, osd: int, timeout: float = 30.0) -> None:
        """Emergent failure detection: pings miss -> reports -> quorum
        commit -> everyone's map shows the OSD down. The default
        budget allows for a loaded host (thread starvation stretches
        every stage; the suite flaked at 15s under full-suite load
        while passing x3 idle)."""
        if self.osd_procs:
            from ..utils.admin_socket import AdminSocketError

            def _down_everywhere() -> bool:
                # the committed map must mark it down AND every live
                # child must have folded an epoch at least that new
                epochs = [m.osdmap.epoch for m in self.mons
                          if not m._stop.is_set()
                          and m.osdmap is not None
                          and not m.osdmap.osd_up[osd]]
                if not epochs:
                    return False
                want = min(epochs)
                for h in self.osds.values():
                    if h._stop.is_set():
                        continue
                    try:
                        if h.asok("status",
                                  timeout=5.0)["osdmap_epoch"] < want:
                            return False
                    except (OSError, AdminSocketError, ValueError):
                        return False
                return True
            self._wait(_down_everywhere, timeout,
                       f"osd.{osd} marked down everywhere")
            return
        self._wait(
            lambda: all(d.osdmap is not None
                        and not d.osdmap.osd_up[osd]
                        for d in self.osds.values()
                        if not d._stop.is_set()),
            timeout, f"osd.{osd} marked down everywhere")

    def wait_for_clean(self, timeout: float = 30.0) -> None:
        """Every PG's primary hosts a backend whose acting set matches
        the map and whose shards are all caught up. In multi-process
        mode the parent cannot reach into a child's RAM: it reads the
        committed map from its in-process monitors and polls each
        primary child's `pg clean` over the admin socket."""
        if self.osd_procs:
            self._wait(self._proc_clean, timeout, "all PGs clean")
            return

        def clean() -> bool:
            for ps in range(self.pg_num):
                owner = None
                for d in self.osds.values():
                    if d._stop.is_set() or d.osdmap is None:
                        continue
                    acting = d.osdmap.pg_to_up_acting_osds(1, ps)[2]
                    if acting and acting[0] == d.osd_id:
                        owner = d
                        break
                if owner is None:
                    return False
                be = owner.backends.get(ps)
                if be is None or be.acting != acting:
                    return False
                if ps in owner._recovering:
                    return False   # async rebuild still in flight
                if owner._lagging_slots(be):
                    return False   # a catch-up is due
            return True
        self._wait(clean, timeout, "all PGs clean")

    def _proc_clean(self) -> bool:
        from ..utils.admin_socket import AdminSocketError
        osdmap = next((m.osdmap for m in self.mons
                       if not m._stop.is_set()
                       and m.osdmap is not None), None)
        if osdmap is None:
            return False
        claims: dict[str, bool] = {}
        for h in self.osds.values():
            if h._stop.is_set():
                continue
            try:
                claims.update(h.asok("pg clean", timeout=5.0))
            except (OSError, AdminSocketError, ValueError):
                return False
        for ps in range(self.pg_num):
            acting = osdmap.pg_to_up_acting_osds(1, ps)[2]
            if not acting or not _valid_osd(acting[0],
                                            len(osdmap.osd_up)):
                return False
            if not claims.get(f"1.{ps}", False):
                return False
        return True

    def shutdown(self) -> None:
        for cl in self.clients:
            cl.shutdown()
        for d in self.osds.values():
            if not d._stop.is_set():
                d.kill()
        for m in self.mons:
            m.kill()
        import shutil
        shutil.rmtree(self.admin_dir, ignore_errors=True)
