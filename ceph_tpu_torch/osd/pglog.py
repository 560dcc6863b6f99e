"""PGLog — per-PG mutation log enabling delta rejoin.

Rebuild of the reference's log-based catch-up (ref: src/osd/PGLog.{h,cc}
pg_log_t entries with eversion_t versions; PeeringState GetLog/
GetMissing computes a missing set from the authoritative log, and a
rejoining OSD either LOG-REPLAYS the delta or, when the log has been
trimmed past its last-applied version, falls back to BACKFILL).

Simplified to what the sim's write model needs: every object mutation
appends (version, name); a shard that was down across some window asks
`missing_since(last_applied)` and gets the deduplicated set of objects
it must re-apply — or None when the log no longer reaches back that far
(the backfill signal). Versions are a single monotone counter per PG
(the reference's eversion epoch component is carried by the OSDMap
epoch at the cluster layer)."""

from __future__ import annotations

from collections import deque


def share_history(local: "PGLog", auth: "PGLog") -> bool:
    """True when the two logs demonstrably belong to one history: some
    retained entry agrees, or local's retained window entirely
    predates auth's trimmed tail (unverifiable => assume shared). A
    local log with entries and NO agreement at all signals interval
    DISCONTINUITY (e.g. the PG restarted virgin on fresh OSDs after a
    full-acting-set outage) — a rewind there would delete the only
    surviving copies, not roll back an uncommitted tail."""
    if not len(local._entries):
        return True
    auth_at = dict(auth._entries)
    for v, name in local._entries:
        if v <= auth.tail or auth_at.get(v) == name:
            return True
    return False


def divergent_names(local: "PGLog", auth: "PGLog") -> list[str]:
    """Names whose entries in `local` the authoritative log does not
    contain (ref: PGLog::merge_log divergent-entry handling): an entry
    past auth.head, or one whose version names a DIFFERENT object in
    the authoritative history, records a write that never committed
    cluster-wide. The rejoining holder must roll those objects back to
    (or re-copy) the authoritative state — serving them would
    resurrect unacknowledged writes. Versions at or before auth.tail
    are unverifiable (trimmed) and assumed converged — the backfill
    path owns that window."""
    auth_at = dict(auth._entries)
    out: dict[str, None] = {}
    for v, name in local._entries:
        if v > auth.head or (v > auth.tail and auth_at.get(v) != name):
            out.setdefault(name)
    return list(out)


class PGLog:
    """Append-only bounded mutation log for one PG."""

    def __init__(self, max_entries: int = 10000):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self.head = 0          # newest version (0 = empty history)
        self.tail = 0          # entries cover versions (tail, head]
        self._entries: deque[tuple[int, str]] = deque()

    def append(self, name: str) -> int:
        """Record a mutation of `name`; returns its version."""
        self.head += 1
        self._entries.append((self.head, name))
        while len(self._entries) > self.max_entries:
            v, _ = self._entries.popleft()
            self.tail = v
        return self.head

    def append_entry(self, version: int, name: str) -> None:
        """Replay a known (version, name) entry — the delta-meta
        restore path reapplying entries persisted after the last full
        snapshot. Versions must arrive strictly ascending past head."""
        if version <= self.head:
            raise ValueError(f"append_entry {version} <= head "
                             f"{self.head}")
        self.head = version
        self._entries.append((version, name))
        while len(self._entries) > self.max_entries:
            v, _ = self._entries.popleft()
            self.tail = v

    def missing_since(self, version: int) -> list[str] | None:
        """Objects mutated after `version` (dedup, oldest-first), or
        None when `version` predates the retained log — the caller must
        backfill (full copy) instead of replaying."""
        if version >= self.head:
            return []
        if version < self.tail:
            return None
        seen: dict[str, None] = {}
        for v, name in self._entries:
            if v > version:
                seen.setdefault(name)
        return list(seen)

    def __len__(self) -> int:
        return len(self._entries)

    # -- wire form (ref: pg_log_t encode/decode) ----------------------------

    def encode(self) -> bytes:
        from ..utils.encoding import Encoder
        e = Encoder().start(1, 1)
        e.u32(self.max_entries).u64(self.head).u64(self.tail)
        e.list(list(self._entries),
               lambda en, ent: en.u64(ent[0]).string(ent[1]))
        return e.finish().bytes()

    @classmethod
    def decode(cls, data: bytes) -> "PGLog":
        from ..utils.encoding import Decoder
        d = Decoder(data)
        d.start(1)
        log = cls(max_entries=d.u32())
        log.head = d.u64()
        log.tail = d.u64()
        for v, name in d.list(lambda dd: (dd.u64(), dd.string())):
            log._entries.append((v, name))
        d.finish()
        return log
