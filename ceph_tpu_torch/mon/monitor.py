"""MonitorCluster — quorum, leader election, replicated KV.

Rebuild of the reference's control plane shape (ref: src/mon/
Monitor.cc — rank-based election (Elector.cc: lowest reachable rank
wins), quorum = majority of the monmap; src/mon/Paxos.cc — proposals
commit only with quorum acks, each commit bumps a monotone version,
peons replicate the leader's transaction; src/mon/ConfigMonitor.cc —
the `ceph config set` KV; src/mon/OSDMonitor.cc — failure reports
become OSDMap updates only THROUGH a quorum commit).

Deliberately Paxos-lite: the sim is synchronous and partition-free
(a monitor is up or down, messages never reorder), so the full
prepare/promise/accept machinery collapses to: leader = lowest alive
rank; propose() commits iff a majority is alive; down monitors sync
the committed store on revive (the probing/synchronizing bootstrap
phases). What is kept faithfully is the OBSERVABLE contract the rest
of the system depends on:

* no quorum -> NO state changes anywhere (OSDMap epochs freeze, config
  stays, failure detection stalls) — the reference cluster's behavior
  when monitors lose majority;
* every commit carries a monotone version; a revived monitor replays
  to the committed version before voting again;
* reads are served only under quorum (the reference parks client
  sessions without it).

SimCluster routes every map mutation through propose(), so killing
monitors actually freezes the failure-handling pipeline — testable
elasticity the r01 sim lacked (its monitor logic was an infallible
singleton).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class NoQuorum(Exception):
    pass


@dataclass
class _Mon:
    rank: int
    alive: bool = True
    version: int = 0
    store: dict[str, object] = field(default_factory=dict)


class MonitorCluster:
    def __init__(self, n_mons: int = 3):
        if n_mons < 1:
            raise ValueError("need at least one monitor")
        self.mons = [_Mon(r) for r in range(n_mons)]
        self.commits = 0
        self.elections = 0
        self._last_leader: int | None = 0

    # -- membership ---------------------------------------------------------

    def kill(self, rank: int) -> None:
        self.mons[rank].alive = False

    def revive(self, rank: int) -> None:
        """Rejoin: sync the committed store before voting (the
        synchronizing phase). Syncing runs over the WHOLE quorum, not
        just the reviver: a quorum re-formed from monitors that came
        back during quorum loss may contain stale members, and a stale
        leader would fork history (reuse versions, lose commits)."""
        self.mons[rank].alive = True
        self._sync_quorum()

    def _sync_quorum(self) -> None:
        """Bring every quorum member to the committed (max) version —
        the probing/synchronizing phase every election runs before the
        quorum serves."""
        q = self.quorum()
        if q is None:
            return
        src = max((self.mons[r] for r in q), key=lambda m: m.version)
        for r in q:
            m = self.mons[r]
            if m.version < src.version:
                m.store = dict(src.store)
                m.version = src.version

    # -- election / quorum ---------------------------------------------------

    def quorum(self) -> list[int] | None:
        alive = [m.rank for m in self.mons if m.alive]
        if len(alive) * 2 > len(self.mons):
            return alive
        return None

    def leader(self) -> int | None:
        """Lowest rank in the quorum (Elector's winner)."""
        q = self.quorum()
        if q is None:
            return None
        lead = min(q)
        if lead != self._last_leader:
            self.elections += 1
            self._last_leader = lead
        return lead

    def _quorum_source(self) -> _Mon | None:
        q = self.quorum()
        if q is None:
            return None
        # any quorum member is at the committed version
        return max((self.mons[r] for r in q), key=lambda m: m.version)

    # -- paxos-lite commit ---------------------------------------------------

    def propose(self, key: str, value) -> int:
        """Commit key=value through the quorum; returns the new
        version. Raises NoQuorum when a majority is not alive — the
        caller's state change must NOT happen."""
        q = self.quorum()
        if q is None:
            raise NoQuorum(
                f"{sum(m.alive for m in self.mons)}/{len(self.mons)} "
                f"monitors alive; no majority")
        self._sync_quorum()  # a stale leader must never fork history
        leader = self.leader()
        v = self.mons[leader].version + 1
        for r in q:  # leader commits, peons replicate
            self.mons[r].store[key] = value
            self.mons[r].version = v
        self.commits += 1
        return v

    def get(self, key: str, default=None):
        """Read from the quorum (parked without one, like client
        sessions to a quorumless cluster)."""
        src = self._quorum_source()
        if src is None:
            raise NoQuorum("no majority; reads parked")
        return src.store.get(key, default)

    def version(self) -> int:
        src = self._quorum_source()
        if src is None:
            raise NoQuorum("no majority")
        return src.version

    # -- osd monitor role ----------------------------------------------------

    def record_up_thru(self, osd: int, epoch: int) -> int:
        """Commit an OSD's up_thru claim (the MOSDAlive handling, ref:
        OSDMonitor::prepare_alive -> osd_info_t::up_thru): the proof
        that an interval's primary was up at its start epoch rides the
        replicated store like any other map mutation — no quorum, no
        recorded up_thru, no PG activation. Monotone: a stale claim
        commits a no-op version bump but never regresses the value."""
        cur = int(self.get(f"osd/{osd}/up_thru", 0) or 0)
        return self.propose(f"osd/{osd}/up_thru", max(cur, int(epoch)))

    def up_thru(self, osd: int) -> int:
        """The committed up_thru for `osd` (0 = never recorded)."""
        return int(self.get(f"osd/{osd}/up_thru", 0) or 0)

    # -- config monitor role -------------------------------------------------

    def config_set(self, name: str, value) -> int:
        return self.propose(f"config/{name}", value)

    def config_dump(self) -> dict[str, object]:
        src = self._quorum_source()
        if src is None:
            raise NoQuorum("no majority")
        return {k[len("config/"):]: v for k, v in src.store.items()
                if k.startswith("config/")}
