"""PeeringState — the GetInfo/GetLog/GetMissing consensus pass.

Rebuild of the reference's peering machine (ref: src/osd/
PeeringState.{h,cc} — a boost::statechart whose load-bearing phases
are: GetInfo (query every up shard for its pg_info_t: last_update,
log bounds), GetLog (pick the authoritative log holder via
find_best_info and pull its log), GetMissing (diff every shard's
last_update against the authoritative log into per-shard missing
sets), then choose_acting/Activate — after which missing objects are
recovered log-first, and shards whose gap predates the log tail are
backfilled instead).

Mapped onto this repo's primitives: each PGBackend already carries the
authoritative in-memory log (`pg_log`) and a per-shard applied cursor
(`shard_applied` — the last_update analog), so peering here is a PURE
FUNCTION over (backend, liveness): it produces the per-shard missing
plan and the PG's resulting state. SimCluster drives it on every map
change / revive and executes the plan through recover_shards; the
state lands in `health()` exactly like `ceph pg stat` strings.

States (the reference's pg_state_t names):
  active+clean        every slot alive and caught up
  active+degraded     >= min_size fresh shards, but some slot down or
                      behind (recovery pending/possible)
  active+backfilling  a slot is receiving a full copy (pg_temp serves)
  peering             healthy enough to activate, but the primary's
                      up_thru is not yet recorded for this interval —
                      the WaitUpThru phase: I/O stays parked until the
                      monitors commit it (ref: PeeringState WaitUpThru
                      + adjust_need_up_thru)
  down                not enough live shards to serve I/O at all
  incomplete          live shards exist, but fewer than min_size of
                      them reach the newest write — recent data is
                      unserviceable until a fresher shard returns

up_thru (ref: osd_info_t::up_thru): the map-recorded proof horizon of
an OSD's activity. Peering consults it in two directions:

* FORWARD (WaitUpThru): before this interval's primary serves I/O,
  its up_thru must reach the interval's start epoch — else a write
  could land in an interval the rest of the cluster can later prove
  nothing about. `peer(..., interval_start=, up_thru=)` classifies
  that window as "peering" with `needs_up_thru=True`; the caller asks
  the monitors to record it and re-peers on the committed map.
* BACKWARD (maybe_went_rw): a PAST interval whose primary never got
  up_thru recorded at its start epoch provably never went active, so
  no write can exist from it — peering neither waits on nor trusts
  its members (`interval_maybe_went_rw`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

BACKFILL = "backfill"  # plan marker: log trimmed past cursor


def interval_maybe_went_rw(interval_start: int,
                           primary_up_thru: int) -> bool:
    """Could an interval that began at map epoch `interval_start`
    have served writes? Only if its primary's up_thru was recorded
    at/past that epoch — otherwise the primary died (or never asked
    the monitors) before the PG could go active, so the interval
    provably carries no writes and need not be waited on or trusted
    (ref: PastIntervals::check_new_interval's maybe_went_rw)."""
    return int(primary_up_thru) >= int(interval_start)


@dataclass
class ShardInfo:
    """One GetInfo reply (pg_info_t slice)."""
    slot: int
    osd: int
    alive: bool
    applied: int          # last_update analog


@dataclass
class PeeringResult:
    state: str                      # pg_state string
    auth_version: int               # newest version any live shard has
    head: int                       # the log's newest version
    infos: list[ShardInfo]
    # live-but-behind slots -> list of object names to replay, or
    # BACKFILL when the log has been trimmed past their cursor
    missing: dict[int, list[str] | str] = field(default_factory=dict)
    # the WaitUpThru signal: the PG would be active, but the primary's
    # up_thru has not reached this interval's start epoch yet — the
    # caller must get it recorded by the monitors first
    needs_up_thru: bool = False

    @property
    def serviceable(self) -> bool:
        return self.state not in ("down", "incomplete") \
            and not self.state.startswith("peering")


def peer(backend, alive_osds, backfilling: bool = False,
         compute_missing: bool = True, interval_start: int = 0,
         up_thru: int | None = None) -> PeeringResult:
    """Run the GetInfo -> GetLog -> GetMissing phases for one PG.

    backend: a PGBackend (holds acting, pg_log, shard_applied).
    alive_osds: container with `alive_osds[osd]` truthy when the OSD
    process answers (the heartbeat view).
    backfilling: the cluster's flag that this PG has an in-flight
    pg_temp-protected copy.
    compute_missing: False skips the GetMissing log walk (classify-only
    mode for per-op serviceability gates and health polls — the state
    depends only on cursor counts, and walking a 10k-entry log per
    client op would be pure waste).
    interval_start/up_thru: the current interval's start epoch and the
    primary's map-recorded up_thru; when up_thru lags the interval
    start, a PG that would otherwise go active is held in "peering"
    (the WaitUpThru phase) with needs_up_thru=True. up_thru=None keeps
    the pre-up_thru behavior (callers that don't track intervals).
    """
    head = backend.pg_log.head

    # -- GetInfo: per-slot infos; dead shards don't reply; an unfilled
    # CRUSH slot (hole sentinel CRUSH_ITEM_NONE = 0x7FFFFFFF, or any
    # id outside the OSD table) has nobody to ask -> undersized PG
    from ..crush.map import CRUSH_ITEM_NONE
    n_osds = len(alive_osds)

    def hole(osd: int) -> bool:
        return osd == CRUSH_ITEM_NONE or not (0 <= osd < n_osds)

    infos = [ShardInfo(slot, osd,
                       not hole(osd) and bool(alive_osds[osd]),
                       backend.shard_applied[slot])
             for slot, osd in enumerate(backend.acting)]
    live = [i for i in infos if i.alive]
    undersized = any(hole(i.osd) for i in infos)

    # -- GetLog: the authoritative version reachable from live shards ------
    auth_version = max((i.applied for i in live), default=0)

    # -- GetMissing: per live shard, what it must replay -------------------
    behind = [i for i in live if i.applied < head]
    missing: dict[int, list[str] | str] = {}
    if compute_missing:
        for i in behind:
            names = backend.pg_log.missing_since(i.applied)
            missing[i.slot] = BACKFILL if names is None else names

    # -- classify (choose_acting/Activate outcome) -------------------------
    # distinct OSDs, mirroring the min_size gate: two slots on one
    # disk are one failure domain
    live_osds = {i.osd for i in live}
    fresh_osds = {i.osd for i in live if i.applied >= head}
    min_live = backend.min_live
    needs_up_thru = False
    if len(live_osds) < min_live:
        state = "down"
    elif len(fresh_osds) < min_live:
        # enough processes, but not enough of them have the newest
        # writes: I/O on recent objects would be wrong/unrecoverable
        state = "incomplete"
    elif up_thru is not None and up_thru < interval_start:
        # WaitUpThru: the data is there, but the primary may not serve
        # a single write until the monitors have recorded its up_thru
        # for this interval — or a later peering could not prove
        # whether this interval went rw (ref: adjust_need_up_thru)
        state = "peering"
        needs_up_thru = True
    elif backfilling:
        state = "active+backfilling"
    elif behind or len(live) < len(infos):
        state = "active+degraded"
    else:
        state = "active+clean"
    if undersized and state.startswith("active"):
        state += "+undersized"
    return PeeringResult(state, auth_version, head, infos, missing,
                         needs_up_thru=needs_up_thru)
