"""Repair policy plane — WHEN and IN WHAT ORDER to repair, not how.

The stack below this module already repairs FAST (r10 fused recovery
batches, r14 minimal-helper plans, r16 delta writes); what it lacked
was judgement. The Facebook warehouse study (arxiv 1309.0186) measured
that recovery traffic — not client IO — is what saturates erasure-coded
clusters, and that the large majority of "failures" are transient: a
daemon back in 90 seconds does not deserve a multi-gigabyte rebuild.
This module is the policy layer between failure detection and the r14
planner, three mechanisms:

* **DownClock + lazy repair.** A per-OSD state machine
  (up -> suspect -> down_deferred -> down_confirmed) driven by the
  evidence the daemon already has: heartbeat/complaint suspicion and
  the committed map's down marks. While a peer is `down_deferred`
  (map-down for less than `osd_repair_delay`), shard rebuilds for it
  are PARKED — the reconcile pass plans nothing and moves nothing. A
  revive inside the window cancels the parked work with only a
  cursor/version re-check (the PG-log missing-set walk; zero bytes
  when no write landed in the window). The delay loses to three
  overrides: a stripe at m-1 surviving redundancy (one more failure =
  data loss) repairs immediately, an outstanding-stripe budget
  (`osd_repair_deferred_max_stripes`) bounds the exposure a patient
  policy can accumulate, and an OUT mark (the operator or
  mon_osd_down_out_interval said permanent) confirms instantly.

* **Risk-ordered burst recovery.** On multi-failure events the rebuild
  queue orders by stripe risk — fewest surviving redundancy shards
  first, ties broken by the r14 plan's helper cost (cheapest exposure
  reduction first), then PG id for determinism — so cumulative
  stripe-time at m-1 shrinks even when total repair time is unchanged
  (the queue is a schedule; risk order is shortest-exposure-first).

* **Per-failure-domain repair budgets.** Repair grants draw from token
  buckets keyed by the CRUSH failure domain of the helper set
  (scheduler.DomainBudgets), so one rack's burst rebuild cannot
  saturate another rack's uplinks; enforcement rides the existing
  mClock `background_recovery` grant path — a grant whose domains are
  out of tokens re-queues instead of executing.

Everything here is clock-agnostic (`now` is a parameter) so the scale
sim replays a day of churn in virtual time through the SAME policy
object the live daemon runs, and config resolves AT CALL TIME through
the daemon's layered Config — a committed `config set osd_repair_*`
retunes a running policy with no restart.
"""

from __future__ import annotations

from typing import Callable, Iterable

__all__ = ["DownClock", "RepairPolicy", "risk_key", "order_plans",
           "exposure_units"]


class DownClock:
    """One OSD's failure-classification state machine.

    States and the evidence that moves them:

      up             healthy (map up, no suspicion)
      suspect        heartbeat/complaint suspicion, map still up —
                     reads/writes already route around it; repair
                     policy does nothing yet (the mon may disagree)
      down_deferred  the committed map marked it down; rebuilds are
                     parked until the repair delay elapses (or an
                     override fires)
      down_confirmed the delay elapsed / a threshold or m-1 override
                     fired / the OSD was marked out: rebuild for real

    A revive (map up again) from either down state returns to `up` and
    counts a FLAP when the down dwell was shorter than the delay — the
    signal the lazy-repair delay exists to absorb."""

    UP = "up"
    SUSPECT = "suspect"
    DOWN_DEFERRED = "down_deferred"
    DOWN_CONFIRMED = "down_confirmed"

    __slots__ = ("state", "down_since", "confirmed_reason", "flaps",
                 "transitions")

    def __init__(self):
        self.state = self.UP
        self.down_since: float | None = None
        self.confirmed_reason: str | None = None
        self.flaps = 0
        self.transitions = 0

    def _to(self, state: str) -> None:
        if state != self.state:
            self.state = state
            self.transitions += 1

    def mark_suspect(self) -> None:
        if self.state == self.UP:
            self._to(self.SUSPECT)

    def clear_suspect(self) -> None:
        if self.state == self.SUSPECT:
            self._to(self.UP)

    def mark_down(self, now: float) -> None:
        if self.state in (self.DOWN_DEFERRED, self.DOWN_CONFIRMED):
            return
        self.down_since = now
        self.confirmed_reason = None
        self._to(self.DOWN_DEFERRED)

    def mark_up(self, now: float, delay: float) -> bool:
        """Map says up again. Returns True when this revive cancels a
        deferral window that was still open (the lazy-repair win)."""
        was_deferred = self.state == self.DOWN_DEFERRED
        if self.state in (self.DOWN_DEFERRED, self.DOWN_CONFIRMED):
            if self.down_since is not None \
                    and now - self.down_since < max(delay, 0.0):
                self.flaps += 1
        self.down_since = None
        self.confirmed_reason = None
        self._to(self.UP)
        return was_deferred

    def confirm(self, reason: str) -> None:
        """Deferral lost: delay elapsed, stripe budget blown, m-1
        override, or an OUT mark. One-way until the next revive."""
        if self.state == self.DOWN_DEFERRED:
            self.confirmed_reason = reason
            self._to(self.DOWN_CONFIRMED)

    def maybe_confirm_elapsed(self, delay: float, now: float) -> bool:
        if self.state == self.DOWN_DEFERRED \
                and self.down_since is not None \
                and now - self.down_since >= max(delay, 0.0):
            self.confirm("delay_elapsed")
        return self.state == self.DOWN_CONFIRMED

    def dump(self) -> dict:
        return {"state": self.state, "down_since": self.down_since,
                "confirmed_reason": self.confirmed_reason,
                "flaps": self.flaps, "transitions": self.transitions}


#: every counter the policy keeps — the daemon mirrors these into its
#: declared PerfCounters under the same names (r9 discipline: declared
#: once, asserted by the observability smoke)
POLICY_COUNTERS = (
    "repair_deferred_stripes",       # stripes parked behind the delay
    "repair_deferred_cancelled",     # parked PGs cancelled by a revive
    "repair_deferred_confirmed",     # parked PGs that went to rebuild
    "repair_cancel_noop",            # revive re-checks that moved 0 B
    "repair_catchup_objects",        # objects the cursor re-check DID
    #                                  have to replay (writes landed
    #                                  inside the window)
    "repair_urgent_overrides",       # m-1 stripes that beat the delay
    "repair_urgent_parked",          # MUST STAY 0: an at-risk stripe
    #                                  was parked (invariant checker)
    "repair_risk_inversions",        # MUST STAY 0 under risk order: a
    #                                  healthier stripe was queued
    #                                  ahead of an exposed one
    "repair_domain_throttles",       # grants deferred by a domain
    #                                  token bucket
    "repair_time_at_m1_ms",          # cumulative stripe-time at m-1
    # r21 capacity plane
    "repair_backfillfull_parked",    # rounds parked: a replacement
    #                                  target sat at/over backfillfull
    "repair_enospc_parked",          # rounds parked: writeback hit
    #                                  ENOSPC mid-rebuild (cursors
    #                                  intact, retried next reconcile)
    # r22 network plane
    "slow_link_suspects",            # peers marked DownClock-suspect
    #                                  on measured slow-link evidence
    #                                  (hb RTT ewma over the slow-ping
    #                                  line; one tick per flip)
)


class RepairPolicy:
    """The daemon-side policy state: DownClocks for every peer, the
    parked-rebuild table, revive re-check queue, and the time-at-m-1
    accounting. Owned per OSDDaemon (policy is local to the primary
    that would plan the repair, exactly like the reconcile pass);
    in-RAM like the rest of the observability plane — a restarted
    primary starts conservative (unknown down peers confirm
    immediately; see `observe_map`)."""

    def __init__(self, config=None, perf=None,
                 now_fn: Callable[[], float] | None = None):
        # config: a utils.config.Config (or any mapping); resolved at
        # CALL time so committed central-config changes apply live
        self._config = config
        self._perf = perf
        self._now = now_fn
        self.clocks: dict[int, DownClock] = {}
        # ps -> {"dead": set, "since": t, "lost": n, "stripes": n}
        self.parked: dict[int, dict] = {}
        # ps -> revived osd ids whose shards need the cursor re-check
        self.rechecks: dict[int, set[int]] = {}
        # ps -> wall stamp the PG was first seen at m-1 redundancy
        self._exposed_since: dict[int, float] = {}
        self.counters: dict[str, int] = {k: 0 for k in POLICY_COUNTERS}
        self._last_up: dict[int, bool] = {}

    # -- plumbing ------------------------------------------------------------

    def _cfg(self, key: str, default):
        if self._config is None:
            return default
        try:
            return self._config[key]
        except KeyError:
            return default

    def _count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n
        if self._perf is not None:
            try:
                self._perf.inc(key, n)
            except KeyError:
                pass    # harness perf without the declared schema

    def clock(self, osd: int) -> DownClock:
        if osd not in self.clocks:
            self.clocks[osd] = DownClock()
        return self.clocks[osd]

    @property
    def delay(self) -> float:
        return float(self._cfg("osd_repair_delay", 0.0))

    @property
    def max_deferred_stripes(self) -> int:
        return int(self._cfg("osd_repair_deferred_max_stripes", 512))

    @property
    def queue_order(self) -> str:
        return str(self._cfg("osd_repair_queue_order", "risk"))

    # -- evidence ------------------------------------------------------------

    def observe_map(self, osd_up: Iterable[bool], out_osds:
                    Iterable[int] = (), now: float | None = None,
                    suspect: Iterable[int] = ()) -> list[int]:
        """Fold one committed map's liveness into the clocks. Returns
        the osds that REVIVED (down -> up) so the caller can cancel
        parked work and queue cursor re-checks for them.

        First observation semantics: an OSD already down in the very
        first map this policy sees has an UNKNOWN down stamp (the
        previous primary's RAM died with it) — it confirms immediately.
        Deferring an unknowable window would gamble data safety on a
        guess, so a restarted primary is eager, not patient."""
        now = self._now() if now is None and self._now else (now or 0.0)
        first = not self._last_up
        revived: list[int] = []
        up_list = list(osd_up)
        out = set(out_osds)
        susp = set(suspect)
        for osd, up in enumerate(up_list):
            ck = self.clock(osd)
            prev = self._last_up.get(osd)
            if up:
                if prev is False or ck.state in (DownClock.DOWN_DEFERRED,
                                                 DownClock.DOWN_CONFIRMED):
                    ck.mark_up(now, self.delay)
                    revived.append(osd)
                if osd in susp:
                    ck.mark_suspect()
                else:
                    ck.clear_suspect()
            else:
                ck.mark_down(now)
                if first:
                    ck.confirm("unknown_down_at_boot")
                if osd in out:
                    ck.confirm("marked_out")
            self._last_up[osd] = bool(up)
        if revived:
            for ps, ent in list(self.parked.items()):
                hit = ent["dead"] & set(revived)
                if hit:
                    self.rechecks.setdefault(ps, set()).update(hit)
                    ent["dead"] -= hit
                    if not ent["dead"]:
                        self.parked.pop(ps, None)
                        self._count("repair_deferred_cancelled")
        return revived

    def note_suspect(self, osd: int) -> None:
        self.clock(osd).mark_suspect()

    def note_slow_link(self, osd: int) -> None:
        """r22: measured slow-link evidence (heartbeat RTT ewma over
        the slow-ping line) — same DownClock suspect mark as
        heartbeat silence, but counted separately so operators can
        tell a sick WIRE from a silent peer."""
        self.clock(osd).mark_suspect()
        self._count("slow_link_suspects")

    # -- decisions -----------------------------------------------------------

    def should_defer(self, ps: int, dead_osds: Iterable[int],
                     n_lost: int, redundancy: int, n_stripes: int,
                     now: float | None = None) -> bool:
        """One PG's park-or-plan decision for `n_lost` lost slots whose
        old holders are `dead_osds`, on a code tolerating `redundancy`
        losses. True = park (lazy). The overrides, in order:

        * delay <= 0 (policy off) or any dead holder unknown/confirmed
          -> plan now;
        * m-1 override: surviving redundancy <= 1 -> plan NOW, count
          the override, and confirm the holders (a second stripe of
          the same OSD must not re-enter deferral);
        * stripe budget: parked stripes past
          osd_repair_deferred_max_stripes -> plan now.
        """
        now = self._now() if now is None and self._now else (now or 0.0)
        delay = self.delay
        dead = {int(o) for o in dead_osds}
        if n_lost <= 0 or not dead:
            return False
        urgent = (redundancy - n_lost) <= 1
        if urgent:
            if any(self.clock(o).state == DownClock.DOWN_DEFERRED
                   for o in dead):
                self._count("repair_urgent_overrides")
                for o in dead:
                    self.clock(o).confirm("m1_override")
            self._unpark(ps)
            return False
        if delay <= 0:
            return False
        for o in dead:
            ck = self.clock(o)
            if ck.state != DownClock.DOWN_DEFERRED:
                return False
            if ck.maybe_confirm_elapsed(delay, now):
                self._count("repair_deferred_confirmed")
                self._unpark(ps)
                return False
        outstanding = sum(e["stripes"] for e in self.parked.values()
                          if e is not self.parked.get(ps))
        if outstanding + n_stripes > self.max_deferred_stripes:
            for o in dead:
                self.clock(o).confirm("stripe_budget")
            self._count("repair_deferred_confirmed")
            self._unpark(ps)
            return False
        if ps not in self.parked:
            self._count("repair_deferred_stripes", n_stripes)
        self.parked[ps] = {"dead": dead, "since":
                           self.parked.get(ps, {}).get("since", now),
                           "lost": n_lost, "stripes": n_stripes}
        return True

    def _unpark(self, ps: int) -> None:
        self.parked.pop(ps, None)

    def note_planned(self, ps: int) -> None:
        """A rebuild for this PG is actually being planned — drop any
        parked record (the plan subsumes it)."""
        self._unpark(ps)

    def take_recheck(self, ps: int) -> set[int]:
        """The revived osds whose shards this PG must cursor-check
        (consumed — the re-check runs once per revive)."""
        return self.rechecks.pop(ps, set())

    def note_recheck(self, moved_objects: int) -> None:
        if moved_objects:
            self._count("repair_catchup_objects", moved_objects)
        else:
            self._count("repair_cancel_noop")

    # -- exposure accounting ---------------------------------------------------

    def note_exposure(self, ps: int, at_m1: bool,
                      now: float | None = None) -> None:
        """Track cumulative stripe-time at m-1 redundancy (the metric
        risk ordering exists to shrink). Transitions accumulate into
        repair_time_at_m1_ms; steady state costs a dict probe."""
        now = self._now() if now is None and self._now else (now or 0.0)
        if at_m1:
            self._exposed_since.setdefault(ps, now)
        else:
            t0 = self._exposed_since.pop(ps, None)
            if t0 is not None:
                self._count("repair_time_at_m1_ms",
                            max(0, int((now - t0) * 1000)))

    def exposed_pgs(self) -> int:
        return len(self._exposed_since)

    # -- introspection ---------------------------------------------------------

    def dump(self) -> dict:
        return {
            "counters": dict(self.counters),
            "parked": {str(ps): {"dead": sorted(e["dead"]),
                                 "since": e["since"],
                                 "lost": e["lost"],
                                 "stripes": e["stripes"]}
                       for ps, e in sorted(self.parked.items())},
            "exposed_pgs": self.exposed_pgs(),
            "clocks": {str(o): ck.dump()
                       for o, ck in sorted(self.clocks.items())
                       if ck.state != DownClock.UP or ck.flaps},
            "config": {"osd_repair_delay": self.delay,
                       "osd_repair_deferred_max_stripes":
                           self.max_deferred_stripes,
                       "osd_repair_queue_order": self.queue_order},
        }


# -- queue ordering ------------------------------------------------------------

def risk_key(redundancy_left: int, helper_cost: float, ps: int
             ) -> tuple:
    """The rebuild queue's sort key: most exposed first (fewest
    surviving redundancy shards), cheapest helper plan second (an
    exposed stripe that repairs in half the bytes halves its residual
    exposure window), PG id last for determinism."""
    return (redundancy_left, helper_cost, ps)


def plan_helper_cost(plan) -> float:
    """Tie-break cost of one r14 plan: helper rows on the wire scaled
    by the sub-chunk fraction (what the planner minimized)."""
    rp = getattr(plan, "repair", None)
    frac = rp.wire_fraction if rp is not None else 1.0
    return len(getattr(plan, "helper", ())) * frac


def order_plans(entries, redundancy_of, mode: str = "risk",
                counter: Callable[[str, int], None] | None = None):
    """Order a reconcile pass's [(ps, plan, dead)] rebuild entries.

    mode="risk" sorts by risk_key; mode="pgid" keeps PG-id order (the
    pre-r17 behavior, kept selectable so the exposure comparison stays
    measurable) but COUNTS the inversions it ships — every position
    where a healthier stripe precedes a more exposed one increments
    repair_risk_inversions, the invariant signal the thrasher asserts
    stays 0 under risk order."""
    def key(ent):
        ps, plan, _dead = ent
        left = redundancy_of(ps, plan)
        return risk_key(left, plan_helper_cost(plan), ps)

    ranked = sorted(entries, key=key)
    out = ranked if mode == "risk" else sorted(entries,
                                               key=lambda e: e[0])
    if counter is not None:
        inversions = 0
        lefts = [redundancy_of(ps, plan) for ps, plan, _d in out]
        for i in range(len(lefts)):
            for j in range(i + 1, len(lefts)):
                if lefts[i] > lefts[j]:
                    inversions += 1
        if inversions:
            counter("repair_risk_inversions", inversions)
    return out


def exposure_units(queue: Iterable[tuple[int, float, bool]]) -> float:
    """Cumulative exposure of a rebuild schedule: for every stripe at
    m-1 redundancy, the work units processed until IT completes (its
    position in the schedule, cost-weighted). The unit is
    bytes-processed x stripes-exposed — a pure count, so risk-vs-pgid
    comparisons are deterministic on any box.

    queue: ordered (pg, rebuild_cost, at_m1) entries."""
    done = 0.0
    exposure = 0.0
    for _pg, cost, at_m1 in queue:
        done += float(cost)
        if at_m1:
            exposure += done
    return exposure
