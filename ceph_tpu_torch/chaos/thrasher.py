"""Thrasher — a deterministic, seed-driven fault scheduler for the
wire tier (the teuthology OSDThrasher role, ref: qa/tasks/
ceph_manager.py: random kill/revive/injection during live I/O, then
assert the cluster converged and nothing was lost).

Design goals, in order:

1. REPRODUCIBLE. Every decision — which fault, which victim, what
   data, which injection knob values — is drawn from ONE
   `random.Random(seed)`. The messenger injection knobs are seeded
   per daemon (`Messenger.seed_injection`), so a logged seed replays
   the same fault schedule and the same delay draws. Thread
   interleaving still varies run to run (real sockets, real
   threads), which is the point: the schedule is the experiment, the
   nondeterministic execution is the population it samples.
2. COMPOSED. Faults run with cephx tickets AND secure (encrypted)
   frames on, over either store backend ("mem"/"tin"), with
   `ms_inject_socket_failures` + `ms_inject_delay` live on every
   daemon and scheduled scrub enabled — the full production-shaped
   stack, not an isolated knob (round 5's messenger identity bugs
   only surfaced under exactly this composition).
3. CHECKED. After every round's heal the invariants run:
     * convergence   — every PG's primary hosts a caught-up backend
                       (wait_for_clean);
     * exactly-once  — every acked write reads back byte-exact, every
       bytes           acked overwrite reads the LAST acked value;
     * no            — an acked remove stays removed (a rejoined
       resurrection    shard's stale copy must never come back);
   and at teardown:
     * fsck-clean    — every TinStore directory (the stores crashed
       remount         mid-chaos and remounted, then died with the
                       final shutdown) passes offline fsck with zero
                       errors.
   An invariant failure raises InvariantViolation carrying the seed
   and the one-command reproducer (`tools/thrash.py --seed N ...`).

Client ops that fail mid-chaos (PG below min_size, primary pre-
active, quorum loss) are PARKED, not errors: the op's target object
moves to the `unknown` set and is excluded from exactly-once /
resurrection claims — an op whose ack never arrived proves nothing
either way (the reference's thrasher tolerates EAGAIN the same way).

Twin of ceph_tpu/chaos/thrasher.py, line for line apart from the
device: `Thrasher(..., device=None)` hands it to the StandaloneCluster
it builds (None is the current CUDA device, and raises without one; the
tests pass "cpu"). The fault menu, its weights, every RNG draw, the
invariant oracles and the reproducer line are the twin's, so a seed
draws the twin's schedule.
"""

from __future__ import annotations

import random
import time


def load_factor(cap: float = 4.0) -> float:
    """How oversubscribed this host is right now (1-min loadavg per
    core, floored at 1, capped). Deadline scaling for timing-sensitive
    cells: convergence/heartbeat budgets tuned on an idle box flake
    under full-suite load (CHANGES r10: matrix cell [41-tin] and the
    standalone leader-failover case pass alone, fail only under load)
    — scaling the DEADLINE by the observed load keeps the assertion
    meaningful on both."""
    import os
    try:
        la = os.getloadavg()[0]
    except (OSError, AttributeError):
        return 1.0
    cpus = os.cpu_count() or 1
    return max(1.0, min(cap, la / cpus))

#: the fault menu — name -> (weight, description). `--list-knobs`
#: prints this; the weights are part of the schedule contract (a seed
#: replays the same draws only against the same menu).
KNOBS: dict[str, tuple[int, str]] = {
    "write": (4, "write fresh objects through the client"),
    "overwrite": (2, "rewrite a previously-named object (exactly-once "
                     "check tracks the last acked value)"),
    "remove": (2, "remove an object (no-resurrection check)"),
    "kill_osd": (2, "SIGKILL an OSD (budget: <= m concurrently dead)"),
    "revive_osd": (2, "revive a killed OSD (TinStore: WAL remount)"),
    "remount": (1, "kill + immediately revive one OSD — a pure "
                   "store-remount cycle"),
    "socket_failures": (1, "re-seed ms_inject_socket_failures with a "
                           "drawn period on every live daemon"),
    "delays": (1, "re-seed ms_inject_delay with drawn period/max_ms"),
    "mon_kill": (1, "SIGKILL a monitor (may take out the majority — "
                    "map mutations and activation stall)"),
    "mon_revive": (1, "revive a killed monitor (store sync + "
                      "election)"),
    "deep_scrub": (1, "client-driven deep scrub of a random PG "
                      "(scheduled scrub also runs throughout via "
                      "osd_scrub_interval)"),
}


def repro_command(seed: int, store: str, rounds: int, ops: int,
                  op_shards: int = 1, osd_procs: bool = False,
                  rotate_secrets: bool = False,
                  overwrite_during_faults: bool = False,
                  transient_fraction: float = 0.0,
                  workload_profile: str | None = None,
                  disk_full: bool = False,
                  link_degrade: bool = False) -> str:
    """The one-command local reproduction for a failing cell."""
    cmd = (f"python tools/thrash.py --seed {seed} --store {store} "
           f"--rounds {rounds} --ops {ops}")
    if op_shards != 1:
        cmd += f" --op-shards {op_shards}"
    if osd_procs:
        cmd += " --osd-procs"
    if rotate_secrets:
        cmd += " --rotate-secrets"
    if overwrite_during_faults:
        cmd += " --overwrite-during-faults"
    if transient_fraction:
        cmd += f" --transient-fraction {transient_fraction}"
    if workload_profile:
        cmd += f" --workload-profile {workload_profile}"
    if disk_full:
        cmd += " --disk-full"
    if link_degrade:
        cmd += " --link-degrade"
    return cmd


class InvariantViolation(AssertionError):
    """An invariant failed; the message carries seed + reproducer."""

    def __init__(self, what: str, seed: int, repro: str):
        super().__init__(
            f"{what}\n  thrash seed: {seed}\n  reproduce: {repro}")
        self.seed = seed
        self.repro = repro


class Thrasher:
    """One seeded thrash run over a StandaloneCluster."""

    def __init__(self, seed: int, store: str = "mem", rounds: int = 2,
                 ops: int = 6, n_osds: int = 4, pg_num: int = 2,
                 store_dir: str | None = None, verbose: bool = False,
                 read_during_faults: bool = False,
                 op_shards: int = 1, osd_procs: bool = False,
                 rotate_secrets: bool = False,
                 overwrite_during_faults: bool = False,
                 transient_fraction: float = 0.0,
                 profile: str | None = None,
                 workload_profile: str | None = None,
                 disk_full: bool = False,
                 link_degrade: bool = False, device=None):
        self.seed = int(seed)
        # the cluster's device: every daemon's encodes, deltas, decodes
        # and CRCs run there (None: the current CUDA device)
        from ..ec.interface import resolve_device
        self.device = resolve_device(device)
        self.store = store
        self.rounds = rounds
        self.ops = ops
        self.n_osds = n_osds
        self.pg_num = pg_num
        self.store_dir = store_dir
        self.verbose = verbose
        # mid-fault read sweep (degraded-read invariant): every acked
        # object must read back bit-exact BEFORE the round heals —
        # i.e. no read ever blocks on wait_for_clean. Off by default
        # so the seed-pinned matrix cells keep their timing profile.
        self.read_during_faults = read_during_faults
        self.degraded_read_checks = 0
        # r13: osd_op_num_shards under chaos — ops hash by PG to
        # per-shard mClock queues; the exactly-once/no-resurrection
        # invariants must hold under sharded dispatch too
        self.op_shards = int(op_shards)
        # r15: every OSD in its own OS process (multiproc.py); forces
        # a real on-disk store so SIGKILL+revive survives the process
        # boundary, and routes the RAM-reaching helpers (rotation
        # push, store fsck) over the new control lines
        self.osd_procs = bool(osd_procs)
        if self.osd_procs:
            self.store = store = "tin"
        # deterministic per-round secret rotation (OUTSIDE the seeded
        # action menu, so existing seed-pinned cells replay unchanged):
        # rotate at every heal; live daemons — child processes
        # included — must keep serving through the keep-window
        self.rotate_secrets = bool(rotate_secrets)
        # r16: partial overwrites WITH the round's faults still live —
        # SIGKILL lands mid-RMW, exercising the stripe journal's
        # replay under the exactly-once/no-resurrection checkers. Like
        # rotate_secrets, the sweep draws from its OWN seeded stream
        # (OUTSIDE the action menu) so pinned cells replay unchanged.
        self.overwrite_during_faults = bool(overwrite_during_faults)
        self.rmw_rng = random.Random(self.seed ^ 0x5EED)
        self.rmw_overwrite_checks = 0
        # r17: transient-vs-real failure mix — a seeded fraction of
        # extra kills AUTO-REVIVE inside or outside the repair delay
        # window, exercising the lazy-repair policy under chaos. The
        # sweep draws from its OWN stream (OUTSIDE the action menu,
        # like rmw_rng) so pinned cells replay unchanged; victims are
        # tracked apart from dead_osds so the menu's draws stay
        # schedule-deterministic. Requires in-process daemons (the
        # invariant checkers read policy counters from daemon RAM).
        self.transient_fraction = float(transient_fraction)
        self.profile = profile
        # r20: a seeded tenant-profile op burst rides each round's
        # fault window — the workload engine's stream generator
        # (ceph_tpu.workload) keyed on (profile, seed ^ round), so
        # the burst is fully deterministic and, like rmw_rng, lives
        # OUTSIDE the action menu: pinned cells replay unchanged
        # when the flag is off
        self.workload_profile = workload_profile
        self.workload_ops = 0
        # r21: the disk_full fault stream — capacity-exhaustion
        # windows (every live store shrunk to just over the failsafe
        # ratio, mon ladder flips FULL, a background writer must PARK
        # with zero op_errors and drain exactly-once after restore)
        # plus one-shot ENOSPC injection at a drawn store txn phase
        # each round. Own stream (OUTSIDE the action menu, like
        # rmw_rng): pinned cells replay unchanged with the flag off.
        # In-process only: the sweep reaches stores and perf counters
        # through daemon RAM.
        self.disk_full = bool(disk_full)
        self.full_rng = random.Random(self.seed ^ 0xF011)
        self.full_windows = 0
        self.full_reads_served = 0
        self.full_parked_drained = 0
        self.enospc_injected = 0
        self.enospc_fired = 0
        #: armed one-shot ENOSPC faults: (osd, phase, {"n": shots})
        self._armed_faults: list[tuple[int, str, dict]] = []
        # r22: the link_degrade fault stream — one directed-link
        # degrade window per round against the HEALED cluster: a drawn
        # one-way delay+jitter on exactly one sender->peer edge, and
        # the netobs plane must (a) flip OSD_SLOW_PING_TIME naming
        # exactly that link within two grace windows, (b) reprice the
        # degraded peer worst in the sender's helper-cost feed
        # (counter-pinned on net_helper_penalties), (c) clear after
        # heal. Own stream (OUTSIDE the action menu, like rmw_rng):
        # pinned cells replay unchanged with the flag off. In-process
        # only (the window reads link trackers and perf counters from
        # daemon RAM).
        self.link_degrade = bool(link_degrade)
        self.link_rng = random.Random(self.seed ^ 0x11CD)
        self.link_windows = 0
        self.link_health_flips = 0
        self.link_health_clears = 0
        self.link_repriced = 0
        self.trans_rng = random.Random(self.seed ^ 0x7AB5)
        # victim -> (revive deadline, inside_window, quiet_start,
        #            kill schedule idx, repair-bytes snapshot at kill)
        self.transient_dead: dict[int, tuple] = {}
        self.transient_kills = 0
        self.transient_revives_inside = 0
        self.transient_noop_checks = 0
        self.transient_noop_skips = 0
        # deadline scaling, NOT schedule input: the RNG stream never
        # sees it, so a seed replays identically on an idle box.
        # self.load is the CONSTRUCTION-TIME sample — it pins the
        # config the daemons run under (op_timeout, hb_grace,
        # osd_repair_delay) so those stay stable for the whole run.
        # Wait-site deadlines re-sample via _load() instead (r22
        # deflake): a full-suite run's load ramps over minutes, and a
        # deadline scaled by a stale sample taken at construction
        # under-budgets the waits that actually hit the loaded phase.
        self.load = load_factor()
        # wall seconds of the r17 repair delay the transient cells run
        # under (load-scaled at execution, never an RNG input)
        self.repair_delay = 5.0 * self.load
        self.rng = random.Random(self.seed)
        # shadow state (the invariant oracles)
        self.shadow: dict[str, bytes] = {}   # name -> last ACKED bytes
        self.removed: set[str] = set()       # ACKED removes
        self.unknown: set[str] = set()       # un-acked fate: no claims
        self.dead_osds: set[int] = set()
        self.dead_mons: set[int] = set()
        self.schedule: list[str] = []        # the replayable fault log
        self._obj_i = 0
        self.repro = repro_command(
            self.seed, self.store, rounds, ops,
            op_shards=self.op_shards, osd_procs=self.osd_procs,
            rotate_secrets=self.rotate_secrets,
            overwrite_during_faults=self.overwrite_during_faults,
            transient_fraction=self.transient_fraction,
            workload_profile=self.workload_profile,
            disk_full=self.disk_full,
            link_degrade=self.link_degrade)
        self.c = None
        self.cl = None

    # -- plumbing ------------------------------------------------------------

    def _load(self) -> float:
        """Fresh load sample for a WAIT-SITE deadline (never for
        config, never for an RNG stream): at least the construction
        sample, so a deadline never shrinks mid-run below what the
        daemons' own load-pinned config was budgeted for."""
        return max(self.load, load_factor())

    def _log(self, msg: str) -> None:
        self.schedule.append(msg)
        # every fault event ALSO rides the gathered log ring with the
        # seed stamped in, so `ceph daemon <name> log dump` over the
        # admin socket reconstructs the fault timeline mid-chaos —
        # interleaved with the daemons' own events in one clock
        from ..utils.log import dout
        dout("chaos", 1, f"thrash seed={self.seed} {msg}")
        if self.verbose:
            print(f"thrash[{self.seed}]: {msg}", flush=True)

    def _violate(self, what: str) -> None:
        raise InvariantViolation(what, self.seed, self.repro)

    def _fresh_names(self, n: int) -> list[str]:
        names = [f"thrash-{self.seed}-{self._obj_i + j}"
                 for j in range(n)]
        self._obj_i += n
        return names

    def _parked(self, what: str, e: Exception) -> None:
        self._log(f"parked {what}: {type(e).__name__}")

    # -- setup / teardown ----------------------------------------------------

    def setup(self):
        from ..osd.standalone import StandaloneCluster
        # cephx + secure ON: the secret is seed-derived so even the
        # key schedule replays; tin gets a real on-disk directory
        secret = bytes(self.rng.randrange(256) for _ in range(32))
        self._log(f"setup n_osds={self.n_osds} pg_num={self.pg_num} "
                  f"store={self.store} cephx+secure on")
        kwargs = {}
        if self.profile is not None:
            kwargs["profile"] = self.profile
        self.c = StandaloneCluster(
            n_osds=self.n_osds, pg_num=self.pg_num, store=self.store,
            store_dir=self.store_dir, cephx=True, secret=secret,
            # op_timeout scales too (r19 deflake): a 6s budget tuned
            # idle let in-flight ops time out under full-suite load
            # and read as transient-smoke failures [311]
            op_timeout=6.0 * self.load, op_shards=self.op_shards,
            osd_procs=self.osd_procs,
            # a loaded host stretches every ping round trip: scale the
            # grace with the observed load so CPU starvation doesn't
            # read as daemon death (the [41-tin] full-suite flake)
            hb_grace=1.2 * self.load, device=self.device, **kwargs)
        self.m = self.c.pool_size - self.c.pool_min_size
        self.c.wait_for_clean(timeout=40 * self._load())
        self.cl = self.c.client()
        # injection + scheduled scrub live from the start
        self._set_injection()
        try:
            self.cl.config_set("osd_scrub_interval", 3.0,
                                timeout=20 * self._load())
            self.cl.config_set("osd_scrub_auto_repair", "true",
                               timeout=20 * self._load())
        except TimeoutError as e:
            self._parked("config_set scrub", e)
        if self.disk_full and self.osd_procs:
            raise ValueError("disk_full needs in-process daemons "
                             "(capacity shrink + fault arming reach "
                             "stores through daemon RAM)")
        if self.link_degrade and self.osd_procs:
            raise ValueError("link_degrade needs in-process daemons "
                             "(delay injection + link trackers live "
                             "in daemon RAM)")
        if self.transient_fraction > 0:
            if self.osd_procs:
                raise ValueError("transient_fraction needs in-process "
                                 "daemons (policy counters live in "
                                 "daemon RAM)")
            try:
                self.cl.config_set("osd_repair_delay",
                                   self.repair_delay,
                                   timeout=20 * self._load())
            except TimeoutError as e:
                self._parked("config_set osd_repair_delay", e)
        return self

    def teardown(self) -> None:
        if self.c is None:
            return
        self.c.inject_socket_failures(0)
        self.c.inject_delays(0, 0.0)
        self.c.heal_link_degrades()
        self.c.shutdown()

    def _set_injection(self) -> None:
        every_sock = self.rng.randrange(8, 14)
        every_delay = self.rng.randrange(5, 10)
        max_ms = self.rng.uniform(4.0, 12.0)
        alive = sorted(set(self.c.osd_ids()) - self.dead_osds)
        self.c.inject_socket_failures(every_sock, osds=alive,
                                      seed=self.seed)
        self.c.inject_delays(every_delay, max_ms, osds=alive,
                             seed=self.seed)
        self._log(f"inject socket_failures={every_sock} "
                  f"delay=({every_delay}, {max_ms:.1f}ms)")

    # -- fault + IO actions --------------------------------------------------

    def act_write(self) -> None:
        objs = {n: self.rng.randbytes(self.rng.randrange(50, 900))
                for n in self._fresh_names(self.rng.randrange(2, 5))}
        try:
            self.cl.write(objs)
        except (ConnectionError, OSError, RuntimeError) as e:
            self.unknown.update(objs)
            self._parked("write", e)
            return
        self.shadow.update(objs)
        self.removed -= set(objs)
        self._log(f"write {len(objs)} objects")

    def act_overwrite(self) -> None:
        # target drawn from the DETERMINISTIC name counter, never from
        # the ack-dependent shadow: which ops got parked varies run to
        # run (thread timing), and a state-dependent candidate set
        # would desync the RNG stream between a run and its replay
        if not self._obj_i:
            return
        name = f"thrash-{self.seed}-{self.rng.randrange(self._obj_i)}"
        data = self.rng.randbytes(self.rng.randrange(50, 900))
        try:
            self.cl.write({name: data})
        except (ConnectionError, OSError, RuntimeError) as e:
            self.unknown.add(name)
            self._parked("overwrite", e)
            return
        self.shadow[name] = data
        self.removed.discard(name)
        self.unknown.discard(name)   # ack resolves an unknown fate
        self._log(f"overwrite {name}")

    def act_remove(self) -> None:
        if self._obj_i < 3:
            return
        name = f"thrash-{self.seed}-{self.rng.randrange(self._obj_i)}"
        try:
            self.cl.remove(name)     # idempotent: absent names ack too
        except (ConnectionError, OSError, RuntimeError, KeyError) as e:
            self.unknown.add(name)
            self._parked("remove", e)
            return
        self.shadow.pop(name, None)
        self.removed.add(name)
        self.unknown.discard(name)
        self._log(f"remove {name}")

    def act_kill_osd(self) -> None:
        # transient victims count against the concurrent-death budget
        # (data safety) but are DRAWN from their own stream — with
        # transient_fraction=0 this is bit-identical to the pre-r17
        # schedule
        alive = sorted(set(self.c.osd_ids()) - self.dead_osds
                       - set(self.transient_dead))
        if len(self.dead_osds) + len(self.transient_dead) >= self.m \
                or not alive:
            return
        victim = alive[self.rng.randrange(len(alive))]
        self.c.kill_osd(victim)
        self.dead_osds.add(victim)
        self._log(f"kill osd.{victim}")

    def act_revive_osd(self) -> None:
        if not self.dead_osds:
            return
        dead = sorted(self.dead_osds)
        victim = dead[self.rng.randrange(len(dead))]
        self.c.revive_osd(victim)
        self.dead_osds.discard(victim)
        # the revived daemon rejoins the injection matrix
        self.c.inject_socket_failures(self.rng.randrange(8, 14),
                                      osds=[victim], seed=self.seed)
        self.c.inject_delays(self.rng.randrange(5, 10),
                             self.rng.uniform(4.0, 12.0),
                             osds=[victim], seed=self.seed)
        self._log(f"revive osd.{victim}")

    def act_remount(self) -> None:
        """Kill + immediate revive: on TinStore this is a real WAL+
        checkpoint remount under traffic; on MemStore a process
        restart with state kept by fiat."""
        alive = sorted(set(self.c.osd_ids()) - self.dead_osds
                       - set(self.transient_dead))
        if len(self.dead_osds) + len(self.transient_dead) >= self.m \
                or not alive:
            return
        victim = alive[self.rng.randrange(len(alive))]
        self.c.kill_osd(victim)
        self.c.revive_osd(victim)
        self.c.inject_socket_failures(self.rng.randrange(8, 14),
                                      osds=[victim], seed=self.seed)
        self._log(f"remount osd.{victim}")

    def act_socket_failures(self) -> None:
        self._set_injection()

    def act_delays(self) -> None:
        self._set_injection()

    def act_mon_kill(self) -> None:
        # allowed to take out the MAJORITY: the quorum-loss map freeze
        # (and up_thru activation stall) is part of what chaos must
        # exercise; the round's heal revives them
        alive = sorted(set(range(3)) - self.dead_mons)
        if len(self.dead_mons) >= 2 or not alive:
            return
        victim = alive[self.rng.randrange(len(alive))]
        self.c.kill_mon(victim)
        self.dead_mons.add(victim)
        self._log(f"kill mon.{victim}")

    def act_mon_revive(self) -> None:
        if not self.dead_mons:
            return
        dead = sorted(self.dead_mons)
        victim = dead[self.rng.randrange(len(dead))]
        self.c.revive_mon(victim)
        self.dead_mons.discard(victim)
        self._log(f"revive mon.{victim}")

    def act_deep_scrub(self) -> None:
        ps = self.rng.randrange(self.pg_num)
        try:
            self.cl.deep_scrub(ps)
        except (ConnectionError, OSError, RuntimeError) as e:
            self._parked("deep_scrub", e)
            return
        # the report content is run-dependent (timing); the schedule
        # line must stay replay-identical
        self._log(f"deep_scrub pg 1.{ps}")

    # -- transient failures (r17) -------------------------------------------

    _QUIET_PREFIXES = ("inject", "parked", "transient")

    def _live_daemons(self):
        return [d for d in self.c.osds.values() if not d._stop.is_set()]

    def _repair_bytes(self) -> int:
        """Cluster-wide repair traffic counter: decode rebuilds +
        helper pulls + backfill copies (the storm bench's metric)."""
        return sum(d.ec_perf.get("recovered_bytes")
                   + d.ec_perf.get("recover_wire_bytes")
                   + d.perf.get("move_bytes")
                   for d in self._live_daemons())

    def _policy_counter(self, key: str) -> int:
        return sum(d.repair_policy.counters.get(key, 0)
                   for d in self._live_daemons())

    def _transient_sweep(self, round_i: int) -> None:
        """Seeded transient kills: each victim auto-revives at a drawn
        fraction of the repair delay — inside the window (the policy
        must cancel with zero moved bytes) or outside it (the window
        expires, the rebuild runs, the revive copies back: the eager
        cost lazy repair avoids for the inside draws). Draw VALUES
        come from trans_rng only; wall-clock execution (load) never
        feeds back into any RNG stream."""
        if self.transient_fraction <= 0:
            return
        n = self.trans_rng.randrange(1, 3)
        for _ in range(n):
            if self.trans_rng.random() >= self.transient_fraction:
                continue
            alive = sorted(set(self.c.osd_ids()) - self.dead_osds
                           - set(self.transient_dead))
            if (len(self.dead_osds) + len(self.transient_dead)
                    >= max(1, self.m - 1)) or not alive:
                # keep >= 1 spare redundancy so deferral (not the m-1
                # override) is what these kills exercise
                continue
            victim = alive[self.trans_rng.randrange(len(alive))]
            inside = self.trans_rng.random() < 0.7
            frac = self.trans_rng.uniform(0.35, 0.6) if inside \
                else self.trans_rng.uniform(1.3, 1.7)
            # quiet probe: half the inside draws BLOCK the schedule
            # until the revive deadline — a guaranteed quiet window,
            # so invariant (a)'s zero-byte check actually fires under
            # chaos instead of waiting for the menu to go silent. The
            # check needs a QUIET START too: background recovery
            # already in flight (an injection-suspected peer's
            # catch-up) would move bytes the victim never caused.
            probe = inside and self.trans_rng.random() < 0.5
            b0 = self._repair_bytes()
            base = (self._policy_counter("repair_urgent_overrides"),
                    self._policy_counter("repair_deferred_confirmed"))
            quiet_start = (not self.dead_osds and not self.dead_mons
                           and not self.transient_dead and all(
                               not d._recovering
                               and not d.repair_policy.parked
                               and not d.suspect
                               for d in self._live_daemons()))
            self.c.kill_osd(victim)
            deadline = time.monotonic() + frac * self.repair_delay
            self.transient_dead[victim] = (
                deadline, inside, quiet_start, len(self.schedule),
                b0, base)
            self.transient_kills += 1
            self._log(f"transient kill osd.{victim} "
                      f"({'inside' if inside else 'outside'} window, "
                      f"revive at {frac:.2f}x delay"
                      f"{', quiet probe' if probe else ''})")
            if probe:
                while time.monotonic() < deadline:
                    time.sleep(0.1)
                self._tick_transients()

    def _tick_transients(self, final: bool = False) -> None:
        """Revive due transient victims; `final` (the heal) waits out
        and revives everything still pending. An inside-window revive
        whose down-window was QUIET (no other fault or client
        mutation in the schedule since the kill) runs invariant (a):
        the policy must cancel the parked rebuild on a cursor
        re-check alone — ZERO repair bytes moved."""
        if not self.transient_dead:
            return
        now = time.monotonic()
        for victim in sorted(self.transient_dead):
            deadline, inside, quiet_start, kill_idx, b0, base = \
                self.transient_dead[victim]
            if not final and now < deadline:
                continue
            if final and now < deadline:
                # the heal waits the window out so outside-window
                # draws really see their deferral expire (bounded:
                # draws cap at 1.7x delay)
                time.sleep(min(max(0.0, deadline - now),
                               2.0 * self.repair_delay))
            del self.transient_dead[victim]
            quiet = quiet_start and all(
                line.startswith(self._QUIET_PREFIXES)
                for line in self.schedule[kill_idx + 1:])
            self.c.revive_osd(victim)
            if inside:
                self.transient_revives_inside += 1
            self._log(f"transient revive osd.{victim} "
                      f"({'inside' if inside else 'outside'} window, "
                      f"quiet={quiet})")
            if inside and quiet:
                self._check_inside_revive_noop(victim, b0, base)
            now = time.monotonic()

    def _check_inside_revive_noop(self, victim: int, b0: int,
                                  base: tuple) -> None:
        """Invariant (a): a within-window revive of a quiet PG set
        moves NO repair bytes — the cancel is a cursor/version
        re-check. Waits (load-scaled) for the cancel to land, then
        compares the cluster repair-bytes counter to the at-kill
        snapshot."""
        deadline = time.monotonic() + 10.0 * self._load()
        while time.monotonic() < deadline:
            parked = any(victim in ent["dead"]
                         for d in self._live_daemons()
                         for ent in d.repair_policy.parked.values())
            if not parked and all(
                    d.osdmap is not None and d.osdmap.osd_up[victim]
                    for d in self._live_daemons()):
                break
            time.sleep(0.1)
        time.sleep(0.3 * self._load())   # let an (illegal) rebuild
        b1 = self._repair_bytes()        # actually show up
        # a spurious down-mark of ANOTHER osd during the window (load
        # + injection stretching heartbeats) can legitimately move
        # bytes: a second loss fires the m-1 override, or an expired
        # window confirms. Those are the policy WORKING — skip the
        # zero-byte claim, don't fail it.
        overrides = (self._policy_counter("repair_urgent_overrides"),
                     self._policy_counter("repair_deferred_confirmed"))
        if overrides != base:
            self.transient_noop_skips += 1
            self._log(f"transient noop check osd.{victim}: skipped "
                      f"(concurrent override/confirm)")
            return
        if b1 != b0:
            self._violate(
                f"transient revive of osd.{victim} inside the repair "
                f"window moved {b1 - b0} repair bytes over a quiet "
                f"window (lazy repair must cancel with a cursor "
                f"re-check only)")
        self.transient_noop_checks += 1
        self._log(f"transient noop check osd.{victim}: 0 bytes ok")

    def _check_policy_invariants(self, round_i: int) -> None:
        """Invariant (b): no stripe waits at m-1 while the queue holds
        healthier stripes — structurally, the policy never PARKS an
        at-risk stripe (repair_urgent_parked == 0) and never ships a
        risk-inverted queue under risk order (repair_risk_inversions
        == 0). Asserted every heal, transient mode or not."""
        parked = self._policy_counter("repair_urgent_parked")
        if parked:
            self._violate(f"round {round_i}: {parked} at-m-1 "
                          f"stripe(s) were parked behind the repair "
                          f"delay")
        live = self._live_daemons()
        order = str(live[0].config["osd_repair_queue_order"]) \
            if live else "risk"
        inv = self._policy_counter("repair_risk_inversions")
        if inv and order == "risk":
            self._violate(f"round {round_i}: {inv} risk "
                          f"inversion(s) in the rebuild queue under "
                          f"risk order")

    # -- capacity exhaustion (r21) --------------------------------------------

    #: store txn phases the one-shot ENOSPC draw picks from (the
    #: store/KV `set_fault` hook points; mem has no WAL/flush plane)
    _ENOSPC_PHASES = {
        "mem": ("txn.apply",),
        "tin": ("txn.apply", "wal.append", "flush.segment-written",
                "flush.manifest-swapped", "compact.segments-written",
                "compact.manifest-swapped"),
    }

    def _enospc_sweep(self, round_i: int) -> None:
        """Arm ONE one-shot ENOSPC at a drawn (victim, txn phase) for
        this round's fault window. Whatever path trips it — a client
        write's apply, a replica subop, WAL append, a background
        flush/compact — must abort atomically: the op parks as
        unknown like any other mid-chaos failure, and the torn-store
        claim is settled by the heal's exactly-once reads plus the
        final offline fsck. Draws come from full_rng only."""
        if not self.disk_full:
            return
        victims = sorted(self.c.osd_ids())
        victim = victims[self.full_rng.randrange(len(victims))]
        phases = self._ENOSPC_PHASES[self.store]
        phase = phases[self.full_rng.randrange(len(phases))]
        armed = {"n": 1}

        def fault(point, _phase=phase, _armed=armed):
            if point == _phase and _armed["n"] > 0:
                _armed["n"] -= 1
                import errno
                raise OSError(errno.ENOSPC,
                              f"injected ENOSPC at {point}")

        self.c.osds[victim].store.set_fault(fault)
        self._armed_faults.append((victim, phase, armed))
        self.enospc_injected += 1
        self._log(f"round {round_i}: armed one-shot ENOSPC on "
                  f"osd.{victim} at {phase}")

    def _clear_faults(self) -> None:
        """Disarm every injected fault (heal entry: an unfired flush/
        compact fault must not land mid-recovery-writeback AFTER the
        window it belonged to) and tally what actually fired."""
        if not self._armed_faults:
            return
        for _victim, _phase, armed in self._armed_faults:
            self.enospc_fired += 1 - armed["n"]
        self._armed_faults.clear()
        for d in self._live_daemons():
            d.store.set_fault(None)

    def _disk_full_window(self, round_i: int) -> None:
        """One capacity-exhaustion window against a CLEAN cluster
        (post-heal): shrink every store with data to just over the
        failsafe ratio, wait for the mon ladder to commit FULL, and
        assert the RADOS full contract under live injection:

          * a background writer PARKS — zero op_errors surface;
          * every acked object still READS bit-exact mid-FULL;
          * after capacity restore the flag clears and every parked
            write drains EXACTLY-ONCE (bytes verified by read-back
            here and again by the next heal's sweep).

        Draw values come from full_rng; deadlines are load-scaled
        wall clock that never feeds back into any RNG stream."""
        if not self.disk_full:
            return
        import threading
        names = self._fresh_names(self.full_rng.randrange(3, 6))
        objs = {n: self.full_rng.randbytes(
                    self.full_rng.randrange(100, 600))
                for n in names}
        shrunk: list[int] = []
        empty: list[int] = []
        cl2 = self.c.client()
        acked: dict[str, bytes] = {}
        errors: list[str] = []

        def _writer():
            for n_, data in objs.items():
                try:
                    cl2.write({n_: data})
                except Exception as e:   # noqa: BLE001 — ANY error
                    errors.append(       # here violates the contract
                        f"{n_}: {type(e).__name__}: {e}")
                    return
                acked[n_] = data

        t = threading.Thread(target=_writer, daemon=True)
        try:
            for o in sorted(self.c.osd_ids()):
                st = self.c.osds[o].store.statfs()
                used = int(st.get("used", 0))
                if used <= 0:
                    empty.append(o)   # no ratio to push over: leave
                    continue          # unbounded (can't ENOSPC either)
                # used/total ~ 0.98: over failsafe (0.97) AND over
                # mon_osd_full_ratio (0.95) in one move
                self.c.osds[o].store.set_capacity(
                    max(1, int(used / 0.98)))
                shrunk.append(o)
            if not shrunk:
                self._log(f"round {round_i}: disk_full window skipped "
                          f"(no store holds data yet)")
                return
            self._log(f"round {round_i}: disk_full window — shrank "
                      f"{len(shrunk)} store(s) over failsafe"
                      + (f" ({len(empty)} empty left unbounded)"
                         if empty else ""))
            if not empty:
                # every primary is gated: the first write bounces at
                # the OSD failsafe (statfs-only, pre-map) and the
                # client parks on the pinned epoch — start now so the
                # hard-stop path gets chaos coverage too
                t.start()
            if not self._poll_df(True, 30.0 * self._load()):
                self._violate(
                    f"round {round_i}: mon ladder never committed "
                    f"cluster FULL ({len(shrunk)} stores over the "
                    f"full ratio)")
            if not t.is_alive():
                # an empty-store primary could have raced writes
                # through pre-flip: start (or observe) post-flip
                if empty and not acked and not errors:
                    t.start()
            self.full_windows += 1
            # reads must keep serving while writes are parked
            for name in sorted(set(self.shadow) - self.unknown):
                try:
                    got = self.cl.read(name)
                except Exception as e:   # noqa: BLE001
                    self._violate(
                        f"round {round_i}: read of acked {name!r} "
                        f"failed under cluster FULL "
                        f"({type(e).__name__}: {e}) — reads must not "
                        f"park behind the full ladder")
                if got != self.shadow[name]:
                    self._violate(
                        f"round {round_i}: read of {name!r} under "
                        f"cluster FULL diverged from last acked bytes")
                self.full_reads_served += 1
            # the writer must be PARKED, not errored: backoff counter
            # growing and no op_errors surfaced
            full_wait = 30.0 * self._load()
            deadline = time.monotonic() + full_wait
            parked = False
            while time.monotonic() < deadline:
                if errors:
                    break
                fb = cl2.perf.dump().get("full_backoff_time") or {}
                if int(fb.get("avgcount", 0)) > 0:
                    parked = True
                    break
                time.sleep(0.2)
            if errors:
                self._violate(
                    f"round {round_i}: op_error surfaced to a writer "
                    f"under cluster FULL (must park, never error): "
                    f"{errors[0]}")
            if not parked:
                self._violate(
                    f"round {round_i}: writer neither parked nor "
                    f"errored under cluster FULL within "
                    f"{full_wait:.0f}s")
        finally:
            for o in shrunk:
                self.c.osds[o].store.set_capacity(
                    self.c.store_capacity)
        if not self._poll_df(False, 30.0 * self._load()):
            self._violate(f"round {round_i}: cluster FULL flag never "
                          f"cleared after capacity restore")
        drain_wait = 60.0 * self._load()
        t.join(drain_wait)
        if t.is_alive():
            self._violate(
                f"round {round_i}: parked writes failed to drain "
                f"within {drain_wait:.0f}s of the FULL flag "
                f"clearing")
        if errors:
            self._violate(
                f"round {round_i}: op_error surfaced draining parked "
                f"writes: {errors[0]}")
        if len(acked) != len(objs):
            self._violate(
                f"round {round_i}: only {len(acked)}/{len(objs)} "
                f"parked writes drained after restore")
        # exactly-once: every drained write reads back bit-exact NOW
        # (and again at the next heal via the shadow oracle)
        for n_, data in sorted(acked.items()):
            try:
                got = self.cl.read(n_)
            except Exception as e:   # noqa: BLE001
                self._violate(f"round {round_i}: drained write "
                              f"{n_!r} unreadable ({e})")
            if got != data:
                self._violate(f"round {round_i}: drained write "
                              f"{n_!r} bytes diverged")
        self.shadow.update(acked)
        self.removed -= set(acked)
        self.full_parked_drained += len(acked)
        self._log(f"round {round_i}: disk_full window ok — "
                  f"{len(acked)} parked writes drained exactly-once, "
                  f"{self.full_reads_served} reads served under FULL")

    def _poll_df(self, want_full: bool, deadline_s: float) -> dict:
        """Poll the mon `df` command until its committed-map FULL flag
        matches; {} on deadline (the caller decides the violation)."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            try:
                df = self.cl.mon_command("df",
                                         timeout=10.0 * self._load())
            except Exception:   # noqa: BLE001 — mon hunt mid-chaos
                df = None
            if isinstance(df, dict) \
                    and bool(df.get("cluster_full")) == want_full:
                return df
            time.sleep(0.2)
        return {}

    # -- network degrade (r22) ------------------------------------------------

    def _link_degrade_window(self, round_i: int) -> None:
        """One directed-link degrade window against a CLEAN cluster
        (post-heal): inject a drawn one-way delay on exactly one
        sender->peer edge and hold the netobs plane to its contract:

          * OSD_SLOW_PING_TIME flips within two heartbeat grace
            windows (plus the MgrReport pipe), naming EXACTLY the
            degraded link and no other;
          * the sender's helper-cost feed reprices the degraded peer
            worst among live helpers, pinned on the
            net_helper_penalties counter (the planner input r14/r11
            rank by — routing around the link IS this repricing);
          * after heal the check clears within the same budget.

        Draw values come from link_rng only; deadlines are load-scaled
        wall clock that never feeds back into any RNG stream."""
        if not self.link_degrade:
            return
        live = sorted(set(self.c.osd_ids()) - self.dead_osds)
        if len(live) < 3:
            self._log(f"round {round_i}: link_degrade window skipped "
                      f"(<3 live osds)")
            return
        a = live[self.link_rng.randrange(len(live))]
        others = [o for o in live if o != a]
        b = others[self.link_rng.randrange(len(others))]
        delay_ms = self.link_rng.uniform(250.0, 400.0)
        jitter_ms = self.link_rng.uniform(0.0, 30.0)
        thr_ms = 100.0   # 10-50x an in-proc RTT, 1/3 of the delay
        try:
            self.cl.config_set("mon_warn_on_slow_ping_time", thr_ms,
                               timeout=20 * self._load())
        except TimeoutError as e:
            self._parked("config_set mon_warn_on_slow_ping_time", e)
            return
        d = self.c.osds[a]
        pen0 = d.perf.get("net_helper_penalties")
        grace = float(d.config["osd_heartbeat_grace"])
        report_s = float(d.config["mgr_report_interval"])
        budget = 2.0 * grace + 2.0 * report_s + 2.0 * self._load()
        # settle: the kill/revive phase just before this window leaves
        # REAL slow residue in the matrix (pings to a dead peer are
        # answered late on its revive), and the exact-link contract
        # only holds against a quiet baseline — wait for any residue
        # to decay below the threshold before injecting
        settle = budget + 4.0 * self._load()
        deadline = time.monotonic() + settle
        while self._poll_slow_ping(0.0) is not None:
            if time.monotonic() >= deadline:
                self._log(f"round {round_i}: link_degrade window "
                          f"skipped — pre-existing slow links never "
                          f"settled in {settle:.1f}s")
                try:
                    self.cl.config_set("mon_warn_on_slow_ping_time",
                                       0.0, timeout=20 * self._load())
                except TimeoutError as e:
                    self._parked(
                        "config_set mon_warn_on_slow_ping_time", e)
                return
            time.sleep(0.3)
        self.c.link_degrade(a, b, delay_ms, jitter_ms, seed=self.seed)
        self.link_windows += 1
        self._log(f"round {round_i}: link_degrade window — "
                  f"osd.{a} -> osd.{b} +{delay_ms:.0f}ms "
                  f"(jitter {jitter_ms:.0f}ms, threshold {thr_ms:.0f}ms)")
        want = f"osd.{a} -> osd.{b} (hb)"
        try:
            fired = self._poll_slow_ping(budget)
            if fired is None:
                self._violate(
                    f"round {round_i}: OSD_SLOW_PING_TIME never fired "
                    f"within {budget:.1f}s of degrading "
                    f"osd.{a} -> osd.{b} by {delay_ms:.0f}ms")
            if not any(want in ln for ln in fired["detail"]):
                self._violate(
                    f"round {round_i}: OSD_SLOW_PING_TIME fired but "
                    f"named {fired['detail']!r}, not the degraded "
                    f"link {want!r}")
            strays = [ln for ln in fired["detail"] if want not in ln]
            if strays:
                self._violate(
                    f"round {round_i}: OSD_SLOW_PING_TIME named "
                    f"links beyond the degraded one: {strays!r}")
            self.link_health_flips += 1
            # the feed must shift helper selection: the sender now
            # prices b worst among live helpers, and the blend took
            # the hb-EWMA branch (counter-pinned)
            from types import SimpleNamespace
            costs = d._helper_costs(SimpleNamespace(acting=live))
            ranked = sorted((s for s, o in enumerate(live) if o != a),
                            key=lambda s: costs[s])
            if live[ranked[-1]] != b:
                self._violate(
                    f"round {round_i}: degraded helper osd.{b} not "
                    f"priced worst by osd.{a}'s feed "
                    f"(costs {dict(zip(live, (costs[s] for s in range(len(live)))))!r})")
            pen1 = d.perf.get("net_helper_penalties")
            if pen1 <= pen0:
                self._violate(
                    f"round {round_i}: net_helper_penalties never "
                    f"moved ({pen0} -> {pen1}) — the hb-RTT feed did "
                    f"not join the helper-cost blend")
            self.link_repriced += 1
            self._log(f"round {round_i}: link_degrade flip ok — "
                      f"named {want!r}, osd.{b} priced "
                      f"{costs[ranked[-1]]}us (next worst "
                      f"{costs[ranked[-2]]}us)")
        finally:
            self.c.heal_link_degrades()
        # clear: the ewma halves per undelayed ping (alpha 0.5), so a
        # couple of sweeps bring it under the threshold; budget the
        # same pipe slack plus a few extra pings
        clear_budget = budget + 4.0 * self._load()
        deadline = time.monotonic() + clear_budget
        cleared = False
        while time.monotonic() < deadline:
            if self._poll_slow_ping(0.0) is None:
                cleared = True
                break
            time.sleep(0.3)
        if not cleared:
            self._violate(
                f"round {round_i}: OSD_SLOW_PING_TIME failed to "
                f"clear within {clear_budget:.1f}s of healing "
                f"osd.{a} -> osd.{b}")
        self.link_health_clears += 1
        try:
            self.cl.config_set("mon_warn_on_slow_ping_time", 0.0,
                               timeout=20 * self._load())
        except TimeoutError as e:
            self._parked("config_set mon_warn_on_slow_ping_time", e)
        self._log(f"round {round_i}: link_degrade window ok — "
                  f"health cleared after heal")

    def _poll_slow_ping(self, budget_s: float) -> dict | None:
        """Poll `health detail` up to budget_s for OSD_SLOW_PING_TIME;
        the check dict if present, None if absent at deadline (a
        budget of 0 means one immediate look)."""
        deadline = time.monotonic() + budget_s
        while True:
            try:
                h = self.cl.health(detail=True)
            except Exception:   # noqa: BLE001 — mon hunt mid-chaos
                h = None
            if h is not None:
                fired = next((ck for ck in h.get("checks", [])
                              if ck["code"] == "OSD_SLOW_PING_TIME"),
                             None)
                if fired is not None:
                    return fired
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.2)

    # -- the schedule --------------------------------------------------------

    def _menu(self):
        acts = []
        for name, (weight, _desc) in KNOBS.items():
            acts.extend([getattr(self, f"act_{name}")] * weight)
        return acts

    def run(self) -> dict:
        """Execute rounds of (faults under I/O, heal, invariants).
        Returns the report dict; raises InvariantViolation (with the
        seed + reproducer in the message) on any violated invariant."""
        t0 = time.monotonic()
        if self.c is None:
            self.setup()
        try:
            menu = self._menu()
            for round_i in range(self.rounds):
                self.act_write()     # every round has data on the line
                self._transient_sweep(round_i)
                self._enospc_sweep(round_i)
                for _ in range(self.ops):
                    menu[self.rng.randrange(len(menu))]()
                    time.sleep(0.15)
                    self._tick_transients()
                if self.overwrite_during_faults:
                    self._overwrite_sweep_during_faults(round_i)
                if self.workload_profile:
                    self._workload_sweep_during_faults(round_i)
                if self.read_during_faults:
                    self._read_sweep_during_faults(round_i)
                self._heal_and_check(round_i)
                # r21: the capacity-exhaustion window runs against the
                # healed (clean) cluster so the only thing parking the
                # writer is the full ladder itself
                self._disk_full_window(round_i)
                # r22: likewise post-heal — the only slow link must be
                # the injected one, or exact-link naming can't hold
                self._link_degrade_window(round_i)
            report = self._final_report(time.monotonic() - t0)
        finally:
            self.teardown()
        if self.store == "tin":
            self._check_fsck(report)
        self._log(f"OK: {report['objects_verified']} objects verified "
                  f"across {self.rounds} rounds")
        return report

    # -- heal + invariants ---------------------------------------------------

    def _read_sweep_during_faults(self, round_i: int) -> None:
        """Invariant: DEGRADED READS NEVER BLOCK — with the round's
        faults still live (dead OSDs un-revived, dead monitors
        un-revived, injection running), every acked object must read
        back bit-exact through the degraded-read fast path. No heal,
        no wait_for_clean first: a read that can only succeed after
        convergence is exactly the tail this invariant forbids."""
        names = sorted(set(self.shadow) - self.unknown)
        for name in names:
            try:
                got = self.cl.read(name)
            except Exception as e:   # noqa: BLE001 — any failure here
                self._violate(       # means the read blocked on heal
                    f"round {round_i}: degraded read of acked "
                    f"{name!r} failed mid-faults ({type(e).__name__}: "
                    f"{e}) — reads must not wait for wait_for_clean")
            if got != self.shadow[name]:
                self._violate(f"round {round_i}: degraded read of "
                              f"{name!r} diverged from last acked "
                              f"bytes")
            self.degraded_read_checks += 1
        self._log(f"round {round_i}: degraded-read sweep ok "
                  f"({len(names)} objects, faults live)")

    def _overwrite_sweep_during_faults(self, round_i: int) -> None:
        """r16 invariant input: partial overwrites (write_at) WITH the
        round's faults still live — dead OSDs un-revived, injection
        running — so kills land mid-RMW and the stripe journal's
        replay has to hold the exactly-once/no-resurrection line.
        Draws come from the dedicated rmw stream and never read
        ack-dependent state, so a seed replays the identical sweep."""
        n = self.rmw_rng.randrange(2, 5)
        for _ in range(n):
            if not self._obj_i:
                return
            name = f"thrash-{self.seed}-" \
                   f"{self.rmw_rng.randrange(self._obj_i)}"
            off = self.rmw_rng.randrange(0, 700)
            patch = self.rmw_rng.randbytes(
                self.rmw_rng.randrange(8, 200))
            try:
                self.cl.write_at(name, off, patch)
            except (ConnectionError, OSError, RuntimeError,
                    KeyError) as e:
                self.unknown.add(name)
                self._parked(f"write_at {name}", e)
                continue
            if name in self.unknown:
                # base bytes unknowable: a patch over them proves
                # nothing either way — the object stays unclaimed
                continue
            old = self.shadow.get(name, b"")
            buf = bytearray(max(len(old), off + len(patch)))
            buf[:len(old)] = old
            buf[off:off + len(patch)] = patch
            self.shadow[name] = bytes(buf)
            self.removed.discard(name)
            self.rmw_overwrite_checks += 1
            self._log(f"round {round_i}: write_at {name} "
                      f"[{off},{off + len(patch)})")

    def _workload_sweep_during_faults(self, round_i: int) -> None:
        """r20 invariant input: a tenant-profile traffic burst WITH
        the round's faults still live — the workload engine's seeded
        stream generator drives reads, write_at patches, appends and
        full rewrites against thrash-owned objects, so fault windows
        see realistic mixed traffic, not just the menu's writes.
        Streams come from (profile, seed ^ round) alone — the
        dedicated-stream discipline: a seed replays the identical
        burst, and cells without --workload-profile are untouched."""
        from ..workload import OpStream
        from ..workload.profiles import BUILTIN_PROFILES, TenantProfile
        from ..workload.streams import payload_for
        spec = BUILTIN_PROFILES.get(self.workload_profile)
        if spec is None:
            import json as _json
            spec = _json.loads(self.workload_profile)
        p = TenantProfile.from_dict(spec)
        seed = self.seed ^ 0x301D ^ round_i
        # ~0.5 s of the profile's schedule, executed back-to-back (a
        # sweep, not a paced run); payload slices are seed-derived too
        ops = OpStream(p, seed).generate(0.5)
        payload = payload_for(p, seed)
        for op in ops:
            name = f"wl-{self.seed}-{p.name}-{op.obj}"
            try:
                if op.kind == "read":
                    if name not in self.shadow \
                            or name in self.unknown:
                        continue
                    got = self.cl.read(name)
                    if got != self.shadow[name]:
                        self._violate(
                            f"round {round_i}: workload read of "
                            f"{name!r} diverged from last acked "
                            f"bytes")
                elif op.kind == "write_at":
                    patch = payload[:op.size]
                    self.cl.write_at(name, op.offset, patch)
                    if name not in self.unknown:
                        old = self.shadow.get(name, b"")
                        buf = bytearray(max(len(old),
                                            op.offset + len(patch)))
                        buf[:len(old)] = old
                        buf[op.offset:op.offset + len(patch)] = patch
                        self.shadow[name] = bytes(buf)
                        self.removed.discard(name)
                elif op.kind == "append":
                    data = payload[:op.size]
                    self.cl.append(name, data)
                    if name not in self.unknown:
                        self.shadow[name] = \
                            self.shadow.get(name, b"") + data
                        self.removed.discard(name)
                else:       # write_full
                    data = payload[:p.object_size]
                    self.cl.write({name: data})
                    self.shadow[name] = data
                    self.removed.discard(name)
                    self.unknown.discard(name)
            except (ConnectionError, OSError, RuntimeError,
                    KeyError) as e:
                if op.kind != "read":
                    self.unknown.add(name)
                self._parked(f"workload {op.kind} {name}", e)
                continue
            self.workload_ops += 1
        self._log(f"round {round_i}: workload sweep "
                  f"[{p.name}] {self.workload_ops} ops total")

    def _heal_and_check(self, round_i: int) -> None:
        # r21: disarm any unfired ENOSPC faults first — heal-time
        # recovery writeback must not trip a fault that belonged to
        # the closed window
        self._clear_faults()
        # transient victims first: the heal waits their windows out so
        # outside-window draws exercise the expire->rebuild path
        self._tick_transients(final=True)
        for r in sorted(self.dead_mons):
            self.c.revive_mon(r)
        self.dead_mons.clear()
        for o in sorted(self.dead_osds):
            self.c.revive_osd(o)
        self.dead_osds.clear()
        if self.rotate_secrets:
            # deterministic per-round rotation (r15): every live
            # daemon — --osd-procs children via the control-pipe push
            # — refreshes its verifier; I/O must keep flowing through
            # the keep-window and clients re-fetch past it
            self.c.rotate_service_secrets("osd")
            self._log(f"round {round_i}: rotated osd service secrets")
        self._log(f"round {round_i}: healed; checking invariants")
        # invariant: CONVERGENCE — recovery + activation (up_thru)
        # must settle with injection still live (deadline scaled by
        # the host's load, not loosened: see load_factor)
        try:
            self.c.wait_for_clean(timeout=90 * self._load())
        except TimeoutError as e:
            self._violate(f"round {round_i}: cluster did not "
                          f"converge after heal ({e})")
        # invariant: EXACTLY-ONCE BYTES — every acked write reads back
        # the last acked value, byte-exact, through live injection
        for name in sorted(set(self.shadow) - self.unknown):
            try:
                got = self.cl.read(name)
            except Exception as e:   # noqa: BLE001 — any read failure
                self._violate(f"round {round_i}: acked object "
                              f"{name!r} unreadable ({e})")
            if got != self.shadow[name]:
                self._violate(f"round {round_i}: {name!r} bytes "
                              f"diverged from last acked write")
        # invariant: NO RESURRECTION — an acked remove stays removed
        # even after dead shards rejoined with stale copies
        for name in sorted(self.removed - self.unknown):
            try:
                self.cl.read(name)
            except KeyError:
                continue             # correctly gone
            except Exception as e:   # noqa: BLE001 — must be ENOENT,
                self._violate(       # not a transport wedge
                    f"round {round_i}: removed {name!r} read "
                    f"errored oddly ({e})")
            self._violate(f"round {round_i}: removed object "
                          f"{name!r} resurrected")
        # r17 policy invariants hold after every heal (transient mode
        # or not; counters are 0 when the policy never engaged)
        if not self.osd_procs:
            self._check_policy_invariants(round_i)

    def _final_report(self, elapsed: float) -> dict:
        return {
            "seed": self.seed,
            "store": self.store,
            "rounds": self.rounds,
            "objects_verified": len(set(self.shadow) - self.unknown),
            "removes_verified": len(self.removed - self.unknown),
            "unknown_fate": len(self.unknown),
            "degraded_read_checks": self.degraded_read_checks,
            "rmw_overwrite_checks": self.rmw_overwrite_checks,
            "workload_ops": self.workload_ops,
            "transient_kills": self.transient_kills,
            "transient_revives_inside": self.transient_revives_inside,
            "transient_noop_checks": self.transient_noop_checks,
            "transient_noop_skips": self.transient_noop_skips,
            "full_windows": self.full_windows,
            "full_reads_served": self.full_reads_served,
            "full_parked_drained": self.full_parked_drained,
            "enospc_injected": self.enospc_injected,
            "enospc_fired": self.enospc_fired,
            "link_windows": self.link_windows,
            "link_health_flips": self.link_health_flips,
            "link_health_clears": self.link_health_clears,
            "link_repriced": self.link_repriced,
            "writes_rejected_full":
                sum(d.perf.get("writes_rejected_full")
                    for d in self._live_daemons())
                if self.c is not None and not self.osd_procs else 0,
            "repair_deferred_stripes":
                self._policy_counter("repair_deferred_stripes")
                if self.c is not None and not self.osd_procs else 0,
            "repair_deferred_cancelled":
                self._policy_counter("repair_deferred_cancelled")
                if self.c is not None and not self.osd_procs else 0,
            "schedule_len": len(self.schedule),
            "elapsed_s": round(elapsed, 2),
            "repro": self.repro,
        }

    def _check_fsck(self, report: dict) -> None:
        """Invariant: FSCK-CLEAN REMOUNT — after the final shutdown
        (a crash, not a clean umount) every TinStore directory must
        audit clean offline. Orphan segments are crash artifacts the
        next mount reclaims, not corruption."""
        import os

        from ..osd.tinstore import TinStore
        checked = 0
        for osd in range(self.n_osds):
            path = os.path.join(self.c.store_dir, f"osd.{osd}")
            if not os.path.isdir(path):
                continue
            rep = TinStore.fsck(path)
            bad = (rep["errors"] or rep["extent_errors"]
                   or rep["bad_objects"])
            if bad:
                self._violate(f"fsck of {path} not clean: {bad}")
            checked += 1
        if not checked:
            self._violate("store=tin but no TinStore directories "
                          "found to fsck")
        report["fsck_clean_stores"] = checked
