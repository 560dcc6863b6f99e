"""thrash — run one seeded Thrasher cell from the command line, on the port.

The failure reproducer for the chaos matrix (tests/test_thrash.py):
a failing cell prints `python tools/thrash.py --seed N --store S ...`
and THIS command replays the exact fault schedule (same RNG draws,
same injection periods, same victims, same data) with the invariant
checkers live — CI failure to local reproduction in one command (the
teuthology `--seed` rerun role, ref: qa/tasks/ceph_manager.py). Twin of
the JAX package's tools/thrash.py: the cluster's daemons run on
--device (default the CUDA device); a seed draws the twin's schedule.

  python -m ceph_tpu_torch.tools.thrash --seed 7 --store tin
  python -m ceph_tpu_torch.tools.thrash --seed 7 --store tin --repro
  python -m ceph_tpu_torch.tools.thrash --list-knobs
  python -m ceph_tpu_torch.tools.thrash --matrix 10      # seed sweep
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

from . import STANDALONE_PROFILE, _device, add_device_flag, pool_profile


def run_cell(seed: int, store: str, rounds: int, ops: int,
             verbose: bool, op_shards: int = 1,
             osd_procs: bool = False,
             rotate_secrets: bool = False,
             overwrite_during_faults: bool = False,
             transient_fraction: float = 0.0,
             n_osds: int | None = None,
             profile: str | None = None,
             workload_profile: str | None = None,
             disk_full: bool = False,
             link_degrade: bool = False,
             device=None) -> dict:
    from ..chaos import InvariantViolation, Thrasher
    if osd_procs:
        store = "tin"            # children need a real on-disk store
    tmp = tempfile.mkdtemp(prefix=f"thrash-{seed}-") \
        if store == "tin" else None
    kwargs = {}
    if transient_fraction:
        # transient cells default to a wide code (m=3) so single
        # losses keep >= 2 spare redundancy and really defer
        kwargs["transient_fraction"] = transient_fraction
        kwargs["n_osds"] = n_osds if n_osds is not None else 7
        kwargs["profile"] = profile or \
            "plugin=tpu_rs k=2 m=3 impl=bitlinear"
    elif n_osds is not None:
        kwargs["n_osds"] = n_osds
    from ..ec.interface import resolve_device
    kwargs["profile"] = pool_profile(
        resolve_device(device), kwargs.get("profile", STANDALONE_PROFILE))
    th = Thrasher(seed, store=store, rounds=rounds, ops=ops,
                  store_dir=tmp, verbose=verbose, op_shards=op_shards,
                  osd_procs=osd_procs, rotate_secrets=rotate_secrets,
                  overwrite_during_faults=overwrite_during_faults,
                  workload_profile=workload_profile,
                  disk_full=disk_full,
                  link_degrade=link_degrade,
                  device=device, **kwargs)
    try:
        report = th.run()
        report["ok"] = True
        return report
    except InvariantViolation as e:
        return {"ok": False, "seed": seed, "store": store,
                "violation": str(e), "repro": th.repro,
                "schedule": th.schedule}
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="seeded wire-tier fault thrasher (teuthology "
                    "Thrasher role); exit 0 iff every invariant held")
    ap.add_argument("--seed", type=int, default=1,
                    help="fault-schedule seed (logged by failing "
                         "tests; same seed = same schedule)")
    ap.add_argument("--store", choices=("mem", "tin"), default="mem")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ops", type=int, default=6,
                    help="fault/IO actions per round")
    ap.add_argument("--op-shards", type=int, default=1,
                    help="osd_op_num_shards on every OSD (r13 "
                         "sharded dispatch under chaos)")
    ap.add_argument("--osd-procs", action="store_true",
                    help="every OSD in its own OS process (r15 "
                         "control parity: rotation pushes + store "
                         "fsck cross the child control pipe); "
                         "implies --store tin")
    ap.add_argument("--rotate-secrets", action="store_true",
                    help="rotate the osd service secrets at every "
                         "round's heal (deterministic — outside the "
                         "seeded action menu, so seed replays are "
                         "unchanged)")
    ap.add_argument("--overwrite-during-faults", action="store_true",
                    help="r16: per-round partial-overwrite sweep "
                         "(write_at) with the faults still live — "
                         "SIGKILL lands mid-RMW and the stripe "
                         "journal must replay clean (drawn from a "
                         "dedicated seeded stream; pinned cells "
                         "replay unchanged)")
    ap.add_argument("--workload-profile", default=None,
                    help="r20: per-round tenant-traffic burst with "
                         "the faults still live — a builtin profile "
                         "name (interactive/streaming/bursty/noisy) "
                         "or inline profile JSON; streams come from "
                         "the workload engine's seeded generator "
                         "(dedicated stream, outside the action "
                         "menu: pinned cells replay unchanged)")
    ap.add_argument("--disk-full", action="store_true",
                    help="r21: per-round capacity-exhaustion window "
                         "(stores shrunk over the failsafe ratio, mon "
                         "ladder commits FULL, a background writer "
                         "must park with zero op_errors and drain "
                         "exactly-once after restore) plus one-shot "
                         "ENOSPC at a drawn store txn phase each "
                         "round (dedicated seeded stream; pinned "
                         "cells replay unchanged)")
    ap.add_argument("--link-degrade", action="store_true",
                    help="r22: per-round directed-link degrade window "
                         "against the healed cluster — a drawn one-way "
                         "delay on one sender->peer edge; "
                         "OSD_SLOW_PING_TIME must flip naming exactly "
                         "that link within two grace windows, the "
                         "sender's helper-cost feed must reprice the "
                         "peer worst (counter-pinned), and the check "
                         "must clear after heal (dedicated seeded "
                         "stream; pinned cells replay unchanged)")
    ap.add_argument("--transient-fraction", type=float, default=0.0,
                    help="r17: fraction of a dedicated seeded kill "
                         "stream whose victims AUTO-REVIVE inside/"
                         "outside the osd_repair_delay window — the "
                         "lazy-repair policy must cancel inside "
                         "revives with zero moved bytes (checked)")
    ap.add_argument("--matrix", type=int, metavar="N",
                    help="run seeds 1..N instead of one --seed")
    ap.add_argument("--repro", action="store_true",
                    help="replay mode: verbose schedule log on (use "
                         "with the --seed a failing test printed)")
    ap.add_argument("--list-knobs", action="store_true",
                    help="print the fault menu and exit")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = _device(args)

    if args.list_knobs:
        from ..chaos import KNOBS
        print("fault menu (name  weight  description):")
        for name, (weight, desc) in KNOBS.items():
            print(f"  {name:<16} {weight:>2}  {desc}")
        print("\ninvariants checked after every round's heal:\n"
              "  convergence, exactly-once bytes, no resurrection;\n"
              "  plus fsck-clean stores at teardown (--store tin)")
        return 0

    seeds = list(range(1, args.matrix + 1)) if args.matrix \
        else [args.seed]
    failed = 0
    for seed in seeds:
        rep = run_cell(seed, args.store, args.rounds, args.ops,
                       verbose=args.repro, op_shards=args.op_shards,
                       osd_procs=args.osd_procs,
                       rotate_secrets=args.rotate_secrets,
                       overwrite_during_faults=args.overwrite_during_faults,
                       transient_fraction=args.transient_fraction,
                       workload_profile=args.workload_profile,
                       disk_full=args.disk_full,
                       link_degrade=args.link_degrade,
                       device=device)
        print(json.dumps(rep, sort_keys=True))
        if not rep["ok"]:
            failed += 1
            print(f"REPRODUCE: {rep['repro']}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
