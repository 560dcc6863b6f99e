"""osdmaptool — offline OSDMap file operations, on the port.

Recreation of the reference's map tool (ref: src/tools/osdmaptool.cc —
`osdmaptool <file> --print`, `--test-map-pgs [--pool N]` (PG->OSD
distribution statistics), `--upmap <out>` (compute pg_upmap_items via
OSDMap::calc_pg_upmaps and write the commands), `--createsimple N`).
Twin of the JAX package's tools/osdmaptool.py: the map's placement runs
on --device (default the CUDA device), and `--upmap-mode batch` runs
mgr/placement.py's scorer kernel there; map and upmap files are the
twin's, byte for byte.

  python -m ceph_tpu_torch.tools.osdmaptool --createsimple 64 \
      --pool-pgs 256 map.bin
  python -m ceph_tpu_torch.tools.osdmaptool map.bin --print
  python -m ceph_tpu_torch.tools.osdmaptool map.bin --test-map-pgs
  python -m ceph_tpu_torch.tools.osdmaptool map.bin --upmap out.txt --save
"""

from __future__ import annotations

import argparse

import numpy as np

from . import _device, add_device_flag


def load(path: str, device):
    from ..osd.osdmap import OSDMap
    from ..utils.encoding import EncodingError
    with open(path, "rb") as f:
        try:
            return OSDMap.decode(f.read(), device=device)
        except (EncodingError, ValueError) as e:
            raise SystemExit(f"osdmaptool: {path}: not an osdmap ({e})")


def cmd_createsimple(args, device) -> None:
    from ..crush.map import build_hierarchy, ec_rule, replicated_rule
    from ..osd.osdmap import OSDMap, PGPool
    n = args.createsimple
    m = build_hierarchy(n, osds_per_host=args.osds_per_host,
                        hosts_per_rack=args.hosts_per_rack)
    replicated_rule(m, 0, choose_type=1, firstn=True)
    ec_rule(m, 1, choose_type=1)
    om = OSDMap(m, device=device)
    om.add_pool(PGPool(1, pg_num=args.pool_pgs, size=args.pool_size,
                       min_size=args.pool_size - args.pool_size // 2,
                       crush_rule=0))
    with open(args.mapfile, "wb") as f:
        f.write(om.encode())
    print(f"osdmaptool: writing epoch {om.epoch} to {args.mapfile}")


def cmd_print(om) -> None:
    print(f"epoch {om.epoch}")
    up = int(om.osd_up.sum())
    n = len(om.osd_up)
    print(f"max_osd {n} ({up} up, "
          f"{int((om.osd_weight > 0).sum())} in)")
    for pid in sorted(om.pools):
        p = om.pools[pid]
        kind = "erasure" if p.is_erasure else "replicated"
        print(f"pool {pid} '{kind}' size {p.size} min_size "
              f"{p.min_size} pg_num {p.pg_num} crush_rule "
              f"{p.crush_rule}")
    for pg, items in sorted(om.pg_upmap_items.items()):
        pairs = " ".join(f"{f}->{t}" for f, t in items)
        print(f"pg_upmap_items {pg[0]}.{pg[1]} [{pairs}]")
    for pg, acting in sorted(om.pg_temp.items()):
        print(f"pg_temp {pg[0]}.{pg[1]} {acting}")


def cmd_test_map_pgs(om, pool_id: int) -> None:
    from ..crush.map import CRUSH_ITEM_NONE
    if pool_id not in om.pools:
        raise SystemExit(f"osdmaptool: no pool {pool_id}")
    up = np.asarray(om.pgs_to_up(pool_id))
    flat = up[up != CRUSH_ITEM_NONE]
    counts = np.bincount(flat, minlength=len(om.osd_up))
    in_mask = np.asarray(om.osd_weight) > 0
    sub = counts[in_mask]
    pool = om.pools[pool_id]
    print(f"pool {pool_id} pg_num {pool.pg_num}")
    print(f"#osd\tcount\tfirst\tprimary\tc wt\twt")
    primaries = np.bincount(up[:, 0][up[:, 0] != CRUSH_ITEM_NONE],
                            minlength=len(om.osd_up))
    for o in np.nonzero(in_mask)[0]:
        w = om.osd_weight[o] / 0x10000
        print(f"osd.{o}\t{counts[o]}\t{primaries[o]}\t{primaries[o]}"
              f"\t{w:.4f}\t{w:.4f}")
    print(f" avg {sub.mean():.2f} stddev {sub.std():.2f} "
          f"min {sub.min()} max {sub.max()}")
    print(f" size {pool.size}: fill "
          f"{(up != CRUSH_ITEM_NONE).mean():.4f}")


def cmd_upmap(om, args) -> None:
    from ..mgr.balancer import calc_pg_upmaps, device_load
    pool_id = args.pool
    if pool_id not in om.pools:
        raise SystemExit(f"osdmaptool: no pool {pool_id}")
    before = device_load(om, pool_id)
    if args.upmap_mode == "batch":
        from ..mgr.placement import batch_calc_pg_upmaps
        res = batch_calc_pg_upmaps(
            om, pool_id, max_deviation=args.upmap_deviation,
            max_movement=(args.upmap_budget
                          if args.upmap_budget is not None
                          else args.upmap_max))
        moves = res.moves
        print(f"osdmaptool: batch balancer: {res.rounds} round(s), "
              f"{res.candidates_scored} candidates scored "
              f"({res.candidates_per_s:,.0f}/s), max deviation "
              f"{res.max_dev_before:.1f} -> {res.max_dev_after:.1f}, "
              f"converged={res.converged}")
    else:
        moves = calc_pg_upmaps(om, pool_id,
                               max_deviation=args.upmap_deviation,
                               max_optimizations=args.upmap_max)
    after = device_load(om, pool_id)
    # one command per PG from the map's FINAL upmap state: the real
    # `ceph osd pg-upmap-items` REPLACES a PG's whole item list, so
    # per-move lines would lose earlier redirects on replay when a PG
    # was optimized in more than one round
    touched = {pg for pg, _ in moves}
    with open(args.upmap, "w") as f:
        for pid, ps in sorted(touched):
            pairs = om.pg_upmap_items.get((pid, ps), [])
            flat = " ".join(f"{frm} {to}" for frm, to in pairs)
            f.write(f"ceph osd pg-upmap-items {pid}.{ps} {flat}\n")
    in_mask = np.asarray(om.osd_weight) > 0
    print(f"osdmaptool: {len(moves)} upmap move(s) -> {args.upmap}; "
          f"spread {int(before[in_mask].max() - before[in_mask].min())}"
          f" -> {int(after[in_mask].max() - after[in_mask].min())}")
    if args.save:
        with open(args.mapfile, "wb") as f:
            f.write(om.encode())
        print(f"osdmaptool: writing epoch {om.epoch} to "
              f"{args.mapfile}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mapfile")
    ap.add_argument("--createsimple", type=int, metavar="N_OSDS")
    ap.add_argument("--osds-per-host", type=int, default=4)
    ap.add_argument("--hosts-per-rack", type=int, default=4)
    ap.add_argument("--pool-pgs", type=int, default=128)
    ap.add_argument("--pool-size", type=int, default=3)
    ap.add_argument("--print", dest="do_print", action="store_true")
    ap.add_argument("--test-map-pgs", action="store_true")
    ap.add_argument("--pool", type=int, default=1)
    ap.add_argument("--upmap", metavar="OUT",
                    help="compute balancer upmaps; write commands here")
    ap.add_argument("--upmap-deviation", type=int, default=1)
    ap.add_argument("--upmap-max", type=int, default=100,
                    help="cap on upmap moves (both modes)")
    ap.add_argument("--upmap-mode", choices=("batch", "scalar"),
                    default="batch",
                    help="batch = device-batched balancer (one "
                    "vectorized CRUSH launch, r12); scalar = the "
                    "per-PG oracle")
    ap.add_argument("--upmap-budget", type=int, default=None,
                    help="batch mode data-movement budget in PG "
                    "shards (default: --upmap-max)")
    ap.add_argument("--save", action="store_true",
                    help="write the modified map back to mapfile")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = _device(args)

    if args.createsimple:
        cmd_createsimple(args, device)
        return
    om = load(args.mapfile, device)
    did = False
    if args.do_print:
        cmd_print(om)
        did = True
    if args.test_map_pgs:
        cmd_test_map_pgs(om, args.pool)
        did = True
    if args.upmap:
        cmd_upmap(om, args)
        did = True
    if not did:
        raise SystemExit("osdmaptool: nothing to do (--print / "
                         "--test-map-pgs / --upmap / --createsimple)")


if __name__ == "__main__":
    main()
