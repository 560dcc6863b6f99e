"""ceph-objectstore-tool — offline PG export/import demo CLI, on the port.

Recreation of the reference's disaster-recovery workflow (ref:
src/tools/ceph_objectstore_tool.cc `--op export` / `--op import`;
SURVEY §5 checkpoint/resume). The cluster is hermetic, so the CLI
demonstrates the full round trip end to end. Twin of the JAX package's
tools/objectstore_tool.py: the clusters live on --device (default the
CUDA device), so the degraded reads rebuild through gf_apply; export
files and TinStore directories are the twin's formats, so either
package's tool reads what the other's wrote:

  python -m ceph_tpu_torch.tools.objectstore_tool demo --pg 0
      builds a cluster, writes objects, DEGRADES the PG (one OSD
      killed), exports it (reads reconstruct), imports the file into
      a FRESH cluster with a different pool profile, verifies bytes.

  python -m ceph_tpu_torch.tools.objectstore_tool inspect <export-file>
      prints an export file's header + object list.

KV-plane surface (the ceph-kvstore-tool role over a TinStore/TinDB
directory — offline, no daemon):

  python -m ceph_tpu_torch.tools.objectstore_tool kv-dump <store-dir>
      MANIFEST levels, per-segment entry counts, WAL chain state.
  python -m ceph_tpu_torch.tools.objectstore_tool kv-list <store-dir> [--prefix O]
      ordered key walk (key + value size) from a read-only snapshot.
  python -m ceph_tpu_torch.tools.objectstore_tool kv-compact <store-dir>
      flush + full leveled compaction down to one run.
  python -m ceph_tpu_torch.tools.objectstore_tool fsck <store-dir>
      full offline audit: KV seals/ordering/WAL chain + KV-vs-block
      cross-checks + every object's data crc.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from . import _device, add_device_flag, pool_profile


def cmd_demo(args, device) -> None:
    from ..osd.cluster import SimCluster
    from ..osd.pg_export import export_pg, import_objects

    src = SimCluster(n_osds=12, pg_num=4, profile=pool_profile(device),
                     device=device)
    rng = np.random.default_rng(0)
    objs = {f"obj-{i}": rng.integers(0, 256, 700, np.uint8)
            for i in range(24)}
    src.write(objs)
    ps = args.pg
    src.kill_osd(src.pgs[ps].acting[0])   # export must reconstruct
    path = args.file or os.path.join(tempfile.gettempdir(),
                                     f"pg1.{ps}.export")
    summary = export_pg(src, ps, path)
    print(f"exported degraded pg 1.{ps}: {summary['objects']} objects, "
          f"{summary['bytes']} bytes -> {path}")

    dst = SimCluster(n_osds=12, pg_num=8,
                     profile=pool_profile(
                         device, "plugin=tpu_rs k=8 m=3 impl=bitlinear"),
                     chunk_size=128, device=device)
    res = import_objects(dst, path)
    print(f"imported into fresh cluster (source profile "
          f"{res['source_profile']!r} -> k=8 m=3): "
          f"{res['objects']} objects")
    ok = sum(1 for n in objs
             if src.locate(n) == ps
             and bytes(dst.read(n)) == objs[n].tobytes())
    exported = summary["objects"]
    print(f"verified {ok}/{exported} objects byte-exact in the "
          f"destination")
    if ok != exported:
        raise SystemExit("objectstore_tool: verification FAILED")


def cmd_inspect(args) -> None:
    from ..osd.pg_export import read_export
    try:
        exp = read_export(args.file)
    except (ValueError, OSError) as e:
        raise SystemExit(f"objectstore_tool: {e}")
    print(f"pg {exp['pg']} profile {exp['profile']!r} "
          f"log [{exp['log_tail']}, {exp['log_head']}]")
    for n, d in sorted(exp["objects"].items()):
        print(f"  {n}  {len(d)} bytes")


def cmd_kv_dump(args) -> None:
    from ..kv import TinDB, TinDBCorruption
    try:
        man = TinDB._read_manifest(args.dir)
    except TinDBCorruption as e:
        raise SystemExit(f"objectstore_tool: {e}")
    if man is None:
        raise SystemExit(f"objectstore_tool: {args.dir}: no MANIFEST "
                         f"(not a KV store, or pre-KV legacy layout)")
    covered, next_seg, levels = man
    print(f"{args.dir}: covered_seq={covered} next_seg={next_seg}")
    from ..kv.tindb import Segment
    for i, lvl in enumerate(levels):
        print(f"  L{i}: {len(lvl)} segment(s)")
        for name in lvl:
            try:
                seg = Segment(os.path.join(args.dir, name))
                size = os.path.getsize(os.path.join(args.dir, name))
                print(f"    {name}  {seg.n_entries} entries  "
                      f"{size} bytes")
                seg.close()
            except (TinDBCorruption, OSError) as e:
                print(f"    {name}  UNREADABLE: {e}")
    rep = TinDB.fsck(args.dir)
    print(f"  WAL: {rep['wal_records']} record(s) past covered_seq"
          + (" (torn tail)" if rep["torn_tail"] else ""))
    for o in rep["orphans"]:
        print(f"  orphan segment: {o}")
    for e in rep["errors"]:
        print(f"  ERROR: {e}")
    if rep["errors"]:
        raise SystemExit(1)


def cmd_kv_list(args) -> None:
    from ..kv import TinDB, TinDBCorruption
    try:
        snap = TinDB.open_readonly(args.dir)
    except TinDBCorruption as e:
        raise SystemExit(f"objectstore_tool: {e}")
    prefixes = [args.prefix] if args.prefix else ["C", "O", "M", "S"]
    n = 0
    for pre in prefixes:
        for k, v in snap.iterate(pre):
            print(f"  {pre} {k!r}  {len(v)} bytes")
            n += 1
            if args.limit and n >= args.limit:
                print(f"  ... (stopped at --limit {args.limit})")
                return
    print(f"{n} key(s)")


def cmd_kv_compact(args) -> None:
    from ..kv import TinDB, TinDBCorruption
    try:
        db = TinDB(args.dir)
    except TinDBCorruption as e:
        raise SystemExit(f"objectstore_tool: {e}")
    before = db.segment_stats()
    db.compact()
    after = db.segment_stats()
    db.umount()
    print(f"compacted {args.dir}: {before['segments']} -> "
          f"{after['segments']} segment(s), "
          f"{after['entries']} live entries")


def cmd_fsck(args) -> None:
    import json
    from ..osd.tinstore import TinStore
    rep = TinStore.fsck(args.dir)
    print(json.dumps(rep, indent=1, default=str))
    bad = rep["errors"] or rep["extent_errors"] or rep["bad_objects"]
    if bad:
        raise SystemExit(1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    demo = sub.add_parser("demo")
    demo.add_argument("--pg", type=int, default=0)
    demo.add_argument("--file", default=None)
    insp = sub.add_parser("inspect")
    insp.add_argument("file")
    for name in ("kv-dump", "kv-list", "kv-compact", "fsck"):
        p = sub.add_parser(name)
        p.add_argument("dir")
        if name == "kv-list":
            p.add_argument("--prefix", default=None,
                           choices=["C", "O", "M", "S"])
            p.add_argument("--limit", type=int, default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = _device(args)
    if args.cmd == "demo":
        cmd_demo(args, device)
    elif args.cmd == "inspect":
        cmd_inspect(args)
    elif args.cmd == "kv-dump":
        cmd_kv_dump(args)
    elif args.cmd == "kv-list":
        cmd_kv_list(args)
    elif args.cmd == "kv-compact":
        cmd_kv_compact(args)
    else:
        cmd_fsck(args)


if __name__ == "__main__":
    main()
