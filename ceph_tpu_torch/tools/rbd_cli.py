"""rbd — block-image administration CLI, on the port.

Recreation of the reference's `rbd` command surface (ref:
src/tools/rbd/ — create/ls/info/rm/resize, snap create/ls/protect/
unprotect/rollback/rm, clone/flatten/children, export/import,
diff/export-diff) over the port's librbd-shaped layer
(`ceph_tpu_torch/client/rbd.py`) on a hermetic SimCluster whose state
persists across invocations via an objectstore export file — so the
CLI behaves statefully like the real tool. Twin of the JAX package's
tools/rbd_cli.py: the cluster lives on --device (default the CUDA
device), so writes run gf_apply (the 4 KiB and striper deltas its delta
instances); the state file holds only bytes, ints, lists and dicts, so
either package's tool reads the other's.

  python -m ceph_tpu_torch.tools.rbd_cli --state /tmp/rbd.img create vm1 --size 8M
  python -m ceph_tpu_torch.tools.rbd_cli --state /tmp/rbd.img snap create vm1@gold
  python -m ceph_tpu_torch.tools.rbd_cli --state /tmp/rbd.img snap protect vm1@gold
  python -m ceph_tpu_torch.tools.rbd_cli --state /tmp/rbd.img clone vm1@gold vm2
  python -m ceph_tpu_torch.tools.rbd_cli --state /tmp/rbd.img ls -l
  python -m ceph_tpu_torch.tools.rbd_cli --state /tmp/rbd.img import ./disk.raw vm3
  python -m ceph_tpu_torch.tools.rbd_cli --state /tmp/rbd.img export vm2 ./out.raw
  python -m ceph_tpu_torch.tools.rbd_cli --state /tmp/rbd.img diff vm2 --from-snap s1
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

from . import _device, add_device_flag, pool_profile


def parse_size(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    for suf, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30)):
        if s.endswith(suf):
            mult, s = m, s[:-1]
            break
    return int(float(s) * mult)


def split_at_snap(spec: str) -> tuple[str, str]:
    """'image@snap' -> (image, snap); errors without an @."""
    if "@" not in spec:
        raise SystemExit(f"rbd: expected image@snap, got {spec!r}")
    img, snap = spec.split("@", 1)
    return img, snap


class State:
    """The CLI's cluster-in-a-file: object payloads + pool snap state
    pickle-exported per invocation (the `rbd` tool's statefulness
    against a real cluster, without a daemon)."""

    def __init__(self, path: str | None, device):
        from ..client.rados import Rados
        from ..client.rbd import RBD
        from ..osd.cluster import SimCluster
        self.path = path
        self.cluster = SimCluster(n_osds=6, pg_num=4,
                                  profile=pool_profile(device),
                                  device=device)
        self.io = Rados(self.cluster).open_ioctx()
        self.rbd = RBD(self.io)
        if path and os.path.exists(path):
            with open(path, "rb") as f:
                snap = pickle.load(f)
            c = self.cluster
            self.io.rados  # keep import shape obvious
            for name, data in snap["objects"].items():
                c.write({name: data})
            c.snap_seq = snap["snap_seq"]
            c.sm_snaps = set(snap["sm_snaps"])
            c.selfmanaged = bool(snap["sm_snaps"]) or snap["selfmanaged"]
            c.snapsets = {k: [tuple(x) for x in v]
                          for k, v in snap["snapsets"].items()}
            c.object_births = dict(snap["births"])

    def save(self) -> None:
        if not self.path:
            return
        c = self.cluster
        objects = {}
        for ps in range(c.pg_num):
            for name in c.pgs[ps].list_pg_objects():
                objects[name] = bytes(c.pgs[ps].read_object(
                    name, dead_osds=set()))
        snap = {"objects": objects, "snap_seq": c.snap_seq,
                "sm_snaps": sorted(c.sm_snaps),
                "selfmanaged": c.selfmanaged,
                "snapsets": {k: [list(x) for x in v]
                             for k, v in c.snapsets.items()},
                "births": dict(c.object_births)}
        with open(self.path, "wb") as f:
            pickle.dump(snap, f)


def cmd_create(st: State, a) -> None:
    st.rbd.create(a.image, parse_size(a.size))
    print(f"created {a.image} ({parse_size(a.size)} bytes)")


def cmd_ls(st: State, a) -> None:
    from ..client.rbd import Image
    for name in st.rbd.list():
        if not a.long:
            print(name)
            continue
        img = Image(st.rbd, name)
        hdr = img._hdr()
        parent = hdr["parent"]
        extra = f" parent={parent['image']}@{parent['snap_name']}" \
            if parent else ""
        print(f"{name}\t{hdr['size']}\tsnaps={len(hdr['snaps'])}{extra}")


def cmd_info(st: State, a) -> None:
    from ..client.rbd import Image
    img = Image(st.rbd, a.image)
    hdr = img._hdr()
    out = {"name": a.image, "size": hdr["size"],
           "snaps": hdr["snaps"], "parent": hdr["parent"]}
    print(json.dumps(out, indent=1, sort_keys=True))


def cmd_rm(st: State, a) -> None:
    st.rbd.remove(a.image)
    print(f"removed {a.image}")


def cmd_resize(st: State, a) -> None:
    from ..client.rbd import Image
    Image(st.rbd, a.image).resize(parse_size(a.size))
    print(f"resized {a.image} -> {parse_size(a.size)}")


def cmd_snap(st: State, a) -> None:
    from ..client.rbd import Image
    if a.snap_op == "ls":
        img = Image(st.rbd, a.spec)
        for s in img.snap_list():
            prot = " (protected)" if s["protected"] else ""
            print(f"{s['id']}\t{s['name']}\t{s['size']}{prot}")
        return
    image, snap = split_at_snap(a.spec)
    img = Image(st.rbd, image)
    if a.snap_op == "create":
        sid = img.snap_create(snap)
        print(f"created {image}@{snap} (id {sid})")
    elif a.snap_op == "protect":
        img.snap_protect(snap)
        print(f"protected {image}@{snap}")
    elif a.snap_op == "unprotect":
        img.snap_unprotect(snap)
        print(f"unprotected {image}@{snap}")
    elif a.snap_op == "rollback":
        img.snap_rollback(snap)
        print(f"rolled back {image} to @{snap}")
    elif a.snap_op == "rm":
        img.snap_remove(snap)
        print(f"removed {image}@{snap}")


def cmd_clone(st: State, a) -> None:
    image, snap = split_at_snap(a.parent)
    st.rbd.clone(image, snap, a.child)
    print(f"cloned {image}@{snap} -> {a.child}")


def cmd_flatten(st: State, a) -> None:
    from ..client.rbd import Image
    Image(st.rbd, a.image).flatten()
    print(f"flattened {a.image}")


def cmd_children(st: State, a) -> None:
    image, snap = split_at_snap(a.spec)
    for c in st.rbd.list_children(image, snap):
        print(c)


def _ec_counter_totals(st: State) -> dict:
    """Scalar EC-backend counters summed over every PG — the
    amplification numerators (rmw_wire_bytes vs write_wire_bytes)
    the bench JSON reports deltas of."""
    tot: dict = {}
    for ps in range(st.cluster.pg_num):
        perf = getattr(st.cluster.pgs[ps], "perf", None)
        if perf is None:
            continue
        for k, v in perf.dump().items():
            if isinstance(v, (int, float)):
                tot[k] = tot.get(k, 0) + v
    return tot


def cmd_bench(st: State, a) -> None:
    """`rbd bench --io-type write|read` (ref: src/tools/rbd/action/
    Bench.cc): timed sequential or random I/O against the image
    through the full stack (librbd-shaped Image -> striper ->
    librados -> EC pool). Writes report an `amplification` block —
    EC wire-byte deltas over the timed loop — and
    `--full-stripe-writes` pins the pre-r16 read-merge-write_full
    baseline so the two paths are A/B-comparable on one workload."""
    import time

    import numpy as np
    from ..client.rbd import Image
    st.rbd.full_stripe_writes = bool(
        getattr(a, "full_stripe_writes", False))
    img = Image(st.rbd, a.image)
    size = img.size()
    io_size = parse_size(a.io_size)
    io_total = parse_size(a.io_total)
    if io_size <= 0 or io_total <= 0:
        raise SystemExit("rbd bench: io-size/io-total must be positive")
    if io_size > size:
        raise SystemExit(f"rbd bench: io-size {io_size} exceeds image "
                         f"size {size}")
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, io_size, np.uint8).tobytes()
    n_ios = max(1, io_total // io_size)
    offsets = (rng.integers(0, max(1, size - io_size), n_ios)
               if a.pattern == "rand"
               else np.arange(n_ios) * io_size % max(1, size - io_size + 1))
    if a.io_type == "read":
        # stage only the benched range (unwritten extents read back
        # as zeros anyway; full-image staging on a big image would
        # dwarf the timed loop)
        hi = int(max(offsets)) + io_size
        for off in range(0, min(hi, size), io_size):
            img.write(off, payload[:min(io_size, size - off)])
    # one untimed op per path: first-use costs (kernel builds, device
    # programs) land here, not in the measured window
    if a.io_type == "write":
        img.write(0, payload)
    else:
        img.read(0, io_size)
    ec0 = _ec_counter_totals(st)
    lat = []
    t_start = time.perf_counter()
    for off in offsets:
        t0 = time.perf_counter()
        if a.io_type == "write":
            img.write(int(off), payload)
        else:
            img.read(int(off), io_size)
        lat.append(time.perf_counter() - t0)
    dt = time.perf_counter() - t_start
    ec1 = _ec_counter_totals(st)
    arr = sorted(lat)
    pick = lambda q: arr[min(len(arr) - 1, int(q * len(arr)))]  # noqa: E731
    out = {"image": a.image, "io_type": a.io_type,
           "pattern": a.pattern, "io_size": io_size, "ios": len(lat),
           "seconds": round(dt, 3),
           "iops": round(len(lat) / dt, 1),
           "mb_per_s": round(len(lat) * io_size / dt / 1e6, 2),
           "p50_ms": round(pick(0.5) * 1e3, 3),
           "p99_ms": round(pick(0.99) * 1e3, 3)}
    if a.io_type == "write":
        d = {k: ec1.get(k, 0) - ec0.get(k, 0)
             for k in ("rmw_ops", "rmw_wire_bytes",
                       "rmw_preread_bytes", "rmw_append_fast",
                       "rmw_full_fallbacks", "write_wire_bytes")}
        wire = d["rmw_wire_bytes"] + d["write_wire_bytes"]
        logical = len(lat) * io_size
        out["amplification"] = {
            "full_stripe_writes": st.rbd.full_stripe_writes,
            **d,
            "wire_bytes_total": wire,
            "wire_bytes_per_op": round(wire / max(1, len(lat)), 1),
            "wire_per_logical": round(wire / max(1, logical), 3)}
    print(json.dumps(out, sort_keys=True))


def cmd_export(st: State, a) -> None:
    from ..client.rbd import Image
    img = Image(st.rbd, a.image)
    if a.snap:
        img.set_snap(a.snap)
    data = img.read(0, img.size())
    with open(a.dest, "wb") as f:
        f.write(data)
    print(f"exported {a.image}"
          + (f"@{a.snap}" if a.snap else "")
          + f" -> {a.dest} ({len(data)} bytes)")


def cmd_import(st: State, a) -> None:
    with open(a.src, "rb") as f:
        data = f.read()
    img = st.rbd.create(a.image, len(data))
    if data:
        img.write(0, data)
    print(f"imported {a.src} -> {a.image} ({len(data)} bytes)")


def cmd_export_diff(st: State, a) -> None:
    from ..client.rbd import Image
    img = Image(st.rbd, a.image)
    blob = img.export_diff(from_snap=a.from_snap)
    with open(a.dest, "wb") as f:
        f.write(blob)
    print(f"export-diff {a.image}"
          + (f" (from @{a.from_snap})" if a.from_snap else " (full)")
          + f" -> {a.dest} ({len(blob)} bytes)")


def cmd_import_diff(st: State, a) -> None:
    from ..client.rbd import Image
    with open(a.src, "rb") as f:
        blob = f.read()
    written = Image(st.rbd, a.image).import_diff(blob)
    print(f"import-diff {a.src} -> {a.image} ({written} bytes applied)")


def cmd_diff(st: State, a) -> None:
    from ..client.rbd import Image
    img = Image(st.rbd, a.image)
    runs = img.diff_iterate(from_snap=a.from_snap)
    for off, ln in runs:
        print(f"{off}\t{ln}")
    total = sum(ln for _, ln in runs)
    print(f"# {len(runs)} extent(s), {total} bytes", file=sys.stderr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="rbd", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--state", help="cluster state file (persists "
                    "images across invocations)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("create"); p.add_argument("image")
    p.add_argument("--size", required=True)
    p = sub.add_parser("ls"); p.add_argument("-l", "--long",
                                             action="store_true")
    p = sub.add_parser("info"); p.add_argument("image")
    p = sub.add_parser("rm"); p.add_argument("image")
    p = sub.add_parser("resize"); p.add_argument("image")
    p.add_argument("--size", required=True)
    p = sub.add_parser("snap")
    p.add_argument("snap_op", choices=["create", "ls", "protect",
                                       "unprotect", "rollback", "rm"])
    p.add_argument("spec", help="image@snap (image alone for ls)")
    p = sub.add_parser("clone"); p.add_argument("parent")
    p.add_argument("child")
    p = sub.add_parser("flatten"); p.add_argument("image")
    p = sub.add_parser("children"); p.add_argument("spec")
    p = sub.add_parser("bench"); p.add_argument("image")
    p.add_argument("--io-type", dest="io_type", default="write",
                   choices=["write", "read"])
    p.add_argument("--io-size", dest="io_size", default="64K")
    p.add_argument("--io-total", dest="io_total", default="4M")
    p.add_argument("--io-pattern", dest="pattern", default="seq",
                   choices=["seq", "rand"])
    p.add_argument("--full-stripe-writes", dest="full_stripe_writes",
                   action="store_true",
                   help="fall back to the read-merge-write_full "
                        "full-stripe path (the pre-r16 baseline the "
                        "amplification block compares against)")
    p = sub.add_parser("export"); p.add_argument("image")
    p.add_argument("dest"); p.add_argument("--snap")
    p = sub.add_parser("import"); p.add_argument("src")
    p.add_argument("image")
    p = sub.add_parser("diff"); p.add_argument("image")
    p.add_argument("--from-snap", dest="from_snap")
    p = sub.add_parser("export-diff"); p.add_argument("image")
    p.add_argument("dest"); p.add_argument("--from-snap",
                                           dest="from_snap")
    p = sub.add_parser("import-diff"); p.add_argument("src")
    p.add_argument("image")

    add_device_flag(ap)
    a = ap.parse_args(argv)
    st = State(a.state, _device(a))
    try:
        {"create": cmd_create, "ls": cmd_ls, "info": cmd_info,
         "rm": cmd_rm, "resize": cmd_resize, "snap": cmd_snap,
         "clone": cmd_clone, "flatten": cmd_flatten,
         "children": cmd_children, "bench": cmd_bench,
         "export": cmd_export,
         "import": cmd_import, "diff": cmd_diff,
         "export-diff": cmd_export_diff,
         "import-diff": cmd_import_diff}[a.cmd](st, a)
    except (KeyError, FileExistsError, FileNotFoundError,
            ValueError) as e:
        raise SystemExit(f"rbd: {type(e).__name__}: {e}")
    st.save()


if __name__ == "__main__":
    main()
