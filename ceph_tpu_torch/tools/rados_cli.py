"""rados — object-level CLI (put/get/rm/ls/stat), on the port.

Recreation of the reference's `rados` tool object commands (ref:
src/tools/rados/rados.cc — put/get/rm/ls/stat against a pool through
librados; `rados bench` lives in tools/rados_bench.py). State rides a
pickle file between invocations like tools/rbd_cli.py: the CLI's
cluster-in-a-file, so put/get/rm/ls compose across calls.
Twin of the JAX package's tools/rados_cli.py: the SimCluster lives on
--device (default the CUDA device), so a put is one fused write
(gf_apply and CRC32C); the state file holds only bytes, so either
package's tool reads the other's.

  python -m ceph_tpu_torch.tools.rados_cli --state /tmp/s put obj1 ./payload.bin
  python -m ceph_tpu_torch.tools.rados_cli --state /tmp/s ls
  python -m ceph_tpu_torch.tools.rados_cli --state /tmp/s get obj1 -
  python -m ceph_tpu_torch.tools.rados_cli --state /tmp/s stat obj1
  python -m ceph_tpu_torch.tools.rados_cli --state /tmp/s rm obj1
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

from . import _device, add_device_flag, pool_profile


class State:
    def __init__(self, path: str | None, device):
        from ..client.rados import Rados
        from ..osd.cluster import SimCluster
        self.path = path
        self.cluster = SimCluster(n_osds=6, pg_num=4,
                                  profile=pool_profile(device),
                                  device=device)
        self.io = Rados(self.cluster).open_ioctx()
        if path and os.path.exists(path):
            with open(path, "rb") as f:
                objs = pickle.load(f)["objects"]
            if objs:
                self.cluster.write(objs)   # ONE batched restore

    def save(self) -> None:
        if not self.path:
            return
        c = self.cluster
        objects = {}
        for ps in range(c.pg_num):
            for name in c.pgs[ps].list_pg_objects():
                objects[name] = bytes(c.pgs[ps].read_object(
                    name, dead_osds=set()))
        with open(self.path, "wb") as f:
            pickle.dump({"objects": objects}, f)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--state", help="cluster state file (persists "
                                    "across invocations)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("put"); p.add_argument("obj")
    p.add_argument("src", help="input file, or - for stdin")
    p = sub.add_parser("get"); p.add_argument("obj")
    p.add_argument("dest", help="output file, or - for stdout")
    sub.add_parser("ls")
    p = sub.add_parser("stat"); p.add_argument("obj")
    p = sub.add_parser("rm"); p.add_argument("obj", nargs="+")
    add_device_flag(ap)
    a = ap.parse_args(argv)
    device = _device(a)

    st = State(a.state, device)
    io = st.io
    try:
        if a.cmd == "put":
            data = (sys.stdin.buffer.read() if a.src == "-"
                    else open(a.src, "rb").read())
            io.write_full(a.obj, data)
            st.save()
        elif a.cmd == "get":
            data = bytes(io.read(a.obj))
            if a.dest == "-":
                sys.stdout.buffer.write(data)
            else:
                with open(a.dest, "wb") as f:
                    f.write(data)
        elif a.cmd == "ls":
            for name in sorted(io.list_objects()):
                print(name)
        elif a.cmd == "stat":
            print(f"{a.obj} mtime n/a, size {io.stat(a.obj)}")
        elif a.cmd == "rm":
            for obj in a.obj:
                io.remove(obj)
            st.save()
    except KeyError as e:
        raise SystemExit(f"error: no such object {e}")


if __name__ == "__main__":
    main()
