"""ceph-dencoder — wire-format encode/decode/round-trip checker, on the port.

Recreation of the reference's ceph-dencoder (ref: src/tools/
ceph-dencoder/ — `ceph-dencoder type <T> ... encode decode dump_json`,
used by qa to pin encoding compatibility): for each versioned wire
type this framework defines, build a representative instance, run
encode -> decode -> re-encode, demand byte equality (encode
determinism — the property upstream pins with corpus archives), and
dump a JSON view. Twin of the JAX package's tools/ceph_dencoder.py:
the instances are the twin's, built from the port's modules (an OSDMap
on --device, default the CUDA device), and their encodings are the
twin's byte for byte, so `roundtrip all` prints the twin's digests.

  python -m ceph_tpu_torch.tools.ceph_dencoder list
  python -m ceph_tpu_torch.tools.ceph_dencoder roundtrip OSDMap
  python -m ceph_tpu_torch.tools.ceph_dencoder roundtrip all
  python -m ceph_tpu_torch.tools.ceph_dencoder dump PGLog
"""

from __future__ import annotations

import argparse
import hashlib
import json

from ..crush.map import CrushMap, build_hierarchy, ec_rule
from ..msgr.messenger import _MSG_TYPES
from ..osd.memstore import Transaction
from ..osd.osdmap import OSDMap, PGPool
from ..osd.pglog import PGLog
from ..osd.standalone import MOSDFailure, MOSDOp
from ..osd.stripe import HashInfo
from ..osd.tinstore import _decode_txn, _encode_txn
from ..utils.encoding import Decoder, Encoder
from . import _device, add_device_flag


def _mk_crush(device=None):
    m = build_hierarchy(12, osds_per_host=2, hosts_per_rack=3)
    ec_rule(m, rule_id=1, choose_type=1)
    return m


def _mk_osdmap(device=None):
    m = OSDMap(_mk_crush(), device=device)
    m.add_pool(PGPool(1, pg_num=8, size=3, min_size=2, crush_rule=1,
                      is_erasure=True))
    m.mark_down(3)
    m.pg_temp[(1, 2)] = [4, 5, 6]
    m.pg_upmap_items[(1, 1)] = [(0, 7)]
    m.config_set("osd_max_backfills", "2")
    m.pool_mksnap(1, "s1")
    m.mon_join(3)
    m.osd_admin_out = {3, 7}     # v5 section
    return m


def _mk_pglog(device=None):
    log = PGLog(max_entries=4)
    for i in range(6):          # overflow: exercises tail advance
        log.append(f"obj{i}")
    return log


def _mk_hashinfo(device=None):
    return HashInfo(3, 4096, [0x1234, 0x5678, 0x9ABC])


def _mk_txn(device=None):
    return (Transaction()
            .create_collection("1.2s0")
            .write("1.2s0", "obj", 0, b"payload bytes")
            .setattr("1.2s0", "obj", "hinfo_key", b"\x01\x02")
            .omap_set("1.2s0", "obj", {b"k": b"v"})
            .omap_rmkeys("1.2s0", "obj", [b"dead"])
            .truncate("1.2s0", "obj", 8))


def _mk_message(device=None):
    return MOSDOp(42, True, "write", b"pg-op payload")


def _mk_failure(device=None):
    return MOSDFailure(5, alive=True)     # v2: the retraction flag


def _enc_message(o) -> bytes:
    e = Encoder()
    o.encode_payload(e)
    return o.type_id.to_bytes(2, "little") + e.bytes()


def _dec_message(b: bytes, device=None):
    tid = int.from_bytes(b[:2], "little")
    return _MSG_TYPES[tid].decode_payload(Decoder(b[2:]))


# each type: make(device) builds the instance, enc(obj) -> bytes,
# dec(bytes, device) -> obj, dump(obj) -> a JSON view
TYPES = {
    "CrushMap": {
        "make": _mk_crush,
        "enc": lambda o: o.encode(),
        "dec": lambda b, device=None: CrushMap.decode(b),
        "dump": lambda o: {"buckets": len(o.buckets),
                           "rules": sorted(o.rules),
                           "devices": o.n_devices},
    },
    "OSDMap": {
        "make": _mk_osdmap,
        "enc": lambda o: o.encode(),
        "dec": lambda b, device=None: OSDMap.decode(b, device=device),
        "dump": lambda o: {"epoch": o.epoch,
                           "pools": sorted(o.pools),
                           "mon_members": o.mon_members,
                           "config_kv": o.config_kv,
                           "pg_temp": {f"{k[0]}.{k[1]}": v
                                       for k, v in o.pg_temp.items()},
                           "snaps": o.pools[1].snaps},
    },
    "PGLog": {
        "make": _mk_pglog,
        "enc": lambda o: o.encode(),
        "dec": lambda b, device=None: PGLog.decode(b),
        "dump": lambda o: {"entries": len(o), "head": o.head,
                           "tail": o.tail},
    },
    "HashInfo": {
        "make": _mk_hashinfo,
        "enc": lambda o: o.to_bytes(),
        "dec": lambda b, device=None: HashInfo.from_bytes(b),
        "dump": lambda o: {"shards": o.n_shards,
                           "hashes": o.cumulative_shard_hashes,
                           "total_chunk_size": o.total_chunk_size},
    },
    "Transaction": {
        "make": _mk_txn,
        "enc": _encode_txn,
        "dec": lambda b, device=None: _decode_txn(b),
        "dump": lambda o: {"ops": [op[0] for op in o.ops]},
    },
    "Message": {
        # the typed-frame payload codec (transport framing adds
        # crc/len/seq around this)
        "make": _mk_message,
        "enc": _enc_message,
        "dec": _dec_message,
        "dump": lambda o: {"type_id": o.type_id, "kind": o.kind,
                           "req_id": o.req_id},
    },
    "MOSDFailure": {
        "make": _mk_failure,
        "enc": _enc_message,
        "dec": _dec_message,
        "dump": lambda o: {"type_id": o.type_id, "failed": o.failed,
                           "alive": o.alive},
    },
}


def roundtrip(name: str, device=None) -> bool:
    t = TYPES[name]
    obj = t["make"](device)
    b1 = t["enc"](obj)
    obj2 = t["dec"](b1, device)
    b2 = t["enc"](obj2)
    ok = b1 == b2
    digest = hashlib.sha256(b1).hexdigest()[:16]
    status = "OK " if ok else "FAIL"
    print(f"{status} {name}: {len(b1)} bytes, sha256 {digest}"
          + ("" if ok else "  ** re-encode differs! **"))
    return ok


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("cmd", nargs="?", default="list",
                    help="list | roundtrip | dump")
    ap.add_argument("name", nargs="?", default="all",
                    help="a type name, or all")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = _device(args)
    if args.cmd == "list":
        for name in TYPES:
            print(name)
        return
    cmd, name = args.cmd, args.name
    if name != "all" and name not in TYPES:
        raise SystemExit(f"dencoder: unknown type {name!r} "
                         f"(have: {', '.join(TYPES)})")
    if cmd == "roundtrip":
        names = list(TYPES) if name == "all" else [name]
        bad = [n for n in names if not roundtrip(n, device)]
        if bad:
            raise SystemExit(f"dencoder: round-trip failed: {bad}")
        return
    if cmd == "dump":
        if name == "all":
            raise SystemExit("dencoder: dump needs one type name")
        t = TYPES[name]
        obj = t["dec"](t["enc"](t["make"](device)), device)
        print(json.dumps(t["dump"](obj), indent=1, sort_keys=True,
                         default=str))
        return
    raise SystemExit(f"dencoder: unknown command {cmd!r}")


if __name__ == "__main__":
    main()
