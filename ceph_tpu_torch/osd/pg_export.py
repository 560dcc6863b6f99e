"""PG export/import — offline checkpoint of a placement group.

Rebuild of the reference's disaster-recovery tool semantics (ref:
src/tools/ceph_objectstore_tool.cc — `--op export` walks a PG's
objects/attrs/log into a portable file, `--op import` replays it into
another OSD; SURVEY §5 checkpoint/resume names this as the offline
half of durability). Mapped onto this framework:

* export reads the PG's LOGICAL objects through the backend (so a
  degraded PG exports fine — reconstruction is the read path), plus
  the PG log bounds and per-object versions;
* import replays the objects through the target cluster's client
  write path, which re-places and re-encodes them under the TARGET
  pool's profile — an EC k=4,m=2 export imports cleanly into a
  replicated or k=8,m=3 cluster (the reference requires same-profile
  imports; re-encoding through the framework's own codec removes that
  restriction and is the TPU-native choice: bytes are the contract,
  not shard layout).

File format: utils.encoding versioned section (v1): pg id, pool
profile string, log head/tail, objects [(name, version, data)].
"""

from __future__ import annotations

import numpy as np

from ..utils.encoding import Decoder, Encoder

MAGIC = 0x70676578  # "pgex"


def export_pg(cluster, ps: int, path: str) -> dict:
    """Write one PG's logical state to `path`; returns a summary.
    Works on degraded PGs — reads reconstruct from survivors."""
    be = cluster.pgs[ps]
    dead = cluster._dead_osds()
    names = be.list_pg_objects()
    data = be.read_objects(names, dead_osds=dead) if names else {}
    e = Encoder()
    e.u32(MAGIC)
    e.start(1, 1)
    e.string(be.pg)
    e.string(str(cluster.profile))
    e.u64(be.pg_log.head).u64(be.pg_log.tail)
    e.u32(len(names))
    for n in names:
        e.string(n)
        e.u64(be.object_versions.get(n, 0))
        e.blob(np.asarray(data[n], np.uint8).tobytes())
    e.finish()
    blob = e.bytes()
    with open(path, "wb") as f:
        f.write(blob)
    return {"pg": be.pg, "objects": len(names),
            "bytes": sum(int(np.asarray(d).size)
                         for d in data.values()),
            "file_bytes": len(blob)}


def read_export(path: str) -> dict:
    with open(path, "rb") as f:
        d = Decoder(f.read())
    if d.u32() != MAGIC:
        raise ValueError(f"{path}: not a pg export")
    d.start(1)
    out = {"pg": d.string(), "profile": d.string(),
           "log_head": d.u64(), "log_tail": d.u64()}
    objs = {}
    for _ in range(d.u32()):
        name = d.string()
        _version = d.u64()
        objs[name] = np.frombuffer(d.blob(), dtype=np.uint8)
    d.finish()
    out["objects"] = objs
    return out


def import_objects(cluster, path: str,
                   overwrite: bool = False) -> dict:
    """Replay an export into `cluster` through its client write path
    (re-placed by ITS map, re-encoded by ITS pool profile). Refuses to
    clobber existing objects unless overwrite=True (the reference
    refuses to import over an existing PG)."""
    exp = read_export(path)
    if not overwrite:
        # placement is deterministic by name: an object can only live
        # in its located PG
        existing = [n for n in exp["objects"]
                    if n in cluster.pgs[
                        cluster.locate(n)].object_sizes]
        if existing:
            raise FileExistsError(
                f"{len(existing)} object(s) already exist "
                f"(e.g. {existing[0]!r}); pass overwrite=True")
    if exp["objects"]:
        cluster.write(exp["objects"])
    return {"pg": exp["pg"], "objects": len(exp["objects"]),
            "source_profile": exp["profile"]}
