"""Shared drivers of the client-tier parity tests (test_torch_rados,
test_torch_rbd, test_torch_fs, test_torch_rgw): one scripted sequence
runs through the JAX package's client stack over its SimCluster and
through the port's over SimCluster(device="cpu"), with the same
arguments and payloads from np.random.default_rng(seed). Every result
the sequence records (bytes, sizes, listings, snaps, notify replies,
exceptions by class name and message, the Objecter's counters) and, at
the end, every OSD's shard bytes, xattrs (hinfo) and omap, the object
class KV plane, the snap state and the OSDMap must be equal. Tolerance:
none."""

import copy
import importlib
import os
import types

import numpy as np
import torch

# RS k=4 m=2 and k=8 m=3 with a small chunk; 14 OSDs leave room to remap
# an 11-shard PG after an OSD goes out
PROFILES = {"k4m2": "plugin=tpu_rs k=4 m=2", "k8m3": "plugin=tpu_rs k=8 m=3"}
CLUSTER = dict(n_osds=14, pg_num=8, chunk_size=64, heartbeat_grace=20.0,
               down_out_interval=60.0)
COUNTERS = ("op_send", "op_resend", "map_refresh", "op_degraded")

_MODULES = {"cluster": "osd.cluster", "objecter": "client.objecter",
            "rados": "client.rados", "rbd": "client.rbd", "fs": "fs.client",
            "gateway": "rgw.gateway", "auth": "rgw.auth",
            "objclass": "osd.objclass"}


def stack(pkg: str) -> types.SimpleNamespace:
    """The client stack of one package ("ceph_tpu" or "ceph_tpu_torch")."""
    return types.SimpleNamespace(
        pkg=pkg, **{key: importlib.import_module(f"{pkg}.{mod}")
                    for key, mod in _MODULES.items()})


def new_cluster(S, profile: str, **kw):
    args = {**CLUSTER, "profile": profile, **kw}
    if S.pkg == "ceph_tpu_torch":
        args["device"] = "cpu"
    return S.cluster.SimCluster(**args)


def plain(x):
    """A result as plain comparable values; a torch tensor must never
    reach client code."""
    assert not isinstance(x, torch.Tensor), "a tensor leaked to the client"
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
        items = [plain(v) for v in x]
        return (type(x).__name__, sorted(items, key=repr)
                if isinstance(x, (set, frozenset)) else items)
    if isinstance(x, (bytes, bytearray, memoryview)):
        return ("bytes", bytes(x))
    if x is None or isinstance(x, (str, int, float)):
        return x
    return ("object", type(x).__name__)   # a handle (Image, FsFile, ...)


class Recorder:
    """Runs a sequence's steps and keeps what each returned or raised."""

    def __init__(self):
        self.log: list = []

    def __call__(self, label: str, fn, *args, **kw):
        try:
            out = fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 — every refusal is compared
            self.log.append((label, "raised", type(e).__name__, str(e)))
            return None
        self.log.append((label, plain(out)))
        return out

    def note(self, label: str, value) -> None:
        self.log.append((label, plain(value)))


def counters(rados) -> dict:
    perf = rados._objecter.perf
    return {key: perf.get(key) for key in COUNTERS}


def store_state(c) -> dict:
    out = {}
    for osd, st in sorted(c.cluster.stores.items()):
        out[(osd, "collections")] = st.list_collections()
        for cid in st.list_collections():
            for name in st.list_objects(cid):
                o = st.collections[cid][name]
                out[(osd, cid, name)] = (o.data.tobytes(),
                                         sorted(o.xattrs.items()),
                                         sorted(o.omap.items()))
    return out


def cluster_state(c) -> dict:
    return {"stores": store_state(c),
            "acting": [list(c.pgs[ps].acting) for ps in range(c.pg_num)],
            "osdmap": c.osdmap.encode(),
            "health": c.health(),
            "obj_kv": plain(c.obj_kv),
            "snaps": (c.snap_seq, dict(c.snaps), sorted(c.sm_snaps),
                      c.selfmanaged),
            "snapsets": plain(c.snapsets),
            "object_births": dict(c.object_births),
            "object_sizes": [dict(c.pgs[ps].object_sizes)
                             for ps in range(c.pg_num)]}


def assert_same_state(jc, tc) -> None:
    js, ts = cluster_state(jc), cluster_state(tc)
    for key in js:
        if key == "stores":
            assert sorted(ts[key]) == sorted(js[key]), "store objects"
            for obj in js[key]:
                assert ts[key][obj] == js[key][obj], obj
        else:
            assert ts[key] == js[key], key


def seeded_urandom(monkeypatch, seed: int):
    """Pin os.urandom (RGW upload ids, auth nonces and keys) to a seeded
    source; returns a function that restarts it, called before each
    package's run so that both draw the same bytes."""
    state = {}

    def restart():
        state["rng"] = np.random.default_rng(seed)
    restart()
    monkeypatch.setattr(os, "urandom", lambda n: state["rng"].bytes(n))
    return restart


def run_both(sequence, profile: str, restart=None, **cluster_kw):
    """Run `sequence(S, cluster, rec)` through the twin's stack and the
    port's; assert equal logs and equal final cluster state. Returns the
    port's log."""
    runs = []
    for pkg in ("ceph_tpu", "ceph_tpu_torch"):
        if restart is not None:
            restart()
        S = stack(pkg)
        c = new_cluster(S, profile, **cluster_kw)
        rec = Recorder()
        sequence(S, c, rec)
        runs.append((rec.log, c))
    (jlog, jc), (tlog, tc) = runs
    assert len(tlog) == len(jlog), (len(tlog), len(jlog))
    for j, t in zip(jlog, tlog):
        assert t == j, j[0]
    assert_same_state(jc, tc)
    return tlog


def payload(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def cluster_snapshot(c, **config) -> dict:
    """A plain snapshot of a settled EC SimCluster of either package, in
    the form ceph_tpu_torch.osd.cluster.cluster_from_snapshot takes;
    `config` adds the keyword arguments a cluster does not keep
    (osds_per_host, hosts_per_rack, n_mons)."""
    assert not c.backfills, "snapshot of a cluster with backfills in flight"
    stores = {}
    for osd, st in c.cluster.stores.items():
        colls = stores.setdefault(osd, {})
        for cid in st.list_collections():
            objs = colls.setdefault(cid, {})
            for name in st.list_objects(cid):
                o = st.collections[cid][name]
                objs[name] = {"data": o.data.copy(),
                              "attrs": dict(o.xattrs),
                              "omap": dict(o.omap)}
    pgs = {ps: {"acting": list(be.acting),
                "object_sizes": dict(be.object_sizes),
                "object_versions": dict(be.object_versions),
                "pg_log": be.pg_log.encode(),
                "shard_applied": dict(enumerate(be.shard_applied)),
                "rmw_seq": be._rmw_seq}
           for ps, be in c.pgs.items()}
    return {"config": dict(n_osds=len(c.alive), profile=c.profile,
                           pg_num=c.osdmap.pools[1].pg_num,
                           chunk_size=c.chunk_size,
                           heartbeat_interval=c.hb_interval,
                           heartbeat_grace=c.hb_grace,
                           down_out_interval=c.down_out_interval,
                           min_down_reporters=c.min_down_reporters,
                           **config),
            "osdmap": c.osdmap.encode(), "now": c.now,
            "alive": c.alive.copy(), "destroyed": sorted(c.destroyed),
            "last_heard": c.last_heard.copy(),
            "down_since": dict(c.down_since),
            "pg_changed_epoch": dict(c.pg_changed_epoch),
            "interval_start": dict(c.interval_start),
            "pg_primary": dict(c._pg_primary),
            "pgs": pgs, "stores": stores,
            "snap_seq": c.snap_seq, "snaps": dict(c.snaps),
            "sm_snaps": sorted(c.sm_snaps), "selfmanaged": c.selfmanaged,
            "snapsets": {n: [list(e) for e in ss]
                         for n, ss in c.snapsets.items()},
            "object_births": dict(c.object_births),
            "obj_kv": copy.deepcopy(c.obj_kv),
            "last_scrub": dict(c.last_scrub),
            "last_deep_scrub": dict(c.last_deep_scrub)}
