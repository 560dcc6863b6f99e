"""The port's SimCluster (ceph_tpu_torch.osd.cluster) held against its
twin (ceph_tpu.osd.cluster) on the CPU through one seeded scenario:
write; kill an OSD until the map marks it down; destroy it and tick
past down_out_interval, so that it goes out, CRUSH remaps and
recover_shards rebuilds onto the new acting sets; kill another, write
while it is down and revive it before it goes out (the PG-log replay);
repair a rotten shard. After every step both clusters must agree on
the acting sets, pg states, health(), the perf counters, the OSDMap's
bytes and every OSD store's collections, object bytes and xattrs.
For an EC pool and a replicated one, over MemStores and over persistent
TinStores (kill drops an OSD's RAM state, revive remounts it from its
WAL), and once with zlib-compressed TinStores. Tolerance: none."""

import numpy as np
import pytest
import torch

from ceph_tpu.osd import cluster as J
from ceph_tpu_torch.osd import cluster as T

PROFILES = {"ec": "plugin=tpu_rs k=4 m=2",
            "replicated": "replicated size=3"}
SIZES = (700, 1500, 2048)   # few shard lengths: the twin compiles per length


def _stores(c):
    out = {}
    for osd, st in sorted(c.cluster.stores.items()):
        if st.is_down:              # a killed TinStore holds no RAM state
            out[(osd, "down")] = True
            continue
        if hasattr(st, "compress_stats"):
            out[(osd, "compress_stats")] = dict(st.compress_stats)
        for cid in st.list_collections():
            for name in st.list_objects(cid):
                o = st.collections[cid][name]
                out[(osd, cid, name)] = (o.data.tobytes(),
                                         sorted(o.xattrs.items()),
                                         sorted(o.omap.items()))
        out[(osd, "collections")] = st.list_collections()
    return out


def _state(c):
    return {"acting": [list(c.pgs[ps].acting) for ps in range(c.pg_num)],
            "health": c.health(),
            "perf": c.perf.dump(),
            "osdmap": c.osdmap.encode(),
            "alive": c.alive.tolist(),
            "down_since": dict(c.down_since),
            "backfills": sorted(c.backfills),
            "stores": _stores(c)}


def _same(jc, tc):
    js, ts = _state(jc), _state(tc)
    for key in js:
        assert ts[key] == js[key], key


def _both(jc, tc, fn):
    a, b = fn(jc), fn(tc)
    assert b == a
    return b


def _objects(rng, n, tag):
    return {f"{tag}{i}": rng.integers(0, 256, SIZES[i % len(SIZES)],
                                      dtype=np.uint8) for i in range(n)}


def _rot(st, cid, name):
    """Flip one stored byte of a shard (or replica) behind the store's
    back: on a TinStore, in its block device file."""
    if hasattr(st, "compress_stats"):
        data = st.collections[cid][name].data     # a map of the device
        data[3] ^= 0xFF
        data.flush()
    else:
        data = st.read(cid, name).copy()
        data[3] ^= 0xFF
        st.collections[cid][name].data = data


@pytest.mark.parametrize("pool,store,compression", [
    ("ec", "mem", None), ("replicated", "mem", None), ("ec", "tin", None),
    ("replicated", "tin", None), ("ec", "tin", "zlib")],
    ids=["ec", "replicated", "ec-tin", "replicated-tin", "ec-tin-zlib"])
def test_failure_remap_recovery_matches_twin(pool, store, compression,
                                             tmp_path):
    kw = dict(n_osds=12, pg_num=8, profile=PROFILES[pool], chunk_size=256,
              store=store, store_compression=compression)
    if store == "tin":
        jc = J.SimCluster(**kw, store_dir=str(tmp_path / "twin"))
        tc = T.SimCluster(**kw, store_dir=str(tmp_path / "port"),
                          device="cpu")
    else:
        jc, tc = J.SimCluster(**kw), T.SimCluster(**kw, device="cpu")
    assert tc.device == torch.device("cpu")
    assert tc.pgs[0].device == torch.device("cpu")
    assert tc.osdmap.device == torch.device("cpu")
    _same(jc, tc)
    rng = np.random.default_rng(2026)
    objs = _objects(rng, 40, "o")
    if compression:   # a seeded block repeated: blobs that compress
        objs.update({f"z{i}": np.tile(rng.integers(0, 256, 100, np.uint8),
                                      20) for i in range(6)})
    _both(jc, tc, lambda c: c.write(objs))
    _same(jc, tc)
    if compression:
        stats = [st.compress_stats for st in tc.cluster.stores.values()]
        assert sum(s["compressed_blobs"] for s in stats) > 0
        assert sum(s["stored_bytes"] for s in stats) < \
            sum(s["logical_bytes"] for s in stats)

    # kill -> heartbeats go silent -> the monitors mark it down
    a = tc.pgs[0].acting[0]
    _both(jc, tc, lambda c: (c.kill_osd(a), c.tick(30)))
    _same(jc, tc)
    assert not tc.osdmap.osd_up[a]
    assert tc.verify_all(objs) == len(objs)       # degraded reads
    assert tc.health()["pgs_degraded"] > 0

    # disk lost -> out after down_out_interval -> remap -> recover
    _both(jc, tc, lambda c: (c.destroy_osd(a), c.tick(tc.down_out_interval)))
    _same(jc, tc)
    assert tc.osdmap.osd_weight[a] == 0
    assert all(a not in be.acting for be in tc.pgs.values())
    assert tc.perf.get("recovered_objects") > 0
    assert tc.health()["pgs_degraded"] == 0
    assert tc.verify_all(objs) == len(objs)

    # kill, write while down, revive before out: PG-log replay
    b = tc.pgs[1].acting[1]
    _both(jc, tc, lambda c: (c.kill_osd(b), c.tick(30)))
    more = _objects(rng, 12, "n")
    objs.update(more)
    _both(jc, tc, lambda c: c.write(more))
    _same(jc, tc)
    _both(jc, tc, lambda c: (c.revive_osd(b), c.tick(6)))
    _same(jc, tc)
    assert tc.perf.get("log_replayed_objects") > 0
    assert tc.verify_all(objs) == len(objs)
    _both(jc, tc, lambda c: c.verify_all(objs))

    # a rotten shard (or replica), found and rewritten by repair_pg
    name = sorted(n for n in objs if tc.locate(n) == 2)[0]
    for c in (jc, tc):
        be = c.pgs[2]
        _rot(c.cluster.osd(be.acting[1]), f"{be.pg}s1", name)
    rep = _both(jc, tc, lambda c: c.repair_pg(2))
    assert rep["repaired"] == 1
    _same(jc, tc)
    assert tc.verify_all(objs) == len(objs)


def test_refusals():
    with pytest.raises(ValueError, match="store_compression requires"):
        T.SimCluster(store_compression="zlib", device="cpu")
    with pytest.raises(ValueError, match="store_compression"):
        T.SimCluster(store_compression="zstd", device="cpu")
    with pytest.raises(ValueError, match="unknown store_compression"):
        T.SimCluster(store="tin", store_compression="zstd", device="cpu")
    with pytest.raises(ValueError, match="store="):
        T.SimCluster(store="disk", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.SimCluster()
    # StaleMap is the port's own class, raised by the port's client path
    c = T.SimCluster(device="cpu")
    primary = c.osdmap.pg_to_up_acting_osds(1, 0)[3]
    with pytest.raises(T.StaleMap):
        c.client_rpc(primary + 1 if primary == 0 else primary - 1,
                     c.osdmap.epoch, "read", 0, [])
