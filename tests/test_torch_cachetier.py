"""The port's writeback cache tier (ceph_tpu_torch.osd.cachetier, a copy
of ceph_tpu.osd.cachetier) over the port's SimClusters, held to the
twin's over the twin's on the CPU.

Each of the twin's test_cachetier.py scenarios (writeback and flush,
re-dirtying, proxy reads and promotion, hit-set decay, the agent's
flush and eviction over its ratios, flush_evict_all, whiteouts) runs
through both packages: an RS k=4 m=2 base of 8 OSDs and a replicated
size=2 cache of 4, the port's on `device="cpu"`. Every read, every
KeyError, `stats()` and the dirty and cache bytes after each step, and
at the end every base and cache OSD's objects and xattrs, must be equal.
A flush is the base pool's batched write: one encode for the objects it
takes down.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.osd import cachetier as JC
from ceph_tpu.osd import cluster as J
from ceph_tpu_torch.osd import cachetier as TC
from ceph_tpu_torch.osd import cluster as T


def _blob(i, size=1000):
    return np.random.default_rng(i).integers(0, 256, size, np.uint8)


def _tier(pkg, **kw):
    cluster, cachetier, dev = pkg
    base = cluster.SimCluster(n_osds=8, pg_num=4, heartbeat_grace=20.0,
                              down_out_interval=60.0,
                              profile="plugin=tpu_rs k=4 m=2", **dev)
    cache = cluster.SimCluster(n_osds=4, pg_num=2, heartbeat_grace=20.0,
                               down_out_interval=60.0,
                               profile="replicated size=2", **dev)
    kw.setdefault("target_max_bytes", 64 * 1024)
    return cachetier.CacheTier(base, cache, **kw), base, cache


class _Log:
    """What a scenario saw: reads (bytes or the KeyError), the tier's
    stats and byte counters."""

    def __init__(self, tier):
        self.tier, self.seen = tier, []

    def read(self, fn, name):
        try:
            self.seen.append(("read", name,
                              np.asarray(fn(name), np.uint8).tobytes()))
        except KeyError:
            self.seen.append(("read", name, KeyError))

    def remove(self, name):
        try:
            self.tier.remove(name)
            self.seen.append(("remove", name, None))
        except KeyError:
            self.seen.append(("remove", name, KeyError))

    def note(self):
        self.seen.append(("stats", self.tier.stats(),
                          self.tier.dirty_bytes, self.tier.cache_bytes))


def writeback(tier, base, log):
    tier.write({"a": _blob(1)})
    log.read(tier.read, "a")
    log.read(base.read, "a")
    log.note()
    tier.flush()
    log.read(base.read, "a")
    log.read(tier.read, "a")
    log.note()


def redirty(tier, base, log):
    tier.write({"a": _blob(1)})
    tier.flush()
    tier.write({"a": _blob(2)})
    log.note()
    tier.flush()
    log.read(base.read, "a")


def promote(tier, base, log):
    base.write({"cold": _blob(3)})
    for _ in range(3):
        log.read(tier.read, "cold")
        log.note()
    log.read(tier.read, "nope")


def decay(tier, base, log):
    base.write({"x": _blob(4), "y": _blob(5), "z": _blob(6)})
    for _ in range(3):
        for name in "xyz":
            log.read(tier.read, name)
    log.note()


def agent_flush(tier, base, log):
    objs = {f"d{i}": _blob(10 + i) for i in range(8)}
    tier.write(objs)
    log.note()
    for name in sorted(objs):
        log.read(tier.read if name in tier._size else base.read, name)


def agent_evict(tier, base, log):
    tier.write({f"e{i}": _blob(20 + i) for i in range(8)})
    log.note()
    for i in range(8):
        log.read(tier.read, f"e{i}")
    log.note()


def flush_evict_all(tier, base, log):
    tier.write({f"f{i}": _blob(30 + i) for i in range(4)})
    tier.flush_evict_all()
    log.note()
    for i in range(4):
        log.read(base.read, f"f{i}")


def whiteout_dirty(tier, base, log):
    tier.write({"w": _blob(7)})
    tier.flush()
    tier.write({"w": _blob(8)})
    log.remove("w")
    log.read(tier.read, "w")
    log.read(base.read, "w")
    tier.flush()
    log.read(base.read, "w")
    log.read(tier.read, "w")
    log.note()


def whiteout_cache_only(tier, base, log):
    tier.write({"c": _blob(9)})
    log.remove("c")
    log.read(tier.read, "c")
    tier.flush()
    log.read(base.read, "c")
    log.remove("ghost")
    log.note()


def rewrite_after_whiteout(tier, base, log):
    tier.write({"r": _blob(11)})
    tier.flush()
    log.remove("r")
    tier.write({"r": _blob(12)})
    log.read(tier.read, "r")
    tier.flush()
    log.read(base.read, "r")
    log.note()


# (scenario, CacheTier keywords): the twin's test_cachetier.py cases
SCENARIOS = [
    (writeback, {}), (redirty, {}),
    (promote, {"promote_after_hits": 2}),
    (decay, {"promote_after_hits": 2, "hit_set_period": 2}),
    (agent_flush, {"target_max_bytes": 8000, "dirty_ratio": 0.4,
                   "full_ratio": 1.0}),
    (agent_evict, {"target_max_bytes": 8000, "dirty_ratio": 0.1,
                   "full_ratio": 0.5}),
    (flush_evict_all, {}), (whiteout_dirty, {}), (whiteout_cache_only, {}),
    (rewrite_after_whiteout, {})]


def _stores(c):
    return {(osd, cid, name): (st.read(cid, name).tobytes(),
                               sorted(st.collections[cid][name].xattrs
                                      .items()))
            for osd, st in sorted(c.cluster.stores.items())
            for cid in st.list_collections()
            for name in st.list_objects(cid)}


def _run(pkg, scenario, kw):
    tier, base, cache = _tier(pkg, **kw)
    log = _Log(tier)
    scenario(tier, base, log)
    return log.seen, _stores(base), _stores(cache)


@pytest.mark.parametrize("scenario,kw", SCENARIOS,
                         ids=[s.__name__ for s, _ in SCENARIOS])
def test_scenario_matches_twin(scenario, kw):
    twin = _run((J, JC, {}), scenario, kw)
    port = _run((T, TC, {"device": "cpu"}), scenario, kw)
    assert port[0] == twin[0]
    assert port[1] == twin[1]          # the base pool's stores
    assert port[2] == twin[2]          # the cache pool's
    assert any(kind == "stats" for kind, *_ in port[0])


def test_the_agents_flush_is_one_batched_base_write(monkeypatch):
    tier, base, _ = _tier((T, TC, {"device": "cpu"}),
                          target_max_bytes=8000, dirty_ratio=0.4,
                          full_ratio=1.0)
    writes = []
    real = base.write

    def counted(objects):
        writes.append(sorted(objects))
        return real(objects)
    monkeypatch.setattr(base, "write", counted)
    tier.write({f"d{i}": _blob(10 + i) for i in range(8)})
    assert len(writes) == 1 and len(writes[0]) == tier.stats()["tier_flush"]
    assert tier.dirty_bytes <= 3200
    assert base.device == torch.device("cpu")
