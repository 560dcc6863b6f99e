"""Recovery staged from remote stores: the port's RecoveryRunner._stage
held to its twin's (ceph_tpu.osd.ecbackend) on the CPU.

Each store of both packages is wrapped in a fake remote store that
offers `readv_submit` / `readv_ranges_submit`, whose handles' `.result()`
return what the wire tier's frames carry (osd/standalone.py's `_ReadvOp`
and `_ReadvRangesOp`): the rows as bytes, and the hinfo attrs, or the
range CRCs and the rows that failed their hinfo at the source. The same
numpy-seeded objects go through both packages; the staged stack, `exp`
and `pre_bad`, the frames submitted, and the rebuilt shards and their
hinfo CRCs must be equal. Tolerance: none, every comparison is exact.
"""

import numpy as np
import pytest

from ceph_tpu.osd import ecbackend as J
from ceph_tpu_torch.osd import ecbackend as T

RS = "plugin=jerasure technique=reed_sol_van k=4 m=2"
CLAY = "plugin=clay k=4 m=2 d=5"
# (id, profile, chunk size, object size, lost slot): a full-row RS plan
# and a Clay single-loss plan, which ships only its repair planes
GEOMS = [("rs-full-rows", RS, 256, 900, 1),
         ("clay-ranges", CLAY, 1024, 9000, 0)]
PG = "1.0"


class _Handle:
    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


class RemoteFake:
    """A store seen over the wire: reads and attrs pass through to the
    local store, and readv / readv_ranges come back as frame payloads
    served by the package's own source half."""

    def __init__(self, mod, store, log):
        self._mod, self._st, self._log = mod, store, log

    def __getattr__(self, name):
        return getattr(self._st, name)

    def readv_submit(self, cid, oids, length, attr_key=None):
        self._log.append(("readv", cid, tuple(oids)))
        rows = [self._st.read(cid, n) for n in oids]
        assert all(len(r) == length for r in rows)
        attrs = ([self._st.getattr(cid, n, attr_key) for n in oids]
                 if attr_key else None)
        return _Handle((b"".join(r.tobytes() for r in rows), attrs))

    def readv_ranges_submit(self, cid, oids, length, ranges,
                            attr_key=None):
        self._log.append(("readv_ranges", cid, tuple(oids)))
        kw = {} if self._mod is J else {"device": "cpu"}
        rows, crcs, bad = self._mod.readv_ranges_host(
            self._st, cid, list(oids), length, ranges, attr_key, **kw)
        # the frame carries the CRCs as u32 and the bad rows as u32
        return _Handle((rows.tobytes(),
                        None if crcs is None
                        else [int(c) & 0xFFFFFFFF for c in crcs],
                        [int(b) for b in bad]))


def _objects(n, size, seed):
    rng = np.random.default_rng(seed)
    return {f"obj{i}": rng.integers(0, 256, size - 37 * (i % 3),
                                    dtype=np.uint8) for i in range(n)}


def _backends(profile, cs, objs):
    n = T.factory(profile, device="cpu").get_chunk_count()
    jb = J.ECBackend(profile, PG, list(range(n)), J.ShardSet(),
                     chunk_size=cs)
    tb = T.ECBackend(profile, PG, list(range(n)), T.ShardSet(),
                     chunk_size=cs, device="cpu")
    for be in (jb, tb):
        be.write_objects(objs)
    return jb, tb


def _go_remote(mod, be, lost):
    """Drop the lost slot's store and put every other behind the fake."""
    log: list = []
    for osd in list(be.cluster.stores):
        if osd == be.acting[lost]:
            del be.cluster.stores[osd]
        else:
            be.cluster.stores[osd] = RemoteFake(mod, be.cluster.stores[osd],
                                                log)
    return log


def _corrupt(be, slot, name):
    st = be._store(slot)
    st = getattr(st, "_st", st)
    st.queue_transaction(J.Transaction().write(
        J.shard_cid(PG, slot), name, 3, b"\xff\x00\x5a"))


def _stage(mod, be, plan):
    """One runner's staging of the plan's first size class."""
    runner = mod.RecoveryRunner([plan], batch=64, host_crc=False)
    sl, names = sorted(plan.names_by_len.items())[0]
    rl, _ranges = plan.row_ranges(sl)
    live = [(plan, n, be.object_versions.get(n, 0)) for n in names]
    stack = np.zeros((len(live), len(plan.helper), rl), np.uint8)
    exp = np.zeros((len(live), len(plan.helper)), np.uint32)
    pre_bad = runner._stage(live, sl, rl, stack, exp, plan.verify)
    return stack, exp, pre_bad


def _stores(be):
    out = {}
    for osd, st in sorted(be.cluster.stores.items()):
        st = getattr(st, "_st", st)
        for cid in st.list_collections():
            for name in st.list_objects(cid):
                out[(osd, cid, name)] = (st.read(cid, name).tobytes(),
                                         st.getattr(cid, name, J.HINFO_KEY))
    return out


@pytest.fixture(params=GEOMS, ids=[g[0] for g in GEOMS])
def geom(request):
    return request.param


def test_remote_staging_matches_twin_and_local_staging(geom):
    _, profile, cs, size, lost = geom
    objs = _objects(6, size, seed=41)
    got = {}
    for remote in (False, True):
        jb, tb = _backends(profile, cs, objs)
        logs = []
        for mod, be in ((J, jb), (T, tb)):
            if remote:
                logs.append(_go_remote(mod, be, lost))
            else:
                be.cluster.stores.pop(be.acting[lost])
        jp = jb.plan_recovery([lost], {lost: 60})
        tp = tb.plan_recovery([lost], {lost: 60})
        assert (tp.helper, tp.range_planes) == (jp.helper, jp.range_planes)
        js, ts = _stage(J, jb, jp), _stage(T, tb, tp)
        np.testing.assert_array_equal(ts[0], js[0])
        np.testing.assert_array_equal(ts[1], js[1])
        assert ts[2] == js[2] == {}
        if remote:
            assert logs[1] == logs[0]
            kind = "readv_ranges" if tp.range_planes else "readv"
            assert [e[0] for e in logs[1]] == [kind] * len(tp.helper)
        got[remote] = ts
    # a row staged from a frame is the row staged from the store
    for a, b in zip(got[False], got[True]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_remote_recovery_rebuilds_what_the_twin_rebuilds(geom):
    _, profile, cs, size, lost = geom
    objs = _objects(9, size, seed=42)
    jb, tb = _backends(profile, cs, objs)
    logs = [_go_remote(J, jb, lost), _go_remote(T, tb, lost)]
    cj = jb.recover_shards([lost], replacement_osds={lost: 70})
    ct = tb.recover_shards([lost], replacement_osds={lost: 70})
    assert ct == cj and ct["objects"] == len(objs)
    assert logs[1] == logs[0] and logs[1]
    for key in ("recover_wire_bytes", "recover_launches",
                "recovered_objects", "hinfo_failures"):
        assert tb.perf.get(key) == jb.perf.get(key), key
    assert _stores(tb) == _stores(jb)
    # the rebuilt shards are the written ones, their hinfo CRCs too
    got = tb.read_objects(list(objs))
    for name, data in objs.items():
        np.testing.assert_array_equal(got[name], data)
    assert tb.deep_scrub()["inconsistent"] == []


def test_fetch_frames_are_chunked_by_the_byte_budget(geom, monkeypatch):
    _, profile, cs, size, lost = geom
    objs = _objects(7, size, seed=43)
    jb, tb = _backends(profile, cs, objs)
    plan = tb.plan_recovery([lost], {lost: 60})
    sl = max(plan.names_by_len)
    rl, _ranges = plan.row_ranges(sl)
    # two names a frame
    for mod in (J, T):
        monkeypatch.setattr(mod, "RECOVERY_FETCH_BYTES", 2 * rl + 1)
    jb, tb = _backends(profile, cs, objs)
    logs = [_go_remote(J, jb, lost), _go_remote(T, tb, lost)]
    cj = jb.recover_shards([lost], replacement_osds={lost: 70})
    ct = tb.recover_shards([lost], replacement_osds={lost: 70})
    assert ct == cj
    assert logs[1] == logs[0]
    sizes = {len(e[2]) for e in logs[1]}
    assert max(sizes) == 2
    per_len = {n: len(v) for n, v in plan.names_by_len.items()}
    want = sum(-(-c // 2) for c in per_len.values()) * len(plan.helper)
    assert len(logs[1]) == want
    assert _stores(tb) == _stores(jb)


@pytest.mark.parametrize("kind", ["readv", "readv_ranges"])
def test_short_reply_raises_as_in_the_twin(kind):
    profile, cs, size, lost = ((RS, 256, 900, 1) if kind == "readv"
                               else (CLAY, 1024, 9000, 0))
    objs = _objects(3, size, seed=44)
    errors = []
    for mod, be in zip((J, T), _backends(profile, cs, objs)):
        _go_remote(mod, be, lost)
        for st in be.cluster.stores.values():
            if kind == "readv":
                st.readv_submit = lambda *a, **k: _Handle((b"\x01" * 5,
                                                           None))
            else:
                st.readv_ranges_submit = \
                    lambda *a, **k: _Handle((b"\x01" * 5, None, []))
        plan = be.plan_recovery([lost], {lost: 60})
        with pytest.raises(ValueError) as ei:
            _stage(mod, be, plan)
        errors.append(str(ei.value))
    assert errors[1] == errors[0]
    assert errors[1].startswith(f"{kind}: got 5 bytes, expected ")


def test_row_flagged_bad_at_the_source_matches_twin():
    # a Clay helper whose full shard fails its hinfo at the source: the
    # range frame names the row, the receiver plans around it
    objs = _objects(5, 9000, seed=45)
    bad_slot = _backends(CLAY, 1024, objs)[1].plan_recovery(
        [0], {0: 60}).helper[2]
    pairs = []
    for _ in range(2):          # one pair stages, one pair recovers
        jb, tb = _backends(CLAY, 1024, objs)
        for mod, be in ((J, jb), (T, tb)):
            _corrupt(be, bad_slot, "obj3")
            _go_remote(mod, be, 0)
        pairs.append((jb, tb))
    (jb, tb), (jr, tr) = pairs
    jp = jb.plan_recovery([0], {0: 60})
    tp = tb.plan_recovery([0], {0: 60})
    js, ts = _stage(J, jb, jp), _stage(T, tb, tp)
    np.testing.assert_array_equal(ts[0], js[0])
    np.testing.assert_array_equal(ts[1], js[1])
    assert ts[2] == js[2] and set().union(*ts[2].values()) == {bad_slot}
    cj = jr.recover_shards([0], replacement_osds={0: 70})
    ct = tr.recover_shards([0], replacement_osds={0: 70})
    assert ct == cj and ct["hinfo_failures"] >= 1
    assert _stores(tr) == _stores(jr)
    got = tr.read_objects(["obj3"])
    np.testing.assert_array_equal(got["obj3"], objs["obj3"])
