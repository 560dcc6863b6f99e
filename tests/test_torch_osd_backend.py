"""The port's PG data path (ceph_tpu_torch.osd.ecbackend: ECBackend,
RecoveryRunner, ShardSet) held byte for byte against its twin
(ceph_tpu.osd.ecbackend) on the CPU.

Both backends take the same numpy-seeded objects and operations; after
each step every store's shard bytes, hinfo xattrs and omap (the stripe
journal) must be equal, and so must what the backends return. The port
runs with its default impl (the GF kernel's plain version on the CPU),
the twin with its default (and with impl=pallas in interpret mode for
the full-object paths, as its own tests run it). Tolerance: none, every
comparison is exact.
"""

import types

import numpy as np
import pytest
import torch

from ceph_tpu.csum.reference import ceph_crc32c
from ceph_tpu.ec import registry as JR
from ceph_tpu.osd import ecbackend as J
from ceph_tpu_torch.ec import registry as TR
from ceph_tpu_torch.osd import ecbackend as T

RS = "plugin=jerasure technique=reed_sol_van"
# (id, profile, chunk_size, object size): the twin's own test geometry
# (tests/test_ecbackend.py) and the BASELINE geometry at a small chunk
GEOMS = [("k4m2", f"{RS} k=4 m=2", 256, 900),
         ("k8m3", f"{RS} k=8 m=3", 4096, 40000)]
GEOM_IDS = [g[0] for g in GEOMS]
PG = "1.0"


def _pair(profile, chunk_size, twin_profile=None):
    n = TR.factory(profile, device="cpu").get_chunk_count()
    jb = J.ECBackend(twin_profile or profile, PG, list(range(n)),
                     J.ShardSet(), chunk_size=chunk_size)
    tb = T.ECBackend(profile, PG, list(range(n)), T.ShardSet(),
                     chunk_size=chunk_size, device="cpu")
    return jb, tb


def _objects(n, size, seed):
    rng = np.random.default_rng(seed)
    return {f"obj{i}": rng.integers(0, 256, size, dtype=np.uint8)
            for i in range(n)}


def _dump(cluster):
    """Every store's content through the public store API: shard bytes,
    the hinfo xattr and the omap, per (osd, collection, object)."""
    out = {}
    for osd, st in sorted(cluster.stores.items()):
        for cid in st.list_collections():
            for name in st.list_objects(cid):
                try:
                    hinfo = st.getattr(cid, name, J.HINFO_KEY)
                except KeyError:
                    hinfo = None
                out[(osd, cid, name)] = (st.read(cid, name).tobytes(),
                                         hinfo,
                                         tuple(st.omap_iter(cid, name)))
    return out


def _same(jb, tb):
    assert _dump(jb.cluster) == _dump(tb.cluster)
    assert jb.object_sizes == tb.object_sizes
    assert jb.object_versions == tb.object_versions
    assert jb.shard_applied == tb.shard_applied
    assert jb._rmw_seq == tb._rmw_seq


def _both(jb, tb, fn):
    return fn(jb), fn(tb)


def _corrupt(be, slot, name, off=5):
    be.cluster.osd(be.acting[slot]).queue_transaction(
        J.Transaction().write(J.shard_cid(PG, slot), name, off, b"\xff\x00"))


@pytest.fixture(autouse=True)
def _port_device_programs(monkeypatch):
    # these tests hold the port's device programs (their plain versions
    # on the CPU) to the twin: keep the port's CPU backends out of the
    # native host mode; the host mode has its own tests below
    monkeypatch.setattr(T, "_host_crc_available", lambda device=None: False)


@pytest.fixture(params=GEOMS, ids=GEOM_IDS)
def geom(request):
    return request.param


def test_write_matches_twin(geom):
    _, profile, cs, size = geom
    jb, tb = _pair(profile, cs)
    objs = _objects(6, size, seed=1)
    _both(jb, tb, lambda be: be.write_objects(objs))
    _same(jb, tb)
    # the hinfo CRC is the raw ceph_crc32c(-1, shard) of what was stored
    st = tb.cluster.osd(tb.acting[tb.n - 1])
    cid = J.shard_cid(PG, tb.n - 1)
    h = J.HashInfo.from_bytes(st.getattr(cid, "obj3", J.HINFO_KEY))
    assert h.get_chunk_hash(0) == ceph_crc32c(0xFFFFFFFF,
                                              st.read(cid, "obj3"))
    assert tb.perf.get("fused_write_launches") == 1


def test_write_matches_twin_pallas_interpret():
    # the twin's Pallas kernel (interpret mode on the CPU) against the
    # port's default: the same shard bytes and hinfo
    profile = f"{RS} k=4 m=2"
    jb, tb = _pair(profile, 256, twin_profile=profile + " impl=pallas")
    objs = _objects(3, 700, seed=2)
    _both(jb, tb, lambda be: be.write_objects(objs))
    _same(jb, tb)


def test_mixed_sizes_and_empty_objects_match_twin():
    jb, tb = _pair(f"{RS} k=4 m=2", 256)
    rng = np.random.default_rng(3)
    objs = {"a": rng.integers(0, 256, 100, np.uint8),
            "b": rng.integers(0, 256, 2500, np.uint8),
            "c": np.zeros(0, np.uint8),
            "d": rng.integers(0, 256, 100, np.uint8)}
    _both(jb, tb, lambda be: be.write_objects(objs))
    _same(jb, tb)
    got = tb.read_objects(list(objs))
    for name, data in objs.items():
        np.testing.assert_array_equal(got[name], data)


@pytest.mark.parametrize("dead", [(), (0,), (1, 5)],
                         ids=["clean", "one-data", "data+parity"])
def test_read_objects_matches_twin(geom, dead):
    _, profile, cs, size = geom
    jb, tb = _pair(profile, cs)
    objs = _objects(5, size, seed=4)
    _both(jb, tb, lambda be: be.write_objects(objs))
    dead = {d if d < 5 else jb.n - 1 for d in dead}
    gj, gt = _both(jb, tb, lambda be: be.read_objects(list(objs),
                                                      dead_osds=dead))
    for name, data in objs.items():
        np.testing.assert_array_equal(gt[name], data)
        np.testing.assert_array_equal(gt[name], gj[name])
    assert tb.perf.get("decode_launches") == jb.perf.get("decode_launches")


def test_read_eio_decodes_around_and_repairs_like_twin(geom):
    _, profile, cs, size = geom
    jb, tb = _pair(profile, cs)
    objs = _objects(4, size, seed=5)
    _both(jb, tb, lambda be: be.write_objects(objs))
    for be in (jb, tb):
        _corrupt(be, 2, "obj1")
    gj, gt = _both(jb, tb, lambda be: be.read_objects(list(objs)))
    for name, data in objs.items():
        np.testing.assert_array_equal(gt[name], data)
    assert tb.eio_stats == jb.eio_stats == {"read_eio": 1, "repaired": 1}
    _same(jb, tb)


@pytest.mark.parametrize("lost", [(1,), (0, -1)], ids=["one", "two"])
def test_recover_shards_matches_twin(geom, lost):
    _, profile, cs, size = geom
    jb, tb = _pair(profile, cs)
    objs = _objects(7, size, seed=6)
    _both(jb, tb, lambda be: be.write_objects(objs))
    lost = [s % jb.n for s in lost]
    repl = {s: 100 + s for s in lost}
    for be in (jb, tb):
        for s in lost:
            be.cluster.stores.pop(be.acting[s])
    cj, ct = _both(jb, tb, lambda be: be.recover_shards(
        lost, replacement_osds=repl, batch=4))
    assert ct == cj and ct["objects"] == 7 and ct["hinfo_failures"] == 0
    _same(jb, tb)
    got = tb.read_objects(list(objs))
    for name, data in objs.items():
        np.testing.assert_array_equal(got[name], data)


def test_recover_with_corrupt_helper_matches_twin(geom):
    _, profile, cs, size = geom
    jb, tb = _pair(profile, cs)
    objs = _objects(5, size, seed=7)
    _both(jb, tb, lambda be: be.write_objects(objs))
    for be in (jb, tb):
        _corrupt(be, 2, "obj3")
        be.cluster.stores.pop(be.acting[1])
    cj, ct = _both(jb, tb, lambda be: be.recover_shards(
        [1], replacement_osds={1: 50}))
    assert ct == cj and ct["hinfo_failures"] == 1
    _same(jb, tb)
    # the rebuilt shard is the written one, not decoded from the rot
    st = tb.cluster.osd(50)
    cid = J.shard_cid(PG, 1)
    full = tb.sinfo.object_to_shards(objs["obj3"][None])[0, 1]
    np.testing.assert_array_equal(st.read(cid, "obj3"), full)


def test_runner_host_crc_mode_and_cross_pg_batches_match_twin():
    # two PGs' plans fused into one runner's batches, checksums on the
    # host (CPU tensors in the port)
    profile = f"{RS} k=4 m=2"
    pairs = []
    for pg, seed in (("1.0", 8), ("1.1", 9)):
        jb = J.ECBackend(profile, pg, list(range(6)), J.ShardSet(),
                         chunk_size=256)
        tb = T.ECBackend(profile, pg, list(range(6)), T.ShardSet(),
                         chunk_size=256, device="cpu")
        objs = _objects(3, 900, seed)
        for be in (jb, tb):
            be.write_objects(objs)
            be.cluster.stores.pop(3)
        pairs.append((jb, tb))
    runs = []
    for side, mod in ((0, J), (1, T)):
        plans = [p[side].plan_recovery([3], {3: 30}) for p in pairs]
        r = mod.RecoveryRunner(plans, batch=8, host_crc=True)
        r.run()
        runs.append((r.stats, [p.counters for p in plans]))
    (js, jc), (ts, tc) = runs
    assert tc == jc
    assert ts["cross_pg_batches"] == js["cross_pg_batches"] == 1
    assert ts["host_crc"] is True
    for jb, tb in pairs:
        assert _dump(jb.cluster) == _dump(tb.cluster)


def test_runner_host_crc_mode_refuses_card_backends():
    # the host-CRC mode is for CPU backends until the native CRC
    # library is ported; a plan on the card is refused up front
    card = types.SimpleNamespace(be=types.SimpleNamespace(
        device=torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="host_crc=True needs CPU"):
        T.RecoveryRunner([card], host_crc=True)


def test_deep_scrub_and_repair_pg_match_twin(geom):
    _, profile, cs, size = geom
    jb, tb = _pair(profile, cs)
    objs = _objects(4, size, seed=10)
    _both(jb, tb, lambda be: be.write_objects(objs))
    rj, rt = _both(jb, tb, lambda be: be.deep_scrub())
    assert rt == rj and rt["inconsistent"] == []
    for be in (jb, tb):
        _corrupt(be, 3, "obj2", off=0)
    rj, rt = _both(jb, tb, lambda be: be.deep_scrub())
    assert rt == rj and rt["inconsistent"] == [("obj2", 3)]
    rj, rt = _both(jb, tb, lambda be: be.repair_pg())
    assert rt == rj and rt["repaired"] == 1
    _same(jb, tb)
    assert tb.deep_scrub()["inconsistent"] == []


def test_write_ranges_full_path_matches_twin(geom):
    _, profile, cs, size = geom
    jb, tb = _pair(profile, cs)
    objs = _objects(3, size, seed=11)
    _both(jb, tb, lambda be: be.write_objects(objs))
    rng = np.random.default_rng(12)
    sw = tb.sinfo.stripe_width
    ops = [("obj0", sw - 5, rng.integers(0, 256, sw + 33, np.uint8)),
           ("obj1", size - 10, rng.integers(0, 256, 300, np.uint8)),
           ("new", 17, rng.integers(0, 256, 50, np.uint8))]
    _both(jb, tb, lambda be: be.write_ranges(ops))
    _same(jb, tb)
    assert tb.perf.get("rmw_full_fallbacks") == \
        jb.perf.get("rmw_full_fallbacks") > 0
    # degraded: a data shard down ladders every op to the full path
    ops = [("obj2", 3, rng.integers(0, 256, 5, np.uint8))]
    _both(jb, tb, lambda be: be.write_ranges(ops, dead_osds={0}))
    _same(jb, tb)


@pytest.mark.parametrize("windows", [
    [(3, 5), (600, 7)], [(0, 6)], [(7, -11)]],
    ids=["5+7-bytes", "6-bytes", "chunk-less-11-bytes"])
def test_write_ranges_delta_path_ragged_window_matches_twin(geom, windows):
    # windows inside one stripe and fewer than k columns, each of a
    # length that is not a multiple of 4 (a negative length counts back
    # from the chunk size: 245 or 4085 bytes in one column)
    _, profile, cs, size = geom
    jb, tb = _pair(profile, cs)
    objs = _objects(4, size, seed=13)
    _both(jb, tb, lambda be: be.write_objects(objs))
    rng = np.random.default_rng(14)
    ops = []
    for name in ("obj0", "obj2"):
        for off, ln in windows:
            ln = ln if ln > 0 else cs + ln
            assert ln % 4 and off + ln <= size
            ops.append((name, off, rng.integers(0, 256, ln, np.uint8)))
    _both(jb, tb, lambda be: be.write_ranges(ops))
    assert tb.perf.get("rmw_ops") == jb.perf.get("rmw_ops") == 2
    assert tb.perf.get("rmw_full_fallbacks") == 0
    _same(jb, tb)
    got = tb.read_objects(["obj0", "obj2"])
    for name in ("obj0", "obj2"):
        want = objs[name].copy()
        for n, off, data in ops:
            if n == name:
                want[off:off + len(data)] = data
        np.testing.assert_array_equal(got[name], want)
    assert tb.deep_scrub()["inconsistent"] == []


def test_append_fast_path_matches_twin():
    jb, tb = _pair(f"{RS} k=4 m=2", 256)
    objs = _objects(2, 300, seed=15)
    _both(jb, tb, lambda be: be.write_objects(objs))
    tail = {"obj0": b"abcde", "obj1": bytes(range(9))}
    _both(jb, tb, lambda be: be.append_objects(tail))
    assert tb.perf.get("rmw_append_fast") == \
        jb.perf.get("rmw_append_fast") == 2
    _same(jb, tb)


class _Kill(Exception):
    pass


@pytest.mark.parametrize("phase", ["mid_prepare", "after_prepare",
                                   "mid_apply"])
def test_stripe_journal_replay_matches_twin(phase):
    jb, tb = _pair(f"{RS} k=4 m=2", 256)
    objs = _objects(2, 3000, seed=16)
    _both(jb, tb, lambda be: be.write_objects(objs))
    patch = np.random.default_rng(17).integers(0, 256, 101, np.uint8)

    def hook(p):
        if p == phase:
            raise _Kill(p)
    for be in (jb, tb):
        be._rmw_crash_hook = hook
        with pytest.raises(_Kill):
            be.write_at("obj1", 501, patch)
        be._rmw_crash_hook = None
    _same(jb, tb)
    rj, rt = _both(jb, tb, lambda be: be.stripe_journal_replay())
    assert rt == rj and rt["entries"] > 0
    _same(jb, tb)
    sj, st = _both(jb, tb, lambda be: be.deep_scrub())
    assert st == sj and st["inconsistent"] == []
    assert tb.stripe_journal_replay()["entries"] == 0


def test_carried_state_twin_writes_port_recovers():
    # the twin writes, overwrites in place and loses a shard; the port
    # takes its stores and metadata as a plain snapshot, recovers, reads
    # and scrubs; the twin does the same recovery on its own state
    profile = f"{RS} k=8 m=3"
    jb = J.ECBackend(profile, PG, list(range(11)), J.ShardSet(),
                     chunk_size=4096)
    objs = _objects(5, 40000, seed=18)
    jb.write_objects(objs)
    jb.write_ranges([("obj1", 3, b"hello")])
    jb.cluster.stores.pop(4)
    snap = {"stores": {}, "object_sizes": dict(jb.object_sizes),
            "object_versions": dict(jb.object_versions),
            "pg_log": jb.pg_log.encode(),
            "shard_applied": dict(enumerate(jb.shard_applied)),
            "rmw_seq": jb._rmw_seq}
    for osd, st in jb.cluster.stores.items():
        colls = snap["stores"].setdefault(osd, {})
        for cid in st.list_collections():
            for name in st.list_objects(cid):
                try:
                    attrs = {J.HINFO_KEY: st.getattr(cid, name,
                                                     J.HINFO_KEY)}
                except KeyError:
                    attrs = {}
                colls.setdefault(cid, {})[name] = {
                    "data": st.read(cid, name), "attrs": attrs,
                    "omap": dict(st.omap_iter(cid, name))}
    tb = T.backend_from_snapshot(snap, profile, PG, list(range(11)),
                                 chunk_size=4096, device="cpu")
    _same(jb, tb)
    for be in (jb, tb):
        be.recover_shards([4], replacement_osds={4: 40})
    _same(jb, tb)
    want = dict(objs)
    want["obj1"] = want["obj1"].copy()
    want["obj1"][3:8] = np.frombuffer(b"hello", np.uint8)
    got = tb.read_objects(list(objs), dead_osds={0, 9, 10})
    for name, data in want.items():
        np.testing.assert_array_equal(got[name], data)
    assert tb.deep_scrub()["inconsistent"] == []


def test_program_caches_are_keyed_by_device():
    cpu, meta = torch.device("cpu"), torch.device("meta")
    tb = T.ECBackend(f"{RS} k=4 m=2", PG, list(range(6)), T.ShardSet(),
                     chunk_size=256, device="cpu")
    mat = tb.coder.matrix.tobytes()
    a = T._fused_write_fn(mat, 2, 4, "pallas", 256, 4, cpu)
    assert a is T._fused_write_fn(mat, 2, 4, "pallas", 256, 4, cpu)
    assert a is not T._fused_write_fn(mat, 2, 4, "pallas", 256, 4, meta)
    d = T._fused_delta_fn(mat[:2], 2, 1, "pallas", 5, 1, cpu)
    assert d is not T._fused_delta_fn(mat[:2], 2, 1, "pallas", 5, 1, meta)
    tb.write_objects(_objects(3, 900, seed=19))
    tb.cluster.stores.pop(2)
    tb.recover_shards([2], replacement_osds={2: 20})
    assert any(k[-1] == cpu for k in T._RECOVER_PROGRAMS)


def test_backend_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.ECBackend(f"{RS} k=4 m=2", PG, list(range(6)))
    be = T.ECBackend(f"{RS} k=4 m=2", PG, list(range(6)), device="cpu")
    assert be.device == torch.device("cpu") == be.coder.device


@pytest.mark.parametrize("L", [5, 6, 7])
def test_ragged_chunk_length_encode_matches_twin(L):
    # the port's default coder (the GF kernel's plain version on the CPU)
    # takes any chunk length, as the twin's default does
    profile = f"{RS} k=4 m=2"
    x = np.random.default_rng(L).integers(0, 256, (2, 4, L), np.uint8)
    port = TR.factory(profile, device="cpu").encode_chunks(x)
    twin = np.asarray(JR.factory(profile).encode_chunks(x))
    assert tuple(port.shape) == twin.shape == (2, 2, L)
    np.testing.assert_array_equal(port.numpy(), twin)


# -- LRC and Clay profiles (BASELINE configs #3 and #4, small chunks) ---------

# (id, profile, chunk_size, object size)
CODEC_GEOMS = [("lrc-k4m2l3", "plugin=lrc k=4 m=2 l=3", 256, 900),
               ("lrc-k8m4l4", "plugin=lrc k=8 m=4 l=4", 256, 3000),
               ("clay-k4m2d5", "plugin=clay k=4 m=2 d=5", 1024, 9000),
               ("clay-k8m4d11", "plugin=clay k=8 m=4 d=11", 8192, 60000)]
PLANNER_KEYS = ("planner_local_plans", "planner_subchunk_plans",
                "planner_cost_plans", "planner_full_plans",
                "recover_wire_bytes", "recover_launches",
                "recovered_objects", "hinfo_failures")


@pytest.fixture(params=CODEC_GEOMS, ids=[g[0] for g in CODEC_GEOMS])
def codec_geom(request):
    return request.param


def _runner_pair(jb, tb, lost, batch=4):
    """One plan_recovery + RecoveryRunner on each side; returns what
    both report (family, helpers, counters, the runner's stats)."""
    out = []
    for mod, be in ((J, jb), (T, tb)):
        plan = be.plan_recovery(lost, {s: 100 + s for s in lost})
        r = mod.RecoveryRunner([plan], batch=batch)
        r.run()
        out.append((plan.repair.family, plan.repair.helpers,
                    dict(plan.counters),
                    {k: r.stats[k] for k in (
                        "batches", "fused_batches", "generic_batches",
                        "range_batches", "helper_bytes_on_wire")}))
    return out


def _single_loss(be):
    coder = be.coder
    return coder.data_positions[0] if hasattr(coder, "data_positions") \
        else 0


def test_codec_write_read_and_scrub_match_twin(codec_geom):
    _, profile, cs, size = codec_geom
    jb, tb = _pair(profile, cs)
    objs = _objects(4, size, seed=20)
    _both(jb, tb, lambda be: be.write_objects(objs))
    _same(jb, tb)
    dead = {jb.acting[_single_loss(jb)], jb.acting[jb.n - 1]}
    gj, gt = _both(jb, tb, lambda be: be.read_objects(list(objs),
                                                      dead_osds=dead))
    for name, data in objs.items():
        np.testing.assert_array_equal(gt[name], data)
        np.testing.assert_array_equal(gt[name], gj[name])
    rj, rt = _both(jb, tb, lambda be: be.deep_scrub())
    assert rt == rj and rt["inconsistent"] == []


@pytest.mark.parametrize("loss", ["one", "two"])
def test_codec_recovery_matches_twin(codec_geom, loss):
    gid, profile, cs, size = codec_geom
    jb, tb = _pair(profile, cs)
    objs = _objects(5, size, seed=21)
    _both(jb, tb, lambda be: be.write_objects(objs))
    first = _single_loss(jb)
    # "two": a second loss in the first one's local group (LRC), or a
    # data and a parity shard (Clay, the chip run's 0 and 9 at k=8)
    lost = [first] if loss == "one" else sorted(
        {first, first + 1 if gid.startswith("lrc") else jb.n - 3})
    for be in (jb, tb):
        for s in lost:
            be.cluster.stores.pop(be.acting[s])
    rj, rt = _runner_pair(jb, tb, lost)
    assert rt == rj
    family, helpers, counters, stats = rt
    assert counters["objects"] == 5 and counters["hinfo_failures"] == 0
    want = {("lrc", "one"): "lrc_local", ("lrc", "two"): "lrc_multi",
            ("clay", "one"): "clay_planes",
            ("clay", "two"): "clay_full"}[(gid.split("-")[0], loss)]
    assert family == want
    sl = tb._shard_len(size)
    if want == "lrc_local":
        # a local group's l helpers, not k: 2.0x fewer at k=8 l=4
        assert len(helpers) == int(gid[-1])
        assert stats["helper_bytes_on_wire"] == 5 * len(helpers) * sl
    if want == "clay_planes":
        # d helpers ship beta of q^t planes: d/(k*q) of k full chunks
        # (11/32 at k=8 m=4 d=11)
        c = tb.coder
        assert stats["range_batches"] >= 1
        assert stats["helper_bytes_on_wire"] * c.k * c.q == \
            5 * c.k * sl * c.d
    for key in PLANNER_KEYS:
        assert tb.perf.get(key) == jb.perf.get(key), key
    _same(jb, tb)
    got = tb.read_objects(list(objs))
    for name, data in objs.items():
        np.testing.assert_array_equal(got[name], data)
    assert tb.deep_scrub()["inconsistent"] == []


@pytest.mark.parametrize("where", ["inside", "outside"])
def test_clay_range_recovery_flags_rot_at_the_source(where):
    # one flipped byte in a helper, inside or outside the repair planes
    # it ships: the source's full-row check flags it (pre_bad) either
    # way, and the object is decoded around the rotten helper
    profile, cs, size = "plugin=clay k=4 m=2 d=5", 1024, 9000
    jb, tb = _pair(profile, cs)
    objs = _objects(5, size, seed=22)
    _both(jb, tb, lambda be: be.write_objects(objs))
    planes = tb.coder._repair_planes(0)
    s = tb._shard_len(size) // tb.coder.sub_chunk_count
    z = planes[1] if where == "inside" else \
        next(p for p in range(tb.coder.sub_chunk_count) if p not in planes)
    for be in (jb, tb):
        _corrupt(be, 2, "obj3", off=z * s + 7)
        be.cluster.stores.pop(be.acting[0])
    rj, rt = _runner_pair(jb, tb, [0])
    assert rt == rj and rt[0] == "clay_planes"
    assert rt[2]["hinfo_failures"] == 1 and rt[3]["range_batches"] >= 1
    _same(jb, tb)
    st = tb.cluster.osd(100)
    full = tb.sinfo.object_to_shards(objs["obj3"][None])[0, 0]
    np.testing.assert_array_equal(st.read(J.shard_cid(PG, 0), "obj3"), full)


def test_readv_ranges_host_matches_twin():
    profile, cs, size = "plugin=clay k=4 m=2 d=5", 1024, 9000
    jb, tb = _pair(profile, cs)
    objs = _objects(3, size, seed=23)
    _both(jb, tb, lambda be: be.write_objects(objs))
    for be in (jb, tb):
        _corrupt(be, 1, "obj1", off=900)
    sl = tb._shard_len(size)
    ranges = ((0, 128), (512, 256), (1000, 24))
    for attr in (J.HINFO_KEY, None):
        got = [mod.readv_ranges_host(
            be.cluster.osd(be.acting[1]), J.shard_cid(PG, 1),
            sorted(objs), sl, ranges, attr, **kw)
            for mod, be, kw in ((J, jb, {}), (T, tb, {"device": "cpu"}))]
        (jr, jc, jbad), (tr, tc, tbad) = got
        np.testing.assert_array_equal(tr, jr)
        assert tbad == jbad == ([1] if attr else [])
        if attr is None:
            assert tc is None and jc is None
        else:
            np.testing.assert_array_equal(tc, jc)


def test_range_staging_refuses_remote_stores():
    # a remote store whose readv_ranges reply is short is refused, as in
    # the twin: the bytes would not fill the planned rows
    tb = T.ECBackend("plugin=clay k=4 m=2 d=5", PG, list(range(6)),
                     T.ShardSet(), chunk_size=1024, device="cpu")
    tb.write_objects(_objects(2, 9000, seed=24))
    tb.cluster.stores.pop(0)
    st = tb.cluster.osd(tb.acting[1])

    class Short:
        def result(self):
            return b"\x00" * 7, None, []
    st.readv_ranges_submit = lambda *a: Short()
    with pytest.raises(ValueError, match="readv_ranges: got 7 bytes"):
        tb.recover_shards([0], replacement_osds={0: 100})


@pytest.mark.parametrize("profile,cs,lost", [
    ("plugin=lrc k=8 m=4 l=4", 256, [3]),
    ("plugin=clay k=4 m=2 d=5", 1024, [0])], ids=["lrc", "clay"])
def test_carried_state_codecs_twin_writes_port_recovers(profile, cs, lost):
    n = TR.factory(profile, device="cpu").get_chunk_count()
    jb = J.ECBackend(profile, PG, list(range(n)), J.ShardSet(),
                     chunk_size=cs)
    objs = _objects(4, 5000, seed=25)
    jb.write_objects(objs)
    for s in lost:
        jb.cluster.stores.pop(s)
    snap = {"stores": {}, "object_sizes": dict(jb.object_sizes),
            "object_versions": dict(jb.object_versions),
            "pg_log": jb.pg_log.encode(),
            "shard_applied": dict(enumerate(jb.shard_applied)),
            "rmw_seq": jb._rmw_seq}
    for osd, st in jb.cluster.stores.items():
        colls = snap["stores"].setdefault(osd, {})
        for cid in st.list_collections():
            for name in st.list_objects(cid):
                colls.setdefault(cid, {})[name] = {
                    "data": st.read(cid, name),
                    "attrs": {J.HINFO_KEY: st.getattr(cid, name,
                                                      J.HINFO_KEY)},
                    "omap": {}}
    tb = T.backend_from_snapshot(snap, profile, PG, list(range(n)),
                                 chunk_size=cs, device="cpu")
    _same(jb, tb)
    cj, ct = _both(jb, tb, lambda be: be.recover_shards(
        lost, replacement_osds={s: 40 + s for s in lost}))
    assert ct == cj and ct["objects"] == 4
    _same(jb, tb)
    got = tb.read_objects(list(objs))
    for name, data in objs.items():
        np.testing.assert_array_equal(got[name], data)


@pytest.mark.parametrize("verify", [True, False])
def test_recover_program_crcs_rebuilt_and_shorter_fold(verify):
    # the recovery program's one CRC call: rebuilt rows of sl bytes and,
    # with verify, the helper fold of the staged rl < sl bytes (a Clay
    # range plan's shape), equal to separate calls and to the oracle
    from ceph_tpu_torch.csum.kernels import crc32c_blocks

    rng = np.random.default_rng(31)
    B, H, rl, sl = 3, 4, 1536, 3072
    stack = torch.from_numpy(rng.integers(0, 256, (B, H, rl), np.uint8))
    rebuilt = torch.from_numpy(rng.integers(0, 256, (B, 2, sl), np.uint8))
    calls = []

    def sets(rows):
        calls.append([tuple(r.blocks.shape) for r in rows])
        return crc_sets(rows)
    crc_sets, T.crc32c_sets = T.crc32c_sets, sets
    try:
        fold = np.bitwise_xor.reduce(stack.numpy(), axis=1)
        exp = np.array([ceph_crc32c(0xFFFFFFFF, f) for f in fold], np.int64)
        exp[1] ^= 1                              # one fold check fails
        prog = T._build_recover_program(lambda s: rebuilt, verify, False)
        got, rcrc, ok = prog(stack, exp)
    finally:
        T.crc32c_sets = crc_sets
    assert got is rebuilt
    assert calls == ([[(2 * B, sl), (B, rl)]] if verify else [[(2 * B, sl)]])
    assert torch.equal(rcrc, crc32c_blocks(rebuilt.reshape(2 * B, sl),
                                           0xFFFFFFFF, 0).reshape(B, 2))
    assert rcrc[2, 1].item() == ceph_crc32c(0xFFFFFFFF,
                                            rebuilt[2, 1].numpy())
    assert ok.tolist() == ([True, False, True] if verify else [True] * B)


@pytest.mark.parametrize("program", ["write", "delta"])
def test_fused_write_and_delta_crc_once(program, monkeypatch):
    # the fused write's (seed -1) and the RMW delta's (seed 0, 4093-byte
    # rows) CRCs of data and parity rows: one crc32c_sets call a call,
    # the (bucket, k + m) order of separate calls
    from ceph_tpu_torch.csum.kernels import crc32c_blocks

    coder = TR.factory(f"{RS} k=4 m=2", device="cpu")
    k, m, bucket = 4, 2, 3
    if program == "write":
        L, seed, t, mat = 4096, 0xFFFFFFFF, k, coder.matrix
        fn = T._fused_write_fn(mat.tobytes(), m, k, coder.impl, L, bucket,
                               torch.device("cpu"))
    else:
        L, seed, t = 4093, 0, 2
        mat = np.ascontiguousarray(coder.matrix[:, :t])
        fn = T._fused_delta_fn(mat.tobytes(), m, t, coder.impl, L, bucket,
                               torch.device("cpu"))
    calls = []
    real = T.crc32c_sets
    monkeypatch.setattr(T, "crc32c_sets",
                        lambda rows: calls.append(len(rows)) or real(rows))
    d = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (bucket, t, L), np.uint8))
    parity, crcs = fn(d)
    assert calls == [2]
    full = torch.cat([d, parity], dim=1).reshape(bucket * (t + m), L)
    assert torch.equal(crcs, crc32c_blocks(full, seed, 0).reshape(
        bucket, t + m))
