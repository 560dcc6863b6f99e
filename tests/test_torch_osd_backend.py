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
