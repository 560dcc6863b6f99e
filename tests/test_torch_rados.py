"""The port's Objecter, librados (Rados, IoCtx, aio) and RadosStriper held
against the JAX package's on the CPU: each test drives one seeded
sequence through both client stacks, each over its own package's
SimCluster (the port's with device="cpu"), at RS k=4 m=2 and k=8 m=3,
and compares every returned byte string, size, listing, snap list,
notify reply, exception (class and message) and the Objecter's
counters, then every OSD's shards, xattrs and omap (see
torch_client_helpers). Tolerance: none."""

import threading

import numpy as np
import pytest

from torch_client_helpers import (PROFILES, counters, new_cluster, payload,
                                  run_both, stack)

SIZES = (700, 1500, 2048, 3000)


def _objects(rng, n: int, tag: str) -> dict:
    return {f"{tag}{i}": payload(rng, SIZES[i % len(SIZES)])
            for i in range(n)}


def seq_object_ops(S, c, rec):
    rng = np.random.default_rng(1)
    r = S.rados.Rados(c)
    io = r.open_ioctx()
    rec("open bad pool", r.open_ioctx, "nope")
    objs = _objects(rng, 8, "o")
    for name, data in objs.items():
        rec(f"write_full {name}", io.write_full, name, data)
    rec("write at 333", io.write, "o1", payload(rng, 500), offset=333)
    rec("write past the tail", io.write, "o2", payload(rng, 300),
        offset=2200)
    rec("append", io.append, "o3", payload(rng, 777))
    rec("append to a new object", io.append, "fresh", payload(rng, 64))
    for name in sorted(objs) + ["fresh"]:
        rec(f"read {name}", io.read, name)
    rec("read range", io.read, "o1", length=400, offset=300)
    rec("read past the end", io.read, "o0", length=100, offset=650)
    rec("read_many", io.read_many, ["o4", "o5", "fresh", "o0"])
    rec("stat", lambda: [io.stat(n) for n in sorted(objs)])
    rec("list", io.list_objects)
    rec("remove", io.remove, "o6")
    rec("read removed", io.read, "o6")
    rec("stat removed", io.stat, "o6")
    rec("remove removed", io.remove, "o6")
    rec("list after remove", io.list_objects)
    rec("stat_cluster", r.stat_cluster)
    rec.note("counters", counters(r))


def seq_failover(S, c, rec):
    """The primary of a PG dies: reads are served degraded at once,
    writes wait for the map; the map marks it down (ops retarget), then
    out (CRUSH remaps, recovery rebuilds)."""
    rng = np.random.default_rng(2)
    r = S.rados.Rados(c)
    io = r.open_ioctx()
    objs = _objects(rng, 12, "f")
    for name, data in objs.items():
        io.write_full(name, data)
    victim_obj = "f3"
    ps = c.locate(victim_obj)
    primary = c.osdmap.pg_to_up_acting_osds(1, ps)[3]
    rec.note("victim", (ps, primary))
    c.kill_osd(primary)
    rec("degraded read", io.read, victim_obj)
    rec("degraded read range", io.read, victim_obj, length=100, offset=50)
    rec("degraded read_many", io.read_many, sorted(objs))
    rec.note("counters after the kill", counters(r))
    rec("write to the dead primary", io.write_full, victim_obj,
        payload(rng, 900))
    rec("missing object through the fast path", io.read, "no-such")
    c.tick(30.0)                   # marked down: a new primary serves
    rec.note("up", bool(c.osdmap.osd_up[primary]))
    rec("write after the mark-down", io.write_full, victim_obj,
        payload(rng, 900))
    rec("partial write", io.write, "f4", payload(rng, 200), offset=123)
    rec("append", io.append, "f5", payload(rng, 333))
    rec("read all", io.read_many, sorted(objs))
    rec.note("counters after the mark-down", counters(r))
    c.tick(60.0)                   # out: remap and recovery
    rec.note("weight", int(c.osdmap.osd_weight[primary]))
    rec("write after the remap", io.write_full, "f6", payload(rng, 1500))
    rec("read after the remap", io.read_many, sorted(objs))
    rec.note("health", c.health())
    rec.note("counters", counters(r))


def seq_aio(S, c, rec):
    """32 aio ops with callbacks and aio_flush; one worker thread, so
    that both packages apply the ops in the same order."""
    rng = np.random.default_rng(3)
    r = S.rados.Rados(c, aio_threads=1)
    io = r.open_ioctx()
    seen: list = []
    lock = threading.Lock()

    def cb(comp):
        with lock:
            try:
                seen.append(("ok", comp.get_return_value()))
            except Exception as e:  # noqa: BLE001
                seen.append(("raised", type(e).__name__, str(e)))
    objs = _objects(rng, 12, "a")
    comps = [io.aio_write_full(n, d, callback=cb) for n, d in objs.items()]
    comps += [io.aio_write("a1", payload(rng, 100), offset=50, callback=cb),
              io.aio_write("a2", payload(rng, 700), offset=1900,
                           callback=cb)]
    io.aio_flush()
    rec("write returns", lambda: [cp.get_return_value() for cp in comps])
    reads = [io.aio_read(n, callback=cb) for n in sorted(objs)]
    reads += [io.aio_read("a1", length=200, offset=40, callback=cb),
              io.aio_read("missing", callback=cb),
              io.aio_remove("a11", callback=cb),
              io.aio_read("a11", callback=cb)]
    io.aio_flush(reads)
    for i, cp in enumerate(reads):
        rec(f"aio result {i}", cp.get_return_value)
    rec.note("complete", [cp.is_complete() for cp in comps + reads])
    rec.note("callbacks", seen)
    r.shutdown()
    rec("sync read after shutdown", io.read, "a0")
    rec.note("counters", counters(r))


def seq_pool_snaps(S, c, rec):
    rng = np.random.default_rng(4)
    r = S.rados.Rados(c)
    io = r.open_ioctx()
    objs = _objects(rng, 6, "s")
    for name, data in objs.items():
        io.write_full(name, data)
    s1 = rec("snap_create", io.snap_create)
    rec("overwrite", io.write_full, "s0", payload(rng, 900))
    rec("partial overwrite", io.write, "s1", payload(rng, 64), offset=10)
    rec("remove", io.remove, "s2")
    rec("create after the snap", io.write_full, "s9", payload(rng, 300))
    s2 = rec("snap_create", io.snap_create)
    rec("overwrite again", io.write_full, "s0", payload(rng, 1100))
    for name in ("s0", "s1", "s2", "s3", "s9"):
        for sid in (s1, s2):
            rec(f"read {name} at {sid}", io.read, name, snap=sid)
        rec(f"snap_changed {name}", io.snap_changed, name, s1)
    rec("snap_list", io.snap_list)
    rec("rollback", io.snap_rollback, "s0", s1)
    rec("read rolled back", io.read, "s0")
    rec("selfmanaged refused", io.selfmanaged_snap_create)
    rec("snap_remove", io.snap_remove, s1)
    rec("snap_remove again", io.snap_remove, s1)
    rec("read at removed snap", io.read, "s0", snap=s1)
    rec("snap_list", io.snap_list)
    rec("list", io.list_objects)
    rec.note("counters", counters(r))


def seq_selfmanaged_snaps(S, c, rec):
    rng = np.random.default_rng(5)
    r = S.rados.Rados(c)
    io = r.open_ioctx()
    objs = _objects(rng, 5, "m")
    for name, data in objs.items():
        io.write_full(name, data)
    sid = rec("selfmanaged_snap_create", io.selfmanaged_snap_create)
    rec("write naming the snap", io.write_full, "m0", payload(rng, 800),
        snapc=sid)
    rec("range write naming the snap", io.write, "m1", payload(rng, 50),
        offset=7, snapc=sid)
    rec("write naming no snap", io.write_full, "m2", payload(rng, 800))
    rec("remove naming the snap", io.remove, "m3", snapc=sid)
    for name in sorted(objs):
        rec(f"read {name} at the snap", io.read, name, snap=sid)
        rec(f"snap_changed {name}", io.snap_changed, name, sid)
        rec(f"read {name}", io.read, name)
    rec("pool snap refused", io.snap_create)
    rec("selfmanaged_snap_remove", io.selfmanaged_snap_remove, sid)
    rec("selfmanaged_snap_remove again", io.selfmanaged_snap_remove, sid)
    rec("list", io.list_objects)
    rec.note("counters", counters(r))


def seq_cls_watch(S, c, rec):
    rng = np.random.default_rng(6)
    r = S.rados.Rados(c)
    io = r.open_ioctx()
    io.write_full("obj", payload(rng, 1000))
    io.write_full("rc", payload(rng, 100))
    lock = b'{"owner": "a"}'
    rec("lock", io.execute, "obj", "lock", "lock", lock)
    rec("lock by b", io.execute, "obj", "lock", "lock", b'{"owner": "b"}')
    rec("shared lock refused", io.execute, "obj", "lock", "lock",
        b'{"owner": "b", "type": "shared"}')
    rec("get_info", io.execute, "obj", "lock", "get_info")
    rec("unlock by b", io.execute, "obj", "lock", "unlock",
        b'{"owner": "b"}')
    rec("unlock", io.execute, "obj", "lock", "unlock", lock)
    rec("unknown class", io.execute, "obj", "nope", "nope")
    for _ in range(2):
        rec("refcount get", io.execute, "rc", "refcount", "get",
            b'{"tag": "t1"}')
    rec("refcount read", io.execute, "rc", "refcount", "read")
    rec("version bump", io.execute, "obj", "version", "bump")
    rec("version read", io.execute, "obj", "version", "read")
    replies = {}

    def watcher(tag):
        def cb(name, data):
            replies.setdefault(tag, []).append((name, bytes(data)))
            return tag.encode() + bytes(data)
        return cb

    def broken(name, data):
        raise RuntimeError("watcher bug")
    w1 = rec("watch 1", io.watch, "obj", watcher("one"))
    w2 = rec("watch 2", io.watch, "obj", watcher("two"))
    rec("watch broken", io.watch, "obj", broken)
    rec("watch a missing object", io.watch, "missing", watcher("x"))
    rec("notify", io.notify, "obj", b"ping")
    rec("unwatch", io.unwatch, "obj", w1)
    rec("notify after unwatch", io.notify, "obj", b"pong")
    rec("unwatch", io.unwatch, "obj", w2)
    rec.note("replies", replies)
    rec("read", io.read, "obj")
    rec("remove", io.remove, "obj")
    rec("notify a removed object", io.notify, "obj", b"gone")
    rec.note("counters", counters(r))


def seq_striper(S, c, rec):
    """Extents across stripe-unit and object boundaries at odd offsets
    and lengths, appends, truncates and the full-stripe route."""
    rng = np.random.default_rng(7)
    io = S.rados.Rados(c).open_ioctx()
    st = S.rados.RadosStriper(io, stripe_unit=512, stripe_count=3,
                              object_size=2048)
    rec("bad geometry", S.rados.RadosStriper, io, stripe_unit=500,
        object_size=2048)
    rec("extents", lambda: list(st._extents(333, 5000)))
    rec("write", st.write, "s", payload(rng, 7001), offset=0)
    rec("write odd", st.write, "s", payload(rng, 1111), offset=1537)
    rec("write past the end (a hole)", st.write, "s", payload(rng, 99),
        offset=9000)
    rec("size", st.size, "s")
    rec("read all", st.read, "s")
    rec("read odd", st.read, "s", length=2049, offset=511)
    rec("read past the end", st.read, "s", length=500, offset=8900)
    rec("append dense", st.append, "d", payload(rng, 700))
    rec("append dense", st.append, "d", payload(rng, 1300))
    rec("append after a hole", st.append, "s", payload(rng, 600))
    rec("read d", st.read, "d")
    rec("truncate", st.truncate, "s", 3000)
    rec("read truncated", st.read, "s")
    rec("regrow", st.truncate, "s", 4000)
    rec("read regrown", st.read, "s", length=1500, offset=2500)
    full = S.rados.RadosStriper(io, stripe_unit=512, stripe_count=2,
                                object_size=1024, full_stripe_writes=True)
    rec("full-stripe write", full.write, "f", payload(rng, 3333),
        offset=17)
    rec("full-stripe read", full.read, "f")
    rec("piece extents", lambda: list(st.piece_extents(4, 9099)))
    rec("remove", st.remove, "s")
    rec("size removed", st.size, "s")
    rec("list", io.list_objects)


SEQUENCES = {"object_ops": seq_object_ops, "failover": seq_failover,
             "aio": seq_aio, "pool_snaps": seq_pool_snaps,
             "selfmanaged_snaps": seq_selfmanaged_snaps,
             "cls_watch": seq_cls_watch, "striper": seq_striper}


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_librados_sequence_matches_twin(name, profile):
    run_both(SEQUENCES[name], PROFILES[profile])


def test_aio_with_16_in_flight_reads_back_exact():
    # four worker threads and 16 ops in flight at a time: the order the
    # ops reach the cluster is the threads', so only what each returns
    # is compared, against the bytes written
    rng = np.random.default_rng(8)
    objs = {f"p{i}": payload(rng, 500 + 37 * i) for i in range(32)}
    for pkg in ("ceph_tpu", "ceph_tpu_torch"):
        S = stack(pkg)
        c = new_cluster(S, PROFILES["k4m2"])
        r = S.rados.Rados(c, aio_threads=4)
        io = r.open_ioctx()
        names = sorted(objs)
        for i in range(0, len(names), 16):
            io.aio_flush([io.aio_write_full(n, objs[n])
                          for n in names[i:i + 16]])
        got = {}
        for i in range(0, len(names), 16):
            comps = {n: io.aio_read(n) for n in names[i:i + 16]}
            io.aio_flush(list(comps.values()))
            got.update({n: cp.get_return_value() for n, cp in comps.items()})
        r.shutdown()
        assert got == objs, pkg
        assert c.verify_all({n: np.frombuffer(d, np.uint8)
                             for n, d in objs.items()}) == len(objs)


def test_rados_without_device_runs_on_cuda_or_raises(monkeypatch):
    import torch

    from ceph_tpu_torch.client.rados import Rados
    from ceph_tpu_torch.osd.cluster import SimCluster
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Rados(SimCluster(n_osds=6, pg_num=4, profile=PROFILES["k4m2"]))
