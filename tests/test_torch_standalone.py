"""The port's standalone cluster (ceph_tpu_torch.osd.standalone: OSD
daemons, three Paxos monitors and clients, every interaction a frame on
the Messenger) held to its twin (ceph_tpu.osd.standalone) on the CPU.

One numpy-seeded client sequence runs through both packages' clusters
(the twin's defaults, 8 OSDs, pg_num 4, chunk 1024; the port on
`device="cpu"`): 32 objects of ragged sizes, `write_at` overwrites (the
parity-delta RMW over `rmw_fetch` frames), an OSD killed, degraded
reads, `wait_for_down`, `wait_for_clean`, a reread. Once recovery has
settled (every PG's acting set holds all its shards and the daemons'
summed `recovered_objects` equals the objects that had a shard on the
victim), the reads, every live OSD's objects and hinfo attrs, and
`recover_wire_bytes` per recovered object must be equal. Per-OSD
counters at the moment `wait_for_clean` returns are not compared: they
depend on timing in the twin itself. Both packages run their CPU host
modes (the native RS codec and CRC32C) when the native library builds.
Every comparison is exact; every wait has its own timeout.
"""

import time
import types

import numpy as np
import pytest
import torch

from ceph_tpu import native as JN
from ceph_tpu.osd import ecbackend as JB
from ceph_tpu.osd import pg_export as JX
from ceph_tpu.osd import standalone as JS
from ceph_tpu_torch import native as TN
from ceph_tpu_torch.osd import ecbackend as TB
from ceph_tpu_torch.osd import pg_export as TX
from ceph_tpu_torch.osd import standalone as TS

HINFO = "hinfo_key"
VICTIM = 2
KILL_GRACE = 8.0      # seconds of heartbeat silence from the kill on
# (id, profile, cluster keywords): the twin's default profile, RS k=4
# m=2 over cephx and AES-GCM sessions, and Clay, whose recovery ships
# only its repair planes (readv_ranges frames)
PROFILES = [
    ("rs-k2m1", "plugin=tpu_rs k=2 m=1 impl=bitlinear", {}),
    ("rs-k4m2-cephx-secure", "plugin=tpu_rs k=4 m=2",
     {"secret": b"\x42" * 32, "cephx": True}),
    ("clay-k4m2d5", "plugin=clay k=4 m=2 d=5", {}),
]


@pytest.fixture(scope="module", autouse=True)
def _twin_roster():
    """The twin's cluster gets the port's empty roster while its daemons
    are built. Without it, every twin daemon whose first heartbeat comes
    before the last daemon exists loses its heartbeat thread to the
    missing `osds` attribute (four of eight on an idle CPU, more on a
    loaded one). Those OSDs then never report a failure, and with fewer
    than two reporters the twin never marks the victim down."""
    init = JS.StandaloneCluster.__init__

    def with_roster(self, *args, **kw):
        self.osds = {}
        init(self, *args, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS.StandaloneCluster, "__init__", with_roster)
        yield


@pytest.fixture(scope="module", autouse=True)
def _same_host_mode():
    """Both packages in the same CPU mode: the native library built by
    each package's own build, the mode caches cleared."""
    for build in (TN.build, JN.lib):
        try:
            build()
        except (RuntimeError, OSError):
            pass
    TB._native_crc_ready.cache_clear()
    JB._host_crc_available.cache_clear()
    assert TB._host_crc_available("cpu") == JB._host_crc_available()
    yield


def _objects(seed=7, n=32):
    # ragged sizes of one shard length at every profile here (4097 to
    # 6144 bytes: three 1 KiB chunks a shard at k=2, two at k=4), so
    # the twin compiles few XLA programs on its daemon threads
    rng = np.random.default_rng(seed)
    return {f"obj{i:02d}": rng.integers(
        0, 256, int(rng.integers(4097, 6145)), np.uint8).tobytes()
        for i in range(n)}


def _overwrites(objs, seed=8, n=6):
    rng = np.random.default_rng(seed)
    names = sorted(objs)
    out = []
    for i in range(n):
        name = names[(i * 5) % len(names)]
        size = len(objs[name])
        off = int(rng.integers(0, max(1, size - 1)))
        data = rng.integers(0, 256, int(rng.integers(1, 700)),
                            np.uint8).tobytes()
        out.append((name, off, data))
    return out


def _apply(model, name, off, data):
    cur = bytearray(model[name])
    if off + len(data) > len(cur):
        cur.extend(bytes(off + len(data) - len(cur)))
    cur[off:off + len(data)] = data
    model[name] = bytes(cur)


def _store_objects(store, names):
    """{(collection, name): (bytes, hinfo)} of the client objects."""
    out = {}
    for cid in store.list_collections():
        for name in store.list_objects(cid):
            if name in names:
                out[(cid, name)] = (store.read(cid, name).tobytes(),
                                    store.getattr(cid, name, HINFO))
    return out


def _wait(pred, timeout, what):
    t_end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > t_end:
            raise TimeoutError(f"timed out after {timeout} s: {what}")
        time.sleep(0.05)


def _settled(c, names, want_recovered):
    """Every PG's acting set holds all its shards, and the daemons have
    recovered every object that had a shard on the victim."""
    live = {o: d for o, d in c.osds.items() if not d._stop.is_set()}
    got = sum(d.ec_perf.get("recovered_objects") for d in live.values())
    if got != want_recovered:
        return False
    osdmap = next(iter(live.values())).osdmap
    for name in names:
        ps = osdmap.object_to_pg(1, name)[1]
        acting = osdmap.pg_to_up_acting_osds(1, ps)[2]
        for slot, osd in enumerate(acting):
            if osd not in live:
                return False
            cid = JB.shard_cid(f"1.{ps}", slot)
            try:
                live[osd].store.read(cid, name)
            except KeyError:
                return False
    return True


def _primary(osdmap, name):
    return osdmap.pg_to_up_acting_osds(
        1, osdmap.object_to_pg(1, name)[1])[2][0]


def _grace(c, seconds):
    """Every OSD's heartbeat grace, as `ceph daemon osd.N config set`
    would set it; the daemons' sampling profilers off as well (a quarter
    of the sequence's CPU, which the tier-1 run shares with other
    tests)."""
    for d in c.osds.values():
        d.config.set("osd_heartbeat_grace", seconds, level="override")
        d.config.set("daemon_profile_hz", 0, level="override")


def _journey(S, profile, kw):
    """The seeded client sequence through one package's cluster. The
    twin builds its XLA programs at their first use, seconds a shape on
    a loaded CPU, during which its daemons answer pings late: a long
    heartbeat grace covers the writes and reads, and a shorter one the
    kill, so that failure detection finds the victim and no other OSD
    (both packages alike)."""
    model = _objects()
    names = set(model)
    c = S.StandaloneCluster(n_osds=8, pg_num=4, profile=profile,
                            chunk_size=1024, **kw)
    out = {}
    try:
        # a daemon without its heartbeat thread never reports a failure
        assert all(d._hb.is_alive() for d in c.osds.values())
        _grace(c, 60.0)
        cl = c.client()
        if kw.get("cephx"):
            # a store RPC that met a cold osd ticket at boot left its
            # peer suspect, and writes skip suspects (both packages):
            # let the tickets warm, then commit an epoch, which clears
            # the suspicion of every up OSD
            _wait(lambda: all(d._cauth.has_ticket("osd")
                              for d in c.osds.values()), 90,
                  "osd service tickets")
            cl.config_set("osd_heartbeat_grace", str(c.hb_grace),
                          timeout=60)
        cl.write(model)
        out["first_reads"] = cl.read_many(sorted(model))
        for name, off, data in _overwrites(model):
            cl.write_at(name, off, data)
            _apply(model, name, off, data)
        out["model"] = dict(model)
        out["reads"] = cl.read_many(sorted(model))
        on_victim = sorted({n for _c, n in _store_objects(
            c.osds[VICTIM].store, names)})
        out["on_victim"] = on_victim
        _grace(c, KILL_GRACE)
        c.kill_osd(VICTIM)
        # reads that need the victim's shard, served by live primaries
        # (a read sent to the dead primary waits out the op timeout)
        degraded = [n for n in on_victim
                    if _primary(cl.osdmap, n) != VICTIM][:6]
        out["degraded_reads"] = cl.read_many(degraded)
        # generous waits: the tier-1 run shares the CPU with other tests
        c.wait_for_down(VICTIM, timeout=90)
        c.wait_for_clean(timeout=240)
        _wait(lambda: _settled(c, names, len(on_victim)), 90,
              "recovery settled")
        out["reread"] = cl.read_many(sorted(model))
        live = {o: d for o, d in c.osds.items() if o != VICTIM}
        out["stores"] = {o: _store_objects(d.store, names)
                         for o, d in live.items()}
        out["perf"] = {key: sum(d.ec_perf.get(key) for d in live.values())
                       for key in ("recover_wire_bytes",
                                   "recovered_objects", "rmw_ops",
                                   "host_encode_launches",
                                   "fused_write_launches")}
        out["frames"] = sum(d.msgr.perf.get("frames_tx")
                            for d in live.values())
        out["scrub"] = [cl.deep_scrub(ps)["inconsistent"]
                        for ps in range(c.pg_num)]
        if S is TS:
            out["devices"] = {str(d.device) for d in live.values()} | {
                str(m.device) for m in c.mons} | {str(cl.device)}
    finally:
        c.shutdown()
    return out


@pytest.fixture(scope="module", params=PROFILES,
                ids=[p[0] for p in PROFILES])
def runs(request):
    _, profile, kw = request.param
    twin = _journey(JS, profile, kw)
    port = _journey(TS, profile, dict(kw, device="cpu"))
    return twin, port


def test_reads_match_twin_and_the_model(runs):
    twin, port = runs
    assert port["model"] == twin["model"]
    for key in ("first_reads", "reads", "degraded_reads", "reread"):
        assert port[key] == twin[key], key
    assert port["reread"] == port["model"]
    assert port["degraded_reads"] == {
        n: port["model"][n] for n in port["degraded_reads"]}
    assert port["degraded_reads"]
    assert port["devices"] == {"cpu"}


def test_live_stores_match_twin_once_recovery_settled(runs):
    twin, port = runs
    assert port["on_victim"] == twin["on_victim"] and port["on_victim"]
    assert port["stores"].keys() == twin["stores"].keys()
    for osd in port["stores"]:
        assert port["stores"][osd] == twin["stores"][osd], osd


def test_recovery_wire_bytes_per_object_match_twin(runs):
    twin, port = runs
    for side in (twin, port):
        assert side["perf"]["recovered_objects"] == len(side["on_victim"])
        assert side["perf"]["recover_wire_bytes"] > 0
    assert port["perf"]["recover_wire_bytes"] * \
        twin["perf"]["recovered_objects"] == \
        twin["perf"]["recover_wire_bytes"] * \
        port["perf"]["recovered_objects"]


def test_counters_and_scrub_match_twin(runs):
    twin, port = runs
    assert port["perf"]["rmw_ops"] == twin["perf"]["rmw_ops"]
    # the same write mode: native host encode, or the fused program
    for key in ("host_encode_launches", "fused_write_launches"):
        assert (port["perf"][key] > 0) == (twin["perf"][key] > 0), key
    assert port["scrub"] == twin["scrub"] == [[]] * 4
    assert port["frames"] > 0


def test_pg_exported_from_the_twin_imports_into_the_port(tmp_path):
    """ceph-objectstore-tool's export / import across packages: one PG
    of the twin's standalone cluster, exported through the twin's
    pg_export, imported through the port's copy into the port's
    cluster by its client write path, reads back equal."""
    objs = _objects(seed=9, n=12)
    twin = JS.StandaloneCluster(n_osds=6, pg_num=4, chunk_size=256)
    try:
        # nothing is killed here: a long grace keeps a loaded CPU from
        # marking live OSDs down, which would leave a PG without primary
        _grace(twin, 60.0)
        cl = twin.client()
        cl.write(objs)
        ps = cl.osdmap.object_to_pg(1, "obj00")[1]
        summary = JX.export_pg(_ExportView(twin), ps,
                               str(tmp_path / "pg.export"))
    finally:
        twin.shutdown()
    carried = {n for n in objs if _pg_of(twin, n) == ps}
    assert summary["objects"] == len(carried) > 0
    port = TS.StandaloneCluster(n_osds=6, pg_num=4, chunk_size=256,
                                device="cpu")
    try:
        _grace(port, 60.0)
        cl = port.client()
        view = _ImportView(port, cl)
        got = TX.import_objects(view, str(tmp_path / "pg.export"))
        assert got["objects"] == len(carried)
        assert cl.read_many(sorted(carried)) == {n: objs[n]
                                                 for n in carried}
        with pytest.raises(FileExistsError):
            TX.import_objects(view, str(tmp_path / "pg.export"))
    finally:
        port.shutdown()


def _pg_of(c, name):
    return c.mons[0].osdmap.object_to_pg(1, name)[1]


def _primary_backend(c, ps):
    osdmap = c.mons[0].osdmap
    primary = osdmap.pg_to_up_acting_osds(1, ps)[2][0]
    return c.osds[primary].backends.get(ps)


class _ExportView:
    """export_pg's view of a standalone cluster: each PG's primary
    backend (its stores are RemoteStore proxies over the wire)."""

    def __init__(self, c):
        self.profile = c.profile
        self.pgs = {ps: _primary_backend(c, ps) for ps in range(c.pg_num)}
        self._c = c

    def _dead_osds(self):
        return {o for o, d in self._c.osds.items() if d._stop.is_set()}


class _ImportView:
    """import_objects' view: placement from the client's map, the
    existence check on the primary's backend, writes by the client."""

    def __init__(self, c, client):
        self._c, self._cl = c, client

    def locate(self, name):
        return self._cl.osdmap.object_to_pg(1, name)[1]

    @property
    def pgs(self):
        # a PG no op has reached yet has no backend and no objects
        empty = types.SimpleNamespace(object_sizes={})
        return {ps: _primary_backend(self._c, ps) or empty
                for ps in range(self._c.pg_num)}

    def write(self, objects):
        self._cl.write({n: np.asarray(d, np.uint8).tobytes()
                        for n, d in objects.items()})


def test_cluster_without_a_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.StandaloneCluster(n_osds=3, pg_num=1)


def test_heartbeats_survive_a_slow_start(monkeypatch):
    """Daemons that take longer to build than a heartbeat interval (as
    on a card) keep their heartbeat threads: the roster is empty, not
    missing, until every daemon exists."""
    build = TS.OSDDaemon.__init__

    def slow(self, *args, **kw):
        build(self, *args, **kw)
        time.sleep(0.4)          # longer than hb_interval
    monkeypatch.setattr(TS.OSDDaemon, "__init__", slow)
    c = TS.StandaloneCluster(n_osds=3, pg_num=1, hb_interval=0.1,
                             device="cpu")
    try:
        time.sleep(0.3)
        assert all(d._hb.is_alive() for d in c.osds.values())
        assert all(m._hb.is_alive() for m in c.mons)
    finally:
        c.shutdown()


def _homeless_client(c, homeless_calls, **run_kw):
    """A client of `c` whose first `homeless_calls` primary lookups find
    no primary (as while a live primary is marked down), and whose
    _run_ops takes `run_kw`."""
    cl = c.client()
    primary, run = cl._primary, cl._run_ops
    calls = {"n": 0}

    def lookup(ps):
        calls["n"] += 1
        if calls["n"] <= homeless_calls:
            raise ConnectionError(f"pg 1.{ps} has no acting primary")
        return primary(ps)
    cl._primary = lookup
    cl._run_ops = lambda ops, **kw: run(ops, **run_kw)
    return cl, calls


def test_homeless_ops_wait_for_a_map_with_a_primary():
    """An op whose PG has no primary in the client's map for more rounds
    than its retry budget waits for a map with one (the Objecter's
    homeless ops) instead of failing; the write and the read are exact."""
    c = TS.StandaloneCluster(n_osds=3, pg_num=1, device="cpu")
    try:
        c.wait_for_clean(timeout=60)
        cl, calls = _homeless_client(c, 20, retries=5, retry_sleep=0.01)
        cl.write({"o": b"x" * 3000})
        assert calls["n"] > 20
        assert cl.read("o") == b"x" * 3000
    finally:
        c.shutdown()


def test_homeless_ops_fail_once_the_map_stalls():
    """A PG that stays without a primary while no newer map comes fails
    its op within the retry budget once `timeout` has passed."""
    c = TS.StandaloneCluster(n_osds=3, pg_num=1, device="cpu")
    try:
        c.wait_for_clean(timeout=60)
        cl, calls = _homeless_client(c, 10 ** 9, timeout=0.2, retries=3,
                                     retry_sleep=0.01)
        t0 = time.monotonic()
        with pytest.raises(ConnectionError, match="no acting primary"):
            cl.write({"o": b"x" * 3000})
        assert time.monotonic() - t0 < 10
        assert calls["n"] > 3
    finally:
        c.shutdown()


def test_a_shard_that_missed_writes_while_suspected_catches_up():
    """A write acked while a live member was suspected skips its shard.
    Once the suspicion clears, the primary replays the missed objects
    onto it and only then reports the PG clean; a deep scrub then reads
    every shard."""
    c = TS.StandaloneCluster(n_osds=4, pg_num=1, device="cpu")
    try:
        c.wait_for_clean(timeout=60)
        cl = c.client()
        cl.write({"a": b"a" * 3000})
        prim = next(d for d in c.osds.values() if 0 in d.backends)
        be = prim.backends[0]
        slot = 1
        other = be.acting[slot]
        with prim._lock:
            prim.suspect.add(other)
        cl.write({"b": b"b" * 2000, "a": b"c" * 1000})
        assert be.shard_applied[slot] < be.pg_log.head
        with prim._lock:
            prim.suspect.discard(other)
        c.wait_for_clean(timeout=60)
        assert be.shard_applied[slot] == be.pg_log.head
        assert cl.read_many(["a", "b"]) == {"a": b"c" * 1000,
                                            "b": b"b" * 2000}
        rep = cl.deep_scrub(0)
        assert rep["inconsistent"] == []
        assert rep["checked"] == 2 * be.n
    finally:
        c.shutdown()


def test_a_stalled_heartbeat_thread_reports_no_live_peer():
    """An OSD whose own heartbeat thread blocks past the grace (here on
    a PG lock, as behind a recovery batch) sent no pings meanwhile: it
    reports none of its live peers failed when it resumes, since a peer
    fails only on a ping it left unanswered for longer than the grace.
    A peer that stops answering is still reported."""
    c = TS.StandaloneCluster(n_osds=3, pg_num=1, hb_interval=0.1,
                             hb_grace=0.5, device="cpu")
    try:
        c.wait_for_clean(timeout=60)
        d = c.osds[0]
        reported = []
        note = d.repair_policy.note_suspect

        def record(osd):
            reported.append(osd)
            note(osd)
        d.repair_policy.note_suspect = record
        with d._pg_lock(0):
            time.sleep(1.5)       # the beat's reconcile waits here
        time.sleep(0.6)
        assert reported == [] and not d._reported
        c.kill_osd(2)
        t_end = time.monotonic() + 10
        while 2 not in reported and time.monotonic() < t_end:
            time.sleep(0.05)
        assert reported == [2]
    finally:
        c.shutdown()


def test_a_rebuild_short_of_helpers_by_suspicion_retries_with_them():
    """A primary that suspects a live helper (a store op that timed out
    under load) as it folds each map after a kill plans the rebuild
    with too few helpers. It clears the suspicion of the peers its map
    holds up, and a heartbeat's reconcile plans again with them: the PG
    recovers once the maps go quiet, and every byte reads back."""
    c = TS.StandaloneCluster(n_osds=5, pg_num=1, hb_interval=0.1,
                             device="cpu")
    try:
        c.wait_for_clean(timeout=60)
        cl = c.client()
        cl.write({"a": b"a" * 3000, "b": b"b" * 1000})
        prim = next(d for d in c.osds.values() if 0 in d.backends)
        acting = list(prim.backends[0].acting)
        helper, victim = acting[1], acting[2]
        adopt, reconcile = prim._adopt_map_locked, prim._reconcile_pg
        folding, injected = [], []

        def fold(newmap):
            folding.append(newmap.epoch)
            try:
                return adopt(newmap)
            finally:
                folding.pop()

        def suspect_on_fold(ps, new_plans):
            # each map fold after the victim's down mark suspects the
            # helper just before the PG's rebuild is planned
            if folding and not prim.osdmap.osd_up[victim]:
                injected.append(prim.osdmap.epoch)
                prim.suspect.add(helper)
            return reconcile(ps, new_plans)
        prim._adopt_map_locked = fold
        prim._reconcile_pg = suspect_on_fold
        for d in c.osds.values():
            d.config.set("osd_heartbeat_grace", 1.0, level="override")
        c.kill_osd(victim)
        c.wait_for_down(victim, timeout=30)
        c.wait_for_clean(timeout=30)
        assert injected
        assert victim not in prim.backends[0].acting
        assert cl.read_many(["a", "b"]) == {"a": b"a" * 3000,
                                            "b": b"b" * 1000}
    finally:
        c.shutdown()
