"""The port's one-process-an-OSD mode (ceph_tpu_torch.osd.multiproc:
every OSD daemon a real OS process, SIGKILL its failure; monitors and
clients in the test process) held to its twin (ceph_tpu.osd.multiproc)
on the CPU.

The twin's tier-1 smoke sequence runs through both packages, one cluster
after the other (3 child processes, cephx, TinStores, RS k=2 m=1): a
numpy-seeded write, the reads, the admin socket, two service-secret
rotations with IO between them, each child's online fsck. After the
shutdown (a SIGKILL of every child) each OSD's TinStore directory of
both runs is remounted here, and every OSD's client objects and hinfo
attrs must be equal. The port's children must report the CPU as their
device and answer the port-only `launches` line.

Then a MemStore child is SIGKILLed at 4 OSDs (its RAM, its shards, are
gone): after the down mark the survivors rebuild the lost shards, the
reads and every PG's deep scrub (each live shard's CRC32C against the
hinfo written with it) must be the twin's. Every wait has its own
timeout, and the heartbeat grace and the timeouts are scaled by the
host's load as the twin's tests scale theirs; the graces are longer
than the twin's 1.2 s (10 s where nothing is killed, 4 s for the kill),
since a boot storm (ROADMAP queue 3) would move placement between the
two runs.
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu.osd import standalone as JS
from ceph_tpu_torch.chaos.thrasher import load_factor
from ceph_tpu_torch.osd import multiproc as M
from ceph_tpu_torch.osd import standalone as TS
from ceph_tpu_torch.osd.tinstore import TinStore

ROOT = Path(__file__).resolve().parents[1]
LF = load_factor()
PROFILE = "plugin=tpu_rs k=2 m=1 impl=bitlinear"
HINFO = "hinfo_key"
SECRET = b"\x5a" * 32


def _objects(seed, n):
    # ragged sizes of one shard length (four 256-byte chunks a shard), so
    # each of the twin's children compiles few XLA programs
    rng = np.random.default_rng(seed)
    return {f"mp-{i:02d}": rng.integers(
        0, 256, int(rng.integers(1537, 2049)), np.uint8).tobytes()
        for i in range(n)}


def _cluster(S, n_osds, store, grace, store_dir=None, **kw):
    # `grace` is the heartbeat grace before the host's load scales it:
    # children that import torch or JAX at once answer pings late on a
    # busy CPU, and a live OSD marked down would change the placement
    # the comparisons below hold equal (ROADMAP queue 3)
    return S.StandaloneCluster(
        n_osds=n_osds, pg_num=2, store=store, store_dir=store_dir,
        osd_procs=True, op_shards=2, cephx=True, secret=SECRET,
        profile=PROFILE, hb_grace=grace * LF, **kw)


def _remounted(path, names):
    """{(collection, name): (bytes, hinfo)} of the client objects in the
    TinStore directory `path`, remounted from its WAL."""
    st = TinStore(str(path))
    try:
        return {(cid, name): (st.read(cid, name).tobytes(),
                              st.getattr(cid, name, HINFO))
                for cid in st.list_collections()
                for name in st.list_objects(cid) if name in names}
    finally:
        st.umount()


def _boot_rw(S, root, **kw):
    """The twin's test_multiproc_boot_rw_smoke sequence, its results."""
    objs = _objects(seed=13, n=8)
    rot = np.random.default_rng(14).integers(0, 256, 1024,
                                             np.uint8).tobytes()
    c = _cluster(S, 3, "tin", 10.0, str(root / "osds"), **kw)
    out = {}
    try:
        c.wait_for_clean(timeout=40 * LF)
        cl = c.client()
        cl.write(objs)
        out["reads"] = {n: bytes(cl.read(n)) for n in sorted(objs)}
        h = c.osds[0]
        out["frames_rx"] = h.asok("perf dump")["msgr"]["frames_rx"] > 0
        out["op_shards"] = sorted(h.asok("dump_op_shards"))
        # rotated secrets cross each child's control pipe; IO flows
        # between the two rotations and after them
        c.rotate_service_secrets("osd")
        cl.write({"mp-rot": rot})
        c.rotate_service_secrets("osd")
        out["rot"] = bytes(cl.read("mp-rot")) == rot
        out["fsck"] = {}
        for o, d in c.osds.items():
            rep = d.store_fsck()
            out["fsck"][o] = (rep["errors"], rep["bad_objects"],
                              rep["extent_errors"], rep["format"],
                              rep["objects"] > 0)
        if S is TS:
            out["devices"] = {d.device for d in c.osds.values()}
            out["launches"] = {o: d.launches() for o, d in c.osds.items()}
    finally:
        c.shutdown()
    names = set(objs) | {"mp-rot"}
    out["stores"] = {o: _remounted(root / "osds" / f"osd.{o}", names)
                     for o in range(3)}
    return out


@pytest.fixture(scope="module")
def boot_rw(tmp_path_factory):
    twin = _boot_rw(JS, tmp_path_factory.mktemp("twin"))
    port = _boot_rw(TS, tmp_path_factory.mktemp("port"), device="cpu")
    return twin, port


def test_boot_rw_reads_and_rotations_match_twin(boot_rw):
    twin, port = boot_rw
    assert port["reads"] == twin["reads"] == {
        n: v for n, v in _objects(seed=13, n=8).items()}
    for key in ("frames_rx", "op_shards", "rot"):
        assert port[key] == twin[key], key
    assert port["op_shards"] == ["shard_0", "shard_1"]
    assert port["frames_rx"] and port["rot"]


def test_online_fsck_is_clean_in_every_child(boot_rw):
    twin, port = boot_rw
    assert port["fsck"] == twin["fsck"]
    assert set(port["fsck"]) == {0, 1, 2}
    for errors, bad, extent, fmt, some in port["fsck"].values():
        assert errors == bad == extent == [] and some
        assert fmt in ("kv", "legacy")


def test_children_report_the_cpu_and_answer_launches(boot_rw):
    _, port = boot_rw
    assert port["devices"] == {"cpu"}
    for counts in port["launches"].values():
        # the CPU runs the kernels' plain versions: nothing is launched
        assert counts["gf_apply"] == {"launches": 0, "by_shape": {}}
        assert set(counts["csum"]) == {"launches", "shapes"}


def test_remounted_stores_match_twin(boot_rw):
    twin, port = boot_rw
    assert port["stores"].keys() == twin["stores"].keys()
    for o in port["stores"]:
        assert port["stores"][o] == twin["stores"][o], o
    held = {n for st in port["stores"].values() for _cid, n in st}
    assert held == set(_objects(seed=13, n=8)) | {"mp-rot"}
    # every object has its k + m = 3 shards, one an OSD
    assert sum(len(st) for st in port["stores"].values()) == 3 * len(held)


def _acting(osdmap, name):
    return osdmap.pg_to_up_acting_osds(1, osdmap.object_to_pg(1, name)[1])[2]


def _kill_rebuild(S, **kw):
    objs = _objects(seed=15, n=12)
    c = _cluster(S, 4, "mem", 4.0, **kw)
    out = {}
    try:
        c.wait_for_clean(timeout=60 * LF)
        cl = c.client()
        cl.write(objs)
        victim = max(c.osd_ids())
        out["on_victim"] = sorted(n for n in objs
                                  if victim in _acting(cl.osdmap, n))
        c.kill_osd(victim)
        c.wait_for_down(victim, timeout=40 * LF)
        c.wait_for_clean(timeout=90 * LF)
        out["victim"] = victim
        out["reads"] = {n: bytes(cl.read(n)) for n in sorted(objs)}
        # each live shard's CRC32C against the hinfo written with it: the
        # rebuilt shards' bytes are the written ones
        out["scrub"] = [{key: rep[key] for key in ("checked",
                                                   "inconsistent")}
                        for rep in map(cl.deep_scrub, range(c.pg_num))]
        out["placed"] = {n: _acting(cl.osdmap, n) for n in objs}
    finally:
        c.shutdown()
    return out


def test_sigkilled_memstore_child_is_rebuilt_as_in_the_twin():
    twin = _kill_rebuild(JS)
    port = _kill_rebuild(TS, device="cpu")
    assert port == twin
    assert port["reads"] == _objects(seed=15, n=12)
    assert port["on_victim"]          # shards that had to be rebuilt
    assert all(port["victim"] not in acting
               for acting in port["placed"].values())
    assert sum(rep["checked"] for rep in port["scrub"]) == 3 * 12
    assert all(rep["inconsistent"] == [] for rep in port["scrub"])


def _handle(tmp_path, argv):
    """A parent-side handle of osd.0 over the child process `argv`, its
    stderr in `tmp_path` as a cluster's child's is in the admin dir."""
    cluster = types.SimpleNamespace(admin_dir=str(tmp_path), device="cpu")
    h = M.OSDProcHandle.__new__(M.OSDProcHandle)
    h.c, h.osd_id, h.name = cluster, 0, "osd.0"
    h.msgr = M._HandleMsgr(h)
    with open(h.stderr_path, "ab") as err:
        h._proc = subprocess.Popen(argv, stdin=subprocess.PIPE,
                                   stdout=subprocess.PIPE, stderr=err,
                                   cwd=ROOT, text=True)
    h._stop = M._ProcStop(h._proc)
    return h


def test_a_child_that_dies_at_boot_is_reported_with_its_stderr(tmp_path):
    h = _handle(tmp_path, [sys.executable, "-m",
                           "ceph_tpu_torch.osd.multiproc"])
    try:
        h._proc.stdin.write("{not json\n")     # the config line
        h._proc.stdin.flush()
        with pytest.raises(TimeoutError, match="JSONDecodeError"):
            h.wait_ready(timeout=60 * LF)
    finally:
        h.kill()
    assert "Traceback" in open(h.stderr_path).read()


def test_a_child_on_another_device_fails_at_boot(tmp_path):
    ready = json.dumps({"event": "ready", "addr": ["127.0.0.1", 1],
                        "device": "cuda:0"})
    h = _handle(tmp_path, [sys.executable, "-c",
                           f"print({ready!r}, flush=True); "
                           f"import sys; sys.stdin.read()"])
    try:
        with pytest.raises(RuntimeError, match="runs on cuda:0, the "
                                               "cluster on cpu"):
            h.wait_ready(timeout=60 * LF)
        assert h._stop.is_set() and h._proc.poll() is not None
    finally:
        h.kill()


def test_cluster_of_processes_without_a_device_raises_without_cuda(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.StandaloneCluster(n_osds=3, pg_num=1, osd_procs=True)
