"""The port's CephFS client (FsClient: the namespace, file I/O at
offsets, truncate, rename, dirfrag split and merge, caps, du and quota)
held against the JAX package's on the CPU, each over its own package's
librados and SimCluster (the port's with device="cpu"), at RS k=4 m=2
and k=8 m=3: every returned byte string, stat, listing, frag info,
exception (class and message) and the Objecter's counters, then every
OSD's shards, xattrs and omap and the object-class KV plane that holds
the dirfrags (torch_client_helpers). Tolerance: none."""

import numpy as np
import pytest

from torch_client_helpers import PROFILES, counters, payload, run_both

SPLIT = 6      # frag_split_threshold; merges under 2


def _fs(S, c, name="fsclient"):
    r = S.rados.Rados(c)
    return r, S.fs.FsClient(r.open_ioctx(), name=name,
                            frag_split_threshold=SPLIT,
                            frag_merge_threshold=2)


def seq_namespace_and_io(S, c, rec):
    rng = np.random.default_rng(21)
    r, fs = _fs(S, c)
    rec("mkdir", fs.mkdir, "/a")
    rec("mkdir nested", fs.mkdir, "/a/b")
    rec("mkdir again", fs.mkdir, "/a")
    rec("mkdir under a missing dir", fs.mkdir, "/x/y")
    rec("create", fs.create, "/a/f", payload(rng, 3000))
    rec("create again", fs.create, "/a/f")
    rec("create empty", fs.create, "/a/b/e")
    rec("write at an offset", fs.write, "/a/f", payload(rng, 1234),
        offset=2500)
    rec("write past a stripe unit", fs.write, "/a/b/e",
        payload(rng, 5000), offset=(1 << 16) - 1000)
    rec("read", fs.read, "/a/f")
    rec("read range", fs.read, "/a/f", length=700, offset=2222)
    rec("read sparse", fs.read, "/a/b/e", length=2000,
        offset=(1 << 16) - 1500)
    rec("stat", lambda: {k: v for k, v in fs.stat("/a/f").items()
                         if k != "mtime"})
    rec("readdir", lambda: sorted(fs.readdir("/a")))
    rec("read a dir", fs.read, "/a")
    rec("truncate shrink", fs.truncate, "/a/f", 1000)
    rec("read truncated", fs.read, "/a/f")
    rec("truncate grow", fs.truncate, "/a/f", 4000)
    rec("read regrown", fs.read, "/a/f")
    rec("rename", fs.rename, "/a/f", "/a/b/g")
    rec("read renamed", fs.read, "/a/b/g")
    rec("read old name", fs.read, "/a/f")
    rec("rename a dir over a file", fs.rename, "/a/b", "/a/b/g")
    rec("rmdir non-empty", fs.rmdir, "/a/b")
    rec("unlink a dir", fs.unlink, "/a/b")
    rec("unlink", fs.unlink, "/a/b/g")
    rec("unlink", fs.unlink, "/a/b/e")
    rec("rmdir", fs.rmdir, "/a/b")
    rec("readdir", lambda: sorted(fs.readdir("/a")))
    with fs.open("/a/h", "w") as f:
        rec("handle write", f.write, payload(rng, 900), offset=10)
    rec("caps after close", fs.caps_info, "/a/h")
    r2, other = _fs(S, c, name="other")
    h = fs.open("/a/h", "w")
    rec("open held by another mount", other.open, "/a/h", "w")
    rec("caps held", fs.caps_info, "/a/h")
    rec("break caps", other.break_caps, "/a/h", "fsclient")
    with other.open("/a/h", "r") as f:
        rec("handle read", f.read)
    rec("stale handle write", h.write, b"late")
    rec.note("counters", counters(r))


def seq_dirfrags_and_quota(S, c, rec):
    rng = np.random.default_rng(22)
    r, fs = _fs(S, c)
    fs.mkdir("/big")
    names = [f"file{i:03d}" for i in range(3 * SPLIT)]
    for n in names:
        rec(f"create {n}", fs.create, f"/big/{n}", payload(rng, 100))
    rec("frag_info after growth", fs.frag_info, "/big")
    rec("readdir", lambda: sorted(fs.readdir("/big")))
    rec("read one", fs.read, "/big/file007")
    for n in names[:-1]:
        rec(f"unlink {n}", fs.unlink, f"/big/{n}")
    rec("frag_info after shrink", fs.frag_info, "/big")
    rec("readdir", lambda: sorted(fs.readdir("/big")))
    fs.mkdir("/q")
    rec("set_quota", fs.set_quota, "/q", max_bytes=5000, max_files=3)
    rec("bad quota", fs.set_quota, "/q", max_bytes=-1)
    rec("get_quota", fs.get_quota, "/q")
    rec("create in quota", fs.create, "/q/a", payload(rng, 3000))
    rec("write past max_bytes", fs.write, "/q/a", payload(rng, 3000),
        offset=3000)
    rec("create 2", fs.create, "/q/b")
    rec("create 3", fs.create, "/q/c")
    rec("create past max_files", fs.create, "/q/d")
    rec("du /q", fs.du, "/q")
    rec("du /", fs.du, "/")
    rec("clear quota", fs.set_quota, "/q")
    rec("create after clearing", fs.create, "/q/d", payload(rng, 10))
    rec("du /q", fs.du, "/q")
    rec.note("counters", counters(r))


SEQUENCES = {"namespace_and_io": seq_namespace_and_io,
             "dirfrags_and_quota": seq_dirfrags_and_quota}


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_fs_sequence_matches_twin(name, profile):
    run_both(SEQUENCES[name], PROFILES[profile])


def test_each_package_registers_its_classes_in_its_own_registry():
    # both packages are imported here: the fs and rgw modules of each
    # register their object classes in that package's own objclass
    import ceph_tpu.fs.client  # noqa: F401
    import ceph_tpu.rgw.gateway  # noqa: F401
    import ceph_tpu_torch.fs.client  # noqa: F401
    import ceph_tpu_torch.rgw.gateway  # noqa: F401
    from ceph_tpu.osd import objclass as J
    from ceph_tpu_torch.osd import objclass as T
    assert J._CLS is not T._CLS and sorted(J._CLS) == sorted(T._CLS)
    for key, fn in T._CLS.items():
        assert fn.__module__.startswith("ceph_tpu_torch."), key
        assert J._CLS[key].__module__.startswith("ceph_tpu."), key
    for cls in ("fs_dir", "fs_meta", "rgw_index"):
        assert any(k[0] == cls for k in T._CLS), cls


def _write_state(S, c, rng) -> dict:
    """The twin's side of the carry-over: an RBD image with a snapshot,
    an RGW bucket with a multipart object and a CephFS tree."""
    io = S.rados.Rados(c).open_ioctx()
    rbd = S.rbd.RBD(io, stripe_unit=4096, stripe_count=4,
                    object_size=16384)
    img = rbd.create("vm", 64 << 10)
    want = {"head": payload(rng, 64 << 10)}
    img.write(0, want["head"])
    img.snap_create("s1")
    want["s1"] = want["head"]
    patch = payload(rng, 4096)
    img.write(5000, patch)
    want["head"] = want["head"][:5000] + patch + want["head"][9096:]
    gw = S.gateway.Gateway(io)
    gw.create_bucket("bkt")
    gw.put_object("bkt", "small", payload(rng, 777))
    up = gw.initiate_multipart("bkt", "multi")
    parts = [payload(rng, 5000 + i) for i in range(3)]
    for i, part in enumerate(parts):
        gw.upload_part("bkt", "multi", up, i + 1, part)
    gw.complete_multipart("bkt", "multi", up)
    want["multi"] = b"".join(parts)
    fs = S.fs.FsClient(io, frag_split_threshold=SPLIT,
                       frag_merge_threshold=2)
    fs.mkdir("/d")
    for i in range(2 * SPLIT):
        fs.create(f"/d/f{i}", payload(rng, 100 + i))
    fs.write("/d/f3", payload(rng, 3000), offset=70000)
    return want


def _read_state(S, c, rec) -> None:
    io = S.rados.Rados(c).open_ioctx()
    rbd = S.rbd.RBD(io, stripe_unit=4096, stripe_count=4,
                    object_size=16384)
    img = rec("open image", S.rbd.Image, rbd, "vm")
    rec("image head", img.read, 0, 64 << 10)
    rec("snaps", img.snap_list)
    img.set_snap("s1")
    rec("image at s1", img.read, 0, 64 << 10)
    gw = S.gateway.Gateway(io)
    rec("buckets", gw.list_buckets)
    rec("listing", gw.list_objects, "bkt")
    rec("multipart object", gw.get_object, "bkt", "multi")
    rec("small object", gw.get_object, "bkt", "small")
    fs = S.fs.FsClient(io, frag_split_threshold=SPLIT,
                       frag_merge_threshold=2)
    rec("readdir", lambda: sorted(fs.readdir("/d")))
    rec("frag_info", fs.frag_info, "/d")
    rec("files", lambda: [fs.read(f"/d/f{i}") for i in range(2 * SPLIT)])
    rec("du", fs.du, "/")


def _overwrite_kill_recover(S, c, rec) -> None:
    rng = np.random.default_rng(42)
    io = S.rados.Rados(c).open_ioctx()
    rbd = S.rbd.RBD(io, stripe_unit=4096, stripe_count=4,
                    object_size=16384)
    img = S.rbd.Image(rbd, "vm")
    rec("overwrite", img.write, 20001, payload(rng, 4096))
    victim = c.osdmap.pg_to_up_acting_osds(
        1, c.locate("rbd_data.vm.0000000000000001"))[3]
    c.kill_osd(victim)
    rec("degraded image read", img.read, 16384, 8192)
    c.tick(30.0)
    c.tick(60.0)
    rec("weight", lambda: int(c.osdmap.osd_weight[victim]))
    rec("image after recovery", img.read, 0, 64 << 10)
    img.set_snap("s1")
    rec("s1 after recovery", img.read, 0, 64 << 10)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_state_written_by_the_twin_reads_back_through_the_port(profile):
    from ceph_tpu_torch.osd.cluster import cluster_from_snapshot
    from torch_client_helpers import (Recorder, assert_same_state,
                                      cluster_snapshot, new_cluster, stack)
    J, T = stack("ceph_tpu"), stack("ceph_tpu_torch")
    jc = new_cluster(J, PROFILES[profile])
    want = _write_state(J, jc, np.random.default_rng(41))
    tc = cluster_from_snapshot(cluster_snapshot(jc), device="cpu")
    assert tc.device.type == "cpu" and tc.pgs[0].device.type == "cpu"
    assert_same_state(jc, tc)
    logs = []
    for S, c in ((J, jc), (T, tc)):
        rec = Recorder()
        _read_state(S, c, rec)
        logs.append(rec.log)
    assert logs[1] == logs[0]
    got = dict((label, value) for label, value in logs[1])
    assert got["image head"] == ("bytes", want["head"])
    assert got["image at s1"] == ("bytes", want["s1"])
    assert got["multipart object"] == ("bytes", want["multi"])
    logs = []
    for S, c in ((J, jc), (T, tc)):
        rec = Recorder()
        _overwrite_kill_recover(S, c, rec)
        logs.append(rec.log)
    assert logs[1] == logs[0]
    assert all(entry[1] != "raised" for entry in logs[1]), logs[1]
    assert dict(logs[1])["weight"] == 0
    assert_same_state(jc, tc)
