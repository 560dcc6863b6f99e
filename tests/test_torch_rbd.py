"""The port's RBD (images, 4 KiB overwrites at unaligned offsets,
snapshots, clone and flatten, diffs) held against the JAX package's on
the CPU, each over its own package's librados and SimCluster (the
port's with device="cpu"), at RS k=4 m=2 and k=8 m=3: every returned
byte string, size, snap list, listing, exception (class and message)
and the Objecter's counters, then every OSD's shards, xattrs and omap
(torch_client_helpers). Tolerance: none."""

import numpy as np
import pytest

from torch_client_helpers import PROFILES, counters, payload, run_both

# 4 KiB stripe units over 16 KiB objects, 4 objects a set
GEOMETRY = dict(stripe_unit=4096, stripe_count=4, object_size=16384)
IMAGE = 96 << 10


def _rbd(S, c):
    r = S.rados.Rados(c)
    return r, S.rbd.RBD(r.open_ioctx(), **GEOMETRY)


def seq_image_io(S, c, rec):
    rng = np.random.default_rng(11)
    r, rbd = _rbd(S, c)
    img = rec("create", rbd.create, "vm", IMAGE)
    rec("create again", rbd.create, "vm", 1)
    rec("create negative", rbd.create, "bad", -1)
    rec("read unwritten", img.read, 0, 512)
    rec("full write", img.write, 0, payload(rng, IMAGE))
    for i, off in enumerate((1, 4095, 8191 + 333, 16384 - 7, 40001,
                             IMAGE - 4096)):
        rec(f"4 KiB overwrite {i}", img.write, off, payload(rng, 4096))
    rec("write out of bounds", img.write, IMAGE - 100, payload(rng, 200))
    rec("read across objects", img.read, 16000, 9000)
    rec("read past the end", img.read, IMAGE - 1000, 5000)
    rec("read all", img.read, 0, IMAGE)
    rec("resize shrink", img.resize, IMAGE - 10000)
    rec("resize grow", img.resize, IMAGE)
    rec("read regrown", img.read, IMAGE - 12000, 12000)
    rec("size", img.size)
    rec("create second", rbd.create, "vm2", 20000)
    rec("list", rbd.list)
    rec("remove", rbd.remove, "vm2")
    rec("open removed", S.rbd.Image, rbd, "vm2")
    rec("list", rbd.list)
    rec.note("counters", counters(r))


def seq_snapshots(S, c, rec):
    rng = np.random.default_rng(12)
    r, rbd = _rbd(S, c)
    img = rbd.create("vm", IMAGE)
    img.write(0, payload(rng, IMAGE))
    s1 = rec("snap_create s1", img.snap_create, "s1")
    rec("snap_create s1 again", img.snap_create, "s1")
    for off in (5, 20000, 50001):
        rec(f"overwrite at {off}", img.write, off, payload(rng, 4096))
    rec("snap_create s2", img.snap_create, "s2")
    rec("overwrite after s2", img.write, 70000, payload(rng, 4096))
    rec("snap_list", img.snap_list)
    rec("set_snap s1", img.set_snap, "s1")
    rec("read at s1", img.read, 0, IMAGE)
    rec("write at a snap", img.write, 0, b"x")
    rec("set_snap head", img.set_snap, None)
    rec("diff since s1", img.diff_iterate, "s1")
    rec("export_diff since s1", img.export_diff, "s1")
    rec("protect s1", img.snap_protect, "s1")
    rec("remove protected", img.snap_remove, "s1")
    rec("is_protected", img.snap_is_protected, "s1")
    rec("unprotect s1", img.snap_unprotect, "s1")
    rec("rollback to s1", img.snap_rollback, "s1")
    rec("read rolled back", img.read, 0, IMAGE)
    rec("remove s2", img.snap_remove, "s2")
    rec("remove image with snaps", rbd.remove, "vm")
    rec("remove s1", img.snap_remove, "s1")
    rec("snap_list", img.snap_list)
    rec.note("sm_snaps", sorted(c.sm_snaps))
    rec.note("counters", counters(r))


def seq_clone_flatten(S, c, rec):
    rng = np.random.default_rng(13)
    r, rbd = _rbd(S, c)
    base = rbd.create("base", IMAGE)
    base.write(0, payload(rng, IMAGE - 20000))
    base.snap_create("gold")
    rec("clone of an unprotected snap", rbd.clone, "base", "gold", "kid")
    rec("protect", base.snap_protect, "gold")
    kid = rec("clone", rbd.clone, "base", "gold", "kid")
    rec("parent_info", kid.parent_info)
    rec("list_children", rbd.list_children, "base", "gold")
    rec("parent overwritten after the snap", base.write, 100,
        payload(rng, 4096))
    rec("read the clone", kid.read, 0, IMAGE)
    for off in (3, 16384 + 4000, 60000):
        rec(f"clone overwrite at {off}", kid.write, off, payload(rng, 4096))
    rec("read after copy-up", kid.read, 0, IMAGE)
    rec("unprotect with a child", base.snap_unprotect, "gold")
    kid.snap_create("k1")
    rec("flatten with snaps", kid.flatten)
    kid.snap_remove("k1")
    rec("flatten", kid.flatten)
    rec("parent_info after flatten", kid.parent_info)
    rec("list_children after flatten", rbd.list_children, "base", "gold")
    rec("read flattened", kid.read, 0, IMAGE)
    rec("unprotect", base.snap_unprotect, "gold")
    rec("list", rbd.list)
    rec.note("counters", counters(r))


SEQUENCES = {"image_io": seq_image_io, "snapshots": seq_snapshots,
             "clone_flatten": seq_clone_flatten}


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_rbd_sequence_matches_twin(name, profile):
    run_both(SEQUENCES[name], PROFILES[profile])
