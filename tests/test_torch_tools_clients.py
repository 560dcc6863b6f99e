"""The port's client and store tools held to their JAX twins on the CPU.

`ceph_tpu_torch.tools.{rados_cli,rbd_cli,objectstore_tool}` against
`tools/{rados_cli,rbd_cli,objectstore_tool}.py`: one command sequence
through each package (the port's with `--device cpu`), each package in
a directory of its own with relative paths, so exit codes, stdout and
every written file compare byte for byte. These tools print no host
clock. The cross-package cases: a state file, an export file and a
TinStore directory written by one package's tool (or store) are read by
the other's.
"""

import hashlib
import pickle
import shutil

import numpy as np
import pytest

from torch_tools_helpers import port_tool, run, twin_tool

CPU = ["--device", "cpu"]
MiB = 1 << 20


class _NoGlobals(pickle.Unpickler):
    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"state refers to {module}.{name}")


def plain_state(path):
    """A state file holds only bytes, ints, strings, lists and dicts:
    it unpickles with no class of any package (a tensor or an array
    would name its module)."""
    with open(path, "rb") as f:
        return _NoGlobals(f).load()


def run_seq(name, seq, tmp_path, monkeypatch, stdin=None):
    """Each command of `seq` through both packages, each in tmp/<pkg>;
    returns {pkg: [(rc, out, err), ...]}."""
    res = {}
    for pkg, mod, extra in (("twin", twin_tool(name), []),
                            ("port", port_tool(name), CPU)):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        res[pkg] = [run(mod, extra + argv,
                        stdin=stdin if "-" in argv[-2:] else None)
                    for argv in seq]
    return res


def assert_same(res, seq):
    for argv, t, p in zip(seq, res["twin"], res["port"]):
        assert (t[0], t[1]) == (p[0], p[1]), argv
        if t[0]:
            assert t[2] == p[2], argv


# -- rados --------------------------------------------------------------------

def _payloads(tmp_path):
    rng = np.random.default_rng(7)
    blobs = {"big": rng.integers(0, 256, MiB, np.uint8).tobytes(),
             "odd": rng.integers(0, 256, 70_001, np.uint8).tobytes()}
    for pkg in ("twin", "port"):
        (tmp_path / pkg).mkdir()
        for n, b in blobs.items():
            (tmp_path / pkg / f"{n}.bin").write_bytes(b)
    return blobs


RADOS = [["--state", "s", "put", "obj1", "big.bin"],
         ["--state", "s", "put", "obj2", "-"],
         ["--state", "s", "put", "obj3", "odd.bin"],
         ["--state", "s", "ls"],
         ["--state", "s", "stat", "obj1"],
         ["--state", "s", "stat", "obj2"],
         ["--state", "s", "get", "obj1", "obj1.out"],
         ["--state", "s", "get", "obj3", "-"],
         ["--state", "s", "rm", "obj2", "obj3"],
         ["--state", "s", "ls"],
         ["--state", "s", "get", "obj2", "x.out"],
         ["--state", "s", "stat", "nope"],
         ["ls"]]


def test_rados_sequence_and_files_are_the_twins(tmp_path, monkeypatch):
    blobs = _payloads(tmp_path)
    res = run_seq("rados_cli", RADOS, tmp_path, monkeypatch,
                  stdin=blobs["odd"][::-1])
    assert_same(res, RADOS)
    port = res["port"]
    assert port[3][1] == b"obj1\nobj2\nobj3\n"
    assert port[5][1] == f"obj2 mtime n/a, size {len(blobs['odd'])}\n".encode()
    assert port[7][1] == blobs["odd"]                     # get to stdout
    assert port[9][1] == b"obj1\n" and port[10][0] == 1
    for pkg in ("twin", "port"):
        assert (tmp_path / pkg / "obj1.out").read_bytes() == blobs["big"]
        assert plain_state(tmp_path / pkg / "s") == {
            "objects": {"obj1": blobs["big"]}}


@pytest.mark.parametrize("writer", ["twin", "port"])
def test_rados_state_crosses_packages(writer, tmp_path, monkeypatch):
    """A state file written by one package's rados is read, extended
    and written back by the other's, and the writer reads it again."""
    blobs = _payloads(tmp_path)
    tools = {"twin": (twin_tool("rados_cli"), []),
             "port": (port_tool("rados_cli"), CPU)}
    reader = "port" if writer == "twin" else "twin"
    monkeypatch.chdir(tmp_path / writer)
    mod, extra = tools[writer]
    assert run(mod, extra + ["--state", "s", "put", "a", "big.bin"])[0] == 0
    shutil.copy(tmp_path / writer / "s", tmp_path / reader / "s")
    monkeypatch.chdir(tmp_path / reader)
    mod, extra = tools[reader]
    rc, out, _ = run(mod, extra + ["--state", "s", "get", "a", "-"])
    assert rc == 0 and out == blobs["big"]
    assert run(mod, extra + ["--state", "s", "put", "b", "odd.bin"])[0] == 0
    shutil.copy(tmp_path / reader / "s", tmp_path / writer / "s")
    monkeypatch.chdir(tmp_path / writer)
    mod, extra = tools[writer]
    rc, out, _ = run(mod, extra + ["--state", "s", "get", "b", "-"])
    assert rc == 0 and out == blobs["odd"]
    assert run(mod, extra + ["--state", "s", "ls"])[1] == b"a\nb\n"


# -- rbd ----------------------------------------------------------------------

RBD = [["create", "vm1", "--size", "2M"],
       ["import", "disk.raw", "vm3"],
       ["snap", "create", "vm3@gold"],
       ["snap", "protect", "vm3@gold"],
       ["clone", "vm3@gold", "vm2"],
       ["children", "vm3@gold"],
       ["ls", "-l"],
       ["info", "vm2"],
       ["snap", "ls", "vm3"],
       ["resize", "vm1", "--size", "1M"],
       ["export", "vm2", "clone.raw"],
       ["flatten", "vm2"],
       ["export", "vm2", "flat.raw"],
       ["export", "vm3", "gold.raw", "--snap", "gold"],
       ["diff", "vm3"],
       ["diff", "vm3", "--from-snap", "gold"],
       ["export-diff", "vm3", "full.diff"],
       ["import-diff", "full.diff", "vm1"],
       ["export", "vm1", "vm1.raw"],
       ["snap", "rm", "vm3@gold"],
       ["snap", "unprotect", "vm3@gold"],
       ["snap", "rollback", "vm3@gold"],
       ["snap", "rm", "vm3@gold"],
       ["rm", "vm1"],
       ["info", "vm1"],
       ["clone", "vm3", "vm4"],
       ["ls"]]


def test_rbd_sequence_and_files_are_the_twins(tmp_path, monkeypatch):
    disk = np.random.default_rng(9).integers(0, 256, MiB, np.uint8).tobytes()
    for pkg in ("twin", "port"):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / "disk.raw").write_bytes(disk)
    seq = [["--state", "st"] + argv for argv in RBD]
    res = run_seq("rbd_cli", seq, tmp_path, monkeypatch)
    assert_same(res, seq)
    port = res["port"]
    assert port[5][1] == b"vm2\n"
    assert port[14][1] == f"0\t{MiB}\n".encode()        # every extent
    assert port[15][1] == b""                           # none since gold
    assert [r[0] for r in port[-8:]] == [1, 0, 0, 0, 0, 1, 1, 0]
    assert port[-1][1] == b"vm2\nvm3\n"
    files = ("clone.raw", "flat.raw", "gold.raw", "full.diff", "vm1.raw")
    for f in files:
        assert (tmp_path / "twin" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes(), f
    # the host model: a clone and its flattening read the parent's bytes
    for f in ("clone.raw", "flat.raw", "gold.raw", "vm1.raw"):
        assert (tmp_path / "port" / f).read_bytes() == disk, f
    state = plain_state(tmp_path / "port" / "st")
    assert state.keys() == plain_state(tmp_path / "twin" / "st").keys()


@pytest.mark.parametrize("writer", ["twin", "port"])
def test_rbd_state_crosses_packages(writer, tmp_path, monkeypatch):
    disk = np.random.default_rng(5).integers(0, 256, 300_000,
                                             np.uint8).tobytes()
    tools = {"twin": (twin_tool("rbd_cli"), []),
             "port": (port_tool("rbd_cli"), CPU)}
    reader = "port" if writer == "twin" else "twin"
    for pkg in tools:
        (tmp_path / pkg).mkdir()
    (tmp_path / writer / "disk.raw").write_bytes(disk)
    monkeypatch.chdir(tmp_path / writer)
    mod, extra = tools[writer]
    for argv in (["import", "disk.raw", "base"], ["snap", "create", "base@s"],
                 ["snap", "protect", "base@s"], ["clone", "base@s", "kid"]):
        assert run(mod, extra + ["--state", "st"] + argv)[0] == 0, argv
    shutil.copy(tmp_path / writer / "st", tmp_path / reader / "st")
    monkeypatch.chdir(tmp_path / reader)
    mod, extra = tools[reader]
    outs = [run(mod, extra + ["--state", "st"] + argv)
            for argv in (["ls", "-l"], ["info", "kid"], ["snap", "ls", "base"],
                         ["export", "kid", "kid.raw"], ["flatten", "kid"],
                         ["children", "base@s"])]
    assert [o[0] for o in outs] == [0] * 6
    assert outs[0][1] == (b"base\t300000\tsnaps=1\n"
                          b"kid\t300000\tsnaps=0 parent=base@s\n")
    assert (tmp_path / reader / "kid.raw").read_bytes() == disk
    assert outs[5][1] == b""       # flattened: the clone left its parent


# -- ceph-objectstore-tool ----------------------------------------------------

def test_objectstore_demo_and_exports_are_the_twins(tmp_path, monkeypatch):
    seq = [["demo", "--pg", "1", "--file", "pg.export"],
           ["inspect", "pg.export"], ["demo", "--pg", "3", "--file", "p3"],
           ["inspect", "p3"], ["inspect", "missing.export"]]
    res = run_seq("objectstore_tool", seq, tmp_path, monkeypatch)
    assert_same(res, seq)
    out = res["port"][0][1].decode()
    assert "exported degraded pg 1.1: " in out and \
        "objects byte-exact in the destination" in out
    for f in ("pg.export", "p3"):
        assert (tmp_path / "twin" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes()
    # each package inspects the OTHER's export
    shutil.copy(tmp_path / "twin" / "pg.export", tmp_path / "port" / "o")
    shutil.copy(tmp_path / "port" / "pg.export", tmp_path / "twin" / "o")
    cross = run_seq("objectstore_tool", [["inspect", "o"]], tmp_path,
                    monkeypatch)
    assert_same(cross, [["inspect", "o"]])
    assert cross["port"][0][1] == res["port"][1][1]


def _write_store(S, Tx, path, seed):
    """A TinStore with overwrites, truncates, xattrs and omap keys across
    WAL rolls (a small WAL cap), unmounted clean."""
    st = S(str(path), wal_max_bytes=2000)
    rng = np.random.default_rng(seed)
    st.queue_transaction(Tx().create_collection("1.0s0")
                         .create_collection("1.1s2"))
    for i in range(40):
        cid = "1.0s0" if i % 3 else "1.1s2"
        name = f"o{i % 9}"
        data = rng.integers(0, 256, int(rng.integers(1, 5000)), np.uint8)
        st.queue_transaction(
            Tx().write(cid, name, 0, data).truncate(cid, name, len(data))
            .setattr(cid, name, "v", bytes([i]))
            .omap_set(cid, name, {b"k%d" % i: b"x" * (i % 7)}))
    st.umount()


@pytest.mark.parametrize("writer", ["twin", "port"])
def test_objectstore_kv_commands_are_the_twins(writer, tmp_path,
                                               monkeypatch):
    """kv-dump, kv-list, fsck, kv-compact and fsck again over one
    TinStore, written by either package's store, through both tools."""
    if writer == "twin":
        from ceph_tpu.osd.memstore import Transaction
        from ceph_tpu.osd.tinstore import TinStore
    else:
        from ceph_tpu_torch.osd.memstore import Transaction
        from ceph_tpu_torch.osd.tinstore import TinStore
    _write_store(TinStore, Transaction, tmp_path / "store", 11)
    for pkg in ("twin", "port"):
        shutil.copytree(tmp_path / "store", tmp_path / pkg / "store")
    (tmp_path / "twin" / "empty").mkdir()
    (tmp_path / "port" / "empty").mkdir()
    seq = [["kv-dump", "store"], ["kv-list", "store"],
           ["kv-list", "store", "--prefix", "M", "--limit", "7"],
           ["fsck", "store"], ["kv-compact", "store"], ["kv-dump", "store"],
           ["kv-list", "store", "--prefix", "O"], ["fsck", "store"],
           ["kv-dump", "empty"]]
    res = run_seq("objectstore_tool", seq, tmp_path, monkeypatch)
    assert_same(res, seq)
    port = res["port"]
    assert b"(stopped at --limit 7)" in port[2][1]
    assert b'"bad_objects": []' in port[3][1] and port[3][0] == 0
    assert b" -> 1 segment(s), " in port[4][1]
    assert port[-1][0] == 1
    # the compacted stores are the same files
    for f in sorted(p.name for p in (tmp_path / "twin" / "store").iterdir()):
        assert hashlib.sha256((tmp_path / "twin" / "store" / f).read_bytes()
                              ).digest() == hashlib.sha256(
            (tmp_path / "port" / "store" / f).read_bytes()).digest(), f
