"""The port's store tier (ceph_tpu_torch.kv, osd.tinstore, native) held
against its twin on the CPU: a TinDB and a TinStore written by one
package mount and read in the other, both ways, after a clean umount and
after a crash (WAL replay), compressed blobs included; the native host
library's CRC32C against the oracle; the `native` EC plugin's bytes
against the twin's `native` and the port's `tpu_rs`, and its refusal of
a card device. Tolerance: none."""

from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu import kv as JK
from ceph_tpu.osd import tinstore as JS
from ceph_tpu_torch import kv as TK
from ceph_tpu_torch import native as TN
from ceph_tpu_torch.csum.reference import ceph_crc32c
from ceph_tpu_torch.osd import tinstore as TS
from ceph_tpu_torch.osd.memstore import Transaction as TTxn
from ceph_tpu_torch.utils import nvcc

PKGS = {"twin": (JK, JS), "port": (TK, TS)}
DIRECTIONS = [("twin", "port"), ("port", "twin")]


def _kv_writes(db, rng):
    for i in range(40):
        t = db.transaction()
        for j in range(8):
            t.set("O", f"k{i:03d}.{j}".encode(),
                  rng.integers(0, 256, 64 + i, np.uint8).tobytes())
        if i % 5 == 0:
            t.rmkey("O", f"k{i - 1:03d}.0".encode())
        t.set("M", f"m{i}".encode(), bytes([i]) * i)
        db.submit_transaction(t)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("end", ["umount", "crash"])
def test_tindb_written_by_one_package_mounts_in_the_other(
        tmp_path, writer, reader, end):
    path = str(tmp_path / "db")
    db = PKGS[writer][0].TinDB(path, memtable_max_bytes=4096)
    _kv_writes(db, np.random.default_rng(5))
    want = {p: list(db.iterate(p)) for p in ("O", "M")}
    assert db.segment_stats()["segments"] > 0    # flushed segments too
    db.umount() if end == "umount" else db.crash()
    other = PKGS[reader][0].TinDB(path, memtable_max_bytes=4096)
    assert {p: list(other.iterate(p)) for p in ("O", "M")} == want
    assert other.get("M", b"m7") == bytes([7]) * 7
    other.umount()
    assert PKGS[reader][0].TinDB.fsck(path)["errors"] == []


def _store_writes(st, txn_cls, rng, n=12):
    objs = {}
    t = txn_cls()
    t.create_collection("1.0s0")
    st.queue_transaction(t)
    for i in range(n):
        name = f"obj{i}"
        if i % 3 == 0:       # compressible: a seeded block repeated
            data = np.tile(rng.integers(0, 256, 512, np.uint8), 16)
        else:
            data = rng.integers(0, 256, 3000 + 97 * i, np.uint8)
        t = txn_cls()
        t.write("1.0s0", name, 0, data)
        t.setattr("1.0s0", name, "hinfo", bytes([i, 7]))
        t.omap_set("1.0s0", name, {b"k": bytes([i])})
        st.queue_transaction(t)
        objs[name] = data
    t = txn_cls()
    t.remove("1.0s0", "obj4")
    st.queue_transaction(t)
    objs.pop("obj4")
    return objs


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("compression", [None, "zlib"])
def test_tinstore_written_by_one_package_mounts_in_the_other(
        tmp_path, writer, reader, compression):
    from ceph_tpu.osd.memstore import Transaction as JTxn
    txn = {"twin": JTxn, "port": TTxn}
    path = str(tmp_path / "osd.0")
    kw = dict(cache_bytes=32 << 10, compression=compression,
              compression_min_blob=64)
    st = PKGS[writer][1].TinStore(path, **kw)
    objs = _store_writes(st, txn[writer], np.random.default_rng(9))
    if compression:
        assert st.compress_stats["compressed_blobs"] > 0
        assert st.compress_stats["stored_bytes"] < \
            st.compress_stats["logical_bytes"]
    st.crash()                                   # only the files survive
    other = PKGS[reader][1].TinStore(path, **kw)
    assert other.list_collections() == ["1.0s0"]
    assert other.list_objects("1.0s0") == sorted(objs)
    for name, data in objs.items():
        assert np.array_equal(other.read("1.0s0", name), data), name
        assert other.getattr("1.0s0", name, "hinfo") == \
            bytes([int(name[3:]), 7])
        assert dict(other.collections["1.0s0"][name].omap) == \
            {b"k": bytes([int(name[3:])])}
    other.umount()
    report = PKGS[reader][1].TinStore.fsck(path)
    assert report["errors"] == [], report


def test_native_library_is_the_ports_own_build():
    path = Path(TN.build())
    assert path.parent == nvcc.BUILD_DIR
    assert path == nvcc.library_path(TN._SRC, flags=nvcc.HOST_FLAGS)
    assert TN.ready() and TN.crc32c_hw() in (True, False)
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 256, (5, 1000), np.uint8)
    for seed in (0, 0xFFFFFFFF, 12345):
        assert TN.native_crc32c(seed, rows[0]) == ceph_crc32c(seed, rows[0])
        assert TN.native_crc32c_rows(seed, rows).tolist() == \
            [ceph_crc32c(seed, r) for r in rows]
    assert TK.host_crc32c(b"123456789") == ceph_crc32c(0xFFFFFFFF,
                                                       b"123456789")
    assert "gf256" in TN.version()
    assert TN.erasure_code_init("tpu") == 0


def test_native_build_failure_raises_and_leaves_nothing(tmp_path):
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on ec_tpu.cpp"):
        nvcc.build(TN._SRC, tmp_path, lambda: "false",
                   flags=nvcc.HOST_FLAGS, label="g++")
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("profile", [
    "plugin=native k=4 m=2", "plugin=native k=8 m=3",
    "plugin=native k=6 m=3 technique=cauchy_good"])
def test_native_plugin_matches_twin_and_tpu_rs(profile):
    import ceph_tpu.native  # noqa: F401 — registers the twin's plugin
    from ceph_tpu.ec.registry import factory as jfactory
    from ceph_tpu_torch.ec.registry import factory as tfactory
    jc = jfactory(profile)
    tc = tfactory(profile, device="cpu")
    rs = tfactory(profile.replace("plugin=native", "plugin=jerasure"),
                  device="cpu")
    assert type(tc).__module__ == "ceph_tpu_torch.native"
    assert np.array_equal(tc.matrix, jc.matrix)
    k, m = tc.k, tc.m
    data = np.random.default_rng(k * m).integers(0, 256, (3, k, 640),
                                                 np.uint8)
    parity = tc.encode_chunks(torch.from_numpy(data))
    assert isinstance(parity, torch.Tensor) and parity.dtype == torch.uint8
    assert np.array_equal(parity.numpy(), jc.encode_chunks(data))
    assert torch.equal(parity, rs.encode_chunks(torch.from_numpy(data)))
    full = {i: data[:, i, :] for i in range(k)}
    full.update({k + j: parity.numpy()[:, j, :] for j in range(m)})
    lost = [0, k] if m > 1 else [0]
    have = {c: torch.from_numpy(v) for c, v in full.items()
            if c not in lost}
    got = tc.decode_chunks(lost, have)
    want = jc.decode_chunks(lost, {c: v.numpy() for c, v in have.items()})
    for e in lost:
        assert torch.equal(got[e], torch.from_numpy(full[e]))
        assert np.array_equal(got[e].numpy(), np.asarray(want[e]))
    obj = np.random.default_rng(1).integers(0, 256, 5000, np.uint8)
    enc = tc.encode(range(k + m), obj)
    assert all(torch.equal(enc[i], v) for i, v in
               rs.encode(range(k + m), obj).items())


def test_native_plugin_refuses_a_card_device(monkeypatch):
    from ceph_tpu_torch.ec.registry import factory
    with pytest.raises(ValueError, match="native plugin runs on the host"):
        TN.NativeReedSolomon({"k": "4", "m": "2"}, device="cuda:0")
    with pytest.raises(ValueError, match="native plugin runs on the host"):
        factory("plugin=native k=4 m=2", device="cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        factory("plugin=native k=4 m=2")
