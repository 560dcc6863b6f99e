"""The twin's CPU host modes in the port's ECBackend: a CPU backend with
the port's native library built (hardware CRC32C) encodes writes and
RMW parity deltas in the native RS codec and checksums host rows there,
as the twin (ceph_tpu.osd.ecbackend) does on its CPU backend; a card
backend never takes them. Held to the twin's bytes, hinfo and counters
on numpy-seeded inputs; every comparison is exact."""

import types

import numpy as np
import pytest
import torch

from ceph_tpu import native as JN
from ceph_tpu.osd import ecbackend as J
from ceph_tpu_torch import native as TN
from ceph_tpu_torch.osd import ecbackend as T

RS = "plugin=jerasure technique=reed_sol_van"
PG = "1.0"


@pytest.fixture(scope="module")
def host_mode():
    """Both packages' native libraries built, the mode caches cleared;
    True when the host mode is on in both."""
    try:
        TN.build()
        JN.lib()
    except (RuntimeError, OSError) as e:
        pytest.fail(f"the native library did not build: {e}")
    T._native_crc_ready.cache_clear()
    J._host_crc_available.cache_clear()
    on = T._host_crc_available("cpu")
    assert on == J._host_crc_available() == TN.crc32c_hw()
    return on


def _dump(cluster):
    out = {}
    for osd, st in sorted(cluster.stores.items()):
        for cid in st.list_collections():
            for name in st.list_objects(cid):
                try:
                    hinfo = st.getattr(cid, name, J.HINFO_KEY)
                except KeyError:         # the stripe journal's object
                    hinfo = None
                out[(osd, cid, name)] = (st.read(cid, name).tobytes(),
                                         hinfo, tuple(st.omap_iter(cid,
                                                                   name)))
    return out


def test_host_crc_is_available_only_for_the_cpu(host_mode):
    assert T._host_crc_available() is False          # None: the card
    assert T._host_crc_available(torch.device("cuda", 0)) is False
    assert T._host_crc_available("cuda:0") is False
    assert T._host_crc_available("cpu") is host_mode
    assert T._host_crc_available(torch.device("cpu")) is host_mode


@pytest.mark.parametrize("k,m,cs,size", [(4, 2, 256, 900),
                                         (8, 3, 4096, 40000)],
                         ids=["k4m2", "k8m3"])
def test_host_mode_write_delta_recovery_match_twin(host_mode, k, m, cs,
                                                   size):
    assert host_mode, "this host has no hardware CRC32C"
    profile = f"{RS} k={k} m={m}"
    n = k + m
    jb = J.ECBackend(profile, PG, list(range(n)), J.ShardSet(),
                     chunk_size=cs)
    tb = T.ECBackend(profile, PG, list(range(n)), T.ShardSet(),
                     chunk_size=cs, device="cpu")
    rng = np.random.default_rng(k)
    objs = {f"obj{i}": rng.integers(0, 256, size - 11 * i, np.uint8)
            for i in range(5)}
    ops = [("obj1", 3, rng.integers(0, 256, 5, np.uint8)),
           ("obj3", cs + 7, rng.integers(0, 256, cs // 2 + 1, np.uint8))]
    for be in (jb, tb):
        be.write_objects(objs)
        be.write_ranges(ops)
    assert _dump(tb.cluster) == _dump(jb.cluster)
    keys = ("host_encode_launches", "fused_write_launches", "encode_bytes",
            "rmw_delta_launches", "rmw_ops", "rmw_full_fallbacks")
    assert {key: tb.perf.get(key) for key in keys} == \
        {key: jb.perf.get(key) for key in keys}
    assert tb.perf.get("host_encode_launches") > 0
    assert tb.perf.get("fused_write_launches") == 0
    assert tb.perf.get("rmw_delta_launches") > 0
    for be in (jb, tb):
        be.cluster.stores.pop(1)
    cj = jb.recover_shards([1], replacement_osds={1: 40})
    ct = tb.recover_shards([1], replacement_osds={1: 40})
    assert ct == cj and ct["objects"] == len(objs)
    assert _dump(tb.cluster) == _dump(jb.cluster)
    got = tb.read_objects(["obj1", "obj3"])
    want = {name: objs[name].copy() for name in ("obj1", "obj3")}
    for name, off, data in ops:
        want[name][off:off + len(data)] = data
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_runner_detects_the_mode_per_backend_device(host_mode):
    tb = T.ECBackend(f"{RS} k=4 m=2", PG, list(range(6)), T.ShardSet(),
                     chunk_size=256, device="cpu")
    tb.write_objects({"o": np.arange(900, dtype=np.uint8)})
    tb.cluster.stores.pop(0)
    plan = tb.plan_recovery([0], {0: 30})
    assert T.RecoveryRunner([plan]).stats["host_crc"] is host_mode
    assert T.RecoveryRunner([plan], host_crc=False).stats["host_crc"] is \
        False
    # a card backend auto-detects the device mode, and refuses the host
    card = types.SimpleNamespace(be=types.SimpleNamespace(
        device=torch.device("cuda", 0), perf=T.ec_perf_counters()),
        names_by_len={}, dec_fn=None)
    assert T.RecoveryRunner([card]).stats["host_crc"] is False
    with pytest.raises(ValueError, match="host_crc=True needs CPU"):
        T.RecoveryRunner([card], host_crc=True)
