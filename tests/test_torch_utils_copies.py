"""The port's copies of JAX-free modules stay copies of the twin's, and
what they write the twin reads (and back): the byte codec, the PG log,
the stripe-journal entries, the repair planner's choices over the two
coders, the perf counters and the tracing span."""

from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as JR
from ceph_tpu.osd import ecbackend as JB
from ceph_tpu.osd import pglog as JL
from ceph_tpu.osd import repairplan as JP
from ceph_tpu.utils import encoding as JE
from ceph_tpu_torch.ec import registry as TR
from ceph_tpu_torch.osd import ecbackend as TB
from ceph_tpu_torch.osd import pglog as TL
from ceph_tpu_torch.osd import repairplan as TP
from ceph_tpu_torch.utils import encoding as TE
from ceph_tpu_torch.utils import perf_counters as TC
from ceph_tpu_torch.utils import tracing as TT

ROOT = Path(__file__).resolve().parents[1]
COPIES = ["utils/perf_counters.py", "utils/profiler.py",
          "utils/flight_recorder.py", "utils/encoding.py",
          "mgr/tracing.py", "osd/memstore.py", "osd/pglog.py",
          "osd/repairplan.py", "crush/hash.py", "crush/ln48.py",
          "crush/map.py", "crush/oracle.py", "utils/log.py",
          "utils/config.py", "utils/op_tracker.py", "mon/monitor.py",
          "osd/peering.py", "osd/scheduler.py", "osd/objclass.py",
          "mgr/pg_autoscaler.py", "crush/compiler.py", "mgr/balancer.py",
          "kv/interface.py", "kv/tindb.py", "kv/__init__.py",
          "osd/tinstore.py", "utils/throttle.py", "client/__init__.py",
          "client/objecter.py", "client/rados.py", "client/rbd.py",
          "fs/__init__.py", "fs/client.py", "rgw/__init__.py",
          "rgw/gateway.py", "rgw/auth.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_twin_source(rel):
    # every import in these modules is package-relative, so a copy that
    # stayed a copy is the twin's text byte for byte
    assert (ROOT / "ceph_tpu_torch" / rel).read_bytes() == \
        (ROOT / "ceph_tpu" / rel).read_bytes()


@pytest.mark.parametrize("enc,dec", [(TE, JE), (JE, TE)],
                         ids=["port-to-twin", "twin-to-port"])
def test_encoding_round_trips_across_packages(enc, dec):
    e = enc.Encoder().start(2, 1)
    e.u8(7).u16(513).u32(0xDEADBEEF).u64(1 << 40).i64(-5).string("obj")
    e.blob(b"\x00\xff").list([1, 2, 3], enc.Encoder.u32)
    raw = e.finish().bytes()
    d = dec.Decoder(raw)
    d.start(2)
    assert (d.u8(), d.u16(), d.u32(), d.u64(), d.i64(), d.string(),
            d.blob(), d.list(dec.Decoder.u32)) == \
        (7, 513, 0xDEADBEEF, 1 << 40, -5, "obj", b"\x00\xff", [1, 2, 3])
    d.finish()


def test_stripe_journal_entries_match_twin():
    args = (9, "obj1", 2, [0, 4, 5], 900, 256, 256, 3, b"hello",
            0x12345678, 17)
    raw = TB.ECBackend._encode_jentry(*args)
    assert raw == JB.ECBackend._encode_jentry(*args)
    assert TB.ECBackend._decode_jentry(raw) == \
        JB.ECBackend._decode_jentry(raw)
    assert TB.ECBackend._jkey(9) == JB.ECBackend._jkey(9)


def test_pglog_encodes_like_twin():
    jl, tl = JL.PGLog(max_entries=4), TL.PGLog(max_entries=4)
    for name in ("a", "b", "a", "c", "d", "e"):
        jl.append(name)
        tl.append(name)
    assert tl.encode() == jl.encode()
    back = TL.PGLog.decode(jl.encode())
    assert (back.head, back.tail, back.missing_since(3)) == \
        (jl.head, jl.tail, jl.missing_since(3))


@pytest.mark.parametrize("lost", [[1], [0, 9], [3, 8, 10]])
def test_repair_planner_chooses_like_twin(lost):
    profile = "plugin=jerasure technique=reed_sol_van k=8 m=3"
    port, twin = TR.factory(profile, device="cpu"), JR.factory(profile)
    avail = [s for s in range(11) if s not in lost]
    costs = {s: (s * 7) % 5 for s in avail}
    tp = TP.plan_repair(port, lost, avail, costs=costs)
    jp = JP.plan_repair(twin, lost, avail, costs=costs)
    assert (sorted(tp.helpers), tp.family) == (sorted(jp.helpers), jp.family)
    assert TP.plan_read(port, list(range(8)), avail) == \
        JP.plan_read(twin, list(range(8)), avail)


def test_crc_shift_and_rows_crc0_match_twin():
    rng = np.random.default_rng(3)
    for reg, n in ((0xFFFFFFFF, 5), (0x1234, 4093), (0, 9), (7, 0)):
        assert TB._crc_shift(reg, n) == JB._crc_shift(reg, n)
    rows = rng.integers(0, 256, (3, 13), dtype=np.uint8)
    np.testing.assert_array_equal(TB._rows_crc0(rows, "cpu"),
                                  JB._rows_crc0(rows))
    np.testing.assert_array_equal(TB._rows_crc32c(rows, "cpu"),
                                  JB._rows_crc32c(rows))


def test_ec_counters_are_the_twins_less_streaming():
    port = set(TB.ec_perf_counters().dump())
    twin = set(JB.ec_perf_counters().dump())
    assert port == twin - {"stream_launches", "stream_bytes",
                           "stream_drain_time"}


def test_span_times_into_counters_and_shows_in_the_profiler():
    perf = (TC.PerfCountersBuilder("t_torch_span")
            .add_time_avg("lat", "span wall time").create_perf_counters())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with TT.span("ecbackend.write.encode", counters=perf, key="lat"):
            torch.ones(4).sum()
    assert perf.dump()["lat"]["avgcount"] == 1
    names = {e.key for e in prof.key_averages()}
    assert "ecbackend.write.encode" in names


def test_trace_captures_a_span_into_a_chrome_trace(tmp_path):
    # the twin's start_trace / stop_trace / trace over torch.profiler:
    # True on a capture, False with none running or one already running
    import json
    assert TT.stop_trace() is False
    assert TT.start_trace(str(tmp_path / "a")) is True
    assert TT.start_trace(str(tmp_path / "b")) is False
    with TT.span("mesh.gather_apply"):
        torch.ones(4).sum()
    assert TT.stop_trace() is True
    assert TT.stop_trace() is False
    with TT.trace(str(tmp_path / "c")) as ok:
        assert ok is True
        with TT.span("mesh.encode"):
            torch.ones(4).sum()
    for sub, name in (("a", "mesh.gather_apply"), ("c", "mesh.encode")):
        (path,) = (tmp_path / sub).glob("*.pt.trace.json")
        events = json.loads(path.read_text())["traceEvents"]
        assert name in {e.get("name") for e in events}
    assert not (tmp_path / "b").exists()
