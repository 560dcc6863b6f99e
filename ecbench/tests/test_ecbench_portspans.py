"""The port-span readings: attribution of device entries to the port's
spans and the naming of idle gaps on a synthetic trace, the new metrics
only in their cells of a traced tiny run, the breakdown's keys, and no
reading from a port without the span capture (CPU, tiny sizes)."""

import types

import pytest

from ecbench import harness as H
from ecbench import portspans as P
from ecbench.tests.helpers import CELLS, run_tiny

NEW = {"fold_ms.recover", "fold_roofline.recover", "kernels_per_op",
       "port_host_us_per_op"}
TID = 4242


def rec(i, parent, name, a, b, tid=TID, **tags):
    return types.SimpleNamespace(id=i, parent=parent, name=name,
                                 start_ns=a, end_ns=b, tid=tid, tags=tags)


def synthetic():
    """One op of the recovery program, a collection inside its fold, a
    span of another thread, and the loop's own spans."""
    records = [
        rec(2, 1, "ecbackend.recover_program.decode", 110, 200),
        rec(3, 2, "gf_apply", 120, 190, B=2),
        rec(5, 4, "python.gc", 230, 330, generation=0),
        rec(4, 1, "ecbackend.recover_program.fold", 210, 400,
            bytes_in=3000, bytes_out=1000),
        rec(6, 1, "csum.crc32c", 410, 480),
        rec(1, None, "ecbackend.recover_program", 100, 500, B=2, H=3,
            rl=500),
        rec(7, None, "gf_apply", 0, 10_000, tid=99),    # another thread
    ]
    # (name, start, end, correlation id); launches {corr: (start, end)}
    device = [("gf", 1000, 1100, 1), ("clone", 1100, 1150, 2),
              ("xor", 1400, 1500, 3), ("crc", 1500, 1560, 4),
              ("memset", 1560, 1561, 5), ("cat", 1600, 1610, 6),
              ("lost", 1610, 1620, 7)]
    launches = {1: (150, 160), 2: (220, 225), 3: (340, 345),
                4: (420, 430), 5: (415, 418), 6: (495, 505)}
    harness = [("submit", 90, 510), ("wait", 520, 2000)]
    own = [("Activity Buffer Request", 1120, 1160)]
    return records, device, launches, harness, own


def test_attribution_and_named_gaps_on_a_synthetic_trace():
    records, device, launches, harness, own = synthetic()
    r = P.attribute(records, device, launches, harness, ops=1,
                    window_s=1e-6, tid=TID, own=own)
    assert r.by_span == {
        "gf_apply": [pytest.approx(100e-9), 1],
        "ecbackend.recover_program.fold": [pytest.approx(150e-9), 2],
        "csum.crc32c": [pytest.approx(61e-9), 2],
        "ecbackend.recover_program": [pytest.approx(10e-9), 1]}
    assert r.attributed == 6 and r.unlinked == 1
    # the cat's runtime call (495-505) runs past its span's end (500)
    assert r.outside == 1
    assert r.attributed_s == pytest.approx(321e-9)
    assert r.device_s == pytest.approx(331e-9)
    assert r.fold_bytes == 4000
    assert r.outer_host_s == pytest.approx(400e-9)    # not gc, not tid 99
    assert r.gc == [1, pytest.approx(100e-9)]
    # the gaps 1150-1400 and 1561-1600 fall in the loop's wait, no port
    # span open; the profiler's buffer request overlaps the first
    assert r.gaps == [["wait:-", pytest.approx(250e-9),
                       "Activity Buffer Request"],
                      ["wait:-", pytest.approx(39e-9), ""]]


def test_gaps_take_the_innermost_port_span_and_the_harness_span():
    records, *_ = synthetic()
    spans = [(x.start_ns, x.end_ns, x) for x in records if x.tid == TID]
    # device idle from 240 (inside python.gc inside the fold) to 300,
    # from 405 (between fold and crc) to 415, from 600 to 700
    device = [("a", 0, 240), ("b", 300, 405), ("c", 415, 600),
              ("d", 700, 800)]
    harness = [("submit", 90, 510), ("wait", 520, 650)]
    gaps = P.named_gaps(device, spans, harness, [], top=10)
    assert gaps == [["wait:-", pytest.approx(100e-9), ""],
                    ["submit:python.gc", pytest.approx(60e-9), ""],
                    ["submit:ecbackend.recover_program",
                     pytest.approx(10e-9), ""]]


def test_innermost_sweep_matches_a_brute_force():
    records, *_ = synthetic()
    spans = [(x.start_ns, x.end_ns, x) for x in records if x.tid == TID]
    times = list(range(0, 600, 7))
    got = P.innermost(spans, times)
    for t, g in zip(times, got):
        inside = [s for s in spans if s[0] <= t <= s[1]]
        want = max(inside, key=lambda s: (s[0], -s[1]))[2] if inside \
            else None
        assert g is want, t


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_lists_the_new_metrics_only_in_their_cells(cell):
    out = run_tiny(cell, trace=True)
    man = H.manifest()
    mine = {m["name"] for m in man["per_layer"]
            if m["name"] in NEW and cell in m["workloads"]}
    assert set(out["metrics"]) & NEW <= mine
    # the host-clock reading comes from the capture, on a CPU too; the
    # device readings need a card
    assert "port_host_us_per_op" in out["metrics"]
    assert out["metrics"]["port_host_us_per_op"]["value"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["correct"]


def test_the_new_entries_read_their_cells():
    man = H.manifest()
    by = {m["name"]: m for m in man["per_layer"]}
    assert set(by["fold_ms.recover"]["workloads"]) == \
        set(by["fold_roofline.recover"]["workloads"]) == \
        {"rs-recover", "clay-repair"}
    assert set(by["kernels_per_op"]["workloads"]) == \
        set(by["port_host_us_per_op"]["workloads"]) == set(CELLS)
    for name in NEW:
        assert callable(H.reader(name))


def test_a_port_without_the_capture_gives_no_reading(monkeypatch):
    from ceph_tpu_torch.utils import tracing
    monkeypatch.delattr(tracing, "Capture")
    out = run_tiny("rs-recover", trace=True)
    assert not set(out["metrics"]) & NEW and out["correct"]
