"""The port's span: free with nothing listening, kept by a capture with
its parent, clock and work tags through the real device programs (CPU,
tiny shapes), out of a sampled flight ring where made with ring=False,
and the collector's runs as `python.gc` spans."""

import gc
import json
import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.osd import ecbackend as EB
from ceph_tpu_torch.utils import flight_recorder as FR
from ceph_tpu_torch.utils import tracing as T

CPU = torch.device("cpu")
RS = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4",
      "m": "2"}


def _boom(*a, **kw):
    raise AssertionError("called with nothing listening")


@pytest.mark.parametrize("ring,tags", [(True, {}),
                                       (False, {"bytes_in": 3})],
                         ids=["ring", "program"])
def test_span_off_reads_no_clock_and_enters_no_profiler_range(ring, tags):
    patched = [(time, "time_ns"), (time, "perf_counter"),
               (threading, "get_native_id"), (T, "_range"),
               (T, "record_function")]
    saved = [getattr(mod, name) for mod, name in patched]
    ran = False
    try:
        for mod, name in patched:
            setattr(mod, name, _boom)
        sp = T.span("ecbackend.recover_program.fold", ring=ring, **tags)
        with sp as inner:
            ran = True
            inner.tag(bytes_out=1)
    finally:
        for (mod, name), v in zip(patched, saved):
            setattr(mod, name, v)
    assert ran and sp is T._OFF and inner is T._OFF and not sp.on


def _nested_ok(recs: list) -> None:
    by_id = {r.id: r for r in recs}
    for r in recs:
        assert r.start_ns <= r.end_ns and r.tid == threading.get_native_id()
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def _tree(recs: list) -> set:
    by_id = {r.id: r for r in recs}
    return {(r.name, by_id[r.parent].name if r.parent else None)
            for r in recs if r.name != T.GC_SPAN}


def test_capture_through_the_fused_write():
    coder = factory(RS, device=CPU)
    mat = coder.matrix.astype(np.uint8).tobytes()
    B, k, m, sl = 3, 4, 2, 64
    fn = EB._fused_write_fn(mat, m, k, coder.impl, sl, B, CPU)
    d = torch.randint(0, 256, (B, k, sl), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1))
    with T.Capture() as cap:
        fn(d)
    recs = [r for r in cap.records if r.name != T.GC_SPAN]
    assert _tree(recs) == {
        ("ecbackend.fused_write", None),
        ("gf_apply", "ecbackend.fused_write"),
        ("csum.crc32c", "ecbackend.fused_write"),
        ("ecbackend.fused_write.hinfo", "ecbackend.fused_write")}
    _nested_ok(recs)
    tags = {r.name: r.tags for r in recs}
    assert tags["ecbackend.fused_write"] == {"bytes": B * k * sl}
    assert tags["gf_apply"] == {"B": B, "k": k, "m": m, "L": sl,
                                "nnz": int(np.count_nonzero(
                                    coder.matrix))}
    assert tags["csum.crc32c"] == {"rows": B * (k + m),
                                   "bytes": B * (k + m) * sl}
    # the records finish innermost first, the program last
    assert recs[-1].name == "ecbackend.fused_write"


@pytest.mark.parametrize("host_crc", [False, True],
                         ids=["device", "host_crc"])
def test_capture_through_the_recovery_program(host_crc):
    coder = factory(RS, device=CPU)
    k, sl, B = 4, 64, 5
    lost, helpers = [0], [1, 2, 3, 4]
    data = torch.randint(0, 256, (B, k, sl), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    rows = torch.cat([data, coder.encode_chunks(data)], dim=1)
    stack = rows[:, helpers].contiguous()
    dec = coder.batch_decoder(lost, helpers)
    fn = EB._build_recover_program(dec, verify=True, host_crc=host_crc)
    H = len(helpers)
    with T.Capture() as cap:
        if host_crc:
            rebuilt, fold = fn(stack)
        else:
            exp = EB._rows_crc32c(stack.reshape(-1, sl).numpy(), "cpu") \
                .reshape(B, H)
            rebuilt, _rcrc, ok = fn(stack, EB._expected_fold_crcs(exp, sl))
            assert bool(ok.all())
    assert torch.equal(rebuilt[:, 0], data[:, 0])
    recs = [r for r in cap.records if r.name != T.GC_SPAN]
    want = {("ecbackend.recover_program", None),
            ("ecbackend.recover_program.decode",
             "ecbackend.recover_program"),
            ("gf_apply", "ecbackend.recover_program.decode"),
            ("ecbackend.recover_program.fold", "ecbackend.recover_program")}
    if not host_crc:
        want |= {("csum.crc32c", "ecbackend.recover_program"),
                 ("ecbackend.recover_program.verify",
                  "ecbackend.recover_program")}
    assert _tree(recs) == want
    _nested_ok(recs)
    tags = {r.name: r.tags for r in recs}
    assert tags["ecbackend.recover_program"] == {"B": B, "H": H, "rl": sl}
    assert tags["ecbackend.recover_program.fold"] == {
        "bytes_in": B * H * sl, "bytes_out": B * sl}


def test_program_spans_stay_out_of_a_sampled_flight_ring(monkeypatch):
    # the backend's device write path, as on the card (no host CRC mode)
    monkeypatch.setattr(EB, "_host_crc_available", lambda device=None:
                        False)
    be = EB.ECBackend("k=4 m=2", "1.0", list(range(6)), EB.ShardSet(),
                      chunk_size=256, device="cpu")
    rec = FR.FlightRecorder("osd.0")
    ctx = FR.TraceContext(FR.new_trace_id(), sampled=True)
    with T.Capture() as cap, FR.activate(ctx, rec):
        be.write_objects({"o": b"x" * 900})
    ring = {s["name"] for s in rec.dump()["spans"]}
    captured = {r.name for r in cap.records}
    assert "ecbackend.write.encode" in ring
    assert {"ecbackend.fused_write", "gf_apply", "csum.crc32c"} \
        <= captured
    assert ring.isdisjoint(captured - {"ecbackend.write.encode"})
    assert all(FR.is_span_declared(n) for n in ring | captured)


def test_ecbackend_declares_its_span_names_without_standalone():
    # each module declares the names of its own sites (the coder modules
    # load as their plugins are asked for)
    import ceph_tpu_torch.ec.clay  # noqa: F401
    for name in ("ecbackend.write.encode", "ecbackend.read.decode",
                 "ecbackend.recover.stage", "ecbackend.recover.launch",
                 "ecbackend.recover.fetch", "ecbackend.recover.writeback",
                 EB.FUSED_WRITE, EB.FUSED_WRITE_HINFO, EB.RECOVER_PROGRAM,
                 EB.RECOVER_DECODE, EB.RECOVER_FOLD, EB.RECOVER_VERIFY,
                 "gf_apply", "csum.crc32c", "ec.clay.encode_chunks",
                 T.GC_SPAN):
        assert FR.is_span_declared(name), name
    assert not FR.is_span_declared("ecbackend.recover.batch")


def test_the_collector_is_a_span_under_capture():
    n_hooks = len(gc.callbacks)
    with T.Capture() as cap:
        assert len(gc.callbacks) == n_hooks + 1
        with T.span("ecbackend.recover_program", ring=False):
            gc.collect()
    assert len(gc.callbacks) == n_hooks
    outer = next(r for r in cap.records
                 if r.name == "ecbackend.recover_program")
    gcs = [r for r in cap.records if r.name == T.GC_SPAN
           and r.tags["generation"] == 2]
    assert gcs and gcs[-1].parent == outer.id
    assert outer.start_ns <= gcs[-1].start_ns <= gcs[-1].end_ns \
        <= outer.end_ns


def test_capture_keeps_only_its_extent_and_nests_captures():
    with T.span("before", ring=False):
        pass
    with T.Capture() as a:
        with T.span("both", ring=False):
            with T.Capture() as b:
                with T.span("inner", ring=False, rows=2):
                    pass
        with T.span("after_b", ring=False):
            pass
    with T.span("after", ring=False):
        pass
    def names(c):
        return [r.name for r in c.records if r.name != T.GC_SPAN]
    assert names(a) == ["inner", "both", "after_b"]
    # a span begun before a capture started is not kept by it
    assert names(b) == ["inner"]
    inner = next(r for r in a.records if r.name == "inner")
    both = next(r for r in a.records if r.name == "both")
    assert inner.parent == both.id and inner.tags == {"rows": 2}


def test_stop_trace_writes_the_span_capture_beside_the_chrome_trace(
        tmp_path):
    assert T.start_trace(str(tmp_path)) is True
    with T.span("ecbackend.fused_write", ring=False, bytes=8):
        torch.ones(4).sum()
    assert T.stop_trace() is True
    (path,) = tmp_path.glob("*.spans.json")
    spans = json.loads(path.read_text())["spans"]
    row = next(s for s in spans if s["name"] == "ecbackend.fused_write")
    assert row["tags"] == {"bytes": 8} and row["parent"] is None
    assert row["start_ns"] <= row["end_ns"]
    (chrome,) = tmp_path.glob("*.pt.trace.json")
    assert "ecbackend.fused_write" in {
        e.get("name") for e in json.loads(chrome.read_text())["traceEvents"]}
