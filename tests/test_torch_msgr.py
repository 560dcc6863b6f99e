"""The port's messenger (ceph_tpu_torch.msgr, a copy of the twin's) on
the wire with the twin's (ceph_tpu.msgr): a port endpoint and a twin
endpoint exchange registered messages in both directions over Unix
sockets and loopback TCP, in crc, secure (AES-GCM) and zlib-compressed
modes, and each side decodes the other's frames exactly. The frames the
port writes are the twin's bytes and those of the frozen single-buffer
framing (`legacy_frame`, the oracle of tests/test_msgr_frames.py).
Payloads are numpy-seeded; every comparison is exact.
"""

import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest

from ceph_tpu.msgr import messenger as JM
from ceph_tpu.osd import standalone as JS
from ceph_tpu.utils.encoding import Decoder as JDec
from ceph_tpu_torch.msgr import messenger as TM
from ceph_tpu_torch.osd import standalone as TS
from ceph_tpu_torch.utils.encoding import Decoder as TDec

SECRET = b"0123456789abcdef0123456789abcdef"
KEY = b"K" * 32
TYPE_ID = 0x7C0      # outside every registry's ids (standalone: 0x30-0x4E)


def _blob_message(mod):
    """The same message class, registered in one package's registry."""
    class Blob(mod.Message):
        type_id = TYPE_ID

        def __init__(self, stamp: int, data: bytes, note: str = ""):
            self.stamp, self.data, self.note = stamp, data, note

        def encode_payload(self, e) -> None:
            e.start(1, 1).u64(self.stamp).blob(self.data) \
                .string(self.note).finish()

        @classmethod
        def decode_payload(cls, d):
            d.start(1)
            m = cls(d.u64(), d.blob(), d.string())
            d.finish()
            return m
    return mod.register_message(Blob)


PORT_BLOB, TWIN_BLOB = _blob_message(TM), _blob_message(JM)


def _payloads(seed=5):
    rng = np.random.default_rng(seed)
    return [b"", b"x", rng.integers(0, 256, 3000, np.uint8).tobytes(),
            b"A" * 4096, bytes(200),
            rng.integers(0, 4, 70000, np.uint8).tobytes()]


def _wait_for(pred, timeout=15.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if pred():
            return True
        time.sleep(0.01)
    return False


MODES = {"crc": {}, "secure": {"secret": SECRET},
         "zlib": {"compress": "zlib"},
         "secure-zlib": {"secret": SECRET, "compress": "zlib"}}


@pytest.mark.parametrize("uds", [True, False], ids=["uds", "tcp"])
@pytest.mark.parametrize("mode", list(MODES))
def test_port_and_twin_exchange_frames_both_ways(mode, uds):
    port = TM.Messenger("osd.0", uds=uds, **MODES[mode])
    twin = JM.Messenger("osd.1", uds=uds, **MODES[mode])
    try:
        port.add_peer("osd.1", twin.addr)
        twin.add_peer("osd.0", port.addr)
        at_port, at_twin = [], []
        lock = threading.Lock()

        def keep(into):
            def h(peer, m):
                with lock:
                    into.append((peer, type(m), m.stamp, m.data, m.note))
            return h
        port.register_handler(TYPE_ID, keep(at_port))
        twin.register_handler(TYPE_ID, keep(at_twin))
        # a real frame type of the wire tier too: a store op's envelope
        got_ops = []
        twin.register_handler(JS.MStoreOp.type_id,
                              lambda p, m: got_ops.append(m))
        payloads = _payloads()
        for i, data in enumerate(payloads):
            port.send("osd.1", PORT_BLOB(i, data, f"p{i}"))
            twin.send("osd.0", TWIN_BLOB(100 + i, data[::-1], f"t{i}"))
        port.send("osd.1", TS.MStoreOp(9, True, "readv", payloads[2]))
        assert port.flush("osd.1", timeout=15)
        assert twin.flush("osd.0", timeout=15)
        n = len(payloads)
        assert _wait_for(lambda: len(at_port) == n and len(at_twin) == n
                         and len(got_ops) == 1)
        assert at_twin == [("osd.0", TWIN_BLOB, i, d, f"p{i}")
                           for i, d in enumerate(payloads)]
        assert at_port == [("osd.1", PORT_BLOB, 100 + i, d[::-1], f"t{i}")
                           for i, d in enumerate(payloads)]
        op = got_ops[0]
        assert (type(op), op.req_id, op.kind, op.blob) == \
            (JS.MStoreOp, 9, "readv", payloads[2])
        if "zlib" in mode:
            # both ends offered zlib, so the compressible frames shrank
            assert port.stats.get("tx_compressed", 0) > 0
            assert twin.stats.get("tx_compressed", 0) > 0
    finally:
        port.shutdown()
        twin.shutdown()


def legacy_frame(mod, seq, type_id, payload, comp, box=None):
    """The single-buffer framing of tests/test_msgr_frames.py, on the
    given package's CRC and AEAD box."""
    if comp == mod.COMP_ZLIB and len(payload) >= mod._COMPRESS_MIN:
        packed = zlib.compress(payload, 1)
        if len(packed) < len(payload):
            payload = packed
            type_id |= mod._COMP_FLAG
    plain = struct.pack("<QH", seq, type_id) + payload
    if box is None:
        frame = struct.pack("<I", len(plain)) + plain
        return frame + struct.pack("<I", mod._crc(frame))
    hdr = struct.pack("<I", mod._NONCE + len(plain) + mod._GCM_TAG)
    return hdr + box.seal(plain, hdr)


def capture_frame(mod, seq, type_id, payload, comp, box=None):
    """The bytes the package's _Conn.send_frame puts on a socket."""
    a, b = socket.socketpair()
    try:
        conn = mod._Conn(a, box=box, comp=comp)
        got = bytearray()

        def drain():
            b.settimeout(5)
            try:
                while chunk := b.recv(1 << 16):
                    got.extend(chunk)
            except OSError:
                pass
        t = threading.Thread(target=drain, daemon=True)
        t.start()
        conn.send_frame(seq, type_id, payload)
        a.shutdown(socket.SHUT_WR)
        t.join(10)
        assert not t.is_alive()
        return bytes(got)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("secure", [False, True], ids=["crc", "secure"])
@pytest.mark.parametrize("comp", ["plain", "zlib"])
def test_port_frames_are_the_twins_bytes(comp, secure):
    cid = {"plain": TM.COMP_NONE, "zlib": TM.COMP_ZLIB}[comp]
    for i, payload in enumerate(_payloads(seed=6)):
        boxes = [(mod._SecureBox(KEY, b"cli\x00", b"srv\x00")
                  if secure else None) for mod in (TM, JM, TM)]
        port = capture_frame(TM, 3 + i, TYPE_ID, payload, cid, boxes[0])
        twin = capture_frame(JM, 3 + i, TYPE_ID, payload, cid, boxes[1])
        want = legacy_frame(TM, 3 + i, TYPE_ID, payload, cid, boxes[2])
        assert port == twin == want, i
        # segment lists frame to the same bytes
        cut = len(payload) // 3
        box = TM._SecureBox(KEY, b"cli\x00", b"srv\x00") if secure else None
        assert capture_frame(TM, 3 + i, TYPE_ID,
                             [payload[:cut], b"", payload[cut:]],
                             cid, box) == want, i


def test_messages_decode_across_packages():
    # the wire tier's envelopes: what one package encodes the other
    # decodes field for field, a trace context included
    from ceph_tpu.utils.flight_recorder import TraceContext as JT
    from ceph_tpu_torch.utils.flight_recorder import TraceContext as TT
    cases = [(TS, JS, TDec, JDec, TT), (JS, TS, JDec, TDec, JT)]
    for src, dst, _sd, dd, ctx in cases:
        for cls in ("MStoreOp", "MOSDOp", "MOSDOpReply", "MMgrReport"):
            trace = ctx(0x1234, 0x5678, True, client_lat={1: 0.002})
            msg = getattr(src, cls)(7, True, "write", b"body" * 50,
                                    trace=trace)
            e = src.Encoder()
            msg.encode_payload(e)
            back = getattr(dst, cls).decode_payload(dd(e.bytes()))
            assert (back.req_id, back.ok, back.kind, back.blob) == \
                (7, True, "write", b"body" * 50)
            assert (back.trace.trace_id, back.trace.parent_span_id,
                    back.trace.sampled) == (0x1234, 0x5678, True)
        for cls, args in (("MOSDPing", (12.5,)), ("MOSDFailure", (3, True)),
                          ("MOSDAlive", (4, 9)), ("MMonCollect", (17,))):
            e = src.Encoder()
            getattr(src, cls)(*args).encode_payload(e)
            back = getattr(dst, cls).decode_payload(dd(e.bytes()))
            e2 = dst.Encoder()
            back.encode_payload(e2)
            assert e2.bytes() == e.bytes(), cls
