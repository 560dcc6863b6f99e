"""The port's EC runtime server (ceph_tpu_torch.native.server) held to its
twin (ceph_tpu.native.server) on the CPU.

The same raw frames go to a twin server and a port server (the port's
on `device="cpu"`): ping, encodes and decodes at RS k=4 m=2 and k=8
m=3, a short frame, a bad magic, an unknown op, a decode whose survivors
cannot invert. Every response's bytes and both servers' `requests_handled`
and `errors` counters must be equal. Then the port's native shim forwards
to the port's server (`set_runtime_socket`), and its encodes and decodes
must equal its own CPU codec's with the socket unset, the server having
served them.
"""

import os
import socket
import struct
import tempfile

import numpy as np
import pytest
import torch

from ceph_tpu.native import server as JS
from ceph_tpu_torch import native as TN
from ceph_tpu_torch.ec.matrices import reed_sol_van_matrix
from ceph_tpu_torch.native import server as TS


def _frame(op, k=0, m=0, chunk_len=0, batch=0, erasures=(),
           survivors=(), matrix=b"", payload=b"", magic=TS.MAGIC):
    body = TS._HDR.pack(magic, op, k, m, len(erasures), chunk_len, batch)
    body += np.asarray(erasures, "<i4").tobytes()
    body += np.asarray(survivors, "<i4").tobytes()
    return body + bytes(matrix) + bytes(payload)


def _frames():
    rng = np.random.default_rng(20)
    out = [("ping", _frame(TS.OP_PING))]
    for k, m, L, B in ((4, 2, 512, 3), (8, 3, 4096, 2)):
        mat = reed_sol_van_matrix(k, m)
        data = rng.integers(0, 256, (B, k, L), np.uint8)
        out.append((f"encode {k}+{m}",
                    _frame(TS.OP_ENCODE, k, m, L, B, matrix=mat.tobytes(),
                           payload=data.tobytes())))
        lost = [1, k]                 # a data chunk and the first parity
        alive = [i for i in range(k + m) if i not in lost][:k]
        shards = rng.integers(0, 256, (B, k, L), np.uint8)
        out.append((f"decode {k}+{m}",
                    _frame(TS.OP_DECODE, k, m, L, B, erasures=lost,
                           survivors=alive, matrix=mat.tobytes(),
                           payload=shards.tobytes())))
    out += [("short", b"\x01\x02\x03"),
            ("magic", _frame(TS.OP_PING, magic=0xDEADBEEF)),
            ("op", _frame(7, 4, 2, 16, 1, matrix=bytes(8),
                          payload=bytes(64))),
            ("singular", _frame(TS.OP_DECODE, 2, 2, 8, 1, erasures=[0],
                                survivors=[1, 1], matrix=bytes(4),
                                payload=bytes(16)))]
    return out


def _exchange(srv_cls, **kw):
    path = os.path.join(tempfile.mkdtemp(), "ec.sock")
    srv = srv_cls(path, **kw)
    replies = {}
    with srv:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.connect(path)
        with conn:
            for label, body in _frames():
                conn.sendall(struct.pack("<I", len(body)) + body)
                n = struct.unpack("<I", _recv(conn, 4))[0]
                replies[label] = _recv(conn, n)
    return replies, srv.requests_handled, srv.errors


def _recv(conn, n):
    buf = b""
    while len(buf) < n:
        got = conn.recv(n - len(buf))
        assert got, "server closed the connection"
        buf += got
    return buf


@pytest.fixture(scope="module")
def exchanges():
    return _exchange(JS.ECRuntimeServer), \
        _exchange(TS.ECRuntimeServer, device="cpu")


@pytest.mark.parametrize("label", [label for label, _ in _frames()])
def test_response_bytes_match_twin(exchanges, label):
    (twin, _, _), (port, _, _) = exchanges
    assert port[label] == twin[label]
    status = port[label][4]
    assert status == (0 if label.split()[0] in ("ping", "encode", "decode")
                      else 1)


def test_counters_match_twin(exchanges):
    (_, twin_handled, twin_errors), (_, handled, errors) = exchanges
    assert (handled, errors) == (twin_handled, twin_errors) == (7, 4)


def test_wire_constants_match_twin():
    assert (TS.MAGIC, TS.OP_PING, TS.OP_ENCODE, TS.OP_DECODE) == \
        (JS.MAGIC, JS.OP_PING, JS.OP_ENCODE, JS.OP_DECODE)
    assert TS._HDR.format == JS._HDR.format


def test_shim_forwards_to_the_port_server_and_matches_its_cpu_codec():
    try:
        TN.build()
    except TN.NativeUnavailable as e:
        pytest.fail(f"the native library does not build here: {e}")
    rng = np.random.default_rng(21)
    path = os.path.join(tempfile.mkdtemp(), "ec.sock")
    coder = TN.NativeReedSolomon({"k": "8", "m": "3"}, device="cpu")
    data = rng.integers(0, 256, (4, 8, 1024), np.uint8)
    full_lost = [0, 9]
    with TS.ECRuntimeServer(path, device="cpu") as srv:
        TN.set_runtime_socket(path)
        try:
            assert TN.runtime_ping()
            parity = np.asarray(coder.encode_chunks(data))
            full = np.concatenate([data, parity], axis=1)
            rec = coder.decode_chunks(
                full_lost, {i: full[:, i] for i in range(11)
                            if i not in full_lost})
            served = srv.requests_handled
        finally:
            TN.set_runtime_socket(None)
        assert served >= 3                 # ping, encode, decode
        assert np.array_equal(np.asarray(coder.encode_chunks(data)), parity)
        assert srv.requests_handled == served   # the CPU codec, alone
    cpu = coder.decode_chunks(full_lost, {i: full[:, i] for i in range(11)
                                          if i not in full_lost})
    for i in full_lost:
        assert np.array_equal(np.asarray(rec[i]), full[:, i])
        assert np.array_equal(np.asarray(cpu[i]), full[:, i])


def test_server_without_a_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.ECRuntimeServer(str(tmp_path / "ec.sock"))
