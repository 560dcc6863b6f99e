"""EC runtime server — the card's side of the native shim's IPC hop.

Twin of ceph_tpu/native/server.py. The C++ host library keeps the
reference's dlopen plugin ABI (ref: src/erasure-code/
ErasureCodePlugin.cc ErasureCodePluginRegistry::load resolving
__erasure_code_init), but a CPU shim alone would leave reference-shaped
callers with CPU speed. This server lets the shim forward encode/decode
to a running PyTorch process over a Unix socket; the shim falls back to
its built-in CPU codec whenever the socket is absent, dead, or answers
garbage.

Wire format (little-endian, one length-prefixed frame per op), the
twin's byte for byte:

  request  := u32 body_len, body
  body     := u32 magic(0xEC7B0001) u8 op u8 k u8 m u8 n_era
              i64 chunk_len u32 batch
              i32 erasures[n_era] i32 survivors[k]     (decode only)
              u8 matrix[m*k]                            (coding matrix)
              u8 payload[batch*k*chunk_len]
  ops      := 0 ping | 1 encode | 2 decode
  response := u32 body_len, body := u32 magic u8 status u8 out[...]
  status   := 0 ok | 1 error
  out      := encode: batch*m*chunk_len | decode: batch*n_era*chunk_len

The matrix travels with every request, so the server is stateless per
connection and exotic host-constructed techniques work unchanged
(mirrors ec_create_with_matrix on the C side). The server computes on
its device (`device=None` is the current CUDA device and raises without
one): each request's (batch, k, chunk_len) stack goes to the device
once, through `ops.rs_kernels.make_encoder` (gf_apply on a card), and
its result comes back to the host once.
"""

from __future__ import annotations

import os
import socket
import struct
import threading

import numpy as np
import torch

MAGIC = 0xEC7B0001
OP_PING, OP_ENCODE, OP_DECODE = 0, 1, 2

_HDR = struct.Struct("<IBBBBqI")  # magic, op, k, m, n_era, chunk_len, batch


def _recv_exact(conn: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        got = conn.recv(n - len(buf))
        if not got:
            return None
        buf += got
    return bytes(buf)


class ECRuntimeServer:
    """Threaded Unix-socket server executing EC ops on `device` (the
    current CUDA device when None)."""

    def __init__(self, path: str, device=None):
        from ..ec.interface import resolve_device
        self.device = resolve_device(device)
        self.path = path
        self.requests_handled = 0
        self.errors = 0
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if os.path.exists(path):
            os.unlink(path)
        self._sock.bind(path)
        self._sock.listen(8)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ECRuntimeServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            # poke the accept loop awake
            poker = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            poker.settimeout(0.2)
            poker.connect(self.path)
            poker.close()
        except OSError:
            pass
        self._thread.join(timeout=5)
        self._sock.close()
        if os.path.exists(self.path):
            os.unlink(self.path)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- serving ------------------------------------------------------------

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            if self._stop.is_set():
                conn.close()
                break
            t = threading.Thread(target=self._handle_conn, args=(conn,),
                                 daemon=True)
            t.start()

    def _handle_conn(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                raw_len = _recv_exact(conn, 4)
                if raw_len is None:
                    return
                body = _recv_exact(conn, struct.unpack("<I", raw_len)[0])
                if body is None:
                    return
                try:
                    reply = self._dispatch(body)
                    status = 0
                except Exception as e:  # malformed frame / bad geometry
                    self.errors += 1
                    reply = str(e).encode()[:200]
                    status = 1
                out = struct.pack("<IB", MAGIC, status) + reply
                conn.sendall(struct.pack("<I", len(out)) + out)

    def _dispatch(self, body: bytes) -> bytes:
        if len(body) < _HDR.size:
            raise ValueError("short frame")
        magic, op, k, m, n_era, chunk_len, batch = _HDR.unpack_from(body)
        if magic != MAGIC:
            raise ValueError("bad magic")
        self.requests_handled += 1
        if op == OP_PING:
            return b"pong"
        off = _HDR.size
        erasures = survivors = None
        if op == OP_DECODE:
            erasures = np.frombuffer(body, "<i4", n_era, off)
            off += 4 * n_era
            survivors = np.frombuffer(body, "<i4", k, off)
            off += 4 * k
        matrix = np.frombuffer(body, np.uint8, m * k, off).reshape(m, k)
        off += m * k
        payload = np.frombuffer(body, np.uint8, batch * k * chunk_len, off)
        stack = payload.reshape(batch, k, chunk_len)

        from ..gf.numpy_ref import decode_matrix
        from ..ops.rs_kernels import make_encoder
        if op == OP_ENCODE:
            fn = make_encoder(matrix)
        elif op == OP_DECODE:
            D = decode_matrix(matrix, [int(e) for e in erasures], k,
                              [int(s) for s in survivors])
            fn = make_encoder(D)
        else:
            raise ValueError(f"unknown op {op}")
        # one copy to the device and one back; the frame's buffer is
        # read-only, so the host tensor is a copy of it
        data = torch.from_numpy(stack.copy()).to(self.device)
        return fn(data).cpu().numpy().tobytes()


def serve_forever(path: str, device=None) -> None:
    """CLI entry: run the runtime server until killed."""
    srv = ECRuntimeServer(path, device=device).start()
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    import sys
    import tempfile
    serve_forever(sys.argv[1] if len(sys.argv) > 1 else
                  os.path.join(tempfile.gettempdir(), "ec_tpu.sock"))
