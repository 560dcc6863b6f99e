"""Wire encoding — the bufferlist encode/decode layer.

Rebuild of the reference's serialization core (ref: src/include/
encoding.h — `encode()`/`decode()` over bufferlists, little-endian
primitives, length-prefixed strings/containers, and the
ENCODE_START(v, compat)/ENCODE_FINISH versioned-section protocol that
gives every structure forward AND backward compatibility: a section
carries (version, compat_version, length); an old reader meeting a
newer section checks `compat <= my_version` and skips the bytes past
what it understands; a new reader meeting an old section sees the low
version and decodes only the fields that existed then).

Everything is explicit little-endian bytes — no pickle, no struct-
by-reflection — so the format is stable across Python versions and
auditable on the wire, the same property the reference's hand-rolled
encoders guarantee.
"""

from __future__ import annotations

import struct


class EncodingError(ValueError):
    pass


class Encoder:
    """Append-only byte builder (the `bufferlist& bl` role).

    Scatter-gather aware: `blob_ref` appends a caller buffer BY
    REFERENCE (the bufferlist::append(bufferptr) role — no copy), so a
    message carrying a large data payload encodes as a list of
    segments: small bytearray chunks of framing fields interleaved
    with zero-copy views of the payload. `bytes()` still joins to one
    contiguous buffer for callers that need it; `segments()` hands the
    raw part list to the messenger's sendmsg path. Buffers appended by
    reference must stay unmodified until the encoded message is fully
    sent (and, on the lossless messenger, acked) — the same aliasing
    contract a bufferlist imposes."""

    def __init__(self):
        self._buf = bytearray()
        self._parts: list = []          # finalized parts (bytearray/mv)
        self._starts: list[int] = []    # absolute offset of each part
        self._base = 0                  # total bytes in finalized parts
        self._sections: list[int] = []  # ABS offsets of open length slots

    # -- primitives ---------------------------------------------------------

    def u8(self, v: int) -> "Encoder":
        self._buf += struct.pack("<B", v)
        return self

    def u16(self, v: int) -> "Encoder":
        self._buf += struct.pack("<H", v)
        return self

    def u32(self, v: int) -> "Encoder":
        self._buf += struct.pack("<I", v)
        return self

    def u64(self, v: int) -> "Encoder":
        self._buf += struct.pack("<Q", v)
        return self

    def i32(self, v: int) -> "Encoder":
        self._buf += struct.pack("<i", v)
        return self

    def i64(self, v: int) -> "Encoder":
        self._buf += struct.pack("<q", v)
        return self

    def f64(self, v: float) -> "Encoder":
        self._buf += struct.pack("<d", v)
        return self

    def boolean(self, v: bool) -> "Encoder":
        return self.u8(1 if v else 0)

    def blob(self, b: bytes) -> "Encoder":
        self.u32(len(b))
        self._buf += b
        return self

    def blob_ref(self, b) -> "Encoder":
        """Length-prefixed blob appended BY REFERENCE: `b` is one
        buffer (bytes/bytearray/memoryview) or a list of them. Wire
        bytes are identical to `blob(joined)`; no payload copy is
        made. The caller must keep the buffers unmodified until the
        encoded message has been transmitted (and acked on lossless
        transports)."""
        parts = b if isinstance(b, (list, tuple)) else (b,)
        self.u32(sum(len(p) for p in parts))
        for p in parts:
            if len(p) == 0:
                continue
            if self._buf:
                self._parts.append(self._buf)
                self._starts.append(self._base)
                self._base += len(self._buf)
                self._buf = bytearray()
            mv = p if isinstance(p, memoryview) else memoryview(p)
            self._parts.append(mv)
            self._starts.append(self._base)
            self._base += len(mv)
        return self

    def string(self, s: str) -> "Encoder":
        return self.blob(s.encode("utf-8"))

    def list(self, items, fn) -> "Encoder":
        """u32 count + fn(self, item) each (container convention)."""
        self.u32(len(items))
        for it in items:
            fn(self, it)
        return self

    def mapping(self, d: dict, kfn, vfn) -> "Encoder":
        self.u32(len(d))
        for k in d:
            kfn(self, k)
            vfn(self, d[k])
        return self

    # -- versioned sections (ENCODE_START / ENCODE_FINISH) ------------------

    def start(self, version: int, compat: int) -> "Encoder":
        if compat > version:
            raise EncodingError(f"compat {compat} > version {version}")
        self.u8(version).u8(compat)
        self._sections.append(self._base + len(self._buf))
        self.u32(0)  # length slot, patched by finish()
        return self

    def finish(self) -> "Encoder":
        if not self._sections:
            raise EncodingError("finish() without start()")
        at = self._sections.pop()
        body_len = self._base + len(self._buf) - at - 4
        self._patch_u32(at, body_len)
        return self

    def _patch_u32(self, at: int, value: int) -> None:
        """Patch 4 bytes at absolute offset `at`. The slot is always
        inside a bytearray part: blob_ref only flushes the current
        chunk AFTER writing the length prefix, and the 4-byte slot is
        written contiguously into one chunk."""
        packed = struct.pack("<I", value)
        if at >= self._base:
            self._buf[at - self._base:at - self._base + 4] = packed
            return
        import bisect
        i = bisect.bisect_right(self._starts, at) - 1
        part = self._parts[i]
        off = at - self._starts[i]
        part[off:off + 4] = packed

    def __len__(self) -> int:
        return self._base + len(self._buf)

    def bytes(self) -> bytes:
        if self._sections:
            raise EncodingError(f"{len(self._sections)} unfinished "
                                f"section(s)")
        if not self._parts:
            return bytes(self._buf)
        return b"".join(self._parts) + bytes(self._buf)

    def segments(self) -> list:
        """The encoded message as its raw part list (zero-copy where
        blob_ref was used). Joining the parts equals bytes() exactly.
        The encoder must not be appended to afterwards."""
        if self._sections:
            raise EncodingError(f"{len(self._sections)} unfinished "
                                f"section(s)")
        if self._buf:
            self._parts.append(self._buf)
            self._starts.append(self._base)
            self._base += len(self._buf)
            self._buf = bytearray()
        return list(self._parts)


class Decoder:
    """Cursor over bytes (the `bufferlist::const_iterator` role)."""

    def __init__(self, data):
        # bytes/bytearray/memoryview wrap zero-copy (the receive path
        # hands in a view over the frame body); anything else (numpy,
        # etc.) materializes once
        if isinstance(data, (bytes, bytearray, memoryview)):
            self._buf = memoryview(data)
        else:
            self._buf = memoryview(bytes(data))
        self._off = 0
        self._ends: list[int] = []  # section end offsets

    def _take(self, n: int) -> memoryview:
        if self._off + n > len(self._buf):
            raise EncodingError(
                f"decode past end: need {n} at {self._off}, "
                f"have {len(self._buf)}")
        if self._ends and self._off + n > self._ends[-1]:
            raise EncodingError(
                f"decode past section end {self._ends[-1]}")
        v = self._buf[self._off:self._off + n]
        self._off += n
        return v

    def u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def boolean(self) -> bool:
        return self.u8() != 0

    def blob(self) -> bytes:
        return bytes(self._take(self.u32()))

    def string(self) -> str:
        return self.blob().decode("utf-8")

    def list(self, fn) -> list:
        return [fn(self) for _ in range(self.u32())]

    def mapping(self, kfn, vfn) -> dict:
        return {kfn(self): vfn(self) for _ in range(self.u32())}

    # -- versioned sections (DECODE_START / DECODE_FINISH) ------------------

    def start(self, supported: int) -> int:
        """Open a section; returns its encoded version. Raises when the
        writer declared we're too old to read it at all."""
        v = self.u8()
        compat = self.u8()
        if compat > supported:
            raise EncodingError(
                f"section compat {compat} > supported {supported}: "
                f"written by an incompatible future version")
        length = self.u32()
        end = self._off + length
        if end > len(self._buf) or (self._ends and end > self._ends[-1]):
            raise EncodingError("section length overruns buffer")
        self._ends.append(end)
        return v

    def finish(self) -> None:
        """Skip any trailing fields a newer writer appended."""
        if not self._ends:
            raise EncodingError("finish() without start()")
        self._off = self._ends.pop()

    def remaining_in_section(self) -> int:
        if not self._ends:
            return len(self._buf) - self._off
        return self._ends[-1] - self._off

    @property
    def offset(self) -> int:
        return self._off
