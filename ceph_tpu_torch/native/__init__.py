"""ctypes bindings for the native host library — the CPU codec + plugin shim.

Twin of ceph_tpu/native/__init__.py. The library is built from the
repository's native/ec_tpu.cpp with the flags of native/Makefile, by
g++ (utils/nvcc.py `build`, `HOST_FLAGS`), into `ceph_tpu_torch/_build/`
under a name that carries the hash of source and flags: the port never
loads a library built from other sources, never shares the twin's
native/libec_tpu.so, and never races its `make -B`. The build runs at
the first `lib()` call, not at import.

The library's flat C API (ref: ErasureCodePluginRegistry::load
dlopening libec_<name>.so and resolving __erasure_code_init) carries
the host codec, raw-register CRC32C on SSE4.2 (TinDB's and TinStore's
checksums, `kv/tindb.py::host_crc32c`), AES-256-GCM and the runtime
socket. The `native` EC plugin runs RS on the host by definition: it
takes `device="cpu"` only and raises for a card, and takes and returns
uint8 tensors like the port's other coders.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch

from ..utils import nvcc

_SRC = Path(__file__).resolve().parents[2] / "native" / "ec_tpu.cpp"
_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def build(force: bool = False) -> str:
    """Compile the library unless this source's build exists (always
    with `force`); returns the .so path. Raises NativeUnavailable when
    there is no compiler or the build fails."""
    if not _SRC.exists():
        raise NativeUnavailable(f"missing {_SRC}")
    try:
        return str(nvcc.build(_SRC, compiler=nvcc.find_host,
                              flags=nvcc.HOST_FLAGS, force=force,
                              label="g++"))
    except RuntimeError as e:
        raise NativeUnavailable(f"build failed: {e}") from None


def ready() -> bool:
    """True when this source's library exists — WITHOUT building it
    (import-time callers must never run a compile)."""
    return _SRC.exists() and nvcc.library_path(
        _SRC, flags=nvcc.HOST_FLAGS).exists()


def lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        L = ctypes.CDLL(build())
        L.ec_tpu_version.restype = ctypes.c_char_p
        L.ec_create.restype = ctypes.c_void_p
        L.ec_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
        L.ec_create_with_matrix.restype = ctypes.c_void_p
        L.ec_create_with_matrix.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_char_p]
        L.ec_destroy.argtypes = [ctypes.c_void_p]
        L.ec_get_matrix.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        L.ec_encode.restype = ctypes.c_int
        L.ec_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
        L.ec_decode.restype = ctypes.c_int
        L.ec_decode.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_int64, ctypes.c_int]
        L.ec_crc32c.restype = ctypes.c_uint32
        L.ec_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_char_p,
                                ctypes.c_int64]
        L.ec_crc32c_hw.restype = ctypes.c_int
        L.ec_crc32c_rows.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_uint32)]
        L.__erasure_code_init.restype = ctypes.c_int
        L.__erasure_code_init.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        L.ec_registered_plugin.restype = ctypes.c_char_p
        L.ec_set_runtime_socket.argtypes = [ctypes.c_char_p]
        L.ec_runtime_ping.restype = ctypes.c_int
        L.ec_aes256gcm_supported.restype = ctypes.c_int
        for fn in (L.ec_aes256gcm_seal, L.ec_aes256gcm_open):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                           ctypes.c_char_p, ctypes.c_int64,
                           ctypes.c_char_p, ctypes.c_int64,
                           ctypes.c_char_p]
        _lib = L
        return L


def set_runtime_socket(path: str | None) -> None:
    """Point the shim's encode/decode at a running EC runtime server;
    None restores pure-CPU operation."""
    lib().ec_set_runtime_socket(path.encode() if path else None)


def runtime_ping() -> bool:
    return bool(lib().ec_runtime_ping())


def version() -> str:
    return lib().ec_tpu_version().decode()


def erasure_code_init(name: str = "tpu") -> int:
    """Exercise the reference-shaped plugin entry symbol."""
    return lib().__erasure_code_init(name.encode(), b"")


def native_crc32c(seed: int, data: bytes | np.ndarray) -> int:
    buf = bytes(data) if not isinstance(data, np.ndarray) else \
        np.ascontiguousarray(data, np.uint8).tobytes()
    return int(lib().ec_crc32c(seed & 0xFFFFFFFF, buf, len(buf)))


def crc32c_hw() -> bool:
    """True when the library is built and ec_crc32c runs on the SSE4.2
    CRC32 instruction (the table fallback is ~20x slower)."""
    try:
        return ready() and bool(lib().ec_crc32c_hw())
    except (NativeUnavailable, OSError, AttributeError):
        return False


def native_crc32c_rows(seed: int, rows: np.ndarray) -> np.ndarray:
    """Raw-register crc32c of each row of a (B, L) uint8 stack in ONE
    ctypes crossing — the host checksum path."""
    rows = np.ascontiguousarray(rows, np.uint8)
    if rows.ndim != 2:
        raise ValueError(f"want (B, L), got {rows.shape}")
    out = np.empty(rows.shape[0], np.uint32)
    lib().ec_crc32c_rows(
        seed & 0xFFFFFFFF, rows.ctypes.data_as(ctypes.c_void_p),
        rows.shape[0], rows.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def aes256gcm_supported() -> bool:
    """True when the library is built and the CPU has AES-NI + PCLMUL."""
    try:
        return ready() and bool(lib().ec_aes256gcm_supported())
    except (NativeUnavailable, OSError, AttributeError):
        return False


def aes256gcm_seal(key: bytes, nonce: bytes, plain: bytes,
                   aad: bytes) -> bytes:
    """NIST AES-256-GCM (96-bit nonce): ciphertext || 16-byte tag."""
    out = ctypes.create_string_buffer(len(plain) + 16)
    r = lib().ec_aes256gcm_seal(key, nonce, aad,
                                ctypes.c_int64(len(aad)), plain,
                                ctypes.c_int64(len(plain)), out)
    if r != 0:
        raise NativeUnavailable(f"ec_aes256gcm_seal rc={r}")
    return out.raw


def aes256gcm_open(key: bytes, nonce: bytes, blob: bytes,
                   aad: bytes) -> bytes:
    """Decrypt+verify; raises ValueError on tag mismatch (the caller
    maps it to the AEAD InvalidTag)."""
    if len(blob) < 16:
        raise ValueError("aes256gcm blob too short")
    out = ctypes.create_string_buffer(len(blob) - 16)
    r = lib().ec_aes256gcm_open(key, nonce, aad,
                                ctypes.c_int64(len(aad)), blob,
                                ctypes.c_int64(len(blob)), out)
    if r == -1:
        raise ValueError("aes256gcm tag mismatch")
    if r != 0:
        raise NativeUnavailable(f"ec_aes256gcm_open rc={r}")
    return out.raw


from ..ec.interface import ErasureCode, resolve_device  # noqa: E402
from ..ec.registry import register  # noqa: E402


@register("native")
class NativeReedSolomon(ErasureCode):
    """RS coder running entirely in the native host library (the
    CPU-native baseline path; profile plugin=native). Host only: a
    card device raises rather than computing on the host for it."""

    def __init__(self, profile: Mapping[str, str] | None = None,
                 device=None):
        dev = resolve_device(device)
        if dev.type != "cpu":
            raise ValueError(
                f"the native plugin runs on the host: device {dev} "
                f"refused; pass device='cpu'")
        super().__init__(profile, device=dev)

    def init(self, profile: Mapping[str, str]) -> None:
        self.k = int(profile.get("k", 7))
        self.m = int(profile.get("m", 3))
        technique = profile.get("technique", "reed_sol_van")
        L = lib()
        if technique == "reed_sol_van":
            self._h = L.ec_create(self.k, self.m, b"reed_sol_van")
        else:
            from ..ec.matrices import coding_matrix
            mat = np.ascontiguousarray(
                coding_matrix(technique, self.k, self.m))
            self._h = L.ec_create_with_matrix(self.k, self.m,
                                              mat.tobytes())
        if not self._h:
            raise ValueError(f"native coder rejected k={self.k} "
                             f"m={self.m} technique={technique!r}")
        self.technique = technique
        mat = ctypes.create_string_buffer(self.m * self.k)
        L.ec_get_matrix(self._h, mat)
        self.matrix = np.frombuffer(mat.raw, np.uint8).reshape(
            self.m, self.k).copy()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            try:
                lib().ec_destroy(h)
            except TypeError:
                pass  # interpreter teardown already unloaded the lib
            self._h = None

    def _host(self, x) -> np.ndarray:
        return np.ascontiguousarray(self.as_chunks(x).numpy())

    def encode_chunks(self, data) -> torch.Tensor:
        data = self._host(data)
        squeeze = data.ndim == 2
        if squeeze:
            data = data[None]
        B, k, cl = data.shape
        if k != self.k:
            raise ValueError(f"data must be (B, {self.k}, L), got "
                             f"{data.shape}")
        out = np.zeros((B, self.m, cl), np.uint8)
        rc = lib().ec_encode(self._h, data.ctypes.data_as(ctypes.c_char_p),
                             out.ctypes.data_as(ctypes.c_char_p), cl, B)
        if rc != 0:
            raise RuntimeError(f"ec_encode failed: {rc}")
        out = torch.from_numpy(out)
        return out[0] if squeeze else out

    def decode_chunks(self, want_to_read: Sequence[int],
                      chunks: Mapping[int, object]
                      ) -> dict[int, torch.Tensor]:
        erasures = sorted(want_to_read)
        survivors = sorted(s for s in chunks
                           if s not in set(erasures))[:self.k]
        if len(survivors) < self.k:
            raise ValueError(f"need {self.k} chunks, have {len(survivors)}")
        arrs = [self._host(chunks[s]) for s in survivors]
        squeeze = arrs[0].ndim == 1
        if squeeze:
            arrs = [a[None] for a in arrs]
        stack = np.ascontiguousarray(np.stack(arrs, axis=1))  # (B, k, cl)
        B, _, cl = stack.shape
        out = np.zeros((B, len(erasures), cl), np.uint8)
        ers = (ctypes.c_int * len(erasures))(*erasures)
        surv = (ctypes.c_int * self.k)(*survivors)
        rc = lib().ec_decode(self._h, ers, len(erasures), surv,
                             stack.ctypes.data_as(ctypes.c_char_p),
                             out.ctypes.data_as(ctypes.c_char_p), cl, B)
        if rc != 0:
            raise RuntimeError(f"ec_decode failed: {rc}")
        out = torch.from_numpy(out)
        if squeeze:
            out = out[0]
            return {e: out[i] for i, e in enumerate(erasures)}
        return {e: out[:, i, :] for i, e in enumerate(erasures)}
