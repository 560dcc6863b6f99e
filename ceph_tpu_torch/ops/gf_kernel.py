"""Batched static-matrix GF(2^8) apply: the hand-written Hopper kernel
and its plain PyTorch version.

Counterpart of ceph_tpu/ops/pallas_gf.py. `apply_matrix_gf(matrix,
data)` computes out[b, i, :] = XOR_j matrix[i, j] (x) data[b, j, :]
over GF(2^8) (poly 0x11D) for data (B, k, L) uint8 with L % 4 == 0.

- On a CUDA tensor it launches `csrc/gf_apply.cu` (sm_90a), built with
  nvcc on first use into `ceph_tpu_torch/_build/` and loaded with
  ctypes. A build or launch failure raises; nothing falls back.
- On a CPU tensor it runs `apply_matrix_plain`, the torch twin of the
  same SWAR function on int32 words (`pallas_gf._kernel_body`).

The design note and the bound on the H100 are in the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..gf.tables import bit_powers

_REP = 0x01010101
_SRC = Path(__file__).resolve().parent / "csrc" / "gf_apply.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def coef_words(matrix: np.ndarray) -> np.ndarray:
    """(m, k, 8) uint32: matrix[i, j] * 2^b replicated into 4 bytes."""
    matrix = np.ascontiguousarray(matrix, np.uint8)
    return bit_powers()[matrix].astype(np.uint32) * np.uint32(_REP)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build ceph_tpu_torch/ops/csrc/gf_apply.cu")


def build() -> Path:
    """Compile gf_apply.cu into BUILD_DIR (once per source content) and
    return the shared library's path. Raises on a failed build."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libgf_apply_{tag[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC.name} "
                           f"(rc={proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.gf_apply
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


@functools.lru_cache(maxsize=256)
def _device_coefs(matrix_bytes: bytes, m: int, k: int,
                  device: torch.device) -> torch.Tensor:
    matrix = np.frombuffer(matrix_bytes, np.uint8).reshape(m, k)
    words = coef_words(matrix).view(np.int32)
    return torch.from_numpy(words.copy()).to(device)


def _check(matrix: np.ndarray, data: torch.Tensor) -> None:
    m, k = matrix.shape
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"data must be a torch.Tensor, got {type(data)}")
    if data.dtype != torch.uint8 or data.ndim != 3:
        raise ValueError(f"data must be (batch, k, L) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if data.shape[1] != k:
        raise ValueError(f"data has {data.shape[1]} shards, "
                         f"matrix expects {k}")
    if data.shape[2] % 4:
        raise ValueError(f"chunk length {data.shape[2]} not a multiple of 4")


def apply_matrix_plain(matrix: np.ndarray, data: torch.Tensor
                       ) -> torch.Tensor:
    """The kernel's function in plain torch ops on int32 words: the
    SWAR bit-linear accumulate of `pallas_gf._kernel_body`. `>>` on
    int32 is arithmetic, but `& 0x01010101` after a shift of at most 7
    keeps only bits that came from the word itself; `(v << 8) - v`
    wraps like the uint32 original."""
    matrix = np.ascontiguousarray(matrix, np.uint8)
    _check(matrix, data)
    m, k = matrix.shape
    B, _, L = data.shape
    if data.numel() == 0:
        return torch.zeros((B, m, L), dtype=torch.uint8, device=data.device)
    coefs = coef_words(matrix).view(np.int32)
    x = data.contiguous().view(torch.int32)          # (B, k, L // 4)
    accs: list[torch.Tensor | None] = [None] * m
    for j in range(k):
        xj = x[:, j]
        for b in range(8):
            col = coefs[:, j, b]
            if not col.any():
                continue
            v = (xj >> b) & _REP
            mask = (v << 8) - v
            for i in range(m):
                c = int(col[i])
                if c == 0:
                    continue
                term = mask if c == -1 else mask & c
                accs[i] = term if accs[i] is None else accs[i] ^ term
    zero = torch.zeros((B, L // 4), dtype=torch.int32, device=data.device)
    out = torch.stack([a if a is not None else zero for a in accs], dim=1) \
        if m else torch.empty((B, 0, L // 4), dtype=torch.int32,
                              device=data.device)
    return out.view(torch.uint8).reshape(B, m, L)


def apply_matrix_gf(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """out = matrix (GF) @ data along the shard axis; matrix static.

    CUDA tensor: one launch of the hand kernel on the current stream
    (counted in `apply_matrix_gf.launches`). CPU tensor: the plain
    version. Any other device raises."""
    matrix = np.ascontiguousarray(matrix, np.uint8)
    _check(matrix, data)
    if data.device.type == "cpu":
        return apply_matrix_plain(matrix, data)
    if data.device.type != "cuda":
        raise ValueError(f"gf_apply runs on cuda or cpu tensors, "
                         f"got {data.device}")
    m, k = matrix.shape
    B, _, L = data.shape
    out = torch.empty((B, m, L), dtype=torch.uint8, device=data.device)
    if B == 0 or L == 0 or m == 0:
        return out.zero_()
    data = data.contiguous()
    if data.data_ptr() % 4:
        data = data.clone()
    vec = 4 if L % 16 == 0 and data.data_ptr() % 16 == 0 else 1
    coefs = _device_coefs(matrix.tobytes(), m, k, data.device)
    lib = _load()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.gf_apply(data.data_ptr(), out.data_ptr(), coefs.data_ptr(),
                          B, k, m, L, vec, stream)
    if rc != 0:
        raise RuntimeError(f"gf_apply launch failed: cudaError {rc} "
                           f"(B={B} k={k} m={m} L={L} vec={vec})")
    apply_matrix_gf.launches += 1
    return out


apply_matrix_gf.launches = 0
