"""Batched GF(2^8) encode/decode on torch tensors.

Twin of ceph_tpu/ops/rs_kernels.py. Unit of work: uint8 tensors shaped
(batch, shard, chunk_bytes); the coding/decoding matrix is a static
host numpy array. Every lowering runs on the device the data lies on
and gives the same bytes as the numpy oracle:

  impl="pallas"  (default) — the hand-written GF kernel
      (ops/gf_kernel.py, csrc/gf_apply.cu) on a CUDA tensor, its plain
      torch version on a CPU tensor. The slot keeps the twin's name so
      that `impl=pallas` profile strings resolve unchanged.
  impl="bitlinear" — c*x = XOR_{b set in x} (c * 2^b) as uint8 torch
      ops, unrolled over (j, b).
  impl="mxu" — GF(2) bit-planes times the (8m, 8k) bit-expansion of the
      matrix as a float32 matmul; the sums are at most 8k <= 2040, so
      they are exact, and the low bit is the XOR.
  impl="logexp" — log/antilog table gathers.

`apply_matrix_traced` takes a runtime per-batch matrix (log/exp form).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..gf.tables import GF_EXP, GF_LOG, bit_powers, matrix_to_bitmatrix
from .fold_kernel import xor_fold, xor_fold_plain
from .gf_kernel import apply_matrix_gf


@functools.lru_cache(maxsize=16)
def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    log = torch.from_numpy(GF_LOG.astype(np.int64)).to(device)
    exp = torch.from_numpy(GF_EXP[:512].astype(np.uint8)).to(device)
    return log, exp


def _check(data: torch.Tensor, k: int) -> None:
    if data.ndim != 3:
        raise ValueError(f"data must be (batch, k, L) uint8, got "
                         f"{tuple(data.shape)}")
    if data.shape[1] != k:
        raise ValueError(f"data has {data.shape[1]} shards, "
                         f"matrix expects {k}")


def xor_reduce(t: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of `t` along `dim` (torch has no XOR-reduce op): the hand
    fold kernel on a CUDA tensor (ops/fold_kernel.py::xor_fold, which
    raises on what it does not take), the plain torch loop on any
    other."""
    if t.device.type == "cuda":
        return xor_fold(t, dim)
    return xor_fold_plain(t, dim)


# ---------------------------------------------------------------- bitlinear

def _apply_bitlinear(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """parity[i] = XOR_j XOR_b bit_b(data[j]) ? (matrix[i,j] * 2^b) : 0."""
    m, k = matrix.shape
    _check(data, k)
    B, _, L = data.shape
    P = bit_powers()[matrix]  # (m, k, 8) uint8 host constants
    Pt = torch.from_numpy(P).to(data.device)
    acc = None
    for j in range(k):
        dj = data[:, j, :]
        for b in range(8):
            if not P[:, j, b].any():
                continue
            mask = torch.zeros_like(dj) - ((dj >> b) & 1)  # 0x00/0xFF
            term = mask[:, None, :] & Pt[None, :, j, b, None]
            acc = term if acc is None else acc ^ term
    if acc is None:
        acc = torch.zeros((B, m, L), dtype=torch.uint8, device=data.device)
    return acc


# ---------------------------------------------------------------- mxu

def _apply_mxu(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """Bit-plane matmul; sum mod 2 == XOR accumulate."""
    m, k = matrix.shape
    _check(data, k)
    B, _, L = data.shape
    bm = matrix_to_bitmatrix(matrix)  # (m*8, k*8) in {0,1}
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (data[:, :, None, :] >> shifts[None, None, :, None]) & 1
    x = bits.reshape(B, k * 8, L).to(torch.float32)
    w = torch.from_numpy(bm.astype(np.float32)).to(data.device)
    pbits = torch.matmul(w, x)  # (B, m*8, L), exact integers <= 8k
    pbits = (pbits.to(torch.int32) & 1).reshape(B, m, 8, L)
    out = (pbits << shifts.to(torch.int32)[None, None, :, None]).sum(dim=2)
    return out.to(torch.uint8)


# ---------------------------------------------------------------- logexp

def _apply_logexp_static(matrix: np.ndarray, data: torch.Tensor
                         ) -> torch.Tensor:
    m, k = matrix.shape
    _check(data, k)
    log_t, exp_t = _tables(data.device)
    logs = GF_LOG[matrix].astype(np.int64)  # (m, k) host constants
    zero = matrix == 0
    ld = log_t[data.long()]  # (B, k, L)
    rows = []
    for i in range(m):
        row = None
        for j in range(k):
            if zero[i, j]:
                continue
            prod = exp_t[ld[:, j, :] + int(logs[i, j])]
            prod = torch.where(data[:, j, :] == 0, 0, prod).to(torch.uint8)
            row = prod if row is None else row ^ prod
        if row is None:
            row = torch.zeros_like(data[:, 0, :])
        rows.append(row)
    if not rows:
        return torch.empty((data.shape[0], 0, data.shape[2]),
                           dtype=torch.uint8, device=data.device)
    return torch.stack(rows, dim=1)


def apply_matrix_traced(matrix: torch.Tensor, data: torch.Tensor
                        ) -> torch.Tensor:
    """GF matmul with a RUNTIME matrix — per-batch decode matrices.

    matrix: (..., m, k) uint8 (may carry a leading batch dim matching data).
    data:   (..., k, L) uint8.
    Returns (..., m, L).
    """
    matrix = torch.as_tensor(matrix, dtype=torch.uint8, device=data.device)
    log_t, exp_t = _tables(data.device)
    lm = log_t[matrix.long()]                            # (..., m, k)
    ld = log_t[data.long()]                              # (..., k, L)
    s = lm[..., :, :, None] + ld[..., None, :, :]        # (..., m, k, L)
    prod = exp_t[s]
    nz = (matrix[..., :, :, None] != 0) & (data[..., None, :, :] != 0)
    prod = torch.where(nz, prod, 0).to(torch.uint8)
    return xor_reduce(prod, dim=-2)


_IMPLS = {
    "bitlinear": _apply_bitlinear,
    "mxu": _apply_mxu,
    "logexp": _apply_logexp_static,
    "pallas": apply_matrix_gf,
}

DEFAULT_IMPL = "pallas"


def apply_matrix(matrix: np.ndarray, data: torch.Tensor,
                 impl: str = DEFAULT_IMPL) -> torch.Tensor:
    """out = matrix (GF) @ data along the shard axis. matrix is static."""
    return _IMPLS[impl](np.asarray(matrix, dtype=np.uint8), data)


@functools.lru_cache(maxsize=128)
def _make_fn(matrix_bytes: bytes, m: int, k: int, impl: str):
    matrix = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(m, k)
    return functools.partial(_IMPLS[impl], matrix)


def pow2_bucket(n: int) -> int:
    """Next power of two >= n (>= 1): the shared batch-bucketing rule."""
    return 1 << max(0, int(n - 1).bit_length())


def run_bucketed(fn, arr):
    """Call `fn` with `arr`'s leading dim zero-padded to the pow2 bucket
    and slice the result back, as the twin does (there it spares XLA
    recompiles; here it keeps the launched shapes the twin's)."""
    arr = torch.as_tensor(arr)
    B = arr.shape[0]
    bucket = pow2_bucket(B)
    if bucket != B:
        arr = torch.cat([arr, arr.new_zeros((bucket - B,) + arr.shape[1:])])
    return fn(arr)[:B]


def make_encoder(matrix: np.ndarray, impl: str = DEFAULT_IMPL,
                 bucket_batch: bool = True):
    """Closure computing matrix @ data for a fixed matrix, on the device
    the data lies on. Works for encode (coding matrix) and decode
    (decode matrix) alike. bucket_batch pads the batch to the next
    power of two and slices the result back (the twin's default)."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}; available: {sorted(_IMPLS)}")
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    fn = _make_fn(matrix.tobytes(), *matrix.shape, impl)
    if not bucket_batch:
        return fn
    return lambda data: run_bucketed(fn, torch.as_tensor(data,
                                                         dtype=torch.uint8))
