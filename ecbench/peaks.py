"""The H100's published peaks and the least time a kernel can take.

NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit: HBM3 at
3.35 TB/s, int8 tensor cores at 1,979 Tops/s, float32 outside the
tensor cores at 67 TFLOP/s. A roofline share is the bound below over
the kernel's device time, against these peaks whatever power limit the
card is set to (the run prints the limit beside it).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FP32_OPS_PER_S = 67e12


def gf_bound(B: int, k: int, m: int, L: int, nnz: int) -> tuple[float, str]:
    """Least time (ms) of a GF(2^8) matrix apply (B, k, L) -> (B, m, L):
    the larger of B*(k+m)*L bytes through HBM (each input byte read
    once, each output byte written once) and the fewest operations
    known for it, an (8m x 8k) bit-matrix product per byte column on the
    int8 tensor cores, 2*64 operations for each of the matrix's `nnz`
    non-zero coefficients, B*L columns."""
    t_bytes = B * (k + m) * L / HBM_BYTES_PER_S
    t_ops = 2 * 64 * nnz * B * L / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def crc_bound(sets, out_bytes: int = 8, ops_per_byte: float = 2.0
              ) -> tuple[float, str]:
    """Least time (ms) of one CRC32C launch over row sets [(B, L)]: the
    larger of the bytes (each input byte read once, `out_bytes` a row
    written: the int64 register) through HBM and `ops_per_byte` integer
    operations a byte (one table lookup and one XOR) at the float32
    rate outside the tensor cores (the data sheet gives no integer rate
    there)."""
    t_bytes = sum(B * (L + out_bytes) for B, L in sets) / HBM_BYTES_PER_S
    t_ops = sum(B * L for B, L in sets) * ops_per_byte / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
