"""GF(2^8) table construction.

Copy of ceph_tpu/gf/tables.py (numpy only), kept in the port so that
ceph_tpu_torch imports nothing of ceph_tpu. The gf-complete w=8
arithmetic layer
(ref: src/erasure-code/jerasure/gf-complete/src/gf_w8.c — SPLIT 4,8
table multiplication; primitive polynomial 0x11D, the gf-complete /
ISA-L default for w=8).

Everything here is built once with numpy at import time; the resulting
tables are the constants that the torch ops and the CUDA GF kernel use.

Conventions:
  - Field: GF(2^8) = GF(2)[x] / (x^8 + x^4 + x^3 + x^2 + 1)  (0x11D).
  - Generator: alpha = x = 0x02 (primitive for 0x11D).
  - Bit order: bit b of a byte is the coefficient of x^b (LSB-first).
"""

from __future__ import annotations

import functools

import numpy as np

PRIM_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1 (gf-complete w=8 default)
GF_SIZE = 256


def _build_exp_log() -> tuple[np.ndarray, np.ndarray]:
    """exp/log tables for generator 0x02 under PRIM_POLY.

    exp has 512 entries so exp[log a + log b] needs no modular reduction.
    log[0] is set to 0 but must never be consumed (guarded by callers).
    """
    exp = np.zeros(512, dtype=np.uint16)
    log = np.zeros(256, dtype=np.uint16)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    return exp.astype(np.uint8), log

GF_EXP, GF_LOG = _build_exp_log()


def gf_mul_scalar(a: int, b: int) -> int:
    """Single GF(2^8) multiply (python ints). Reference implementation."""
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[int(GF_LOG[a]) + int(GF_LOG[b])])


def gf_inv_scalar(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return int(GF_EXP[255 - int(GF_LOG[a])])


def gf_div_scalar(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) divide by 0")
    if a == 0:
        return 0
    return int(GF_EXP[int(GF_LOG[a]) + 255 - int(GF_LOG[b])])


def gf_pow_scalar(a: int, n: int) -> int:
    """a**n in GF(2^8), with the jerasure convention 0**0 == 1."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % 255])


@functools.cache
def mul_table() -> np.ndarray:
    """Full 256x256 multiplication table, MUL[a, b] = a*b. 64 KiB."""
    a = np.arange(256, dtype=np.int32)
    la = GF_LOG[a].astype(np.int32)
    s = la[:, None] + la[None, :]
    prod = GF_EXP[s]
    prod = prod.copy()
    prod[0, :] = 0
    prod[:, 0] = 0
    return prod.astype(np.uint8)


@functools.cache
def inv_table() -> np.ndarray:
    """INV[a] = a^-1; INV[0] = 0 (never valid to use)."""
    inv = np.zeros(256, dtype=np.uint8)
    inv[1:] = GF_EXP[255 - GF_LOG[np.arange(1, 256)].astype(np.int32)]
    return inv


@functools.cache
def nibble_tables() -> tuple[np.ndarray, np.ndarray]:
    """SPLIT 4,8-style tables (ref: gf_w8_split_4_8 in gf_w8.c).

    Returns (LO, HI), each (256, 16) uint8:
      LO[c, n] = c * n          (low-nibble products)
      HI[c, n] = c * (n << 4)   (high-nibble products)
    so  c * x == LO[c, x & 0xF] ^ HI[c, x >> 4].
    """
    mt = mul_table()
    lo = mt[:, :16].copy()
    hi = mt[:, [n << 4 for n in range(16)]].copy()
    return lo, hi


@functools.cache
def bit_powers() -> np.ndarray:
    """P[c, b] = c * (1 << b): products of every constant with each bit.

    Because GF(2^8) multiplication is GF(2)-linear in each operand,
      c * x == XOR_{b: bit b of x set} P[c, b].
    This is the basis of the gather-free "bit-linear" device kernels.
    Shape (256, 8) uint8.
    """
    mt = mul_table()
    return mt[:, [1 << b for b in range(8)]].copy()


def gf_bitmatrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix M of multiply-by-c: bits(c*x) = M @ bits(x) mod 2.

    Column b of M holds the bits of c * 2^b (LSB-first rows). This is the
    same companion-matrix expansion jerasure's *_to_bitmatrix performs for
    its Cauchy/"schedule" codecs (ref: jerasure.c jerasure_matrix_to_bitmatrix),
    transposed to column-acts-on-input convention.
    """
    m = np.zeros((8, 8), dtype=np.uint8)
    for b in range(8):
        p = gf_mul_scalar(c, 1 << b)
        for r in range(8):
            m[r, b] = (p >> r) & 1
    return m


def matrix_to_bitmatrix(mat: np.ndarray) -> np.ndarray:
    """Expand an (r, c) GF(2^8) matrix to an (r*8, c*8) GF(2) bit matrix.

    Encoding over the bit matrix (XOR-accumulated AND products on the
    bit-planes of the data) is bit-exact with GF encoding over `mat`.
    """
    r, c = mat.shape
    out = np.zeros((r * 8, c * 8), dtype=np.uint8)
    for i in range(r):
        for j in range(c):
            out[i * 8:(i + 1) * 8, j * 8:(j + 1) * 8] = gf_bitmatrix(int(mat[i, j]))
    return out
