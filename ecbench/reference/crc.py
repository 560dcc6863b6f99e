"""CRC-32C (Castagnoli) of byte rows in plain PyTorch.

The register is reflected (polynomial 0x82F63B78). `crc32c_raw(rows,
seed)` is Ceph's ceph_crc32c(seed, row): the register after the row,
with no final xor (the hinfo convention, seed 0xFFFFFFFF). Each row is
cut into chunks whose zero-seed CRCs are taken side by side a byte at a
time, then merged in pairs: crc0(A || B) = shift_|B|(crc0(A)) ^
crc0(B), where shift_n advances a register through n zero bytes, a
GF(2)-linear map applied by four byte tables. Leading zero bytes leave
a zero-seed CRC unchanged, which pads rows to whole chunks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

POLY_REFLECTED = 0x82F63B78
CHUNK = 64


@functools.lru_cache(maxsize=1)
def byte_table() -> np.ndarray:
    t = np.zeros(256, np.int64)
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ (POLY_REFLECTED if c & 1 else 0)
        t[n] = c
    return t


def _apply(cols: tuple, x: int) -> int:
    out = 0
    for b in range(32):
        if (x >> b) & 1:
            out ^= cols[b]
    return out


@functools.lru_cache(maxsize=None)
def shift_cols(nbytes: int) -> tuple:
    """Columns of the 32 x 32 GF(2) matrix of shift_nbytes."""
    if nbytes == 0:
        return tuple(1 << b for b in range(32))
    if nbytes == 1:
        t = byte_table()
        return tuple(int(t[(1 << b) & 0xFF] ^ ((1 << b) >> 8))
                     for b in range(32))
    half = shift_cols(nbytes // 2)
    twice = tuple(_apply(half, c) for c in half)
    if nbytes % 2:
        one = shift_cols(1)
        twice = tuple(_apply(one, c) for c in twice)
    return twice


def shift(reg: int, nbytes: int) -> int:
    return _apply(shift_cols(nbytes), reg)


@functools.lru_cache(maxsize=64)
def _shift_tables(nbytes: int) -> np.ndarray:
    """(4, 256): shift_nbytes of v << 8b, so that shift(x) = XOR_b
    tables[b][byte b of x]."""
    cols = shift_cols(nbytes)
    v = np.arange(256, dtype=np.int64)
    out = np.zeros((4, 256), np.int64)
    for b in range(4):
        for bit in range(8):
            out[b] ^= np.where((v >> bit) & 1, cols[8 * b + bit], 0)
    return out


def _shift_t(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    tab = torch.from_numpy(_shift_tables(nbytes)).to(x.device)
    return (tab[0][x & 0xFF] ^ tab[1][(x >> 8) & 0xFF]
            ^ tab[2][(x >> 16) & 0xFF] ^ tab[3][(x >> 24) & 0xFF])


def crc32c_zero(rows: torch.Tensor) -> torch.Tensor:
    """(R, L) uint8 -> (R,) int64: zero-seed CRC of each row."""
    R, L = rows.shape
    n = max(1, -(-L // CHUNK))
    n = 1 << (n - 1).bit_length()                  # whole pairs to merge
    pad = n * CHUNK - L
    if pad:
        rows = torch.cat([rows.new_zeros((R, pad)), rows], dim=1)
    chunks = rows.reshape(R, n, CHUNK)
    tab = torch.from_numpy(byte_table()).to(rows.device)
    reg = torch.zeros((R, n), dtype=torch.int64, device=rows.device)
    for i in range(CHUNK):
        reg = tab[(reg ^ chunks[:, :, i].to(torch.int64)) & 0xFF] ^ (reg >> 8)
    span = CHUNK
    while reg.shape[1] > 1:
        reg = _shift_t(reg[:, 0::2], span) ^ reg[:, 1::2]
        span *= 2
    return reg[:, 0]


def crc32c_raw(rows: torch.Tensor, seed: int = 0xFFFFFFFF,
               max_rows: int = 256) -> torch.Tensor:
    """(R, L) uint8 -> (R,) int64: ceph_crc32c(seed, row), in blocks of
    `max_rows` rows."""
    R, L = rows.shape
    out = torch.empty((R,), dtype=torch.int64, device=rows.device)
    for r0 in range(0, R, max_rows):
        out[r0:r0 + max_rows] = crc32c_zero(rows[r0:r0 + max_rows])
    return out ^ shift(seed, L)
