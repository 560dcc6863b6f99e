"""Batched CRC32C on torch tensors.

Twin of the crc32c half of ceph_tpu/csum/kernels.py (xxh32/xxh64 come
in a later slice). Unit of work: (batch, block_len) uint8 — many
equal-sized blocks checked in one call. Results are (batch,) int64
tensors holding the uint32 CRC values: torch's uint32 dtype has almost
no CUDA ops (no shifts, gathers or mixed comparisons), so the port keeps
32-bit values in int64 from end to end; `.numpy().astype(np.uint32)`
gives the twin's array.

CRC is GF(2)-linear in the message, so as in the twin:
  1. every 8-byte chunk's zero-init CRC comes from the slicing-by-8
     tables as gathers;
  2. the chunk CRCs combine pairwise in log2(n) levels, where the left
     one is advanced through `span` zero bytes by the constant 32x32
     GF(2) shift matrix;
  3. at most 7 tail bytes step serially, and the init/xorout
     contribution is a host constant.
torch has no uint32 shifts, so 32-bit lanes ride in int64 and stay
below 2^32 (every op is a shift right, an AND with a 32-bit mask, an
XOR or a gather of 32-bit table words). The 32x32 GF(2) matrix is
applied as four 256-entry byte tables (XOR of the columns selected by
each byte of the register), the same linear map as the twin's 32
masked XORs in fewer ops.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .reference import (apply_shift, crc32c_slice8_tables, crc32c_table,
                        matrix_cols_u32, shift_matrix)

_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=16)
def _crc_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    slice8 = torch.from_numpy(crc32c_slice8_tables().astype(np.int64))
    t0 = torch.from_numpy(crc32c_table().astype(np.int64))
    return slice8.to(device), t0.to(device)


@functools.lru_cache(maxsize=256)
def _byte_tables_host(nbytes: int) -> np.ndarray:
    """(4, 256) int64: T[q][v] = shift^{nbytes} applied to v << 8q."""
    cols = matrix_cols_u32(shift_matrix(nbytes)).astype(np.int64)
    v = np.arange(256, dtype=np.int64)
    out = np.zeros((4, 256), dtype=np.int64)
    for q in range(4):
        for bit in range(8):
            out[q] ^= np.where((v >> bit) & 1, cols[8 * q + bit], 0)
    return out


@functools.lru_cache(maxsize=256)
def _byte_tables(nbytes: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_byte_tables_host(nbytes)).to(device)


def _apply_shift(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Advance int64 registers (< 2^32) through `nbytes` zero bytes."""
    t = _byte_tables(nbytes, x.device)
    return (t[0][x & 0xFF] ^ t[1][(x >> 8) & 0xFF]
            ^ t[2][(x >> 16) & 0xFF] ^ t[3][(x >> 24) & 0xFF])


def _crc32c_linear(blocks: torch.Tensor) -> torch.Tensor:
    """Zero-init CRC register over each row of (B, L) uint8, L % 8 == 0."""
    B, L = blocks.shape
    n = L // 8
    slice8, _ = _crc_tables(blocks.device)
    chunks = blocks.reshape(B, n, 8)
    c = slice8[7][chunks[:, :, 0].long()]
    for i in range(1, 8):
        c ^= slice8[7 - i][chunks[:, :, i].long()]
    # log-depth combine; pad FRONT with zero chunks (a zero-init
    # register stays 0 through a zero prefix)
    span = 8
    while c.shape[1] > 1:
        if c.shape[1] % 2:
            c = torch.cat([c.new_zeros((B, 1)), c], dim=1)
        c = _apply_shift(c[:, 0::2], span) ^ c[:, 1::2]
        span *= 2
    return c[:, 0]


def _crc32c_zero_seed(blocks: torch.Tensor) -> torch.Tensor:
    """Zero-seed CRC register (int64) over each row of (B, L) uint8, any
    L: the 8-aligned head in parallel, then <= 7 serial tail bytes."""
    B, block_len = blocks.shape
    main = (block_len // 8) * 8
    if main:
        reg = _crc32c_linear(blocks[:, :main])
    else:
        reg = torch.zeros((B,), dtype=torch.int64, device=blocks.device)
    _, t0 = _crc_tables(blocks.device)
    for t in range(main, block_len):
        byte = blocks[:, t].long()
        reg = (reg >> 8) ^ t0[(reg ^ byte) & 0xFF]
    return reg


def _as_blocks(blocks) -> torch.Tensor:
    blocks = torch.as_tensor(blocks)
    if blocks.dtype != torch.uint8 or blocks.ndim != 2:
        raise ValueError(f"blocks must be (B, L) uint8, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    return blocks


def crc32c_blocks(blocks, init: int = 0xFFFFFFFF,
                  xorout: int = 0xFFFFFFFF) -> torch.Tensor:
    """CRC-32C of each row of (B, L) uint8, as (B,) int64. Defaults =
    standard CRC-32C; use init=seed, xorout=0 for the raw
    ceph_crc32c(seed, ·) convention (what HashInfo stores, seed -1)."""
    blocks = _as_blocks(blocks)
    block_len = int(blocks.shape[1])
    init &= _M32
    xorout &= _M32
    const = apply_shift(init, block_len) ^ xorout if block_len \
        else init ^ xorout
    return _crc32c_zero_seed(blocks) ^ const


def crc32c_extend(regs, blocks) -> torch.Tensor:
    """Advance raw CRC registers through one block each: regs (B,)
    (uint32 values; array or tensor), blocks (B, L) uint8 -> (B,) int64,
    the batched form of
    ceph_crc32c(reg, block): shift^{L}(reg) ^ crc_0(block). The twin
    pads L to a power of two (one XLA program per bucket) and un-shifts
    the padding on the host; eager torch needs neither, and the result
    is the same."""
    blocks = _as_blocks(blocks)
    if not isinstance(regs, torch.Tensor):
        regs = torch.from_numpy(np.asarray(regs).astype(np.int64))
    regs = regs.to(device=blocks.device, dtype=torch.int64)
    if regs.shape != blocks.shape[:1]:
        raise ValueError(f"regs must be ({blocks.shape[0]},), got "
                         f"{tuple(regs.shape)}")
    regs = regs & _M32
    return _apply_shift(regs, int(blocks.shape[1])) \
        ^ _crc32c_zero_seed(blocks)
