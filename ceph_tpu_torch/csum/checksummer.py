"""Checksummer — per-block checksum calculate/verify.

Twin of ceph_tpu/csum/checksummer.py (ref: src/os/bluestore/
Checksummer.h — crc32c / crc32c_16 / crc32c_8 / xxhash32 / xxhash64,
`calculate` filling a csum vector per csum_block and `verify` returning
the first bad offset). `data` is all the blocks of a blob at once and
the per-block checksums come back from one kernel launch.

The crc32c variants use the reference's convention: register seeded with
-1, no final inversion (what BlueStore stores on disk). The truncated
crc32c_16/_8 keep the low 16/8 bits, like the reference's templates.

`device` widens the twin's bool: True means the card (resolved by
ec.interface.resolve_device, so it raises without CUDA), False the
numpy/python oracle as in the twin, and a torch.device or a string that
device ("cpu" runs the kernels' plain versions). A uint8 tensor already
on the chosen device is checksummed where it lies; only the checksums
come back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ec.interface import resolve_device
from . import kernels, reference

CSUM_ALGORITHMS = ("crc32c", "crc32c_16", "crc32c_8", "xxhash32", "xxhash64")
_CRC_SEED = 0xFFFFFFFF  # BlueStore seeds the register with -1
_CRC_MASK = {"crc32c": 0xFFFFFFFF, "crc32c_16": 0xFFFF, "crc32c_8": 0xFF}


def _as_blocks(data, block_size: int):
    """Flat bytes or (nblocks, bs) rows -> (nblocks, bs) uint8: a tensor
    stays a tensor (on its device), anything else becomes numpy."""
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8:
            raise ValueError(f"data must be uint8, got {data.dtype}")
        arr = data
    elif isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        arr = np.asarray(data, np.uint8)
    if arr.ndim == 1:
        if arr.shape[0] % block_size:
            raise ValueError(
                f"data length {arr.shape[0]} not a multiple of csum block "
                f"size {block_size}")
        return arr.reshape(-1, block_size)
    if arr.ndim != 2 or arr.shape[1] != block_size:
        raise ValueError(f"data must be flat bytes or (nblocks, "
                         f"{block_size}), got shape {tuple(arr.shape)}")
    return arr


@dataclass(frozen=True)
class Checksummer:
    """One algorithm + block size, like a blob's csum settings."""

    algorithm: str = "crc32c"
    block_size: int = 4096  # bluestore csum_block_size default

    def __post_init__(self):
        if self.algorithm not in CSUM_ALGORITHMS:
            raise ValueError(f"unknown csum algorithm {self.algorithm!r}; "
                             f"one of {CSUM_ALGORITHMS}")
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")

    @property
    def csum_value_size(self) -> int:
        """Bytes per stored checksum (ref: Checksummer value_t sizes)."""
        return {"crc32c": 4, "crc32c_16": 2, "crc32c_8": 1,
                "xxhash32": 4, "xxhash64": 8}[self.algorithm]

    def calculate(self, data, device=True) -> np.ndarray:
        """Per-block checksums of `data` (flat bytes or (nblocks, bs);
        bytes, an array or a uint8 tensor).

        Returns uint32 (or uint64 for xxhash64), one value per block.
        device=False forces the numpy/python oracle; True runs on the
        card; a torch.device or string runs on that device.
        """
        blocks = _as_blocks(data, self.block_size)
        if device is False:
            if isinstance(blocks, torch.Tensor):
                blocks = blocks.cpu().numpy()
            return self._calculate_host(blocks)
        dev = resolve_device(None if device is True else device)
        if not isinstance(blocks, torch.Tensor):
            blocks = np.ascontiguousarray(blocks)
            if not blocks.flags.writeable:
                blocks = blocks.copy()
            blocks = torch.from_numpy(blocks)
        blocks = blocks.to(dev)
        a = self.algorithm
        if a in _CRC_MASK:
            out = kernels.crc32c_blocks(blocks, init=_CRC_SEED, xorout=0)
            return (out & _CRC_MASK[a]).cpu().numpy().astype(np.uint32)
        if a == "xxhash32":
            return kernels.xxh32_blocks(blocks, seed=0).cpu().numpy() \
                .astype(np.uint32)
        pairs = kernels.xxh64_blocks(blocks, seed=0).cpu().numpy() \
            .astype(np.uint64)
        return (pairs[:, 0] << np.uint64(32)) | pairs[:, 1]

    def _calculate_host(self, blocks: np.ndarray) -> np.ndarray:
        a = self.algorithm
        if a in _CRC_MASK:
            return np.array([reference.ceph_crc32c(_CRC_SEED, row)
                             & _CRC_MASK[a] for row in blocks],
                            dtype=np.uint32)
        if a == "xxhash32":
            return np.array([reference.xxh32(row) for row in blocks],
                            dtype=np.uint32)
        return np.array([reference.xxh64(row) for row in blocks],
                        dtype=np.uint64)

    def verify(self, data, expected, device=True) -> int:
        """Return -1 if every block's checksum matches `expected`, else
        the BYTE offset of the first bad block (mirrors the reference's
        `verify` returning the bad_csum offset for _verify_csum's EIO)."""
        got = self.calculate(data, device=device)
        expected = np.asarray(expected)
        if expected.shape != got.shape:
            raise ValueError(f"expected {got.shape[0]} checksums, "
                             f"got {expected.shape}")
        bad = np.nonzero(got != expected.astype(got.dtype))[0]
        if bad.size == 0:
            return -1
        return int(bad[0]) * self.block_size
