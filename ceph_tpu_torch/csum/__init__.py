"""Checksum subsystem of the port: crc32c / xxhash, batched on torch
tensors.

  reference.py   — pure numpy/python oracles + table/matrix construction
                   (a copy of the twin's)
  kernels.py     — batched crc32c / xxh32 / xxh64: the hand kernels of
                   csrc/csum.cu on the card, plain torch ops on the CPU
  checksummer.py — Checksummer-style per-block calculate/verify API
"""

from .checksummer import CSUM_ALGORITHMS, Checksummer  # noqa: F401
from .reference import ceph_crc32c, crc32c, xxh32, xxh64  # noqa: F401
