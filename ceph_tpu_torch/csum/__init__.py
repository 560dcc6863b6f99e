"""Checksum subsystem of the port: crc32c, batched on torch tensors.

  reference.py — pure numpy/python oracles + table/matrix construction
                 (a copy of the twin's)
  kernels.py   — batched crc32c on the device the blocks lie on
"""

from .reference import ceph_crc32c, crc32c, xxh32, xxh64  # noqa: F401
