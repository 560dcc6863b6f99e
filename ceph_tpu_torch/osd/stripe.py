"""Stripe geometry + per-shard integrity bookkeeping.

Twin of ceph_tpu/osd/stripe.py: the layout rules and the hinfo byte
format are the twin's, byte for byte. `HashInfo.append` runs its CRC
extension on the device its caller names (the card unless the caller
passes `device="cpu"`).

Rebuild of the reference's EC stripe math (ref: src/osd/ECUtil.{h,cc} —
`stripe_info_t` with stripe_width = k * chunk_size, the logical<->chunk
offset maps used by ECBackend/ECTransaction to turn object byte ranges
into shard sub-ranges, and `HashInfo`, the per-shard cumulative crc32c
vector stored in the hinfo xattr and checked by deep scrub).

This file freezes the on-host byte format:

  * an object's logical bytes are laid out round-robin in stripe units:
    stripe s, chunk j holds logical bytes
    [s*stripe_width + j*chunk_size, s*stripe_width + (j+1)*chunk_size);
  * each shard's store file is the concatenation of its chunk of every
    stripe (so shard offset = logical_offset / k for aligned offsets);
  * objects are zero-padded up to the next stripe boundary (matching
    ErasureCode::encode's padding rule; trailing zeros are trimmed on
    read via the recorded object size).

Because GF encoding is positionwise, applying a coding matrix across
whole shard arrays encodes every stripe at once — the layout here is
exactly what the batched kernels consume: (batch, shard, shard_len).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import torch

from ..csum.kernels import crc32c_extend
from ..csum.reference import ceph_crc32c
from ..ec.interface import resolve_device


def as_flat_u8(data) -> np.ndarray:
    """Coerce bytes/memoryview/array input to a flat uint8 array — the
    one shared byte-coercion rule for every write path."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    return np.asarray(data, np.uint8).ravel()


@dataclass(frozen=True)
class StripeInfo:
    """Geometry of one EC pool's stripes (ref: ECUtil::stripe_info_t)."""

    k: int
    chunk_size: int  # bytes each shard contributes per stripe

    def __post_init__(self):
        if self.k < 1 or self.chunk_size < 1:
            raise ValueError(f"bad stripe geometry k={self.k} "
                             f"chunk_size={self.chunk_size}")

    @property
    def stripe_width(self) -> int:
        return self.k * self.chunk_size

    # -- offset maps (ref: stripe_info_t logical<->chunk methods) ---------

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - offset % self.stripe_width

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.stripe_width

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        """Shard-file offset of the stripe containing logical `offset`."""
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.chunk_size

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        if offset % self.stripe_width:
            raise ValueError(f"offset {offset} not stripe-aligned "
                             f"(stripe_width={self.stripe_width})")
        return offset // self.k

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        if offset % self.chunk_size:
            raise ValueError(f"chunk offset {offset} not chunk-aligned "
                             f"(chunk_size={self.chunk_size})")
        return offset * self.k

    def offset_len_to_stripe_bounds(self, offset: int,
                                    length: int) -> tuple[int, int]:
        """Smallest stripe-aligned (offset, len) covering the range —
        what an RMW must read (ref: sinfo usage in ECCommon::RMWPipeline)."""
        start = self.logical_to_prev_stripe_offset(offset)
        end = self.logical_to_next_stripe_offset(offset + length)
        return start, end - start

    def offset_len_to_chunk_bounds(self, offset: int,
                                   length: int) -> tuple[int, int]:
        """Shard-file (offset, len) each shard must touch for the range."""
        start, width = self.offset_len_to_stripe_bounds(offset, length)
        return start // self.k, width // self.k

    def chunk_index_of(self, offset: int) -> int:
        """Which data shard holds logical byte `offset`."""
        return (offset % self.stripe_width) // self.chunk_size

    def object_size_to_shard_size(self, object_size: int) -> int:
        return self.logical_to_next_chunk_offset(object_size)

    # -- layout transforms -------------------------------------------------

    def object_to_shards(self, data) -> np.ndarray:
        """(B, object_bytes) or flat bytes -> (B, k, shard_len) uint8,
        zero-padded to the next stripe boundary."""
        arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) else np.asarray(
                data, np.uint8)
        squeeze = arr.ndim == 1
        if squeeze:
            arr = arr[None, :]
        b, n = arr.shape
        padded_len = self.logical_to_next_stripe_offset(n)
        padded = np.zeros((b, padded_len), dtype=np.uint8)
        padded[:, :n] = arr
        n_stripes = padded_len // self.stripe_width
        shards = padded.reshape(b, n_stripes, self.k, self.chunk_size)
        shards = shards.transpose(0, 2, 1, 3).reshape(
            b, self.k, n_stripes * self.chunk_size)
        return shards[0] if squeeze else shards

    def shards_to_object(self, shards: np.ndarray,
                         object_size: int | None = None) -> np.ndarray:
        """Inverse of object_to_shards; trims padding if object_size given."""
        arr = np.asarray(shards, np.uint8)
        squeeze = arr.ndim == 2
        if squeeze:
            arr = arr[None]
        b, k, shard_len = arr.shape
        if k != self.k or shard_len % self.chunk_size:
            raise ValueError(f"shards shape {arr.shape[1:]} does not match "
                             f"k={self.k} chunk_size={self.chunk_size}")
        n_stripes = shard_len // self.chunk_size
        obj = arr.reshape(b, self.k, n_stripes, self.chunk_size)
        obj = obj.transpose(0, 2, 1, 3).reshape(b, n_stripes * self.stripe_width)
        if object_size is not None:
            obj = obj[:, :object_size]
        return obj[0] if squeeze else obj


_HINFO_SEED = 0xFFFFFFFF  # the reference seeds shard CRCs with -1


@dataclass
class HashInfo:
    """Cumulative per-shard crc32c (ref: ECUtil::HashInfo, stored in the
    hinfo_key xattr; appended on every shard write, compared by deep
    scrub). Register convention: ceph_crc32c chained from seed -1."""

    n_shards: int
    total_chunk_size: int = 0
    cumulative_shard_hashes: list[int] = field(default_factory=list)

    def __post_init__(self):
        if not self.cumulative_shard_hashes:
            self.cumulative_shard_hashes = [_HINFO_SEED] * self.n_shards
        if len(self.cumulative_shard_hashes) != self.n_shards:
            raise ValueError("hash vector length != n_shards")

    def append(self, old_size: int, shard_chunks: np.ndarray,
               device=None) -> None:
        """Extend every shard's CRC with its new chunk bytes.

        shard_chunks: (n_shards, L) uint8 — the bytes appended to each
        shard at shard-offset old_size (must equal current total, the
        same append-only invariant the reference asserts). The CRC
        extension runs on `device` (None: the CUDA device).
        """
        chunks = np.asarray(shard_chunks, np.uint8)
        if chunks.ndim != 2 or chunks.shape[0] != self.n_shards:
            raise ValueError(f"shard_chunks must be ({self.n_shards}, L), "
                             f"got {chunks.shape}")
        if old_size != self.total_chunk_size:
            raise ValueError(f"append at shard offset {old_size} but "
                             f"current shard size is {self.total_chunk_size}")
        if chunks.shape[1] == 0:
            return
        device = resolve_device(device)
        regs = torch.tensor(self.cumulative_shard_hashes, dtype=torch.int64,
                            device=device)
        new = crc32c_extend(regs, torch.from_numpy(
            np.ascontiguousarray(chunks)).to(device))
        new = new.cpu().numpy().astype(np.uint32)
        self.cumulative_shard_hashes = [int(v) for v in new]
        self.total_chunk_size += chunks.shape[1]

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]

    def verify_shard(self, shard: int, data: np.ndarray) -> bool:
        """Deep-scrub check: does this shard's full byte stream hash to
        the recorded cumulative CRC? (host path; batched scrub uses
        csum.kernels directly)."""
        arr = np.asarray(data, np.uint8).ravel()
        if arr.size != self.total_chunk_size:
            return False
        return ceph_crc32c(_HINFO_SEED, arr) == \
            self.cumulative_shard_hashes[shard]

    # -- serialization (the hinfo xattr byte format) -----------------------

    def to_bytes(self) -> bytes:
        import struct
        return struct.pack(
            f"<II{self.n_shards}I", self.n_shards,
            self.total_chunk_size, *self.cumulative_shard_hashes)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "HashInfo":
        import struct
        n, total = struct.unpack_from("<II", raw)
        hashes = list(struct.unpack_from(f"<{n}I", raw, 8))
        return cls(n_shards=n, total_chunk_size=total,
                   cumulative_shard_hashes=hashes)
