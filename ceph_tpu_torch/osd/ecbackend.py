"""The device programs of the erasure-coded PG data path.

Twin of the device half of ceph_tpu/osd/ecbackend.py (ref:
src/osd/ECBackend.{h,cc}; per-shard HashInfo ref: src/osd/ECUtil.{h,cc}).
This slice holds only the programs that the write and recovery paths
launch; the ECBackend class, RecoveryRunner and ShardSet come later.

- `_fused_write_fn(...)(data)`: parity encode plus the raw hinfo
  CRC32C (seed -1, no final xor) of all k+m rows of every object.
- `_build_recover_program(dec_fn, verify, host_crc)`: decode, then the
  CRC of the rebuilt rows, then the CRC of the helpers' XOR-fold,
  compared with `_expected_fold_crcs`.

Everything runs on the device the stripes lie on; no program copies
to the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..csum.kernels import crc32c_blocks
from ..ec.interface import resolve_device
from ..ops.rs_kernels import make_encoder, xor_reduce

_SEED = 0xFFFFFFFF


@functools.lru_cache(maxsize=256)
def _fused_write_fn(matrix_bytes: bytes, m: int, k: int, impl: str,
                    sl: int, bucket: int, device: torch.device):
    """Process-wide cache: every PG backend with the same coder geometry
    shares one program per (shard len, batch bucket, device). The
    program maps (bucket, k, sl) u8 data on `device` to ((bucket, m, sl)
    parity, (bucket, k+m) raw hinfo CRCs in dense row order), the CRCs as
    int64 tensors holding uint32 values (see csum/kernels.py)."""
    matrix = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(m, k)
    enc = make_encoder(matrix, impl, bucket_batch=False)
    device = resolve_device(device)

    def fused(d: torch.Tensor):
        if d.shape != (bucket, k, sl) or d.dtype != torch.uint8 \
                or d.device != device:
            raise ValueError(
                f"fused write wants ({bucket}, {k}, {sl}) uint8 on "
                f"{device}, got {tuple(d.shape)} {d.dtype} on {d.device}")
        parity = enc(d)
        # the CRCs of [data; parity] rows, without concatenating them
        dcrc = crc32c_blocks(d.reshape(bucket * k, sl), init=_SEED,
                             xorout=0).reshape(bucket, k)
        pcrc = crc32c_blocks(parity.reshape(bucket * m, sl), init=_SEED,
                             xorout=0).reshape(bucket, m)
        return parity, torch.cat([dcrc, pcrc], dim=1)
    return fused


@functools.lru_cache(maxsize=256)
def _fold_seed_const(sl: int) -> int:
    """shift^{sl}(0xFFFFFFFF): the seed contribution inside a raw
    hinfo CRC of an sl-byte row (crc_{-1}(m) = crc_0(m) ^ K)."""
    from ..csum.reference import apply_shift
    return int(apply_shift(0xFFFFFFFF, sl))


def _expected_fold_crcs(exp: np.ndarray, sl: int) -> np.ndarray:
    """Expected raw CRC of the XOR-fold of H helper rows, from their
    expected per-row hinfo CRCs. CRC32C is GF(2)-linear in the message:
    crc_0(r0 ^ .. ^ rH) = XOR_i crc_0(r_i), and the -1 seed adds the
    constant K = shift^{sl}(-1) per row — so H rows verify with ONE
    data-pass checksum instead of H."""
    K = np.uint32(_fold_seed_const(sl))
    folded = np.bitwise_xor.reduce(exp.astype(np.uint32) ^ K, axis=1)
    return folded ^ K


def _build_recover_program(dec_fn, verify: bool, host_crc: bool):
    """One recovery program per (decode function, verify, mode).

    host_crc mode: fn(stack) -> (rebuilt[, helper-fold]); the caller
    checksums on the host. Device mode: fn(stack, expfold) -> (rebuilt,
    rebuilt CRCs, fold-ok), all on the stack's device; expfold (B,) is
    what `_expected_fold_crcs` gives, best passed as an int64 tensor
    already on that device (a host array is uploaded here)."""
    if host_crc:
        def fused_host(stack: torch.Tensor):     # (B, H, sl) u8
            rebuilt = dec_fn(stack)              # (B, E, sl)
            if verify:
                return rebuilt, xor_reduce(stack, dim=1)
            return (rebuilt,)
        return fused_host

    def fused(stack: torch.Tensor, expfold):     # (B, H, rl) u8, (B,)
        B = stack.shape[0]
        rebuilt = dec_fn(stack)        # (B, E, sl) — sl may exceed the
        E = rebuilt.shape[1]           # staged rl (range plans ship
        out_len = rebuilt.shape[2]     # sub-chunks, rebuild whole rows)
        rcrc = crc32c_blocks(rebuilt.reshape(B * E, out_len), init=_SEED,
                             xorout=0).reshape(B, E)
        if verify:
            fold = xor_reduce(stack, dim=1)
            fcrc = crc32c_blocks(fold, init=_SEED, xorout=0)
            if not isinstance(expfold, torch.Tensor):
                expfold = torch.from_numpy(
                    np.asarray(expfold).astype(np.int64))
            ok = fcrc == expfold.to(device=stack.device, dtype=torch.int64)
        else:
            ok = torch.ones((B,), dtype=torch.bool, device=stack.device)
        return rebuilt, rcrc, ok
    return fused
