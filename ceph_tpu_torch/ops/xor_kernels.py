"""Batched XOR-schedule apply for bitmatrix codecs, on torch tensors.

Twin of ceph_tpu/ops/xor_kernels.py (ref: jerasure.c
jerasure_bitmatrix_encode / jerasure_do_parity). The bitmatrix is
static, so the schedule unrolls into a tree of elementwise u8 XORs over
(batch, packet_bytes) blocks on the device the data lies on.

Unit of work: (batch, n_in, chunk) uint8, chunk = w packets. Output
(batch, n_out, chunk) where n_out = bitmatrix.rows / w.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _apply_xor(bm: np.ndarray, w: int, data: torch.Tensor) -> torch.Tensor:
    """data: (B, n_in, w*pkt) -> (B, n_out, w*pkt) per the GF(2) bm."""
    rows, cols = bm.shape
    B, n_in, L = data.shape
    if n_in * w != cols:
        raise ValueError(f"data has {n_in} chunks of {w} packets but "
                         f"bitmatrix expects {cols} packet rows")
    pkt = L // w
    x = data.reshape(B, cols, pkt)
    outs = []
    for r in range(rows):
        acc = None
        for c in np.nonzero(bm[r])[0]:
            term = x[:, int(c), :]
            acc = term.clone() if acc is None else acc.bitwise_xor_(term)
        if acc is None:
            acc = torch.zeros((B, pkt), dtype=torch.uint8, device=data.device)
        outs.append(acc)
    out = torch.stack(outs, dim=1)  # (B, rows, pkt)
    return out.reshape(B, rows // w, L)


@functools.lru_cache(maxsize=128)
def _make_fn(bm_bytes: bytes, rows: int, cols: int, w: int):
    bm = np.frombuffer(bm_bytes, dtype=np.uint8).reshape(rows, cols)
    return functools.partial(_apply_xor, bm, w)


def make_xor_encoder(bitmatrix: np.ndarray, w: int):
    """Closure: XOR schedule for a fixed (rows, k*w) bitmatrix. Works
    for encode and decode alike (both are GF(2) matrix applies over
    packet rows)."""
    bm = np.ascontiguousarray(bitmatrix, dtype=np.uint8) & 1
    if bm.shape[0] % w:
        raise ValueError(f"bitmatrix rows {bm.shape[0]} not a multiple "
                         f"of w={w}")
    return _make_fn(bm.tobytes(), *bm.shape, w)


def xor_schedule_ref(bitmatrix: np.ndarray, w: int,
                     data: np.ndarray) -> np.ndarray:
    """Pure-numpy oracle for the XOR schedule (the jerasure_bitmatrix_
    encode semantics), used by tests to pin the device kernels."""
    bm = np.asarray(bitmatrix, dtype=np.uint8) & 1
    data = np.asarray(data, np.uint8)
    squeeze = data.ndim == 2
    if squeeze:
        data = data[None]
    B, n_in, L = data.shape
    rows, cols = bm.shape
    pkt = L // w
    x = data.reshape(B, cols, pkt)
    out = np.zeros((B, rows, pkt), dtype=np.uint8)
    for r in range(rows):
        for c in np.nonzero(bm[r])[0]:
            out[:, r, :] ^= x[:, c, :]
    out = out.reshape(B, rows // w, L)
    return out[0] if squeeze else out
