"""Derive static repair matrices from any positionwise codec.

Copy of ceph_tpu/ec/linearize.py, kept in the port so that
ceph_tpu_torch imports nothing of ceph_tpu. The probes stay numpy
(`default_rng(seed)`), so the derived matrices are the same bytes as
the twin's; the coder's tensor outputs are fetched with `host_array`.

Every positionwise-linear codec (all matrix codes: RS, LRC layers,
bitmatrix techniques viewed per byte position) satisfies
  lost_chunk = XOR_h C[h] * helper_chunk        (GF(2^8), byte-wise)
for SOME coefficient row C once the helper set can repair the loss.
This module recovers C empirically — probe the codec with random
objects, read one byte column per sample, solve the GF linear system,
verify on held-out samples and full chunks — so callers get a static
matrix usable in fused/sharded device pipelines even when the codec
(e.g. LRC's layered planner, ref: src/erasure-code/lrc/
ErasureCodeLrc.cc minimum_to_decode layer walk) only exposes a
procedural decode.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..gf.numpy_ref import gf_inv_matrix, gf_matmul
from .interface import CHUNK_ALIGNMENT, ErasureCode, host_array


def derive_delta_matrix(coder: ErasureCode,
                        touched: Sequence[int]) -> np.ndarray:
    """(m, len(touched)) GF matrix D with
    parity_delta = D (GF@) data_delta, byte-wise — the parity-update
    rule of a partial-stripe overwrite (delta_j = G[j,i] (x) (new_i ^
    old_i), ref: the RMW parity math in ECCommon; arxiv 1709.05365's
    online-EC overwrite cost model). `touched` names DENSE data rows
    (encode_chunks order).

    Probed, not assumed: unit vectors recover the candidate columns,
    then a random held-out delta must reproduce encode_chunks exactly
    — codecs whose per-byte map is not a GF(2^8) scalar (bitmatrix
    techniques) fail the verify and callers fall back to the generic
    XOR-linear path (encode_chunks of the zero-padded delta), which
    is always correct for additive codes.

    Raises ValueError when the codec is not positionwise or the probe
    verify fails."""
    if not getattr(coder, "positionwise", True):
        raise ValueError("codec couples byte positions (not positionwise); "
                         "no per-byte delta matrix exists")
    touched = [int(t) for t in touched]
    k = coder.get_data_chunk_count()
    m = coder.get_coding_chunk_count()
    bad = [t for t in touched if not 0 <= t < k]
    if bad:
        raise ValueError(f"touched rows must be data rows in [0, {k}), "
                         f"got {sorted(bad)}")
    L = 128     # any length works for a positionwise code
    D = np.zeros((m, len(touched)), np.uint8)
    probe = np.zeros((len(touched), k, L), np.uint8)
    for ti, t in enumerate(touched):
        probe[ti, t, :] = 1     # GF multiplicative identity
    parity = host_array(coder.encode_chunks(probe))     # (t, m, L)
    for ti in range(len(touched)):
        col = parity[ti, :, 0]
        if not np.array_equal(parity[ti],
                              np.repeat(col[:, None], L, axis=1)):
            raise ValueError("per-byte parity map is not constant "
                             "across positions; no scalar delta matrix")
        D[:, ti] = col
    # verify: a random delta through D must equal encode_chunks
    rng = np.random.default_rng(1)
    delta = rng.integers(0, 256, (len(touched), L), np.uint8)
    full = np.zeros((1, k, L), np.uint8)
    for ti, t in enumerate(touched):
        full[0, t] = delta[ti]
    want = host_array(coder.encode_chunks(full))[0]     # (m, L)
    if not np.array_equal(gf_matmul(D, delta), want):
        raise ValueError("delta matrix failed the held-out verify; "
                         "codec's per-byte map is not a GF(2^8) scalar")
    return D


def derive_repair_matrix(coder: ErasureCode, lost: Sequence[int],
                         helpers: Sequence[int],
                         seed: int = 0) -> np.ndarray:
    """(len(lost), len(helpers)) GF matrix R with
    lost_chunks = R (GF@) helper_chunks, byte-wise.

    Raises ValueError when the codec is not positionwise or the probe
    system is singular (helpers insufficient)."""
    if not getattr(coder, "positionwise", True):
        raise ValueError("codec couples byte positions (not positionwise); "
                         "no per-byte repair matrix exists")
    lost = [int(s) for s in lost]
    helpers = [int(s) for s in helpers]
    n = coder.get_chunk_count()
    k = coder.get_data_chunk_count()
    H = len(helpers)
    cs = coder.get_chunk_size(k * CHUNK_ALIGNMENT)
    rng = np.random.default_rng(seed)
    S = H + 4
    A = np.zeros((S, H), np.uint8)     # helper byte columns
    Y = np.zeros((S, len(lost)), np.uint8)
    full = []
    for s in range(S):
        obj = rng.integers(0, 256, k * cs, np.uint8)
        enc = {c: host_array(v)
               for c, v in coder.encode(range(n), obj).items()}
        full.append(enc)
        A[s] = [enc[h][0] for h in helpers]
        Y[s] = [enc[t][0] for t in lost]
    sq = A[:H]
    try:
        inv = gf_inv_matrix(sq)
    except (ValueError, np.linalg.LinAlgError):
        raise ValueError("probe system singular; try different helpers "
                         "or another seed") from None
    R = gf_matmul(inv, Y[:H]).T        # (len(lost), H)
    # verify: held-out byte columns AND every byte of one full sample
    if not np.array_equal(gf_matmul(A[H:], R.T), Y[H:]):
        raise ValueError("repair relation failed held-out samples; "
                         "helpers cannot linearly produce the lost chunks")
    enc = full[0]
    hstack = np.stack([np.asarray(enc[h]) for h in helpers])  # (H, cs)
    want = np.stack([np.asarray(enc[t]) for t in lost])
    if not np.array_equal(gf_matmul(R, hstack), want):
        raise ValueError("repair matrix valid at byte 0 only — codec is "
                         "not positionwise after all")
    return R
