"""Pure-numpy GF(2^8) linear algebra — the host-side oracle.

Copy of ceph_tpu/gf/numpy_ref.py, kept in the port so that
ceph_tpu_torch imports nothing of ceph_tpu.

Plays two roles:
  1. Test oracle for the torch ops and the CUDA GF kernel (slow but obviously
     correct, mirrors jerasure's galois_* / jerasure_matrix_* semantics;
     ref: src/erasure-code/jerasure/jerasure/src/jerasure.c).
  2. Host-side construction of tiny decode matrices (invert a k x k
     surviving submatrix — microseconds on host, not worth a device trip;
     jerasure does the same on CPU in jerasure_matrix_decode).
"""

from __future__ import annotations

import numpy as np

from .tables import GF_EXP, GF_LOG, inv_table, mul_table


def gf_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise GF(2^8) product of uint8 arrays (broadcasting ok)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    la = GF_LOG[a].astype(np.int32)
    lb = GF_LOG[b].astype(np.int32)
    out = GF_EXP[la + lb]
    return np.where((a == 0) | (b == 0), np.uint8(0), out)


def gf_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product: XOR-accumulated gf_mul. A:(r,k) B:(k,c)."""
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    assert A.shape[1] == B.shape[0], (A.shape, B.shape)
    prod = gf_mul(A[:, :, None], B[None, :, :])  # (r, k, c)
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_matvec(A: np.ndarray, x: np.ndarray) -> np.ndarray:
    return gf_matmul(A, np.asarray(x, dtype=np.uint8).reshape(-1, 1)).reshape(-1)


def gf_inv_matrix(A: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan elimination.

    Semantics of jerasure_invert_matrix (jerasure.c): row swaps for zero
    pivots, scale pivot row by pivot^-1, eliminate all other rows.
    Raises ValueError on singular input.
    """
    A = np.array(A, dtype=np.uint8, copy=True)
    n = A.shape[0]
    assert A.shape == (n, n), A.shape
    inv = np.eye(n, dtype=np.uint8)
    invt = inv_table()
    mt = mul_table()
    for col in range(n):
        pivot = col
        while pivot < n and A[pivot, col] == 0:
            pivot += 1
        if pivot == n:
            raise ValueError("singular GF(2^8) matrix")
        if pivot != col:
            A[[col, pivot]] = A[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        p = A[col, col]
        if p != 1:
            pinv = invt[p]
            A[col] = mt[pinv, A[col]]
            inv[col] = mt[pinv, inv[col]]
        for row in range(n):
            if row != col and A[row, col] != 0:
                f = A[row, col]
                A[row] ^= mt[f, A[col]]
                inv[row] ^= mt[f, inv[col]]
    return inv


def encode_ref(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Reference systematic encode: parity = matrix @ data.

    matrix: (m, k) uint8 coding matrix.
    data:   (..., k, L) uint8 chunk bytes (leading batch dims allowed).
    returns (..., m, L) parity chunks.

    Mirrors jerasure_matrix_encode (jerasure.c): each coding chunk is the
    XOR over data chunks of the GF product with its matrix coefficient.
    """
    matrix = np.asarray(matrix, dtype=np.uint8)
    data = np.asarray(data, dtype=np.uint8)
    m, k = matrix.shape
    assert data.shape[-2] == k, (matrix.shape, data.shape)
    mt = mul_table()
    out = np.zeros(data.shape[:-2] + (m, data.shape[-1]), dtype=np.uint8)
    for i in range(m):
        acc = np.zeros(data.shape[:-2] + (data.shape[-1],), dtype=np.uint8)
        for j in range(k):
            c = matrix[i, j]
            if c == 0:
                continue
            acc ^= mt[c, data[..., j, :]]
        out[..., i, :] = acc
    return out


def decode_matrix(matrix: np.ndarray, erasures: list[int], k: int,
                  survivors: list[int] | None = None) -> np.ndarray:
    """Build the decode matrix for recovering erased chunks.

    matrix: (m, k) coding matrix of the systematic code [I; matrix].
    erasures: chunk ids that were lost (data ids < k, parity ids >= k).
    survivors: the k chunk ids actually used as decode input, in the
        order they will be stacked; defaults to the first k non-erased
        ids. Returns (len(erasures), k) matrix D with lost = D @ survivors.

    Same construction as jerasure_matrix_decode (jerasure.c): take the
    rows of [I; matrix] for the k chosen survivors, invert, then for each
    erased data chunk use the corresponding row of the inverse; for each
    erased parity chunk re-encode from the recovered data row combination.
    """
    matrix = np.asarray(matrix, dtype=np.uint8)
    m, _ = matrix.shape
    n = k + m
    erased = set(erasures)
    if any(not 0 <= e < n for e in erased):
        raise ValueError(f"erasure ids must be in [0, {n}), got {sorted(erased)}")
    if len(erased) > m:
        raise ValueError(f"cannot decode {len(erased)} erasures with m={m}")
    if survivors is None:
        survivors = [i for i in range(n) if i not in erased][:k]
    if (len(survivors) != k or erased & set(survivors)
            or any(not 0 <= s < n for s in survivors)):
        raise ValueError("need exactly k surviving chunk ids disjoint from erasures")
    full = np.vstack([np.eye(k, dtype=np.uint8), matrix])  # (n, k)
    sub = full[survivors]  # (k, k)
    inv = gf_inv_matrix(sub)
    rows = []
    for e in erasures:
        if e < k:
            rows.append(inv[e])
        else:
            # parity chunk: its row in [I;C] applied to recovered data
            rows.append(gf_matmul(matrix[e - k].reshape(1, -1), inv).reshape(-1))
    return np.asarray(rows, dtype=np.uint8)


def decode_ref(matrix: np.ndarray, chunks: dict[int, np.ndarray], erasures: list[int],
               k: int) -> dict[int, np.ndarray]:
    """Reference decode: reconstruct `erasures` from surviving `chunks`.

    chunks: {chunk_id: (..., L) uint8}; must contain >= k survivors.
    Returns {erased_id: recovered bytes}.
    """
    erased = set(erasures)
    survivors = sorted(i for i in chunks if i not in erased)[:k]
    D = decode_matrix(matrix, list(erasures), k, survivors)
    stack = np.stack([chunks[s] for s in survivors], axis=-2)  # (..., k, L)
    rec = encode_ref(D, stack)  # (..., E, L)
    return {e: rec[..., idx, :] for idx, e in enumerate(erasures)}
