"""Coding-matrix construction, jerasure-compatible.

Copy of ceph_tpu/ec/matrices.py (numpy only), kept in the port so that
ceph_tpu_torch imports nothing of ceph_tpu.

Re-derives the matrix algorithms of the reference's jerasure plugin
(ref: src/erasure-code/jerasure/ErasureCodeJerasure.cc techniques
`reed_sol_van`, `cauchy_orig`, `cauchy_good`; C library
src/erasure-code/jerasure/jerasure/src/reed_sol.c, cauchy.c).

NOTE on bit-exactness: the reference mount was empty at survey time
(SURVEY.md citation notice), so these are from-first-principles
implementations of the published algorithms (Plank's 1997 RS tutorial +
2005 correction; Blomer et al. Cauchy codes), with the gf-complete w=8
primitive polynomial 0x11D. Pinned non-regression corpora in
tests/corpus/ freeze OUR byte output so it can never drift; if the
reference tree materializes, parity vs jerasure is then a matrix-level
comparison (m x k coefficients), cheap to re-verify.
"""

from __future__ import annotations

import numpy as np

from ..gf.numpy_ref import gf_inv_matrix, gf_matmul
from ..gf.tables import (gf_div_scalar, gf_inv_scalar, gf_mul_scalar,
                         gf_pow_scalar, mul_table)


def vandermonde_raw(rows: int, cols: int) -> np.ndarray:
    """V[i, j] = i**j in GF(2^8) with 0**0 == 1 (Plank's construction)."""
    v = np.zeros((rows, cols), dtype=np.uint8)
    for i in range(rows):
        for j in range(cols):
            v[i, j] = gf_pow_scalar(i, j)
    return v


def reed_sol_van_matrix(k: int, m: int) -> np.ndarray:
    """The `reed_sol_van` coding matrix: (m, k) uint8.

    Algorithm (reed_sol.c reed_sol_big_vandermonde_distribution_matrix):
    build the (k+m) x k Vandermonde matrix V[i,j] = i^j, then apply
    elementary COLUMN operations (which preserve the any-k-rows-invertible
    property) to turn the top k x k block into the identity. The bottom m
    rows are the systematic coding matrix. Column ops, in order, per
    diagonal position i: swap in a nonzero pivot from the right, scale the
    pivot column to make V[i,i] == 1, then cancel every other nonzero
    entry of row i by subtracting a multiple of column i.
    """
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for w=8")
    v = vandermonde_raw(k + m, k)
    mt = mul_table()
    for i in range(k):
        if v[i, i] == 0:
            for j in range(i + 1, k):
                if v[i, j] != 0:
                    v[:, [i, j]] = v[:, [j, i]]
                    break
            else:
                raise AssertionError("vandermonde: no pivot")
        if v[i, i] != 1:
            inv = gf_inv_scalar(int(v[i, i]))
            v[:, i] = mt[inv, v[:, i]]
        for j in range(k):
            if j != i and v[i, j] != 0:
                v[:, j] ^= mt[int(v[i, j]), v[:, i]]
    assert (v[:k] == np.eye(k, dtype=np.uint8)).all()
    return v[k:].copy()


def cauchy_orig_matrix(k: int, m: int) -> np.ndarray:
    """The `cauchy_orig` coding matrix (cauchy.c cauchy_original_coding_matrix):
    element (i, j) = 1 / (i XOR (m + j)) with X_i = i (i < m) and
    Y_j = m + j (j < k); X and Y disjoint so no division by zero."""
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for w=8")
    mat = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            mat[i, j] = gf_div_scalar(1, i ^ (m + j))
    return mat


def _bitmatrix_ones(c: int) -> int:
    """Number of ones in the 8x8 bit-expansion of multiply-by-c."""
    from ..gf.tables import gf_bitmatrix
    return int(gf_bitmatrix(c).sum())


def cauchy_good_matrix(k: int, m: int) -> np.ndarray:
    """The `cauchy_good` matrix (cauchy.c cauchy_improve_coding_matrix).

    Starts from cauchy_orig and reduces total bitmatrix weight:
      1. divide each column j by its row-0 element (row 0 becomes all 1s);
      2. for every other row, try dividing the whole row by each of its
         elements and keep the division that minimizes the row's total
         bit-expansion weight (ones in the 8x8 bitmatrices).
    Division by an element keeps the code MDS (elementary row/col scaling).
    """
    mat = cauchy_orig_matrix(k, m)
    # step 1: normalize row 0 to all ones by scaling columns
    for j in range(k):
        d = int(mat[0, j])
        if d != 1:
            for i in range(m):
                mat[i, j] = gf_div_scalar(int(mat[i, j]), d)
    # step 2: per-row best divisor
    for i in range(1, m):
        best_w = sum(_bitmatrix_ones(int(c)) for c in mat[i])
        best_row = mat[i].copy()
        for div in mat[i].tolist():
            if div in (0, 1):
                continue
            cand = np.array([gf_div_scalar(int(c), int(div)) for c in mat[i]],
                            dtype=np.uint8)
            w = sum(_bitmatrix_ones(int(c)) for c in cand)
            if w < best_w:
                best_w = w
                best_row = cand
        mat[i] = best_row
    return mat


def liberation_like_xor_first_row(mat: np.ndarray) -> bool:
    """True if the first parity row is pure XOR (all-ones) — a documented
    property of reed_sol_van and cauchy_good first rows."""
    return bool((mat[0] == 1).all())


def isa_rs_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L-style RS matrix (semantic mirror of isa-l ec_base.c
    gf_gen_rs_matrix, used by the reference's isa plugin — ref:
    src/erasure-code/isa/ErasureCodeIsa.cc): coding row r has entries
    (2^r)^j — row 0 all ones, row 1 powers of 2, row 2 powers of 4, ...
    NOT guaranteed MDS for every geometry (a known ISA-L caveat); callers
    must check is_mds() or catch singular decode matrices.
    """
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for w=8")
    mat = np.zeros((m, k), dtype=np.uint8)
    gen = 1
    for r in range(m):
        p = 1
        for j in range(k):
            mat[r, j] = p
            p = gf_mul_scalar(p, gen)
        gen = gf_mul_scalar(gen, 2)
    return mat


def isa_cauchy_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L-style Cauchy matrix (semantic mirror of isa-l ec_base.c
    gf_gen_cauchy1, the reference isa plugin's technique=cauchy — ref:
    src/erasure-code/isa/ErasureCodeIsa.cc): coding element (i, j) =
    1 / ((k + i) XOR j). X = {k..k+m-1} and Y = {0..k-1} are disjoint, so
    this is a true Cauchy matrix — MDS for every geometry. Distinct from
    jerasure's cauchy_orig (1 / (i XOR (m + j))), so the two plugins'
    parity bytes differ, as they do in the reference."""
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for w=8")
    mat = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            mat[i, j] = gf_inv_scalar((k + i) ^ j)
    return mat


def reed_sol_r6_matrix(k: int, m: int) -> np.ndarray:
    """The RAID-6 matrix (reed_sol.c reed_sol_r6_coding_matrix): P row is
    plain XOR, Q row is powers of the generator: Q[j] = 2**j. m must be 2."""
    if m != 2:
        raise ValueError(f"reed_sol_r6_op requires m=2, got m={m}")
    mat = np.ones((2, k), dtype=np.uint8)
    for j in range(k):
        mat[1, j] = gf_pow_scalar(2, j)
    return mat


TECHNIQUES = {
    "reed_sol_van": reed_sol_van_matrix,
    "reed_sol_r6_op": reed_sol_r6_matrix,
    "cauchy_orig": cauchy_orig_matrix,
    "cauchy_good": cauchy_good_matrix,
    "isa_reed_sol_van": isa_rs_matrix,
    "isa_cauchy": isa_cauchy_matrix,
}


def coding_matrix(technique: str, k: int, m: int) -> np.ndarray:
    try:
        fn = TECHNIQUES[technique]
    except KeyError:
        raise ValueError(f"unknown technique {technique!r}; "
                         f"available: {sorted(TECHNIQUES)}") from None
    return fn(k, m)


def is_mds(matrix: np.ndarray, k: int) -> bool:
    """Exhaustively check the MDS property for small k+m: every k x k
    submatrix of [I; C] must be invertible (i.e. any k chunks decode)."""
    from itertools import combinations
    m = matrix.shape[0]
    full = np.vstack([np.eye(k, dtype=np.uint8), matrix])
    for rows in combinations(range(k + m), k):
        try:
            gf_inv_matrix(full[list(rows)])
        except ValueError:
            return False
    return True
