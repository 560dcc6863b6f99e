"""GF(2^8) arithmetic over x^8 + x^4 + x^3 + x^2 + 1 (0x11D), plain."""

from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x11D


@functools.lru_cache(maxsize=1)
def tables() -> tuple[np.ndarray, np.ndarray]:
    """(exp, log): exp has 510 entries so that exp[log a + log b] needs
    no reduction; log[0] is unused."""
    exp = np.zeros(510, np.int64)
    log = np.zeros(256, np.int64)
    v = 1
    for i in range(255):
        exp[i] = v
        log[v] = i
        v <<= 1
        if v & 0x100:
            v ^= POLY
    exp[255:] = exp[:255]
    return exp, log


@functools.lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """(256, 256) uint8: mul_table()[a, b] = a * b."""
    exp, log = tables()
    a = np.arange(256)
    out = exp[log[a][:, None] + log[a][None, :]].astype(np.uint8)
    out[0, :] = 0
    out[:, 0] = 0
    return out


def mul(a: int, b: int) -> int:
    return int(mul_table()[a, b])


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    exp, log = tables()
    return int(exp[255 - log[a]])


def power(a: int, n: int) -> int:
    """a**n with 0**0 == 1."""
    out = 1
    for _ in range(n):
        out = mul(out, a)
    return out


def matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """A @ B over GF(2^8), uint8 matrices."""
    mt = mul_table()
    A = np.asarray(A, np.uint8)
    B = np.asarray(B, np.uint8)
    out = np.zeros((A.shape[0], B.shape[1]), np.uint8)
    for j in range(A.shape[1]):
        out ^= mt[A[:, j][:, None], B[j][None, :]]
    return out


def solve(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """X with A @ X == B over GF(2^8), for A of full column rank (rows
    beyond the rank must be consistent; raises otherwise)."""
    mt = mul_table()
    A = np.array(A, np.uint8)
    B = np.array(B, np.uint8)
    r, c = A.shape
    M = np.concatenate([A, B], axis=1)
    row = 0
    for col in range(c):
        nz = np.nonzero(M[row:, col])[0]
        if len(nz) == 0:
            raise ValueError(f"solve: column {col} has no pivot (rank "
                             f"below {c})")
        p = row + int(nz[0])
        if p != row:
            M[[row, p]] = M[[p, row]]
        M[row] = mt[inv(int(M[row, col])), M[row]]
        f = M[:, col].copy()
        f[row] = 0
        hit = np.nonzero(f)[0]
        if len(hit):
            M[hit] ^= mt[f[hit][:, None], M[row][None, :]]
        row += 1
    if M[c:, c:].any():
        raise ValueError("solve: the system has no solution")
    return M[:c, c:].copy()


def bit_matrix(M: np.ndarray) -> np.ndarray:
    """The (8 mo, 8 ki) 0/1 matrix of x -> M x on bit planes: entry
    (8 i + bo, 8 j + bi) is bit bo of M[i, j] * 2**bi."""
    M = np.asarray(M, np.uint8)
    mo, ki = M.shape
    mt = mul_table()
    prod = mt[M[:, :, None], (1 << np.arange(8))[None, None, :]]
    bits = (prod[:, :, :, None] >> np.arange(8)) & 1      # i, j, bi, bo
    return bits.transpose(0, 3, 1, 2).reshape(8 * mo, 8 * ki) \
        .astype(np.float32)


def apply(M: np.ndarray, data: torch.Tensor,
          max_elems: int = 1 << 28) -> torch.Tensor:
    """out[b, i] = XOR_j M[i, j] * data[b, j] over GF(2^8), data (B, ki,
    L) uint8 on any device: bit planes times the 0/1 bit matrix in
    float32 (exact), taken mod 2. Columns go in blocks of at most
    `max_elems` bit-plane floats."""
    B, ki, L = data.shape
    mo = M.shape[0]
    Mb = torch.from_numpy(bit_matrix(M)).to(data.device)
    sh = torch.arange(8, device=data.device, dtype=torch.int32)
    out = torch.empty((B, mo, L), dtype=torch.uint8, device=data.device)
    step = max(1, max_elems // (8 * max(ki, mo)))
    for b in range(B):
        for c0 in range(0, L, step):
            x = data[b, :, c0:c0 + step].to(torch.int32)
            bits = ((x[:, None, :] >> sh[None, :, None]) & 1) \
                .to(torch.float32).reshape(8 * ki, -1)
            y = (Mb @ bits).to(torch.int32) & 1
            out[b, :, c0:c0 + step] = (y.reshape(mo, 8, -1)
                                       << sh[None, :, None]).sum(1) \
                .to(torch.uint8)
    return out
