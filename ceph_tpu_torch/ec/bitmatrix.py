"""Bitmatrix RAID-6 techniques: liberation, blaum_roth, liber8tion.

Twin of ceph_tpu/ec/bitmatrix.py: the reference's bitmatrix/schedule
jerasure techniques (ref:
src/erasure-code/jerasure/ErasureCodeJerasure.cc classes
ErasureCodeJerasureLiberation / …BlaumRoth / …Liber8tion; C kernels
jerasure.c jerasure_bitmatrix_encode/decode, liberation.c).

A bitmatrix code treats each chunk as w PACKETS (equal byte regions).
The coding bitmatrix BM is (m*w, k*w) over GF(2); coding packet row r is
the XOR of the data packet rows c with BM[r, c] == 1. Encode/decode are
therefore pure XOR schedules over byte regions — no GF(2^8) multiplies
at all: elementwise u8 XOR, batched.

Matrix constructions (from the published algorithms; the reference
mount is empty — see SURVEY.md citation notice — so these are
from-first-principles implementations pinned by our own corpus):

* liberation (Plank, "The RAID-6 Liberation Codes", FAST'08): w prime,
  k <= w, m == 2. P-blocks are identities; Q-block j is the cyclic
  rotation R^j plus, for j > 0, one extra bit at row y = j*(w-1)/2 mod w,
  column (y + j - 1) mod w — the minimal-density MDS family.
* blaum_roth (Blaum & Roth codes): w+1 prime, k <= w, m == 2. Q-block j
  is multiplication by x^j in the polynomial ring
  GF(2)[x] / M_p(x), M_p(x) = 1 + x + ... + x^w (p = w+1), using the
  reduction x^w = 1 + x + ... + x^(w-1).
* liber8tion (Plank, "Uber-CSHR and Liber8tion" family): w == 8 (not
  prime, so liberation's construction is unavailable), k <= 8, m == 2.
  The published matrices were found by search; the exact tables cannot
  be verified against the empty reference mount, so this module derives
  the family with a DETERMINISTIC backtracking search under the same
  structural constraints (X_0 = I, X_j = R^j plus minimal extra bits,
  every X_j and every X_i ^ X_j invertible — the exact MDS conditions
  for an m=2 block code). Output is deterministic and pinned in
  tests/corpus; byte-compatibility with jerasure's liber8tion table is
  explicitly NOT claimed.

Every construction is MDS-verified at init (X_j and pairwise X_i ^ X_j
invertibility), so a buggy matrix can never silently write stripes.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .interface import CHUNK_ALIGNMENT, ErasureCode


# ---------------------------------------------------------------- GF(2)

def gf2_inv(mat: np.ndarray) -> np.ndarray:
    """Invert a square GF(2) matrix (Gauss-Jordan); raises ValueError
    if singular."""
    n = mat.shape[0]
    a = (np.asarray(mat, dtype=np.uint8) & 1).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if a[r, col]:
                piv = r
                break
        if piv is None:
            raise ValueError("singular GF(2) matrix")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= a[col]
                inv[r] ^= inv[col]
    return inv


def gf2_is_invertible(mat: np.ndarray) -> bool:
    try:
        gf2_inv(mat)
        return True
    except ValueError:
        return False


def _rotation(w: int, j: int) -> np.ndarray:
    """R^j: ones at (i, (i + j) % w)."""
    m = np.zeros((w, w), dtype=np.uint8)
    for i in range(w):
        m[i, (i + j) % w] = 1
    return m


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    return all(n % d for d in range(2, int(n ** 0.5) + 1))


def _assemble(k: int, w: int, xblocks: list[np.ndarray]) -> np.ndarray:
    """[identity row | X row] -> (2w, k*w) coding bitmatrix."""
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        bm[:w, j * w:(j + 1) * w] = np.eye(w, dtype=np.uint8)
        bm[w:, j * w:(j + 1) * w] = xblocks[j]
    return bm


def _verify_mds_raid6(xblocks: list[np.ndarray], label: str) -> None:
    """m=2 block-code MDS conditions: every X_j invertible (data+P loss)
    and every X_i ^ X_j invertible (double data loss)."""
    k = len(xblocks)
    for j, x in enumerate(xblocks):
        if not gf2_is_invertible(x):
            raise ValueError(f"{label}: X_{j} singular — not MDS")
    for i in range(k):
        for j in range(i + 1, k):
            if not gf2_is_invertible(xblocks[i] ^ xblocks[j]):
                raise ValueError(f"{label}: X_{i}^X_{j} singular — not MDS")


def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    if not _is_prime(w):
        raise ValueError(f"liberation requires prime w, got w={w}")
    if not 2 <= k <= w:
        raise ValueError(f"liberation requires 2 <= k <= w={w}, got k={k}")
    xb = []
    for j in range(k):
        x = _rotation(w, j)
        if j > 0:
            y = (j * ((w - 1) // 2)) % w
            x[y, (y + j - 1) % w] ^= 1
        xb.append(x)
    _verify_mds_raid6(xb, f"liberation k={k} w={w}")
    return _assemble(k, w, xb)


def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    if not _is_prime(w + 1):
        raise ValueError(f"blaum_roth requires w+1 prime, got w={w}")
    if not 2 <= k <= w:
        raise ValueError(f"blaum_roth requires 2 <= k <= w={w}, got k={k}")
    # multiplication by x in GF(2)[x] / (1 + x + ... + x^w):
    # shift up; x^w reduces to 1 + x + ... + x^(w-1)
    mulx = np.zeros((w, w), dtype=np.uint8)
    for b in range(w - 1):
        mulx[b + 1, b] = 1
    mulx[:, w - 1] = 1
    xb = []
    x = np.eye(w, dtype=np.uint8)
    for j in range(k):
        xb.append(x.copy())
        x = (mulx @ x) & 1
    _verify_mds_raid6(xb, f"blaum_roth k={k} w={w}")
    return _assemble(k, w, xb)


def liber8tion_bitmatrix(k: int, w: int = 8) -> np.ndarray:
    """w=8 m=2 RAID-6 bitmatrix (the liber8tion slot).

    Rotation-plus-extra-bit blocks (liberation's family) provably cannot
    cover w=8: rank(I ^ R^d) = 8 - gcd(8, d), so pairs with even shift
    difference are >= 2 ranks short of invertible — which is why the
    published liber8tion matrices came from Plank's Uber-CSHR search.
    Those tables cannot be verified against the empty reference mount,
    so this builds the X-blocks as companion-matrix powers instead:
    X_j = bitmatrix(2^j) over GF(2^8)/0x11D. MDS is automatic —
    X_i ^ X_j = bitmatrix(2^i ^ 2^j) with a nonzero constant, hence
    invertible — and the code is mathematically the generator-2 RAID-6
    (reed_sol_r6_op) evaluated over bit-sliced symbols: bit-lane t of
    the packet columns forms a GF(2^8) symbol, and parity lane t is
    P/Q of those symbols (a cross-implementation equivalence the tests
    pin). Same contract and packet layout as liber8tion; matrix family
    differs from the published search results."""
    if w != 8:
        raise ValueError(f"liber8tion requires w=8, got w={w}")
    if not 2 <= k <= 8:
        raise ValueError(f"liber8tion requires 2 <= k <= 8, got k={k}")
    from ..gf.tables import gf_bitmatrix, gf_pow_scalar
    xb = [gf_bitmatrix(gf_pow_scalar(2, j)) for j in range(k)]
    _verify_mds_raid6(xb, f"liber8tion k={k}")
    return _assemble(k, 8, xb)


BITMATRIX_TECHNIQUES = {
    "liberation": (liberation_bitmatrix, 7),   # default w
    "blaum_roth": (blaum_roth_bitmatrix, 6),   # w+1 = 7 prime
    "liber8tion": (liber8tion_bitmatrix, 8),
}


# ----------------------------------------------------- decode bitmatrix

def bitmatrix_decode_matrix(bm: np.ndarray, k: int, w: int,
                            erasures: Sequence[int],
                            survivors: Sequence[int]) -> np.ndarray:
    """Decode bitmatrix D: erased chunks' packet rows = D @ survivor
    packet rows (the role of jerasure_matrix_decode's inverted
    submatrix, in the GF(2) domain)."""
    n = (bm.shape[0] // w) + k
    full = np.zeros((n * w, k * w), dtype=np.uint8)
    full[:k * w] = np.kron(np.eye(k, dtype=np.uint8),
                           np.eye(w, dtype=np.uint8))
    full[k * w:] = bm
    surv = list(survivors)[:k]
    rows_s = np.concatenate([np.arange(s * w, (s + 1) * w) for s in surv])
    inv = gf2_inv(full[rows_s])          # (kw, kw): data = inv @ survivors
    rows_e = np.concatenate(
        [np.arange(e * w, (e + 1) * w) for e in erasures])
    return (full[rows_e] @ inv) & 1      # (|E|*w, kw)


# ---------------------------------------------------------- the plugin

class JerasureBitmatrix(ErasureCode):
    """liberation / blaum_roth / liber8tion coder: XOR schedules over
    chunk packets, batched on the coder's device."""

    # a coding BYTE is the XOR of input bytes from OTHER packet rows
    # (different intra-chunk offsets), so no per-byte-position GF(256)
    # repair matrix exists: batch_decoder refuses at once
    positionwise = False

    def init(self, profile: Mapping[str, str]) -> None:
        self.k = int(profile.get("k", 4))
        self.m = int(profile.get("m", 2))
        technique = profile.get("technique", "liberation")
        if technique not in BITMATRIX_TECHNIQUES:
            raise ValueError(f"not a bitmatrix technique: {technique!r}")
        if self.m != 2:
            raise ValueError(f"{technique} requires m=2, got m={self.m}")
        build, default_w = BITMATRIX_TECHNIQUES[technique]
        self.w = int(profile.get("w", default_w))
        self.technique = technique
        self.bitmatrix = build(self.k, self.w)  # (2w, kw)
        from ..ops.xor_kernels import make_xor_encoder
        self._make = make_xor_encoder
        self._encode_fn = make_xor_encoder(self.bitmatrix, self.w)
        self._decode_cache: dict[tuple, tuple] = {}

    def get_chunk_size(self, stripe_width: int) -> int:
        """Chunks split into w equal packets, each CHUNK_ALIGNMENT-
        aligned (role of jerasure's w * packetsize alignment)."""
        align = self.k * self.w * CHUNK_ALIGNMENT
        padded = -(-stripe_width // align) * align if stripe_width else align
        return padded // self.k

    def _check_chunk(self, L: int) -> None:
        if L % self.w:
            raise ValueError(
                f"chunk length {L} not divisible into w={self.w} packets "
                f"(use get_chunk_size for aligned geometry)")

    def encode_chunks(self, data) -> torch.Tensor:
        data = self.as_chunks(data)
        self._check_chunk(data.shape[-1])
        return self._encode_fn(data)

    def decode_chunks(self, want_to_read: Sequence[int],
                      chunks: Mapping[int, object]
                      ) -> dict[int, torch.Tensor]:
        erasures = tuple(sorted(want_to_read))
        survivors = tuple(sorted(
            i for i in chunks if i not in set(erasures))[:self.k])
        if len(survivors) < self.k:
            raise ValueError(
                f"need {self.k} chunks to decode, have {len(survivors)}")
        key = (erasures, survivors)
        hit = self._decode_cache.get(key)
        if hit is None:
            D = bitmatrix_decode_matrix(self.bitmatrix, self.k, self.w,
                                        erasures, survivors)
            hit = (self._make(D, self.w), survivors)
            self._decode_cache[key] = hit
        fn, surv = hit
        stack = torch.stack([self.as_chunks(chunks[s]) for s in surv],
                            dim=-2)
        self._check_chunk(stack.shape[-1])
        squeeze = stack.ndim == 2
        if squeeze:
            stack = stack[None]
        rec = fn(stack)  # (B, |E|, L)
        if squeeze:
            rec = rec[0]
        return {e: rec[..., i, :] for i, e in enumerate(erasures)}
