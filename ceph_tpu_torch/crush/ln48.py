"""Fixed-point log2 tables for the straw2 draw (crush_ln equivalent).

The reference's bucket_straw2_choose draws are s64 fixed point (ref:
src/crush/mapper.c crush_ln — a two-level __RH_LH_tbl/__LL_tbl lookup
pyramid returning ~2^44 * log2(x) — then
  ln   = crush_ln(u & 0xffff) - 0x1000000000000   (<= 0)
  draw = div64_s64(ln, item_weight)               (truncating)
and the FIRST strictly-greatest draw wins).

This module reproduces those semantics exactly, restructured for a
machine with no 64-bit integers on the device:

* `ln44(v)` computes floor(2^44 * log2(v)) with deterministic pure-
  integer arithmetic (msb + 44 fractional bits by the classic square-
  and-extract method at 96-bit working precision) — no float rounding,
  identical on every host. Upstream's table pyramid approximates the
  same quantity with its own interpolation error; its exact table bytes
  cannot be verified here (empty reference mount, same caveat as the
  rjenkins constants — see SURVEY.md), so we pin the mathematically
  exact value instead.
* `a48_table()` is A[u] = 2^48 - crush_ln(u) >= 0 for the 16-bit draw
  domain: since draw = ln/w = -(A // w) for w > 0, comparing draws
  descending is comparing q = A // w ascending, first index winning
  ties — integer semantics identical to the reference's.
* `quotient_tables(weights)` precomputes, per DISTINCT item weight w,
  the full 65536-entry q = A // w table split into u32 hi/lo halves
  (q < 2^48). The device then needs only gathers and u32 lexicographic
  compares — the whole s64 divide/compare pipeline becomes two table
  reads. Weights are static per CrushMap, so this is build-time work.
"""

from __future__ import annotations

import functools

import numpy as np

_PREC = 96          # working precision bits for the fractional part
_FRAC = 44          # fractional bits of crush_ln's fixed point


def ln44(v: int) -> int:
    """floor(2^44 * log2(v)) for integer v >= 1, exact integer math."""
    if v < 1:
        raise ValueError("ln44 domain is v >= 1")
    e = v.bit_length() - 1
    # r = v / 2^e in [1, 2) as a _PREC-bit fixed-point integer
    r = v << (_PREC - e)
    one = 1 << _PREC
    frac = 0
    for _ in range(_FRAC):
        r = (r * r) >> _PREC
        frac <<= 1
        if r >= (one << 1):
            frac |= 1
            r >>= 1
    return (e << _FRAC) | frac


_BASE = 24          # limb radix bits for the vectorized builder
_NLIMB = 5          # 5 x 24 = 120 bits >= _PREC + 2


def _ln44_table_vec() -> np.ndarray:
    """ln44(v) for v in [1, 65536] as uint64, vectorized.

    Same square-and-extract recurrence as ln44() at the same _PREC,
    bit-identical (pinned by tests), but the 44 iterations run as
    numpy limb arithmetic over the whole domain at once instead of
    65536 Python bigint loops (~50x faster; this builds at first
    mapper construction, so it must be cheap). Limbs are base 2^24 in
    uint64, so a 5x5 limb square's column sums stay < 2^53."""
    v = np.arange(1, 65537, dtype=np.uint64)
    e = np.zeros(65536, dtype=np.uint64)
    bl = np.zeros(65536, dtype=np.int64)   # bit_length(v) - 1
    tmp = v.copy()
    for _ in range(17):
        tmp >>= np.uint64(1)
        bl += (tmp > 0).astype(np.int64)
    e = bl.astype(np.uint64)
    # R = v << (_PREC - e), split into base-2^24 limbs (little-endian)
    mask = np.uint64((1 << _BASE) - 1)
    shift = (np.uint64(_PREC) - e).astype(np.uint64)
    limbs = np.zeros((_NLIMB, 65536), dtype=np.uint64)
    # R has at most _PREC+1 bits; fill limb l with bits [24l, 24l+24)
    for li in range(_NLIMB):
        lo = np.int64(li * _BASE)
        # bits of (v << shift) at offset lo = bits of v at lo - shift
        off = lo - shift.astype(np.int64)
        left = np.clip(off, -63, 63)
        part = np.where(left >= 0,
                        v >> left.clip(0).astype(np.uint64),
                        v << (-left).clip(0).astype(np.uint64))
        limbs[li] = part & mask
    one_hi = np.uint64(1 << (_PREC - (_NLIMB - 1) * _BASE))  # 2^96 top limb
    frac = np.zeros(65536, dtype=np.uint64)
    for _ in range(_FRAC):
        # S = (R * R) >> _PREC, computed in limbs
        cols = np.zeros((2 * _NLIMB, 65536), dtype=np.uint64)
        for i in range(_NLIMB):
            for j in range(_NLIMB):
                cols[i + j] += limbs[i] * limbs[j]
        # carry-propagate
        prod = np.zeros((2 * _NLIMB + 1, 65536), dtype=np.uint64)
        carry = np.zeros(65536, dtype=np.uint64)
        for c in range(2 * _NLIMB):
            s = cols[c] + carry
            prod[c] = s & mask
            carry = s >> np.uint64(_BASE)
        prod[2 * _NLIMB] = carry
        # shift right by _PREC = 4 limbs * 24 bits  (4*24 == 96 == _PREC)
        limbs = prod[4:4 + _NLIMB]
        # R >= 2 * 2^_PREC  <=>  top limb >= 2 * one_hi (R < 4*2^_PREC)
        top = limbs[_NLIMB - 1]
        ge2 = top >= (one_hi << np.uint64(1))
        frac = (frac << np.uint64(1)) | ge2.astype(np.uint64)
        # where ge2: R >>= 1 (across limbs)
        down = [(limbs[li] >> np.uint64(1))
                | ((limbs[li + 1] & np.uint64(1)) << np.uint64(_BASE - 1))
                for li in range(_NLIMB - 1)] + [limbs[_NLIMB - 1] >> np.uint64(1)]
        for li in range(_NLIMB):
            limbs[li] = np.where(ge2, down[li], limbs[li])
    return (e << np.uint64(_FRAC)) | frac


@functools.cache
def a48_table() -> np.ndarray:
    """A[u] = 2^48 - ln44(u + 1) for u in [0, 65536), uint64.

    Monotone decreasing; A[0xffff] == 0 (the best possible draw)."""
    return np.uint64(1 << 48) - _ln44_table_vec()


@functools.lru_cache(maxsize=64)
def _quotients_for(w: int) -> np.ndarray:
    # bounded: each entry is a 512 KiB table, and real maps can carry
    # per-OSD capacity-derived weights (many distinct values)
    if w < 1:
        raise ValueError("weight must be >= 1")
    return a48_table() // np.uint64(w)


def quotient_tables(weights) -> tuple[dict[int, int], np.ndarray, np.ndarray]:
    """For the distinct positive weights (16.16 ints), build q-tables.

    Returns (index_of_weight, q_hi, q_lo): q_hi/q_lo are
    (n_distinct, 65536) uint32 with q = A48 // w split at bit 32."""
    distinct = sorted({int(w) for w in weights if int(w) > 0})
    if not distinct:
        distinct = [0x10000]
    index = {w: i for i, w in enumerate(distinct)}
    q = np.stack([_quotients_for(w) for w in distinct])
    return index, (q >> np.uint64(32)).astype(np.uint32), \
        (q & np.uint64(0xFFFFFFFF)).astype(np.uint32)
