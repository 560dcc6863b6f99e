"""rjenkins1 integer mixing hash — the randomness source of CRUSH.

Rebuild of the reference's crush_hash32_{1..5} (ref: src/crush/hash.c,
crush_hashmix / crush_hash_seed, CRUSH_HASH_RJENKINS1): every placement
draw in the mapper derives from these. Written once over generic array
ops so the same code runs as numpy uint32 (host oracle) and jax uint32
(vectorized mapper) — both wrap mod 2^32, so results agree bit-for-bit.

NOTE (see SURVEY.md citation notice): the reference mount was empty at
build time, so these formulas are reconstructed from the well-known
public rjenkins lookup3-style mix used by CRUSH; the parity tests pin
vectorized == oracle, and the constants are frozen here so placement is
stable forever within this framework.
"""

from __future__ import annotations

import numpy as np

CRUSH_HASH_SEED = 1315423911  # crush_hash_seed
_X = 231232
_Y = 1232


def _mix(a, b, c):
    """One crush_hashmix round; a/b/c are uint32 arrays (any backend).
    uint32 wraparound is the point — suppress numpy's scalar overflow
    warnings so host/oracle callers stay quiet."""
    a = (a - b) - c
    a = a ^ (c >> 13)
    b = (b - c) - a
    b = b ^ (a << 8)
    c = (c - a) - b
    c = c ^ (b >> 13)
    a = (a - b) - c
    a = a ^ (c >> 12)
    b = (b - c) - a
    b = b ^ (a << 16)
    c = (c - a) - b
    c = c ^ (b >> 5)
    a = (a - b) - c
    a = a ^ (c >> 3)
    b = (b - c) - a
    b = b ^ (a << 10)
    c = (c - a) - b
    c = c ^ (b >> 15)
    return a, b, c


def _u32(backend, v):
    return backend.asarray(v, dtype=backend.uint32)


def _quiet(fn):
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with np.errstate(over="ignore"):
            return fn(*args, **kw)
    return wrapped


@_quiet
def hash32_1(a, np_like=np):
    a = _u32(np_like, a)
    seed = _u32(np_like, CRUSH_HASH_SEED)
    h = seed ^ a
    b = a
    x = _u32(np_like, _X)
    y = _u32(np_like, _Y)
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h



@_quiet
def hash32_2(a, b, np_like=np):
    a = _u32(np_like, a)
    b = _u32(np_like, b)
    h = _u32(np_like, CRUSH_HASH_SEED) ^ a ^ b
    x = _u32(np_like, _X)
    y = _u32(np_like, _Y)
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h



@_quiet
def hash32_3(a, b, c, np_like=np):
    a = _u32(np_like, a)
    b = _u32(np_like, b)
    c = _u32(np_like, c)
    h = _u32(np_like, CRUSH_HASH_SEED) ^ a ^ b ^ c
    x = _u32(np_like, _X)
    y = _u32(np_like, _Y)
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h



@_quiet
def hash32_4(a, b, c, d, np_like=np):
    a = _u32(np_like, a)
    b = _u32(np_like, b)
    c = _u32(np_like, c)
    d = _u32(np_like, d)
    h = _u32(np_like, CRUSH_HASH_SEED) ^ a ^ b ^ c ^ d
    x = _u32(np_like, _X)
    y = _u32(np_like, _Y)
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h



@_quiet
def hash32_5(a, b, c, d, e, np_like=np):
    a = _u32(np_like, a)
    b = _u32(np_like, b)
    c = _u32(np_like, c)
    d = _u32(np_like, d)
    e = _u32(np_like, e)
    h = _u32(np_like, CRUSH_HASH_SEED) ^ a ^ b ^ c ^ d ^ e
    x = _u32(np_like, _X)
    y = _u32(np_like, _Y)
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    d, x, h = _mix(d, x, h)
    y, e, h = _mix(y, e, h)
    return h
