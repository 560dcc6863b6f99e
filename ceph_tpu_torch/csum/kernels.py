"""Batched block checksums: CRC-32C, XXH32 and XXH64 of every row of a
(B, L) uint8 tensor, by hand-written Hopper kernels and their plain
torch versions.

Twin of ceph_tpu/csum/kernels.py. Unit of work: (batch, block_len)
uint8 — many equal-sized blocks checked in one call. Results are int64
tensors holding the unsigned values: (B,) for CRC-32C and XXH32, (B, 2)
[hi, lo] 32-bit halves for XXH64 (the twin's shape). torch's uint32
dtype has almost no CUDA ops (no shifts, gathers or mixed comparisons),
so the port keeps 32-bit values in int64 from end to end;
`.numpy().astype(np.uint32)` gives the twin's array.

- On a CUDA tensor `crc32c_blocks`, `crc32c_extend`, `xxh32_blocks` and
  `xxh64_blocks` launch `csrc/csum.cu` (sm_90a), built with nvcc on
  first use into `ceph_tpu_torch/_build/` (utils/nvcc.py) and loaded
  with ctypes; each launch is counted in `launches` by kernel name. A
  build or launch failure raises; nothing falls back. Every CRC of the
  main path (the fused write's hinfo CRCs, the RMW delta's, the
  recovery program's rebuilt rows and fold, deep scrub, HashInfo
  appends) goes through these two CRC entry points.
- On a CPU tensor they run the plain versions, which take a tensor on
  any device: `crc32c_blocks_plain`, `crc32c_extend_plain`,
  `xxh32_blocks_plain`, `xxh64_blocks_plain`.

The CRC kernel. CRC is GF(2)-linear in the message, and a zero register
stays zero through zero bytes. Each row's head of L // 32 units of 32
bytes, preceded by `pad` zero units, is cut into S = 2**levels segments
of `seg` units; a thread computes one segment's zero-register CRC with
slicing-by-8 tables in shared memory; the segment CRCs combine by a
tree whose level-l node is shift(left) ^ right, shift a constant 32x32
GF(2) matrix (`plan_cols`); a row spread over several blocks is XORed
together atomically; the last L % 32 bytes step serially, and the seed
term (shift^L(init) ^ xorout, or shift^L(reg) for crc32c_extend) is
added once. `plan_for` picks S for the card, `crc32c_split_ref` is the
same algebra in torch for the tests.

The plain CRC is the twin's lowering: every 8-byte chunk's zero-init CRC
from the slicing-by-8 tables as gathers, a log-depth pairwise combine
whose left side is advanced through `span` zero bytes by the constant
shift matrix (applied as four 256-entry byte tables), then at most 7
serial tail bytes and the init/xorout host constant. The plain xxHash
runs the stripe recurrences on (B, 4) int64 lanes; int64 `*` and `+`
keep the low 64 bits as u64 would, and `>>` is arithmetic, so every
right shift and rotate is masked.

The XXH kernels: four threads a row, one per accumulator, gathered by a
shuffle for the merge, tail and avalanche. The design notes and the
bounds on the H100 are in the CUDA source.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import threading
from pathlib import Path

import numpy as np
import torch

from ..utils import nvcc
from .reference import (apply_shift, crc32c_slice8_tables, crc32c_table,
                        matrix_cols_u32, shift_matrix)

_M32 = 0xFFFFFFFF
_SRC = Path(__file__).resolve().parent / "csrc" / "csum.cu"
_MAX_LEN = (1 << 31) - 1

# The CRC kernel's launch plan (see csrc/csum.cu)
UNIT = 32               # bytes of a unit: two 16-byte loads
BLOCK_THREADS = 256
MIN_SEG_UNITS = 8       # a thread takes 256 bytes at least
THREADS_PER_SM = 1024   # threads plan_for aims to give each SM
MAX_LEVELS = 20         # the kernel's parameters hold 20 level matrices

# kernel launches by name: "crc32c", "xxh32", "xxh64"
launches: collections.Counter = collections.Counter()

_lib = None
_lib_lock = threading.Lock()


# ------------------------------------------------------------ plain CRC

@functools.lru_cache(maxsize=16)
def _crc_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    slice8 = torch.from_numpy(crc32c_slice8_tables().astype(np.int64))
    t0 = torch.from_numpy(crc32c_table().astype(np.int64))
    return slice8.to(device), t0.to(device)


@functools.lru_cache(maxsize=256)
def _byte_tables_host(nbytes: int) -> np.ndarray:
    """(4, 256) int64: T[q][v] = shift^{nbytes} applied to v << 8q."""
    cols = matrix_cols_u32(shift_matrix(nbytes)).astype(np.int64)
    v = np.arange(256, dtype=np.int64)
    out = np.zeros((4, 256), dtype=np.int64)
    for q in range(4):
        for bit in range(8):
            out[q] ^= np.where((v >> bit) & 1, cols[8 * q + bit], 0)
    return out


@functools.lru_cache(maxsize=256)
def _byte_tables(nbytes: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_byte_tables_host(nbytes)).to(device)


def _apply_shift(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Advance int64 registers (< 2^32) through `nbytes` zero bytes."""
    t = _byte_tables(nbytes, x.device)
    return (t[0][x & 0xFF] ^ t[1][(x >> 8) & 0xFF]
            ^ t[2][(x >> 16) & 0xFF] ^ t[3][(x >> 24) & 0xFF])


def _crc32c_linear(blocks: torch.Tensor) -> torch.Tensor:
    """Zero-init CRC register over each row of (B, L) uint8, L % 8 == 0."""
    B, L = blocks.shape
    n = L // 8
    slice8, _ = _crc_tables(blocks.device)
    chunks = blocks.reshape(B, n, 8)
    c = slice8[7][chunks[:, :, 0].long()]
    for i in range(1, 8):
        c ^= slice8[7 - i][chunks[:, :, i].long()]
    # log-depth combine; pad FRONT with zero chunks (a zero-init
    # register stays 0 through a zero prefix)
    span = 8
    while c.shape[1] > 1:
        if c.shape[1] % 2:
            c = torch.cat([c.new_zeros((B, 1)), c], dim=1)
        c = _apply_shift(c[:, 0::2], span) ^ c[:, 1::2]
        span *= 2
    return c[:, 0]


def _tail_steps(reg: torch.Tensor, blocks: torch.Tensor, start: int
                ) -> torch.Tensor:
    """Step int64 registers through blocks[:, start:] byte by byte."""
    _, t0 = _crc_tables(blocks.device)
    for t in range(start, blocks.shape[1]):
        reg = (reg >> 8) ^ t0[(reg ^ blocks[:, t].long()) & 0xFF]
    return reg


def _crc32c_zero_seed(blocks: torch.Tensor) -> torch.Tensor:
    """Zero-seed CRC register (int64) over each row of (B, L) uint8, any
    L: the 8-aligned head in parallel, then <= 7 serial tail bytes."""
    B, block_len = blocks.shape
    main = (block_len // 8) * 8
    if main:
        reg = _crc32c_linear(blocks[:, :main])
    else:
        reg = torch.zeros((B,), dtype=torch.int64, device=blocks.device)
    return _tail_steps(reg, blocks, main)


def _as_blocks(blocks) -> torch.Tensor:
    blocks = torch.as_tensor(blocks)
    if blocks.dtype != torch.uint8 or blocks.ndim != 2:
        raise ValueError(f"blocks must be (B, L) uint8, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    return blocks


def _as_regs(regs, blocks: torch.Tensor) -> torch.Tensor:
    """Registers as an int64 tensor of uint32 values on blocks' device."""
    if not isinstance(regs, torch.Tensor):
        regs = torch.from_numpy(np.asarray(regs).astype(np.int64))
    regs = regs.to(device=blocks.device, dtype=torch.int64)
    if regs.shape != blocks.shape[:1]:
        raise ValueError(f"regs must be ({blocks.shape[0]},), got "
                         f"{tuple(regs.shape)}")
    return regs & _M32


@functools.lru_cache(maxsize=1024)
def _seed_term(init: int, xorout: int, block_len: int) -> int:
    """shift^L(init) ^ xorout: the seed's share of every row's CRC."""
    init &= _M32
    return (apply_shift(init, block_len) if block_len else init) \
        ^ (xorout & _M32)


def crc32c_blocks_plain(blocks, init: int = 0xFFFFFFFF,
                        xorout: int = 0xFFFFFFFF) -> torch.Tensor:
    """crc32c_blocks in plain torch ops, on the device the blocks lie
    on."""
    blocks = _as_blocks(blocks)
    return _crc32c_zero_seed(blocks) ^ _seed_term(init, xorout,
                                                  int(blocks.shape[1]))


def crc32c_extend_plain(regs, blocks) -> torch.Tensor:
    """crc32c_extend in plain torch ops, on the device the blocks lie
    on."""
    blocks = _as_blocks(blocks)
    regs = _as_regs(regs, blocks)
    return _apply_shift(regs, int(blocks.shape[1])) \
        ^ _crc32c_zero_seed(blocks)


# ------------------------------------------------------- the kernel's plan

@dataclasses.dataclass(frozen=True)
class CrcPlan:
    """How the CRC kernel cuts rows of L bytes: the head's L // UNIT
    units, after `pad` zero units, in `segments` (a power of two)
    segments of `seg` units, one a thread; 2**log_sblk threads of a row
    in a block, so a row spans `nb` blocks."""
    L: int
    segments: int
    seg: int
    log_sblk: int

    @property
    def units(self) -> int:
        return self.L // UNIT

    @property
    def tail(self) -> int:
        return self.L % UNIT

    @property
    def pad(self) -> int:
        return self.segments * self.seg - self.units

    @property
    def nb(self) -> int:
        return self.segments >> self.log_sblk

    @property
    def levels(self) -> int:
        return self.segments.bit_length() - 1


def make_plan(L: int, segments: int, block_threads: int = BLOCK_THREADS
              ) -> CrcPlan:
    """The plan for rows of L bytes in `segments` segments, at most
    `block_threads` of them in one block (both powers of two)."""
    for name, v, top in (("segments", segments, 1 << MAX_LEVELS),
                         ("block_threads", block_threads, BLOCK_THREADS)):
        if v < 1 or v & (v - 1) or v > top:
            raise ValueError(f"{name} must be a power of two <= {top}, "
                             f"got {v}")
    if not 0 <= L <= _MAX_LEN:
        raise ValueError(f"rows of {L} bytes: the kernel takes 0 to "
                         f"2**31 - 1")
    seg = -(-(L // UNIT) // segments)
    return CrcPlan(L, segments, seg,
                   min(segments, block_threads).bit_length() - 1)


@functools.lru_cache(maxsize=4096)
def plan_for(B: int, L: int, sms: int) -> CrcPlan:
    """The kernel's plan for B rows of L bytes on a card of `sms` SMs:
    the most segments (a power of two) that keep THREADS_PER_SM threads
    a SM or fewer, and MIN_SEG_UNITS units a thread or more."""
    want = max(1, sms * THREADS_PER_SM // max(B, 1))
    most = max(1, (L // UNIT) // MIN_SEG_UNITS)
    s = min(want, most, 1 << MAX_LEVELS)
    return make_plan(L, 1 << (s.bit_length() - 1))


@functools.lru_cache(maxsize=1024)
def plan_cols(plan: CrcPlan) -> np.ndarray:
    """(levels + 2, 32) uint32 column words of the plan's shift
    matrices: level l advances through seg * UNIT << l bytes; then the
    tail's (L % UNIT bytes) and the row's (L bytes)."""
    nbytes = [plan.seg * UNIT << l for l in range(plan.levels)]
    nbytes += [plan.tail, plan.L]
    return np.stack([matrix_cols_u32(shift_matrix(n)) for n in nbytes])


def _apply_cols(cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The 32x32 GF(2) matrix given by its 32 column words (int64) applied
    to int64 registers < 2^32: XOR of the columns of x's set bits."""
    out = torch.zeros_like(x)
    for b in range(32):
        out ^= ((x >> b) & 1) * cols[b]
    return out


def crc32c_split_ref(blocks, plan: CrcPlan, init: int = 0xFFFFFFFF,
                     xorout: int = 0xFFFFFFFF, regs=None) -> torch.Tensor:
    """The CRC kernel's algebra in torch, for tests: each segment's
    running slicing-by-8 register, the tree over a block's segments with
    the plan's level matrices, the shift of each block past the blocks
    after it, the tail's shift and serial steps, the seed term (of
    crc32c_blocks, or of crc32c_extend where `regs` is given) and the
    XOR of the blocks. Equals crc32c_blocks (crc32c_extend)."""
    blocks = _as_blocks(blocks)
    B, L = blocks.shape
    if L != plan.L:
        raise ValueError(f"plan for rows of {plan.L} bytes, got {L}")
    cols = torch.from_numpy(plan_cols(plan).astype(np.int64)).to(
        blocks.device)
    S, seg, units = plan.segments, plan.seg, plan.units
    head = torch.cat([blocks.new_zeros((B, plan.pad * UNIT)),
                      blocks[:, :units * UNIT]], dim=1)
    b = head.reshape(B, S, seg * UNIT // 4, 4).long()
    words = b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24
    slice8, t0 = _crc_tables(blocks.device)
    v = torch.zeros((B, S), dtype=torch.int64, device=blocks.device)
    for s in range(seg * UNIT // 8):
        lo, hi = words[:, :, 2 * s] ^ v, words[:, :, 2 * s + 1]
        v = slice8[7][lo & 0xFF]
        for i, x in enumerate((lo >> 8, lo >> 16, lo >> 24, hi, hi >> 8,
                               hi >> 16, hi >> 24)):
            v = v ^ slice8[6 - i][x & 0xFF]
    for level in range(plan.log_sblk):
        v = v.reshape(B, -1, 2)
        v = _apply_cols(cols[level], v[..., 0]) ^ v[..., 1]
    parts = []
    for bi in range(plan.nb):
        x, m, level = v[:, bi], plan.nb - 1 - bi, plan.log_sblk
        while m:
            if m & 1:
                x = _apply_cols(cols[level], x)
            m, level = m >> 1, level + 1
        parts.append(_apply_cols(cols[plan.levels], x) if plan.tail else x)
    seed = _apply_cols(cols[plan.levels + 1], _as_regs(regs, blocks)) \
        if regs is not None else _seed_term(init, xorout, L)
    last = _tail_steps(torch.zeros_like(parts[0]), blocks, units * UNIT)
    parts[-1] = parts[-1] ^ last ^ seed
    out = parts[0]
    for p in parts[1:]:
        out = out ^ p
    return out


# ---------------------------------------------------------- the kernels

def build() -> Path:
    """Compile csum.cu into the build directory (once per source
    content) and return the shared library's path. Raises on a failed
    build."""
    return nvcc.build(_SRC)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.crc32c_rows.argtypes = [P, LL, P, P, I, P, P, I, P]
            lib.xxh32_rows.argtypes = [P, LL, I, I, ctypes.c_uint, P, I, P]
            lib.xxh64_rows.argtypes = [P, LL, I, I, ctypes.c_ulonglong, P,
                                       I, P]
            for fn in (lib.crc32c_rows, lib.xxh32_rows, lib.xxh64_rows):
                fn.restype = I
            _lib = lib
    return _lib


@functools.lru_cache(maxsize=16)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _rows_for_kernel(blocks: torch.Tensor, name: str
                     ) -> tuple[torch.Tensor, int]:
    """The blocks as rows the kernels read (each row contiguous), and
    the row pitch in bytes; raises for another device or too long rows."""
    if blocks.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{blocks.device}")
    B, L = blocks.shape
    if L > _MAX_LEN or B > _MAX_LEN:
        raise ValueError(f"{name}: ({B}, {L}) rows; the kernel takes "
                         f"fewer than 2**31 rows of fewer than 2**31 bytes")
    if L > 1 and blocks.stride(1) != 1:
        blocks = blocks.contiguous()
    return blocks, (blocks.stride(0) if B > 1 else 0)


def _launch(name: str, blocks: torch.Tensor, call) -> None:
    lib = _load()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        rc = call(lib, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc} "
                           f"(B={blocks.shape[0]} L={blocks.shape[1]})")
    launches[name] += 1


def _crc32c_kernel(blocks: torch.Tensor, regs: torch.Tensor | None,
                   add: int) -> torch.Tensor:
    B, L = blocks.shape
    out = torch.empty((B,), dtype=torch.int64, device=blocks.device)
    if B == 0:
        return out
    rows, pitch = _rows_for_kernel(blocks, "crc32c")
    ptr = rows.data_ptr()
    vec = next(v for v in (16, 8, 1) if ptr % v == 0 and pitch % v == 0)
    plan = plan_for(B, L, _sms(rows.device))
    meta = np.array([plan.units, plan.tail, plan.seg, plan.pad,
                     plan.log_sblk, plan.nb, plan.levels,
                     np.uint32(add).view(np.int32)], np.int32)
    cols = plan_cols(plan)
    if regs is not None:
        regs = regs.contiguous()
    _launch("crc32c", rows, lambda lib, stream: lib.crc32c_rows(
        ptr, pitch, out.data_ptr(),
        None if regs is None else regs.data_ptr(), B, meta.ctypes.data,
        cols.ctypes.data, vec, stream))
    return out


def crc32c_blocks(blocks, init: int = 0xFFFFFFFF,
                  xorout: int = 0xFFFFFFFF) -> torch.Tensor:
    """CRC-32C of each row of (B, L) uint8, as (B,) int64. Defaults =
    standard CRC-32C; use init=seed, xorout=0 for the raw
    ceph_crc32c(seed, ·) convention (what HashInfo stores, seed -1).
    A CUDA tensor launches the kernel; a CPU tensor runs the plain
    version; any other device raises."""
    blocks = _as_blocks(blocks)
    if blocks.device.type == "cpu":
        return crc32c_blocks_plain(blocks, init, xorout)
    return _crc32c_kernel(blocks, None,
                          _seed_term(init, xorout, int(blocks.shape[1])))


def crc32c_extend(regs, blocks) -> torch.Tensor:
    """Advance raw CRC registers through one block each: regs (B,)
    (uint32 values; array or tensor), blocks (B, L) uint8 -> (B,) int64,
    the batched form of ceph_crc32c(reg, block): shift^{L}(reg) ^
    crc_0(block). The twin pads L to a power of two (one XLA program per
    bucket) and un-shifts the padding on the host; neither the kernel
    nor the plain version needs that, and the result is the same."""
    blocks = _as_blocks(blocks)
    if blocks.device.type == "cpu":
        return crc32c_extend_plain(regs, blocks)
    return _crc32c_kernel(blocks, _as_regs(regs, blocks), 0)


# ---------------------------------------------------------------- xxhash

_P32 = (2654435761, 2246822519, 3266489917, 668265263, 374761393)
_P64 = (11400714785074694791, 14029467366897019727, 1609587929392839161,
        9650029242287828579, 2870177450012600261)


def _s64(v: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def _lanes(blocks: torch.Tensor, width: int) -> torch.Tensor:
    """(B, L) uint8 -> (B, L // width) int64 little-endian words of
    `width` bytes (a word of 8 bytes may come out negative)."""
    B, L = blocks.shape
    b = blocks[:, :L // width * width].reshape(B, L // width, width).long()
    out = b[..., 0]
    for i in range(1, width):
        out = out | (b[..., i] << (8 * i))
    return out


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))      # x < 2^32


def _shr64(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr64(x, 64 - r)


def xxh32_blocks_plain(blocks, seed: int = 0) -> torch.Tensor:
    """xxh32_blocks in plain torch ops (int64 lanes masked to 32 bits),
    on the device the blocks lie on."""
    blocks = _as_blocks(blocks)
    B, L = blocks.shape
    seed &= _M32
    p1, p2, p3, p4, p5 = _P32
    stripes, dev = L // 16, blocks.device
    if stripes:
        lanes = _lanes(blocks[:, :16 * stripes], 4).reshape(B, stripes, 4)
        v = torch.tensor([seed + p1 + p2, seed + p2, seed, seed - p1],
                         dtype=torch.int64, device=dev) & _M32
        v = v.expand(B, 4)
        for s in range(stripes):
            v = (_rotl32((v + lanes[:, s] * p2) & _M32, 13) * p1) & _M32
        h = (_rotl32(v[:, 0], 1) + _rotl32(v[:, 1], 7) + _rotl32(v[:, 2], 12)
             + _rotl32(v[:, 3], 18)) & _M32
    else:
        h = torch.full((B,), (seed + p5) & _M32, dtype=torch.int64,
                       device=dev)
    h = (h + L) & _M32
    p = 16 * stripes
    if L - p >= 4:
        words = _lanes(blocks[:, p:], 4)
        for i in range(words.shape[1]):
            h = (_rotl32((h + words[:, i] * p3) & _M32, 17) * p4) & _M32
        p += 4 * words.shape[1]
    for q in range(p, L):
        h = (_rotl32((h + blocks[:, q].long() * p5) & _M32, 11) * p1) & _M32
    h = h ^ (h >> 15)
    h = (h * p2) & _M32
    h = h ^ (h >> 13)
    h = (h * p3) & _M32
    return h ^ (h >> 16)


def _round64(acc: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    return _rotl64(acc + lane * _s64(_P64[1]), 31) * _s64(_P64[0])


def xxh64_blocks_plain(blocks, seed: int = 0) -> torch.Tensor:
    """xxh64_blocks in plain torch ops (int64 wrapping like u64, right
    shifts masked), on the device the blocks lie on."""
    blocks = _as_blocks(blocks)
    B, L = blocks.shape
    p1, p2, p3, p4, p5 = (_s64(p) for p in _P64)
    stripes, dev = L // 32, blocks.device
    if stripes:
        lanes = _lanes(blocks[:, :32 * stripes], 8).reshape(B, stripes, 4)
        v = torch.tensor([_s64(seed + _P64[0] + _P64[1]),
                          _s64(seed + _P64[1]), _s64(seed),
                          _s64(seed - _P64[0])], dtype=torch.int64,
                         device=dev).expand(B, 4)
        for s in range(stripes):
            v = _round64(v, lanes[:, s])
        h = (_rotl64(v[:, 0], 1) + _rotl64(v[:, 1], 7) + _rotl64(v[:, 2], 12)
             + _rotl64(v[:, 3], 18))
        for i in range(4):
            h = (h ^ _round64(torch.zeros_like(h), v[:, i])) * p1 + p4
    else:
        h = torch.full((B,), _s64(seed + _P64[4]), dtype=torch.int64,
                       device=dev)
    h = h + L
    p = 32 * stripes
    if L - p >= 8:
        words = _lanes(blocks[:, p:], 8)
        for i in range(words.shape[1]):
            k1 = _round64(torch.zeros_like(h), words[:, i])
            h = _rotl64(h ^ k1, 27) * p1 + p4
        p += 8 * words.shape[1]
    if L - p >= 4:
        h = h ^ (_lanes(blocks[:, p:p + 4], 4)[:, 0] * p1)
        h = _rotl64(h, 23) * p2 + p3
        p += 4
    for q in range(p, L):
        h = _rotl64(h ^ (blocks[:, q].long() * p5), 11) * p1
    h = h ^ _shr64(h, 33)
    h = h * p2
    h = h ^ _shr64(h, 29)
    h = h * p3
    h = h ^ _shr64(h, 32)
    return torch.stack([_shr64(h, 32), h & _M32], dim=1)


def _xxh_kernel(name: str, blocks: torch.Tensor, seed: int,
                width: int) -> torch.Tensor:
    B, L = blocks.shape
    shape = (B,) if name == "xxh32" else (B, 2)
    out = torch.empty(shape, dtype=torch.int64, device=blocks.device)
    if B == 0:
        return out
    rows, pitch = _rows_for_kernel(blocks, name)
    ptr = rows.data_ptr()
    aligned = int(ptr % width == 0 and pitch % width == 0)
    fn = "xxh32_rows" if name == "xxh32" else "xxh64_rows"
    _launch(name, rows, lambda lib, stream: getattr(lib, fn)(
        ptr, pitch, B, L, seed, out.data_ptr(), aligned, stream))
    return out


def xxh32_blocks(blocks, seed: int = 0) -> torch.Tensor:
    """XXH32 of each row of (B, L) uint8, as (B,) int64. A CUDA tensor
    launches the kernel; a CPU tensor runs the plain version; any other
    device raises."""
    blocks = _as_blocks(blocks)
    if blocks.device.type == "cpu":
        return xxh32_blocks_plain(blocks, seed)
    return _xxh_kernel("xxh32", blocks, seed & _M32, 4)


def xxh64_blocks(blocks, seed: int = 0) -> torch.Tensor:
    """XXH64 of each row of (B, L) uint8, as (B, 2) int64 [hi, lo]
    32-bit halves (combine as (hi << 32) | lo). A CUDA tensor launches
    the kernel; a CPU tensor runs the plain version; any other device
    raises."""
    blocks = _as_blocks(blocks)
    if blocks.device.type == "cpu":
        return xxh64_blocks_plain(blocks, seed)
    return _xxh_kernel("xxh64", blocks, seed & ((1 << 64) - 1), 8)
