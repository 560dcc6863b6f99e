"""Batched static-matrix GF(2^8) apply: the hand-written Hopper kernel
and its plain PyTorch version.

Counterpart of ceph_tpu/ops/pallas_gf.py. `apply_matrix_gf(matrix,
data)` computes out[b, i, :] = XOR_j matrix[i, j] (x) data[b, j, :]
over GF(2^8) (poly 0x11D) for data (B, k, L) uint8, any L >= 0.

- On a CUDA tensor it launches `csrc/gf_apply.cu` (sm_90a), built with
  nvcc on first use into `ceph_tpu_torch/_build/` and loaded with
  ctypes (utils/nvcc.py). A build or launch failure raises; nothing
  falls back. The kernel walks a schedule that `compile_schedule` makes
  from the matrix once, with numpy (the counterpart of the Pallas
  kernel's trace-time skip of zero columns and coefficients), kept on
  the device in a least-recently-used cache bounded by
  COEF_CACHE_BYTES.
- On a CPU tensor it runs `apply_matrix_plain`, the torch twin of the
  same SWAR function on int32 words (`pallas_gf._kernel_body`).
  `run_schedule` interprets a compiled schedule the way the kernel
  walks it; the tests hold it against the plain version.

The design note and the bound on the H100 are in the CUDA source.
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

from ..gf.tables import bit_powers
from ..utils import nvcc

_REP = 0x01010101
_SRC = Path(__file__).resolve().parent / "csrc" / "gf_apply.cu"
BUILD_DIR = nvcc.BUILD_DIR
_nvcc = nvcc.find

# shared memory a block may stage one chunk of its row group's
# coefficient words in (past the default 48 KiB by opt-in; two such
# blocks still share an SM's 227 KiB)
CHUNK_BYTES = 96 * 1024
# schedules whose largest chunk holds more coefficient bytes than this
# are staged in shared memory chunk by chunk (Clay's, RS k=8 m=3's encode,
# LRC's global layer); smaller ones (two-row decodes, SHEC's, the LRC
# local layers, the RMW delta) are read from global memory through L1,
# which spares each block the staging and its barriers
STAGE_MIN_BYTES = 512
# bytes of device schedules kept per process
COEF_CACHE_BYTES = 512 << 20

_lib = None
_lib_lock = threading.Lock()
_coef_cache: collections.OrderedDict = collections.OrderedDict()
_coef_bytes = 0
_coef_lock = threading.Lock()


def coef_words(matrix: np.ndarray) -> np.ndarray:
    """(m, k, 8) uint32: matrix[i, j] * 2^b replicated into 4 bytes."""
    matrix = np.ascontiguousarray(matrix, np.uint8)
    return bit_powers()[matrix].astype(np.uint32) * np.uint32(_REP)


def group_rows(m: int) -> int:
    """Rows per row group (the kernel's MT): the smallest of 1, 2, 4, 8
    that holds min(m, 8) rows."""
    return next(mt for mt in (1, 2, 4, 8) if mt >= min(m, 8))


def nonzero_groups(matrix: np.ndarray, mt: int) -> int:
    """(row group, input row) pairs with any non-zero coefficient: the
    entries a schedule of `mt`-row groups holds."""
    m, k = matrix.shape
    groups = -(-m // mt)
    padded = np.zeros((groups * mt, k), np.uint8)
    padded[:m] = matrix
    return int(padded.reshape(groups, mt, k).any(axis=1).sum())


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A matrix compiled for gf_apply_kernel. Row group g holds output
    rows [g * mt, (g + 1) * mt) and walks chunks [gch[g], gch[g+1]);
    chunk c holds entries [cent[c], cent[c+1]) and their coefficient
    words [cwo[c], cwo[c+1]), which a block stages in shared memory at
    once. Entry e is ent[e] = j << 8 | mask: the input row j, ascending
    in its group, and the mt-bit mask of the group's rows with a
    non-zero coefficient there; its words are, for each row of the mask
    in ascending order, that row's 8 coefficient words (`coef_words`,
    bits 0..7)."""
    m: int
    k: int
    mt: int
    ent: np.ndarray     # (entries,) int32
    words: np.ndarray   # (cwo[-1],) uint32
    gch: np.ndarray     # (groups + 1,) int32
    cent: np.ndarray    # (chunks + 1,) int32
    cwo: np.ndarray     # (chunks + 1,) int32

    @property
    def groups(self) -> int:
        return len(self.gch) - 1

    @functools.cached_property
    def chunk_words(self) -> int:
        """Words of the largest chunk: the shared memory a block takes."""
        return int(np.diff(self.cwo).max(initial=0))

    @property
    def nbytes(self) -> int:
        """Bytes of the schedule on the device."""
        return 4 * (12 * self.groups + len(self.words) + len(self.ent)
                    + len(self.cent) + len(self.cwo))

    def group_records(self) -> np.ndarray:
        """(groups, 12) int32, the kernel's three 16-byte loads per
        group: its first and end chunk and first and end entry; the
        ent of its first three entries (0 past its end); its first
        chunk's first and end word and end entry (0 without chunks)."""
        rec = np.zeros((self.groups, 12), np.int32)
        first, end = self.gch[:-1], self.gch[1:]
        rec[:, 0], rec[:, 1] = first, end
        rec[:, 2], rec[:, 3] = self.cent[first], self.cent[end]
        for g in np.flatnonzero(end > first):
            c = first[g]
            e0, e1 = rec[g, 2], rec[g, 3]
            n = min(3, e1 - e0)
            rec[g, 4:4 + n] = self.ent[e0:e0 + n]
            rec[g, 8:11] = self.cwo[c], self.cwo[c + 1], self.cent[c + 1]
        return rec


def compile_schedule(matrix: np.ndarray, mt: int | None = None,
                     chunk_bytes: int | None = None) -> Schedule:
    """The kernel's schedule of `matrix` in row groups of `mt` rows
    (group_rows(m) by default): only input rows with a non-zero
    coefficient in a group, and only the words of non-zero rows, cut
    into chunks of whole entries of at most `chunk_bytes` (CHUNK_BYTES
    by default) of words each."""
    matrix = np.ascontiguousarray(matrix, np.uint8)
    m, k = matrix.shape
    mt = group_rows(m) if mt is None else mt
    budget = (CHUNK_BYTES if chunk_bytes is None else chunk_bytes) // 4
    if mt not in (1, 2, 4, 8) or k >= 1 << 23 or budget < 8 * mt:
        raise ValueError(f"row groups of {mt} rows at k={k} in chunks of "
                         f"{4 * budget} bytes: the kernel takes 1, 2, 4 "
                         f"or 8 rows, k < 2**23 and chunks that hold an "
                         f"entry")
    groups = max(1, -(-m // mt))
    padded = np.zeros((groups * mt, k), np.uint8)
    padded[:m] = matrix
    nz = padded.reshape(groups, mt, k).transpose(0, 2, 1) != 0  # (G, k, mt)
    g_of, j_of = np.nonzero(nz.any(axis=2))         # entries, (g, j) order
    rows = nz[g_of, j_of]
    masks = (rows << np.arange(mt)).sum(axis=1)
    wo = np.zeros(len(g_of) + 1, np.int64)
    np.cumsum(rows.sum(axis=1) * 8, out=wo[1:])
    g3, j3, i3 = np.nonzero(nz)                     # (g, j, i) order
    words = (bit_powers()[padded[g3 * mt + i3, j3]].astype(np.uint32)
             * np.uint32(_REP)).reshape(-1)
    # chunks: a group's entries in order, each chunk as many whole
    # entries as fit the budget
    eofs = np.searchsorted(g_of, np.arange(groups + 1))
    gch, cent = [0], []
    for g in range(groups):
        e, e1 = int(eofs[g]), int(eofs[g + 1])
        while e < e1:
            cent.append(e)
            e = int(np.searchsorted(wo, wo[e] + budget, "right")) - 1
            e = min(e, e1)
        gch.append(len(cent))
    cent.append(len(g_of))
    cent = np.asarray(cent, np.int32)
    ent = (j_of.astype(np.int32) << 8) | masks.astype(np.int32)
    return Schedule(m, k, mt, ent.astype(np.int32),
                    np.ascontiguousarray(words, np.uint32),
                    np.asarray(gch, np.int32), cent,
                    wo[cent].astype(np.int32))


def stages(sched: Schedule) -> bool:
    """Whether the kernel stages the schedule's coefficient words in
    shared memory: where its largest chunk holds more than
    STAGE_MIN_BYTES."""
    return sched.chunk_words * 4 > STAGE_MIN_BYTES


def run_schedule(sched: Schedule, data: torch.Tensor) -> torch.Tensor:
    """Plain interpreter of a compiled schedule, for tests: walks each
    row group's chunks and entries as gf_apply_kernel does, with its
    masks (shift bit b of each byte to bit 7, then spread bit 7 over
    the byte, as PRMT's sign-replicate mode does) on numpy uint32 words
    of a CPU tensor, reading each chunk's words from its staged copy."""
    B, k, L = data.shape
    if k != sched.k:
        raise ValueError(f"data has {k} shards, schedule expects {sched.k}")
    n = -(-L // 4)
    x = np.zeros((B, k, 4 * n), np.uint8)
    x[:, :, :L] = data.numpy()
    x = x.view(np.uint32)                           # (B, k, n)
    out = np.zeros((B, sched.groups * sched.mt, n), np.uint32)
    for g in range(sched.groups):
        for c in range(sched.gch[g], sched.gch[g + 1]):
            staged = sched.words[sched.cwo[c]:sched.cwo[c + 1]].copy()
            w = 0
            for e in range(sched.cent[c], sched.cent[c + 1]):
                j, msk = int(sched.ent[e]) >> 8, int(sched.ent[e]) & 0xFF
                masks = [(((x[:, j] << np.uint32(7 - bit))
                           & np.uint32(0x80808080)) >> np.uint32(7))
                         * np.uint32(0xFF) for bit in range(8)]
                for i in range(sched.mt):
                    if not (msk >> i) & 1:
                        continue
                    acc = out[:, g * sched.mt + i]
                    for bit in range(8):
                        acc ^= masks[bit] & staged[w + bit]
                    w += 8
    return torch.from_numpy(
        out[:, :sched.m].view(np.uint8)[:, :, :L].copy())


def build() -> Path:
    """Compile gf_apply.cu into BUILD_DIR (once per source content) and
    return the shared library's path. Raises on a failed build."""
    return nvcc.build(_SRC, BUILD_DIR, _nvcc)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.gf_apply
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _device_schedule(matrix_bytes: bytes, m: int, k: int,
                     device: torch.device) -> tuple[Schedule, torch.Tensor,
                                                    np.ndarray]:
    """A matrix's schedule, its arrays on `device` (one int32 tensor
    [group_records | words | ent | cent | cwo]) and the launch record
    the kernel's entry point reads (int64: the five arrays' addresses,
    k, m, mt, groups, the largest chunk's words, whether to stage them,
    the device's SM count). Kept in a least-recently-used cache bounded
    by COEF_CACHE_BYTES (a schedule larger than the bound is made for
    the call and not kept), so a call with a cached matrix computes
    none of it."""
    global _coef_bytes
    key = (matrix_bytes, m, k, device)
    with _coef_lock:
        hit = _coef_cache.get(key)
        if hit is not None:
            _coef_cache.move_to_end(key)
            return hit
    sched = compile_schedule(
        np.frombuffer(matrix_bytes, np.uint8).reshape(m, k))
    flat = torch.from_numpy(np.concatenate([
        sched.group_records().reshape(-1), sched.words.view(np.int32),
        sched.ent, sched.cent, sched.cwo])).to(device)
    grp = flat.data_ptr()
    ptrs = [grp + 48 * sched.groups]                # words
    for part in (sched.words, sched.ent, sched.cent):
        ptrs.append(ptrs[-1] + 4 * len(part))       # ent, cent, cwo
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else 0
    meta = np.array([*ptrs, grp, k, m, sched.mt, sched.groups,
                     sched.chunk_words, int(stages(sched)), sms], np.int64)
    entry = (sched, flat, meta)
    if sched.nbytes > COEF_CACHE_BYTES:
        return entry
    with _coef_lock:
        if key not in _coef_cache:
            _coef_cache[key] = entry
            _coef_bytes += sched.nbytes
            while _coef_bytes > COEF_CACHE_BYTES:
                _k, (old, _t, _m) = _coef_cache.popitem(last=False)
                _coef_bytes -= old.nbytes
    return entry


def _check(matrix: np.ndarray, data: torch.Tensor) -> None:
    m, k = matrix.shape
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"data must be a torch.Tensor, got {type(data)}")
    if data.dtype != torch.uint8 or data.ndim != 3:
        raise ValueError(f"data must be (batch, k, L) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if data.shape[1] != k:
        raise ValueError(f"data has {data.shape[1]} shards, "
                         f"matrix expects {k}")


def apply_matrix_plain(matrix: np.ndarray, data: torch.Tensor
                       ) -> torch.Tensor:
    """The kernel's function in plain torch ops on int32 words: the
    SWAR bit-linear accumulate of `pallas_gf._kernel_body`. `>>` on
    int32 is arithmetic, but `& 0x01010101` after a shift of at most 7
    keeps only bits that came from the word itself; `(v << 8) - v`
    wraps like the uint32 original. A length that is not a multiple
    of 4 is zero-padded to the next word and the padding's (zero)
    output dropped: each byte position is computed on its own."""
    matrix = np.ascontiguousarray(matrix, np.uint8)
    _check(matrix, data)
    m, k = matrix.shape
    B, _, L = data.shape
    if data.numel() == 0:
        return torch.zeros((B, m, L), dtype=torch.uint8, device=data.device)
    if L % 4:
        padded = data.new_zeros((B, k, L + 4 - L % 4))
        padded[:, :, :L] = data
        return apply_matrix_plain(matrix, padded)[:, :, :L]
    coefs = coef_words(matrix).view(np.int32)
    x = data.contiguous().view(torch.int32)          # (B, k, L // 4)
    accs: list[torch.Tensor | None] = [None] * m
    for j in range(k):
        xj = x[:, j]
        for b in range(8):
            col = coefs[:, j, b]
            if not col.any():
                continue
            v = (xj >> b) & _REP
            mask = (v << 8) - v
            for i in range(m):
                c = int(col[i])
                if c == 0:
                    continue
                term = mask if c == -1 else mask & c
                accs[i] = term if accs[i] is None else accs[i] ^ term
    zero = torch.zeros((B, L // 4), dtype=torch.int32, device=data.device)
    out = torch.stack([a if a is not None else zero for a in accs], dim=1) \
        if m else torch.empty((B, 0, L // 4), dtype=torch.int32,
                              device=data.device)
    return out.view(torch.uint8).reshape(B, m, L)


def apply_matrix_gf(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """out = matrix (GF) @ data along the shard axis; matrix static.

    CUDA tensor: one launch of the hand kernel on the current stream,
    counted in `apply_matrix_gf.launches` and, by (k, m, L, vec), in
    `apply_matrix_gf.by_shape`. CPU tensor: the plain version. Any
    other device raises."""
    matrix = np.ascontiguousarray(matrix, np.uint8)
    _check(matrix, data)
    if data.device.type == "cpu":
        return apply_matrix_plain(matrix, data)
    if data.device.type != "cuda":
        raise ValueError(f"gf_apply runs on cuda or cpu tensors, "
                         f"got {data.device}")
    m, k = matrix.shape
    B, _, L = data.shape
    out = torch.empty((B, m, L), dtype=torch.uint8, device=data.device)
    if B == 0 or L == 0 or m == 0:
        return out.zero_()
    data = data.contiguous()
    # 16-byte words where rows allow them, 4-byte words where rows are
    # word-aligned, else byte loads (ragged L or a misaligned start)
    ptr = data.data_ptr()
    vec = 4 if L % 16 == 0 and ptr % 16 == 0 else \
        1 if L % 4 == 0 and ptr % 4 == 0 else 0
    _sched, _flat, meta = _device_schedule(matrix.tobytes(), m, k,
                                           data.device)
    lib = _load()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.gf_apply(ptr, out.data_ptr(), meta.ctypes.data, B, L, vec,
                          stream)
    if rc != 0:
        raise RuntimeError(f"gf_apply launch failed: cudaError {rc} "
                           f"(B={B} k={k} m={m} L={L} vec={vec} "
                           f"schedule {meta[5:].tolist()})")
    apply_matrix_gf.launches += 1
    apply_matrix_gf.by_shape[(k, m, L, vec)] += 1
    return out


apply_matrix_gf.launches = 0
apply_matrix_gf.by_shape = collections.Counter()
