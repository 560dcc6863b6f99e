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

- On a CUDA tensor `crc32c_blocks`, `crc32c_extend`, `crc32c_sets`,
  `xxh32_blocks` and `xxh64_blocks` launch `csrc/csum.cu` (sm_90a),
  built with nvcc on first use into `ceph_tpu_torch/_build/`
  (utils/nvcc.py) and loaded with ctypes; each launch is counted in
  `launches` by kernel name, and each CRC launch in `shapes` by its
  row sets' (B, L, vec). A build or launch failure raises; nothing
  falls back. Every CRC of the main path (the fused write's hinfo
  CRCs, the RMW delta's, the recovery program's rebuilt rows and fold,
  deep scrub, HashInfo appends) goes through these CRC entry points;
  the three fused programs make one `crc32c_sets` launch a call.
- On a CPU tensor they run the plain versions, which take a tensor on
  any device: `crc32c_blocks_plain`, `crc32c_extend_plain`,
  `crc32c_sets_plain`, `xxh32_blocks_plain`, `xxh64_blocks_plain`.

The CRC kernel. CRC is GF(2)-linear in the message, and a zero register
stays zero through zero bytes. Each row's head of L // 32 units of 32
bytes, preceded by `pad` zero units, is cut into S = 2**levels segments
of `seg` units; a lane computes one segment's zero-register CRC with
slicing-by-4 tables of its own in shared memory (lane-private: no bank
conflicts), from units its warp stages with coalesced copies; within a
warp's work item each lane shifts its CRC past the later segments of
its row there (`lane_cols`) and the row's lanes XOR theirs; an item is
shifted past the items after it by level matrices (`plan_cols`) and
XORed into its row atomically; the last L % 32 bytes step apart, and
the seed term (shift^L(init) ^ xorout, or shift^L(reg) for
crc32c_extend) is added once. One block a SM walks the items.
`plan_for` picks S for the card (`plans_for` for the sets of one
launch); `crc32c_split_ref` and `crc32c_sets_ref` are the same algebra
in torch for the tests, the kernel's realigned loads of rows off the
16-byte grid included.

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
from ..utils.flight_recorder import declare_span_names
from ..utils.tracing import span
from .reference import (apply_shift, crc32c_slice8_tables, crc32c_table,
                        matrix_cols_u32, shift_matrix)

_M32 = 0xFFFFFFFF
_SRC = Path(__file__).resolve().parent / "csrc" / "csum.cu"
_MAX_LEN = (1 << 31) - 1

# The CRC kernel's launch plan (see csrc/csum.cu)
UNIT = 32               # bytes of a unit: two 16-byte loads
WARP = 32               # lanes of a work item
ITEMS_PER_SM = 16       # work items plan_for aims to give each SM
MIN_SEG_UNITS = 4       # a lane takes 128 bytes at least
BLOCK_WARPS = 12        # warps of a block (one a SM)
MAX_LEVELS = 20         # S <= 2**20 (15 item levels in the kernel)
MAX_SETS = 4            # row sets one launch takes

# kernel launches by name: "crc32c", "xxh32", "xxh64"
launches: collections.Counter = collections.Counter()
# CRC launches by shape: "B,L,vec" a row set, sets joined by "+" (vec:
# the largest of 16, 8, 4, 2, 1 dividing the rows' start and pitch)
shapes: collections.Counter = collections.Counter()

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
    segments of `seg` units, one a lane; a work item holds
    2**log_lanes lanes of a row (a warp's 32, or all S when S < 32, and
    then 32 // S rows), so a row spans `nb` items."""
    L: int
    segments: int
    seg: int
    log_lanes: int

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
        return self.segments >> self.log_lanes

    @property
    def levels(self) -> int:
        return self.segments.bit_length() - 1

    def items(self, B: int) -> int:
        """Work items of B rows: row groups of 32 >> log_lanes rows (a
        warp's lanes), nb items a group."""
        per = WARP >> min(self.log_lanes, 5)
        return -(-B // per) * self.nb


def make_plan(L: int, segments: int, lanes: int = WARP) -> CrcPlan:
    """The plan for rows of L bytes in `segments` segments, at most
    `lanes` of them in one work item (both powers of two). The kernel
    launches items of a warp (lanes = 32, what `plan_for` gives); the
    model `crc32c_split_ref` takes any width up to 256."""
    for name, v, top in (("segments", segments, 1 << MAX_LEVELS),
                         ("lanes", lanes, 256)):
        if v < 1 or v & (v - 1) or v > top:
            raise ValueError(f"{name} must be a power of two <= {top}, "
                             f"got {v}")
    if not 0 <= L <= _MAX_LEN:
        raise ValueError(f"rows of {L} bytes: the kernel takes 0 to "
                         f"2**31 - 1")
    seg = -(-(L // UNIT) // segments)
    return CrcPlan(L, segments, seg,
                   min(segments, lanes).bit_length() - 1)


@functools.lru_cache(maxsize=4096)
def plan_for(B: int, L: int, sms: int, warps: int | None = None
             ) -> CrcPlan:
    """The kernel's plan for B rows of L bytes on a card of `sms` SMs:
    the fewest segments (a power of two) whose warp items number
    `warps` or more (by default ITEMS_PER_SM a SM), as long as a segment
    keeps MIN_SEG_UNITS units or more. Few long rows thereby spread over
    every SM, and short rows get a warp or less a row."""
    want = sms * ITEMS_PER_SM if warps is None else warps
    units = L // UNIT
    S = 1
    while (S < 1 << MAX_LEVELS and make_plan(L, S).items(B) < want
           and -(-units // (2 * S)) >= MIN_SEG_UNITS):
        S *= 2
    return make_plan(L, S)


def plans_for(shapes, sms: int) -> list:
    """The plans of one launch's row sets, shapes [(B, L), ...]: each
    set gets the card's warps in proportion to its bytes (at least
    one), so that the sets together fill the card as one set would."""
    total = sum(B * max(L, 1) for B, L in shapes) or 1
    every = sms * ITEMS_PER_SM
    return [plan_for(B, L, sms, max(1, -(-every * B * max(L, 1) // total)))
            for B, L in shapes]


@functools.lru_cache(maxsize=1024)
def plan_cols(plan: CrcPlan) -> np.ndarray:
    """(levels + 2, 32) uint32 column words of the plan's shift
    matrices: level l advances through seg * UNIT << l bytes; then the
    tail's (L % UNIT bytes) and the row's (L bytes)."""
    nbytes = [plan.seg * UNIT << l for l in range(plan.levels)]
    nbytes += [plan.tail, plan.L]
    return np.stack([matrix_cols_u32(shift_matrix(n)) for n in nbytes])


@functools.lru_cache(maxsize=1024)
def lane_cols(plan: CrcPlan) -> np.ndarray:
    """(2**log_lanes, 32) uint32 column words: lane j's matrix shifts its
    segment's CRC past the later segments of its row in its item,
    (2**log_lanes - 1 - j) * seg * UNIT bytes."""
    n = 1 << plan.log_lanes
    return np.stack([matrix_cols_u32(shift_matrix((n - 1 - j) * plan.seg
                                                  * UNIT))
                     for j in range(n)])


@functools.lru_cache(maxsize=1024)
def plan_mats(plan: CrcPlan) -> np.ndarray:
    """The kernel's matrices of a plan (items of a warp, log_lanes <= 5)
    as one uint32 array: lane j's column b at [32 b + j] (so a warp
    reads a column of all its lanes' matrices in one load), then
    `plan_cols` from word 1024 on."""
    lanes = np.zeros((32, 32), np.uint32)
    lanes[:, :1 << plan.log_lanes] = lane_cols(plan).T
    return np.concatenate([lanes.reshape(-1), plan_cols(plan).reshape(-1)])


@functools.lru_cache(maxsize=256)
def _plan_mats_on(plan: CrcPlan, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(plan_mats(plan).view(np.int32)).to(device)


def _apply_cols(cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The 32x32 GF(2) matrix given by its 32 column words (int64) applied
    to int64 registers < 2^32: XOR of the columns of x's set bits."""
    out = torch.zeros_like(x)
    for b in range(32):
        out ^= ((x >> b) & 1) * cols[b]
    return out


def _unit_words(blocks: torch.Tensor, plan: CrcPlan) -> torch.Tensor:
    """(B, S, seg * 8) int64: the little-endian words each lane steps
    through, the virtual zero units in front included, read as the
    kernel reads them. Rows whose start and pitch (in the blocks'
    storage, taken as 16-byte aligned) are multiples of 16 take their
    units' two 16-byte words; any others the two or three aligned
    16-byte words that hold a unit's 32 bytes, shifted by o // 4 words
    and o % 4 bytes (o: the unit's offset from the grid). Raises if a
    word read holds no byte of its row."""
    B, L = blocks.shape
    S, seg, units = plan.segments, plan.seg, plan.units
    dev = blocks.device
    words = torch.zeros((B, plan.pad + units, 8), dtype=torch.int64,
                        device=dev)
    if units and B:
        pitch = blocks.stride(0) if B > 1 else 0
        if L > 1 and blocks.stride(1) != 1:
            raise ValueError("rows must be contiguous")
        flat = torch.frombuffer(bytearray(blocks.untyped_storage().cpu()),
                                dtype=torch.uint8) \
            if blocks.device.type == "cpu" else None
        if flat is None:
            flat = blocks.untyped_storage()
            flat = torch.empty(0, dtype=torch.uint8, device=dev).set_(
                flat).reshape(-1)
        n16 = -(-flat.numel() // 16) * 16 + 16
        buf = torch.zeros(n16, dtype=torch.int64, device=dev)
        buf[:flat.numel()] = flat.long()
        b4 = buf.reshape(-1, 4)
        word = b4[:, 0] | b4[:, 1] << 8 | b4[:, 2] << 16 | b4[:, 3] << 24
        rows = torch.arange(B, device=dev).long()
        start = blocks.storage_offset() + rows * pitch             # (B,)
        at = start[:, None] + UNIT * torch.arange(units, device=dev)
        aligned = blocks.storage_offset() % 16 == 0 and pitch % 16 == 0
        o = torch.zeros_like(at) if aligned else at % 16
        base = (at - o) // 4                                       # word
        x = [word[base + i] for i in range(12)]
        third = o != 0
        x[8:] = [torch.where(third, xi, 0) for xi in x[8:]]
        # the words read must each hold a byte of their row
        end = start[:, None] + L
        for k, live in ((0, None), (1, None), (2, third)):
            lo = 4 * base + 16 * k
            ok = (lo < end) & (lo + 16 > start[:, None])
            if live is not None:
                ok = ok | ~live
            if not bool(ok.all()):
                raise AssertionError("a load reads a 16-byte word that "
                                     "holds no byte of its row")
        two, one = (o & 8) != 0, (o & 4) != 0
        x = [torch.where(two, x[i + 2], x[i]) for i in range(10)] + x[10:]
        x = [torch.where(one, x[i + 1], x[i]) for i in range(9)]
        s = 8 * (o & 3)
        w = [torch.where(s == 0, x[i],
                         ((x[i] >> s) | (x[i + 1] << (32 - s))) & _M32)
             for i in range(8)]
        words[:, plan.pad:] = torch.stack(w, dim=-1)
    return words.reshape(B, S, seg * 8)


def _segment_crcs(words: torch.Tensor) -> torch.Tensor:
    """(B, S) zero-register CRCs of each lane's words, slicing by 4 as
    the kernel's lane-private tables do: the register after a word x
    (XORed in) is T3[x & 0xFF] ^ T2[x >> 8 & 0xFF] ^ T1[x >> 16 & 0xFF]
    ^ T0[x >> 24], T_j the step through j + 1 zero bytes."""
    slice8, _ = _crc_tables(words.device)
    v = torch.zeros(words.shape[:2], dtype=torch.int64, device=words.device)
    for i in range(words.shape[2]):
        x = v ^ words[:, :, i]
        v = slice8[3][x & 0xFF] ^ slice8[2][(x >> 8) & 0xFF] \
            ^ slice8[1][(x >> 16) & 0xFF] ^ slice8[0][(x >> 24) & 0xFF]
    return v


def _item_values(blocks: torch.Tensor, plan: CrcPlan, seed: torch.Tensor
                 ) -> torch.Tensor:
    """(B, nb) what each work item XORs into its row's output: each
    lane's segment CRC shifted past the later segments of its row in the
    item (`lane_cols`) and XORed across the row's lanes; that shifted
    past the items after it (the binary digits of their count pick
    level matrices) and past the tail; the last item adds the tail's
    steps and the seed term `seed` (B,)."""
    B, L = blocks.shape
    dev = blocks.device
    cols = torch.from_numpy(plan_cols(plan).astype(np.int64)).to(dev)
    lanes = torch.from_numpy(lane_cols(plan).astype(np.int64)).to(dev)
    v = _segment_crcs(_unit_words(blocks, plan))
    v = v.reshape(B, plan.nb, 1 << plan.log_lanes)
    item = torch.zeros((B, plan.nb), dtype=torch.int64, device=dev)
    for j in range(v.shape[2]):
        item ^= _apply_cols(lanes[j], v[..., j])
    parts = []
    for bi in range(plan.nb):
        x, m, level = item[:, bi], plan.nb - 1 - bi, plan.log_lanes
        while m:
            if m & 1:
                x = _apply_cols(cols[level], x)
            m, level = m >> 1, level + 1
        parts.append(_apply_cols(cols[plan.levels], x) if plan.tail else x)
    last = _tail_steps(torch.zeros_like(parts[0]), blocks, plan.units * UNIT)
    parts[-1] = parts[-1] ^ last ^ seed
    return torch.stack(parts, dim=1)


def _seed(blocks: torch.Tensor, plan: CrcPlan, init: int, xorout: int,
          regs) -> torch.Tensor:
    """(B,) the seed term: shift^L(reg) for crc32c_extend (`regs`),
    else shift^L(init) ^ xorout."""
    if regs is not None:
        cols = torch.from_numpy(plan_cols(plan).astype(np.int64)).to(
            blocks.device)
        return _apply_cols(cols[plan.levels + 1], _as_regs(regs, blocks))
    return torch.full((blocks.shape[0],), _seed_term(init, xorout, plan.L),
                      dtype=torch.int64, device=blocks.device)


def crc32c_split_ref(blocks, plan: CrcPlan, init: int = 0xFFFFFFFF,
                     xorout: int = 0xFFFFFFFF, regs=None) -> torch.Tensor:
    """The CRC kernel's algebra in torch, for tests: each lane's words
    read as the kernel's loads read them (`_unit_words`: aligned or
    realigned, and only words that hold row bytes), its slicing-by-4
    register, the tree over an item's lanes with the plan's level
    matrices, the shift of each item past the items after it, the
    tail's shift and serial steps, the seed term (of crc32c_blocks, or
    of crc32c_extend where `regs` is given) and the XOR of the items.
    Equals crc32c_blocks (crc32c_extend)."""
    blocks = _as_blocks(blocks)
    if blocks.shape[1] != plan.L:
        raise ValueError(f"plan for rows of {plan.L} bytes, got "
                         f"{blocks.shape[1]}")
    vals = _item_values(blocks, plan, _seed(blocks, plan, init, xorout,
                                            regs))
    out = vals[:, 0]
    for bi in range(1, plan.nb):
        out = out ^ vals[:, bi]
    return out


@dataclasses.dataclass(frozen=True)
class CrcRows:
    """One row set of a `crc32c_sets` launch: (B, L) uint8 rows and
    their seed, crc32c_blocks' (init, xorout), or crc32c_extend's
    registers where `regs` is given."""
    blocks: object
    init: int = 0xFFFFFFFF
    xorout: int = 0xFFFFFFFF
    regs: object = None


def crc32c_sets_ref(sets, sms: int) -> torch.Tensor:
    """The multi-set launch's algebra in torch, for tests: the plans
    `plans_for` gives the sets, their warp items numbered one set after
    another (each set's first item and first output row), the items
    walked as the kernel's persistent grid walks them (min(sms, items)
    blocks of BLOCK_WARPS warps; item i by block i % grid, warp i // grid
    % BLOCK_WARPS; every item once), each item's value XORed into its row
    of the one (sum of B) output. Equals crc32c_sets_plain."""
    sets = [s for s in sets if _as_blocks(s.blocks).shape[0]]
    if not sets:
        return torch.zeros((0,), dtype=torch.int64)
    blocks = [_as_blocks(s.blocks) for s in sets]
    plans = plans_for([tuple(b.shape) for b in blocks], sms)
    first, rows, n_items = [], [], 0
    for b, plan in zip(blocks, plans):
        first.append(n_items)
        rows.append(sum(x.shape[0] for x in blocks[:len(rows)]))
        n_items += plan.items(b.shape[0])
    grid = min(sms, n_items)
    walked = []
    for blk in range(grid):
        for warp in range(BLOCK_WARPS):
            walked.extend(range(blk + grid * warp, n_items,
                                grid * BLOCK_WARPS))
    if sorted(walked) != list(range(n_items)):
        raise AssertionError("the grid does not walk every item once")
    vals = [_item_values(b, plan, _seed(b, plan, s.init, s.xorout, s.regs))
            for b, plan, s in zip(blocks, plans, sets)]
    out = torch.zeros((sum(b.shape[0] for b in blocks),), dtype=torch.int64,
                      device=blocks[0].device)
    for it in walked:
        s = max(i for i in range(len(sets)) if first[i] <= it)
        grp, bi = divmod(it - first[s], plans[s].nb)
        per = WARP >> plans[s].log_lanes
        for r in range(grp * per, min(blocks[s].shape[0], (grp + 1) * per)):
            out[rows[s] + r] ^= vals[s][r, bi]
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
            lib.crc32c_rows.argtypes = [I, P, P, I, P]
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


def _launch(name: str, device: torch.device, what: str, call) -> None:
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = call(lib, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({what})")
    launches[name] += 1


def _crc32c_kernel(sets) -> torch.Tensor:
    """One launch of the CRC kernel over row sets [(blocks, regs or
    None, add)] on one CUDA device: (sum of B,) int64."""
    dev = sets[0][0].device
    out = torch.empty((sum(b.shape[0] for b, _, _ in sets),),
                      dtype=torch.int64, device=dev)
    live = []
    for blocks, regs, add in sets:
        if blocks.device != dev:
            raise ValueError(f"crc32c: row sets on {dev} and "
                             f"{blocks.device}")
        rows, pitch = _rows_for_kernel(blocks, "crc32c")
        if rows.shape[0]:
            ptr = rows.data_ptr()
            vec = next(v for v in (16, 8, 4, 2, 1)
                       if ptr % v == 0 and pitch % v == 0)
            live.append((rows, pitch, vec, regs, add))
    if not live:
        return out
    if len(live) > MAX_SETS:
        raise ValueError(f"crc32c: {len(live)} row sets; one launch takes "
                         f"{MAX_SETS} at most")
    plans = plans_for([tuple(r.shape) for r, *_ in live], _sms(dev))
    mats = [_plan_mats_on(plan, dev) for plan in plans]
    meta = np.array([
        [rows.data_ptr(), pitch, 0 if regs is None else regs.data_ptr(),
         m.data_ptr(), rows.shape[0], plan.units, plan.tail, plan.seg,
         plan.pad, plan.log_lanes, plan.levels, add, vec == 16]
        for (rows, pitch, vec, regs, add), plan, m
        in zip(live, plans, mats)], np.int64)
    key = "+".join(f"{r.shape[0]},{r.shape[1]},{vec}"
                   for r, _, vec, _, _ in live)
    _launch("crc32c", dev, key, lambda lib, stream: lib.crc32c_rows(
        len(live), meta.ctypes.data, out.data_ptr(), _sms(dev), stream))
    shapes[key] += 1
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
    return _crc32c_kernel([(blocks, None, _seed_term(
        init, xorout, int(blocks.shape[1])))])


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
    return _crc32c_kernel([(blocks, _as_regs(regs, blocks), 0)])


def _sets(sets) -> list:
    sets = list(sets)
    if not 1 <= len(sets) <= MAX_SETS:
        raise ValueError(f"crc32c_sets takes 1 to {MAX_SETS} row sets, "
                         f"got {len(sets)}")
    return sets


def crc32c_sets_plain(sets) -> torch.Tensor:
    """crc32c_sets in plain torch ops, on the device the blocks lie on:
    each set's crc32c_blocks (or crc32c_extend) in turn."""
    return torch.cat([
        crc32c_blocks_plain(s.blocks, s.init, s.xorout) if s.regs is None
        else crc32c_extend_plain(s.regs, s.blocks) for s in _sets(sets)])


CRC_SPAN = "csum.crc32c"
declare_span_names(CRC_SPAN)


def crc32c_sets(sets) -> torch.Tensor:
    """CRC-32C of 1 to MAX_SETS row sets (`CrcRows`: rows of their own
    B and L, each with crc32c_blocks' init/xorout or crc32c_extend's
    registers) as one (sum of B,) int64: set after set, each what
    crc32c_blocks (crc32c_extend) gives it. On CUDA tensors one kernel
    launch; on CPU tensors the plain version; any other device raises.
    Spanned as `csum.crc32c`, tagged with its rows and bytes."""
    sets = _sets(sets)
    blocks = [_as_blocks(s.blocks) for s in sets]
    with span(CRC_SPAN, ring=False) as sp:
        if sp.on:
            sp.tag(rows=sum(int(b.shape[0]) for b in blocks),
                   bytes=sum(b.numel() for b in blocks))
        if blocks[0].device.type == "cpu":
            if any(b.device.type != "cpu" for b in blocks):
                raise ValueError("crc32c_sets: the row sets lie on "
                                 "different devices")
            return crc32c_sets_plain(sets)
        return _crc32c_kernel([
            (b, None, _seed_term(s.init, s.xorout, int(b.shape[1])))
            if s.regs is None else (b, _as_regs(s.regs, b), 0)
            for s, b in zip(sets, blocks)])


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
    _launch(name, rows.device, f"B={B} L={L}",
            lambda lib, stream: getattr(lib, fn)(
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
