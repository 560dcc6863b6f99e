"""ECBackend — the erasure-coded PG data path, on the card.

Twin of ceph_tpu/osd/ecbackend.py (ref: src/osd/ECBackend.{h,cc} +
ECCommon.{h,cc}; per-shard HashInfo ref: src/osd/ECUtil.{h,cc}). The
unit of work is a BATCH of objects: writes encode (B, k, chunk) in one
fused launch, recovery stages the helpers of B objects into one
(B, H, chunk) stack, runs one fused decode and scatters the rebuilt
shards back. Data and metadata (shards, hinfo xattrs, the stripe
journal's omap, the PG log) stay on the host in MemStore, as in the
twin; every encode, decode and CRC runs on the backend's device — the
CUDA device unless the caller passes `device="cpu"`.

Where the twin hands numpy to `jax.device_put`/`device_get`, the port
stages helper rows into pinned host buffers, uploads them with
non-blocking copies, and brings results back into pinned buffers, one
batch ahead; CUDA events order the host's reuse of a buffer after the
copy that reads it (see RecoveryRunner).

The device programs:
- `_fused_write_fn(...)(data)`: parity encode plus the raw hinfo
  CRC32C (seed -1, no final xor) of all k+m rows of every object;
- `_fused_delta_fn(...)(deltas)`: the RMW parity-delta encode plus the
  zero-seed CRCs of every delta row, for any window length;
- `_build_recover_program(dec_fn, verify, host_crc)`: decode, then the
  CRCs of the rebuilt rows and of the helpers' XOR-fold (one CRC
  launch), the fold's compared with `_expected_fold_crcs`.
The fused programs' CRCs are one `crc32c_sets` launch a call.
CRCs leave the device as int64 tensors holding uint32 values and are
turned into uint32 arrays before they reach HashInfo or a comparison.

Recovery stages helper rows from local stores or, over the wire tier's
`RemoteStore` (osd/standalone.py), from `readv_submit` /
`readv_ranges_submit` frames: full rows, or, for a Clay single-loss
plan, only the sub-chunk ranges of the repair planes
(`readv_ranges_host`: the source verifies each full row against its
hinfo and CRCs the shipped bytes on its backend's device).

CPU backends take the twin's host modes when the port's native library
is built with hardware CRC32C (`_host_crc_available(device)`): the
native RS codec encodes writes and parity deltas, and the CRCs of host
rows run as SSE4.2 instructions, with the twin's bytes and counters. A
card backend never takes them.
"""

from __future__ import annotations

import functools
import struct as _struct
import threading as _threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..csum.kernels import CrcRows, crc32c_blocks, crc32c_sets
from ..ec.interface import ErasureCode, host_array, resolve_device
from ..ec.registry import factory
from ..ec.rs import ReedSolomon
from ..ops.rs_kernels import make_encoder, pow2_bucket, run_bucketed, \
    xor_reduce
from ..utils.flight_recorder import declare_span_names
from ..utils.perf_counters import PerfCountersBuilder
from ..utils.tracing import span
from .memstore import MemStore, Transaction
from .pgbackend import (HINFO_KEY, PGBackend, shard_cid,  # noqa: F401
                        to_device)
from .pglog import PGLog
from .repairplan import plan_read, plan_repair
from .stripe import HashInfo, StripeInfo, as_flat_u8

_SEED = 0xFFFFFFFF

# the span names of this module's sites: the ECBackend methods' (which
# a sampled op's flight ring may carry; the observability smoke asserts
# no ring carries an undeclared name) and the device programs' (kept
# out of the ring: `ring=False`)
declare_span_names(
    "ecbackend.write.encode", "ecbackend.read.decode",
    "ecbackend.recover.stage", "ecbackend.recover.launch",
    "ecbackend.recover.fetch", "ecbackend.recover.writeback")
FUSED_WRITE = "ecbackend.fused_write"
FUSED_WRITE_HINFO = "ecbackend.fused_write.hinfo"
RECOVER_PROGRAM = "ecbackend.recover_program"
RECOVER_DECODE = "ecbackend.recover_program.decode"
RECOVER_FOLD = "ecbackend.recover_program.fold"
RECOVER_VERIFY = "ecbackend.recover_program.verify"
declare_span_names(FUSED_WRITE, FUSED_WRITE_HINFO, RECOVER_PROGRAM,
                   RECOVER_DECODE, RECOVER_FOLD, RECOVER_VERIFY)


def _u32(t: torch.Tensor) -> np.ndarray:
    """A CRC tensor (int64 holding uint32 values) as a uint32 array."""
    return t.cpu().numpy().astype(np.uint32)


def _upload_padded(arr: np.ndarray, bucket: int,
                   device: torch.device) -> torch.Tensor:
    """(B, ...) host rows -> (bucket, ...) on `device`, the padding rows
    zeros made on the device."""
    B = arr.shape[0]
    if bucket == B:
        return to_device(arr, device)
    out = torch.zeros((bucket,) + tuple(arr.shape[1:]), dtype=torch.uint8,
                      device=device)
    out[:B] = to_device(arr, device)
    return out


def ec_perf_counters():
    """The EC data-path counter schema (logger "ec"), as in the twin."""
    return (PerfCountersBuilder("ec")
            .add_u64_counter("encode_launches",
                             "generic encode device launches")
            .add_u64_counter("fused_write_launches",
                             "fused encode+crc single launches")
            .add_u64_counter("host_encode_launches",
                             "write-path encodes served by the native "
                             "SSE codec + hardware crc32c (CPU "
                             "backend only — bit-identical to the "
                             "fused device launch)")
            .add_u64_counter("decode_launches",
                             "read-path decode launches")
            .add_u64_counter("recover_launches",
                             "fused recovery launches")
            .add_u64_counter("program_cache_hits",
                             "compiled-program cache hits")
            .add_u64_counter("program_cache_misses",
                             "compiled-program cache compiles")
            .add_u64_counter("encode_bytes", "logical bytes encoded")
            .add_u64_counter("decode_bytes", "logical bytes decoded")
            .add_u64_counter("recovered_objects",
                             "objects rebuilt by recovery")
            .add_u64_counter("recovered_bytes",
                             "shard bytes rebuilt by recovery")
            .add_u64_counter("hinfo_failures",
                             "helper chunks failing hinfo verify")
            .add_u64_counter("read_eio",
                             "read-path chunk crc mismatches")
            .add_u64_counter("planner_local_plans",
                             "repairs planned inside one LRC local "
                             "group (repair-locality planner)")
            .add_u64_counter("planner_subchunk_plans",
                             "repairs planned as Clay/MSR sub-chunk "
                             "range reads")
            .add_u64_counter("planner_cost_plans",
                             "cost-ranked helper selections (SHEC "
                             "windows / MDS cheapest-k)")
            .add_u64_counter("planner_full_plans",
                             "plans laddered to a full/multi-loss "
                             "decode (locality broken or multi-loss)")
            .add_u64_counter("recover_wire_bytes",
                             "helper bytes pulled for recovery (the "
                             "repair-bytes-on-wire numerator)")
            .add_time_avg("encode_time", "write-path encode wall time",
                          hist=True)
            .add_time_avg("decode_time", "read-path decode wall time",
                          hist=True)
            .add_time_avg("recover_stage_time",
                          "recovery host staging (producer thread)")
            .add_time_avg("recover_launch_time",
                          "recovery launch enqueue + async D2H start",
                          hist=True)
            .add_time_avg("recover_fetch_time",
                          "blocking remainder of the D2H fetch "
                          "(overlap eats the rest)")
            .add_time_avg("recover_writeback_time",
                          "rebuilt-shard writeback fan-out")
            .add_u64_counter("rmw_ops",
                             "partial-stripe overwrites served by the "
                             "parity-delta fast path")
            .add_u64_counter("rmw_delta_launches",
                             "fused delta-encode launches (device or "
                             "native host)")
            .add_u64_counter("rmw_wire_bytes",
                             "journal + delta payload bytes shipped "
                             "to participating shards (the RMW "
                             "amplification numerator)")
            .add_u64_counter("rmw_preread_bytes",
                             "pre-image bytes read for delta "
                             "construction (zero on the append path)")
            .add_u64_counter("rmw_fetch_waves",
                             "combined RMW prepare-fetch waves (one "
                             "per delta group: hinfo attrs + pre-"
                             "image ranges gathered in a single "
                             "overlapped round trip)")
            .add_u64_counter("rmw_fetch_frames",
                             "prepare-fetch frames issued (one per "
                             "participant shard per wave — the 1+m "
                             "sequential getattrs + per-span reads "
                             "these replaced counted 1 frame each)")
            .add_u64_counter("rmw_shard_ios",
                             "participating shards per RMW op, summed "
                             "(the shard-IO amplification counter: "
                             "1 data + m parity on the fast path)")
            .add_u64_counter("rmw_full_fallbacks",
                             "RMW jobs laddered to the full-stripe "
                             "path (degraded/stale stripe, stripe-"
                             "spanning or overlapping writes)")
            .add_u64_counter("rmw_append_fast",
                             "delta jobs whose pre-image was pure "
                             "padding (appends: no read phase at all)")
            .add_u64_counter("journal_entries",
                             "stripe-journal intents logged")
            .add_u64_counter("journal_replay_forward",
                             "journaled RMWs rolled forward on replay")
            .add_u64_counter("journal_replay_rollback",
                             "journaled RMWs rolled back on replay")
            .add_u64_counter("write_wire_bytes",
                             "full-path shard write bytes shipped "
                             "(the full-stripe amplification "
                             "numerator the RMW ratio divides by)")
            .add_u64_counter("stream_launches",
                             "StreamingCodec tile launches")
            .add_u64_counter("stream_bytes",
                             "bytes streamed through tiled encode")
            .add_time_avg("stream_drain_time",
                          "StreamingCodec blocking drain remainder")
            .create_perf_counters())


@dataclass
class ShardSet:
    """The 'cluster': one ObjectStore per OSD id. `store_factory` picks
    the backend (MemStore by default)."""
    stores: dict[int, MemStore] = field(default_factory=dict)
    store_factory: "callable | None" = None

    def osd(self, osd_id: int) -> MemStore:
        if osd_id not in self.stores:
            self.stores[osd_id] = (self.store_factory(osd_id)
                                   if self.store_factory else MemStore())
        return self.stores[osd_id]


# -- device programs -----------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _fused_write_fn(matrix_bytes: bytes, m: int, k: int, impl: str,
                    sl: int, bucket: int, device: torch.device):
    """Process-wide cache: every PG backend with the same coder geometry
    shares one program per (shard len, batch bucket, device). The
    program maps (bucket, k, sl) u8 data on `device` to ((bucket, m, sl)
    parity, (bucket, k+m) raw hinfo CRCs in dense row order), the CRCs as
    int64 tensors holding uint32 values (see csum/kernels.py)."""
    matrix = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(m, k)
    enc = make_encoder(matrix, impl, bucket_batch=False)
    device = resolve_device(device)

    def fused(d: torch.Tensor):
        if d.shape != (bucket, k, sl) or d.dtype != torch.uint8 \
                or d.device != device:
            raise ValueError(
                f"fused write wants ({bucket}, {k}, {sl}) uint8 on "
                f"{device}, got {tuple(d.shape)} {d.dtype} on {d.device}")
        with span(FUSED_WRITE, ring=False, bytes=bucket * k * sl):
            parity = enc(d)
            # the CRCs of [data; parity] rows in one launch, without
            # concatenating the rows
            crc = crc32c_sets([CrcRows(d.reshape(bucket * k, sl), _SEED,
                                       0),
                               CrcRows(parity.reshape(bucket * m, sl),
                                       _SEED, 0)])
            with span(FUSED_WRITE_HINFO, ring=False):
                return parity, torch.cat(
                    [crc[:bucket * k].reshape(bucket, k),
                     crc[bucket * k:].reshape(bucket, m)], dim=1)
    return fused


@functools.lru_cache(maxsize=256)
def _fused_delta_fn(matrix_bytes: bytes, m: int, t: int, impl: str,
                    wl: int, bucket: int, device: torch.device):
    """Process-wide fused delta-encode program, one per (delta matrix,
    window len, batch bucket, device): delta rows (bucket, t, wl) on
    `device` -> (parity deltas (bucket, m, wl), zero-seed CRCs of all
    t+m rows as int64) — the CRCs feed the incremental hinfo update.
    `wl` is any length: the RMW window of a 5-byte overwrite is 5."""
    D = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(m, t)
    enc = make_encoder(D, impl, bucket_batch=False)
    device = resolve_device(device)

    def fused(d: torch.Tensor):
        if d.shape != (bucket, t, wl) or d.dtype != torch.uint8 \
                or d.device != device:
            raise ValueError(
                f"fused delta wants ({bucket}, {t}, {wl}) uint8 on "
                f"{device}, got {tuple(d.shape)} {d.dtype} on {d.device}")
        parity = enc(d)
        crc = crc32c_sets([CrcRows(d.reshape(bucket * t, wl), 0, 0),
                           CrcRows(parity.reshape(bucket * m, wl), 0, 0)])
        return parity, torch.cat([crc[:bucket * t].reshape(bucket, t),
                                  crc[bucket * t:].reshape(bucket, m)],
                                 dim=1)
    return fused


@functools.lru_cache(maxsize=256)
def _fold_seed_const(sl: int) -> int:
    """shift^{sl}(0xFFFFFFFF): the seed contribution inside a raw
    hinfo CRC of an sl-byte row (crc_{-1}(m) = crc_0(m) ^ K)."""
    from ..csum.reference import apply_shift
    return int(apply_shift(0xFFFFFFFF, sl))


def _expected_fold_crcs(exp: np.ndarray, sl: int) -> np.ndarray:
    """Expected raw CRC of the XOR-fold of H helper rows, from their
    expected per-row hinfo CRCs. CRC32C is GF(2)-linear in the message:
    crc_0(r0 ^ .. ^ rH) = XOR_i crc_0(r_i), and the -1 seed adds the
    constant K = shift^{sl}(-1) per row — so H rows verify with ONE
    data-pass checksum instead of H."""
    K = np.uint32(_fold_seed_const(sl))
    folded = np.bitwise_xor.reduce(exp.astype(np.uint32) ^ K, axis=1)
    return folded ^ K


def _build_recover_program(dec_fn, verify: bool, host_crc: bool):
    """One recovery program per (decode function, verify, mode).

    host_crc mode: fn(stack) -> (rebuilt[, helper-fold]); the caller
    checksums on the host. Device mode: fn(stack, expfold) -> (rebuilt,
    rebuilt CRCs, fold-ok), all on the stack's device; expfold (B,) is
    what `_expected_fold_crcs` gives, best passed as an int64 tensor
    already on that device (a host array is uploaded here)."""
    def fold(stack: torch.Tensor) -> torch.Tensor:
        B, H, rl = stack.shape
        with span(RECOVER_FOLD, ring=False, bytes_in=B * H * rl,
                  bytes_out=B * rl):
            return xor_reduce(stack, dim=1)

    if host_crc:
        def fused_host(stack: torch.Tensor):     # (B, H, sl) u8
            B, H, sl = stack.shape
            with span(RECOVER_PROGRAM, ring=False, B=B, H=H, rl=sl):
                with span(RECOVER_DECODE, ring=False):
                    rebuilt = dec_fn(stack)      # (B, E, sl)
                if verify:
                    return rebuilt, fold(stack)
                return (rebuilt,)
        return fused_host

    def fused(stack: torch.Tensor, expfold):     # (B, H, rl) u8, (B,)
        B, H, rl = stack.shape
        with span(RECOVER_PROGRAM, ring=False, B=B, H=H, rl=rl):
            with span(RECOVER_DECODE, ring=False):
                rebuilt = dec_fn(stack)  # (B, E, sl) — sl may exceed the
            E = rebuilt.shape[1]         # staged rl (range plans ship
            out_len = rebuilt.shape[2]   # sub-chunks, rebuild whole rows)
            rows = CrcRows(rebuilt.reshape(B * E, out_len), _SEED, 0)
            if verify:
                # the rebuilt rows' CRCs and the helper fold's (rl
                # bytes) in one launch
                crc = crc32c_sets([rows, CrcRows(fold(stack), _SEED, 0)])
                rcrc, fcrc = crc[:B * E].reshape(B, E), crc[B * E:]
                with span(RECOVER_VERIFY, ring=False):
                    if not isinstance(expfold, torch.Tensor):
                        expfold = torch.from_numpy(
                            np.asarray(expfold).astype(np.int64))
                    ok = fcrc == expfold.to(device=stack.device,
                                            dtype=torch.int64)
            else:
                rcrc = crc32c_sets([rows]).reshape(B, E)
                ok = torch.ones((B,), dtype=torch.bool, device=stack.device)
            return rebuilt, rcrc, ok
    return fused


# -- host-side CRC helpers -----------------------------------------------------

@functools.lru_cache(maxsize=64)
def _host_encoder_handle(matrix_bytes: bytes, k: int, m: int):
    """Process-wide native RS encoder per coding matrix (the same
    sharing rule as the fused-program cache). Handles live for the
    process — ec_destroy never runs, matching the program caches."""
    try:
        from .. import native
        h = native.lib().ec_create_with_matrix(k, m, matrix_bytes)
        return h or None
    except Exception:   # noqa: BLE001 — no native lib: device path
        return None


@functools.lru_cache(maxsize=1)
def _native_crc_ready() -> bool:
    try:
        from .. import native
        return native.ready() and native.crc32c_hw()
    except Exception:   # noqa: BLE001 — any native trouble = no mode
        return False


def _host_crc_available(device=None) -> bool:
    """Host-integrity mode: a CPU backend with the native SSE4.2
    crc32c built checksums (and RS-encodes) host rows in the native
    library, as the twin does on its CPU backend. `device` is the
    backend's; None means the card (the port's default), and a card
    keeps its CRCs on the card, so the mode is off there. Never builds
    the library (the twin's `ready()` gate)."""
    if device is None or torch.device(device).type != "cpu":
        return False
    return _native_crc_ready()


@functools.lru_cache(maxsize=4096)
def _shift_cols(nbytes: int) -> tuple:
    """Packed GF(2) column constants of the CRC32C shift-by-nbytes
    matrix (cached: the RMW path shifts through the same tail
    distances over and over)."""
    from ..csum.reference import matrix_cols_u32, shift_matrix
    return tuple(int(c) for c in matrix_cols_u32(shift_matrix(nbytes)))


def _crc_shift(reg: int, nbytes: int) -> int:
    """Advance a raw CRC32C register through nbytes zero bytes — the
    O(1) building block of the incremental hinfo update (CRC32C is
    GF(2)-linear in the message AND the seed, so
    crc(new_row) = shift^{tail}(crc(old_row)) ^ shift^{tail'}(crc0(delta)))."""
    if nbytes == 0 or reg == 0:
        return int(reg)
    cols = _shift_cols(int(nbytes))
    out = 0
    for b in range(32):
        if (reg >> b) & 1:
            out ^= cols[b]
    return out


def _rows_crc0(rows: np.ndarray, device) -> np.ndarray:
    """(N, L) byte rows -> (N,) ZERO-seed crc32c on `device` (the
    delta-row convention: a zero seed composes under XOR and position
    shifts)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    if _host_crc_available(device):
        from .. import native
        return np.asarray(native.native_crc32c_rows(0, rows),
                          dtype=np.uint32)
    return _u32(run_bucketed(lambda b: crc32c_blocks(b, init=0, xorout=0),
                             to_device(rows, resolve_device(device))))


def _rows_crc32c(rows: np.ndarray, device) -> np.ndarray:
    """(B, L) byte rows -> (B,) raw crc32c (seed -1, the HashInfo
    convention) on `device` (native SSE4.2 in the host mode)."""
    if _host_crc_available(device):
        from .. import native
        return native.native_crc32c_rows(
            0xFFFFFFFF, np.ascontiguousarray(rows, dtype=np.uint8))
    return PGBackend._batched_crcs(rows, resolve_device(device))


def readv_ranges_host(store, cid: str, names: list[str], length: int,
                      ranges, attr_key: str | None, device=None
                      ) -> tuple[np.ndarray, np.ndarray | None,
                                 list[int]]:
    """Serve a ranged shard pull from a LOCAL store — the source half
    of the sub-chunk read (ref: ErasureCodeClay's minimum_to_decode
    sub-chunk ranges riding the ECSubRead).

    Per object: verify the FULL stored row against its hinfo when
    `attr_key` is given (rot detection stays at the source — the
    receiver never sees the whole row, so the whole-row fold can't
    cover it), slice the planned `ranges`, and crc32c the shipped
    bytes (range-level integrity the receiver's fold verify consumes;
    CRC32C is GF(2)-linear at any row length, so H range rows still
    verify with ONE fold CRC). The CRCs run on `device` (None: the
    CUDA device).

    Returns (rows (B, rl) uint8, range CRCs (B,) uint32 | None,
    indices of rows whose FULL shard failed its hinfo — their range
    bytes ship anyway and the receiver plans around them)."""
    ranges = [(int(o), int(ln)) for o, ln in ranges]
    rl = sum(ln for _o, ln in ranges)
    B = len(names)
    rows = np.empty((B, rl), dtype=np.uint8)
    bad: list[int] = []
    if attr_key is not None:
        full = np.empty((B, length), dtype=np.uint8)
        for i, name in enumerate(names):
            arr = store.read(cid, name)
            if len(arr) != length:
                # a stale/partial shard must fail LOUDLY — zero-
                # filling would hand the decoder garbage
                raise ValueError(
                    f"readv_ranges: {name!r} is {len(arr)} bytes, "
                    f"expected {length}")
            full[i] = arr
        crcs = _rows_crc32c(full, device)
        for i, name in enumerate(names):
            hinfo = HashInfo.from_bytes(
                store.getattr(cid, name, attr_key))
            if int(crcs[i]) != hinfo.get_chunk_hash(0):
                bad.append(i)
        at = 0
        for off, ln in ranges:
            rows[:, at:at + ln] = full[:, off:off + ln]
            at += ln
        return rows, _rows_crc32c(rows, device), bad
    for i, name in enumerate(names):
        at = 0
        for off, ln in ranges:
            got = store.read(cid, name, off, ln)
            if len(got) != ln:
                raise ValueError(
                    f"readv_ranges: {name!r} range ({off},{ln}) "
                    f"returned {len(got)} bytes")
            rows[i, at:at + ln] = got
            at += ln
    return rows, None, bad


class ECBackend(PGBackend):
    """One PG's EC backend over a set of per-OSD stores, with its
    encode, decode and CRC work on `device` (None: the CUDA device)."""

    def __init__(self, profile: dict | str, pg: str, acting: list[int],
                 cluster: ShardSet | None = None,
                 chunk_size: int | None = None,
                 perf=None, ensure_collections: bool = True,
                 device=None):
        self.perf = perf if perf is not None else ec_perf_counters()
        self.coder: ErasureCode = factory(profile,
                                          device=resolve_device(device))
        self.device = self.coder.device
        self.k = self.coder.get_data_chunk_count()
        self.m = self.coder.get_coding_chunk_count()
        self.min_live = self.k  # EC pool min_size gate
        if len(acting) != self.k + self.m:
            raise ValueError(
                f"acting set size {len(acting)} != k+m={self.k + self.m}")
        # shard slot s holds the coder's chunk id s; mapping[j] names
        # the slot carrying DENSE row j (k data rows then m parity)
        self.chunk_mapping = [int(p) for p in
                              self.coder.get_chunk_mapping()]
        if sorted(self.chunk_mapping) != list(range(self.k + self.m)):
            raise ValueError(
                f"chunk mapping {self.chunk_mapping} is not a "
                f"permutation of 0..{self.k + self.m - 1}")
        self.data_slots = self.chunk_mapping[:self.k]
        self._perm = np.asarray(self.chunk_mapping)
        self._identity_mapping = \
            self.chunk_mapping == list(range(self.k + self.m))
        # pool-wide stripe geometry, rounded through the coder's rule
        requested = chunk_size or self.coder.get_chunk_size(0) or 4096
        cs = self.coder.get_chunk_size(requested * self.k)
        self.sinfo = StripeInfo(self.k, cs)
        self._init_common(pg, acting, cluster or ShardSet(),
                          ensure_collections=ensure_collections)
        self._fused_cache: dict = {}
        # partial-stripe RMW state: per-PG stripe-journal sequence and
        # the crash hook the phase-boundary tests drive (None in prod)
        self._rmw_seq = 0
        self._rmw_crash_hook = None
        self.eio_stats = {"read_eio": 0, "repaired": 0}

    # -- helpers ------------------------------------------------------------

    def _shard_len(self, object_size: int) -> int:
        return self.sinfo.object_size_to_shard_size(object_size)

    def _slots_from_dense(self, dense: np.ndarray) -> np.ndarray:
        """(B, n, L) dense rows (k data then m parity, encode order)
        -> per-slot rows: slot chunk_mapping[j] carries dense row j."""
        if self._identity_mapping:
            return dense
        out = np.empty_like(dense)
        out[:, self._perm] = dense
        return out

    _expected_shard_len = _shard_len  # shallow-scrub size rule

    def _encode_shards_with_crcs(self, data_shards: np.ndarray,
                                 sl: int) -> tuple[np.ndarray,
                                                   np.ndarray]:
        """(B, k, sl) data rows -> (slot-ordered (B, n, sl) shards,
        slot-ordered (B, n) uint32 hinfo CRCs). For RS the encode and
        both CRC sets run as ONE fused, B-bucketed program on the
        device with one fetch, or in the native library on a CPU
        backend in the host mode (the twin's; same bytes); other coders
        take the generic path."""
        B = data_shards.shape[0]
        if isinstance(self.coder, ReedSolomon) \
                and _host_crc_available(self.device):
            mat = np.ascontiguousarray(self.coder.matrix, dtype=np.uint8)
            handle = _host_encoder_handle(mat.tobytes(), self.k, self.m)
            if handle is not None:
                from .. import native as _native
                import ctypes as _ctypes
                self.perf.inc_many(
                    (("host_encode_launches", 1),
                     ("encode_bytes", int(data_shards.size))))
                with span("ecbackend.write.encode",
                          counters=self.perf, key="encode_time"):
                    data_c = np.ascontiguousarray(data_shards)
                    parity = np.zeros((B, self.m, sl), np.uint8)
                    rc = _native.lib().ec_encode(
                        handle,
                        data_c.ctypes.data_as(_ctypes.c_char_p),
                        parity.ctypes.data_as(_ctypes.c_char_p),
                        sl, B)
                    if rc == 0:
                        dense = np.concatenate([data_shards, parity],
                                               axis=1)
                        dense_crcs = _native.native_crc32c_rows(
                            0xFFFFFFFF,
                            np.ascontiguousarray(dense).reshape(
                                B * self.n, sl)).reshape(B, self.n)
                        shards = self._slots_from_dense(dense)
                        if self._identity_mapping:
                            return shards, dense_crcs
                        crcs = np.empty_like(dense_crcs)
                        crcs[:, self._perm] = dense_crcs
                        return shards, crcs
                # rc != 0: the fused program below, as in the twin
        if isinstance(self.coder, ReedSolomon):
            bucket = pow2_bucket(B)
            mat = np.ascontiguousarray(self.coder.matrix, dtype=np.uint8)
            ci0 = _fused_write_fn.cache_info()
            fn = _fused_write_fn(mat.tobytes(), self.m, self.k,
                                 self.coder.impl, sl, bucket, self.device)
            ci1 = _fused_write_fn.cache_info()
            self.perf.inc_many(
                (("fused_write_launches", 1),
                 ("encode_bytes", int(data_shards.size)),
                 ("program_cache_hits", ci1.hits - ci0.hits),
                 ("program_cache_misses", ci1.misses - ci0.misses)))
            with span("ecbackend.write.encode", counters=self.perf,
                      key="encode_time"):
                parity_d, crcs_d = fn(_upload_padded(data_shards, bucket,
                                                     self.device))
                parity = parity_d[:B].cpu().numpy()
                dense_crcs = _u32(crcs_d[:B])
            dense = np.concatenate([data_shards, parity], axis=1)
            shards = self._slots_from_dense(dense)
            if self._identity_mapping:
                return shards, dense_crcs
            crcs = np.empty_like(dense_crcs)
            crcs[:, self._perm] = dense_crcs
            return shards, crcs
        self.perf.inc_many((("encode_launches", 1),
                            ("encode_bytes", int(data_shards.size))))
        with span("ecbackend.write.encode", counters=self.perf,
                  key="encode_time"):
            parity = host_array(self.coder.encode_chunks(data_shards))
        shards = self._slots_from_dense(
            np.concatenate([data_shards, parity], axis=1))
        crcs = self._batched_hinfo_crcs(
            shards.reshape(-1, sl)).reshape(B, self.n)
        return shards, crcs

    def _write_empty(self, name: str, live: list[int] | None = None) -> None:
        hinfo = HashInfo(1, 0, [0xFFFFFFFF])
        self.object_sizes[name] = 0
        live = live if live is not None else list(range(self.n))
        for shard in live:
            t = (Transaction()
                 .write(shard_cid(self.pg, shard), name, 0, b"")
                 .truncate(shard_cid(self.pg, shard), name, 0)
                 .setattr(shard_cid(self.pg, shard), name,
                          HINFO_KEY, hinfo.to_bytes()))
            self._store(shard).queue_transaction(t)
        self._log_write(name, live)

    # -- write path (full-object) -------------------------------------------

    def write_objects(self, objects: dict[str, bytes | np.ndarray],
                      dead_osds: set[int] | None = None,
                      shard_txn_extra=None) -> None:
        """Full-object writes, batched: encode every equal-length group
        in one fused launch, then one combined transaction per live
        shard (ECTransaction::generate_transactions). Shards on dead
        OSDs are skipped and fall behind in the PG log.
        shard_txn_extra: optional factory, called once per fan-out wave
        with the wave's names AFTER the PG log reflects them; returns
        fn(shard, txn) that appends extra ops to each shard's txn."""
        live = self._live_slots(dead_osds)
        self._check_min_size(live)
        by_len: dict[int, list[tuple[str, np.ndarray]]] = {}
        for name, data in objects.items():
            arr = as_flat_u8(data)
            by_len.setdefault(len(arr), []).append((name, arr))
        for olen, group in by_len.items():
            if olen == 0:
                for name, _ in group:
                    self._write_empty(name, live)
                if shard_txn_extra is not None:
                    add = shard_txn_extra([n for n, _ in group])
                    txns = []
                    for shard in live:
                        t = Transaction()
                        add(shard, t)
                        txns.append((shard, t))
                    self._fanout_txns(txns)
                continue
            batch = np.stack([a for _, a in group])
            sl = self._shard_len(olen)
            data_shards = self.sinfo.object_to_shards(batch)  # (B, k, sl)
            shards, crcs = self._encode_shards_with_crcs(data_shards,
                                                         sl)
            for name, _ in group:
                self.object_sizes[name] = olen
            add = None
            if shard_txn_extra is not None:
                for name, _ in group:
                    self._log_write(name, live)
                add = shard_txn_extra([n for n, _ in group])
            txns = []
            for shard in live:
                cid = shard_cid(self.pg, shard)
                t = Transaction()
                for bi, (name, arr) in enumerate(group):
                    hinfo = HashInfo(1, sl, [int(crcs[bi, shard])])
                    # truncate clears any stale tail from a previous,
                    # larger version of the object
                    t.write(cid, name, 0, shards[bi, shard, :]) \
                     .truncate(cid, name, sl) \
                     .setattr(cid, name, HINFO_KEY, hinfo.to_bytes())
                if add is not None:
                    add(shard, t)
                txns.append((shard, t))
            self.perf.inc("write_wire_bytes", len(group) * len(live) * sl)
            self._fanout_txns(txns)
            if shard_txn_extra is None:
                for name, _ in group:
                    self._log_write(name, live)

    # -- write path (RMW partial-stripe) -------------------------------------

    def _read_data_window(self, names: list[str], c0: int, clen: int,
                          dead: set[int],
                          old_slens: list[int]) -> np.ndarray:
        """Pre-image data-shard window (B, k, clen) for the RMW read
        phase, reconstructing down data shards from survivors (the
        degraded-write case). Reads past a shard's end zero-fill, which
        matches the zero-padding layout rule. old_slens: each object's
        current shard length (vector codes decode at the OLD length)."""
        B = len(names)
        avail = self._fresh_for(
            names, [s for s in range(self.n) if self.acting[s] not in dead])
        lost_data = [s for s in self.data_slots if s not in avail]

        def read_window(s: int, nm: str, off: int, ln: int) -> np.ndarray:
            buf = np.zeros(ln, dtype=np.uint8)
            st = self._store(s)
            cid = shard_cid(self.pg, s)
            if st.exists(cid, nm):
                got = st.read(cid, nm, off, ln)
                buf[:len(got)] = got
            return buf

        # window rows are DENSE data order (row j <-> slot data_slots[j])
        dense_of = {s: j for j, s in enumerate(self.data_slots)}
        window = np.zeros((B, self.k, clen), dtype=np.uint8)
        for j, s in enumerate(self.data_slots):
            if s in lost_data:
                continue
            for bi, nm in enumerate(names):
                window[bi, j] = read_window(s, nm, c0, clen)
        if not lost_data:
            return window
        helpers = sorted(self.coder.minimum_to_decode(lost_data, avail))
        if getattr(self.coder, "positionwise", True):
            # surviving data helpers are already in `window`; only read
            # parity helpers from the stores
            stacks = {s: window[:, dense_of[s]] if s in dense_of else
                      np.stack([read_window(s, nm, c0, clen)
                                for nm in names])
                      for s in helpers}
            rec = self.coder.decode_chunks(lost_data, stacks)
            for s in lost_data:
                window[:, dense_of[s]] = host_array(rec[s])
        else:
            # decode whole chunks at each object's OLD shard length
            by_old: dict[int, list[int]] = {}
            for bi, sl in enumerate(old_slens):
                if sl:
                    by_old.setdefault(sl, []).append(bi)
            for sl, idxs in by_old.items():
                stacks = {s: np.stack([read_window(s, names[bi], 0, sl)
                                       for bi in idxs])
                          for s in helpers}
                rec = self.coder.decode_chunks(lost_data, stacks)
                ln = min(sl, clen)
                for s in lost_data:
                    window[idxs, dense_of[s], :ln] = \
                        host_array(rec[s])[:, :ln]
        return window

    def write_ranges(self, ops: list[tuple[str, int, bytes | np.ndarray]],
                     dead_osds: set[int] | None = None) -> None:
        """Batched RMW dispatcher: every (name, offset, bytes) op goes
        to the PARITY-DELTA fast path when the stripe is clean (all
        shards live + caught up, write within one stripe, touched data
        columns < k), crash-consistent through the per-PG stripe
        journal, and ladders to the full-stripe RMW otherwise."""
        dead = dead_osds or set()
        delta_jobs, full_ops = self._partition_rmw(ops, dead)
        if delta_jobs:
            self._write_ranges_delta(delta_jobs)
        if full_ops:
            self.perf.inc("rmw_full_fallbacks",
                          len({n for n, _o, _d in full_ops}))
            self._write_ranges_full(full_ops, dead_osds)

    def _write_ranges_full(self,
                           ops: list[tuple[str, int, bytes | np.ndarray]],
                           dead_osds: set[int] | None = None) -> None:
        """Full-stripe RMW: read the touched stripe window, overlay,
        re-encode, and emit per-shard sub-range writes + hinfo
        updates, batched across objects whose windows have equal chunk
        length. Handles every case the delta path refuses."""
        dead = dead_osds or set()
        k, si = self.k, self.sinfo
        live = [s for s in range(self.n) if self.acting[s] not in dead]
        self._check_min_size(live)

        # merge ops per object into one covering window
        per_obj: dict[str, list[tuple[int, np.ndarray]]] = {}
        for name, offset, data in ops:
            if offset < 0:
                raise ValueError(f"negative offset {offset}")
            per_obj.setdefault(name, []).append(
                (int(offset), as_flat_u8(data)))

        jobs = []  # (name, writes, old_slen, new_size, s0, clen)
        for name, writes in per_obj.items():
            old_size = self.object_sizes.get(name, 0)
            writes = [(off, a) for off, a in writes if len(a)]
            if not writes:
                # zero-length writes don't extend; just ensure existence
                if name not in self.object_sizes:
                    self._write_empty(name, live)
                continue
            hi = max(off + len(a) for off, a in writes)
            new_size = max(old_size, hi)
            lo = min(off for off, a in writes)
            if not getattr(self.coder, "positionwise", True):
                lo, hi = 0, new_size     # whole-object RMW
            s0, slen = si.offset_len_to_stripe_bounds(lo, hi - lo)
            jobs.append((name, writes, self._shard_len(old_size),
                         new_size, s0, slen // k))

        by_clen: dict[int, list[tuple]] = {}
        for job in jobs:
            by_clen.setdefault(job[-1], []).append(job)

        for clen, group in by_clen.items():
            names = [j[0] for j in group]
            old_slens = [j[2] for j in group]
            c0s = {j[4] // k for j in group}
            if len(c0s) == 1:
                window = self._read_data_window(names, c0s.pop(), clen,
                                                dead, old_slens)
            else:
                window = np.stack([
                    self._read_data_window([j[0]], j[4] // k, clen, dead,
                                           [j[2]])[0]
                    for j in group])
            # overlay new bytes in logical space
            logical = si.shards_to_object(window)  # (B, slen)
            for bi, (name, writes, _, _, s0, _) in enumerate(group):
                for off, arr in writes:
                    logical[bi, off - s0:off - s0 + len(arr)] = arr
            dshards = si.object_to_shards(logical)       # (B, k, clen)
            parity = host_array(self.coder.encode_chunks(dshards))
            shards = self._slots_from_dense(
                np.concatenate([dshards, parity], axis=1))  # (B, n, clen)

            # sub-range writes + full-shard hinfo on the LIVE shards
            # only, the CRCs batched per equal shard length
            new_full: dict[int, list[np.ndarray]] = {}
            slots: dict[int, list[tuple[int, int]]] = {}
            for bi, (name, writes, _, new_size, s0, _) in enumerate(group):
                nsl = self._shard_len(new_size)
                c0 = s0 // k
                for s in live:
                    st = self._store(s)
                    cid = shard_cid(self.pg, s)
                    old = st.read(cid, name) if st.exists(cid, name) \
                        else np.zeros(0, dtype=np.uint8)
                    full = np.zeros(nsl, dtype=np.uint8)
                    full[:min(len(old), nsl)] = old[:nsl]
                    full[c0:c0 + clen] = shards[bi, s]
                    new_full.setdefault(nsl, []).append(full)
                    slots.setdefault(nsl, []).append((bi, s))
            crc_of: dict[tuple[int, int], int] = {}
            for nsl, fulls in new_full.items():
                crcs = self._batched_hinfo_crcs(np.stack(fulls))
                for (bi, s), c in zip(slots[nsl], crcs):
                    crc_of[(bi, s)] = int(c)
            shard_txns = {s: Transaction() for s in live}
            for bi, (name, writes, _, new_size, s0, _) in enumerate(group):
                nsl = self._shard_len(new_size)
                c0 = s0 // k
                for s in live:
                    hinfo = HashInfo(1, nsl, [crc_of[(bi, s)]])
                    shard_txns[s].write(shard_cid(self.pg, s), name, c0,
                                        shards[bi, s]) \
                        .setattr(shard_cid(self.pg, s), name,
                                 HINFO_KEY, hinfo.to_bytes())
            self.perf.inc("write_wire_bytes",
                          len(group) * len(live) * clen)
            self._fanout_txns(list(shard_txns.items()))
            for bi, (name, writes, _, new_size, s0, _) in enumerate(group):
                self.object_sizes[name] = new_size
                self._log_write(name, live)

    # -- write path (parity-delta fast path + stripe journal) ----------------
    #
    # The small-overwrite/append data path (ROADMAP item 3; the
    # online-EC measurement arxiv 1709.05365 shows write amplification
    # dominating this workload): delta_j = G[j,i] (x) (new_i ^ old_i)
    # folded into each parity shard, so only the touched data shard(s)
    # plus m parity shards move — not k+m. Crash consistency comes
    # from a per-PG stripe journal (intent logged durably on every
    # participating shard BEFORE any in-place XOR; an applied shard
    # atomically bumps its watermark and drops the entry), replayed by
    # stripe_journal_replay: SIGKILL anywhere leaves the stripe
    # bit-exact with either the old or the new bytes, never torn.

    JOURNAL_OBJ = "__stripe_journal__"
    _J_APPLIED = b"applied"

    @staticmethod
    def _jkey(seq: int) -> bytes:
        return b"e%016x" % seq

    @staticmethod
    def _encode_jentry(seq: int, name: str, slot: int,
                       participants, new_size: int, osl: int, nsl: int,
                       a: int, delta: bytes, new_crc: int,
                       version: int) -> bytes:
        from ..utils.encoding import Encoder
        e = Encoder()
        e.u32(1)                        # entry codec version
        e.u64(seq).string(name).u32(slot)
        e.list([int(p) for p in participants], Encoder.u32)
        e.u64(new_size).u64(osl).u64(nsl)
        e.u64(a).blob(delta)
        e.u32(new_crc)
        e.u64(version)                  # the PG-log version this RMW
        #                                 creates: replay drops entries
        #                                 a later write superseded
        return e.bytes()

    @staticmethod
    def _decode_jentry(raw: bytes) -> dict:
        from ..utils.encoding import Decoder
        d = Decoder(raw)
        v = d.u32()
        if v != 1:
            raise ValueError(f"stripe-journal entry version {v}")
        return {"seq": d.u64(), "name": d.string(), "slot": d.u32(),
                "participants": d.list(Decoder.u32),
                "new_size": d.u64(), "osl": d.u64(), "nsl": d.u64(),
                "a": d.u64(), "delta": d.blob(), "new_crc": d.u32(),
                "version": d.u64()}

    def _partition_rmw(self, ops, dead: set[int]):
        """Split a write_ranges op list into delta-eligible jobs and
        the ops the full path must carry. One job per object (ops
        merged); a job is delta-eligible when the stripe is CLEAN
        (every slot live and caught up — a delta against a stale or
        reconstructed pre-image would fold garbage into parity, so
        degraded stripes refuse and ladder down), the object exists,
        the merged writes don't overlap or span a full stripe, fewer
        than k data columns are touched, and (vector codes) the shard
        length doesn't change under the sub-chunk geometry."""
        k, si = self.k, self.sinfo
        per_obj: dict[str, list[tuple[int, np.ndarray]]] = {}
        order: list[str] = []
        raw: dict[str, list[tuple]] = {}
        for name, offset, data in ops:
            if offset < 0:
                raise ValueError(f"negative offset {offset}")
            if name not in per_obj:
                order.append(name)
            per_obj.setdefault(name, []).append(
                (int(offset), as_flat_u8(data)))
            raw.setdefault(name, []).append((name, offset, data))
        all_live = len(self._live_slots(dead)) == self.n
        jobs, full_ops = [], []
        for name in order:
            writes = [(o, a) for o, a in per_obj[name] if len(a)]
            old_size = self.object_sizes.get(name, 0)
            job = None
            if writes and all_live and old_size > 0:
                job = self._delta_job(name, writes, old_size)
            if job is not None \
                    and len(self._fresh_for([name],
                                            list(range(self.n)))) \
                    == self.n:
                jobs.append(job)
            else:
                full_ops.extend(raw[name])
        return jobs, full_ops

    def _delta_job(self, name: str, writes, old_size: int):
        """Geometry of one delta-eligible overwrite, or None. A job is
        (name, writes, old_size, new_size, osl, nsl, touched, spans,
        a, b): `spans` are per-write (col, chunk_off, len, log_off)
        chunk sub-ranges, (a, b) the common shard-offset window the
        delta rows are positioned in."""
        si, k = self.sinfo, self.k
        sw = si.stripe_width
        lo = min(o for o, _a in writes)
        hi = max(o + len(a) for o, a in writes)
        if hi - lo >= sw or lo >= old_size + sw:
            return None     # stripe-spanning, or a hole of untouched
        #                     stripes past the tail: full path
        # overlap check: delta composition is XOR — overlapping writes
        # in one wave would double-fold
        ivs = sorted((o, o + len(a)) for o, a in writes)
        for (s1, e1), (s2, _e2) in zip(ivs, ivs[1:]):
            if s2 < e1:
                return None
        new_size = max(old_size, hi)
        osl = self._shard_len(old_size)
        nsl = self._shard_len(new_size)
        spans = []
        touched: set[int] = set()
        for off, arr in writes:
            at = off
            end = off + len(arr)
            while at < end:
                stripe, rem = divmod(at, sw)
                col = rem // si.chunk_size
                in_chunk = rem % si.chunk_size
                ln = min(end - at, si.chunk_size - in_chunk)
                spans.append((col, stripe * si.chunk_size + in_chunk,
                              ln, at))
                touched.add(col)
                at += ln
        if len(touched) >= k:
            return None     # every data shard moves anyway
        if not getattr(self.coder, "positionwise", True):
            if nsl != osl:
                return None     # sub-chunk geometry changes with
            #                     length: ladder to full re-encode
            a, b = 0, osl       # byte positions couple: the delta
            #                     window is the whole chunk
        else:
            a = min(c0 for _col, c0, _ln, _lo in spans)
            b = max(c0 + ln for _col, c0, ln, _lo in spans)
        return (name, writes, old_size, new_size, osl, nsl,
                tuple(sorted(touched)), spans, a, b)

    def _delta_parity_crcs(self, touched: tuple, deltas: np.ndarray
                           ) -> tuple[np.ndarray, np.ndarray]:
        """(B, t, wl) data deltas -> ((B, m, wl) parity deltas,
        (B, t+m) uint32 zero-seed CRCs of data+parity delta rows).
        Static-matrix coders take the native host codec (a CPU
        backend in the host mode) or the fused delta program on the
        device; the rest go through parity_delta's generic XOR-linear
        encode."""
        B, t, wl = deltas.shape
        D = self.coder.delta_matrix(touched)
        if D is not None and _host_crc_available(self.device):
            handle = _host_encoder_handle(
                np.ascontiguousarray(D, np.uint8).tobytes(), t, self.m)
            if handle is not None:
                from .. import native as _native
                import ctypes as _ctypes
                data_c = np.ascontiguousarray(deltas)
                parity = np.zeros((B, self.m, wl), np.uint8)
                rc = _native.lib().ec_encode(
                    handle,
                    data_c.ctypes.data_as(_ctypes.c_char_p),
                    parity.ctypes.data_as(_ctypes.c_char_p), wl, B)
                if rc == 0:
                    self.perf.inc("rmw_delta_launches")
                    rows = np.concatenate([deltas, parity], axis=1)
                    crcs = _native.native_crc32c_rows(
                        0, np.ascontiguousarray(rows).reshape(
                            B * (t + self.m), wl)).reshape(
                                B, t + self.m)
                    return parity, crcs
        if D is not None:
            bucket = pow2_bucket(B)
            ci0 = _fused_delta_fn.cache_info()
            fn = _fused_delta_fn(
                np.ascontiguousarray(D, np.uint8).tobytes(), self.m,
                t, getattr(self.coder, "impl", None) or "mxu", wl,
                bucket, self.device)
            ci1 = _fused_delta_fn.cache_info()
            self.perf.inc_many(
                (("rmw_delta_launches", 1),
                 ("program_cache_hits", ci1.hits - ci0.hits),
                 ("program_cache_misses", ci1.misses - ci0.misses)))
            parity_d, crcs_d = fn(_upload_padded(deltas, bucket,
                                                 self.device))
            return parity_d[:B].cpu().numpy(), _u32(crcs_d[:B])
        self.perf.inc("rmw_delta_launches")
        parity = host_array(self.coder.parity_delta(touched, deltas))
        rows = np.concatenate([deltas, parity], axis=1)
        crcs = _rows_crc0(rows.reshape(B * (t + self.m), wl),
                          self.device).reshape(B, t + self.m)
        return parity, crcs

    def _shard_old_crcs(self, name: str, slots) -> dict[int, int] | None:
        """Current hinfo CRC per slot, or None when any slot's stored
        hinfo is absent/odd (the delta path then refuses the job —
        an incremental update against a wrong base would stamp a
        corrupt CRC that verifies forever)."""
        osl = self._shard_len(self.object_sizes[name])
        out: dict[int, int] = {}
        for s in slots:
            st = self._store(s)
            cid = shard_cid(self.pg, s)
            try:
                hinfo = HashInfo.from_bytes(st.getattr(cid, name,
                                                       HINFO_KEY))
            except KeyError:
                return None
            if hinfo.total_chunk_size != osl:
                return None
            out[s] = hinfo.get_chunk_hash(0)
        return out

    def _rmw_participants(self, touched: tuple, osl: int,
                          nsl: int) -> list[int]:
        """Participant shard slots of one delta job: the touched data
        columns + every parity slot; growth (nsl != osl) adds the
        rest with payload-free entries (zero-extension + hinfo
        shift). ONE derivation shared by the prepare fetch and the
        commit fan-out so the two cannot drift."""
        parts = ([self.data_slots[c] for c in touched]
                 + [self.chunk_mapping[self.k + j]
                    for j in range(self.m)])
        if nsl != osl:
            parts = parts + [s for s in range(self.n)
                             if s not in set(parts)]
        return parts

    def _rmw_prefetch(self, touched: tuple, group):
        """One pipelined wave of combined (hinfo attr + pre-image
        sub-range) fetches for a whole delta group — r16's prepare
        phase paid 1+m tiny sequential getattrs plus one read RTT per
        touched span per job; this pays ONE overlapped frame per
        participant shard for the group (RemoteStore.rmw_fetch_submit;
        in-process stores take the direct path, same accounting).

        Returns (old_crcs, prereads) aligned with `group`:
        old_crcs[i] = {slot: stored hinfo crc} or None when any
        participant's hinfo refuses the incremental base (the job
        then reroutes through the full path, exactly like
        _shard_old_crcs); prereads[i] = {(slot, off, len): bytes}
        for every touched sub-range below the old tail."""
        per_slot: dict[int, list[tuple[str, list]]] = {}
        parts_of: list[list[int]] = []
        ranges_of: list[dict[int, list]] = []
        for job in group:
            name, _w, old_size, _ns, osl, nsl, _t, spans, _a, _b = job
            parts = self._rmw_participants(touched, osl, nsl)
            parts_of.append(parts)
            need: dict[int, list] = {}
            for col, c0, ln, lo in spans:
                if lo < old_size:
                    need.setdefault(self.data_slots[col],
                                    []).append((c0, ln))
            ranges_of.append(need)
            for s in parts:
                per_slot.setdefault(s, []).append(
                    (name, need.get(s, [])))
        handles: list[tuple[int, object]] = []
        results: dict[int, list] = {}
        for s, items in sorted(per_slot.items()):
            st = self._store(s)
            cid = shard_cid(self.pg, s)
            sub = getattr(st, "rmw_fetch_submit", None)
            if sub is not None:
                handles.append((s, sub(cid, HINFO_KEY, items)))
                continue
            out = []
            for name, ranges in items:
                try:
                    attr, ok = st.getattr(cid, name, HINFO_KEY), True
                except KeyError:
                    attr, ok = b"", False
                out.append((ok, attr,
                            [np.asarray(st.read(cid, name, off, ln),
                                        np.uint8).tobytes()
                             for off, ln in ranges]))
            results[s] = out
        for s, h in handles:
            results[s] = h.result()
        self.perf.inc_many((("rmw_fetch_waves", 1),
                            ("rmw_fetch_frames", len(per_slot))))
        cursor = {s: 0 for s in per_slot}
        old_crcs: list[dict | None] = []
        prereads: list[dict] = []
        for ji, job in enumerate(group):
            osl = job[4]
            crcs: dict[int, int] | None = {}
            pre: dict = {}
            for s in parts_of[ji]:
                ok, attr, rows = results[s][cursor[s]]
                cursor[s] += 1
                if crcs is not None:
                    hinfo = None
                    if ok:
                        try:
                            hinfo = HashInfo.from_bytes(attr)
                        except Exception:   # noqa: BLE001 — odd
                            hinfo = None    # stored attr: refuse
                    if hinfo is None or hinfo.total_chunk_size != osl:
                        crcs = None
                    else:
                        crcs[s] = hinfo.get_chunk_hash(0)
                for (off, ln), blob in zip(ranges_of[ji].get(s, []),
                                           rows):
                    pre[(s, off, ln)] = np.frombuffer(blob, np.uint8)
            old_crcs.append(crcs)
            prereads.append(pre)
        return old_crcs, prereads

    def _write_ranges_delta(self, jobs) -> None:
        """Execute delta-eligible RMW jobs: build the delta rows
        (reading only the touched sub-ranges' pre-image — none at all
        for appends into padding), one fused delta-encode launch per
        (touched-columns, window) group, then the journaled two-phase
        shard update. Jobs whose stored hinfo refuses the incremental
        update reroute through the full path."""
        by_shape: dict[tuple, list] = {}
        for job in jobs:
            _n, _w, _os, _ns, _osl, _nsl, touched, _sp, a, b = job
            by_shape.setdefault((touched, b - a), []).append(job)
        for (touched, wl), group in by_shape.items():
            self._delta_group(touched, wl, group)

    def _delta_group(self, touched: tuple, wl: int, group) -> None:
        t = len(touched)
        col_of = {c: i for i, c in enumerate(touched)}
        parity_slots = [self.chunk_mapping[self.k + j]
                        for j in range(self.m)]
        B = len(group)
        deltas = np.zeros((B, t, wl), np.uint8)
        append_fast = 0
        preread = 0
        # r17: ONE overlapped prepare-fetch wave for the whole group —
        # hinfo attrs (the incremental-update base _delta_commit
        # verifies) and pre-image sub-ranges arrive together, one
        # frame per participant shard instead of 1+m sequential
        # getattrs + a read RTT per span per job
        old_crcs, prereads = self._rmw_prefetch(touched, group)
        for bi, job in enumerate(group):
            name, writes, old_size, _ns, osl, _nsl, _t, spans, a, _b \
                = job
            pure_append = all(lo >= old_size
                              for _c, _c0, _ln, lo in spans)
            for col, c0, ln, lo in spans:
                off, arr = next((o, w) for o, w in writes
                                if o <= lo and lo + ln <= o + len(w))
                newb = arr[lo - off:lo - off + ln]
                row = deltas[bi, col_of[col]]
                if lo >= old_size:
                    # append into padding: the pre-image is zeros by
                    # the layout rule — no read phase
                    row[c0 - a:c0 - a + ln] = newb
                    continue
                got = prereads[bi][(self.data_slots[col], c0, ln)]
                oldb = np.zeros(ln, np.uint8)
                oldb[:len(got)] = got
                preread += ln
                row[c0 - a:c0 - a + ln] = np.asarray(newb) ^ oldb
            if pure_append:
                append_fast += 1
        parity, crcs = self._delta_parity_crcs(touched, deltas)
        self.perf.inc_many((("rmw_preread_bytes", preread),
                            ("rmw_append_fast", append_fast)))
        self._delta_commit(touched, wl, group, deltas, parity, crcs,
                           parity_slots, old_crcs=old_crcs)

    def _delta_commit(self, touched: tuple, wl: int, group,
                      deltas, parity, crcs, parity_slots,
                      old_crcs: list | None = None) -> None:
        """The journaled two-phase shard update of one delta batch:
        intent entries (delta payload + new hinfo) durably on every
        participating shard, then the atomic per-shard apply (XOR +
        hinfo + watermark bump + entry drop in ONE transaction).
        `old_crcs` carries the prefetched per-job hinfo bases from
        _rmw_prefetch (None entries reroute through the full path);
        absent, the per-job sync getattr loop serves (bare-backend
        callers)."""
        t = len(touched)
        hook = self._rmw_crash_hook
        # per job: rows per slot, new crcs per slot, participants
        waves = []       # (job, seq, {slot: (row|None, new_crc)})
        wire = 0
        shard_prep: dict[int, Transaction] = {}
        shard_apply: dict[int, Transaction] = {}
        max_seq_of: dict[int, int] = {}
        keys_of: dict[int, list[bytes]] = {}
        for bi, job in enumerate(group):
            name, _w, _os, new_size, osl, nsl, _t, _sp, a, b = job
            # growth touches every shard (zero-extension + hinfo
            # shift) — the others ride payload-free entries
            parts = self._rmw_participants(touched, osl, nsl)
            old = old_crcs[bi] if old_crcs is not None \
                else self._shard_old_crcs(name, parts)
            if old is None:
                # stored hinfo refuses the incremental base: reroute
                # this job through the full path (rare — e.g. a
                # legacy object written before hinfo discipline)
                self.perf.inc("rmw_full_fallbacks")
                self._write_ranges_full(
                    [(name, o, w) for o, w in job[1]], None)
                continue
            self._rmw_seq += 1
            seq = self._rmw_seq
            # the PG-log version this job will create (jobs log in
            # wave order right after the apply fan-out)
            pred_version = self.pg_log.head + len(waves) + 1
            plan: dict[int, tuple] = {}
            for ti, c in enumerate(touched):
                s = self.data_slots[c]
                crc0 = int(crcs[bi, ti])
                plan[s] = (deltas[bi, ti], crc0)
            for j, s in enumerate(parity_slots):
                plan[s] = (parity[bi, j], int(crcs[bi, t + j]))
            for s in parts:
                row, crc0 = plan.get(s, (None, None))
                if crc0 is None:
                    new_crc = _crc_shift(old[s], nsl - osl)
                else:
                    new_crc = (_crc_shift(old[s], nsl - osl)
                               ^ _crc_shift(crc0, nsl - b))
                delta_b = b"" if row is None else row.tobytes()
                entry = self._encode_jentry(
                    seq, name, s, parts, new_size, osl, nsl, a,
                    delta_b, new_crc, pred_version)
                cid = shard_cid(self.pg, s)
                shard_prep.setdefault(s, Transaction()).omap_set(
                    cid, self.JOURNAL_OBJ,
                    {self._jkey(seq): entry})
                at = shard_apply.setdefault(s, Transaction())
                if row is not None:
                    at.xor(cid, name, a, row)
                if nsl != osl:
                    at.truncate(cid, name, nsl)
                at.setattr(cid, name, HINFO_KEY,
                           HashInfo(1, nsl, [new_crc]).to_bytes())
                max_seq_of[s] = max(max_seq_of.get(s, 0), seq)
                keys_of.setdefault(s, []).append(self._jkey(seq))
                wire += len(entry) + len(delta_b)
            waves.append((job, seq, plan, parts))
        if not waves:
            return
        for s, at in shard_apply.items():
            cid = shard_cid(self.pg, s)
            at.omap_set(cid, self.JOURNAL_OBJ,
                        {self._J_APPLIED:
                         _struct.pack("<Q", max_seq_of[s])})
            at.omap_rmkeys(cid, self.JOURNAL_OBJ, keys_of[s])
        try:
            if hook is not None:
                hook("before_prepare")
                # sequential fan-outs under the hook so the crash
                # matrix can land BETWEEN shards (a pipelined wave
                # has no observable mid-point)
                for idx, (s, pt) in enumerate(
                        sorted(shard_prep.items())):
                    self._store(s).queue_transaction(pt)
                    if idx == 0:
                        hook("mid_prepare")
            else:
                self._fanout_txns(list(shard_prep.items()))
            self.perf.inc("journal_entries",
                          sum(len(v) for v in keys_of.values()))
            if hook is not None:
                hook("after_prepare")
                for idx, (s, at) in enumerate(
                        sorted(shard_apply.items())):
                    self._store(s).queue_transaction(at)
                    if idx == 0:
                        hook("mid_apply")
            else:
                self._fanout_txns(list(shard_apply.items()))
            if hook is not None:
                hook("after_apply")
        except (ConnectionError, OSError):
            # a participant died mid-wave: best-effort drop of the
            # wave's intents on every reachable shard (an applied
            # shard holds none — rmkeys no-ops). The caller's
            # degraded retry then rewrites the window through the
            # full path, and the superseded-version guard makes any
            # entry this cleanup missed a replay no-op.
            for s, keys in keys_of.items():
                try:
                    self._store(s).queue_transaction(
                        Transaction().omap_rmkeys(
                            shard_cid(self.pg, s),
                            self.JOURNAL_OBJ, keys))
                except (ConnectionError, OSError, KeyError):
                    pass
            raise
        live = list(range(self.n))
        ios = 0
        for job, _seq, _plan, parts in waves:
            name = job[0]
            self.object_sizes[name] = job[3]
            self._log_write(name, live)
            ios += len(parts)
        self.perf.inc_many((("rmw_ops", len(waves)),
                            ("rmw_shard_ios", ios),
                            ("rmw_wire_bytes", wire)))

    def stripe_journal_replay(self, dead_osds: set[int] | None = None
                              ) -> dict:
        """Replay the per-PG stripe journal after a crash/remount
        (ref: the PGLog-driven divergent-entry resolution, applied to
        RMW intents). Decision per pending seq: roll FORWARD when any
        live participant already applied it (its watermark proves the
        prepare phase completed everywhere) or when every live
        participant still holds the intent (prepare complete, crash
        before any apply — forward and backward are both consistent;
        forward matches the ack the client may have seen); roll BACK
        otherwise (prepare incomplete: applying would tear the
        stripe). Apply is idempotent — an applied shard holds no
        entry and is never re-XORed. Returns {forward, rolled_back,
        entries}."""
        dead = dead_osds or set()
        live = self._live_slots(dead)
        live_set = set(live)
        pending: dict[int, dict[int, dict]] = {}
        watermark: dict[int, int] = {}
        # the existence probe fans out PIPELINED (one overlapped round
        # trip, not n sequential ones — restores run this on every
        # reconcile and most PGs have no journal at all)
        probes: list[tuple[int, object]] = []
        sync_exists: dict[int, bool] = {}
        for s in list(live):
            st = self._store(s)
            cid = shard_cid(self.pg, s)
            sub = getattr(st, "exists_submit", None)
            try:
                if sub is not None:
                    probes.append((s, sub(cid, self.JOURNAL_OBJ)))
                else:
                    sync_exists[s] = st.exists(cid, self.JOURNAL_OBJ)
            except (ConnectionError, OSError, KeyError):
                live_set.discard(s)
        for s, h in probes:
            try:
                sync_exists[s] = bool(h.result()[0])
            except (ConnectionError, OSError, KeyError):
                # an unreachable-but-not-yet-marked shard: scan
                # around it like a dead one (its intents settle on
                # the next restore's replay)
                live_set.discard(s)
        for s in list(live):
            if not sync_exists.get(s, False):
                continue
            st = self._store(s)
            cid = shard_cid(self.pg, s)
            try:
                page = st.omap_iter(cid, self.JOURNAL_OBJ)
            except (ConnectionError, OSError, KeyError):
                live_set.discard(s)
                continue
            for key, val in page:
                if key == self._J_APPLIED:
                    watermark[s] = _struct.unpack("<Q", val)[0]
                elif key.startswith(b"e"):
                    ent = self._decode_jentry(val)
                    pending.setdefault(ent["seq"], {})[s] = ent
        forward = rolled_back = 0
        for seq in sorted(pending):
            holders = pending[seq]
            ent0 = next(iter(holders.values()))
            parts = [p for p in ent0["participants"] if p in live_set]
            applied_any = any(watermark.get(p, -1) >= seq
                              for p in parts)
            all_logged = all(p in holders for p in parts)
            name = ent0["name"]
            # superseded entries (a later write — e.g. the degraded
            # full-path retry of this very RMW — already bumped the
            # object's version) must never re-fold their delta
            roll = (applied_any or all_logged) \
                and name in self.object_sizes \
                and ent0["version"] > self.object_versions.get(name, 0)
            for s, ent in holders.items():
                st = self._store(s)
                cid = shard_cid(self.pg, s)
                txn = Transaction()
                if roll:
                    if ent["delta"]:
                        txn.xor(cid, name, ent["a"], np.frombuffer(
                            ent["delta"], np.uint8))
                    if ent["nsl"] != ent["osl"]:
                        txn.truncate(cid, name, ent["nsl"])
                    txn.setattr(cid, name, HINFO_KEY, HashInfo(
                        1, ent["nsl"], [ent["new_crc"]]).to_bytes())
                    txn.omap_set(cid, self.JOURNAL_OBJ,
                                 {self._J_APPLIED:
                                  _struct.pack("<Q", max(
                                      watermark.get(s, 0), seq))})
                    watermark[s] = max(watermark.get(s, 0), seq)
                txn.omap_rmkeys(cid, self.JOURNAL_OBJ,
                                [self._jkey(seq)])
                st.queue_transaction(txn)
            if roll:
                forward += 1
                self.object_sizes[name] = max(
                    self.object_sizes.get(name, 0), ent0["new_size"])
            else:
                rolled_back += 1
        self._rmw_seq = max([self._rmw_seq] + list(pending)
                            + list(watermark.values()))
        self.perf.inc_many((("journal_replay_forward", forward),
                            ("journal_replay_rollback", rolled_back)))
        return {"forward": forward, "rolled_back": rolled_back,
                "entries": sum(len(h) for h in pending.values())}

    # -- read path -----------------------------------------------------------

    # read_object is inherited; read_objects is the batched
    # objects_read_and_reconstruct analog

    def _decode_host(self, want: list[int], chunks: dict
                     ) -> dict[int, np.ndarray]:
        """coder.decode with host arrays in and out: wanted chunks that
        are present pass through on the host, only the missing ones
        make the trip to the device and back."""
        out = {s: np.asarray(chunks[s]) for s in want if s in chunks}
        missing = [s for s in want if s not in chunks]
        if missing:
            rec = self.coder.decode_chunks(missing, chunks)
            out.update({s: host_array(rec[s]) for s in missing})
        return out

    def read_objects(self, names: list[str],
                     dead_osds: set[int] | None = None,
                     verify: bool = True,
                     repair: bool = True,
                     helper_costs: dict[int, int] | None = None
                     ) -> dict[str, np.ndarray]:
        """Batched reads with BlueStore-style verify-on-read: every
        chunk consumed is CRC-checked against its stored hinfo in one
        batched launch (ref: BlueStore::_verify_csum on every read);
        a mismatch is the EIO path — the read transparently re-decodes
        from other shards AND repairs the rotten chunk in place (ref:
        the read-error recovery qa/standalone/erasure-code/
        test-erasure-eio.sh exercises). repair=False keeps the
        re-decode but skips the writeback — the read-only contract of
        a degraded-read view served by a non-primary.

        Degraded reads gather through the repair-locality planner
        (plan_read): an LRC single-shard loss pulls its local group
        instead of any-k, and `helper_costs` (slot -> cost) biases
        which survivors serve (the daemon's complaint/latency
        memory)."""
        dead = dead_osds or set()
        alive = [s for s in range(self.n)
                 if self.acting[s] not in dead]
        want = list(self.data_slots)
        out: dict[str, np.ndarray] = {}
        # batched like recovery: stack equal-shard-length groups and
        # decode each group in ONE launch
        by_len: dict[int, list[str]] = {}
        for name in names:
            if self.object_sizes[name] == 0:
                out[name] = np.zeros(0, dtype=np.uint8)
                continue
            by_len.setdefault(self._shard_len(self.object_sizes[name]),
                              []).append(name)
        for sl, group in by_len.items():
            # a shard that missed any of this group's writes is stale
            # for it and must not serve (it replays on rejoin)
            avail = self._fresh_for(group, alive)
            while True:
                # the planner raises when the survivors can't cover
                # `want` — the caller's retry boundary
                need_set, family = plan_read(self.coder, want, avail,
                                             costs=helper_costs)
                if family != "direct":
                    self._count_plan(family)
                need = sorted(need_set)
                stacks, missing = {}, None
                for s in need:
                    try:
                        stacks[s] = np.stack(
                            [self._store(s).read(shard_cid(self.pg, s),
                                                 n) for n in group])
                    except KeyError:
                        # cursor says fresh but the store lacks the
                        # object: a repointed slot whose rebuild has
                        # not landed this object yet (recovery in
                        # flight) — plan around it like a stale shard
                        missing = s
                        break
                if missing is None:
                    break
                avail.remove(missing)
            bad: dict[str, set[int]] = {}
            if verify:
                rows = np.concatenate([stacks[s] for s in need])
                crcs = self._batched_hinfo_crcs(rows).reshape(
                    len(need), len(group))
                for si, s in enumerate(need):
                    st = self._store(s)
                    cid = shard_cid(self.pg, s)
                    for bi, nm in enumerate(group):
                        hinfo = HashInfo.from_bytes(
                            st.getattr(cid, nm, HINFO_KEY))
                        if int(crcs[si, bi]) != hinfo.get_chunk_hash(0):
                            bad.setdefault(nm, set()).add(s)
            clean_group = [n for n in group if n not in bad]
            if clean_group:
                idx = [group.index(n) for n in clean_group]
                sub = {s: stacks[s][idx] for s in need}
                self.perf.inc_many(
                    (("decode_launches", 1),
                     ("decode_bytes",
                      len(clean_group) * len(need) * sl)))
                with span("ecbackend.read.decode", counters=self.perf,
                          key="decode_time"):
                    rec = self._decode_host(want, sub)
                shards = np.stack([rec[s] for s in self.data_slots],
                                  axis=1)
                objs = self.sinfo.shards_to_object(shards)
                for oi, name in enumerate(clean_group):
                    out[name] = objs[oi, :self.object_sizes[name]]
            for name, bad_set in bad.items():
                self.eio_stats["read_eio"] += len(bad_set)
                self.perf.inc("read_eio", len(bad_set))
                out[name] = self._read_eio(name, sl, avail, bad_set,
                                           repair=repair)
        return out

    def _read_eio(self, name: str, sl: int, avail: list[int],
                  bad: set[int], repair: bool = True) -> np.ndarray:
        """One object's EIO path: decode around the rotten shards,
        return the bytes, and repair the rot in place.

        Substitute shards are CRC-VERIFIED before they feed the decode:
        an unverified substitute with its own rot would hand the client
        corrupt bytes and then durably launder them — the repair would
        rewrite the flagged shard from corrupt data under a freshly
        matching CRC that no future scrub could catch."""
        want = list(self.data_slots)
        bad = set(bad)
        while True:
            ok_shards = [s for s in avail if s not in bad]
            need = sorted(plan_read(self.coder, want, ok_shards)[0])
            stacks = {}
            newly_bad = False
            for s in need:
                st = self._store(s)
                cid = shard_cid(self.pg, s)
                try:
                    chunk = st.read(cid, name)
                    hinfo = HashInfo.from_bytes(st.getattr(cid, name,
                                                           HINFO_KEY))
                except KeyError:
                    # repointed slot mid-rebuild (no bytes/hinfo yet):
                    # plan around it, exactly like rot
                    bad.add(s)
                    newly_bad = True
                    break
                crc = int(self._batched_hinfo_crcs(chunk[None, :])[0])
                if crc != hinfo.get_chunk_hash(0):
                    self.eio_stats["read_eio"] += 1
                    bad.add(s)
                    newly_bad = True
                    break
                stacks[s] = chunk[None, :]
            if newly_bad:
                continue  # re-plan without the newly found rot
            rec = self._decode_host(want, stacks)
            shards = np.stack([rec[s] for s in self.data_slots], axis=1)
            obj = self.sinfo.shards_to_object(shards)[0]
            if repair:
                self._repair_shards(name, obj, sorted(bad), sl)
            return obj[:self.object_sizes[name]]

    def _repair_shards(self, name: str, logical: np.ndarray,
                       slots: list[int], sl: int) -> None:
        """Rewrite specific shards of one object from its logical bytes
        (the read-error / `ceph pg repair` writeback)."""
        dshards = self.sinfo.object_to_shards(logical[None, :])
        parity = host_array(self.coder.encode_chunks(dshards))
        full = self._slots_from_dense(
            np.concatenate([dshards, parity], axis=1))[0]  # (n, sl)
        crcs = self._batched_hinfo_crcs(full[slots])
        for ci, s in enumerate(slots):
            hinfo = HashInfo(1, sl, [int(crcs[ci])])
            t = (Transaction()
                 .write(shard_cid(self.pg, s), name, 0, full[s])
                 .truncate(shard_cid(self.pg, s), name, sl)
                 .setattr(shard_cid(self.pg, s), name,
                          HINFO_KEY, hinfo.to_bytes()))
            self._store(s).queue_transaction(t)
            self.eio_stats["repaired"] += 1

    def repair_pg(self, dead_osds: set[int] | None = None) -> dict:
        """`ceph pg repair` analog: deep-scrub, then rewrite every
        inconsistent shard from the surviving majority (ref:
        PrimaryLogPG repair path driven by the scrubber's
        authoritative-copy decision)."""
        dead = dead_osds or set()
        rep = self.deep_scrub(dead_osds=dead)
        alive = [s for s in range(self.n)
                 if self.acting[s] not in dead]
        alive_set = set(alive)
        by_name: dict[str, list[int]] = {}
        skipped = 0
        for name, slot in rep["inconsistent"]:
            # never write to a dead slot (repairing it would resurrect
            # a destroyed OSD's store; recovery rebuilds it instead),
            # and a deleted object's leftover is delete-replay's job
            if slot not in alive_set or name not in self.object_sizes:
                skipped += 1
                continue
            by_name.setdefault(name, []).append(slot)
        repaired = 0
        for name, slots in sorted(by_name.items()):
            sl = self._shard_len(self.object_sizes[name])
            obj = self._read_eio(name, sl,
                                 self._fresh_for([name], alive),
                                 set(slots))
            del obj  # _read_eio already repaired in place
            repaired += len(slots)
        return {"checked": rep["checked"], "repaired": repaired,
                "objects": len(by_name), "skipped": skipped,
                "strays_removed": self._remove_strays(dead)}

    # -- recovery (the objects/s metric) -------------------------------------

    def _count_plan(self, family: str) -> None:
        """Fold a planner decision into the declared counters."""
        key = {"lrc_local": "planner_local_plans",
               "clay_planes": "planner_subchunk_plans",
               "shec_cost": "planner_cost_plans",
               "mds": "planner_cost_plans"}.get(family,
                                                "planner_full_plans")
        self.perf.inc(key)

    def plan_recovery(self, lost_shards: list[int],
                      replacement_osds: dict[int, int] | None = None,
                      verify_hinfo: bool = True,
                      names: list[str] | None = None,
                      helper_exclude: set[int] | None = None,
                      helper_costs: dict[int, int] | None = None
                      ) -> "_RecoveryPlan":
        """Open one PG's recovery intent: validate the plan, point the
        lost slots at their replacement OSDs, replay deletes and empty
        objects immediately, and return the rebuild work (names grouped
        by shard length) for a RecoveryRunner to execute — possibly
        FUSED with other PGs' plans into shared decode launches (the
        cross-PG batch formation the per-PG reconcile round lacked).
        Raises ValueError before any mutation when the plan is
        impossible (insufficient live helpers), exactly like the old
        monolithic recover_shards.

        Helper selection goes through the repair-locality planner
        (repairplan.plan_repair): LRC single-loss reads one local
        group, Clay single-loss reads only the repair planes (the
        runner ships sub-chunk ranges), SHEC/RS rank by the optional
        per-helper `helper_costs` (slot -> cost; the daemon feeds its
        complaint memory + peer-latency EWMAs)."""
        lost = sorted(set(lost_shards))
        if len(lost) > self.m:
            raise ValueError(f"{len(lost)} lost shards exceeds m={self.m}")
        excluded = helper_exclude or set()
        full_plan = names is None
        names = sorted(self.object_sizes) if names is None \
            else sorted(set(names))
        provided = set(names)
        # helpers must be caught up for everything being REBUILT — a
        # stale survivor would decode old bytes into the new shard.
        # Validate the plan BEFORE mutating acting, so an impossible
        # recovery (insufficient live helpers) leaves no partial state.
        # A deletes-only replay needs no helper data at all.
        rebuild = [n for n in names if n in self.object_sizes]
        survivors: list[int] = []
        helper: list[int] = []
        repair = None
        if rebuild:
            survivors = self._fresh_for(
                rebuild, [s for s in range(self.n)
                          if s not in lost and s not in excluded])
            repair = plan_repair(self.coder, lost, survivors,
                                 costs=helper_costs)
            helper = sorted(repair.helpers)
            self._count_plan(repair.family)
        repl = replacement_osds or {}
        for s in lost:
            new_osd = repl.get(s, self.acting[s])
            self.acting[s] = new_osd
            t = Transaction().create_collection(shard_cid(self.pg, s))
            self.cluster.osd(new_osd).queue_transaction(t)
        plan = _RecoveryPlan(self, lost, helper, survivors,
                             verify_hinfo, full_plan, provided)
        plan.repair = repair
        # names whose last log entry was a DELETE replay as removals
        names = self._replay_deletes(lost, names)

        for name in names:
            if self.object_sizes[name] == 0:
                hinfo = HashInfo(1, 0, [0xFFFFFFFF])
                for s in lost:
                    # truncate clears a stale pre-failure chunk (the
                    # object may have shrunk to empty while this shard
                    # was down)
                    t = (Transaction()
                         .write(shard_cid(self.pg, s), name, 0, b"")
                         .truncate(shard_cid(self.pg, s), name, 0)
                         .setattr(shard_cid(self.pg, s), name,
                                  HINFO_KEY, hinfo.to_bytes()))
                    self._store(s).queue_transaction(t)
                plan.counters["objects"] += 1
                continue
            plan.names_by_len.setdefault(
                self._shard_len(self.object_sizes[name]),
                []).append(name)
        plan.remaining = {n for g in plan.names_by_len.values()
                          for n in g}
        if plan.names_by_len:
            if repair is not None and repair.planes is not None:
                # sub-chunk wire reads: stage only the repair planes
                # and decode through the range program — the helper
                # bytes on the wire drop to wire_fraction of a full
                # pull (beta/q^t for Clay)
                fn = self.coder.range_batch_decoder(lost, helper)
                if fn is not None:
                    plan.dec_fn = fn
                    plan.group_key = self.coder. \
                        range_decode_program_key(lost, helper)
                    plan.range_planes = repair.planes
                    plan.sub_count = repair.sub_chunk_count
            if plan.dec_fn is None:
                plan.dec_fn = self.coder.batch_decoder(lost, helper)
                if plan.dec_fn is not None:
                    key = self.coder.decode_program_key(lost, helper)
                    # id()-keyed fallbacks stay in the BACKEND's cache
                    # (a process-wide id key could alias a dead object)
                    plan.group_key = key if key is not None else None
        return plan

    def recover_shards(self, lost_shards: list[int],
                       replacement_osds: dict[int, int] | None = None,
                       batch: int = 128,
                       verify_hinfo: bool = True,
                       names: list[str] | None = None,
                       helper_exclude: set[int] | None = None,
                       helper_costs: dict[int, int] | None = None) -> dict:
        """Rebuild every object's lost shard(s): the RecoveryOp loop,
        batched AND pipelined. Returns counters {objects, bytes,
        hinfo_failures}. One-plan convenience over plan_recovery +
        RecoveryRunner — the cross-PG reconcile pass feeds MANY plans
        to one runner instead.

        Dataflow (ref: ECBackend::continue_recovery_op streaming, P5):
        for codecs with a static decode matrix (batch_decoder), each
        sub-batch is ONE fused device launch (decode + helper XOR-fold;
        integrity rides the fold — see RecoveryRunner); launches are
        enqueued asynchronously and their results copied back into
        pinned buffers without blocking, so results stream back one
        batch behind (double buffering). Codecs
        without a static matrix take the generic decode_chunks path,
        still batched per launch.

        lost_shards: shard slots whose OSD died.
        replacement_osds: slot -> new OSD id (defaults to reusing the
        slot's OSD id, i.e. re-created store after replacement).
        names: restrict recovery to these objects — the PG-log
        delta-replay path (a revived shard rebuilds only what it
        missed; ref: PGLog-driven recovery vs backfill).
        helper_exclude: shard slots that must not serve helper reads
        (other still-down OSDs during a partial rejoin).
        """
        plan = self.plan_recovery(lost_shards, replacement_osds,
                                  verify_hinfo, names, helper_exclude,
                                  helper_costs=helper_costs)
        RecoveryRunner([plan], batch=batch, perf=self.perf).run()
        return plan.counters

    def _recover_fallback(self, lost: list[int], survivors: list[int],
                          bad_pairs: dict[str, set[int]],
                          subgroup: list[str], rebuilt_all: np.ndarray,
                          counters: dict) -> None:
        """Re-decode objects whose helper reads failed hinfo, batched by
        identical bad-shard set (one decode launch per distinct set
        instead of the r01 per-object loop)."""
        by_bad: dict[tuple[int, ...], list[str]] = {}
        for name, bad in bad_pairs.items():
            by_bad.setdefault(tuple(sorted(bad)), []).append(name)
        for bad, names_ in by_bad.items():
            alt = [s for s in survivors if s not in bad]
            alt_need = sorted(self.coder.minimum_to_decode(lost, alt))
            stacks = {s: np.stack([self._store(s).read(
                shard_cid(self.pg, s), n) for n in names_])
                for s in alt_need}
            alt_rec = self.coder.decode_chunks(lost, stacks)
            for li, s in enumerate(lost):
                rec_s = host_array(alt_rec[s])
                for ni, name in enumerate(names_):
                    rebuilt_all[subgroup.index(name), li] = rec_s[ni]

    def _writeback_rebuilt(self, lost: list[int], subgroup: list[str],
                           rebuilt_all: np.ndarray, crcs: np.ndarray,
                           sl: int, counters: dict,
                           window: "RecoveryRunner | None" = None) -> None:
        # ONE combined txn per replacement shard for the whole batch
        # (the write-path fan-out unit), pipelined across shards — at
        # the wire tier this is len(lost) overlapped MStoreOp frames
        # per batch instead of len(lost) * B sequential ones. With a
        # `window`, the push rides the runner's byte-budgeted in-flight
        # window instead: frames of LATER batches go out before these
        # acks return (acks are collected as the budget fills and at
        # finish()), the recovery analog of the client op window.
        txns = []
        for li, s in enumerate(lost):
            cid = shard_cid(self.pg, s)
            t = Transaction()
            for bi, name in enumerate(subgroup):
                chunk = rebuilt_all[bi, li]
                hinfo = HashInfo(1, sl, [int(crcs[bi, li])])
                t.write(cid, name, 0, chunk) \
                 .truncate(cid, name, sl) \
                 .setattr(cid, name, HINFO_KEY, hinfo.to_bytes())
                counters["bytes"] += int(chunk.size)
            txns.append((s, t))
        if window is None:
            self._fanout_txns(txns)
        else:
            window.push_txns(self, txns, len(subgroup) * sl)
        counters["objects"] += len(subgroup)

    def _count_recovery(self, counters: dict) -> None:
        self.perf.inc_many(
            (("recovered_objects", counters["objects"]),
             ("recovered_bytes", counters["bytes"]),
             ("hinfo_failures", counters["hinfo_failures"])))

    # -- deep scrub ----------------------------------------------------------

    def _scrub_journal(self, live_slots: list[int]) -> dict:
        """Journal-aware deep scrub (r17): audit pending
        __stripe_journal__ intents instead of skipping the collection
        with the other "__" internals. Per live slot, every entry must
        decode (codec version 1), agree with its omap key, name this
        slot as a participant, fit its own geometry (the delta payload
        inside the new shard length), and sit ABOVE the slot's applied
        watermark (an entry at-or-below the watermark was applied but
        never dropped — the apply txn is atomic, so that's store
        corruption, not lag). Intents a later write superseded are
        counted stale — inert by the replay's version guard, not
        corrupt. Findings stay OUT of the `inconsistent` list: a
        pending intent is crash-recovery state, and auto_repair's
        decode-rebuild must never chew on the journal object."""
        pending = stale = 0
        bad: list[tuple[int, str]] = []      # (slot, why)
        for s in live_slots:
            store = self._store(s)
            cid = shard_cid(self.pg, s)
            try:
                if not store.exists(cid, self.JOURNAL_OBJ):
                    continue
                page = store.omap_iter(cid, self.JOURNAL_OBJ)
            except (ConnectionError, OSError, KeyError):
                continue                      # unreachable: lag excuse
            watermark = None
            entries: list[tuple[bytes, bytes]] = []
            for key, val in page:
                if key == self._J_APPLIED:
                    if len(val) == 8:
                        watermark = _struct.unpack("<Q", val)[0]
                    else:
                        bad.append((s, "watermark not 8 bytes"))
                elif key.startswith(b"e"):
                    entries.append((key, val))
                else:
                    bad.append((s, f"unknown journal key {key!r}"))
            for key, val in entries:
                try:
                    ent = self._decode_jentry(val)
                except Exception as e:   # noqa: BLE001 — ANY decode
                    # failure is the corruption this audit exists for
                    bad.append((s, f"undecodable intent {key!r}: "
                                   f"{type(e).__name__}"))
                    continue
                if self._jkey(ent["seq"]) != key:
                    bad.append((s, f"intent seq {ent['seq']} "
                                   f"disagrees with key {key!r}"))
                    continue
                if s not in ent["participants"]:
                    bad.append((s, f"intent seq {ent['seq']} does "
                                   f"not name slot {s} a participant"))
                    continue
                if ent["delta"] and \
                        ent["a"] + len(ent["delta"]) > ent["nsl"]:
                    bad.append((s, f"intent seq {ent['seq']} delta "
                                   f"overruns shard length "
                                   f"{ent['nsl']}"))
                    continue
                if watermark is not None and ent["seq"] <= watermark:
                    bad.append((s, f"intent seq {ent['seq']} at or "
                                   f"below applied watermark "
                                   f"{watermark} (apply is atomic "
                                   f"with the entry drop)"))
                    continue
                if ent["version"] <= self.object_versions.get(
                        ent["name"], 0):
                    stale += 1                # superseded: inert
                else:
                    pending += 1              # legitimate in-flight
        return {"journal_pending": pending, "journal_stale": stale,
                "journal_bad": bad}

    def deep_scrub(self, dead_osds: set[int] | None = None) -> dict:
        """Read every LIVE shard of every object, verify stored hinfo
        CRCs (the be_deep_scrub bulk-checksum audit), batched per
        shard. Dead slots are skipped — even touching their stores
        would resurrect destroyed OSD ids. The per-PG stripe journal
        is audited too (see _scrub_journal) instead of skipped."""
        dead = dead_osds or set()
        bad: list[tuple[str, int]] = []
        checked = 0
        for s in range(self.n):
            if self.acting[s] in dead:
                continue
            store = self._store(s)
            cid = shard_cid(self.pg, s)
            # a shard behind on an object's last write (or holding a
            # not-yet-replayed delete's leftover) is lagging, not
            # corrupt — same staleness excuse the replicated scrub and
            # shallow scrub apply
            # "__"-prefixed objects are PG-internal bookkeeping (e.g.
            # the standalone tier's __pg_meta__ omap blob): no hinfo,
            # not client data — the scrub audits client objects only
            names = [n for n in store.list_objects(cid)
                     if not n.startswith("__")
                     and n in self.object_sizes
                     and self.shard_applied[s]
                     >= self.object_versions.get(n, 0)]
            by_len: dict[int, list[str]] = {}
            for n in names:
                by_len.setdefault(store.stat(cid, n), []).append(n)
            for ln, group in by_len.items():
                blocks = np.stack([store.read(cid, n) for n in group])
                crcs = _u32(crc32c_blocks(to_device(blocks, self.device),
                                          init=0xFFFFFFFF, xorout=0))
                for bi, n in enumerate(group):
                    hinfo = HashInfo.from_bytes(store.getattr(cid, n,
                                                              HINFO_KEY))
                    checked += 1
                    if hinfo.get_chunk_hash(0) != int(crcs[bi]):
                        bad.append((n, s))
        rep = {"checked": checked, "inconsistent": bad}
        rep.update(self._scrub_journal(
            [s for s in range(self.n) if self.acting[s] not in dead]))
        return rep


# -- cross-PG recovery engine -------------------------------------------------

_RECOVER_PROGRAMS: dict = {}
_RECOVER_PROGRAMS_LOCK = _threading.Lock()

#: one shard-fetch frame's byte budget (readv chunks larger batches so
#: a single source OSD never serializes a multi-MiB frame per pull)
RECOVERY_FETCH_BYTES = 8 << 20


class _RecoveryPlan:
    """One PG's recovery intent (opened by ECBackend.plan_recovery):
    the rebuild name groups plus everything a RecoveryRunner needs to
    stage, verify, write back, and finally mark the slots caught up.
    `remaining` shrinks as batches land — a wire-tier round that dies
    mid-way re-plans exactly the leftover names."""

    __slots__ = ("be", "lost", "helper", "survivors", "verify",
                 "full_plan", "provided", "counters", "names_by_len",
                 "dec_fn", "group_key", "remaining", "done",
                 "repair", "range_planes", "sub_count")

    def __init__(self, be, lost, helper, survivors, verify, full_plan,
                 provided):
        self.be = be
        self.lost = list(lost)
        self.helper = list(helper)
        self.survivors = list(survivors)
        self.verify = verify
        self.full_plan = full_plan
        self.provided = provided
        self.counters = {"objects": 0, "bytes": 0, "hinfo_failures": 0}
        self.names_by_len: dict[int, list[str]] = {}
        self.dec_fn = None
        self.group_key = None
        self.remaining: set[str] = set()
        self.done = False
        # repair-locality planner outputs: the RepairPlan that chose
        # the helpers, plus the sub-chunk range shape when the wire
        # ships less than full rows (range_planes None = full rows)
        self.repair = None
        self.range_planes: tuple[int, ...] | None = None
        self.sub_count = 1

    def row_ranges(self, sl: int):
        """(row bytes shipped per helper, coalesced (off, len) ranges
        or None) at shard length `sl` — the wire shape of one staged
        helper row."""
        if self.range_planes is None:
            return sl, None
        from .repairplan import coalesce_ranges
        s = sl // self.sub_count
        return (len(self.range_planes) * s,
                coalesce_ranges((z * s, s) for z in self.range_planes))

    def finish(self) -> None:
        """Count the work done; advance applied cursors only when every
        planned name landed (a partial round must not defeat the
        staleness gate — the retry covers the rest)."""
        if self.done:
            return
        self.done = True
        if not self.remaining:
            self.be._mark_caught_up(self.lost, self.full_plan,
                                    self.provided)
        self.be._count_recovery(self.counters)



class RecoveryRunner:
    """Cross-PG fused recovery: executes MANY plans as one pipeline of
    fused decode batches (ref: ECBackend::continue_recovery_op, but the
    unit of admission is a BATCH drawn from every primaried PG, not one
    RecoveryOp of one PG).

    Batch formation: fused plans group by (decode-program key, shard
    length) — PGs sharing a geometry and loss pattern FILL shared
    batches, so the round costs one launch per batch instead of one
    per PG; mixed-geometry plans (different k/m, different loss slots)
    ride the same pipeline side by side with their own programs. The
    batch dim is pow2-bucketed like the write path (ragged tails would
    compile one program per size).

    Pipelining (the twin's device_put / copy_to_host_async, in CUDA
    terms): helper rows are staged into a ring of 2 pinned host
    buffers and uploaded with non-blocking copies; results come back
    into pinned buffers with non-blocking copies, one batch ahead, so
    they stream back under the next batch's staging. An event recorded
    after each upload gates the restaging of its buffer, and an event
    recorded after each download gates the host's read of it: neither
    copy is complete when the call that starts it returns. Writeback
    acks collect behind a byte budget (windowed PUSH). step() advances one batch at a time so the
    wire tier's mClock worker can interleave client ops between grants.

    Consistency under interleaved client ops (wire tier): the lost
    slots were repointed at plan time, so every client mutation after
    that reaches the recovering store directly; staging skips names
    whose size-class changed, and writeback skips names whose version
    moved since their stage — a skipped name needs nothing from us and
    a write of the OLD decode would resurrect overwritten (or deleted)
    bytes under a fresh CRC."""

    def __init__(self, plans, batch: int = 128, perf=None,
                 push_window_ops: int = 0, push_window_bytes: int = 0,
                 host_crc: bool | None = None):
        self.plans = [p for p in plans if p is not None]
        if host_crc is None:
            # the twin's auto-detection, per backend device: CPU
            # backends with the native hardware CRC take the host mode
            host_crc = bool(self.plans) and all(
                _host_crc_available(p.be.device) for p in self.plans)
        if host_crc and any(p.be.device.type != "cpu" for p in self.plans):
            # the twin's mode hands CRCs to its native SSE4.2 library;
            # a card backend keeps its CRCs on the card, where the mode
            # would only move the checksums of device data to the CPU
            raise ValueError("host_crc=True needs CPU backends: card "
                             "backends keep their CRCs on the card")
        self.perf = perf if perf is not None else (
            self.plans[0].be.perf if self.plans else ec_perf_counters())
        self.batch = max(1, int(batch))
        self._host_crc = bool(host_crc)
        self._push_ops_cap = int(push_window_ops)
        self._push_bytes_cap = int(push_window_bytes)
        self._push: list = []        # (handle, nbytes) in-flight acks
        self._push_bytes = 0
        self.stats = {"batches": 0, "fused_batches": 0,
                      "generic_batches": 0, "cross_pg_batches": 0,
                      "range_batches": 0, "helper_bytes_on_wire": 0,
                      "push_stalls": 0, "push_max_inflight_bytes": 0,
                      "skipped_stale": 0,
                      "host_crc": self._host_crc}
        self._batches: list = []
        groups: dict = {}
        order: list = []
        for plan in self.plans:
            for sl, names in sorted(plan.names_by_len.items()):
                if plan.dec_fn is None:
                    for i in range(0, len(names), self.batch):
                        self._batches.append(
                            ("generic", plan, sl,
                             names[i:i + self.batch]))
                    continue
                key = (plan.group_key
                       if plan.group_key is not None
                       else ("inst", id(plan.be), tuple(plan.lost),
                             tuple(plan.helper)),
                       sl, plan.verify)
                if key not in groups:
                    groups[key] = []
                    order.append(key)
                groups[key].extend((plan, n) for n in names)
        for key in order:
            pairs = groups[key]
            for i in range(0, len(pairs), self.batch):
                sub = pairs[i:i + self.batch]
                self._batches.append(("fused", sub[0][0], key[1], sub))
        self._bi = 0
        self._pending: list = []
        self._stage_bufs: dict = {}   # (shape, ring slot) -> buffer
        self._fetch_bufs: dict = {}   # (shapes, ring slot) -> buffers
        self._launched = 0            # fused launches: the ring index

    # -- pacing hooks (the mClock worker's inputs) -------------------------

    def pending(self) -> int:
        return (len(self._batches) - self._bi) + len(self._pending)

    def next_cost(self) -> int:
        """Bytes the next step will move — the mClock cost input
        (range plans cost their PLANNED wire bytes, not full rows)."""
        if self._bi < len(self._batches):
            kind, plan, sl, payload = self._batches[self._bi]
            rl, _ranges = plan.row_ranges(sl)
            return max(1, len(plan.helper)) * rl * len(payload)
        if self._pending:
            sl, pairs = self._pending[0][0], self._pending[0][2]
            return sl * len(pairs)
        return 1

    def next_helper_osds(self) -> list[int]:
        """Distinct source OSD ids the NEXT batch pulls helper rows
        from — the key set the r17 per-failure-domain repair budgets
        bucket next_cost()'s bytes by. Empty when the pipeline is
        drained or the next step is a completion (no new reads)."""
        if self._bi >= len(self._batches):
            return []
        kind, plan, _sl, payload = self._batches[self._bi]
        plans = [plan] if kind == "generic" else \
            list({id(p): p for p, _n in payload}.values())
        out: set[int] = set()
        for p in plans:
            for h in p.helper:
                out.add(int(p.be.acting[h]))
        return sorted(out)

    # -- pipeline ----------------------------------------------------------

    def step(self) -> bool:
        """One pipeline advance: launch the next batch (completing the
        oldest first when the pipeline is full) or drain one pending
        completion. Returns True while work remains."""
        if self._bi < len(self._batches):
            kind, plan, sl, payload = self._batches[self._bi]
            self._bi += 1
            if kind == "generic":
                self._run_generic(plan, sl, payload)
            else:
                self._launch(sl, payload)
                if len(self._pending) >= 2:
                    self._complete(self._pending.pop(0))
        elif self._pending:
            self._complete(self._pending.pop(0))
        else:
            return False
        return self._bi < len(self._batches) or bool(self._pending)

    def run(self) -> None:
        while self.step():
            pass
        self.finish()

    def finish(self) -> None:
        """Drain the pipeline and the push window, then settle every
        plan (cursor advance + counter fold)."""
        while self._pending:
            self._complete(self._pending.pop(0))
        self._drain_push(0, 0)
        for plan in self.plans:
            plan.finish()

    # -- windowed push ------------------------------------------------------

    def push_txns(self, be, txns, nbytes: int) -> None:
        """Submit writeback transactions into the in-flight window:
        transmit now, collect acks only when the byte/op budget fills
        (and at finish) — later batches' frames overlap these acks."""
        for shard, t in txns:
            st = be._store(shard)
            submit = getattr(st, "queue_transaction_async", None)
            if submit is None:
                st.queue_transaction(t)
                continue
            if self._push_ops_cap or self._push_bytes_cap:
                stalled = self._drain_push(
                    (self._push_ops_cap - 1) if self._push_ops_cap
                    else None,
                    (self._push_bytes_cap - nbytes)
                    if self._push_bytes_cap else None)
                if stalled:
                    self.stats["push_stalls"] += stalled
            self._push.append((submit(t), nbytes))
            self._push_bytes += nbytes
            self.stats["push_max_inflight_bytes"] = max(
                self.stats["push_max_inflight_bytes"], self._push_bytes)
        if not (self._push_ops_cap or self._push_bytes_cap):
            # no window configured: keep the synchronous durability
            # point (every shard acked before the next batch) — the
            # frames still all hit the wire before any ack is awaited
            self._drain_push(0, 0)

    def _drain_push(self, max_ops: int | None,
                    max_bytes: int | None) -> int:
        drained = 0
        while self._push and (
                (max_ops is not None and len(self._push) > max_ops)
                or (max_bytes is not None
                    and self._push_bytes > max(0, max_bytes))):
            h, nb = self._push.pop(0)
            self._push_bytes -= nb
            drained += 1
            h.result()
        return drained


    # -- fused path ---------------------------------------------------------

    def _program(self, plan):
        device = plan.be.device
        key = plan.group_key
        if key is None:
            # no shareable identity: cache on the owning backend
            ckey = ("r10", id(plan.dec_fn), plan.verify, self._host_crc)
            fn = plan.be._fused_cache.get(ckey)
            if fn is None:
                self.perf.inc("program_cache_misses")
                fn = _build_recover_program(plan.dec_fn, plan.verify,
                                            self._host_crc)
                plan.be._fused_cache[ckey] = fn
            else:
                self.perf.inc("program_cache_hits")
            return fn
        ckey = (key, plan.verify, self._host_crc, device)
        with _RECOVER_PROGRAMS_LOCK:
            fn = _RECOVER_PROGRAMS.get(ckey)
            if fn is None:
                self.perf.inc("program_cache_misses")
                fn = _build_recover_program(plan.dec_fn, plan.verify,
                                            self._host_crc)
                _RECOVER_PROGRAMS[ckey] = fn
            else:
                self.perf.inc("program_cache_hits")
        return fn

    def _stage_buffer(self, bucket: int, H: int, sl: int,
                      device: torch.device) -> list:
        """[host tensor, its numpy view, upload event] for this launch:
        a ring of 2 reusable buffers per shape (a fresh 100+ MiB buffer
        per batch pays page faults and, pinned, a cudaHostAlloc). On a
        CUDA device the buffers are pinned and the upload from a buffer
        must have finished before the host restages it: the copy is
        non-blocking, so the ring waits on the event the last upload
        from it recorded."""
        key = (bucket, H, sl, device, self._launched % 2)
        buf = self._stage_bufs.get(key)
        if buf is None:
            host = torch.zeros((bucket, H, sl), dtype=torch.uint8,
                               pin_memory=device.type == "cuda")
            buf = [host, host.numpy(), None]
            self._stage_bufs[key] = buf
        elif buf[2] is not None:
            buf[2].synchronize()
            buf[2] = None
        return buf

    def _fetch_async(self, outs, device: torch.device):
        """Start the device-to-host copies of a launch's results:
        (host tensors, event). On a CUDA device the copies land in
        pinned buffers (a ring of 2 per shape set, matching the depth-2
        pipeline: the launch that last used this slot was completed
        before this one) and `event` must be waited on before any host
        read; on the CPU the results are already host tensors."""
        if device.type != "cuda":
            return list(outs), None
        key = (tuple((tuple(t.shape), t.dtype) for t in outs),
               self._launched % 2)
        hosts = self._fetch_bufs.get(key)
        if hosts is None:
            hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in outs]
            self._fetch_bufs[key] = hosts
        for h, t in zip(hosts, outs):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        return hosts, event

    def _launch(self, sl: int, pairs) -> None:
        proto = pairs[0][0]
        device = proto.be.device
        helper = proto.helper
        H = len(helper)
        # rl is the staged row width: a full shard row, or the
        # repair planes' ranges of a Clay single-loss plan
        rl, _ranges = proto.row_ranges(sl)
        # stage-time revalidation (see class docstring)
        live: list[tuple] = []   # (plan, name, version-at-stage)
        for plan, name in pairs:
            size = plan.be.object_sizes.get(name)
            if size is None or plan.be._shard_len(size) != sl:
                plan.remaining.discard(name)
                self.stats["skipped_stale"] += 1
                continue
            live.append((plan, name,
                         plan.be.object_versions.get(name, 0)))
        if not live:
            return
        B = len(live)
        bucket = pow2_bucket(B)
        buf = self._stage_buffer(bucket, H, rl, device)
        host, stack = buf[0], buf[1]
        exp = np.zeros((B, H), dtype=np.uint32)
        with span("ecbackend.recover.stage", counters=self.perf,
                  key="recover_stage_time"):
            pre_bad = self._stage(live, sl, rl, stack, exp, proto.verify)
        wire = B * H * rl
        self.stats["helper_bytes_on_wire"] += wire
        self.perf.inc("recover_wire_bytes", wire)
        if bucket != B:
            stack[B:] = 0       # padding rows are zeros on the device
        program = self._program(proto)
        self.perf.inc("recover_launches")
        with span("ecbackend.recover.launch", counters=self.perf,
                  key="recover_launch_time"):
            dev_stack = host.to(device, non_blocking=True)
            if device.type == "cuda":
                buf[2] = torch.cuda.Event()
                buf[2].record(torch.cuda.current_stream(device))
            if self._host_crc:
                outs = program(dev_stack)
            else:
                expfold = np.zeros(bucket, dtype=np.int64)
                if proto.verify:
                    expfold[:B] = _expected_fold_crcs(exp, rl)
                    # a padded all-zero row folds to zero bytes, whose
                    # raw CRC is just the seed shifted through rl zero
                    # bytes — match it so padding never "fails"
                    expfold[B:] = _fold_seed_const(rl)
                outs = program(dev_stack,
                               torch.from_numpy(expfold).to(device))
            hosts, event = self._fetch_async(outs, device)
        self._pending.append((sl, rl, live, hosts, event, exp, pre_bad))
        self._launched += 1
        self.stats["batches"] += 1
        self.stats["fused_batches"] += 1
        if proto.range_planes is not None:
            self.stats["range_batches"] += 1
        if len({id(p) for p, _, _ in live}) > 1:
            self.stats["cross_pg_batches"] += 1

    @staticmethod
    def _segments(live) -> list[tuple]:
        """Contiguous per-plan runs of a batch: (plan, row0, names)."""
        segs: list[tuple] = []
        for ri, (plan, name, _v) in enumerate(live):
            if not segs or segs[-1][0] is not plan:
                segs.append((plan, ri, []))
            segs[-1][2].append(name)
        return segs

    def _stage(self, live, sl: int, rl: int, stack: np.ndarray,
               exp: np.ndarray, verify: bool) -> dict[int, set[int]]:
        """Fill (B, H, rl) helper rows + the expected fold inputs.
        `stack` is the numpy view of the runner's staging buffer (pinned
        for a card backend): local rows and frame replies are copied
        into it, never into fresh tensors. Remote stores submit ONE
        readv frame per (PG, helper shard), chunked by
        RECOVERY_FETCH_BYTES, data AND integrity in the frame, and all
        frames are on the wire before any reply is collected (the
        windowed PULL: fetches from different source OSDs overlap).

        Full-row plans ship whole shards and `exp` carries the stored
        hinfo CRCs (the whole-row fold). Range plans ship only the
        planned sub-chunk ranges; the SOURCE verifies each full shard
        against its hinfo (rot detection moves to the helper), `exp`
        carries the shipped ranges' CRCs, and rows whose full shard
        failed at the source come back in the returned
        {batch row: {helper slot}} map — the decode proceeds but those
        objects re-decode through the full-row fallback."""
        waits: list[tuple] = []
        pre_bad: dict[int, set[int]] = {}
        for plan, r0, names in self._segments(live):
            nb = len(names)
            _rl, ranges = plan.row_ranges(sl)
            for hi, s in enumerate(plan.helper):
                st = plan.be._store(s)
                cid = shard_cid(plan.be.pg, s)
                # chunk by the fetch byte budget so one source OSD
                # never serializes a giant frame
                per = max(1, RECOVERY_FETCH_BYTES // max(1, rl))
                if ranges is not None:
                    subr = getattr(st, "readv_ranges_submit", None)
                    for c0 in range(0, nb, per):
                        cnames = names[c0:c0 + per]
                        if subr is not None:
                            waits.append(
                                (subr(cid, cnames, sl, ranges,
                                      HINFO_KEY if verify else None),
                                 r0 + c0, hi, len(cnames), s))
                            continue
                        rows, crcs, bad = readv_ranges_host(
                            st, cid, cnames, sl, ranges,
                            HINFO_KEY if verify else None,
                            device=plan.be.device)
                        stack[r0 + c0:r0 + c0 + len(cnames), hi, :] \
                            = rows
                        if crcs is not None:
                            exp[r0 + c0:r0 + c0 + len(cnames), hi] \
                                = crcs
                        for b in bad:
                            pre_bad.setdefault(r0 + c0 + b,
                                               set()).add(s)
                    continue
                subv = getattr(st, "readv_submit", None)
                if subv is not None:
                    for c0 in range(0, nb, per):
                        cnames = names[c0:c0 + per]
                        waits.append(
                            (subv(cid, cnames, sl,
                                  HINFO_KEY if verify else None),
                             r0 + c0, hi, len(cnames), None))
                    continue
                out = stack[r0:r0 + nb, hi, :]
                rb = getattr(st, "read_batch", None)
                if rb is not None:
                    rb(cid, names, sl, out=out)
                else:
                    for bi, name in enumerate(names):
                        out[bi] = st.read(cid, name)
                if verify:
                    for bi, name in enumerate(names):
                        hb = st.getattr(cid, name, HINFO_KEY)
                        exp[r0 + bi, hi] = HashInfo.from_bytes(
                            hb).get_chunk_hash(0)
        for handle, r0, hi, nb, range_slot in waits:
            if range_slot is not None:
                data, crcs, bad = handle.result()
                rows = np.frombuffer(data, np.uint8)
                if rows.size != nb * rl:
                    raise ValueError(
                        f"readv_ranges: got {rows.size} bytes, "
                        f"expected {nb * rl}")
                stack[r0:r0 + nb, hi, :] = rows.reshape(nb, rl)
                if crcs is not None:
                    exp[r0:r0 + nb, hi] = crcs
                for b in bad:
                    pre_bad.setdefault(r0 + int(b),
                                       set()).add(range_slot)
                continue
            data, attrs = handle.result()
            rows = np.frombuffer(data, np.uint8)
            if rows.size != nb * sl:
                raise ValueError(
                    f"readv: got {rows.size} bytes, expected {nb * sl}")
            stack[r0:r0 + nb, hi, :] = rows.reshape(nb, sl)
            if attrs is not None:
                for bi, hb in enumerate(attrs):
                    exp[r0 + bi, hi] = HashInfo.from_bytes(
                        hb).get_chunk_hash(0)
        return pre_bad

    def _locate_bad_helpers(self, plan, name: str, bi: int,
                            exp: np.ndarray) -> set[int]:
        """Fold CRC mismatched for one object: re-read its helper rows
        and checksum each to find the rotten shard(s) — the rare path
        pays the per-row pass the common path no longer does."""
        device = torch.device("cpu") if self._host_crc else plan.be.device
        bad: set[int] = set()
        for hi, s in enumerate(plan.helper):
            st = plan.be._store(s)
            cid = shard_cid(plan.be.pg, s)
            chunk = st.read(cid, name)
            crc = int(_rows_crc32c(chunk[None, :], device)[0])
            if plan.range_planes is not None:
                want = HashInfo.from_bytes(
                    st.getattr(cid, name, HINFO_KEY)).get_chunk_hash(0)
            else:
                want = int(exp[bi, hi])
            if crc != want:
                bad.add(s)
        return bad

    def _complete(self, entry) -> None:
        sl, rl, live, hosts, event, exp, pre_bad = entry
        B = len(live)
        proto = live[0][0]
        with span("ecbackend.recover.fetch", counters=self.perf,
                  key="recover_fetch_time"):
            if event is not None:
                event.synchronize()
            got = [h.numpy() for h in hosts]
        # private copies: the pinned buffers are reused two launches on
        rebuilt = np.array(got[0][:B])
        if self._host_crc:
            E = rebuilt.shape[1]
            cpu = torch.device("cpu")
            rcrc = _rows_crc32c(rebuilt.reshape(B * E, sl),
                                cpu).reshape(B, E)
            if proto.verify:
                fold = np.array(got[1][:B])
                ok = (_rows_crc32c(fold, cpu)
                      == _expected_fold_crcs(exp, rl))
            else:
                ok = np.ones(B, dtype=bool)
        else:
            rcrc = got[1][:B].astype(np.uint32)
            ok = np.array(got[2][:B])
        bad_by_plan: dict[int, dict[str, set[int]]] = {}
        for bi, bads in (pre_bad or {}).items():
            plan, name, _v = live[bi]
            plan.counters["hinfo_failures"] += len(bads)
            bad_by_plan.setdefault(id(plan), {})[name] = set(bads)
        if proto.verify and not ok.all():
            for bi in np.nonzero(~ok)[0]:
                plan, name, _v = live[bi]
                if name in bad_by_plan.get(id(plan), {}):
                    continue    # already flagged at the source
                bad = self._locate_bad_helpers(plan, name, int(bi), exp)
                if bad:
                    plan.counters["hinfo_failures"] += len(bad)
                    bad_by_plan.setdefault(id(plan), {})[name] = bad
        with span("ecbackend.recover.writeback", counters=self.perf,
                  key="recover_writeback_time"):
            for plan, r0, names in self._segments(live):
                nb = len(names)
                seg_rebuilt = rebuilt[r0:r0 + nb]
                seg_crcs = rcrc[r0:r0 + nb]
                bad_pairs = bad_by_plan.get(id(plan), {})
                if bad_pairs:
                    plan.be._recover_fallback(
                        plan.lost, plan.survivors, bad_pairs, names,
                        seg_rebuilt, plan.counters)
                    idxs = sorted(names.index(n) for n in bad_pairs)
                    fix = plan.be._batched_hinfo_crcs(
                        seg_rebuilt[idxs].reshape(-1, sl)).reshape(
                            len(idxs), len(plan.lost))
                    seg_crcs[idxs] = fix
                # writeback-time revalidation: a name whose version
                # moved since its stage already holds fresher bytes on
                # the recovering slot
                keep = [i for i in range(nb)
                        if plan.be.object_versions.get(names[i], 0)
                        == live[r0 + i][2]
                        and names[i] in plan.be.object_sizes]
                if len(keep) != nb:
                    self.stats["skipped_stale"] += nb - len(keep)
                if keep:
                    plan.be._writeback_rebuilt(
                        plan.lost, [names[i] for i in keep],
                        seg_rebuilt[keep], seg_crcs[keep], sl,
                        plan.counters, window=self)
                plan.remaining.difference_update(names)

    # -- generic path (codecs without a static decode plan) ----------------

    def _run_generic(self, plan, sl: int, names: list[str]) -> None:
        be = plan.be
        live = [n for n in names
                if be.object_sizes.get(n) is not None
                and be._shard_len(be.object_sizes[n]) == sl]
        if len(live) != len(names):
            self.stats["skipped_stale"] += len(names) - len(live)
            plan.remaining.difference_update(
                set(names) - set(live))
        names = live
        if not names:
            return
        self.perf.inc("recover_launches")
        self.stats["batches"] += 1
        self.stats["generic_batches"] += 1
        wire = len(plan.helper) * sl * len(names)
        self.stats["helper_bytes_on_wire"] += wire
        self.perf.inc("recover_wire_bytes", wire)
        stacks = {s: np.stack([be._store(s).read(
            shard_cid(be.pg, s), n) for n in names])
            for s in plan.helper}
        bad_pairs: dict[str, set[int]] = {}
        if plan.verify:
            for s in plan.helper:
                crcs_s = be._batched_hinfo_crcs(stacks[s])
                for bi, name in enumerate(names):
                    hb = be._store(s).getattr(
                        shard_cid(be.pg, s), name, HINFO_KEY)
                    if HashInfo.from_bytes(hb).get_chunk_hash(0) \
                            != int(crcs_s[bi]):
                        plan.counters["hinfo_failures"] += 1
                        bad_pairs.setdefault(name, set()).add(s)
        rec = be.coder.decode_chunks(plan.lost, stacks)
        rebuilt_all = np.stack(
            [host_array(rec[s]) for s in plan.lost], axis=1)
        if bad_pairs:
            be._recover_fallback(plan.lost, plan.survivors, bad_pairs,
                                 names, rebuilt_all, plan.counters)
        crcs = be._batched_hinfo_crcs(
            rebuilt_all.reshape(-1, sl)).reshape(len(names),
                                                 len(plan.lost))
        be._writeback_rebuilt(plan.lost, names, rebuilt_all, crcs, sl,
                              plan.counters, window=self)
        plan.remaining.difference_update(names)


# -- carried state ---------------------------------------------------------------

def shards_from_snapshot(stores: dict, cluster: ShardSet | None = None
                         ) -> ShardSet:
    """Fill a ShardSet (a new one by default) from a snapshot's stores,
    {osd: {cid: {name: {"data": u8 array, "attrs": {key: bytes},
    "omap": {bytes: bytes}}}}}; a collection without objects is
    created all the same."""
    cluster = ShardSet() if cluster is None else cluster
    for osd, colls in stores.items():
        t = Transaction()
        for cid, objs in colls.items():
            t.create_collection(cid)
            for name, obj in objs.items():
                data = np.asarray(obj["data"], np.uint8)
                t.touch(cid, name).write(cid, name, 0, data) \
                 .truncate(cid, name, len(data))
                for key, val in obj.get("attrs", {}).items():
                    t.setattr(cid, name, key, bytes(val))
                if obj.get("omap"):
                    t.omap_set(cid, name, {bytes(k): bytes(v) for k, v
                                           in obj["omap"].items()})
        cluster.osd(int(osd)).queue_transaction(t)
    return cluster


def backend_from_snapshot(snapshot: dict, profile: dict | str, pg: str,
                          acting: list[int], chunk_size: int | None = None,
                          perf=None, device=None,
                          cluster: ShardSet | None = None) -> ECBackend:
    """Build a ShardSet and an ECBackend over it from a plain snapshot,
    so that the port can read, recover and scrub what another process
    (the twin included) wrote. The snapshot holds only numpy arrays,
    bytes, ints and dicts:

      "stores":          {osd: {cid: {name: {"data": u8 array,
                                             "attrs": {key: bytes},
                                             "omap": {bytes: bytes}}}}}
      "object_sizes":    {name: int}
      "object_versions": {name: int}
      "pg_log":          bytes (PGLog.encode)
      "shard_applied":   {slot: int}
      "rmw_seq":         int

    Given `cluster`, a ShardSet that already holds the stores (a whole
    cluster's, see osd/cluster.py::cluster_from_snapshot), the backend
    joins it as it is (no collection made) and "stores" is not read."""
    shared = cluster is not None
    if not shared:
        cluster = shards_from_snapshot(snapshot["stores"])
    be = ECBackend(profile, pg, acting, cluster, chunk_size=chunk_size,
                   perf=perf, ensure_collections=not shared, device=device)
    be.object_sizes = {n: int(v)
                       for n, v in snapshot["object_sizes"].items()}
    be.object_versions = {n: int(v)
                          for n, v in snapshot["object_versions"].items()}
    be.pg_log = PGLog.decode(bytes(snapshot["pg_log"]))
    be.shard_applied = [int(snapshot["shard_applied"][s])
                        for s in range(be.n)]
    be._rmw_seq = int(snapshot["rmw_seq"])
    return be
