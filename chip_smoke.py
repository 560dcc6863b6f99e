#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ceph_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which fails loudly (exit code 1, no result line):
  1. print the card's name and power limit; build every hand kernel
     from the sources in the checkout;
  2. hold each kernel bit-exact against its plain PyTorch version on
     the card, at the main path's shapes and at odd ones;
  3. drive the main path at full width: RS k=8 m=3 over 1024 objects
     of 4 MiB (data made on the card from a seeded torch.Generator),
     in batches of 32: fused write (parity + 11 hinfo CRCs per object),
     lose shards 0 and 9, fused recovery on the first 8 survivors with
     the helper-fold verify, decode_concat of one batch; check against
     the write-time bytes and CRCs, the numpy oracle and the CRC
     reference, and check that the kernels were launched;
  4. time each kernel and its plain version with CUDA events around a
     run of back-to-back calls (warm, median per call; the small ragged
     instance by its device time in a torch.profiler trace), and the
     end-to-end encode GB/s, decode GB/s and recovery objects/s one
     call at a time, host overhead included;
  5. drive the PG backend the way its users do, at the same width:
     ECBackend.write_objects of 256 seeded 4 MiB objects in groups of
     32, read_objects of all of them, a degraded read with shards 0
     and 9 down, one flipped byte in a helper shard, recover_shards
     of shards 0 and 9 through RecoveryRunner (batch 32), repair_pg
     and a clean deep_scrub, one RMW delta wave over 32 objects with
     ragged windows (5 bytes at 3, 4093 bytes at 1 MiB + 7), and a
     stripe-journal replay; every check bit-exact.
The line before the last is a JSON object with one entry per kernel;
the last line is {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of ceph_tpu, and needs one card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 20261017
K, M = 8, 3
OBJECT_SIZE = 4 << 20
N_OBJECTS = 1024
N_BACKEND = 256
BATCH = 32
LOST = (0, 9)
PROFILE = f"plugin=jerasure technique=reed_sol_van k={K} m={M}"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 at 3.35 TB/s,
# int8 tensor cores at 1,979 Tops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, warm: int = 3, reps: int = 7, calls: int = 1) -> float:
    """Milliseconds per call: CUDA events around `calls` back-to-back
    calls, divided by `calls`; the median of `reps` such runs after
    `warm` calls. With calls=1 the time includes the host's work
    between the events, as a user's single call would."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def kernel_device_ms(fn, symbol: str, calls: int = 20) -> float:
    """Milliseconds of device time per launch of the kernel whose
    symbol holds `symbol`, from a torch.profiler trace of `calls`
    calls after warm ones; fails unless the trace shows every launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in device_events(prof) if symbol in e.key]
    n = sum(e.count for e in evs)
    if n != calls:
        fail(f"the trace shows {n} launches of {symbol}, not {calls}")
    return sum(e.self_device_time_total for e in evs) / n / 1e3


def gf_bound(B: int, k: int, m: int, L: int) -> tuple[float, str]:
    """Least time (ms) the card could take for the GF apply: the larger
    of B*(k+m)*L bytes through HBM and the fewest operations known for
    the function, a (8m x 8k) bit-matrix product per byte column on the
    int8 tensor cores (2*64*m*k ops per column, B*L columns)."""
    t_bytes = B * (k + m) * L / HBM_BYTES_PER_S
    t_ops = 2 * 64 * m * k * B * L / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------- phase 2

def check_gf_kernel(torch, dev) -> dict:
    import numpy as np

    from ceph_tpu_torch.ec.matrices import reed_sol_van_matrix
    from ceph_tpu_torch.gf.numpy_ref import decode_matrix
    from ceph_tpu_torch.ops import gf_kernel as G

    rng = np.random.default_rng(SEED)
    rs = reed_sol_van_matrix(K, M)
    sl = OBJECT_SIZE // K
    cases = [("encode k8m3", rs, (BATCH, K, sl), 0)]
    for lost in ((3,), LOST, (1, 5, 10)):
        surv = [s for s in range(K + M) if s not in lost][:K]
        cases.append((f"decode {len(lost)}-loss {lost}",
                      decode_matrix(rs, list(lost), K, surv),
                      (BATCH, K, sl), 0))

    def rmat(m, k):
        return rng.integers(0, 256, (m, k), dtype=np.uint8)
    cases += [
        ("k=1", rmat(3, 1), (4, 1, 4096), 0),
        ("m=1", rmat(1, 8), (4, 8, 4096), 0),
        ("k=16 m=4", rmat(4, 16), (3, 16, 8192), 0),
        ("m=12 (row groups)", rmat(12, 5), (2, 5, 1024), 0),
        ("k=250 m=8 (shared memory > 48 KiB)", rmat(8, 250), (2, 250, 256),
         0),
        ("L=4", rs, (5, K, 4), 0),
        ("L=128", rs, (5, K, 128), 0),
        ("L=524292", rs, (2, K, 524292), 0),
        ("B=1", rs, (1, K, sl), 0),
        ("unaligned start", rs, (3, K, 4096), 4),
        ("L=1 (ragged)", rs, (5, K, 1), 0),
        ("L=5 (ragged)", rs, (5, K, 5), 0),
        ("L=6 (ragged)", rs, (5, K, 6), 0),
        ("L=7 (ragged)", rs, (5, K, 7), 0),
        ("L=4093 (ragged)", rs, (BATCH, K, 4093), 0),
        ("delta (ragged)", rs[:, [0, 2]], (BATCH, 2, 4093), 0),
        ("ragged, odd start", rs, (3, K, 4097), 1),
    ]
    worst = 0
    for name, mat, (B, k, L), offset in cases:
        flat = torch.randint(0, 256, (B * k * L + offset,), dtype=torch.uint8,
                             device=dev)
        data = flat[offset:].view(B, k, L)
        got = G.apply_matrix_gf(mat, data)
        want = G.apply_matrix_plain(mat, data)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) \
            if got.numel() else 0
        worst = max(worst, err)
        log(f"  gf_apply {name}: ({B},{k},{L})->({B},{mat.shape[0]},{L}) "
            f"max_abs_err={err}")
        if err or not torch.equal(got, want):
            fail(f"gf_apply disagrees with its plain version on {name}")
    return {"max_abs_err": worst}


# ------------------------------------------------------------- phase 3

def main_path(torch, dev) -> dict:
    import numpy as np

    from ceph_tpu_torch.csum.reference import ceph_crc32c
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.gf.numpy_ref import encode_ref
    from ceph_tpu_torch.osd.ecbackend import (_build_recover_program,
                                              _expected_fold_crcs,
                                              _fused_write_fn)

    coder = factory(PROFILE)
    if coder.device.type != dev.type or coder.impl != "pallas":
        fail(f"coder on {coder.device} with impl {coder.impl}")
    sl = coder.get_chunk_size(OBJECT_SIZE)
    n = K + M
    write = _fused_write_fn(coder.matrix.tobytes(), M, K, coder.impl, sl,
                            BATCH, coder.device)
    survivors = [s for s in range(n) if s not in LOST][:K]
    dec_fn = coder.batch_decoder(LOST, survivors)
    recover = _build_recover_program(dec_fn, verify=True, host_crc=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for bi in range(N_OBJECTS // BATCH):
        data = torch.randint(0, 256, (BATCH, K, sl), dtype=torch.uint8,
                             device=dev, generator=gen)
        parity, crcs = write(data)
        full = torch.cat([data, parity], dim=1)        # (B, n, sl)
        stack = full[:, survivors]
        exp = crcs[:, survivors].cpu().numpy()         # hinfo, on host
        expfold = torch.from_numpy(
            _expected_fold_crcs(exp, sl).astype(np.int64)).to(dev)
        rebuilt, rcrc, ok = recover(stack, expfold)
        bad += (~ok).sum()
        for ei, e in enumerate(LOST):
            bad += (rebuilt[:, ei] != full[:, e]).any()
            bad += (rcrc[:, ei] != crcs[:, e]).sum()
        if bi == 0:
            d0 = data[:2].cpu().numpy()
            want = encode_ref(coder.matrix, d0)
            if not np.array_equal(parity[:2].cpu().numpy(), want):
                fail("fused write parity differs from encode_ref")
            host = full[0, [0, 8, 9, 10]].cpu().numpy()
            got_crc = crcs[0, [0, 8, 9, 10]].cpu().numpy()
            ref_crc = [ceph_crc32c(0xFFFFFFFF, r) for r in host]
            if [int(c) for c in got_crc] != ref_crc:
                fail(f"hinfo CRCs {got_crc} != reference {ref_crc}")
            chunks = {i: full[:, i] for i in range(n) if i not in LOST}
            obj = coder.decode_concat(chunks, OBJECT_SIZE)
            if obj.shape != (BATCH, OBJECT_SIZE) or \
                    not torch.equal(obj, data.reshape(BATCH, -1)):
                fail("decode_concat did not return the written objects")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if int(bad):
        fail(f"main path: {int(bad)} recovery mismatches "
             f"(fold checks, rebuilt rows or rebuilt CRCs)")
    log(f"  main path: {N_OBJECTS} x {OBJECT_SIZE >> 20} MiB objects, "
        f"write -> lose {list(LOST)} -> fused recover -> verify in "
        f"{seconds:.3f} s (host clock, with checks)")
    return {"coder": coder, "recover": recover, "write": write,
            "dec_fn": dec_fn, "survivors": survivors, "sl": sl}


# ------------------------------------------------------------- phase 4

def measure(torch, dev, ctx) -> dict:
    from ceph_tpu_torch.csum.kernels import crc32c_blocks
    from ceph_tpu_torch.gf.numpy_ref import decode_matrix
    from ceph_tpu_torch.ops import gf_kernel as G

    coder, sl = ctx["coder"], ctx["sl"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    data = torch.randint(0, 256, (BATCH, K, sl), dtype=torch.uint8,
                         device=dev, generator=gen)
    D = decode_matrix(coder.matrix, list(LOST), K, ctx["survivors"])
    out = {}
    for label, mat in (("encode", coder.matrix), ("decode", D)):
        m = mat.shape[0]
        ms = cuda_ms(lambda: G.apply_matrix_gf(mat, data), calls=20)
        plain = cuda_ms(lambda: G.apply_matrix_plain(mat, data), 1, 5,
                        calls=3)
        bound, by = gf_bound(BATCH, K, m, sl)
        out[label] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                      "bound_by": by, "shape": [BATCH, K, m, sl]}
        log(f"  gf_apply {label} ({BATCH},{K},{sl})->({BATCH},{m},{sl}): "
            f"{ms:.4f} ms (bound {bound:.4f} ms, {by}), plain "
            f"{plain:.4f} ms")
    # the ragged instance at the RMW delta shape of phase 5: at this
    # size the wrapper's host work outlasts the kernel, so its time is
    # the kernel's own device time from a trace; host_ms is per call
    # with the host's work included
    dmat = coder.matrix[:, [0, 2]]
    ddata = data[:, :2, :4093].contiguous()
    ms = kernel_device_ms(lambda: G.apply_matrix_gf(dmat, ddata),
                          "gf_apply_kernel")
    host_ms = cuda_ms(lambda: G.apply_matrix_gf(dmat, ddata), calls=20)
    plain = cuda_ms(lambda: G.apply_matrix_plain(dmat, ddata), 1, 5,
                    calls=3)
    bound, by = gf_bound(BATCH, 2, M, 4093)
    out["ragged"] = {"ms": ms, "host_ms": host_ms, "plain_ms": plain,
                     "bound_ms": bound, "bound_by": by,
                     "shape": [BATCH, 2, M, 4093]}
    log(f"  gf_apply ragged ({BATCH},2,4093)->({BATCH},{M},4093): "
        f"{ms:.5f} ms on the device, {host_ms:.4f} ms per call with the "
        f"host's work (bound {bound:.6f} ms, {by}), plain {plain:.4f} ms")
    in_bytes = BATCH * K * sl
    t_enc = cuda_ms(lambda: coder.encode_chunks(data))
    t_write = cuda_ms(lambda: ctx["write"](data))
    t_dec = cuda_ms(lambda: ctx["dec_fn"](data))
    expfold = torch.zeros(BATCH, dtype=torch.int64, device=dev)
    t_rec = cuda_ms(lambda: ctx["recover"](data, expfold))
    rows = data.reshape(BATCH * K, sl)
    t_crc = cuda_ms(lambda: crc32c_blocks(rows, init=0xFFFFFFFF, xorout=0))
    e2e = {"encode_gbps": in_bytes / t_enc / 1e6,
           "fused_write_gbps": in_bytes / t_write / 1e6,
           "decode_gbps": in_bytes / t_dec / 1e6,
           "recovery_objects_per_s": BATCH / t_rec * 1e3,
           "encode_ms": t_enc, "fused_write_ms": t_write,
           "decode_ms": t_dec, "recover_ms": t_rec,
           "crc32c_gbps": BATCH * K * sl / t_crc / 1e6,
           "crc32c_ms_per_8_rows_of_batch": t_crc}
    log(f"  encode_chunks {e2e['encode_gbps']:.2f} GB/s "
        f"({t_enc:.4f} ms / batch of {BATCH}); fused write (encode + 11 "
        f"CRCs) {e2e['fused_write_gbps']:.2f} GB/s ({t_write:.4f} ms)")
    log(f"  decode 2-loss {e2e['decode_gbps']:.2f} GB/s ({t_dec:.4f} ms); "
        f"fused recovery (decode + rebuilt CRCs + fold verify) "
        f"{e2e['recovery_objects_per_s']:.1f} objects/s ({t_rec:.4f} ms)")
    log(f"  crc32c_blocks over {BATCH * K} rows of {sl} B: {t_crc:.4f} ms "
        f"({e2e['crc32c_gbps']:.2f} GB/s)")
    out["e2e"] = e2e
    return out


# ------------------------------------------------------------- phase 5

def backend_path(torch, dev) -> dict:
    """The PG data path through ECBackend and RecoveryRunner at full
    width; returns the phase's rates, span totals and counters."""
    import numpy as np

    from ceph_tpu_torch.osd.ecbackend import (HINFO_KEY, ECBackend,
                                              ShardSet, Transaction,
                                              _fused_write_fn, shard_cid)
    from ceph_tpu_torch.ops import gf_kernel as G
    from ceph_tpu_torch.osd.stripe import HashInfo

    n = K + M
    sl = OBJECT_SIZE // K
    pg = "1.0"
    be = ECBackend(PROFILE, pg, list(range(n)), ShardSet(), chunk_size=sl,
                   device=dev)
    if be.device.type != dev.type or be.sinfo.chunk_size != sl \
            or be.coder.impl != "pallas":
        fail(f"backend on {be.device}, chunk {be.sinfo.chunk_size}, "
             f"impl {be.coder.impl}")
    names = [f"obj{i:04d}" for i in range(N_BACKEND)]
    groups = [names[i:i + BATCH] for i in range(0, N_BACKEND, BATCH)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    objs: dict = {}

    # 1. writes, 32 objects per call
    t_write = 0.0
    for g in groups:
        batch = torch.randint(0, 256, (len(g), OBJECT_SIZE),
                              dtype=torch.uint8, device=dev,
                              generator=gen).cpu().numpy()
        chunk = {nm: batch[i] for i, nm in enumerate(g)}
        objs.update(chunk)
        t0 = time.perf_counter()
        be.write_objects(chunk)
        t_write += time.perf_counter() - t0
    write_gbps = N_BACKEND * OBJECT_SIZE / t_write / 1e9
    log(f"  write_objects: {N_BACKEND} x {OBJECT_SIZE >> 20} MiB in "
        f"{t_write:.3f} s: {write_gbps:.3f} GB/s (host clock)")

    # 2. reads, then 3. a degraded read with shards 0 and 9 down
    for dead, label in (((), "read"), ((be.acting[0], be.acting[9]),
                                       "degraded read (0, 9 down)")):
        t0 = time.perf_counter()
        for g in groups:
            got = be.read_objects(g, dead_osds=set(dead))
            for nm in g:
                if not np.array_equal(got[nm], objs[nm]):
                    fail(f"{label} of {nm} differs from the write")
        log(f"  {label}: {N_BACKEND} objects bit-exact in "
            f"{time.perf_counter() - t0:.3f} s")

    # 4. one flipped byte in a helper shard the recovery will read
    flip_slot, flip_name, flip_off = 3, names[37], sl // 3
    st = be.cluster.osd(be.acting[flip_slot])
    cid = shard_cid(pg, flip_slot)
    byte = st.read(cid, flip_name, flip_off, 1)
    st.queue_transaction(Transaction().write(
        cid, flip_name, flip_off, (byte ^ 0x5A).astype(np.uint8)))

    # 5. lose shards 0 and 9; RecoveryRunner rebuilds them
    lost = list(LOST)
    old = {s: be.cluster.stores.pop(be.acting[s]) for s in lost}
    t0 = time.perf_counter()
    counters = be.recover_shards(lost, replacement_osds={
        s: 100 + s for s in lost}, batch=BATCH)
    t_rec = time.perf_counter() - t0
    rec_rate = counters["objects"] / t_rec
    log(f"  recover_shards({lost}, batch={BATCH}): {counters} in "
        f"{t_rec:.3f} s: {rec_rate:.1f} objects/s (host clock)")
    if counters["objects"] != N_BACKEND or counters["hinfo_failures"] < 1:
        fail(f"recovery counters {counters}: want {N_BACKEND} objects "
             f"and the flipped helper flagged")
    for s in lost:
        new_st = be.cluster.osd(100 + s)
        scid = shard_cid(pg, s)
        for nm in names:
            if not np.array_equal(new_st.read(scid, nm),
                                  old[s].read(scid, nm)):
                fail(f"rebuilt shard {s} of {nm} differs from the write")
            if new_st.getattr(scid, nm, HINFO_KEY) != \
                    old[s].getattr(scid, nm, HINFO_KEY):
                fail(f"rebuilt hinfo of shard {s} of {nm} differs")
    log(f"  rebuilt shards {lost} of {N_BACKEND} objects and their hinfo "
        f"equal the write's, the flipped helper's object included")

    # 6. repair the flipped helper, then a clean deep scrub
    rep = be.repair_pg()
    if rep["repaired"] != 1 or rep["objects"] != 1:
        fail(f"repair_pg {rep}: want the one flipped shard repaired")
    scrub = be.deep_scrub()
    if scrub["inconsistent"] or scrub["checked"] != N_BACKEND * n \
            or scrub["journal_bad"]:
        fail(f"deep_scrub not clean: {scrub}")
    log(f"  repair_pg {rep}; deep_scrub checked {scrub['checked']} "
        f"shards, clean")

    # 7. one RMW delta wave over 32 objects with ragged windows
    rng = np.random.default_rng(SEED + 7)
    wave = names[:BATCH]
    ops = []
    for nm in wave:
        for off, ln in ((3, 5), (OBJECT_SIZE // 4 + 7, 4093)):
            patch = rng.integers(0, 256, ln, dtype=np.uint8)
            ops.append((nm, off, patch))
            objs[nm] = objs[nm].copy()
            objs[nm][off:off + ln] = patch
    rmw0 = be.perf.get("rmw_ops")
    t0 = time.perf_counter()
    be.write_ranges(ops)
    t_rmw = time.perf_counter() - t0
    if be.perf.get("rmw_ops") - rmw0 != BATCH \
            or be.perf.get("rmw_full_fallbacks"):
        fail(f"RMW wave took the full path: rmw_ops "
             f"{be.perf.get('rmw_ops') - rmw0}, fallbacks "
             f"{be.perf.get('rmw_full_fallbacks')}")
    got = be.read_objects(wave)
    data = np.stack([got[nm] for nm in wave])
    if not np.array_equal(data, np.stack([objs[nm] for nm in wave])):
        fail("RMW wave: objects read back differ from the overlay")
    full = _fused_write_fn(be.coder.matrix.tobytes(), M, K, be.coder.impl,
                           sl, BATCH, be.device)
    ref0 = G.apply_matrix_gf.launches     # the reference is not the path
    parity, crcs = full(torch.from_numpy(
        be.sinfo.object_to_shards(data)).to(dev))
    G.apply_matrix_gf.launches = ref0
    parity, crcs = parity.cpu().numpy(), crcs.cpu().numpy()
    for bi, nm in enumerate(wave):
        for s in range(n):
            st = be.cluster.osd(be.acting[s])
            scid = shard_cid(pg, s)
            h = HashInfo.from_bytes(st.getattr(scid, nm, HINFO_KEY))
            if h.get_chunk_hash(0) != int(crcs[bi, s]):
                fail(f"RMW hinfo of shard {s} of {nm} differs from a "
                     f"full re-encode")
            if s >= K and not np.array_equal(st.read(scid, nm),
                                             parity[bi, s - K]):
                fail(f"RMW parity shard {s} of {nm} differs from a full "
                     f"re-encode")
    log(f"  RMW delta wave: {BATCH} objects x 2 ragged windows in "
        f"{t_rmw:.3f} s; parity and hinfo equal a full re-encode")

    # 8. nothing left in the stripe journal
    replay = be.stripe_journal_replay()
    if replay != {"forward": 0, "rolled_back": 0, "entries": 0}:
        fail(f"stripe_journal_replay found pending intents: {replay}")
    spans = {k: be.perf.get(k)["sum"] for k in (
        "encode_time", "recover_stage_time", "recover_launch_time",
        "recover_fetch_time", "recover_writeback_time")}
    log(f"  span totals (s): " + json.dumps(spans))
    launches = G.apply_matrix_gf.launches
    log(f"  gf_apply launches in phase 5: {launches}")
    if launches == 0:
        fail("the backend path never launched gf_apply")
    trace = trace_backend(torch, be, gen)
    return {"gf_apply_launches": launches,
            "write_gbps": write_gbps, "write_s": t_write,
            "recovery_objects_per_s": rec_rate, "recover_s": t_rec,
            "rmw_wave_s": t_rmw, "spans_s": spans,
            "recover_counters": counters, "trace": trace}


def device_events(prof) -> list:
    """The profile's device-side entries (kernels and copies). Host ops
    that launched them, and the spans' ranges that the profiler mirrors
    onto the device timeline, are left out, so nothing counts twice."""
    import torch
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy_s(prof) -> float:
    """Seconds of device work (kernels and copies) in a profile."""
    return sum(e.self_device_time_total for e in device_events(prof)) / 1e6


def trace_backend(torch, be, gen) -> dict:
    """Where phase 5's time goes, after its checks: one more write
    group and a one-shard recovery under torch.profiler (the device's
    busy share of the wall time), and one more write group under
    cProfile (the host functions that take the write's time)."""
    import cProfile
    import pstats

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.osd.ecbackend import shard_cid

    def group(tag):
        batch = torch.randint(0, 256, (BATCH, OBJECT_SIZE), dtype=torch.uint8,
                              device=gen.device, generator=gen)
        return {f"{tag}{i:02d}": row for i, row in
                enumerate(batch.cpu().numpy())}

    out = {}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        be.write_objects(group("tw"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["write_group_s"] = wall
    out["write_device_busy_s"] = device_busy_s(prof)
    slot = 5
    old = be.cluster.stores.pop(be.acting[slot])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        counters = be.recover_shards([slot], replacement_osds={slot: 105},
                                     batch=BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cid = shard_cid(be.pg, slot)
    for nm in old.list_objects(cid):
        if not np.array_equal(be.cluster.osd(105).read(cid, nm),
                              old.read(cid, nm)):
            fail(f"traced recovery of shard {slot} of {nm} differs")
    out["recover_objects"] = counters["objects"]
    out["recover_s"] = wall
    out["recover_device_busy_s"] = device_busy_s(prof)
    out["recover_top_device"] = [
        [e.key[:60], e.self_device_time_total / 1e3, e.count]
        for e in sorted(device_events(prof),
                        key=lambda e: -e.self_device_time_total)[:6]]
    cp = cProfile.Profile()
    objs = group("tc")
    cp.enable()
    be.write_objects(objs)
    cp.disable()
    stats = pstats.Stats(cp)
    out["write_host_top"] = [
        [f"{fn[0].rsplit('/', 1)[-1]}:{fn[1]}:{fn[2]}", tt, ct]
        for fn, (_cc, _nc, tt, ct, _callers) in sorted(
            stats.stats.items(), key=lambda kv: -kv[1][2])[:10]]
    for k in ("write", "recover"):
        busy = out[f"{k}_device_busy_s"]
        wall = out[f"{k}_group_s" if k == "write" else "recover_s"]
        log(f"  traced {k}: wall {wall:.4f} s, device busy {busy:.4f} s, "
            f"idle share {1 - busy / wall:.4f}")
    log("  trace " + json.dumps(out))
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    root = Path(__file__).resolve().parent
    if not (root / "ceph_tpu_torch" / "__init__.py").is_file():
        fail(f"ceph_tpu_torch/ not found beside {Path(__file__).name}: "
             f"run from a checkout of the repository")
    sys.path.insert(0, str(root))
    from ceph_tpu_torch.ops import gf_kernel as G

    dev = torch.device("cuda")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    G.build()
    log(f"phase 1: built gf_apply.cu in {time.perf_counter() - t0:.1f} s")

    log("phase 2: kernels against their plain versions")
    gf_check = check_gf_kernel(torch, dev)

    log("phase 3: main path")
    G.apply_matrix_gf.launches = 0
    ctx = main_path(torch, dev)
    launches = G.apply_matrix_gf.launches
    log(f"  gf_apply launches on the main path: {launches}")
    if launches == 0:
        fail("the main path never launched gf_apply")

    log("phase 4: times")
    times = measure(torch, dev, ctx)
    enc = times["encode"]

    log("phase 5: the PG backend path")
    G.apply_matrix_gf.launches = 0
    backend = backend_path(torch, dev)
    launches5 = backend["gf_apply_launches"]
    log("backend " + json.dumps(backend))
    kernels = [{
        "name": "gf_apply",
        "route": "cuda",
        "source": "ceph_tpu_torch/ops/csrc/gf_apply.cu",
        "replaces": "ceph_tpu/ops/pallas_gf.py:103",
        "launches": launches + launches5,
        "launches_by_phase": {"3": launches, "5": launches5},
        "max_abs_err": gf_check["max_abs_err"],
        "ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": None,
        "shape": enc["shape"],
        "decode": times["decode"],
        "ragged": times["ragged"],
    }]
    log("e2e " + json.dumps(times["e2e"]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
