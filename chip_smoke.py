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
     run of back-to-back calls (warm, median per call), and the
     end-to-end encode GB/s, decode GB/s and recovery objects/s one
     call at a time, host overhead included.
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
    kernels = [{
        "name": "gf_apply",
        "route": "cuda",
        "source": "ceph_tpu_torch/ops/csrc/gf_apply.cu",
        "replaces": "ceph_tpu/ops/pallas_gf.py:103",
        "launches": launches,
        "max_abs_err": gf_check["max_abs_err"],
        "ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": None,
        "shape": enc["shape"],
        "decode": times["decode"],
    }]
    log("e2e " + json.dumps(times["e2e"]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
