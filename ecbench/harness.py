"""The benchmark's harness: find a cell's files by name, set it up, run
its window, read its metrics and check its outputs.

Everything that belongs to one configuration, traffic mix, op kind or
metric is a file of its own, found by the name in BENCHMARK.json:
`ecbench/configs/<config>.json` (the manifest's `file`),
`ecbench/traffic/<mix>.json`, `ecbench/ops/<op>.py` (the mix's "op")
and `ecbench/metrics/<metric>.py`, the whole name (`glue_ms.write.py`).
Op kinds and metric readers are loaded the same way, from their file.

The window is a closed loop: an op is handed to the port, a CUDA event
recorded behind it, and once `in_flight` ops are out the loop waits for
the oldest. An op's latency runs from its hand-off to the moment the
host sees its event complete. Every op the window starts is waited for
before it closes, and all of them count.
"""

from __future__ import annotations

import collections
import contextlib
import importlib.util
import json
import random
import sys
import time
import traceback
import types
from pathlib import Path

import torch

from . import ops as ops_pkg
from . import trace as tr

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_SECONDS = 2.0     # length of a --trace 1 run's traced window
FORBIDDEN = ("jax", "jaxlib", "flax", "ceph_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ------------------------------------------------------------ discovery

def manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str, root: Path = ROOT) -> dict:
    entry = next(c for c in man["configs"] if c["name"] == name)
    return json.loads((Path(root) / entry["file"]).read_text())


def mix(name: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "ecbench" / "traffic" /
                       f"{name}.json").read_text())


_LOADED: dict = {}


def _load(folder: str, name: str, root: Path = ROOT):
    """The module in `ecbench/<folder>/<name>.py` under `root`, loaded
    from its file once a process."""
    path = (Path(root) / "ecbench" / folder / f"{name}.py").resolve()
    if path not in _LOADED:
        if not path.exists():
            raise FileNotFoundError(f"no {path.name} in {path.parent}")
        spec = importlib.util.spec_from_file_location(
            f"ecbench_{folder}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def op_kind(name: str, root: Path = ROOT):
    return _load("ops", name, root)


def metrics_of(man: dict, cell_name: str, trace: bool) -> list:
    """The manifest's metric entries this cell reports: the end-to-end
    ones, or with `trace` the per-layer ones. A metric without a
    `workloads` key goes to every cell that reports what it moves."""
    e2e = [m for m in man["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell_name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)]


def reader(name: str, root: Path = ROOT):
    """The `read(ctx)` function of a metric, loaded from its file."""
    return _load("metrics", name, root).read


# --------------------------------------------------------------- window

def _launches() -> tuple:
    from ceph_tpu_torch.csum import kernels as csum
    from ceph_tpu_torch.ops.gf_kernel import apply_matrix_gf
    return (apply_matrix_gf.launches, csum.launches["crc32c"],
            collections.Counter(apply_matrix_gf.by_shape),
            collections.Counter(csum.shapes))


def _delta(before: tuple, after: tuple) -> dict:
    return {"gf_apply": after[0] - before[0],
            "crc32c": after[1] - before[1],
            "gf_shapes": after[2] - before[2],
            "crc_shapes": after[3] - before[3]}


class Sample:
    """A uniform sample of `size` ops' outputs over the window, drawn
    from the seed (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.kept = size, 0, []
        self.rng = random.Random(ops_pkg.subseed(seed, "sample"))

    def offer(self, i: int, outs) -> None:
        if len(self.kept) < self.size:
            self.kept.append((i, outs))
        else:
            r = self.rng.randrange(self.seen + 1)
            if r < self.size:
                self.kept[r] = (i, outs)
        self.seen += 1


def drive(op, seconds: float, in_flight: int, first: int = 0,
          min_ops: int = 0, sample: Sample | None = None,
          spans: list | None = None) -> dict:
    """Run ops first, first+1, ... for `seconds` (and at least `min_ops`
    of them), `in_flight` at a time; every op started is waited for.
    With `spans`, each op's hand-off and wait are appended to it as
    (name, start ns, end ns) on the Unix clock the profiler's trace
    uses."""
    cuda = op.device.type == "cuda"
    events = [torch.cuda.Event() for _ in range(in_flight + 1)] \
        if cuda else None
    pending: collections.deque = collections.deque()
    lat: list = []
    res = {"failed": 0, "submit_s": 0.0}

    def finish():
        i, t0, ev, outs = pending.popleft()
        w0 = time.time_ns() if spans is not None else 0
        if ev is not None:
            ev.synchronize()
        lat.append(time.perf_counter() - t0)
        if spans is not None:
            spans.append((tr.WAIT, w0, time.time_ns()))
        if sample is not None:
            sample.offer(i, outs)

    i = first
    start = time.perf_counter()
    end = start + seconds
    while i - first < min_ops or time.perf_counter() < end:
        s0 = time.time_ns() if spans is not None else 0
        t0 = time.perf_counter()
        try:
            outs = op.entry(*op.inputs(i))
        except Exception:   # noqa: BLE001 — counted, shown once
            if res["failed"] == 0:
                log(traceback.format_exc())
            res["failed"] += 1
            i += 1
            continue
        ev = None
        if cuda:
            ev = events[i % len(events)]
            ev.record()
        res["submit_s"] += time.perf_counter() - t0
        if spans is not None:
            spans.append((tr.SUBMIT, s0, time.time_ns()))
        pending.append((i, t0, ev, outs))
        del outs
        if len(pending) >= in_flight:
            finish()
        i += 1
    while pending:
        finish()
    res["window_s"] = time.perf_counter() - start
    res["ops"] = len(lat)
    res["attempted"] = i - first
    res["latencies"] = lat
    res["next"] = i
    return res


# ------------------------------------------------------------------ run

def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float | None = None,
             root: Path = ROOT, adjust=None, overrides: dict | None = None
             ) -> dict:
    """One run of a cell: set-up, window (and with `trace` a traced
    window after it), the sampled outputs checked, the result line as a
    dict. `adjust(op)` may change the op after set-up (the tests'
    controls and faults); `overrides` = {"config": {...}, "mix": {...}}
    shrinks a cell for the CPU tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest(root)
    c = cell(man, name)
    cfg = config(man, c["config"], root)
    mx = mix(c["traffic"], root)
    cfg.update((overrides or {}).get("config", {}))
    mx.update((overrides or {}).get("mix", {}))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    op = op_kind(mx["op"], root).Op(cfg, mx, seed, device)
    if adjust is not None:
        adjust(op)
    warm = drive(op, 0.0, mx["in_flight"], min_ops=mx["warm_ops"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"cell {name}: config {c['config']}, mix {c['traffic']}, batch "
        f"{op.batch}, {op.slices} op slices, set-up {setup_s:.3f} s "
        f"(warm-up {warm['ops']} ops)")

    sample = Sample(max(1, mx["check_objects"] // op.batch), seed)
    before = _launches()
    win = drive(op, seconds, mx["in_flight"], first=warm["next"],
                sample=sample)
    counts = _delta(before, _launches())
    ctx = types.SimpleNamespace(
        op=op, setup_s=setup_s, window_s=win["window_s"], ops=win["ops"],
        latencies=win["latencies"], submit_s=win["submit_s"],
        launches=counts, trace=None, trace_ops=0, trace_counts=None)
    lat = sorted(win["latencies"])
    if lat:
        log(f"window {win['window_s']:.6f} s: {win['ops']} ops, "
            f"{win['failed']} failed; op latency median "
            f"{lat[len(lat) // 2] * 1e3:.6f} ms over {len(lat)} ops; "
            f"host {win['submit_s'] / max(1, win['ops']) * 1e6:.3f} us "
            f"an op; launches {counts['gf_apply']} gf_apply, "
            f"{counts['crc32c']} crc32c")

    if trace:
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        before = _launches()
        spans: list = []
        # a CPU run has no device to trace: its trace holds no entry
        cm = profile(activities=[ProfilerActivity.CUDA], acc_events=True) \
            if device.type == "cuda" else contextlib.nullcontext()
        with cm as prof:
            tw = drive(op, min(TRACE_SECONDS, seconds), mx["in_flight"],
                       first=win["next"], spans=spans)
        ctx.trace_counts = _delta(before, _launches())
        ctx.trace_ops = tw["ops"]
        ctx.trace = tr.read(prof, tw["window_s"], spans)
        log(f"traced window: {tw['ops']} ops in {tw['window_s']:.6f} s; "
            f"{len(ctx.trace.device)} device entries; trace taken and "
            f"read in {time.perf_counter() - t0:.3f} s; first device "
            f"entry {ctx.trace.lead_us():.1f} us after the first "
            f"hand-off began")
        del prof

    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    results = {}
    for m in metrics_of(man, name, trace):
        v = reader(m["name"], root)(ctx)
        if v is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} "
                                   f"has no reading")
            continue
        results[m["name"]] = {"value": v, "unit": m["unit"]}

    # the program's state goes before the reference runs
    op.free()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = op.check(sample.kept)
    log(f"checked {len(sample.kept)} sampled ops "
        f"({len(sample.kept) * op.objects_per_op} objects) in "
        f"{time.perf_counter() - t0:.3f} s")
    correct = bool(sample.kept) and win["failed"] == 0 and all(
        v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": c["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["failed"], "metrics": results, "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        out["breakdown"] = {"device_ops": ctx.trace.by_name(),
                            "idle_gaps": ctx.trace.idle_gaps()}
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, (v, lim) in checks.items()}
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (whole names: ceph_tpu_torch is not ceph_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
