"""The port's own spans in a `--trace 1` run.

After the harness's traced window the readers of the span metrics run
one more window of the same op, as long as the traced one, with the
port's span capture on (`ceph_tpu_torch.utils.tracing.Capture`) and
torch.profiler recording the card, and read both together:

- every device entry is attributed to the innermost port span open on
  the loop's thread when its launch record (the CUDA runtime call the
  profiler links to the entry by correlation id) began;
- a launch whose runtime call does not lie wholly inside its span's
  host interval is counted (a check that the two clocks agree: 0);
- each idle gap of the device is named `<harness span>:<port span>`,
  the harness's `submit` / `wait` / `harness` and the innermost port
  span open at the gap's start (`-` where none was).

The reading is worked out once a run and kept on the readers' context.
A port without the capture (an older commit) gives no reading and no
window. The harness's own windows and their metrics are untouched.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import threading
import time

import torch

from ecbench import harness as H
from ecbench.peaks import HBM_BYTES_PER_S
from ecbench.trace import Trace

FOLD = "ecbackend.recover_program.fold"
GC = "python.gc"


@dataclasses.dataclass
class Reading:
    ops: int
    window_s: float
    device_s: float                 # every device entry's time, summed
    by_span: dict                   # span name -> [device s, entries]
    attributed_s: float
    attributed: int                 # entries attributed to a port span
    outside: int                    # ... whose launch left its span
    unlinked: int                   # entries without a launch record
    fold_bytes: int                 # fold spans' bytes_in + bytes_out
    outer_host_s: float             # outermost port spans' host time
    gc: list                        # [python.gc spans, their host s]
    gaps: list                      # [[name, seconds]], longest first


def innermost(spans: list, times: list) -> list:
    """The innermost span open at each of `times` (None where none
    was): `spans` [(start, end, record)] of one thread, properly nested;
    `times` ascending. A sweep: spans enter a stack as their start
    passes and leave it once they have ended."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def attribute(records: list, device: list, launches: dict,
              harness: list, ops: int, window_s: float, tid: int,
              own: list = (), top: int = 10) -> Reading:
    """The reading of one window. `records`: the capture's SpanRecords;
    `device`: [(name, start ns, end ns, correlation id)]; `launches`:
    {correlation id: (start ns, end ns)} of the runtime calls;
    `harness`: the loop's spans [(name, start ns, end ns)]; `tid`: the
    native id of the thread that ran the loop; `own`: the profiler's
    own host work [(name, start ns, end ns)] (its buffer requests)."""
    mine = [r for r in records if r.tid == tid]
    spans = [(r.start_ns, r.end_ns, r) for r in mine]
    linked = sorted((launches[e[3]][0], i) for i, e in enumerate(device)
                    if e[3] in launches)
    owner = dict(zip((i for _, i in linked),
                     innermost(spans, [t for t, _ in linked])))
    by_span: dict = {}
    attributed_s = 0.0
    attributed = outside = 0
    for i, (name, a, b, corr) in enumerate(device):
        r = owner.get(i)
        if r is None:
            continue
        s = (b - a) / 1e9
        row = by_span.setdefault(r.name, [0.0, 0])
        row[0] += s
        row[1] += 1
        attributed_s += s
        attributed += 1
        l0, l1 = launches[corr]
        if not r.start_ns <= l0 <= l1 <= r.end_ns:
            outside += 1
    fold_bytes = sum(r.tags.get("bytes_in", 0) + r.tags.get("bytes_out", 0)
                     for r in mine if r.name == FOLD)
    outer = sum(r.end_ns - r.start_ns for r in mine
                if r.parent is None and r.name != GC) / 1e9
    return Reading(
        ops=ops, window_s=window_s,
        device_s=sum(b - a for _, a, b, _ in device) / 1e9,
        by_span=by_span, attributed_s=attributed_s, attributed=attributed,
        outside=outside, unlinked=sum(1 for e in device
                                      if e[3] not in launches),
        fold_bytes=fold_bytes, outer_host_s=outer,
        gc=[sum(1 for r in mine if r.name == GC),
            sum(r.end_ns - r.start_ns for r in mine if r.name == GC) / 1e9],
        gaps=named_gaps(device, spans, harness, own, top))


def named_gaps(device: list, spans: list, harness: list, own: list,
               top: int) -> list:
    """The `top` longest idle stretches of the device, longest first,
    as [["<harness span>:<port span>", seconds, the profiler's own host
    work that overlaps the gap ("+"-joined names, "" for none)]]."""
    merged = Trace(0.0, [e[:3] for e in device], []).busy()
    gaps = sorted(((merged[j][1], merged[j + 1][0])
                   for j in range(len(merged) - 1)),
                  key=lambda g: g[0] - g[1])[:top]
    at = sorted(a for a, _ in gaps)
    port = dict(zip(at, innermost(spans, at)))
    host = sorted(harness, key=lambda h: h[1])
    starts = [h[1] for h in host]
    out = []
    for a, b in gaps:
        j = bisect.bisect_right(starts, a) - 1
        outer = host[j][0] if j >= 0 and a < host[j][2] else "harness"
        r = port[a]
        mine = sorted({n for n, c, d in own if c < b and a < d})
        out.append([f"{outer}:{r.name if r is not None else '-'}",
                    (b - a) / 1e9, "+".join(mine)])
    return out


def _in_flight(ctx) -> int | None:
    """The cell's ops in flight: that of the mixes of the op's kind, if
    they agree (the readers' context does not name the cell's mix)."""
    vals = set()
    for p in (H.HERE / "traffic").glob("*.json"):
        mx = json.loads(p.read_text())
        if mx.get("op") == ctx.op.kind:
            vals.add(mx["in_flight"])
    return vals.pop() if len(vals) == 1 else None


def _events(prof) -> tuple[list, dict, list]:
    """(device entries [(name, start ns, end ns, correlation id)], the
    runtime calls that launched them {correlation id: (start, end)},
    the profiler's own host work [(name, start, end)])."""
    if prof is None:
        return [], {}, []
    cuda = torch.autograd.DeviceType.CUDA
    device, host, own = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((e.name(), e.start_ns(), e.end_ns(),
                               e.correlation_id()))
        elif e.name().startswith("cu"):     # a runtime or driver call
            host[e.correlation_id()] = (e.start_ns(), e.end_ns())
        else:
            own.append((e.name(), e.start_ns(), e.end_ns()))
    corrs = {e[3] for e in device}
    return device, {c: v for c, v in host.items() if c in corrs}, own


def reading(ctx) -> Reading | None:
    """The span window's reading, run once a run (None: no capture in
    the port, no traced run, or no op)."""
    if not hasattr(ctx, "port_spans"):
        ctx.port_spans = _run(ctx)
    return ctx.port_spans


def _run(ctx) -> Reading | None:
    if ctx.trace is None or not ctx.ops:
        return None
    from ceph_tpu_torch.utils import tracing
    if not hasattr(tracing, "Capture"):
        H.log("port spans: this port has no span capture; no reading")
        return None
    in_flight = _in_flight(ctx)
    if in_flight is None:
        H.log("port spans: the mixes of this op kind disagree on "
              "in_flight; no reading")
        return None
    op = ctx.op
    cuda = op.device.type == "cuda"
    seconds = min(H.TRACE_SECONDS, ctx.window_s)
    t0 = time.perf_counter()
    harness: list = []
    if cuda:
        from torch.profiler import ProfilerActivity, profile
        cm = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
    else:
        cm = contextlib.nullcontext()
    with cm as prof, tracing.Capture() as cap:
        win = H.drive(op, seconds, in_flight, spans=harness)
    device, launches, own = _events(prof)
    del prof
    r = attribute(cap.records, device, launches, harness, win["ops"],
                  win["window_s"], threading.get_native_id(), own)
    _log(ctx, r, win, time.perf_counter() - t0)
    return r


def _log(ctx, r: Reading, win: dict, took: float) -> None:
    untraced = ctx.ops / ctx.window_s
    traced = ctx.trace_ops / ctx.trace.window_s if ctx.trace_ops else 0
    mine = r.ops / r.window_s if r.ops else 0
    H.log(f"port spans: {r.ops} ops in {r.window_s:.6f} s with the "
          f"capture on, {mine:.3f} ops/s (untraced {untraced:.3f}, traced "
          f"without the capture {traced:.3f}); {win['failed']} failed; "
          f"window and reading {took:.3f} s")
    if r.device_s:
        H.log(f"port spans: attributed {r.attributed_s / r.device_s:.6%} "
              f"of {r.device_s:.6f} device s, {r.attributed} entries by "
              f"runtime launch records (correlation ids), {r.unlinked} "
              f"entries without one; launches outside their span's host "
              f"interval: {r.outside}")
    for name, (s, n) in sorted(r.by_span.items(), key=lambda kv: -kv[1][0]):
        H.log(f"port spans: {name}: {s / max(1, r.ops) * 1e3:.6f} device "
              f"ms, {n / max(1, r.ops):.3f} entries an op")
    H.log(f"port spans: host {r.outer_host_s / max(1, r.ops) * 1e6:.3f} "
          f"us an op in the outermost port spans; {r.gc[0]} collections "
          f"({GC}), {r.gc[1] * 1e3:.3f} ms")
    H.log(f"port spans: idle gaps {json.dumps(r.gaps)}")


# ----------------------------------------------------------- the metrics

def fold_ms(ctx):
    """Device ms an op attributed to the recovery program's fold span."""
    r = reading(ctx)
    if r is None or not r.ops or FOLD not in r.by_span:
        return None
    return r.by_span[FOLD][0] / r.ops * 1e3


def fold_roofline(ctx):
    """The fold's share of its HBM roofline, %: its spans' bytes
    (B*H*rl read, B*rl written) at 3.35 TB/s over its device time."""
    r = reading(ctx)
    if r is None or FOLD not in r.by_span or not r.fold_bytes:
        return None
    return 100 * (r.fold_bytes / HBM_BYTES_PER_S) / r.by_span[FOLD][0]


def kernels_per_op(ctx):
    """Device entries an op attributed to port spans."""
    r = reading(ctx)
    if r is None or not r.ops or not r.device_s:
        return None
    return r.attributed / r.ops


def port_host_us_per_op(ctx):
    """Host us an op inside the port's outermost spans, capture on."""
    r = reading(ctx)
    if r is None or not r.ops or not r.outer_host_s:
        return None
    return r.outer_host_s / r.ops * 1e6
