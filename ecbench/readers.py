"""Reductions that more than one metric file reads: a quantity split by
the cells it is read in (`glue_ms.write`, `glue_ms.recover`) is one
file a name, each returning what the function here works out. A
function that finds nothing to read returns None."""

from ecbench.peaks import crc_bound, gf_bound
from ecbench.trace import CRC_KERNEL, GF_KERNEL


def glue_ms(ctx):
    """Device ms an op outside gf_apply and CRC32C (the recovery
    program's helper fold, small cats, copies), from the traced window:
    every device entry's time but the two kernels', over its ops."""
    t = ctx.trace
    if t is None or not ctx.trace_ops:
        return None
    total, _ = t.device_ms()
    if total == 0:
        return None
    gf, _ = t.device_ms(GF_KERNEL)
    crc, _ = t.device_ms(CRC_KERNEL)
    return (total - gf - crc) / ctx.trace_ops


def gf_apply_roofline(ctx):
    """The GF kernel's share of its bound, %: the bound (peaks.gf_bound
    at each launch's shape and its matrix's non-zero coefficients, the
    matrix worked out by the reference) over the device time, both per
    launch, over the traced window's gf_apply launches."""
    t = ctx.trace
    if t is None:
        return None
    ms, seen = t.device_ms(GF_KERNEL)
    shapes = ctx.trace_counts["gf_shapes"]
    launched = sum(shapes.values())
    if not seen or not launched:
        return None
    mats = {(M.shape[1], M.shape[0]): (B, int((M != 0).sum()))
            for B, M in ctx.op.gf_matrices()}
    bound = 0.0
    for (k, m, L, _vec), count in shapes.items():
        if (k, m) not in mats:
            return None
        B, nnz = mats[(k, m)]
        bound += count * gf_bound(B, k, m, L, nnz)[0]
    return 100 * (bound / launched) / (ms / seen)


def crc32c_roofline(ctx):
    """The CRC32C kernel's share of its bound, %: the bound
    (peaks.crc_bound over each launch's row sets, from the port's shape
    counter) over the device time, both per launch, over the traced
    window's crc32c launches."""
    t = ctx.trace
    if t is None:
        return None
    ms, seen = t.device_ms(CRC_KERNEL)
    shapes = ctx.trace_counts["crc_shapes"]
    launched = sum(shapes.values())
    if not seen or not launched:
        return None
    bound = 0.0
    for key, count in shapes.items():
        sets = [tuple(int(v) for v in s.split(",")[:2])
                for s in key.split("+")]
        bound += count * crc_bound(sets)[0]
    return 100 * (bound / launched) / (ms / seen)


def idle_share(ctx):
    """The share of the traced window in which the device ran nothing:
    1 - the union of its entries' intervals over the window."""
    t = ctx.trace
    if t is None or not t.device:
        return None
    return 1 - t.busy_s / t.window_s
