"""launches_per_op: gf_apply and CRC32C kernel launches an op, from the
port's counters (apply_matrix_gf.launches, csum.kernels.launches) over
the untraced window."""


def read(ctx):
    if not ctx.ops:
        return None
    return (ctx.launches["gf_apply"] + ctx.launches["crc32c"]) / ctx.ops
