"""write_GBps: client object bytes of every op the window completed,
over the window's wall time (host clock), in 1e9 bytes a second."""


def read(ctx):
    if not ctx.op.client_bytes_per_op:
        return None
    return ctx.ops * ctx.op.client_bytes_per_op / ctx.window_s / 1e9
