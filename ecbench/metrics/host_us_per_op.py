"""host_us_per_op: host microseconds an op spends handing its work to
the port (the entry's call and the event record, no wait), over the
untraced window."""


def read(ctx):
    if not ctx.ops:
        return None
    return ctx.submit_s / ctx.ops * 1e6
