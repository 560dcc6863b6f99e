"""recovery_objps: objects whose lost shard was rebuilt and verified in
the window, over its wall time (host clock). The objects an op's rotted
helper bytes fail (the mix's corrupt_per_op) are not rebuilt and do not
count."""


def read(ctx):
    if ctx.op.kind != "recover":
        return None
    return ctx.ops * ctx.op.rebuilt_per_op / ctx.window_s
