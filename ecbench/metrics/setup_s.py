"""setup_s: seconds from the process's start to the window's: imports,
the CUDA context, the kernels' build (first run in a checkout) and
load, the pool made and written, every shape warmed."""


def read(ctx):
    return ctx.setup_s
