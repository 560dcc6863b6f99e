"""op_p95_ms: the 95th percentile (nearest rank) of the window's op
latencies, hand-off to the port until the host sees the op's event
complete, in ms."""

import math


def read(ctx):
    lat = sorted(ctx.latencies)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
