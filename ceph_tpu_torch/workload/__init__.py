"""Multi-tenant workload engine (r20).

Declarative, seed-deterministic tenant traffic profiles driving the
block path end-to-end: `profiles` is the JSON/dict grammar (op-size
mix, read/write ratio, temporal phases, QoS class), `streams` turns a
profile + seed into a replayable op stream with a bit-exact digest,
and `engine` executes N tenants concurrently against a live
cephx+secure cluster — small overwrites through the r16
write_at/append fast path, streaming writes through full stripes —
while feeding per-tenant latency into the r18 telemetry plane and
reading back the r20 per-tenant mClock throttle attribution.
"""

from .engine import WorkloadEngine, percentiles
from .profiles import (BUILTIN_PROFILES, Phase, TenantProfile,
                       builtin_mix, parse_profiles)
from .streams import Op, OpStream

__all__ = ["TenantProfile", "Phase", "parse_profiles",
           "builtin_mix", "BUILTIN_PROFILES", "Op", "OpStream",
           "WorkloadEngine", "percentiles"]
