"""Seeded op-stream generation — the replay contract (r20).

One profile + one integer seed -> one op stream, generated entirely
up front from a dedicated `random.Random` keyed on (seed, tenant
name). Nothing execution-dependent feeds the generator (no wall
clock, no ack state, no thread timing), so the committed artifact's
`config.seed` + `profiles` block reproduces every tenant's stream
BIT-EXACTLY — `digest()` pins it, `--repro` checks it (the thrasher's
dedicated-stream discipline applied to traffic).

Arrival times come from a thinned non-homogeneous Poisson process:
candidates are drawn at the profile's peak rate, then accepted with
probability scale(t)/peak — which handles burst phases whose off
scale is 0 without the naive rate-inversion hang, and keeps the
draw count (hence the RNG stream) a pure function of the seed.
"""

from __future__ import annotations

import hashlib
import random
from typing import NamedTuple

from .profiles import TenantProfile


class Op(NamedTuple):
    """One generated op. `obj` is the tenant-namespace object index
    (the engine maps it to `wl-<tenant>-<obj>`); offset/size are
    bytes. kind is read | write_at | append | write_full."""

    t: float            # seconds from stream start
    kind: str
    obj: int
    offset: int
    size: int


_WRITE_KIND = {"overwrite": "write_at", "append": "append",
               "full": "write_full"}


class OpStream:
    """Deterministic op stream for one tenant profile."""

    def __init__(self, profile: TenantProfile, seed: int):
        self.profile = profile
        self.seed = int(seed)
        # string-seeded Random is stable across processes and runs
        # (unlike hash()-derived seeds under PYTHONHASHSEED); the
        # tenant name keys the stream so tenants never share draws
        self._rng_key = f"workload/{self.seed}/{profile.name}"

    def generate(self, duration_s: float) -> list[Op]:
        p = self.profile
        rng = random.Random(self._rng_key)
        peak_rate = p.iops * p.max_scale()
        max_scale = p.max_scale()
        lo, hi = p.op_size if isinstance(p.op_size, tuple) \
            else (int(p.op_size), int(p.op_size))
        ops: list[Op] = []
        t = 0.0
        while True:
            t += rng.expovariate(peak_rate)
            if t >= duration_s:
                break
            # thinning: accept at the phase program's local scale
            if rng.random() * max_scale > p.scale_at(t):
                continue
            is_read = rng.random() < p.read_fraction
            if p.hotspot_fraction and rng.random() \
                    < p.hotspot_fraction:
                obj = rng.randrange(min(p.hotspot_objects, p.objects))
            else:
                obj = rng.randrange(p.objects)
            size = rng.randint(lo, hi)
            if is_read:
                ops.append(Op(t, "read", obj, 0, p.object_size))
            elif p.write_mode == "overwrite":
                off = rng.randrange(p.object_size - size + 1)
                ops.append(Op(t, "write_at", obj, off, size))
            elif p.write_mode == "append":
                ops.append(Op(t, "append", obj, 0, size))
            else:           # full: whole-object streaming rewrite
                ops.append(Op(t, "write_full", obj, 0,
                              p.object_size))
        return ops

    @staticmethod
    def digest(ops: list[Op]) -> str:
        """Canonical sha256 over the stream — the bit-exact replay
        pin committed in the artifact's `streams` block. Times are
        fixed to nanosecond text so float repr drift can't fork the
        hex between Python builds."""
        h = hashlib.sha256()
        for op in ops:
            h.update(f"{op.t:.9f}|{op.kind}|{op.obj}|{op.offset}|"
                     f"{op.size}\n".encode())
        return h.hexdigest()

    @staticmethod
    def routed_counts(ops: list[Op]) -> dict:
        """Per-kind op counts — the block-path routing decision
        summary the artifact commits per tenant."""
        out = {"read": 0, "write_at": 0, "append": 0,
               "write_full": 0}
        for op in ops:
            out[op.kind] += 1
        return out


def payload_for(profile: TenantProfile, seed: int) -> bytes:
    """One deterministic max-op-size byte buffer per tenant (sliced
    per op by the engine): payload bytes ride the same replay
    contract as the op metadata without hashing megabytes per op."""
    rng = random.Random(f"workload-payload/{int(seed)}/"
                        f"{profile.name}")
    hi = profile.op_size[1] if isinstance(profile.op_size, tuple) \
        else int(profile.op_size)
    n = max(hi, profile.object_size)
    return rng.randbytes(n)
