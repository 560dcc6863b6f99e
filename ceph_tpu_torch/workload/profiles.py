"""Tenant traffic profiles — the declarative workload grammar (r20).

A profile is a plain dict (JSON-serializable, committed verbatim into
the bench artifact) describing ONE tenant's traffic: op-size mix,
read/write ratio, write routing mode, object namespace + hotspot
skew, a temporal phase program (diurnal ramps, bursty duty cycles),
and the QoS knobs the run commits for it — an mClock
reservation/weight/limit profile and a per-tenant SLO rule fragment.

The grammar is deliberately closed-form: everything the op-stream
generator reads is in the profile + one integer seed, so a committed
artifact's `profiles` block + `config.seed` replays the exact op
streams (streams.OpStream digests pin this bit-exactly).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

# write routing modes — the block-path decision the engine makes per
# op (ref: the r16 partial-stripe work; ISSUE r20 item 1):
#   overwrite: small in-place patches via write_at (parity-delta RMW)
#   append:    tail appends via the rados append op (no-preread path)
#   full:      whole-object rewrites (full-stripe encode — streaming)
WRITE_MODES = ("overwrite", "append", "full")

PHASE_KINDS = ("steady", "ramp", "burst")


@dataclass
class Phase:
    """One segment of a tenant's temporal program.

    kind=steady: constant `scale` x base iops.
    kind=ramp:   linear `from_scale` -> `to_scale` over the segment —
                 the diurnal ramp primitive (chain two for a day).
    kind=burst:  square wave, `on_scale` for duty*period then
                 `off_scale` — the bursty-neighbor primitive.
    duration_s=0 means "the rest of the run"; the program cycles if
    it ends before the run does.
    """

    kind: str = "steady"
    duration_s: float = 0.0
    scale: float = 1.0          # steady
    from_scale: float = 1.0     # ramp
    to_scale: float = 1.0       # ramp
    period_s: float = 1.0       # burst
    duty: float = 0.5           # burst: fraction of period at on_scale
    on_scale: float = 1.0       # burst
    off_scale: float = 0.0      # burst

    def __post_init__(self):
        if self.kind not in PHASE_KINDS:
            raise ValueError(f"bad phase kind {self.kind!r} "
                             f"(want one of {PHASE_KINDS})")
        if self.duration_s < 0:
            raise ValueError("phase duration_s must be >= 0")
        if self.kind == "burst":
            if self.period_s <= 0 or not (0.0 < self.duty <= 1.0):
                raise ValueError("burst phase needs period_s > 0 and "
                                 "0 < duty <= 1")
        for v in (self.scale, self.from_scale, self.to_scale,
                  self.on_scale, self.off_scale):
            if v < 0:
                raise ValueError("phase scales must be >= 0")

    def scale_at(self, t: float) -> float:
        """Rate multiplier `t` seconds into THIS phase."""
        if self.kind == "steady":
            return self.scale
        if self.kind == "ramp":
            if self.duration_s <= 0:
                return self.to_scale
            f = min(1.0, max(0.0, t / self.duration_s))
            return self.from_scale + f * (self.to_scale
                                          - self.from_scale)
        # burst
        return self.on_scale if (t % self.period_s) \
            < self.duty * self.period_s else self.off_scale

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "duration_s": self.duration_s}
        if self.kind == "steady":
            d["scale"] = self.scale
        elif self.kind == "ramp":
            d["from_scale"] = self.from_scale
            d["to_scale"] = self.to_scale
        else:
            d.update(period_s=self.period_s, duty=self.duty,
                     on_scale=self.on_scale, off_scale=self.off_scale)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Phase":
        known = {f for f in cls.__dataclass_fields__}   # noqa: C416
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown phase keys {sorted(bad)}")
        return cls(**d)


@dataclass
class TenantProfile:
    """One tenant's declarative traffic contract.

    `name` becomes the cephx entity `client.<name>` — the identity
    every OSD's mClock keys its `tenant:<entity>` class on, the
    telemetry plane keys its latency ring on, and the SLO qualifier
    names. `mclock` ('res,wgt,lim', ops/s-space) is committed into
    osd_mclock_scheduler_tenant_profiles; `slo` is a
    client_observed_* rule fragment the engine suffixes with
    `[tenant=client.<name>]`.
    """

    name: str
    klass: str = "interactive"       # free-form label in the artifact
    iops: float = 20.0               # base op rate (phases scale it)
    read_fraction: float = 0.5
    op_size: int | tuple[int, int] = 1024       # bytes (or [lo, hi])
    write_mode: str = "overwrite"
    objects: int = 8                 # namespace width
    object_size: int = 8192          # staged size (overwrite bounds)
    hotspot_fraction: float = 0.0    # ops drawn to the hot set
    hotspot_objects: int = 1         # hot-set width
    phases: list[Phase] = field(default_factory=lambda: [Phase()])
    mclock: str | None = None        # 'res,wgt,lim' or None (default)
    slo: str | None = None           # e.g. 'client_observed_p99 < ...'

    def __post_init__(self):
        if not self.name or not str(self.name).replace("-", "") \
                .replace("_", "").replace(".", "").isalnum():
            raise ValueError(f"bad tenant name {self.name!r}")
        if self.write_mode not in WRITE_MODES:
            raise ValueError(f"bad write_mode {self.write_mode!r} "
                             f"(want one of {WRITE_MODES})")
        if isinstance(self.op_size, (list, tuple)):
            lo, hi = (int(v) for v in self.op_size)
            if not (0 < lo <= hi):
                raise ValueError(f"bad op_size range {self.op_size!r}")
            self.op_size = (lo, hi)
        elif int(self.op_size) <= 0:
            raise ValueError("op_size must be > 0")
        if not (0.0 <= self.read_fraction <= 1.0):
            raise ValueError("read_fraction must be in [0, 1]")
        if self.iops <= 0:
            raise ValueError("iops must be > 0")
        if self.objects < 1 or self.object_size < 1:
            raise ValueError("objects/object_size must be >= 1")
        if not (0.0 <= self.hotspot_fraction <= 1.0):
            raise ValueError("hotspot_fraction must be in [0, 1]")
        if self.hotspot_objects < 1:
            raise ValueError("hotspot_objects must be >= 1")
        if not self.phases:
            raise ValueError("profile needs at least one phase")
        max_sz = self.op_size[1] if isinstance(self.op_size, tuple) \
            else int(self.op_size)
        if self.write_mode == "overwrite" and max_sz \
                > self.object_size:
            raise ValueError(f"overwrite op_size {max_sz} exceeds "
                             f"object_size {self.object_size}")
        if self.mclock is not None:
            # fail at parse time, not when the table hits the OSDs
            from ..osd.scheduler import parse_profile
            parse_profile(self.mclock)

    @property
    def entity(self) -> str:
        return f"client.{self.name}"

    def max_scale(self) -> float:
        """Peak phase multiplier — the thinning envelope the stream
        generator draws candidate arrivals at."""
        peak = 0.0
        for ph in self.phases:
            if ph.kind == "steady":
                peak = max(peak, ph.scale)
            elif ph.kind == "ramp":
                peak = max(peak, ph.from_scale, ph.to_scale)
            else:
                peak = max(peak, ph.on_scale, ph.off_scale)
        return max(peak, 1e-9)

    def scale_at(self, t: float) -> float:
        """Rate multiplier `t` seconds into the run: walk the phase
        program, cycling when it is shorter than the run."""
        total = sum(ph.duration_s for ph in self.phases)
        rest = [ph for ph in self.phases if ph.duration_s <= 0]
        if total > 0 and not rest:
            t = t % total
        for ph in self.phases:
            if ph.duration_s <= 0:     # "rest of the run"
                return ph.scale_at(t)
            if t < ph.duration_s:
                return ph.scale_at(t)
            t -= ph.duration_s
        return self.phases[-1].scale_at(t)

    def to_dict(self) -> dict:
        return {
            "name": self.name, "klass": self.klass,
            "iops": self.iops, "read_fraction": self.read_fraction,
            "op_size": list(self.op_size)
            if isinstance(self.op_size, tuple) else self.op_size,
            "write_mode": self.write_mode,
            "objects": self.objects,
            "object_size": self.object_size,
            "hotspot_fraction": self.hotspot_fraction,
            "hotspot_objects": self.hotspot_objects,
            "phases": [ph.to_dict() for ph in self.phases],
            "mclock": self.mclock, "slo": self.slo,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TenantProfile":
        known = {f for f in cls.__dataclass_fields__}   # noqa: C416
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown profile keys {sorted(bad)}")
        d = dict(d)
        if "phases" in d:
            d["phases"] = [Phase.from_dict(p) if isinstance(p, dict)
                           else p for p in d["phases"]]
        return cls(**d)


def parse_profiles(spec) -> list[TenantProfile]:
    """JSON text / list-of-dicts -> validated profiles. Duplicate
    tenant names are an error (the entity is the identity key
    everywhere downstream)."""
    if isinstance(spec, str):
        spec = json.loads(spec)
    if isinstance(spec, dict):
        spec = [spec]
    out = [p if isinstance(p, TenantProfile)
           else TenantProfile.from_dict(p) for p in spec]
    names = [p.name for p in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names in {names}")
    return out


# The committed 4-tenant mix (the WORKLOAD_r20 cast): a latency-
# sensitive interactive tenant on a diurnal ramp, a streaming tenant
# pushing full stripes, a bursty small-op tenant riding the append
# path, and a deliberately misbehaving noisy neighbor — high-rate
# hotspot overwrites under a LOW mClock limit, so the throttle
# attribution (not just its latency) shows who the cluster is
# holding back.
BUILTIN_PROFILES: dict[str, dict] = {
    "interactive": {
        "name": "interactive", "klass": "interactive",
        "iops": 30.0, "read_fraction": 0.7,
        "op_size": [512, 2048], "write_mode": "overwrite",
        "objects": 16, "object_size": 8192,
        "phases": [{"kind": "ramp", "duration_s": 0.0,
                    "from_scale": 0.6, "to_scale": 1.4}],
        "slo": "client_observed_p99 < 2500ms over 60s",
    },
    "streaming": {
        "name": "streaming", "klass": "streaming",
        "iops": 8.0, "read_fraction": 0.25,
        "op_size": 16384, "write_mode": "full",
        "objects": 6, "object_size": 16384,
        "phases": [{"kind": "steady", "scale": 1.0}],
        "slo": "client_observed_p99 < 2500ms over 60s",
    },
    "bursty": {
        "name": "bursty", "klass": "bursty",
        "iops": 25.0, "read_fraction": 0.3,
        "op_size": [256, 1024], "write_mode": "append",
        "objects": 8, "object_size": 4096,
        "phases": [{"kind": "burst", "duration_s": 0.0,
                    "period_s": 1.0, "duty": 0.35,
                    "on_scale": 2.5, "off_scale": 0.2}],
        "slo": "client_observed_p99 < 2500ms over 60s",
    },
    "noisy": {
        "name": "noisy", "klass": "noisy",
        "iops": 220.0, "read_fraction": 0.1,
        "op_size": 512, "write_mode": "overwrite",
        "objects": 8, "object_size": 4096,
        "hotspot_fraction": 0.8, "hotspot_objects": 2,
        "phases": [{"kind": "steady", "scale": 1.0}],
        # the misbehavior contract: demand ~220 ops/s, granted 25 —
        # its tenant class goes limit-bound and the r20 throttle
        # counter attributes the backpressure to IT by name
        "mclock": "5,1,25",
        "slo": "client_observed_p99 < 20ms over 60s",
    },
}


def builtin_mix(names=None) -> list[TenantProfile]:
    """The named builtin profiles (default: all four), validated."""
    names = list(names) if names else list(BUILTIN_PROFILES)
    missing = [n for n in names if n not in BUILTIN_PROFILES]
    if missing:
        raise ValueError(f"unknown builtin profiles {missing} "
                         f"(have {sorted(BUILTIN_PROFILES)})")
    return parse_profiles([BUILTIN_PROFILES[n] for n in names])
