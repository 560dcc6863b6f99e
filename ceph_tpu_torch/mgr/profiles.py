"""Profile aggregation — cluster CPU flame profiles from per-daemon
sampling rings (r19).

The mgr half of the continuous-profiling plane (mgr/telemetry.py's
role for counters, played for folded stacks): daemons tick their
SamplingProfiler's interval-aligned stack deltas and ship fresh
entries in MgrReports (`profile` field); every monitor independently
folds them into

* a CUMULATIVE per-daemon flame profile (fold of every shipped delta
  — survives daemon ring eviction, horizon bounded only by monitor
  uptime),
* a CLUSTER flame profile that is the EXACT integer fold of the
  per-daemon ones (merge of merges == merge of all — the r18
  bit-exact-merge rule, pinned by tests), and
* a bounded per-interval series of category splits (attribution
  drift over time, aligned across daemons by the shared-clock bucket
  index like the telemetry plane).

Served as `profile cpu [daemon] [--collapsed|--speedscope]` (mon cmd
+ asok + `ceph_cli flame`): the default view is a category self-time
split + top stacks, `--collapsed` is folded-stack text (flamegraph.pl
/ speedscope import), `--speedscope` a complete speedscope JSON
document.
"""

from __future__ import annotations

import threading
import time

from ..utils.profiler import (PROFILE_CATEGORIES, category_split,
                              collapsed_lines, merge_stacks, speedscope,
                              top_stacks)

__all__ = ["ProfileAggregator"]

#: per-category distinct-stack cap per daemon: past it the smallest
#: counts fold into a "..." catch-all stack (disclosed via
#: stacks_folded, never silently dropped — sample totals are exact)
MAX_STACKS = 4096


class ProfileAggregator:
    def __init__(self, config=None, now_fn=time.time):
        self._config = config
        self._now = now_fn
        self._lock = threading.Lock()
        # name -> {"stacks", "samples", "busy_s", "hz", "last_t",
        #          "entries", "dropped_unshipped", "stacks_folded"}
        self._daemons: dict[str, dict] = {}
        # bucket -> {"t", "interval_s", "samples", "categories",
        #            "daemons": set}
        self._intervals: dict[int, dict] = {}

    def _opt(self, name: str, fallback):
        if self._config is not None:
            try:
                return self._config.get(name)
            except (KeyError, ValueError, TypeError):
                pass
        return fallback

    @property
    def max_intervals(self) -> int:
        return int(self._opt("mgr_history_len", 90))

    # -- ingestion (the MgrReport `profile` field) -------------------------

    def ingest(self, name: str, block: dict) -> None:
        """Fold one daemon's shipped profile block: interval entries
        (stack deltas) + the sampler's accounting stats."""
        if not isinstance(block, dict):
            return
        with self._lock:
            d = self._daemons.setdefault(name, {
                "stacks": {}, "samples": 0, "busy_s": 0.0,
                "hz": 0.0, "last_t": 0.0, "entries": 0,
                "dropped_unshipped": 0, "idle_samples": 0,
                "stacks_folded": 0})
            for ent in block.get("entries") or []:
                try:
                    stacks = ent.get("stacks") or {}
                    d["stacks"] = merge_stacks((d["stacks"], stacks))
                    d["samples"] += int(ent.get("samples", 0))
                    d["busy_s"] += float(ent.get("busy_s", 0.0))
                    d["hz"] = float(ent.get("hz", d["hz"]))
                    d["last_t"] = max(d["last_t"],
                                      float(ent.get("t", 0.0)))
                    d["entries"] += 1
                    self._fold_interval(name, ent, stacks)
                except (TypeError, ValueError):
                    continue     # one malformed entry never poisons
            self._trim_daemon(d)
            stats = block.get("stats")
            if isinstance(stats, dict):
                try:
                    d["dropped_unshipped"] = int(
                        stats.get("dropped_unshipped", 0))
                    d["idle_samples"] = int(
                        stats.get("idle_samples", 0))
                    d["hz"] = float(stats.get("hz", d["hz"]))
                except (TypeError, ValueError):
                    pass
            self._trim_intervals()

    def _fold_interval(self, name: str, ent: dict, stacks: dict) -> None:
        b = int(ent.get("bucket", 0))
        iv = self._intervals.setdefault(b, {
            "t": float(ent.get("t", 0.0)),
            "interval_s": float(ent.get("interval_s", 0.0)),
            "samples": 0,
            "categories": {c: 0 for c in PROFILE_CATEGORIES},
            "daemons": set()})
        iv["samples"] += int(ent.get("samples", 0))
        for cat, n in category_split(stacks).items():
            iv["categories"][cat] = iv["categories"].get(cat, 0) + n
        iv["daemons"].add(name)

    def _trim_daemon(self, d: dict) -> None:
        for bucket in d["stacks"].values():
            over = len(bucket) - MAX_STACKS
            if over <= 0:
                continue
            victims = sorted(bucket, key=lambda s: (bucket[s], s))
            folded = 0
            for stk in victims[:over]:
                folded += bucket.pop(stk)
            bucket["..."] = bucket.get("...", 0) + folded
            d["stacks_folded"] += over

    def _trim_intervals(self) -> None:
        over = len(self._intervals) - self.max_intervals
        if over > 0:
            for b in sorted(self._intervals,
                            key=lambda b: self._intervals[b]["t"])[:over]:
                del self._intervals[b]

    # -- views -------------------------------------------------------------

    def daemons(self) -> list[str]:
        with self._lock:
            return sorted(self._daemons)

    def flame(self, daemon: str | None = None) -> dict:
        """Merged {category: {stack: n}} — one daemon's cumulative
        profile, or the cluster fold of every daemon's (EXACT integer
        add, so cluster == merge of per-daemon merges)."""
        with self._lock:
            if daemon is not None:
                d = self._daemons.get(daemon)
                return {c: dict(s) for c, s in
                        (d["stacks"] if d else {}).items()}
            return merge_stacks(d["stacks"]
                                for d in self._daemons.values())

    def stats(self) -> dict:
        """Per-daemon sampler accounting (samples, hz, ring drops) —
        the `ceph_cli top` drop-gauge feed."""
        with self._lock:
            return {name: {"samples": d["samples"],
                           "idle_samples": d["idle_samples"],
                           "hz": d["hz"],
                           "entries": d["entries"],
                           "dropped_unshipped": d["dropped_unshipped"],
                           "stacks_folded": d["stacks_folded"],
                           "sampler_busy_s": round(d["busy_s"], 6)}
                    for name, d in sorted(self._daemons.items())}

    def intervals(self, limit: int = 16) -> list[dict]:
        """Newest-last per-interval category splits (the drift
        series), wall-time ordered like the telemetry plane."""
        with self._lock:
            bs = sorted(self._intervals,
                        key=lambda b: self._intervals[b]["t"])
            out = []
            for b in bs[-int(limit):]:
                iv = self._intervals[b]
                out.append({"bucket": b, "t": iv["t"],
                            "interval_s": iv["interval_s"],
                            "samples": iv["samples"],
                            "categories": dict(iv["categories"]),
                            "daemons": sorted(iv["daemons"])})
            return out

    def dump(self, daemon: str | None = None, top_n: int = 10) -> dict:
        """The `profile cpu [daemon]` body: category split + top
        stacks + per-daemon accounting + the drift series."""
        stacks = self.flame(daemon)
        split = category_split(stacks)
        total = sum(split.values())
        return {
            "daemon": daemon or "cluster",
            "daemons": self.daemons(),
            "samples": total,
            "categories": split,
            "category_share": {c: round(v / total, 4) if total else 0.0
                               for c, v in split.items()},
            "top_stacks": top_stacks(stacks, n=top_n),
            "stats": self.stats(),
            "intervals": self.intervals(),
        }

    # -- the command surface ----------------------------------------------

    def cpu_cmd(self, arg: str = "") -> dict:
        """`profile cpu [daemon] [--collapsed|--speedscope]` — ONE
        parser for the mon cmd, the asok, and ceph_cli flame."""
        daemon = None
        want = "summary"
        for word in (arg or "").split():
            if word == "--collapsed":
                want = "collapsed"
            elif word == "--speedscope":
                want = "speedscope"
            elif word.startswith("--"):
                raise ValueError(f"profile cpu: unknown flag {word!r}")
            else:
                daemon = word
        if daemon is not None and daemon not in self.daemons():
            return {"daemon": daemon, "found": False,
                    "daemons": self.daemons()}
        if want == "collapsed":
            return {"daemon": daemon or "cluster", "found": True,
                    "collapsed": collapsed_lines(self.flame(daemon))}
        if want == "speedscope":
            return {"daemon": daemon or "cluster", "found": True,
                    "speedscope": speedscope(
                        self.flame(daemon),
                        name=f"{daemon or 'cluster'} cpu")}
        return {"found": True, **self.dump(daemon)}
