"""Cache tiering — a writeback cache pool overlaying a base pool.

Rebuild of the reference's cache-tier machinery (ref:
src/osd/PrimaryLogPG.cc maybe_handle_cache_detail — proxy vs promote
decision on a cache miss; agent_work / agent_maybe_flush /
agent_maybe_evict — the tiering agent draining dirty objects and
evicting cold clean ones against target_max_bytes ratios; whiteout
objects carrying deletes down to the base tier; HitSet recency
tracking. Operator surface ref: src/mon/OSDMonitor.cc `osd tier add /
cache-mode / set-overlay` and the pool's cache_target_dirty_ratio /
cache_target_full_ratio options).

TPU-first reshaping: the reference's agent visits objects one at a
time through PrimaryLogPG ops; here flush IS the batched write path —
the agent collects the coldest dirty objects and hands the whole set
to the base pool's `write()` in one call, so a flush of B objects is
ONE batched EC encode launch (SURVEY §2.7 P2), and eviction is a
single batched remove. Promotion likewise rides the cache pool's
batched write.

Scope (matching SURVEY §2.3's "context beyond the EC slice" marker):
writeback mode only (the reference's readonly/readproxy/forward modes
are degenerate cases of the same plumbing), full-object granularity,
one overlay per base pool.
"""

from __future__ import annotations

import numpy as np

from ..utils.perf_counters import PerfCountersBuilder
from .stripe import as_flat_u8


class CacheTier:
    """Writeback overlay: clients address THIS object (the librados
    IoCtx keeps talking to the base pool name; the overlay redirect is
    the reference's `osd tier set-overlay`)."""

    def __init__(self, base, cache,
                 target_max_bytes: int = 64 << 20,
                 dirty_ratio: float = 0.4,
                 full_ratio: float = 0.8,
                 promote_after_hits: int = 2,
                 hit_set_period: float = 60.0):
        if not (0.0 < dirty_ratio <= full_ratio <= 1.0):
            raise ValueError("need 0 < dirty_ratio <= full_ratio <= 1")
        self.base = base
        self.cache = cache
        self.target_max_bytes = int(target_max_bytes)
        self.dirty_ratio = float(dirty_ratio)
        self.full_ratio = float(full_ratio)
        self.promote_after_hits = int(promote_after_hits)
        self.hit_set_period = float(hit_set_period)
        # per-object cache state: dirty bit + last-touch tick + size.
        # A WHITEOUT is a cache entry recording a delete that has not
        # reached the base yet (ref: object_info_t FLAG_WHITEOUT).
        self._dirty: dict[str, bool] = {}
        self._size: dict[str, int] = {}
        self._touch: dict[str, int] = {}
        self._whiteout: set[str] = set()
        self._tick = 0
        # running byte counters: the agent runs per write and must
        # not pay an O(objects) dict scan each time
        self._cache_bytes = 0
        self._dirty_bytes = 0
        # HitSet: miss counters over a sliding period (ref: HitSet
        # bloom persistence — a dict stands in; decayed wholesale each
        # period so one-shot scans never promote)
        self._hits: dict[str, int] = {}
        self._hits_age = 0
        b = PerfCountersBuilder("cache_tier")
        for c in ("hit", "miss", "promote", "proxy_read", "flush",
                  "evict", "whiteout"):
            b.add_u64_counter(f"tier_{c}")
        self.perf = b.create_perf_counters()

    # -- client surface ------------------------------------------------------

    def write(self, objects: dict[str, bytes | np.ndarray]) -> None:
        """Writeback: land in the CACHE pool only, mark dirty; the
        agent flushes to base later (the client ack does not wait for
        the base tier — that is the point of writeback mode)."""
        self._tick += 1
        payload = {}
        for name, data in objects.items():
            arr = as_flat_u8(data)
            payload[name] = arr
            self._account(name, int(arr.size), dirty=True)
            self._touch[name] = self._tick
            self._whiteout.discard(name)
        self.cache.write(payload)
        self._agent()

    def read(self, name: str) -> np.ndarray:
        self._tick += 1
        if name in self._whiteout:
            raise KeyError(f"no object {name!r}")
        if name in self._size:
            self.perf.inc("tier_hit")
            self._touch[name] = self._tick
            return self.cache.read(name)
        self.perf.inc("tier_miss")
        self._decay_hits()
        hits = self._hits[name] = self._hits.get(name, 0) + 1
        data = np.asarray(self.base.read(name))   # miss: KeyError here
        if hits >= self.promote_after_hits:
            # PROMOTE: copy into the cache pool, clean (the bytes
            # also live in base; ref: promote_object)
            self.perf.inc("tier_promote")
            self.cache.write({name: data})
            self._account(name, int(data.size), dirty=False)
            self._touch[name] = self._tick
            # reset recency: an evicted-then-missed object must earn
            # promotion again, not bounce straight back in (churn)
            self._hits.pop(name, None)
            self._agent()
        else:
            # below the promotion threshold: serve THROUGH the tier
            # without caching (ref: do_proxy_read)
            self.perf.inc("tier_proxy_read")
        return data

    def remove(self, names: list[str] | str) -> None:
        """Delete through the tier: drop cached bytes, and leave a
        WHITEOUT when the base still holds the object so the delete
        propagates on flush instead of resurrecting on the next
        miss."""
        self._tick += 1
        names = [names] if isinstance(names, str) else list(names)
        # validate the WHOLE batch before mutating anything (the
        # recover_shards convention): a bad name mid-batch must not
        # leave a half-applied delete the retry then trips over
        for name in dict.fromkeys(names):
            if name in self._whiteout or (
                    name not in self._size
                    and not self._exists_in_base(name)):
                raise KeyError(f"no object {name!r}")
        for name in dict.fromkeys(names):
            if name in self._whiteout:
                # already logically deleted: delete must agree with
                # read (which raises) — and not double-count stats
                raise KeyError(f"no object {name!r}")
            in_cache = name in self._size
            in_base = self._exists_in_base(name)
            if not in_cache and not in_base:
                raise KeyError(f"no object {name!r}")
            if in_cache:
                self.cache.remove([name])
                self._forget(name)
            if in_base:
                self._whiteout.add(name)
                self.perf.inc("tier_whiteout")

    # -- the tiering agent ---------------------------------------------------

    @property
    def cache_bytes(self) -> int:
        return self._cache_bytes

    @property
    def dirty_bytes(self) -> int:
        return self._dirty_bytes

    def _account(self, name: str, size: int, dirty: bool) -> None:
        """Install/refresh one cache entry, keeping the running byte
        counters exact across overwrites and dirty transitions."""
        old_size = self._size.get(name)
        if old_size is not None:
            self._cache_bytes -= old_size
            if self._dirty.get(name):
                self._dirty_bytes -= old_size
        self._size[name] = size
        self._dirty[name] = dirty
        self._cache_bytes += size
        if dirty:
            self._dirty_bytes += size

    def _agent(self) -> None:
        """agent_work: flush the coldest dirty objects when dirty
        bytes exceed the dirty ratio; evict the coldest clean ones
        when total bytes exceed the full ratio. Both run as ONE
        batched operation against the pools."""
        dirty_target = int(self.target_max_bytes * self.dirty_ratio)
        if self.dirty_bytes > dirty_target:
            over = self.dirty_bytes - dirty_target
            self.flush(self._coldest(over, dirty=True))
        full_target = int(self.target_max_bytes * self.full_ratio)
        if self.cache_bytes > full_target:
            over = self.cache_bytes - full_target
            victims = self._coldest(over, dirty=False)
            if victims:
                self.evict(victims)

    def _coldest(self, over_bytes: int, dirty: bool) -> list[str]:
        pool = sorted((n for n in self._size
                       if bool(self._dirty.get(n)) == dirty),
                      key=lambda n: self._touch[n])
        out, acc = [], 0
        for n in pool:
            if acc >= over_bytes:
                break
            out.append(n)
            acc += self._size[n]
        return out

    def flush(self, names: list[str] | None = None) -> int:
        """Write dirty objects down to base (one batched base write)
        and apply pending whiteouts (one batched base remove)."""
        if names is None:
            names = [n for n in self._size if self._dirty.get(n)]
        names = [n for n in names if self._dirty.get(n)]
        if names:
            batch = {n: self.cache.read(n) for n in names}
            self.base.write(batch)
            for n in names:
                self._dirty[n] = False
                self._dirty_bytes -= self._size[n]
            self.perf.inc("tier_flush", len(names))
        if self._whiteout:
            # invariant: whiteouts are only created for names verified
            # in base, and only this tier deletes from base — no
            # re-probe needed
            self.base.remove(sorted(self._whiteout))
            self._whiteout.clear()
        return len(names)

    def evict(self, names: list[str]) -> int:
        """Drop CLEAN cached copies (bytes remain in base)."""
        victims = [n for n in names
                   if n in self._size and not self._dirty.get(n)]
        if victims:
            self.cache.remove(victims)
            for n in victims:
                self._forget(n)
            self.perf.inc("tier_evict", len(victims))
        return len(victims)

    def flush_evict_all(self) -> None:
        """`rados cache-flush-evict-all` — drain the tier completely
        (the decommission path before `osd tier remove-overlay`)."""
        self.flush()
        self.evict([n for n in list(self._size)
                    if not self._dirty.get(n)])

    # -- helpers -------------------------------------------------------------

    def _forget(self, name: str) -> None:
        sz = self._size.pop(name, None)
        if sz is not None:
            self._cache_bytes -= sz
            if self._dirty.get(name):
                self._dirty_bytes -= sz
        self._dirty.pop(name, None)
        self._touch.pop(name, None)

    def _exists_in_base(self, name: str) -> bool:
        # metadata-only probe: a full base.read() would decode a whole
        # EC stripe just to test existence
        locate = getattr(self.base, "locate", None)
        pgs = getattr(self.base, "pgs", None)
        if locate is not None and pgs is not None:
            return name in pgs[locate(name)].object_sizes
        try:
            self.base.read(name)
            return True
        except KeyError:
            return False

    def _decay_hits(self) -> None:
        self._hits_age += 1
        if self._hits_age >= self.hit_set_period:
            self._hits.clear()
            self._hits_age = 0

    def stats(self) -> dict:
        return {
            "cache_bytes": self.cache_bytes,
            "dirty_bytes": self.dirty_bytes,
            "objects": len(self._size),
            "whiteouts": len(self._whiteout),
            **{k: int(v) for k, v in self.perf.dump().items()
               if k.startswith("tier_")},
        }
