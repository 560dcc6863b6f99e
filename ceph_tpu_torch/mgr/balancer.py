"""Balancer — the upmap placement optimizer.

Rebuild of the reference's mgr balancer module in upmap mode (ref:
src/pybind/mgr/balancer/module.py `do_upmap`, which drives
OSDMap::calc_pg_upmaps — greedy moves of PGs from overfull to
underfull OSDs via pg_upmap_items entries, bounded per round by
max_optimizations, stopping at max_deviation).

TPU-first shaping: the expensive part of balancing is knowing where
every PG currently maps — here that is ONE batched `pgs_to_up` launch
per round (the vectorized CRUSH mapper) instead of the reference's
per-PG loop; the load histogram and the greedy move-selection derive
from that single array host-side.

Since r12 this scalar module is the PARITY ORACLE: the production
path is `mgr/placement.py` (device-batched candidate scoring, one
raw launch per optimize run, data-movement budgets), which pins its
legality rules and objective against this implementation in
tests/test_placement.py.

Failure-domain safety: a move is only legal if the target device does
not put two shards of the PG into one failure domain, at the SAME
bucket level the pool's CRUSH rule separates on (chooseleaf type) —
host rules separate hosts, rack rules separate racks.
"""

from __future__ import annotations

import numpy as np

from ..crush.map import (CRUSH_ITEM_NONE, STEP_CHOOSE_FIRSTN,
                         STEP_CHOOSE_INDEP, STEP_CHOOSELEAF_FIRSTN,
                         STEP_CHOOSELEAF_INDEP)


def load_from_up(up: np.ndarray, n_osds: int) -> np.ndarray:
    """PG-shard count per OSD from a (B, size) up array."""
    flat = np.asarray(up)
    flat = flat[flat != CRUSH_ITEM_NONE]
    return np.bincount(flat, minlength=n_osds)


def device_load(osdmap, pool_id: int) -> np.ndarray:
    """Convenience: one vectorized mapping launch -> per-OSD load
    (the same histogram OSDMap.pg_stats exposes as pg_per_osd)."""
    return load_from_up(osdmap.pgs_to_up(pool_id),
                        len(osdmap.osd_weight))


def _rule_domain_type(crush, rule_id: int) -> int:
    """The bucket type the rule separates replicas on (the chooseleaf/
    choose step's type); 0 (osd) when the rule picks devices directly."""
    for step in crush.rules[rule_id].steps:
        if step.op in (STEP_CHOOSELEAF_FIRSTN, STEP_CHOOSELEAF_INDEP,
                       STEP_CHOOSE_FIRSTN, STEP_CHOOSE_INDEP):
            return step.type_id
    return 0


def _domain_of(crush, item: int, type_id: int,
               _parent_cache: dict | None = None) -> int | None:
    """The ancestor bucket of `item` at `type_id` (transitive walk —
    a rack-level domain is two levels above an osd)."""
    if type_id == 0:
        return item
    parents = _parent_cache if _parent_cache is not None else {}
    if not parents:
        for bid, b in crush.buckets.items():
            for it in b.items:
                parents[it] = bid
    cur = item
    for _ in range(len(crush.buckets) + 1):
        cur = parents.get(cur)
        if cur is None:
            return None
        if crush.buckets[cur].type_id == type_id:
            return cur
    return None


def calc_pg_upmaps(osdmap, pool_id: int, max_deviation: int = 1,
                   max_optimizations: int = 10) -> list[tuple]:
    """One optimization run: returns the applied
    [((pool, ps), (from_osd, to_osd)), ...] moves (already set on the
    map — one redirect pair per move).

    Greedy: move a shard from the most-loaded OSD to the least-loaded
    OSD that is up+in, doesn't already serve the PG, and lives in a
    failure domain serving no other shard of it. Stops when the
    max-min spread over up+in OSDs is within max_deviation or no legal
    move exists.
    """
    crush = osdmap.crush
    pool = osdmap.pools[pool_id]
    dom_type = _rule_domain_type(crush, pool.crush_rule)
    parent_cache: dict = {}
    applied: list[tuple] = []
    n_osds = len(osdmap.osd_weight)
    while len(applied) < max_optimizations:
        up_all = np.asarray(osdmap.pgs_to_up(pool_id))  # ONE launch
        load = load_from_up(up_all, n_osds).astype(np.float64)
        w = np.asarray(osdmap.osd_weight, dtype=np.float64) / 0x10000
        usable = (w > 0) & np.asarray(osdmap.osd_up)
        in_osds = [int(o) for o in np.nonzero(usable)[0]]
        if len(in_osds) < 2:
            break
        # deviation vs the WEIGHT-PROPORTIONAL target (a half-weight
        # device should carry half the PGs; equalizing raw counts
        # would fight CRUSH — the reference measures the same way)
        total = load[usable].sum()
        wsum = w[in_osds].sum()
        expected = {o: total * w[o] / wsum for o in in_osds}

        def dev(o):
            return load[o] - expected[o]

        # many moves per mapping launch: update the load histogram
        # incrementally and only re-launch when a full pass over the
        # candidates makes no further progress
        moved_pgs: set[int] = set()
        round_moves = 0
        progress = True
        while progress and len(applied) < max_optimizations:
            progress = False
            devs = sorted(in_osds, key=dev, reverse=True)
            if dev(devs[0]) - dev(devs[-1]) <= max_deviation:
                break
            for overfull in devs:
                if dev(overfull) <= 0:
                    break  # nothing left that is actually overfull
                targets = sorted((o for o in in_osds if o != overfull),
                                 key=dev)
                hit = self_move = None
                for ps in np.nonzero(
                        (up_all == overfull).any(axis=1))[0]:
                    ps = int(ps)
                    if ps in moved_pgs:
                        continue  # up_all is stale for moved pgs
                    pg = (pool_id, ps)
                    raw = osdmap._raw_pg_to_osds(pool, ps)
                    # domain safety derives from the RAW set: a
                    # down-but-in member still owns its slot, and
                    # stacking into its domain breaks separation the
                    # moment it rejoins
                    members = {int(o) for o in raw
                               if o != CRUSH_ITEM_NONE}
                    for _f, t in osdmap.pg_upmap_items.get(pg, []):
                        members.add(t)
                    doms = {_domain_of(crush, o, dom_type, parent_cache)
                            for o in members if o != overfull}
                    items = osdmap.pg_upmap_items.get(pg, [])
                    # who sources overfull here? Either overfull is in
                    # the raw mapping, or an ACTIVE redirect (f ->
                    # overfull, f in raw) produced it; rewriting an
                    # inactive redirect would move the wrong shard
                    if overfull in raw:
                        src_pair = None
                    else:
                        act = [f for f, t in items
                               if t == overfull and f in raw]
                        if not act:
                            continue
                        src_pair = act[0]
                    for to in targets:
                        if dev(to) >= dev(overfull) - 1:
                            break  # no target improves balance
                        if to in members:
                            continue
                        if _domain_of(crush, to, dom_type,
                                      parent_cache) in doms:
                            continue  # two shards in one domain
                        hit, self_move = (pg, ps, items, to), src_pair
                        break
                    if hit:
                        break
                if not hit:
                    continue  # this osd is stuck; try the next
                pg, ps, items, to = hit
                if self_move is None:
                    new_items = items + [(overfull, to)]
                else:
                    new_items = [(f, t) for f, t in items
                                 if (f, t) != (self_move, overfull)]
                    new_items.append((self_move, to))
                osdmap.set_pg_upmap_items(pg, new_items)
                applied.append((pg, (overfull, to)))
                moved_pgs.add(ps)
                load[overfull] -= 1
                load[to] += 1
                round_moves += 1
                progress = True
                break  # re-rank deviations after every move
        if round_moves == 0:
            break  # a full relaunch would see the same stuck state
    return applied
