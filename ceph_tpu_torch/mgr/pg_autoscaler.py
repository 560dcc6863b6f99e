"""pg_autoscaler — PG-count recommendations.

Rebuild of the reference's autoscaler mgr module (ref: src/pybind/mgr/
pg_autoscaler/module.py — for each pool: ideal pg_num = in-OSD count *
mon_target_pg_per_osd * pool's capacity share / pool size, rounded to
a power of two; a change is only recommended when the current value is
off by more than the threshold factor (default 3.0), because pg_num
changes cause mass data movement and must not flap).

This module produces RECOMMENDATIONS (the reference's `warn` mode);
executing them is `SimCluster.apply_autoscale()`, which drives the
OSD-side split machinery (`split_pgs`: quorum-gated pg_num bump,
local collection split, pg_temp-protected child backfill — ref:
src/osd/PG.cc split) — the reference's autoscale `on` mode.
"""

from __future__ import annotations


def _pow2_round(x: float) -> int:
    """Nearest power of two (>= 1), the reference's nearest_power."""
    if x <= 1:
        return 1
    lo = 1 << (int(x).bit_length() - 1)
    hi = lo << 1
    return lo if x / lo < hi / x else hi


def _capacity_share(osdmap, pool_id: int,
                    pool_bytes: dict | None) -> float:
    """The fraction of cluster capacity this pool should size its PG
    count for. With real per-pool utilization (MgrReport-aggregated
    logical bytes) the share is the pool's byte fraction — the
    reference's capacity_ratio; a pool with no bytes yet keeps a
    one-PG-floor share. Without utilization data, an even split
    (the pre-r12 synthetic behavior, kept for offline tools)."""
    if not pool_bytes:
        return 1.0 / max(1, len(osdmap.pools))
    total = sum(int(pool_bytes.get(int(p), 0)) for p in osdmap.pools)
    if total <= 0:
        return 1.0 / max(1, len(osdmap.pools))
    return int(pool_bytes.get(int(pool_id), 0)) / total


def recommend_pg_num(osdmap, pool_id: int,
                     target_pg_per_osd: int = 100,
                     threshold: float = 3.0,
                     pool_bytes: dict | None = None) -> dict:
    """Autoscale advice for one pool. pool_bytes is the MgrReport
    pool-utilization aggregate ({pool_id: logical bytes}); absent, the
    capacity share is split evenly across pools."""
    if threshold < 1.0:
        raise ValueError(f"threshold {threshold} must be >= 1.0")
    pool = osdmap.pools[pool_id]
    n_in = int((osdmap.osd_weight > 0).sum())
    share = _capacity_share(osdmap, pool_id, pool_bytes)
    ideal = max(1.0, n_in * target_pg_per_osd * share / pool.size)
    recommended = _pow2_round(ideal)
    ratio = (pool.pg_num / recommended if pool.pg_num >= recommended
             else recommended / pool.pg_num)
    return {
        "pool_id": pool_id,
        "pg_num_current": pool.pg_num,
        "pg_num_ideal": round(ideal, 1),
        "pg_num_recommended": recommended,
        "would_adjust": ratio > threshold,
        "reason": (f"{n_in} in-osds x {target_pg_per_osd} target/osd "
                   f"x {share:.2f} share / size {pool.size}"),
    }


def autoscale_status(osdmap, target_pg_per_osd: int = 100,
                     threshold: float = 3.0,
                     pool_bytes: dict | None = None) -> list[dict]:
    return [recommend_pg_num(osdmap, pid, target_pg_per_osd, threshold,
                             pool_bytes)
            for pid in sorted(osdmap.pools)]


def autoscale_from_reports(aggregator, osdmap,
                           target_pg_per_osd: int = 100,
                           threshold: float = 3.0) -> list[dict]:
    """The live wiring (r12): capacity shares from the monitors'
    MgrReport aggregate (primaries report per-pool logical bytes)
    instead of synthetic even splits — what the `ceph autoscale
    status` monitor command serves."""
    return autoscale_status(osdmap, target_pg_per_osd, threshold,
                            pool_bytes=aggregator.pool_bytes())
