#!/usr/bin/env python
"""The mgr's upmap balancer at 10k OSDs / 1M PGs, run by the JAX package.

Builds tools/scale_sim.py's heavy-half map (10,000 OSDs, 8 per host, 16
hosts per rack, replicated size 3 over a host failure domain, pg_num
1,048,576; the first half of the devices at twice the CRUSH weight
under uniform reweight targets: a pool that mixes 8 TB and 16 TB
drives) and runs `batch_calc_pg_upmaps` over it once. Writes the
configuration, `BalanceResult.to_dict()` and two sha256 digests
(`balance_digests`) into BALANCER_10K.json, the reference that
`chip_smoke.py` phase 10 holds the port's balancer to.

The greedy walks candidates and devices in `np.argsort` order, and the
deviations it sorts are integer-valued, so ties are everywhere. numpy's
default argsort is an unstable quicksort whose order of ties depends on
the CPU it runs on (on an AVX-512 host numpy sorts with SIMD networks),
so the same code gives other moves on another machine. The run pins
`np.argsort` to `kind="stable"` (`stable_argsort`), as phase 10 does:
the order of ties is then the index order everywhere.

    JAX_PLATFORMS=cpu python tools/balancer_10k.py [--out PATH]

The times in the file are those of this run on its backend (named in
"backend"); only the counts and digests are compared.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

CONFIG = {"osds": 10_000, "pg_num": 1 << 20, "size": 3,
          "osds_per_host": 8, "hosts_per_rack": 16, "heavy_half": True,
          "max_deviation": 1, "max_movement": 65_536, "max_src": 512,
          "max_dst": 512, "chunk": 65_536}


@contextlib.contextmanager
def stable_argsort():
    """np.argsort with kind="stable" while the block runs: ties in index
    order on every CPU."""
    default = np.argsort
    np.argsort = functools.partial(default, kind="stable")
    try:
        yield
    finally:
        np.argsort = default


def balance_digests(moves, proposed) -> dict:
    """sha256 of the moves in order and of the proposed upmap set sorted
    by PG, each as compact JSON of plain integers."""
    def sha(obj) -> str:
        return hashlib.sha256(json.dumps(obj, separators=(",", ":"))
                              .encode()).hexdigest()
    return {
        "moves_sha256": sha([[int(p), int(ps), int(s), int(d)]
                             for (p, ps), (s, d) in moves]),
        "proposed_sha256": sha([[int(p), int(ps),
                                 [[int(f), int(t)] for f, t in items]]
                                for (p, ps), items in
                                sorted(proposed.items())])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "BALANCER_10K.json"))
    args = ap.parse_args()
    import jax

    from ceph_tpu.mgr.placement import batch_calc_pg_upmaps
    from scale_sim import build_cluster

    c = CONFIG
    om = build_cluster(c["osds"], c["pg_num"], size=c["size"],
                       osds_per_host=c["osds_per_host"],
                       hosts_per_rack=c["hosts_per_rack"],
                       heavy_half=c["heavy_half"])
    t0 = time.monotonic()
    with stable_argsort():
        res = batch_calc_pg_upmaps(
            om, 1, max_deviation=c["max_deviation"],
            max_movement=c["max_movement"], max_src=c["max_src"],
            max_dst=c["max_dst"], chunk=c["chunk"])
    wall = time.monotonic() - t0
    out = {"config": c, "argsort": "stable",
           "backend": jax.default_backend(),
           "wall_s": round(wall, 1), "result": res.to_dict(),
           "upmap_pgs": len(res.proposed),
           **balance_digests(res.moves, res.proposed)}
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
