"""The port's placement plane (ceph_tpu_torch.mgr.placement, mgr.balancer,
crush.compiler) held against its twin on the CPU, on the same numpy-seeded
inputs: the scorer bit for bit (best indices, float32 scores, tie order
and -inf slots) against the twin's jitted `_score_kernel`; the host
helpers; the batched and the scalar balancer on small maps (moves,
proposed upmaps, rounds, candidates scored, spreads); the CRUSH text
compiler across the two packages. Tolerance: none."""

import numpy as np
import pytest
import torch

from ceph_tpu.crush import compiler as JX
from ceph_tpu.crush.map import build_hierarchy as j_build
from ceph_tpu.crush.map import replicated_rule as j_rule
from ceph_tpu.mgr import balancer as JB
from ceph_tpu.mgr import placement as J
from ceph_tpu.osd.osdmap import OSDMap as JMap
from ceph_tpu.osd.osdmap import PGPool as JPool
from ceph_tpu_torch.crush import compiler as TX
from ceph_tpu_torch.crush.map import build_hierarchy as t_build
from ceph_tpu_torch.crush.map import replicated_rule as t_rule
from ceph_tpu_torch.mgr import balancer as TB
from ceph_tpu_torch.mgr import placement as T
from ceph_tpu_torch.osd.osdmap import OSDMap as TMap
from ceph_tpu_torch.osd.osdmap import PGPool as TPool

NONE = 0x7FFFFFFF
CPU = torch.device("cpu")


# ----------------------------------------------------------- the scorer

def _scorer_inputs(S2: int, U: int, seed: int, ties: bool):
    """Seeded candidate block: OSD ids with NONE holes, the source among
    each row's members, padded rows (NONE, src 0) at the end, rows whose
    source is the least loaded device (every gain <= 0: all illegal),
    rows holding every target (all members), domain ids with no-ancestor
    devices; dev integer-valued when `ties`."""
    rng = np.random.default_rng(seed)
    n_osds = max(64, 2 * U)
    N = 96
    dom = (np.arange(n_osds) // 4 - 100).astype(np.int32)
    dom[rng.choice(n_osds, 5, replace=False)] = -(10 ** 7) - np.arange(5)
    if ties:
        dev = rng.integers(-6, 7, n_osds).astype(np.float64)
    else:
        dev = rng.normal(0, 4, n_osds)
    dsts = rng.choice(n_osds, U, replace=False).astype(np.int32)
    members = rng.integers(0, n_osds, (N, S2)).astype(np.int32)
    members[rng.random((N, S2)) < 0.1] = NONE
    src = members[np.arange(N), rng.integers(0, S2, N)].copy()
    src[src == NONE] = 1
    members[np.arange(N), 0] = src              # the shard being moved
    low = int(np.argmin(dev))
    src[10:14] = low                             # all-illegal rows
    members[10:14, 0] = low
    if U <= S2:
        members[14, :U] = dsts                   # every target a member
    members[-8:] = NONE                          # pow2 padding rows
    src[-8:] = 0
    return members, src, dsts, dev, dom


def _twin_score(members, src, dsts, dev, dom, topk):
    import jax.numpy as jnp
    best, score = J._score_kernel(
        jnp.asarray(members), jnp.asarray(src), jnp.asarray(dsts),
        jnp.asarray(dev, jnp.float32), jnp.asarray(dom), topk)
    return np.asarray(best), np.asarray(score)


def _same_scores(a, b):
    """Equal bit for bit (so -inf == -inf and 0.0 != -0.0)."""
    return a.dtype == b.dtype == np.float32 and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


SCORER_CASES = [(S2, U, topk) for S2 in (6, 22) for U in (1, 7, 64, 512)
                for topk in range(1, min(8, U) + 1)]


@pytest.mark.parametrize("S2,U,topk", SCORER_CASES)
def test_score_candidates_plain_matches_twin(S2, U, topk):
    for ties in (True, False):
        inp = _scorer_inputs(S2, U, seed=S2 * 1000 + U * 10 + topk,
                             ties=ties)
        jb, js = _twin_score(*inp, topk)
        members, src, dsts, dev, dom = inp
        tb, ts = T.score_candidates(
            torch.from_numpy(members), torch.from_numpy(src),
            torch.from_numpy(dsts),
            torch.from_numpy(dev.astype(np.float32)),
            torch.from_numpy(dom), topk)
        assert tb.dtype == torch.int32 and ts.dtype == torch.float32
        assert np.array_equal(tb.numpy(), jb), (ties, topk)
        assert _same_scores(ts.numpy(), js), (ties, topk)
        assert np.isneginf(js[10:14]).all()      # all-illegal rows


def _insertion_topk(row: np.ndarray, K: int = 8) -> list:
    """The kernel's per-thread top-k (placement.cu), step for step in
    Python: slots start empty; a score enters when it beats the 8th
    strictly or a slot is empty, before the first slot it beats strictly
    (or the first empty one)."""
    vals, idx = [-np.inf] * K, [-1] * K
    for u, v in enumerate(row):
        if not (v > vals[K - 1] or idx[K - 1] < 0):
            continue
        cv, ci, placed = v, u, False
        for p in range(K):
            if placed or cv > vals[p] or idx[p] < 0:
                vals[p], cv = cv, vals[p]
                idx[p], ci = ci, idx[p]
                placed = True
    return idx


@pytest.mark.parametrize("U", [1, 5, 8, 9, 64, 512])
def test_kernel_insertion_order_is_the_plain_order(U):
    # integer scores with -inf holes: ties everywhere
    rng = np.random.default_rng(U)
    score = rng.integers(0, 4, (300, U)).astype(np.float32)
    score[rng.random((300, U)) < 0.4] = -np.inf
    score[:20] = -np.inf                         # all-illegal rows
    topk = min(8, U)
    _, want = torch.sort(torch.from_numpy(score), dim=1, descending=True,
                         stable=True)
    for r in range(score.shape[0]):
        assert _insertion_topk(score[r])[:topk] == \
            want[r, :topk].tolist(), r


def test_score_candidates_refuses_bad_inputs():
    members, src, dsts, dev, dom = (torch.from_numpy(a) for a in
                                    _scorer_inputs(6, 7, 1, True))
    dev = dev.float()
    with pytest.raises(ValueError, match="int32"):
        T.score_candidates(members.long(), src, dsts, dev, dom, 4)
    with pytest.raises(ValueError, match="topk"):
        T.score_candidates(members, src, dsts, dev, dom, 8)
    with pytest.raises(ValueError, match="member slots"):
        T.score_candidates(torch.zeros((4, 33), dtype=torch.int32),
                           src[:4], dsts, dev, dom, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        T.score_candidates(*(t.to("meta") for t in
                             (members, src, dsts, dev, dom)), 4)
    assert T.launches == 0                       # the CPU launches nothing


# -------------------------------------------------------------- the maps

# one topology per package and shape, shared: the twin's VectorMapper
# compiles a program per (map, lane count)
_MAPS: dict = {}


def _topology(pkg: str, n_osds: int, per_host: int, heavy: bool):
    key = (pkg, n_osds, per_host, heavy)
    if key not in _MAPS:
        build, rule = (j_build, j_rule) if pkg == "jax" else (t_build, t_rule)
        m = build(n_osds, osds_per_host=per_host, hosts_per_rack=4)
        if heavy:   # tools/scale_sim.py's heavy_half
            half = n_osds // 2
            for b in m.buckets.values():
                if b.type_id == 1:
                    for i, it in enumerate(b.items):
                        if it < half:
                            b.weights[i] = 2 * 0x10000
            for lvl in (2, 3):
                for b in m.buckets.values():
                    if b.type_id == lvl:
                        b.weights = [m.buckets[c].weight for c in b.items]
            m._packed = None
        rule(m, 1, choose_type=1, firstn=True)
        _MAPS[key] = [m, None]
    return _MAPS[key]


def _osdmap(pkg, n_osds=16, pg_num=128, size=3, per_host=2, heavy=False):
    topo = _topology(pkg, n_osds, per_host, heavy)
    if pkg == "jax":
        om = JMap(topo[0])
        om.add_pool(JPool(1, pg_num=pg_num, size=size, min_size=2,
                          crush_rule=1))
    else:
        om = TMap(topo[0], device="cpu")
        om.add_pool(TPool(1, pg_num=pg_num, size=size, min_size=2,
                          crush_rule=1))
    if topo[1] is None:
        topo[1] = om._vm
    else:
        om._vm = topo[1]
    return om


def _both_maps(**kw):
    return _osdmap("jax", **kw), _osdmap("torch", **kw)


def test_osd_domains_and_rule_type_match_twin():
    jm, tm = _both_maps(n_osds=24, per_host=3)
    for type_id in (0, 1, 2):
        assert np.array_equal(T.osd_domains(tm.crush, type_id, 24),
                              J.osd_domains(jm.crush, type_id, 24))
    assert TB._rule_domain_type(tm.crush, 1) == \
        JB._rule_domain_type(jm.crush, 1) == 1
    # a device outside every bucket gets its own unique id
    jm.crush.buckets[-1].items.remove(0)
    tm.crush.buckets[-1].items.remove(0)
    try:
        assert np.array_equal(T.osd_domains(tm.crush, 1, 24),
                              J.osd_domains(jm.crush, 1, 24))
        assert T.osd_domains(tm.crush, 1, 24)[0] == -(10 ** 7)
    finally:
        jm.crush.buckets[-1].items.insert(0, 0)
        tm.crush.buckets[-1].items.insert(0, 0)


def test_chunked_raw_and_upmap_overlay_match_twin():
    jm, tm = _both_maps()
    jraw = J.chunked_pgs_to_raw(jm, 1)
    traw = T.chunked_pgs_to_raw(tm, 1, chunk=32)     # four chunks
    assert traw.dtype == np.int32 and np.array_equal(traw, jraw)
    assert np.array_equal(T.chunked_pgs_to_raw(tm, 1), jraw)
    row0 = [int(o) for o in jraw[0]]
    items = {(1, 0): [(row0[1], 15)], (1, 3): [(int(jraw[3][0]),
                                                 int(jraw[3][1]))],
             (1, 500): [(1, 2)], (2, 4): [(0, 1)]}
    assert np.array_equal(T.apply_upmaps_to_raw(jraw, 1, items),
                          J.apply_upmaps_to_raw(jraw, 1, items))


class _Telemetry:
    """The two calls telemetry_movement_budget makes."""

    def __init__(self, burn, p99_ms, count=5):
        self.burn, self.p99_ms, self.count = burn, p99_ms, count

    def burn_rate(self):
        return self.burn

    def observed_client_latency(self, pool_id):
        return {"count": self.count, "p99_ms": self.p99_ms}


@pytest.mark.parametrize("burn,p99_ms,ceiling", [
    (0.0, 5.0, None), (0.25, 5.0, None), (1.5, 5.0, None),
    (0.1, 50.0, 0.02), (0.1, 10.0, 0.02)])
def test_telemetry_movement_budget_matches_twin(burn, p99_ms, ceiling):
    tel = _Telemetry(burn, p99_ms)
    for base in (None, 0, 100, 65536):
        assert T.telemetry_movement_budget(tel, base, 1, ceiling) == \
            J.telemetry_movement_budget(tel, base, 1, ceiling)
    assert T.telemetry_movement_budget(None, 7) == 7


def _result(res):
    d = res.to_dict()
    for k in ("candidates_per_s", "score_elapsed_s", "elapsed_s"):
        d.pop(k)    # host times
    return d, list(res.moves), dict(res.proposed)


BALANCER_CASES = {
    "twin-test-map": (dict(), dict(max_deviation=1)),
    "heavy-half": (dict(n_osds=64, pg_num=512, per_host=8, heavy=True),
                   dict(max_deviation=1, max_movement=400, max_src=16,
                        max_dst=16)),
    "down-but-in, budget": (dict(n_osds=32, pg_num=256, per_host=4),
                            dict(max_deviation=0, max_movement=9)),
    "ec-like size 6": (dict(n_osds=48, pg_num=64, size=6, per_host=2),
                       dict(max_deviation=1)),
}


@pytest.mark.parametrize("case", sorted(BALANCER_CASES))
def test_batch_calc_pg_upmaps_matches_twin(case):
    map_kw, run_kw = BALANCER_CASES[case]
    jm, tm = _both_maps(**map_kw)
    if case.startswith("down-but-in"):
        for om in (jm, tm):
            om.mark_down(5)                 # down but still in
            om.mark_in(7, weight=0.5)
            om.set_pg_upmap_items((1, 2), [(int(om.pgs_to_raw(1)[2][0]),
                                            31)])
    jr = J.batch_calc_pg_upmaps(jm, 1, **run_kw)
    tr = T.batch_calc_pg_upmaps(tm, 1, **run_kw)
    assert _result(tr) == _result(jr)
    assert tr.candidates_scored > 0 and tr.moves
    if "max_movement" in run_kw:
        assert tr.budget_used <= run_kw["max_movement"]
    assert tm.pg_upmap_items == jm.pg_upmap_items
    assert tm.encode() == jm.encode()
    # the landed upmaps are what the scalar path maps
    up = tm.pgs_to_up(1)
    for ps in range(0, tm.pools[1].pg_num, 7):
        assert up[ps].tolist() == tm.pg_to_up_acting_osds(1, ps)[0]


def test_batch_calc_pg_upmaps_matches_twin_with_stable_argsort(monkeypatch):
    # phase 10 and tools/balancer_10k.py pin np.argsort to kind="stable"
    # (numpy's default orders ties by the CPU); both packages follow it
    import functools
    monkeypatch.setattr(np, "argsort",
                        functools.partial(np.argsort, kind="stable"))
    map_kw, run_kw = BALANCER_CASES["heavy-half"]
    jm, tm = _both_maps(**map_kw)
    jr = J.batch_calc_pg_upmaps(jm, 1, **run_kw)
    tr = T.batch_calc_pg_upmaps(tm, 1, **run_kw)
    assert _result(tr) == _result(jr) and tr.moves
    assert tm.pg_upmap_items == jm.pg_upmap_items


def test_calc_pg_upmaps_matches_twin():
    jm, tm = _both_maps(n_osds=16, pg_num=64, per_host=2)
    jmoves = JB.calc_pg_upmaps(jm, 1, max_deviation=1, max_optimizations=20)
    tmoves = TB.calc_pg_upmaps(tm, 1, max_deviation=1, max_optimizations=20)
    assert tmoves == jmoves and tmoves
    assert tm.pg_upmap_items == jm.pg_upmap_items
    assert np.array_equal(TB.device_load(tm, 1), JB.device_load(jm, 1))


def test_crush_compiler_round_trips_across_packages():
    jm, tm = _both_maps(n_osds=24, per_host=3)
    jtext, ttext = JX.decompile(jm.crush), TX.decompile(tm.crush)
    assert ttext == jtext
    back_t = TX.compile_text(jtext)         # twin's text, port's compiler
    back_j = JX.compile_text(ttext)
    assert TX.decompile(back_t) == JX.decompile(back_j) == jtext
    from ceph_tpu_torch.crush.oracle import OracleMapper
    w = np.full(24, 0x10000, np.int32)
    om_t, om_o = OracleMapper(back_t), OracleMapper(tm.crush)
    for x in range(64):
        assert om_t.do_rule(1, x, w, 3) == om_o.do_rule(1, x, w, 3)
    with pytest.raises(TX.CompileError):
        TX.compile_text("device 0 osd.0\nrule r {\n  bogus\n}\n")
