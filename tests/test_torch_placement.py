"""The port's placement plane (ceph_tpu_torch.mgr.placement, mgr.balancer,
crush.compiler) held against its twin on the CPU, on the same numpy-seeded
inputs: the scorer bit for bit (best indices, float32 scores, tie order
and -inf slots) against the twin's jitted `_score_kernel`; the host
helpers; the card kernel's walk modelled step for step (`_walk_model`)
against the twin, the plain version and `score_visits_plain`; the
batched and the scalar balancer on small maps (moves,
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


def _order_key_np(x: np.ndarray) -> np.ndarray:
    bits = x.astype(np.float32).view(np.uint32).astype(np.int64)
    return np.where(bits >= 1 << 31, bits ^ 0xFFFFFFFF, bits | 1 << 31)


def _ranks_before(v, u, w, t, nan_aware):
    if t < 0:
        return True
    if nan_aware:   # the total order: a NaN ranks by its sign and bits
        v, w = (int(_order_key_np(np.float32(x))) for x in (v, w))
    return bool(v > w or (v == w and u < t))


def _insert(vals, idx, v, u, nan_aware):
    """The kernel's insertion keyed on (score descending, u ascending)."""
    K = len(vals)
    if not _ranks_before(v, u, vals[K - 1], idx[K - 1], nan_aware):
        return
    cv, ci, placed = v, u, False
    for p in range(K):
        if placed or _ranks_before(cv, ci, vals[p], idx[p], nan_aware):
            vals[p], cv = cv, vals[p]
            idx[p], ci = ci, idx[p]
            placed = True


def _walk_model(members, src, dsts, dev, dom, topk, K=8):
    """placement.cu's walk instance step for step in Python: the block
    stages the targets and sorts them by (order key of dev, u) unless
    their deviations are already non-decreasing; each row walks that
    order, stops at the first gain <= 0 or, once topk legal entries are
    held, at the first gain strictly below the topk-th, appends a legal
    entry after the ones held (gains never increase along the walk) or,
    when it ties the last with a lower u, inserts it by (score, u), and
    fills the -inf slots with the lowest u that hold no legal entry. Rows with a non-finite dev[src], and all
    rows when a staged deviation is not finite, take every target with
    the NaN-aware insertion. Returns (best, score, visits)."""
    dev = dev.astype(np.float32)
    U, one = len(dsts), np.float32(1.0)
    ddev = dev[dsts]
    finite = bool(np.isfinite(ddev).all())
    ascending = all(not ddev[i] > ddev[i + 1] for i in range(U - 1))
    order = (np.lexsort((np.arange(U), _order_key_np(ddev)))
             if finite and not ascending else np.arange(U))
    best = np.empty((len(src), topk), np.int32)
    score = np.empty((len(src), topk), np.float32)
    visits = np.empty(len(src), np.int32)
    for r in range(len(src)):
        s = int(src[r])
        valid = (members[r] != NONE) & (members[r] != s)
        mdom = np.where(valid, dom[np.clip(members[r], 0, len(dom) - 1)],
                        T.MASKED_DOMAIN)
        dsrc = dev[s]
        vals, idx = [np.float32(-np.inf)] * K, [-1] * K
        with np.errstate(invalid="ignore", over="ignore"):
            if finite and np.isfinite(dsrc):
                # held entries in slots :held, (last, lastu) the lowest
                held, last, lastu, n = 0, None, None, U
                for i, u in enumerate(order):
                    u = int(u)
                    g = (dsrc - ddev[u]) - one
                    if not g > 0 or (held == topk and g < last):
                        n = i
                        break
                    # a member equal to the target is the source or
                    # shares its domain: 2S + 1 compares
                    if dsts[u] == s or (mdom == dom[dsts[u]]).any():
                        continue
                    if held < topk:
                        if held == 0 or not _ranks_before(g, u, last, lastu,
                                                          False):
                            vals[held], idx[held] = g, u   # goes last
                        else:
                            _insert(vals, idx, g, u, False)
                        last, lastu = vals[held], idx[held]
                        held += 1
                    elif _ranks_before(g, u, last, lastu, False):
                        _insert(vals, idx, g, u, False)   # ties the kth
                        last, lastu = vals[topk - 1], idx[topk - 1]
                have, u = held, 0
                for p in range(have, topk):
                    while True:
                        n += 1
                        if u not in idx[:have]:
                            break
                        u += 1
                    idx[p] = u
                    u += 1
            else:
                for u in order:
                    g = (dsrc - ddev[u]) - one
                    bad = (members[r] == dsts[u]).any() or \
                        (mdom == dom[dsts[u]]).any()
                    _insert(vals, idx, np.float32(-np.inf) if bad or g <= 0
                            else g, int(u), True)
                n = U
        best[r], score[r], visits[r] = idx[:topk], vals[:topk], n
    return best, score, visits


def _walk_inputs(case: str, seed: int):
    """Scorer inputs for the walk model: `_scorer_inputs` (dsts in random
    order, so the block sorts) as they are, with dsts sorted by dev as
    the balancer passes them, with integer deviations (ties), with
    rounding-collapsed gains (dev[src] = 3e7, targets at deviations
    0.125, 0.25, ... 1.0 listed out of deviation order: 0.25, 0.5 and
    1.0 all give 30000000.0f), with every row illegal, or with the first 24 targets
    in the walk order all in one domain that every row holds (long
    walks)."""
    ties = case in ("ties", "ties-sorted")
    members, src, dsts, dev, dom = _scorer_inputs(
        6, 64, seed=seed, ties=ties)
    dev = dev.astype(np.float32)
    if case == "collapsed":
        rng = np.random.default_rng(seed)
        dev[dsts] = rng.choice(np.float32(np.arange(1, 9) / 8), len(dsts))
        dev[src[::2]] = np.float32(3.0e7)
    if case == "all-illegal":
        src[:] = int(np.argmin(dev))
        members[:, 0] = src
    if case == "long":
        dev[src] = np.abs(dev[src]) + 50     # gains positive throughout
        dsts = dsts[np.argsort(dev[dsts], kind="stable")]
        dom = dom.copy()
        dom[dsts[:24]] = 7
        holder = int(np.setdiff1d(np.arange(len(dom)),
                                  np.concatenate([dsts, src]))[0])
        dom[holder] = 7
        members[:-8, 1] = holder             # not the padding rows
    if case.endswith("sorted"):
        dsts = dsts[np.argsort(dev[dsts], kind="stable")]
    return members, src, dsts, dev, dom


WALK_CASES = ("random", "sorted", "ties", "ties-sorted", "collapsed",
              "all-illegal", "long")


@pytest.mark.parametrize("topk", range(1, 9))
@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_model_matches_plain_and_twin(case, topk):
    members, src, dsts, dev, dom = _walk_inputs(case, seed=topk)
    mb, ms, mv = _walk_model(members, src, dsts, dev, dom, topk)
    tin = [torch.from_numpy(a) for a in (members, src, dsts, dev, dom)]
    pb, ps = T.score_candidates_plain(*tin, topk)
    assert np.array_equal(mb, pb.numpy()) and _same_scores(ms, ps.numpy())
    jb, js = _twin_score(members, src, dsts, dev, dom, topk)
    assert np.array_equal(mb, jb) and _same_scores(ms, js)
    assert np.array_equal(mv, T.score_visits_plain(*tin, topk).numpy())
    walked = np.isfinite(dev[src])
    assert (mv[walked] <= len(dsts) + topk).all()
    if case == "collapsed":
        # equal gains met out of index order, and the walk still settles
        big = dev[src] == np.float32(3.0e7)
        assert (ms[big] == np.float32(3.0e7)).any()
        assert (mv[big] < len(dsts)).all()
    if case == "long":
        assert (mv[:-8] >= 24).all()
    if case == "all-illegal":
        assert np.isneginf(ms).all() and (mv == topk).all()


NONFINITE_CASES = ("inf target", "-inf target", "nan target", "inf source",
                   "nan source", "-inf source")


@pytest.mark.parametrize("case", NONFINITE_CASES)
def test_walk_model_nonfinite_matches_plain(case):
    # the kernel's model, the plain version and the twin all rank in the
    # total order: a NaN with its sign bit set below -inf
    members, src, dsts, dev, dom = _walk_inputs("random", seed=11)
    what, where = case.split()
    val = {"inf": np.inf, "-inf": -np.inf, "nan": np.nan}[what]
    if where == "target":
        dev[dsts[[3, 17]]] = val
    else:
        dev[src[::3]] = val
    tin = [torch.from_numpy(a) for a in (members, src, dsts, dev, dom)]
    for topk in (1, 5, 8):
        mb, ms, mv = _walk_model(members, src, dsts, dev, dom, topk)
        pb, ps = T.score_candidates_plain(*tin, topk)
        assert np.array_equal(mb, pb.numpy()), topk
        assert np.array_equal(np.isnan(ms), np.isnan(ps.numpy()))
        assert _same_scores(np.nan_to_num(ms, nan=7.0),
                            np.nan_to_num(ps.numpy(), nan=7.0))
        assert np.array_equal(mv, T.score_visits_plain(*tin, topk).numpy())
        exhaustive = ~np.isfinite(dev[src]) | (where == "target")
        assert (mv[exhaustive] == len(dsts)).all()
        jb, js = _twin_score(members, src, dsts, dev, dom, topk)
        assert np.array_equal(mb, jb), topk
        assert _same_scores(ms, js), topk


def test_sign_bit_nan_ranks_below_neg_inf_as_in_the_twin():
    # row 36's source is target 7, so its gain at target 3 is
    # -inf - (-inf) - 1: a NaN with the sign bit set on x86, which the
    # twin's lax.top_k ranks below every -inf
    rng = np.random.default_rng(3)
    n_osds, N = 64, 64
    dom = (np.arange(n_osds) // 4).astype(np.int32)
    dev = rng.normal(0, 5, n_osds).astype(np.float32)
    dsts = rng.choice(n_osds, 16, replace=False).astype(np.int32)
    members = rng.integers(0, n_osds, (N, 6)).astype(np.int32)
    src = members[:, 0].copy()
    dev[dsts[[3, 7]]] = -np.inf
    src[36] = members[36, 0] = dsts[7]
    members[36, 1:] = NONE
    tin = [torch.from_numpy(a) for a in (members, src, dsts, dev, dom)]
    pb, ps = T.score_candidates_plain(*tin, 8)
    jb, js = _twin_score(members, src, dsts, dev, dom, 8)
    assert np.array_equal(pb.numpy(), jb)
    assert _same_scores(ps.numpy(), js)
    assert pb[36].tolist() == [0, 1, 2, 4, 5, 6, 7, 8]
    assert np.isneginf(js[36]).all()
    mb, ms, _ = _walk_model(members, src, dsts, dev, dom, 8)
    assert np.array_equal(mb, jb) and _same_scores(ms, js)


def test_score_visits_for_the_scan_instance(monkeypatch):
    # above WALK_MAX_TARGETS the scan instance takes every target
    members, src, dsts, dev, dom = (torch.from_numpy(a) for a in
                                    _scorer_inputs(6, 64, 5, False))
    dev = dev.float()
    with monkeypatch.context() as m:
        m.setattr(T, "WALK_MAX_TARGETS", 63)
        v = torch.zeros(len(src), dtype=torch.int32)
        best, score = T.score_candidates(members, src, dsts, dev, dom, 8,
                                         visits=v)
        assert (v == 64).all()
    v2 = torch.zeros(len(src), dtype=torch.int32)
    best2, score2 = T.score_candidates(members, src, dsts, dev, dom, 8,
                                       visits=v2)
    assert torch.equal(best, best2) and torch.equal(score, score2)
    assert torch.equal(v2, T.score_visits_plain(members, src, dsts, dev,
                                                dom, 8))
    assert int(v2.max()) < 64
    with pytest.raises(ValueError, match="visits"):
        T.score_candidates(members, src, dsts, dev, dom, 8,
                           visits=torch.zeros(3, dtype=torch.int32))


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
