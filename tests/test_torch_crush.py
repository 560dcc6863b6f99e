"""The port's CRUSH mapper (ceph_tpu_torch.crush.mapper) held lane for
lane against its twin (ceph_tpu.crush.mapper.VectorMapper) and the
scalar OracleMapper, on the CPU.

Each bucket alg, firstn and indep, chooseleaf and a multi-step rule,
both straw2 draws, reweighted (0x8000, 0x4000) and out (0) OSDs, and
retry budgets small enough to leave CRUSH_ITEM_NONE holes. Every case
is held against the oracle; the twin, which compiles one XLA program
per (map, rule, lane count), is asked once per bucket alg (one rule
with a firstn and an indep block) and for scan_rule. Tolerance: none,
placements are integers and every comparison is exact.
"""

import numpy as np
import pytest
import torch

import ceph_tpu.crush.map as JM
from ceph_tpu.crush import hash as JH
from ceph_tpu.crush.mapper import VectorMapper as JV
from ceph_tpu.crush.oracle import OracleMapper
from ceph_tpu_torch.crush import map as TM
from ceph_tpu_torch.crush import mapper as T

np.seterr(over="ignore")
NONE = JM.CRUSH_ITEM_NONE
ALGS = ["straw2", "uniform", "list", "tree", "straw"]
N_OSDS = 24


def make_map(mod, alg="straw2", tries=7, n=N_OSDS, per_host=4,
             per_rack=3):
    """root -> racks -> hosts -> osds with a replicated firstn rule 0
    and an EC indep rule 1 (host failure domain), built by `mod`'s own
    map module."""
    m = mod.build_hierarchy(n, per_host, per_rack, alg=alg)
    m.tunables = mod.Tunables(choose_total_tries=tries)
    mod.replicated_rule(m, 0, choose_type=1, firstn=True)
    mod.ec_rule(m, 1, choose_type=1)
    return m


def weights(n=N_OSDS, out=(3,), half=(7,), quarter=(12,)):
    w = T.full_weights(n)
    w[list(out)] = 0
    w[list(half)] = 0x8000
    w[list(quarter)] = 0x4000
    return w


def oracle_rows(m, rule_id, xs, w, n, draw="fixed"):
    om = OracleMapper(m, draw=draw)
    return np.array([(om.do_rule(rule_id, int(x), w, n) + [NONE] * n)[:n]
                     for x in xs], dtype=np.int32)


def port_rows(m, rule_id, xs, w, n, draw="fixed"):
    vm = T.VectorMapper(m, draw=draw, device="cpu")
    got = vm.do_rule(rule_id, xs, w, n)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    return got.numpy()


def test_hash_matches_twin():
    rng = np.random.default_rng(11)
    cols = [rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)
            for _ in range(4)]
    cols[0][:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    for fn_t, fn_j, n in ((T.hash32_2, JH.hash32_2, 2),
                          (T.hash32_3, JH.hash32_3, 3),
                          (T.hash32_4, JH.hash32_4, 4)):
        want = fn_j(*cols[:n])
        args = [torch.from_numpy(c.view(np.int32).copy()) for c in cols[:n]]
        got = fn_t(*args)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        # a scalar argument hashes like the same value in every lane
        got_s = fn_t(*args[:-1], int(cols[n - 1][5]))
        want_s = fn_j(*cols[:n - 1], np.uint32(cols[n - 1][5]))
        np.testing.assert_array_equal(got_s.numpy().view(np.uint32), want_s)


def test_mulhi32_is_exact():
    rng = np.random.default_rng(12)
    h = rng.integers(0, 1 << 32, 400, dtype=np.int64)
    w = rng.integers(0, 1 << 32, 400, dtype=np.int64)
    h[:3], w[:3] = [0xFFFFFFFF, 0xFFFFFFFF, 1], [0xFFFFFFFF, 1, 0xFFFFFFFF]
    got = T._mulhi32(torch.from_numpy(h), torch.from_numpy(w)).numpy()
    assert got.tolist() == [(int(a) * int(b)) >> 32 for a, b in zip(h, w)]


@pytest.mark.parametrize("n", [0, 1, 2, 7, 1000, 1001])
def test_xor_fold(n):
    rng = np.random.default_rng(n)
    v = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    want = np.bitwise_xor.reduce(v) if n else 0
    assert int(T._xor_fold(torch.from_numpy(v).view(-1, 1))) == int(want)


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("rule_id", [0, 1], ids=["firstn", "indep"])
def test_matches_oracle(alg, rule_id):
    m = make_map(TM, alg)
    xs = np.arange(96, dtype=np.uint32)
    w = weights()
    got = port_rows(m, rule_id, xs, w, 3)
    np.testing.assert_array_equal(got, oracle_rows(m, rule_id, xs, w, 3))
    assert not (got == 3).any()          # the out osd is never chosen


def add_both_modes_rule(mod, m, rule_id=2):
    """One rule, two blocks: chooseleaf_firstn 2 hosts, emit, then
    chooseleaf_indep 2 hosts, emit — firstn and indep in one program
    (the twin compiles one XLA program per rule)."""
    root = m.root_id
    m.add_rule(rule_id, [
        mod.Step(mod.STEP_TAKE, arg=root),
        mod.Step(mod.STEP_CHOOSELEAF_FIRSTN, arg=2, type_id=1),
        mod.Step(mod.STEP_EMIT),
        mod.Step(mod.STEP_TAKE, arg=root),
        mod.Step(mod.STEP_CHOOSELEAF_INDEP, arg=2, type_id=1),
        mod.Step(mod.STEP_EMIT)])


@pytest.mark.parametrize("alg", ALGS)
def test_matches_twin(alg):
    # two tries and a third of the OSDs out: retry rounds run on a
    # subset of the lanes, and some slots stay NONE — holes in the
    # indep block, NONE-padded tails in the firstn block
    xs = np.arange(160, dtype=np.uint32)
    w = weights(out=range(0, N_OSDS, 3))
    # 3 OSDs per host, 3 hosts per rack: the twin's uniform unroll (and
    # its compile) grows with the largest bucket
    jm, tm = (make_map(mod, alg, tries=2, per_host=3, per_rack=3)
              for mod in (JM, TM))
    add_both_modes_rule(JM, jm)
    add_both_modes_rule(TM, tm)
    want = np.asarray(JV(jm).do_rule(2, xs, w, 4))
    got = port_rows(tm, 2, xs, w, 4)
    np.testing.assert_array_equal(got, want)
    # the oracle leaves firstn rows short: its blocks are rules 0 and 1
    np.testing.assert_array_equal(got, np.concatenate(
        [oracle_rows(tm, 0, xs, w, 2), oracle_rows(tm, 1, xs, w, 2)], 1))
    holes = got == NONE
    assert holes.any() and not holes.all()
    firstn = holes[:, :2]
    assert not (firstn[:, 0] & ~firstn[:, 1]).any()    # filled from the left


@pytest.mark.parametrize("draw", ["fixed", "float"])
def test_straw2_draws_match_oracle(draw):
    m = make_map(TM)
    xs = np.arange(160, dtype=np.uint32)
    w = weights()
    for rule_id in (0, 1):
        np.testing.assert_array_equal(
            port_rows(m, rule_id, xs, w, 4, draw=draw),
            oracle_rows(m, rule_id, xs, w, 4, draw=draw))


def test_equal_weights_tie_to_the_first_item():
    # two items of one weight whose draws tie: mapper.c keeps the
    # earlier one; so must argmin/argmax on the card and here
    m = TM.CrushMap()
    m.add_type(3, "root")
    m.add_bucket(-1, 3, "straw2", [0, 1, 2, 3], [1.0, 1.0, 1.0, 1.0])
    m.root_id = -1
    TM.replicated_rule(m, 0, choose_type=0)
    xs = np.arange(400_000, dtype=np.uint32)
    h16 = np.stack([JH.hash32_3(xs, np.uint32(i), np.uint32(0)) & 0xFFFF
                    for i in range(4)], axis=1)
    srt = np.sort(h16, axis=1)
    tied = xs[(srt[:, 1:] == srt[:, :-1]).any(axis=1)][:40]
    assert len(tied) >= 10
    got = port_rows(m, 0, tied, T.full_weights(4), 1)[:, 0]
    om = OracleMapper(m)
    assert got.tolist() == [om.bucket_choose(-1, int(x), 0) for x in tied]
    # equal q values: the first slot wins
    q = torch.tensor([[9, 5, 5, 7], [4, 4, 4, 4]])
    assert q.argmin(dim=1).tolist() == [1, 0]


@pytest.mark.parametrize("firstn", [True, False], ids=["firstn", "indep"])
def test_multi_step_rule_matches_oracle(firstn):
    # take -> choose 2 racks -> chooseleaf 2 hosts each -> emit
    m = TM.build_hierarchy(32, 4, 2)
    m.tunables = TM.Tunables(choose_total_tries=7)
    choose = TM.STEP_CHOOSE_FIRSTN if firstn else TM.STEP_CHOOSE_INDEP
    m.add_rule(2, [TM.Step(TM.STEP_TAKE, arg=m.root_id),
                   TM.Step(choose, arg=2, type_id=2),
                   TM.Step(TM.STEP_CHOOSELEAF_INDEP, arg=2, type_id=1),
                   TM.Step(TM.STEP_EMIT)])
    xs = np.arange(64, dtype=np.uint32)
    w = weights(32)
    om = OracleMapper(m)
    got = port_rows(m, 2, xs, w, 4)
    for i, x in enumerate(xs):
        assert got[i].tolist() == om.do_rule(2, int(x), w, 4), f"x={x}"


def test_seeds_as_tensors_and_high_bits():
    m = make_map(TM)
    xs = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    w = weights()
    vm = T.VectorMapper(m, device="cpu")
    want = oracle_rows(m, 1, xs, w, 3)
    np.testing.assert_array_equal(vm.do_rule(1, xs, w, 3).numpy(), want)
    np.testing.assert_array_equal(
        vm.do_rule(1, torch.from_numpy(xs.astype(np.int64)), w, 3).numpy(),
        want)


def test_scan_rule_matches_twin_for_two_lane_splits():
    jm, tm = make_map(JM), make_map(TM)
    w = weights()
    jd, jlast = JV(jm).scan_rule(1, w, 3, 5, 64, 3)
    vm = T.VectorMapper(tm, device="cpu")
    d1, last1 = vm.scan_rule(1, w, 3, 5, 64, 3)
    d2, last2 = vm.scan_rule(1, w, 3, 5, 48, 4)
    assert d1 == jd == d2
    np.testing.assert_array_equal(last1.numpy(), np.asarray(jlast))
    np.testing.assert_array_equal(
        last2.numpy(), vm.do_rule(1, np.arange(149, 197), w, 3).numpy())
    all_rows = vm.do_rule(1, np.arange(5, 197), w, 3).numpy()
    assert d1 == int(np.bitwise_xor.reduce(all_rows.ravel()))


def test_retry_rounds_sync_once_each():
    m = make_map(TM, tries=5)
    vm = T.VectorMapper(m, device="cpu")
    vm.do_rule(1, np.arange(64, dtype=np.uint32), weights(), 3)
    # one sync per retry-round check: at least the one after round 0,
    # at most one per round
    assert 1 <= vm.host_syncs <= 5


def test_plan_bounds_the_descent():
    m = TM.build_hierarchy(10_000, osds_per_host=10, hosts_per_rack=25)
    TM.ec_rule(m, 1, choose_type=1)
    vm = T.VectorMapper(m, device="cpu")
    # root (40 racks) -> rack (25 hosts) -> host (10 osds): two steps
    # to a host, one more to a device, each no wider than its buckets
    assert vm._plan(1) == {1: ([40, 25], [10])}
    assert vm.max_depth + 1 == 4


def test_no_device_means_the_card():
    m = make_map(TM)
    if torch.cuda.is_available():
        assert T.VectorMapper(m).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.VectorMapper(m)
