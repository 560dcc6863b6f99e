"""The CRC32C kernel's split-and-combine (csrc/csum.cu), modelled in torch
by ceph_tpu_torch.csum.kernels.crc32c_split_ref with the same plans and
shift-matrix constants the kernel is launched with, held bit-exact
against the reference oracle on the CPU: every row length 0..300 at
several segment counts and item widths (so rows spread over several
items, and the virtual zero padding, the tail and both seed
conventions are all exercised), rows off the 16-byte grid (the
kernel's realigned loads, at offsets 0-3 and more, odd pitches), the
plans `plan_for` gives the card at the main path's shapes (the
short-row plan, few long rows over every SM), and the multi-set
launch (`crc32c_sets_ref`: items numbered set after set and walked by
the persistent grid) against crc32c_sets_plain and separate calls."""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.csum import kernels as TC
from ceph_tpu_torch.csum.reference import apply_shift, ceph_crc32c, crc32c

# (segments, threads of a row in one block): one block a row, a block
# holding several rows' segments, a row over 2, 4 and 16 blocks
SPLITS = [(1, 256), (2, 256), (4, 2), (8, 256), (16, 4), (16, 1), (64, 4)]


@pytest.mark.parametrize("segments,block_threads", SPLITS)
def test_split_model_equals_the_oracle_at_every_length(segments,
                                                       block_threads):
    rng = np.random.default_rng(segments * 1000 + block_threads)
    for L in range(0, 301):
        rows = rng.integers(0, 256, (2, L), np.uint8)
        plan = TC.make_plan(L, segments, block_threads)
        assert plan.segments * plan.seg - plan.units == plan.pad >= 0
        got = TC.crc32c_split_ref(torch.from_numpy(rows), plan,
                                  init=0xFFFFFFFF, xorout=0)
        want = [ceph_crc32c(0xFFFFFFFF, r.tobytes()) for r in rows]
        assert got.tolist() == want, (L, plan)


@pytest.mark.parametrize("L", [0, 5, 31, 32, 33, 255, 1000])
def test_split_model_standard_crc_and_extend(L):
    rows = np.random.default_rng(L).integers(0, 256, (3, L), np.uint8)
    regs = np.array([0, 0xDEADBEEF, 0xFFFFFFFF], np.uint32)
    for plan in (TC.make_plan(L, 4, 2), TC.make_plan(L, 32, 8)):
        got = TC.crc32c_split_ref(torch.from_numpy(rows), plan)
        assert got.tolist() == [crc32c(r.tobytes()) for r in rows]
        ext = TC.crc32c_split_ref(torch.from_numpy(rows), plan, regs=regs)
        assert ext.tolist() == [ceph_crc32c(int(g), r.tobytes())
                                for g, r in zip(regs, rows)]


@pytest.mark.parametrize("B,L", [(256, 524288), (96, 524288), (32, 524288),
                                 (11, 524288), (64, 4093), (262144, 4096),
                                 (1, 0), (3, 7), (1, 1 << 30)])
def test_plan_for_the_card(B, L):
    plan = TC.plan_for(B, L, 132)
    S, every = plan.segments, 132 * TC.ITEMS_PER_SM
    assert S & (S - 1) == 0 and S <= 1 << TC.MAX_LEVELS
    assert plan.levels + 2 == len(TC.plan_cols(plan))
    # a warp's lanes an item: all of a row's (S >= 32) or 32 // S rows'
    assert plan.log_lanes == min(plan.levels, 5)
    assert plan.nb * min(S, TC.WARP) == S
    # the fewest segments that fill every warp of the card once, while a
    # segment keeps MIN_SEG_UNITS units (or the row has fewer)
    assert S == 1 or plan.seg >= TC.MIN_SEG_UNITS
    doubled = TC.make_plan(L, 2 * S)
    assert plan.items(B) >= every or doubled.seg < TC.MIN_SEG_UNITS
    assert S == 1 or TC.make_plan(L, S // 2).items(B) < every
    cols = TC.plan_cols(plan)
    for level in (0, plan.levels - 1):
        if level >= 0 and plan.levels:
            nbytes = plan.seg * TC.UNIT << level
            assert int(np.bitwise_xor.reduce(
                [cols[level][b] for b in range(32) if (0xA5A5A5A5 >> b) & 1]
            )) == apply_shift(0xA5A5A5A5, nbytes)


def test_split_model_at_a_card_plan():
    # the plan the card gets for 3 rows of 20,000 bytes with 16 SMs: 128
    # segments of 5 units (fewer units would leave a lane under 4), a
    # row over 4 warp items
    rows = np.random.default_rng(5).integers(0, 256, (3, 20000), np.uint8)
    plan = TC.plan_for(3, 20000, 16)
    assert (plan.segments, plan.seg, plan.log_lanes) == (128, 5, 5)
    assert (plan.nb, plan.items(3)) == (4, 12)
    got = TC.crc32c_split_ref(torch.from_numpy(rows), plan,
                              init=0xFFFFFFFF, xorout=0)
    assert got.tolist() == TC.crc32c_blocks(
        torch.from_numpy(rows), init=0xFFFFFFFF, xorout=0).tolist()


def _rows_at(rng, B, L, offset, extra):
    """(B, L) rows `offset` bytes into a buffer, L + extra apart."""
    flat = torch.from_numpy(rng.integers(0, 256, offset + B * (L + extra)
                                         + 16, np.uint8))
    return flat[offset:offset + B * (L + extra)].view(B, L + extra)[:, :L]


@pytest.mark.parametrize("offset,extra", [(0, 0), (1, 0), (2, 3), (3, 1),
                                          (1, 5), (4, 7), (8, 0), (13, 2)])
def test_realigned_loads_equal_the_oracle_at_every_length(offset, extra):
    # rows off the 16-byte grid (the start `offset` bytes in, pitches L +
    # extra, odd ones among them) read through the realigned loads, at a
    # warp a row and at rows spread over several items; the model raises
    # if a load reads a word that holds no byte of its row
    rng = np.random.default_rng(100 + 16 * offset + extra)
    for L in range(0, 301):
        rows = _rows_at(rng, 3, L, offset, extra)
        want = [ceph_crc32c(0xFFFFFFFF, r.numpy().tobytes()) for r in rows]
        for plan in (TC.make_plan(L, 2), TC.make_plan(L, 64)):
            got = TC.crc32c_split_ref(rows, plan, init=0xFFFFFFFF, xorout=0)
            assert got.tolist() == want, (L, plan, offset, extra)


@pytest.mark.parametrize("B", [64, 96])
def test_short_row_plan_rmw_rows(B):
    # the RMW delta's rows: 4093 bytes, 4093 apart; a warp a row, 32
    # segments of 4 units (one virtual zero unit in front), one item a
    # row, rows read through the realigned loads
    plan = TC.plan_for(B, 4093, 132)
    assert (plan.segments, plan.seg, plan.pad, plan.nb) == (32, 4, 1, 1)
    assert plan.items(B) == B
    rng = np.random.default_rng(B)
    rows = _rows_at(rng, B, 4093, 0, 0)
    assert rows.stride(0) == 4093
    regs = rng.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32)
    got = TC.crc32c_split_ref(rows, plan, regs=regs)
    want = [ceph_crc32c(int(g), r.numpy().tobytes())
            for g, r in zip(regs, rows)]
    assert got.tolist() == want
    assert torch.equal(TC.crc32c_split_ref(rows, plan, init=0, xorout=0),
                       TC.crc32c_blocks(rows, 0, 0))


@pytest.mark.parametrize("B", [1, 2, 4, 11, 16])
def test_few_long_rows_spread_over_every_sm(B):
    # few rows of 512 KiB: a warp item for every SM (132), each lane 4
    # units or more; one row stops at 128 items of 4 units a lane
    plan = TC.plan_for(B, 524288, 132)
    assert plan.seg >= TC.MIN_SEG_UNITS
    assert plan.items(B) >= 132 if B > 1 else \
        (plan.items(1), plan.seg) == (128, TC.MIN_SEG_UNITS)
    assert plan.nb >= 32 // B


def test_plans_for_share_the_card_by_bytes():
    # the fused write's one launch: 256 data and 96 parity rows of 512
    # KiB get the warps one set of 352 rows would, in proportion
    every = 132 * TC.ITEMS_PER_SM
    pd, pp = TC.plans_for([(256, 524288), (96, 524288)], 132)
    assert pd == pp == TC.plan_for(352, 524288, 132)
    assert pd.items(256) + pp.items(96) >= every
    # the RMW delta's: each set short rows at a warp a row
    assert [p.segments for p in TC.plans_for([(64, 4093), (96, 4093)],
                                             132)] == [32, 32]
    # the recovery program's rebuilt rows and shorter fold rows
    pr, pf = TC.plans_for([(64, 3072), (32, 1536)], 132)
    assert (pr.L, pf.L) == (3072, 1536)
    assert pr.seg >= TC.MIN_SEG_UNITS and pf.seg >= TC.MIN_SEG_UNITS


def _mixed_sets(rng):
    regs = rng.integers(0, 1 << 32, 4, dtype=np.uint64).astype(np.uint32)
    return [TC.CrcRows(_rows_at(rng, 5, 777, 0, 0), 0xFFFFFFFF, 0),
            TC.CrcRows(_rows_at(rng, 4, 300, 3, 3), regs=regs),
            TC.CrcRows(_rows_at(rng, 40, 64, 1, 0)),
            TC.CrcRows(_rows_at(rng, 2, 4093, 2, 1), 0, 0)]


@pytest.mark.parametrize("sms", [1, 3, 16, 132])
def test_sets_model_equals_the_plain_version(sms):
    # up to four sets of their own L, offsets and seeds in one launch:
    # items numbered set after set, walked by the persistent grid
    rng = np.random.default_rng(sms)
    sets = _mixed_sets(rng)
    for n in (1, 2, 3, 4):
        assert torch.equal(TC.crc32c_sets_ref(sets[:n], sms),
                           TC.crc32c_sets_plain(sets[:n]))
    assert TC.crc32c_sets_ref([TC.CrcRows(torch.zeros((0, 9), dtype=
                                                      torch.uint8))],
                              sms).numel() == 0


def test_sets_plain_equals_separate_calls():
    rng = np.random.default_rng(77)
    sets = _mixed_sets(rng)
    want = torch.cat([
        TC.crc32c_blocks(sets[0].blocks, 0xFFFFFFFF, 0),
        TC.crc32c_extend(sets[1].regs, sets[1].blocks),
        TC.crc32c_blocks(sets[2].blocks),
        TC.crc32c_blocks(sets[3].blocks, 0, 0)])
    assert torch.equal(TC.crc32c_sets_plain(sets), want)
    assert torch.equal(TC.crc32c_sets(sets), want)
    # both seed conventions against the oracle, row by row
    rows = sets[1].blocks
    assert TC.crc32c_sets(sets)[5:9].tolist() == [
        ceph_crc32c(int(g), r.numpy().tobytes())
        for g, r in zip(sets[1].regs, rows)]
    assert TC.crc32c_sets(sets)[9:49].tolist() == [
        crc32c(r.numpy().tobytes()) for r in sets[2].blocks]


def test_sets_refuse_bad_calls():
    x = torch.zeros((2, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="1 to 4 row sets"):
        TC.crc32c_sets([])
    with pytest.raises(ValueError, match="1 to 4 row sets"):
        TC.crc32c_sets([TC.CrcRows(x)] * 5)
    meta = torch.zeros((2, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        TC.crc32c_sets([TC.CrcRows(x), TC.CrcRows(meta)])
    before = dict(TC.launches), dict(TC.shapes)
    with pytest.raises(ValueError, match="cuda or cpu"):
        TC.crc32c_sets([TC.CrcRows(meta)])
    assert (dict(TC.launches), dict(TC.shapes)) == before


@pytest.mark.parametrize("L,S", [(4093, 32), (524288, 512), (300, 4),
                                 (65536, 64)])
def test_plan_mats_layout(L, S):
    # the kernel's matrices of a plan: lane j's column b at [32 b + j]
    # (the shift past the later segments of its row in its item), then
    # the level, tail and length matrices as plan_cols gives them
    plan = TC.make_plan(L, S)
    mats = TC.plan_mats(plan)
    n = 1 << plan.log_lanes
    assert mats.dtype == np.uint32 and mats.shape == (1024 + 32 * (
        plan.levels + 2),)
    x = 0x9E3779B9
    for j in range(32):
        got = 0
        for b in range(32):
            if (x >> b) & 1:
                got ^= int(mats[32 * b + j])
        nbytes = (n - 1 - j) * plan.seg * TC.UNIT
        assert got == (apply_shift(x, nbytes) if j < n else 0), j
    assert np.array_equal(mats[1024:].reshape(-1, 32), TC.plan_cols(plan))


def test_staging_layout_moves_each_chunk_once_without_conflicts():
    # the kernel's staging of a round (csrc/csum.cu): copy lane t moves
    # chunk cc = t % 8 of owners o = 4 i + t // 8 (i = 0..7) to slot
    # 32 i + cslot[i % 2]; owner l reads chunk k from slot 8 l + (k ^ l %
    # 8). Every (owner, chunk) lands in its own slot, each owner reads
    # back what was copied for it, and no quarter warp (8 lanes, 128
    # bytes) of a copy or a read meets a bank conflict.
    where = {}
    for i in range(8):
        groups = {}
        for t in range(32):
            cc, cq = t % 8, t // 8
            cslot = [8 * cq + (cc ^ cq), 8 * cq + (cc ^ (cq + 4))]
            o, slot = 4 * i + cq, 32 * i + cslot[i % 2]
            assert slot == 8 * o + (cc ^ (o % 8))
            assert slot not in where.values()
            where[(o, cc)] = slot
            groups.setdefault(t // 8, []).append(slot % 8)
        assert all(len(set(g)) == 8 for g in groups.values())
    assert sorted(where.values()) == list(range(256))
    for k in range(8):
        slots = [8 * lane + (k ^ (lane % 8)) for lane in range(32)]
        assert slots == [where[(lane, k)] for lane in range(32)]
        for q in range(4):
            assert len({x % 8 for x in slots[8 * q:8 * q + 8]}) == 8


def test_bad_plans_and_devices_raise():
    with pytest.raises(ValueError, match="power of two"):
        TC.make_plan(100, 3)
    with pytest.raises(ValueError, match="power of two"):
        TC.make_plan(100, 4, 512)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        TC.make_plan(1 << 31, 1)
    with pytest.raises(ValueError, match="plan for rows"):
        TC.crc32c_split_ref(torch.zeros((1, 64), dtype=torch.uint8),
                            TC.make_plan(32, 1))
    before = dict(TC.launches)
    meta = torch.zeros((2, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        TC.crc32c_blocks(meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        TC.crc32c_extend(np.zeros(2, np.uint32), meta)
    TC.crc32c_blocks(torch.zeros((2, 64), dtype=torch.uint8))
    assert dict(TC.launches) == before


def test_plain_versions_are_the_cpu_path():
    rows = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, 999), np.uint8))
    regs = np.array([1, 2, 3, 4], np.uint32)
    assert torch.equal(TC.crc32c_blocks(rows, 7, 9),
                       TC.crc32c_blocks_plain(rows, 7, 9))
    assert torch.equal(TC.crc32c_extend(regs, rows),
                       TC.crc32c_extend_plain(regs, rows))


def test_csum_build_failure_raises_and_leaves_nothing(tmp_path):
    from ceph_tpu_torch.utils import nvcc
    with pytest.raises(RuntimeError, match="nvcc failed on csum.cu"):
        nvcc.build(TC._SRC, tmp_path, lambda: "false")
    assert not list(tmp_path.iterdir())
