"""The CRC32C kernel's split-and-combine (csrc/csum.cu), modelled in torch
by ceph_tpu_torch.csum.kernels.crc32c_split_ref with the same plans and
shift-matrix constants the kernel is launched with, held bit-exact
against the reference oracle on the CPU: every row length 0..300 at
several segment counts and block widths (so rows spread over several
blocks, and the virtual zero padding, the tail and both seed
conventions are all exercised), and the plans `plan_for` gives the card
at the main path's shapes."""

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
    S = plan.segments
    assert S & (S - 1) == 0 and S <= 1 << TC.MAX_LEVELS
    assert plan.levels + 2 == len(TC.plan_cols(plan))
    assert S == 1 or plan.seg >= TC.MIN_SEG_UNITS
    assert S == 1 or B * S <= 132 * TC.THREADS_PER_SM
    assert plan.nb * min(S, TC.BLOCK_THREADS) == S
    cols = TC.plan_cols(plan)
    for level in (0, plan.levels - 1):
        if level >= 0 and plan.levels:
            nbytes = plan.seg * TC.UNIT << level
            assert int(np.bitwise_xor.reduce(
                [cols[level][b] for b in range(32) if (0xA5A5A5A5 >> b) & 1]
            )) == apply_shift(0xA5A5A5A5, nbytes)


def test_split_model_at_a_card_plan():
    # the plan the card gets for 3 rows of 20,000 bytes with 16 SMs:
    # 64 segments of 10 units, two rows a block
    rows = np.random.default_rng(5).integers(0, 256, (3, 20000), np.uint8)
    plan = TC.plan_for(3, 20000, 16)
    assert (plan.segments, plan.seg, plan.log_sblk) == (64, 10, 6)
    got = TC.crc32c_split_ref(torch.from_numpy(rows), plan,
                              init=0xFFFFFFFF, xorout=0)
    assert got.tolist() == TC.crc32c_blocks(
        torch.from_numpy(rows), init=0xFFFFFFFF, xorout=0).tolist()


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
