"""The port's batched XXH32 / XXH64 (ceph_tpu_torch.csum.kernels) held
bit-exact against their JAX twins (ceph_tpu.csum.kernels) and the
reference oracle, on the same numpy-seeded rows, on the CPU (where the
wrappers run their plain torch versions)."""

import numpy as np
import pytest
import torch

from ceph_tpu.csum import kernels as JC
from ceph_tpu_torch.csum import kernels as TC
from ceph_tpu_torch.csum import reference as TR

# tests/test_csum.py's lengths, and one past 4 KiB with a ragged tail
LENGTHS = [0, 1, 3, 4, 15, 16, 17, 31, 32, 33, 100, 4096, 4099]
SEEDS = [0, 42]


def _rows(n, L, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, L), np.uint8)


def _u64(pairs: torch.Tensor) -> list[int]:
    assert pairs.dtype == torch.int64 and pairs.shape[1:] == (2,)
    v = pairs.numpy()
    assert ((v >= 0) & (v < 1 << 32)).all()
    return [(int(hi) << 32) | int(lo) for hi, lo in v]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("L", LENGTHS)
def test_xxh32_blocks_matches_jax_twin_and_oracle(L, seed):
    rows = _rows(4, L, 1000 + L)
    got = TC.xxh32_blocks(torch.from_numpy(rows), seed=seed)
    assert got.dtype == torch.int64 and got.shape == (4,)
    want = np.asarray(JC.xxh32_blocks(rows, seed=seed))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert got.tolist() == [TR.xxh32(r.tobytes(), seed) for r in rows]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("L", LENGTHS)
def test_xxh64_blocks_matches_jax_twin_and_oracle(L, seed):
    rows = _rows(4, L, 2000 + L)
    got = TC.xxh64_blocks(torch.from_numpy(rows), seed=seed)
    want = np.asarray(JC.xxh64_blocks(rows, seed=seed))      # [hi, lo]
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert _u64(got) == [TR.xxh64(r.tobytes(), seed) for r in rows]


@pytest.mark.parametrize("seed", [1, 0xFFFFFFFF, (1 << 64) - 1, 1 << 40])
def test_wide_seeds_match_the_oracle(seed):
    rows = _rows(3, 77, seed & 0xFFFF)
    assert TC.xxh32_blocks(torch.from_numpy(rows), seed).tolist() == \
        [TR.xxh32(r.tobytes(), seed & 0xFFFFFFFF) for r in rows]
    assert _u64(TC.xxh64_blocks(torch.from_numpy(rows), seed)) == \
        [TR.xxh64(r.tobytes(), seed) for r in rows]


def test_row_views_and_empty_batches():
    # rows at an odd offset and pitch (a view), and B = 0
    flat = _rows(1, 5 * 101 + 3, 9)[0]
    view = torch.from_numpy(flat)[3:].view(5, 101)[:, :97]
    rows = view.numpy()
    assert TC.xxh32_blocks(view).tolist() == [TR.xxh32(r.tobytes())
                                             for r in rows]
    assert _u64(TC.xxh64_blocks(view, 5)) == [TR.xxh64(r.tobytes(), 5)
                                              for r in rows]
    empty = torch.zeros((0, 64), dtype=torch.uint8)
    assert TC.xxh32_blocks(empty).shape == (0,)
    assert TC.xxh64_blocks(empty).shape == (0, 2)


def test_published_vectors():
    for data, h32, h64 in ((b"", 0x02CC5D05, 0xEF46DB3751D8E999),
                           (b"a", 0x550D7456, 0xD24EC4F1A98C6E5B),
                           (b"abc", 0x32D153FF, 0x44BC2CF5AD770999)):
        rows = torch.frombuffer(bytearray(data), dtype=torch.uint8)[None] \
            if data else torch.zeros((1, 0), dtype=torch.uint8)
        assert int(TC.xxh32_blocks(rows)[0]) == h32
        assert _u64(TC.xxh64_blocks(rows)) == [h64]


def test_other_devices_and_bad_input_raise():
    before = dict(TC.launches)
    meta = torch.zeros((2, 64), dtype=torch.uint8, device="meta")
    for fn in (TC.xxh32_blocks, TC.xxh64_blocks):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(meta)
        with pytest.raises(ValueError, match="uint8"):
            fn(torch.zeros((2, 8), dtype=torch.int32))
        with pytest.raises(ValueError, match="uint8"):
            fn(torch.zeros(8, dtype=torch.uint8))
    TC.xxh32_blocks(torch.zeros((2, 64), dtype=torch.uint8))
    assert dict(TC.launches) == before          # the CPU launches nothing
