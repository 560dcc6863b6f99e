"""The port's batched CRC32C (ceph_tpu_torch.csum.kernels) held bit-exact
against its JAX twin (ceph_tpu.csum.kernels) and the reference oracle,
on the same numpy-seeded rows, on the CPU.

The JAX twin compiles one program per block length (about a second
each on the CPU), so it is compared at a spread of lengths; the oracle
is compared at every length 0..300.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.csum import kernels as JC
from ceph_tpu.csum.reference import ceph_crc32c
from ceph_tpu_torch.csum import kernels as TC
from ceph_tpu_torch.csum import reference as TR

JAX_LENGTHS = [0, 1, 7, 8, 9, 63, 64, 65, 200, 301, 4096]


def _rows(n, L, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, L), np.uint8)


def _u32(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int64
    v = t.numpy()
    assert ((v >= 0) & (v < 1 << 32)).all()
    return v.astype(np.uint32)


@pytest.mark.parametrize("L", JAX_LENGTHS)
def test_crc32c_blocks_matches_jax_twin(L):
    rows = _rows(3, L, seed=L)
    want = np.asarray(JC.crc32c_blocks(rows, init=0xFFFFFFFF, xorout=0))
    got = _u32(TC.crc32c_blocks(torch.from_numpy(rows), init=0xFFFFFFFF,
                                xorout=0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("L", [0, 5, 64, 100, 4096])
def test_crc32c_extend_matches_jax_twin(L):
    rows = _rows(4, L, seed=L + 1)
    regs = np.array([0, 1, 0xFFFFFFFF, 0xDEADBEEF], np.uint32)
    want = np.asarray(JC.crc32c_extend(regs, rows))
    np.testing.assert_array_equal(
        _u32(TC.crc32c_extend(regs, torch.from_numpy(rows))), want)
    np.testing.assert_array_equal(
        _u32(TC.crc32c_extend(torch.from_numpy(regs.astype(np.int64)),
                              torch.from_numpy(rows))), want)


def test_crc32c_blocks_every_length_matches_oracle():
    rng = np.random.default_rng(7)
    for L in range(0, 301):
        rows = rng.integers(0, 256, (2, L), np.uint8)
        got = _u32(TC.crc32c_blocks(torch.from_numpy(rows),
                                    init=0xFFFFFFFF, xorout=0))
        want = [ceph_crc32c(0xFFFFFFFF, r.tobytes()) for r in rows]
        assert [int(g) for g in got] == want, L


def test_crc32c_extend_chains_like_the_oracle():
    a, b = _rows(3, 37, seed=1), _rows(3, 91, seed=2)
    regs = np.full(3, 0xFFFFFFFF, np.uint32)
    mid = TC.crc32c_extend(regs, torch.from_numpy(a))
    end = TC.crc32c_extend(mid, torch.from_numpy(b))
    whole = [ceph_crc32c(0xFFFFFFFF, np.concatenate([a[i], b[i]]))
             for i in range(3)]
    assert [int(v) for v in end] == whole


@pytest.mark.parametrize("data,want", [
    (bytes(32), 0x8A9136AA),                        # RFC 3720 B.4
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
    (bytes(range(31, -1, -1)), 0x113FDB5C),
    (b"123456789", 0xE3069283),
    (b"a", 0xC1D04330),
])
def test_crc32c_blocks_standard_vectors(data, want):
    rows = torch.frombuffer(bytearray(data), dtype=torch.uint8)[None]
    assert int(TC.crc32c_blocks(rows)[0]) == want
    assert TR.crc32c(data) == want


def test_crc32c_blocks_rejects_bad_input():
    with pytest.raises(ValueError, match="uint8"):
        TC.crc32c_blocks(torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="uint8"):
        TC.crc32c_blocks(torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(ValueError, match="regs must be"):
        TC.crc32c_extend(np.zeros(3, np.uint32),
                         torch.zeros((2, 8), dtype=torch.uint8))


def test_reference_copy_matches_twin():
    from ceph_tpu.csum import reference as JR
    np.testing.assert_array_equal(TR.crc32c_slice8_tables(),
                                  JR.crc32c_slice8_tables())
    for n in (1, 8, 4096, 524288):
        np.testing.assert_array_equal(TR.shift_matrix(n), JR.shift_matrix(n))
        assert TR.apply_shift(0xFFFFFFFF, n) == JR.apply_shift(0xFFFFFFFF, n)
    assert TR.xxh64(b"abc", 7) == JR.xxh64(b"abc", 7)
