"""The port's Checksummer (ceph_tpu_torch.csum.checksummer) held against
its JAX twin (ceph_tpu.csum.checksummer): every case of
tests/test_csum.py::TestChecksummer on the same numpy-seeded data, the
port on the CPU (device="cpu", the kernels' plain versions) and
device=False (the oracle, as in the twin)."""

import numpy as np
import pytest
import torch

from ceph_tpu.csum import Checksummer as JChecksummer
from ceph_tpu_torch.csum import CSUM_ALGORITHMS, Checksummer
from ceph_tpu_torch.csum import checksummer as TCS

CPU = "cpu"


def test_algorithms_are_the_twins():
    from ceph_tpu.csum import CSUM_ALGORITHMS as J
    assert CSUM_ALGORITHMS == J


@pytest.mark.parametrize("algo", CSUM_ALGORITHMS)
def test_device_matches_host_and_twin(algo):
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, size=8 * 256, dtype=np.uint8)
    cs = Checksummer(algo, block_size=256)
    got = cs.calculate(data, device=CPU)
    host = cs.calculate(data, device=False)
    twin = JChecksummer(algo, block_size=256).calculate(data)
    assert got.dtype == host.dtype == twin.dtype
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, twin)


@pytest.mark.parametrize("algo", CSUM_ALGORITHMS)
def test_oracle_gives_the_twins_array(algo):
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, size=(5, 128), dtype=np.uint8)
    got = Checksummer(algo, 128).calculate(data, device=False)
    want = JChecksummer(algo, 128).calculate(data, device=False)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", ["bytes", "tensor", "2d"])
def test_input_forms(form):
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, size=4 * 512, dtype=np.uint8)
    arg = {"bytes": data.tobytes(), "tensor": torch.from_numpy(data),
           "2d": data.reshape(4, 512)}[form]
    cs = Checksummer("xxhash64", 512)
    np.testing.assert_array_equal(
        cs.calculate(arg, device=torch.device("cpu")),
        JChecksummer("xxhash64", 512).calculate(data))


def test_verify_clean():
    cs = Checksummer("crc32c", block_size=128)
    data = np.arange(4 * 128, dtype=np.uint8) % 251
    assert cs.verify(data, cs.calculate(data, device=CPU), device=CPU) == -1
    assert JChecksummer("crc32c", 128).verify(
        data, cs.calculate(data, device=CPU)) == -1


def test_verify_reports_first_bad_offset():
    cs = Checksummer("crc32c", block_size=128)
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=6 * 128, dtype=np.uint8)
    sums = cs.calculate(data, device=CPU)
    corrupt = data.copy()
    corrupt[2 * 128 + 5] ^= 0x40  # flip a bit in block 2
    corrupt[5 * 128] ^= 0x01      # and block 5
    assert cs.verify(corrupt, sums, device=CPU) == 2 * 128
    assert cs.verify(corrupt, sums, device=False) == 2 * 128
    assert JChecksummer("crc32c", 128).verify(corrupt, sums) == 2 * 128
    with pytest.raises(ValueError, match="expected"):
        cs.verify(data, sums[:3], device=CPU)


def test_truncated_variants():
    data = np.arange(512, dtype=np.uint8)
    full = Checksummer("crc32c", 256).calculate(data, device=CPU)
    np.testing.assert_array_equal(
        full, JChecksummer("crc32c", 256).calculate(data))
    for algo, mask in (("crc32c_16", 0xFFFF), ("crc32c_8", 0xFF)):
        got = Checksummer(algo, 256).calculate(data, device=CPU)
        np.testing.assert_array_equal(got, full & mask)
        np.testing.assert_array_equal(
            got, JChecksummer(algo, 256).calculate(data))


def test_bad_sizes_rejected():
    cs = Checksummer("crc32c", block_size=128)
    with pytest.raises(ValueError, match="multiple"):
        cs.calculate(np.zeros(100, np.uint8), device=CPU)
    with pytest.raises(ValueError, match="multiple"):
        cs.calculate(torch.zeros(100, dtype=torch.uint8), device=CPU)
    with pytest.raises(ValueError, match="nblocks"):
        cs.calculate(np.zeros((2, 64), np.uint8), device=CPU)
    with pytest.raises(ValueError, match="uint8"):
        cs.calculate(torch.zeros(128, dtype=torch.int32), device=CPU)
    with pytest.raises(ValueError):
        Checksummer("nope", 128)
    with pytest.raises(ValueError):
        Checksummer("crc32c", 0)


def test_value_sizes():
    for algo in CSUM_ALGORITHMS:
        assert Checksummer(algo, 4096).csum_value_size == \
            JChecksummer(algo, 4096).csum_value_size
    assert Checksummer("crc32c", 4096).csum_value_size == 4
    assert Checksummer("crc32c_16", 4096).csum_value_size == 2
    assert Checksummer("crc32c_8", 4096).csum_value_size == 1
    assert Checksummer("xxhash64", 4096).csum_value_size == 8


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cs = Checksummer("crc32c", 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cs.calculate(np.zeros(64, np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cs.verify(np.zeros(64, np.uint8), np.zeros(1, np.uint32))
    assert cs.calculate(np.zeros(64, np.uint8), device=False).shape == (1,)


def test_a_tensor_stays_where_it_lies(monkeypatch):
    # the blocks reach the kernels' wrappers as the caller's tensor
    seen = []
    real = TCS.kernels.xxh32_blocks

    def spy(blocks, seed=0):
        seen.append(blocks)
        return real(blocks, seed)
    monkeypatch.setattr(TCS.kernels, "xxh32_blocks", spy)
    t = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (3, 64), np.uint8))
    Checksummer("xxhash32", 64).calculate(t, device=CPU)
    assert seen[0].data_ptr() == t.data_ptr()
