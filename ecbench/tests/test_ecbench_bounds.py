"""The copied roofline arithmetic at the shapes of PERF.md's kernel
table, against its bound column (ms)."""

import numpy as np
import pytest

from ecbench.peaks import crc_bound, gf_bound
from ecbench.reference import codes

RS = codes.rs_matrix(8, 3)


def _nnz(m):
    return int((np.asarray(m) != 0).sum())


@pytest.fixture(scope="module")
def clay():
    return codes.Clay(8, 4, 11)


@pytest.mark.parametrize("shape, nnz, ms, by", [     # (B, k, m, L)
    ((32, 8, 3, 524288), 24, 0.0551, "bytes"),
    ((32, 8, 1, 524288), 8, 0.0451, "bytes"),
    ((1, 8, 1, 524288), 8, 0.00141, "bytes"),
    ((32, 4, 1, 524288), 4, 0.0250, "bytes"),
    ((32, 8, 4, 524288), 32, 0.0601, "bytes"),
    ((32, 4, 3, 1048576), 12, 0.0701, "bytes"),
])
def test_gf_bound_rows(shape, nnz, ms, by):
    got, kind = gf_bound(*shape, nnz)
    assert kind == by and got == pytest.approx(ms, rel=0.01)


def test_gf_bound_clay_rows(clay):
    enc = clay.encode_matrix()
    rep = clay.repair_matrix(0, list(range(1, 12)))
    assert enc.shape == (256, 512) and _nnz(enc) == 6272
    assert rep.shape == (64, 176) and _nnz(rep) == 944
    ms, kind = gf_bound(32, 512, 256, 8192, _nnz(enc))
    assert kind == "operations" and ms == pytest.approx(0.1063, rel=0.01)
    ms, kind = gf_bound(32, 176, 64, 8192, _nnz(rep))
    assert kind == "bytes" and ms == pytest.approx(0.0188, rel=0.01)


@pytest.mark.parametrize("sets, ms", [
    ([(256, 524288)], 0.0401),
    ([(256, 524288), (96, 524288)], 0.0551),
    ([(64, 524288), (32, 524288)], 0.0150),
    ([(8, 524288)], 0.00125),
])
def test_crc_bound_rows(sets, ms):
    got, kind = crc_bound(sets)
    assert kind == "bytes" and got == pytest.approx(ms, rel=0.01)
