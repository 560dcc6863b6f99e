"""The port's numpy oracle for the XOR schedule (xor_schedule_ref) held
against its twin's, and the port's schedule apply held against the
oracle, on liber8tion's and cauchy_good's bitmatrices, for batched and
single (n, L) inputs. Tolerance: none (bytes)."""

import numpy as np
import pytest
import torch

from ceph_tpu.ops import xor_kernels as J
from ceph_tpu_torch.ec import bitmatrix as TBM
from ceph_tpu_torch.ec import matrices as TM
from ceph_tpu_torch.gf import tables as TT
from ceph_tpu_torch.ops import xor_kernels as T


def _bitmatrix(name: str, k: int) -> np.ndarray:
    if name == "liber8tion":
        return TBM.liber8tion_bitmatrix(k)
    return TT.matrix_to_bitmatrix(TM.cauchy_good_matrix(k, 3))


CASES = [("liber8tion", 6, (4, 6, 8 * 40)), ("liber8tion", 8, (8, 8 * 16)),
         ("cauchy_good", 4, (3, 4, 8 * 33)), ("cauchy_good", 5, (5, 8 * 8))]


@pytest.mark.parametrize("name,k,shape", CASES,
                         ids=[f"{c[0]}-k{c[1]}-{len(c[2])}d" for c in CASES])
def test_xor_schedule_ref_matches_twin(name, k, shape):
    bm = _bitmatrix(name, k)
    data = np.random.default_rng(k + len(shape)).integers(
        0, 256, shape, dtype=np.uint8)
    want = J.xor_schedule_ref(bm, 8, data)
    got = T.xor_schedule_ref(bm, 8, data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    batched = data if data.ndim == 3 else data[None]
    out = T.make_xor_encoder(bm, 8)(torch.from_numpy(batched)).numpy()
    np.testing.assert_array_equal(out.reshape(want.shape), want)
