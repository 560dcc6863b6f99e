"""The plain reference against known values and against the port's CPU
path at tiny sizes (the port is only read here, never by the
reference)."""

import numpy as np
import pytest
import torch

from ecbench.ops.write import reference_parity
from ecbench.reference import codes, crc, gf


def test_crc32c_check_value():
    row = torch.tensor(list(b"123456789"), dtype=torch.uint8)[None]
    assert int(crc.crc32c_raw(row)[0]) ^ 0xFFFFFFFF == 0xE3069283


@pytest.mark.parametrize("L", [1, 63, 64, 65, 4093, 65536])
@pytest.mark.parametrize("seed", [0, 0xFFFFFFFF])
def test_crc32c_against_the_port(L, seed):
    from ceph_tpu_torch.csum.kernels import crc32c_blocks_plain
    g = torch.Generator().manual_seed(L)
    rows = torch.randint(0, 256, (5, L), generator=g, dtype=torch.uint8)
    want = crc32c_blocks_plain(rows, init=seed, xorout=0)
    assert torch.equal(crc.crc32c_raw(rows, seed=seed, max_rows=2), want)


def test_gf_field():
    for a in range(1, 256):
        assert gf.mul(a, gf.inv(a)) == 1
    assert gf.mul(0x80, 2) == 0x1D


@pytest.mark.parametrize("k, m", [(8, 3), (8, 4), (4, 2)])
def test_rs_matrix_is_the_ports(k, m):
    from ceph_tpu_torch.ec.matrices import reed_sol_van_matrix
    assert np.array_equal(codes.rs_matrix(k, m), reed_sol_van_matrix(k, m))


def test_gf_apply_against_the_port():
    from ceph_tpu_torch.ops.gf_kernel import apply_matrix_plain
    M = codes.rs_matrix(8, 3)
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 256, (2, 8, 1000), generator=g, dtype=torch.uint8)
    assert torch.equal(gf.apply(M, x, max_elems=5000),
                       apply_matrix_plain(M, x))


def test_clay_matrices_are_the_ports():
    from ceph_tpu_torch.ec.registry import factory
    port = factory("plugin=clay k=8 m=4 d=11", device="cpu")
    ref = codes.Clay(8, 4, 11)
    enc, _ = port._affine_decode(tuple(range(8, 12)), tuple(range(8)))
    assert np.array_equal(ref.encode_matrix(), enc)
    rep, planes = port.repair_plan_matrix(0, list(range(1, 12)))
    assert planes == ref.repair_planes(0)
    assert np.array_equal(ref.repair_matrix(0, list(range(1, 12))), rep)


@pytest.mark.parametrize("profile, config", [
    ("plugin=jerasure technique=reed_sol_van k=8 m=3",
     {"profile": {"plugin": "jerasure", "technique": "reed_sol_van",
                  "k": 8, "m": 3}}),
    ("plugin=clay k=8 m=4 d=11",
     {"profile": {"plugin": "clay", "k": 8, "m": 4, "d": 11}}),
])
def test_reference_parity_is_the_ports_encode(profile, config):
    from ceph_tpu_torch.ec.registry import factory
    coder = factory(profile, device="cpu")
    g = torch.Generator().manual_seed(5)
    d = torch.randint(0, 256, (2, 8, 64 * 16), generator=g,
                      dtype=torch.uint8)
    assert torch.equal(reference_parity(config, d), coder.encode_chunks(d))
