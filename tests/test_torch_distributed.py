"""The port's multi-host wiring, as tests/test_distributed.py runs the
twin's: 2 "hosts" x 2 gloo ranks on localhost (init_process with
local_devices=2), host_mesh(shard=2), per-host data from seeds 7 + host.
Each rank's block of global_batch, of the sharded encode and of the
decode of (0, 5) from (1, 2, 3, 4) must equal the matching slice of the
numpy oracle on its own host's data. Tolerance: none."""

import numpy as np
import pytest

from ceph_tpu.ec.matrices import reed_sol_van_matrix
from ceph_tpu.gf.numpy_ref import encode_ref
from torch_mesh_helpers import distributed_rank, finish, start_ranks

WORLD, K, M, L, B_LOCAL = 4, 4, 2, 4096, 8


@pytest.fixture(scope="module")
def ranks():
    ctx, out = start_ranks(distributed_rank, WORLD)
    return finish(ctx, out, WORLD)


def _want_full(host: int) -> np.ndarray:
    local = np.random.default_rng(7 + host).integers(0, 256, (B_LOCAL, K, L),
                                                     dtype=np.uint8)
    return np.concatenate([local, encode_ref(reed_sol_van_matrix(K, M),
                                             local)], axis=1)


def test_host_mesh_keeps_shard_rows_inside_a_host(ranks):
    for rank, (_arrays, meta) in enumerate(ranks):
        assert meta["device"] == "cpu"
        devices = np.asarray(meta["devices"])
        assert devices.shape == (2, 2)
        for row in devices:
            assert len({int(r) // 2 for r in row}) == 1
        assert rank in devices


@pytest.mark.parametrize("what", ("data", "chunks", "rebuilt"))
def test_each_rank_block_equals_its_hosts_oracle(ranks, what):
    for rank, (arrays, meta) in enumerate(ranks):
        host = rank // 2
        block = meta[what]
        (b0, b1), *rest = block["index"]
        assert block["shape"][0] == 2 * B_LOCAL
        assert host * B_LOCAL <= b0 < b1 <= (host + 1) * B_LOCAL
        want = _want_full(host)[b0 - host * B_LOCAL:b1 - host * B_LOCAL]
        if what == "data":
            want = want[:, :K]
        elif what == "chunks":
            c0, c1 = rest[0]
            want = want[:, c0:c1]
            assert block["wire"]["calls"] == 0
        else:
            want = want[:, [0, 5]]
            assert block["wire"]["calls"] == 1
        np.testing.assert_array_equal(arrays[what], want)


def test_host_mesh_and_global_batch_refusals(ranks):
    for _arrays, meta in ranks:
        errs = meta["errors"]
        assert errs["shard_3"] == ("shard=3 does not divide the 2 local "
                                   "devices per host")
        assert errs["heterogeneous"].startswith(
            "heterogeneous hosts {0: 3, 1: 1}; host_mesh needs the same "
            "device count per process")
        assert "lay the mesh out with host_mesh" in errs["cross_host"]
