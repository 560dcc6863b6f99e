"""The port's GF(2^8) apply (ceph_tpu_torch.ops) held bit-exact against
its JAX twin (ceph_tpu.ops) on the same numpy-seeded inputs, on the CPU.

On a CPU tensor impl="pallas" runs the hand kernel's plain torch version
(ops/gf_kernel.py); the JAX side runs the Pallas kernel in interpret
mode, about 2 s a call, so those cases are few. The CUDA kernel itself
is held against the plain version by chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec.matrices import reed_sol_van_matrix
from ceph_tpu.gf import numpy_ref as R
from ceph_tpu.gf.tables import bit_powers
from ceph_tpu.ops import rs_kernels as JK
from ceph_tpu_torch.ops import gf_kernel as G
from ceph_tpu_torch.ops import rs_kernels as TK

IMPLS = ["bitlinear", "mxu", "logexp", "pallas"]


def _rand(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


def _port(matrix, data, impl):
    return TK.apply_matrix(matrix, torch.from_numpy(data), impl).numpy()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
def test_apply_matrix_matches_jax_twin(impl, k, m):
    mat = reed_sol_van_matrix(k, m)
    data = _rand((3, k, 256), seed=k)
    want = np.asarray(JK.apply_matrix(mat, data, impl=impl))
    np.testing.assert_array_equal(_port(mat, data, impl), want)


@pytest.mark.parametrize("impl", IMPLS)
def test_zero_and_identity_rows(impl):
    mat = np.array([[0, 0, 0], [1, 0, 0], [2, 3, 0]], dtype=np.uint8)
    data = _rand((2, 3, 128), seed=1)
    np.testing.assert_array_equal(_port(mat, data, impl),
                                  R.encode_ref(mat, data))


@pytest.mark.parametrize("impl", ["bitlinear", "mxu", "logexp"])
def test_apply_matrix_decode_matrices_match_jax_twin(impl):
    mat = reed_sol_van_matrix(8, 3)
    data = _rand((2, 8, 128), seed=3)
    for lost in ((0,), (0, 9), (1, 5, 10)):
        D = R.decode_matrix(mat, list(lost), 8)
        want = np.asarray(JK.apply_matrix(D, data, impl=impl))
        np.testing.assert_array_equal(_port(D, data, impl), want)


@pytest.mark.parametrize("B,k,m,L", [
    (2, 16, 4, 132),    # L % 16 != 0, k > 8
    (1, 1, 12, 4),      # k = 1, m > 8, the shortest row
])
def test_gf_kernel_plain_matches_pallas_interpret(B, k, m, L):
    mat = _rand((m, k), seed=B + k + m)
    data = _rand((B, k, L), seed=L)
    from ceph_tpu.ops.pallas_gf import apply_matrix_pallas
    want = np.asarray(apply_matrix_pallas(mat, data))
    got = G.apply_matrix_gf(mat, torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, R.encode_ref(mat, data))


@pytest.mark.parametrize("B,k,m,L", [
    (0, 3, 2, 64), (3, 2, 0, 64), (1, 5, 9, 4), (4, 3, 8, 1028),
    (2, 255, 1, 8), (2, 1, 255, 8), (2, 4, 2, 1), (3, 8, 3, 4093),
    (2, 5, 12, 7), (1, 3, 2, 0)])
def test_gf_kernel_plain_edge_shapes(B, k, m, L):
    mat = _rand((m, k), seed=k * m + 7)
    data = _rand((B, k, L), seed=B + L)
    got = G.apply_matrix_plain(mat, torch.from_numpy(data))
    assert got.shape == (B, m, L) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), R.encode_ref(mat, data))


def test_gf_kernel_coefficients_are_the_pallas_constants():
    mat = _rand((3, 8), seed=5)
    want = bit_powers()[mat].astype(np.uint32) * np.uint32(0x01010101)
    np.testing.assert_array_equal(G.coef_words(mat), want)


def test_gf_kernel_rejects_what_the_pallas_wrapper_rejects():
    mat = reed_sol_van_matrix(4, 2)
    with pytest.raises(ValueError, match="data has 3 shards, matrix expects 4"):
        G.apply_matrix_gf(mat, torch.zeros((1, 3, 64), dtype=torch.uint8))
    # a length that is not a multiple of 4 is the one thing the Pallas
    # wrapper refuses that the port takes (the RMW delta windows need
    # any length); it gives the oracle's bytes
    ragged = _rand((1, 4, 66), seed=66)
    np.testing.assert_array_equal(
        G.apply_matrix_gf(mat, torch.from_numpy(ragged)).numpy(),
        R.encode_ref(mat, ragged))
    with pytest.raises(ValueError, match="uint8"):
        G.apply_matrix_gf(mat, torch.zeros((1, 4, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="uint8"):
        G.apply_matrix_gf(mat, torch.zeros((4, 64), dtype=torch.uint8))


def test_gf_kernel_takes_the_plain_version_only_on_cpu():
    # a tensor on any other device never reaches the plain version
    mat = reed_sol_van_matrix(4, 2)
    before = G.apply_matrix_gf.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        G.apply_matrix_gf(mat, torch.zeros((1, 4, 64), dtype=torch.uint8,
                                           device="meta"))
    G.apply_matrix_gf(mat, torch.zeros((1, 4, 64), dtype=torch.uint8))
    assert G.apply_matrix_gf.launches == before


def test_gf_kernel_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(G, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(G, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        G.build()
    assert not list(tmp_path.glob("*.so"))


def test_mxu_sums_stay_exact_at_wide_k():
    # 8k bit products per output bit: float32 holds them exactly
    mat = np.full((2, 250), 0xFF, dtype=np.uint8)
    data = np.full((1, 250, 16), 0xFF, dtype=np.uint8)
    np.testing.assert_array_equal(_port(mat, data, "mxu"),
                                  R.encode_ref(mat, data))


def test_apply_matrix_traced_matches_jax_twin():
    rng = np.random.default_rng(11)
    mats = rng.integers(0, 256, (4, 3, 5), dtype=np.uint8)
    mats[0, 1] = 0
    data = rng.integers(0, 256, (4, 5, 64), dtype=np.uint8)
    data[1, 2] = 0
    want = np.asarray(JK.apply_matrix_traced(mats, data))
    got = TK.apply_matrix_traced(torch.from_numpy(mats),
                                 torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pow2_bucket_matches_jax_twin():
    assert [TK.pow2_bucket(n) for n in range(70)] == \
        [JK.pow2_bucket(n) for n in range(70)]


def test_run_bucketed_pads_like_the_twin():
    seen = []

    def fn(x):
        seen.append(tuple(x.shape))
        return x * 2
    arr = _rand((5, 3), seed=2)
    got = TK.run_bucketed(fn, torch.from_numpy(arr))
    want = np.asarray(JK.run_bucketed(lambda x: x * 2, arr))
    assert seen == [(8, 3)]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bucket", [True, False])
def test_make_encoder_matches_jax_twin(bucket):
    mat = reed_sol_van_matrix(8, 3)
    data = _rand((5, 8, 128), seed=9)
    want = np.asarray(JK.make_encoder(mat, "bitlinear",
                                      bucket_batch=bucket)(data))
    got = TK.make_encoder(mat, bucket_batch=bucket)(torch.from_numpy(data))
    assert TK.DEFAULT_IMPL == "pallas"
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_encoder_rejects_unknown_impl():
    with pytest.raises(ValueError, match="unknown impl"):
        TK.make_encoder(reed_sol_van_matrix(4, 2), "cuda")
