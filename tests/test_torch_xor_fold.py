"""The XOR fold (ops/fold_kernel.py, csrc/xor_fold.cu) that
`ops/rs_kernels.py::xor_reduce` routes to.

On the CPU: the plain path against numpy's XOR reduce, the view and
place-width rules the wrapper hands the kernel, and that no CPU tensor
reaches the kernel. On a card (marked `card`, skipped without CUDA): the
kernel byte for byte against the plain path at the same shapes, a base
one byte off the grid, the recovery program's shapes at a reduced batch,
the inputs it refuses, and its launch count. The file imports no JAX, so
that on a machine with a card it runs without the suite's conftest:
`python -m pytest tests/test_torch_xor_fold.py --noconftest -p no:cacheprovider -q`.
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ops import fold_kernel as F
from ceph_tpu_torch.ops.rs_kernels import xor_reduce

HS = (0, 1, 2, 8, 11, 17)
INNERS = (1, 15, 16, 17, 4093, 8192)
DIMS = (0, 1, -2)


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda", 0)


def stack(H: int, inner: int, dim: int, seed: int = 0) -> np.ndarray:
    """Random bytes with H rows along `dim`: (H, 3, inner) for dim 0,
    (3, H, inner) for dim 1 and (2, 3, H, inner) for dim -2 (leading
    dimensions that merge into one)."""
    shape = {0: (H, 3, inner), 1: (3, H, inner), -2: (2, 3, H, inner)}[dim]
    rng = np.random.default_rng([seed, H, inner, dim % 4])
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("H", HS)
def test_plain_fold_matches_numpy(H, inner, dim):
    a = stack(H, inner, dim)
    before = F.xor_fold.launches
    got = xor_reduce(torch.from_numpy(a), dim)
    np.testing.assert_array_equal(got.numpy(),
                                  np.bitwise_xor.reduce(a, axis=dim))
    assert F.xor_fold.launches == before


def test_fold_view_merges_leading_and_keeps_strides():
    t = torch.zeros((2, 3, 5, 7), dtype=torch.uint8)
    v = F.fold_view(t, -2)
    assert v.shape == (6, 5, 7) and v.stride() == (35, 7, 1)
    assert v.data_ptr() == t.data_ptr()
    # H leading: one outer row of the dimensions after it
    v = F.fold_view(t, 0)
    assert v.shape == (1, 2, 105) and v.stride()[1:] == (105, 1)
    # a view one byte into wider rows: no copy, the wider rows' strides
    wide = torch.zeros((4, 3, 9), dtype=torch.uint8)
    v = F.fold_view(wide[:, :, 1:], 1)
    assert v.shape == (4, 3, 8) and v.stride() == (27, 9, 1)
    assert v.data_ptr() == wide.data_ptr() + 1
    # a strided H dimension is fine: its stride is the row stride
    v = F.fold_view(wide[:, ::2, :], 1)
    assert v.shape == (4, 2, 9) and v.stride() == (27, 18, 1)
    # no rows: nothing to walk, whatever strides the empty view has
    assert F.fold_view(torch.zeros((3, 0, 15), dtype=torch.uint8),
                       1).shape == (3, 0, 15)


@pytest.mark.parametrize("make", [
    lambda t: t[:, :, ::2],                      # strided inner
    lambda t: t.transpose(1, 2),                 # H after inner
    lambda t: t.reshape(2, 2, 3, 8).transpose(0, 1),  # outer won't merge
], ids=["strided_inner", "transposed", "unmergeable_outer"])
def test_fold_view_refuses_what_the_kernel_cannot_walk(make):
    t = make(torch.zeros((4, 3, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        F.fold_view(t, -2)


@pytest.mark.parametrize("ptr,bs,rs,inner,optr,want", [
    (4096, 8 * 524288, 524288, 524288, 8192, 16),   # the RS stack
    (4096, 11 * 131072, 131072, 131072, 8192, 16),  # Clay's shipped planes
    (4097, 16 * 32, 32, 32, 8192, 1),               # a base one byte off
    (4096, 3 * 4092, 4092, 4092, 8192, 1),          # rows of words
    (4096, 3 * 4093, 4093, 4093, 8192, 1),          # ragged windows
    (4096, 64, 32, 16, 8200, 1),                    # output off the grid
    (4096, 0, 0, 16, 8192, 16),                     # broadcast rows
])
def test_place_bytes_is_the_widest_the_input_shows(ptr, bs, rs, inner,
                                                   optr, want):
    assert F.place_bytes(ptr, bs, rs, inner, optr) == want


def test_cpu_tensors_never_reach_the_kernel():
    t = torch.ones((2, 3, 16), dtype=torch.uint8)
    before = F.xor_fold.launches
    with pytest.raises(ValueError, match="cuda"):
        F.xor_fold(t, 1)
    assert torch.equal(xor_reduce(t, 1), torch.ones((2, 16),
                                                    dtype=torch.uint8))
    assert F.xor_fold.launches == before


def test_fold_kernel_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(F, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(F, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        F.build()
    assert not list(tmp_path.glob("*.so"))


# ------------------------------------------------------------- on a card

def on_card(a: np.ndarray, dev: torch.device, dim: int) -> None:
    """The kernel on `a` against the plain path on the same device, one
    launch counted (none for an empty result or an empty `dim`)."""
    t = torch.from_numpy(a).to(dev)
    before = F.xor_fold.launches
    got = xor_reduce(t, dim)
    torch.cuda.synchronize()
    launched = 1 if a.shape[dim] and got.numel() else 0
    assert F.xor_fold.launches - before == launched
    assert torch.equal(got, F.xor_fold_plain(t, dim))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.bitwise_xor.reduce(a, axis=dim))


@pytest.mark.card
@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("H", HS)
def test_kernel_matches_plain(H, inner, dim, card):
    on_card(stack(H, inner, dim, seed=1), card, dim)


@pytest.mark.card
@pytest.mark.parametrize("H", (1, 2, 8, 11, 17))
@pytest.mark.parametrize("inner", (16, 4093, 8192))
def test_kernel_base_one_byte_off(H, inner, card):
    a = np.random.default_rng([2, H, inner]).integers(
        0, 256, (8, H, inner + 1), dtype=np.uint8)
    t = torch.from_numpy(a).to(card)[:, :, 1:]
    assert t.data_ptr() % 16 == 1
    before = F.xor_fold.launches
    got = xor_reduce(t, 1)
    torch.cuda.synchronize()
    assert F.xor_fold.launches - before == 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.bitwise_xor.reduce(a[:, :, 1:], axis=1))


@pytest.mark.card
@pytest.mark.parametrize("shape", [(8, 8, 524288), (8, 11, 131072)],
                         ids=["rs_k8m3", "clay_k8m4d11"])
def test_kernel_at_the_recovery_programs_shapes(shape, card):
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    t = torch.randint(0, 256, shape, dtype=torch.uint8, device=card,
                      generator=gen)
    before = F.xor_fold.launches
    got = xor_reduce(t, 1)
    torch.cuda.synchronize()
    assert F.xor_fold.launches - before == 1
    assert torch.equal(got, F.xor_fold_plain(t, 1))


@pytest.mark.card
def test_kernel_refuses_and_counts(card):
    t = torch.zeros((4, 3, 32), dtype=torch.uint8, device=card)
    before = F.xor_fold.launches
    with pytest.raises(ValueError, match="contiguous"):
        xor_reduce(t[:, :, ::2], 1)
    with pytest.raises(ValueError, match="uint8"):
        xor_reduce(t.to(torch.int32), 1)
    assert F.xor_fold.launches == before
    for i in range(3):
        xor_reduce(t, 1)
        torch.cuda.synchronize()
        assert F.xor_fold.launches == before + i + 1
