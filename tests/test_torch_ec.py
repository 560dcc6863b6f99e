"""The port's coders (ceph_tpu_torch.ec) held bit-exact against their
JAX twins (ceph_tpu.ec) on the same numpy-seeded objects, on the CPU.

Profile strings resolve unchanged in both registries. The JAX coders
decode with impl=mxu, its fastest CPU lowering (every impl gives the
same bytes); the port's coders run their default, the GF kernel's
plain version on a CPU tensor.
"""

from itertools import combinations

import numpy as np
import pytest
import torch

from ceph_tpu.ec import linearize as JL
from ceph_tpu.ec import registry as JR
from ceph_tpu.gf.numpy_ref import decode_matrix
from ceph_tpu.ops.rs_kernels import apply_matrix_traced
from ceph_tpu_torch.ec import linearize as TL
from ceph_tpu_torch.ec import registry as TR
from ceph_tpu_torch.ec.interface import ErasureCode, host_array

PROFILES_K4M2 = [
    "plugin=jerasure technique=reed_sol_van k=4 m=2",
    "plugin=jerasure technique=cauchy_good k=4 m=2",
    "plugin=jerasure technique=liberation k=4 m=2",
    "plugin=isa technique=reed_sol_van k=4 m=2",
    "plugin=isa technique=cauchy k=4 m=2",
]


def _pair(profile, jax_impl="mxu"):
    port = TR.factory(profile, device="cpu")
    jprof = profile if "liberation" in profile else \
        f"{profile} impl={jax_impl}"
    return port, JR.factory(jprof)


def _objects(coder, n=2, seed=0):
    size = coder.get_chunk_size(3000) * coder.k - 77   # exercise padding
    return np.random.default_rng(seed).integers(0, 256, (n, size), np.uint8)


def _np(d):
    return {i: host_array(v) for i, v in d.items()}


@pytest.mark.parametrize("profile", PROFILES_K4M2)
def test_encode_and_every_decode_pattern_match_jax_twin(profile):
    port, twin = _pair(profile)
    obj = _objects(port)
    n = port.get_chunk_count()
    got = _np(port.encode(range(n), obj))
    want = _np(twin.encode(range(n), obj))
    assert sorted(got) == sorted(want)
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])
    for ne in range(1, port.m + 1):
        for lost in combinations(range(n), ne):
            have = {i: v for i, v in want.items() if i not in lost}
            g = _np(port.decode(list(lost), have))
            w = _np(twin.decode(list(lost), have))
            for i in lost:
                np.testing.assert_array_equal(g[i], w[i])
                np.testing.assert_array_equal(g[i], want[i])


@pytest.mark.parametrize("profile", [
    "plugin=tpu_rs k=4 m=2",
    "plugin=jerasure technique=cauchy_orig k=4 m=2",
    "plugin=jerasure technique=reed_sol_van k=4 m=2 impl=bitlinear",
    "plugin=jerasure technique=reed_sol_van k=4 m=2 impl=logexp",
    "plugin=jerasure technique=reed_sol_van k=4 m=2 impl=mxu",
])
def test_other_profiles_encode_and_decode_match_jax_twin(profile):
    port = TR.factory(profile, device="cpu")
    twin = JR.factory(profile)
    obj = _objects(port, seed=1)
    got = _np(port.encode(range(6), obj))
    want = _np(twin.encode(range(6), obj))
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])
    have = {i: v for i, v in want.items() if i not in (1, 4)}
    np.testing.assert_array_equal(host_array(port.decode_concat(have)),
                                  np.asarray(twin.decode_concat(have)))


def test_k8m3_every_decode_pattern_matches_jax_twin():
    """All 231 patterns of <= 3 lost shards at L=256: the port's coder
    against the twin's decode matrices applied by the twin's traced
    GF apply (one JAX program per erasure count)."""
    port, twin = _pair("plugin=jerasure technique=reed_sol_van k=8 m=3")
    data = np.random.default_rng(3).integers(0, 256, (1, 8, 256), np.uint8)
    parity = host_array(port.encode_chunks(data))
    np.testing.assert_array_equal(parity, np.asarray(twin.encode_chunks(data)))
    full = np.concatenate([data, parity], axis=1)[0]      # (11, 256)
    for ne in (1, 2, 3):
        pats = list(combinations(range(11), ne))
        mats, stacks = [], []
        for lost in pats:
            surv = [s for s in range(11) if s not in lost][:8]
            mats.append(decode_matrix(twin.matrix, list(lost), 8, surv))
            stacks.append(full[surv])
        want = np.asarray(apply_matrix_traced(np.stack(mats),
                                              np.stack(stacks)))
        for p, lost in enumerate(pats):
            have = {i: full[i] for i in range(11) if i not in lost}
            got = _np(port.decode(list(lost), have))
            for e, i in enumerate(lost):
                np.testing.assert_array_equal(got[i], want[p, e])
                np.testing.assert_array_equal(got[i], full[i])


def test_batch_decoder_matches_jax_twin():
    port, twin = _pair("plugin=jerasure technique=reed_sol_van k=8 m=3")
    stack = np.random.default_rng(4).integers(0, 256, (3, 8, 128), np.uint8)
    surv = [1, 2, 3, 4, 5, 6, 7, 8]
    got = port.batch_decoder((0, 9), surv)(torch.from_numpy(stack))
    want = np.asarray(twin.batch_decoder((0, 9), surv)(stack))
    np.testing.assert_array_equal(got.numpy(), want)
    # the base class derives the same decode through linearize
    base = ErasureCode.batch_decoder(port, (0, 9), surv)
    np.testing.assert_array_equal(base(torch.from_numpy(stack)).numpy(), want)


def test_linearize_matches_jax_twin():
    port, twin = _pair("plugin=jerasure technique=cauchy_good k=4 m=2")
    np.testing.assert_array_equal(
        TL.derive_repair_matrix(port, [0, 5], [1, 2, 3, 4], seed=0),
        JL.derive_repair_matrix(twin, [0, 5], [1, 2, 3, 4], seed=0))
    np.testing.assert_array_equal(TL.derive_delta_matrix(port, [1, 3]),
                                  JL.derive_delta_matrix(twin, [1, 3]))


@pytest.mark.parametrize("profile", [
    "plugin=jerasure technique=reed_sol_van k=4 m=2",
    "plugin=jerasure technique=liberation k=4 m=2",
])
def test_parity_delta_matches_jax_twin(profile):
    port, twin = _pair(profile)
    dl = np.random.default_rng(5).integers(0, 256, (2, 2, 7 * 128), np.uint8)
    np.testing.assert_array_equal(host_array(port.parity_delta((1, 3), dl)),
                                  np.asarray(twin.parity_delta((1, 3), dl)))
    a, b = port.delta_matrix((1, 3)), twin.delta_matrix((1, 3))
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)


def test_geometry_and_minimum_to_decode_match_jax_twin():
    port, twin = _pair("plugin=jerasure technique=reed_sol_van k=8 m=3")
    for size in (1, 4096, 4 << 20, (4 << 20) + 5):
        assert port.get_chunk_size(size) == twin.get_chunk_size(size)
    for want, avail in (([0], range(11)), ([0, 9], [1, 2, 3, 4, 5, 6, 7, 8,
                                                     10])):
        assert port.minimum_to_decode(want, avail) == \
            twin.minimum_to_decode(want, avail)
    with pytest.raises(ValueError):
        port.minimum_to_decode([0], [1, 2])


def test_outputs_are_tensors_on_the_coder_device():
    port = TR.factory("k=4 m=2", device="cpu")
    enc = port.encode(range(6), bytes(range(200)))
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               and v.dtype == torch.uint8 and v.ndim == 1
               for v in enc.values())
    out = port.decode_concat({i: enc[i] for i in (1, 3, 4, 5)}, 200)
    assert bytes(out.numpy()) == bytes(range(200))


def test_registry_errors_match_jax_twin():
    # the bundled plugins of both registries (other tests may register
    # more into the twin's, which is process-wide)
    bundled = {"tpu_rs", "jerasure", "isa", "lrc", "tpu_lrc", "clay", "shec"}
    assert set(TR.plugins()) == bundled <= set(JR.plugins())
    for bad in ("plugin=nope k=4 m=2", "k=4 m=2 impl=nope",
                "plugin=isa technique=cauchy_good k=4 m=2", "k=0 m=2"):
        with pytest.raises(ValueError):
            JR.factory(bad)
        with pytest.raises(ValueError):
            TR.factory(bad, device="cpu")
