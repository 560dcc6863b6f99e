"""The port's SHEC coder (ceph_tpu_torch.ec.shec) held bit-exact against
its JAX twin (ceph_tpu.ec.shec) on the same numpy-seeded objects, on the
CPU.

The twin runs impl="ref" (the numpy oracle, as tests/test_shec.py runs
it) and its default impl="bitlinear"; the port runs its default, the GF
kernel's plain version on a CPU tensor. Geometry: k=4 m=3 c=2 (the
chip run's), plus the twin's other durability cases for the planner.
Every comparison is exact.
"""

from itertools import combinations

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as JR
from ceph_tpu.ec.shec import gf_express as j_express
from ceph_tpu_torch.ec import registry as TR
from ceph_tpu_torch.ec.interface import host_array
from ceph_tpu_torch.ec.shec import Shec, gf_express as t_express


def _profile(k, m, c, extra=""):
    return f"plugin=shec k={k} m={m} c={c} {extra}".strip()


def _pair(k=4, m=3, c=2, twin_impl="ref"):
    return (TR.factory(_profile(k, m, c), device="cpu"),
            JR.factory(_profile(k, m, c, f"impl={twin_impl}")))


def _full(port, B=2, L=256, seed=0):
    data = np.random.default_rng(seed).integers(0, 256, (B, port.k, L),
                                                np.uint8)
    parity = host_array(port.encode_chunks(data))
    return data, {i: (data[:, i] if i < port.k else parity[:, i - port.k])
                  for i in range(port.k + port.m)}


@pytest.mark.parametrize("twin_impl", ["ref", "bitlinear"])
def test_geometry_and_encode_match_twin(twin_impl):
    port, twin = _pair(twin_impl=twin_impl)
    assert isinstance(port, Shec) and port.impl == "pallas"
    assert (port.l, port.windows) == (twin.l, twin.windows)
    np.testing.assert_array_equal(port.matrix, twin.matrix)
    np.testing.assert_array_equal(port.G, twin.G)
    data, full = _full(port, seed=1)
    np.testing.assert_array_equal(
        np.stack([full[4 + j] for j in range(3)], axis=1),
        np.asarray(twin.encode_chunks(data)))
    obj = np.random.default_rng(2).integers(0, 256, 3000, np.uint8)
    pe, je = port.encode(range(7), obj), twin.encode(range(7), obj)
    for i in range(7):
        np.testing.assert_array_equal(host_array(pe[i]), np.asarray(je[i]))
    rec = port.decode_concat({c: pe[c] for c in (0, 1, 3, 4, 5, 6)}, 3000)
    np.testing.assert_array_equal(host_array(rec), obj)


@pytest.mark.parametrize("k,m,c", [(4, 3, 2), (6, 3, 2), (8, 4, 3)])
def test_every_c_erasure_pattern_matches_twin(k, m, c):
    port, twin = _pair(k, m, c)
    _, full = _full(port, seed=k)
    n = k + m
    rng = np.random.default_rng(n)
    costs = {i: int(x) for i, x in enumerate(rng.integers(1, 9, n))}
    for r in range(1, c + 1):
        for erased in combinations(range(n), r):
            avail = [i for i in range(n) if i not in erased]
            need = port.minimum_to_decode(list(erased), avail)
            assert need == twin.minimum_to_decode(list(erased), avail)
            cav = {i: costs[i] for i in avail}
            assert port.minimum_to_decode_with_cost(list(erased), cav) == \
                twin.minimum_to_decode_with_cost(list(erased), cav)
            have = {s: full[s] for s in need}
            got = port.decode_chunks(list(erased), have)
            want = twin.decode_chunks(list(erased), have)
            for e in erased:
                np.testing.assert_array_equal(host_array(got[e]),
                                              np.asarray(want[e]))
                np.testing.assert_array_equal(host_array(got[e]), full[e])


def test_beyond_c_failures_match_twin():
    # non-MDS: the same triples decode or raise in both packages
    port, twin = _pair()
    _, full = _full(port, seed=3)
    outcomes = []
    for erased in combinations(range(7), 3):
        avail = [i for i in range(7) if i not in erased]
        try:
            need = twin.minimum_to_decode(list(erased), avail)
        except ValueError:
            with pytest.raises(ValueError):
                port.minimum_to_decode(list(erased), avail)
            outcomes.append(False)
            continue
        assert port.minimum_to_decode(list(erased), avail) == need
        got = port.decode_chunks(list(erased), {s: full[s] for s in need})
        for e in erased:
            np.testing.assert_array_equal(host_array(got[e]), full[e])
        outcomes.append(True)
    assert len(outcomes) == 35 and any(outcomes) and not all(outcomes)


def test_recovery_read_count_and_gf_express_match_twin():
    port, twin = _pair(8, 4, 3)
    assert [port.recovery_read_count(j) for j in range(12)] == \
        [twin.recovery_read_count(j) for j in range(12)]
    assert max(port.recovery_read_count(j) for j in range(8)) < 8
    rng = np.random.default_rng(4)
    for s in (2, 5, 7):
        A = rng.integers(0, 256, (s, 6), np.uint8)
        for B in (A[[1, 0]] ^ A[[0, 0]], rng.integers(0, 256, (2, 6),
                                                      np.uint8)):
            want = j_express(A, B)
            got = t_express(A, B)
            assert (got is None) == (want is None), s
            if want is not None:
                np.testing.assert_array_equal(got, want)
    A = np.array([[1, 0, 0], [0, 1, 0]], np.uint8)
    assert t_express(A, np.array([[0, 0, 1]], np.uint8)) is None
    assert t_express(A, np.array([[1, 1, 0]], np.uint8)).tolist() == [[1, 1]]


def test_batch_decoder_matches_twin():
    # the inherited static-matrix fast path, default impls on both sides
    port, twin = _pair(twin_impl="bitlinear")
    data, full = _full(port, B=3, L=512, seed=5)
    stack = np.stack([full[i] for i in range(7)], axis=1)
    for lost in ([2], [0, 4]):
        avail = [i for i in range(7) if i not in lost]
        helpers = sorted(port.minimum_to_decode(lost, avail))
        fn = port.batch_decoder(lost, helpers)
        got = host_array(fn(torch.from_numpy(stack[:, helpers])))
        np.testing.assert_array_equal(
            got, np.asarray(twin.batch_decoder(lost, helpers)(
                stack[:, helpers])))
        np.testing.assert_array_equal(got, stack[:, lost])


@pytest.mark.parametrize("impl", ["ref", "mxu", "bitlinear", "logexp"])
def test_impl_profiles_give_the_same_bytes(impl):
    port = TR.factory(_profile(4, 3, 2), device="cpu")
    other = TR.factory(_profile(4, 3, 2, f"impl={impl}"), device="cpu")
    data, full = _full(port, seed=6)
    out = other.encode_chunks(data)
    assert isinstance(out, torch.Tensor) and out.device == other.device
    np.testing.assert_array_equal(
        host_array(out), np.stack([full[4 + j] for j in range(3)], axis=1))
    rec = other.decode_chunks([1], {s: full[s] for s in (0, 2, 4, 5, 6)})
    np.testing.assert_array_equal(host_array(rec[1]), full[1])


def test_ref_impl_is_refused_on_the_card():
    # ref is the host numpy oracle: a card coder would move its work to
    # the CPU, so it is refused there (no CUDA is touched to say so)
    with pytest.raises(ValueError, match="CPU coder only"):
        TR.factory(_profile(4, 3, 2, "impl=ref"), device="cuda:0")


def test_bad_profiles_match_twin():
    for bad in ("k=4 m=3 c=4", "k=2 m=3 c=2"):
        with pytest.raises(ValueError):
            JR.factory(f"plugin=shec {bad}")
        with pytest.raises(ValueError):
            TR.factory(f"plugin=shec {bad}", device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        TR.factory("plugin=shec k=4 m=3 c=2 impl=nope", device="cpu")
