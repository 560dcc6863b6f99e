"""The port's Clay coder (ceph_tpu_torch.ec.clay) held bit-exact against its
JAX twin (ceph_tpu.ec.clay) on the same numpy-seeded objects, on the CPU.

The twin runs impl="ref", the numpy oracle its own tests run
(tests/test_clay.py), and its default impl="mxu" on the small geometry;
the port runs its default, the GF kernel's plain version on a CPU tensor.
Geometries: k=4 m=2 d=5 and k=8 m=4 d=11 (BASELINE config #4) at the
shortest chunk its alignment allows (64 sub-chunks of 128 bytes). Every
comparison is exact.
"""

from itertools import combinations

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as JR
from ceph_tpu_torch.ec import registry as TR
from ceph_tpu_torch.ec.clay import Clay
from ceph_tpu_torch.ec.interface import host_array

GEOMS = [(4, 2, 5), (8, 4, 11)]
GEOM_IDS = ["k4m2d5", "k8m4d11"]


def _profile(k, m, d, extra=""):
    return f"plugin=clay k={k} m={m} d={d} {extra}".strip()


def _pair(k, m, d, twin_impl="ref"):
    return (TR.factory(_profile(k, m, d), device="cpu"),
            JR.factory(_profile(k, m, d, f"impl={twin_impl}")))


def _np(d):
    return {i: host_array(v) for i, v in d.items()}


def _full(port, B=2, seed=0):
    """Every chunk of B seeded objects, from the port's encode_chunks."""
    L = port.get_chunk_size(port.k)      # the shortest aligned chunk
    data = np.random.default_rng(seed).integers(0, 256, (B, port.k, L),
                                                np.uint8)
    parity = host_array(port.encode_chunks(data))
    full = {i: data[:, i] for i in range(port.k)}
    full.update({port.k + j: parity[:, j] for j in range(port.m)})
    return data, full


@pytest.fixture(scope="module", params=GEOMS, ids=GEOM_IDS)
def pair(request):
    return _pair(*request.param)


def test_geometry_matches_twin(pair):
    port, twin = pair
    assert isinstance(port, Clay) and port.impl == "pallas"
    for attr in ("k", "m", "d", "q", "t", "nu", "sub_chunk_count", "gamma"):
        assert getattr(port, attr) == getattr(twin, attr), attr
    np.testing.assert_array_equal(port.base_matrix, twin.base_matrix)
    for size in (1, 4096, 4 << 20):
        assert port.get_chunk_size(size) == twin.get_chunk_size(size)


def test_encode_matches_twin(pair):
    port, twin = pair
    data, full = _full(port, seed=1)
    np.testing.assert_array_equal(
        np.stack([full[port.k + j] for j in range(port.m)], axis=1),
        np.asarray(twin.encode_chunks(data)))
    obj = np.random.default_rng(2).integers(0, 256, 3 * port.k * 128 + 5,
                                            np.uint8)
    n = port.get_chunk_count()
    pe, je = _np(port.encode(range(n), obj)), twin.encode(range(n), obj)
    for i in range(n):
        np.testing.assert_array_equal(pe[i], np.asarray(je[i]))
    keep = {i: pe[i] for i in range(port.m, n)}
    np.testing.assert_array_equal(
        host_array(port.decode_concat(keep, obj.size)), obj)


def test_encode_matches_twin_default_mxu():
    port, twin = _pair(4, 2, 5, twin_impl="mxu")
    data, full = _full(port, seed=3)
    np.testing.assert_array_equal(
        np.stack([full[4], full[5]], axis=1),
        np.asarray(twin.encode_chunks(data)))


def _erasures(n, m, sample):
    pats = [p for r in range(1, m + 1) for p in combinations(range(n), r)]
    if len(pats) <= sample:
        return pats
    rng = np.random.default_rng(n)
    return [pats[i] for i in sorted(rng.choice(len(pats), sample, False))]


def test_decode_chunks_match_twin(pair):
    port, twin = pair
    _, full = _full(port, seed=4)
    n = port.get_chunk_count()
    for erased in _erasures(n, port.m, sample=6) + [(0, 9)][:n > 9]:
        have = {c: full[c] for c in range(n) if c not in erased}
        got = _np(port.decode_chunks(list(erased), have))
        want = twin.decode_chunks(list(erased), have)
        assert got.keys() == set(erased)
        for e in erased:
            np.testing.assert_array_equal(got[e], np.asarray(want[e]),
                                          err_msg=str(erased))
            np.testing.assert_array_equal(got[e], full[e],
                                          err_msg=str(erased))


def test_decode_passthrough_and_partial_survivors_match_twin():
    port, twin = _pair(4, 2, 5)
    _, full = _full(port, seed=5)
    for want, have in (([0, 1], (0, 1)), ([0, 1], (1, 2, 3, 4)),
                       ([0], (1, 2, 3, 4))):
        chunks = {c: full[c] for c in have}
        got = _np(port.decode_chunks(want, chunks))
        ref = twin.decode_chunks(want, chunks)
        assert got.keys() == ref.keys()
        for c in got:
            np.testing.assert_array_equal(got[c], np.asarray(ref[c]))
    for coder in (port, twin):
        with pytest.raises(ValueError):
            coder.decode_chunks([0], {c: full[c] for c in (1, 2, 3)})


def test_minimum_to_decode_and_subchunks_match_twin(pair):
    port, twin = pair
    n = port.get_chunk_count()
    rng = np.random.default_rng(6)
    costs = {i: int(c) for i, c in enumerate(rng.integers(1, 9, n))}
    for want in ([0], [n - 1], [0, 1], [1, n - 1], [2]):
        for avail in ([c for c in range(n) if c not in want],
                      [c for c in range(n) if c not in want][1:]):
            for fn in ("minimum_to_decode", "minimum_to_decode_with_cost"):
                arg = avail if fn == "minimum_to_decode" else \
                    {c: costs[c] for c in avail}
                try:
                    ref = getattr(twin, fn)(want, arg)
                except ValueError:
                    with pytest.raises(ValueError):
                        getattr(port, fn)(want, arg)
                    continue
                assert getattr(port, fn)(want, arg) == ref, (fn, want)
    for failed in range(n):
        avail = [c for c in range(n) if c != failed]
        assert port.minimum_to_decode_subchunks(failed, avail) == \
            twin.minimum_to_decode_subchunks(failed, avail)
        assert port._pick_helpers(failed, avail, costs) == \
            twin._pick_helpers(failed, avail, costs)


def test_repair_matches_twin(pair):
    port, twin = pair
    _, full = _full(port, seed=7)
    n = port.get_chunk_count()
    for failed in range(n):
        rest = {c: full[c] for c in range(n) if c != failed}
        got = host_array(port.repair_from_chunks(failed, rest))
        np.testing.assert_array_equal(
            got, np.asarray(twin.repair_from_chunks(failed, rest)))
        np.testing.assert_array_equal(got, full[failed], err_msg=str(failed))
    # repair_chunk from the shipped planes only
    need = port.minimum_to_decode_subchunks(0, list(range(1, n)))
    P = port.sub_chunk_count
    picked = {h: full[h].reshape(2, P, -1)[:, planes]
              for h, planes in need.items()}
    np.testing.assert_array_equal(host_array(port.repair_chunk(0, picked)),
                                  np.asarray(twin.repair_chunk(0, picked)))
    D, planes = port.repair_plan_matrix(0, sorted(need))
    JD, jplanes = twin.repair_plan_matrix(0, sorted(need))
    np.testing.assert_array_equal(D, JD)
    assert planes == jplanes


def test_batch_and_range_decoders_match_twin():
    # twin default impl (mxu) on both sides' fused single-loss repair
    port, twin = _pair(8, 4, 11, twin_impl="mxu")
    _, full = _full(port, B=3, seed=8)
    n = port.get_chunk_count()
    lost = 5
    helpers = sorted(port.minimum_to_decode([lost], [c for c in range(n)
                                                     if c != lost]))
    stack = np.stack([full[h] for h in helpers], axis=1)   # (B, d, L)
    got = host_array(port.batch_decoder([lost], helpers)(
        torch.from_numpy(stack)))
    np.testing.assert_array_equal(
        got, np.asarray(twin.batch_decoder([lost], helpers)(stack)))
    np.testing.assert_array_equal(got[:, 0], full[lost])
    P, s = port.sub_chunk_count, stack.shape[2] // port.sub_chunk_count
    planes = port.repair_plan_matrix(lost, helpers)[1]
    ranged = stack.reshape(3, len(helpers), P, s)[:, :, planes].reshape(
        3, len(helpers), -1)
    got = host_array(port.range_batch_decoder([lost], helpers)(
        torch.from_numpy(ranged)))
    np.testing.assert_array_equal(
        got, np.asarray(twin.range_batch_decoder([lost], helpers)(ranged)))
    np.testing.assert_array_equal(got[:, 0], full[lost])
    pk = port.range_decode_program_key([lost], helpers)
    jk = twin.range_decode_program_key([lost], helpers)
    assert pk[:4] == jk[:4] and pk[4] == "pallas"
    assert port.batch_decoder([0, 1], helpers) is None
    assert port.range_batch_decoder([lost], helpers[1:]) is None


@pytest.mark.parametrize("k,m,d,ratio", [(4, 2, 5, (5, 8)),
                                          (8, 4, 11, (11, 32))],
                         ids=GEOM_IDS)
def test_repair_reads_d_over_k_times_q(k, m, d, ratio):
    # helper bytes of a single-loss repair over k full chunks: d/(k*q),
    # 11/32 for k=8 m=4 d=11
    port = TR.factory(_profile(k, m, d), device="cpu")
    need = port.minimum_to_decode_subchunks(0, list(range(1, k + m)))
    read = sum(len(p) for p in need.values())
    assert len(need) == d
    assert read * ratio[1] == k * port.sub_chunk_count * ratio[0]


def test_config4_matrix_shapes():
    # the GF matrices the kernel takes at BASELINE config #4
    port = TR.factory(_profile(8, 4, 11), device="cpu")
    enc, _ = port._affine_decode(tuple(range(8, 12)), tuple(range(8)))
    rep, _ = port.repair_plan_matrix(0, list(range(1, 12)))
    dec, _ = port._affine_decode((0, 9), tuple(c for c in range(12)
                                              if c not in (0, 9)))
    shapes = [D.shape for D in (enc, rep, dec)]
    assert shapes == [(256, 512), (64, 176), (128, 640)]
    dens = [round(100 * np.count_nonzero(D) / D.size, 1)
            for D in (enc, rep, dec)]
    assert dens == [4.8, 8.4, 9.2]


@pytest.mark.parametrize("impl", ["mxu", "bitlinear", "ref"])
def test_impl_profiles_give_the_same_bytes(impl):
    port = TR.factory(_profile(4, 2, 5), device="cpu")
    other = TR.factory(_profile(4, 2, 5, f"impl={impl}"), device="cpu")
    data, full = _full(port, seed=9)
    out = other.encode_chunks(data)
    assert isinstance(out, torch.Tensor) and out.device == other.device
    np.testing.assert_array_equal(host_array(out),
                                  np.stack([full[4], full[5]], axis=1))
    rest = {c: full[c] for c in range(1, 6)}
    np.testing.assert_array_equal(
        host_array(other.repair_from_chunks(0, rest)), full[0])
    if impl == "ref":
        assert other.batch_decoder([0], [1, 2, 3, 4, 5]) is None


def test_ref_impl_is_refused_on_the_card():
    # ref is the host numpy oracle: a card coder would move its work to
    # the CPU, so it is refused there (no CUDA is touched to say so)
    with pytest.raises(ValueError, match="CPU coder only"):
        TR.factory(_profile(4, 2, 5, "impl=ref"), device="cuda:0")


def test_bad_profiles_match_twin():
    for bad in ("k=4 m=1", "k=4 m=2 d=4", "k=4 m=2 d=6", "k=4 m=2 gamma=1",
                "k=4 m=2 impl=nope"):
        with pytest.raises(ValueError):
            TR.factory(f"plugin=clay {bad}", device="cpu")
        if "impl" not in bad:
            with pytest.raises(ValueError):
                JR.factory(f"plugin=clay {bad}")


def test_fn_cache_holds_its_matrix():
    # the per-matrix function cache is keyed by id(D) and keeps D alive,
    # so an id can never name another matrix
    port = TR.factory(_profile(4, 2, 5), device="cpu")
    _full(port)
    (D, fn), = port._fn_cache.values()
    assert port._fn_cache[id(D)][0] is D
