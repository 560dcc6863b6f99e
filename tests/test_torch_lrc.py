"""The port's LRC coder (ceph_tpu_torch.ec.lrc) held bit-exact against its
JAX twin (ceph_tpu.ec.lrc) on the same numpy-seeded objects, on the CPU.

The twin runs its default layer impl (as tests/test_lrc.py runs it); the
port runs its default, the GF kernel's plain version on a CPU tensor.
Geometries: k=4 m=2 l=3 (the reference doc's expansion) and k=8 m=4
l=4 (BASELINE config #3). Every comparison is exact.
"""

import json
from itertools import combinations

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as JR
from ceph_tpu.ec.lrc import _expand_kml as j_expand
from ceph_tpu_torch.ec import registry as TR
from ceph_tpu_torch.ec.interface import host_array
from ceph_tpu_torch.ec.lrc import Lrc, _expand_kml as t_expand

GEOMS = [(4, 2, 3), (8, 4, 4)]
GEOM_IDS = ["k4m2l3", "k8m4l4"]


def _profile(k, m, l, extra=""):
    return f"plugin=lrc k={k} m={m} l={l} {extra}".strip()


def _pair(k, m, l):
    return (TR.factory(_profile(k, m, l), device="cpu"),
            JR.factory(_profile(k, m, l)))


def _np(d):
    return {i: host_array(v) for i, v in d.items()}


def _encoded(port, twin, seed=0, B=2):
    size = port.get_chunk_size(700) * port.k - 33   # exercise padding
    objs = np.random.default_rng(seed).integers(0, 256, (B, size), np.uint8)
    n = port.get_chunk_count()
    pe = _np(port.encode(range(n), objs))
    je = {i: np.asarray(v) for i, v in twin.encode(range(n), objs).items()}
    return objs, pe, je


@pytest.fixture(params=GEOMS, ids=GEOM_IDS)
def geom(request):
    return request.param


def test_kml_expansion_and_geometry_match_twin(geom):
    k, m, l = geom
    assert t_expand(k, m, l) == j_expand(k, m, l)
    port, twin = _pair(k, m, l)
    assert isinstance(port, Lrc)
    assert port.mapping == twin.mapping
    assert port.data_positions == twin.data_positions
    assert port.get_chunk_mapping() == twin.get_chunk_mapping()
    assert (port.k, port.m, port.get_chunk_count()) == \
        (twin.k, twin.m, twin.get_chunk_count())
    for size in (1, 4096, 4 << 20):
        assert port.get_chunk_size(size) == twin.get_chunk_size(size)
    assert [(la.d_pos, la.c_pos) for la in port.layers] == \
        [(la.d_pos, la.c_pos) for la in twin.layers]
    if geom == (8, 4, 4):
        # data at positions 3, 4, 7, 8, 9, 12, 13, 14 of 15
        assert port.data_positions == (3, 4, 7, 8, 9, 12, 13, 14)


def test_kml_validation_matches_twin():
    for bad in ((4, 3, 3), (4, 2, 1)):
        with pytest.raises(ValueError):
            j_expand(*bad)
        with pytest.raises(ValueError):
            t_expand(*bad)


def test_encode_matches_twin(geom):
    port, twin = _pair(*geom)
    objs, pe, je = _encoded(port, twin, seed=1)
    assert pe.keys() == je.keys()
    for i in pe:
        np.testing.assert_array_equal(pe[i], je[i], err_msg=str(i))
    data = np.stack([pe[p] for p in port.data_positions], axis=1)
    np.testing.assert_array_equal(host_array(port.encode_chunks(data)),
                                  np.asarray(twin.encode_chunks(data)))
    out = port.decode_concat({i: pe[i] for i in pe}, objs.shape[1])
    np.testing.assert_array_equal(host_array(out), objs)


def _patterns(n, k, m, l):
    singles = [(i,) for i in range(n)]
    doubles = list(combinations(range(n), 2))
    if n > 8:   # k=8: every pair inside a local group and a spread sample
        rng = np.random.default_rng(n)
        doubles = [d for d in doubles if d[0] // (l + 1) == d[1] // (l + 1)] \
            + [doubles[i] for i in rng.choice(len(doubles), 8, False)]
    return singles + doubles


def test_decode_and_minimum_to_decode_match_twin(geom):
    port, twin = _pair(*geom)
    _, pe, _ = _encoded(port, twin, seed=2)
    n = port.get_chunk_count()
    rng = np.random.default_rng(3)
    costs = {i: int(c) for i, c in enumerate(rng.integers(1, 9, n))}
    for lost in _patterns(n, *geom):
        avail = [i for i in range(n) if i not in lost]
        try:
            want = twin.minimum_to_decode(list(lost), avail)
        except ValueError:
            with pytest.raises(ValueError):
                port.minimum_to_decode(list(lost), avail)
            continue
        assert port.minimum_to_decode(list(lost), avail) == want, lost
        cost_av = {i: costs[i] for i in avail}
        assert port.minimum_to_decode_with_cost(list(lost), cost_av) == \
            twin.minimum_to_decode_with_cost(list(lost), cost_av), lost
        have = {i: pe[i] for i in want}
        got = _np(port.decode_chunks(list(lost), have))
        ref = {i: np.asarray(v)
               for i, v in twin.decode_chunks(list(lost), have).items()}
        assert got.keys() == ref.keys() == set(lost)
        for p in lost:
            np.testing.assert_array_equal(got[p], ref[p], err_msg=str(lost))
            np.testing.assert_array_equal(got[p], pe[p], err_msg=str(lost))


@pytest.mark.parametrize("k,m,l,local", [(4, 2, 3, 3), (8, 4, 4, 4)],
                         ids=GEOM_IDS)
def test_single_loss_reads_the_local_group(k, m, l, local):
    # the helper ratio: one lost data chunk reads l chunks, not k
    # (2.0x fewer for k=8 l=4)
    port, twin = _pair(k, m, l)
    n = port.get_chunk_count()
    for lost in port.data_positions:
        avail = [i for i in range(n) if i != lost]
        need = port.minimum_to_decode([lost], avail)
        assert need == twin.minimum_to_decode([lost], avail)
        assert len(need) == local and k / len(need) == k / l


def test_batch_decoder_matches_twin(geom):
    # a local repair linearizes into one (1, l) matrix on the kernel
    port, twin = _pair(*geom)
    _, pe, _ = _encoded(port, twin, seed=4, B=3)
    n = port.get_chunk_count()
    lost = port.data_positions[0]
    helpers = sorted(port.minimum_to_decode([lost], [i for i in range(n)
                                                     if i != lost]))
    stack = np.stack([pe[h] for h in helpers], axis=1)
    fn, jfn = port.batch_decoder([lost], helpers), \
        twin.batch_decoder([lost], helpers)
    got = host_array(fn(torch.from_numpy(stack)))
    np.testing.assert_array_equal(got, np.asarray(jfn(stack)))
    np.testing.assert_array_equal(got[:, 0], pe[lost])
    key = port.decode_program_key([lost], helpers)
    assert key[0] == "lin" and key[2] == (1, geom[2]) \
        and key[3] == "pallas"
    assert key[1] == twin.decode_program_key([lost], helpers)[1]


def test_layers_live_on_the_coder_device():
    port = TR.factory(_profile(8, 4, 4), device="cpu")
    assert port.impl == "pallas"
    assert all(la.coder.device == port.device for la in port.layers)
    enc = port.encode(range(15), bytes(range(256)) * 9)
    assert all(isinstance(v, torch.Tensor) and v.device == port.device
               for v in enc.values())


@pytest.mark.parametrize("impl", ["mxu", "bitlinear", "logexp"])
def test_impl_profiles_give_the_same_bytes(impl):
    port = TR.factory(_profile(4, 2, 3), device="cpu")
    other = TR.factory(_profile(4, 2, 3, f"impl={impl}"), device="cpu")
    assert all(la.coder.impl == impl for la in other.layers)
    x = np.random.default_rng(5).integers(0, 256, (2, 4, 256), np.uint8)
    np.testing.assert_array_equal(host_array(other.encode_chunks(x)),
                                  host_array(port.encode_chunks(x)))


def test_mapping_layers_profile_form_matches_twin():
    mapping, layers = j_expand(4, 2, 3)
    prof = {"plugin": "lrc", "mapping": mapping,
            "layers": json.dumps(layers)}
    port, twin = TR.factory(prof, device="cpu"), JR.factory(prof)
    x = np.random.default_rng(6).integers(0, 256, (2, 4, 128), np.uint8)
    np.testing.assert_array_equal(host_array(port.encode_chunks(x)),
                                  np.asarray(twin.encode_chunks(x)))
    for bad, why in (({"mapping": "DD__"}, "no layers"),
                     ({"mapping": "DD_", "layers": [["cDDD", ""]]},
                      "length"),
                     ({"mapping": "DD__", "layers": [["DDc_", ""]]},
                      "neither data nor written"),
                     ({"mapping": "_DDD",
                       "layers": [["DDDc", ""], ["cDD_", ""]]},
                      "layer order")):
        bad = {"plugin": "lrc", **bad}
        with pytest.raises(ValueError, match=why):
            JR.factory(bad)
        with pytest.raises(ValueError, match=why):
            TR.factory(bad, device="cpu")
