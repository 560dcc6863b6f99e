"""The port's (dp, shard) mesh against the JAX package's sharded steps.

Four gloo ranks on the CPU (tests/torch_mesh_helpers.py, one spawn for
the module) run every case of tests/test_parallel.py and
__graft_entry__.dryrun_multichip at meshes (2, 2) and (1, 4), and at a
(2, 2) mesh of the ranks in reverse order; the JAX package runs the same
numpy-seeded inputs on the same meshes of 4 of the 8 virtual CPU
devices. Each rank's block must equal, bit for bit, the
slice of the twin's global output at the index the twin's output
sharding gives the device at the rank's mesh position. The byte
counters must show that encode moves nothing, a gather receives only
the wanted slots (plus the padding of uneven counts), and Clay's helpers
ship beta/nsub of their rows. Tolerance: none."""

import jax
import numpy as np
import pytest

from ceph_tpu.ec.linearize import derive_repair_matrix as j_derive
from ceph_tpu.ec.matrices import reed_sol_van_matrix
from ceph_tpu.ec.registry import factory as j_factory
from ceph_tpu.parallel import mesh as JM
from ceph_tpu_torch.parallel import mesh as TM
from torch_mesh_helpers import (CASES, DECODES, MESHES, codec_objects,
                                finish, lrc_helpers, parallel_rank, rs_data,
                                start_ranks, survivors)

WORLD = 4


def _jax_mesh(label):
    ranks, shard = MESHES[label]
    return JM.default_mesh(np.asarray(jax.devices())[list(ranks)], shard)


def _twin_outputs() -> dict:
    """{(mesh label, case): (global output, jax output)} of the twin."""
    out = {}
    lrc = j_factory("plugin=lrc k=4 m=2 l=3")
    clay = j_factory("plugin=clay k=4 m=2")
    for label in MESHES:
        mesh = _jax_mesh(label)
        enc = {k: JM.make_sharded_encoder(reed_sol_van_matrix(k, m), mesh)
               for k, m in ((4, 2), (8, 3))}
        for name in ("rs42_encode", "rs83_encode"):
            out[label, name] = enc[4 if name == "rs42_encode" else 8](
                rs_data(name))
        for name, (erasures, given) in DECODES.items():
            k = 4 if name.startswith("rs42") else 8
            mat = reed_sol_van_matrix(k, 2 if k == 4 else 3)
            dec = JM.make_sharded_decoder(
                mat, erasures, survivors(erasures, given, k, k + mat.shape[0]),
                mesh)
            out[label, name] = dec(enc[k](rs_data(name)))
        n = lrc.get_chunk_count()
        chunks = np.stack([JM.encode_all_chunks(lrc, o)
                           for o in codec_objects(lrc, 6)])
        chunks = np.pad(chunks, ((0, 0), (0, JM.padded_slots(n, mesh) - n),
                                 (0, 0)))
        out[label, "lrc_chunks"] = chunks
        helpers = lrc_helpers(lrc)
        out[label, "lrc_repair"] = JM.make_sharded_gather_apply(
            j_derive(lrc, [0], helpers), tuple(helpers), mesh)(chunks)
        n = clay.get_chunk_count()
        chunks = np.stack([JM.encode_all_chunks(clay, o)
                           for o in codec_objects(clay, 7)])
        chunks = np.pad(chunks, ((0, 0), (0, JM.padded_slots(n, mesh) - n),
                                 (0, 0)))
        out[label, "clay_chunks"] = chunks
        out[label, "clay_repair"] = JM.make_sharded_clay_repair(
            clay, 1, tuple(i for i in range(n) if i != 1), mesh)(chunks)
    return {key: (np.asarray(jax.device_get(v)), v) for key, v in out.items()}


@pytest.fixture(scope="module")
def runs():
    """(per-rank results of the port, the twin's outputs): the ranks run
    while the twin computes."""
    ctx, out = start_ranks(parallel_rank, WORLD)
    try:
        twin = _twin_outputs()
    finally:
        ranks = finish(ctx, out, WORLD)
    return ranks, twin


def _slices(pairs):
    return tuple(slice(a, b) for a, b in pairs)


def _norm(index, shape):
    return [[s.start or 0, dim if s.stop is None else s.stop]
            for s, dim in zip(index, shape)]


@pytest.mark.parametrize("label", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_every_rank_block_equals_the_twins(runs, label, case):
    ranks, twin = runs
    want, jarr = twin[label, case]
    jmesh = _jax_mesh(label)
    where = jarr.sharding.devices_indices_map(want.shape)
    for arrays, meta in ranks:
        got = meta[f"{label}/{case}"]
        assert got["shape"] == list(want.shape)
        assert tuple(got["spec"]) == tuple(jarr.sharding.spec)
        pos = tuple(meta[f"{label}/mesh"]["position"])
        # the block the twin's sharding gives the device at this position
        assert _norm(_slices(got["index"]), want.shape) == \
            _norm(where[jmesh.devices[pos]], want.shape)
        np.testing.assert_array_equal(arrays[f"{label}/{case}"],
                                      want[_slices(got["index"])])


@pytest.mark.parametrize("label", MESHES)
@pytest.mark.parametrize("codec", ("lrc", "clay"))
def test_codec_chunks_equal_the_twins(runs, label, codec):
    ranks, twin = runs
    for arrays, _meta in ranks:
        np.testing.assert_array_equal(arrays[f"{label}/{codec}_chunks"],
                                      twin[label, f"{codec}_chunks"][0])


@pytest.mark.parametrize("label", MESHES)
def test_mesh_shape_and_gather_global(runs, label):
    ranks, twin = runs
    jmesh = _jax_mesh(label)
    for rank, (arrays, meta) in enumerate(ranks):
        m = meta[f"{label}/mesh"]
        assert np.asarray(m["devices"]).shape == jmesh.devices.shape
        assert tuple(m["axes"]) == jmesh.axis_names
        assert m["slots"] == [JM.padded_slots(n, jmesh) for n in (6, 11, 12)]
        assert np.asarray(m["devices"])[tuple(m["position"])] == rank
    np.testing.assert_array_equal(ranks[0][0][f"{label}/gather_global"],
                                  twin[label, "rs83_encode"][0])


@pytest.mark.parametrize("label", MESHES)
def test_encode_sends_nothing(runs, label):
    for _arrays, meta in runs[0]:
        for name in ("rs42_encode", "rs83_encode"):
            assert meta[f"{label}/{name}"]["wire"] == \
                {"calls": 0, "sent": 0, "received": 0, "padding": 0}


def _slots_by_column(wanted, n_slots, shard):
    per = n_slots // shard
    return [sum(1 for s in set(wanted) if c * per <= s < (c + 1) * per)
            for c in range(shard)]


@pytest.mark.parametrize("label", MESHES)
@pytest.mark.parametrize("case", (*DECODES, "lrc_repair"))
def test_gather_receives_only_the_wanted_slots(runs, label, case):
    ranks, twin = runs
    shard = MESHES[label][1]
    if case == "lrc_repair":
        wanted = lrc_helpers(j_factory("plugin=lrc k=4 m=2 l=3"))
        n_slots, L = twin[label, "lrc_chunks"][0].shape[1:]
    else:
        erasures, given = DECODES[case]
        k = 4 if case.startswith("rs42") else 8
        n = k + (2 if k == 4 else 3)
        wanted = survivors(erasures, given, k, n)
        n_slots, L = -(-n // shard) * shard, 256
    dp = WORLD // shard
    row = 8 // dp * L                              # one slot of the block
    counts = _slots_by_column(wanted, n_slots, shard)
    for _arrays, meta in ranks:
        col = meta[f"{label}/mesh"]["position"][1]
        w = meta[f"{label}/{case}"]["wire"]
        others = sum(counts) - counts[col]
        assert w["calls"] == 1
        assert w["received"] - w["padding"] == others * row
        assert w["received"] == w["sent"] == (shard - 1) * max(counts) * row


@pytest.mark.parametrize("label", MESHES)
def test_clay_helpers_ship_beta_of_their_rows(runs, label):
    ranks, twin = runs
    shard = MESHES[label][1]
    clay = j_factory("plugin=clay k=4 m=2")
    n = clay.get_chunk_count()
    helpers = [i for i in range(n) if i != 1]
    _, planes = clay.repair_plan_matrix(1, helpers)
    nsub = clay.get_sub_chunk_count()
    assert len(planes) * clay.q == nsub
    n_slots, L = twin[label, "clay_chunks"][0].shape[1:]
    dp = WORLD // shard
    plane_bytes = 8 // dp * L // nsub * len(planes)   # beta/nsub of a row
    counts = _slots_by_column(helpers, n_slots, shard)
    for _arrays, meta in ranks:
        col = meta[f"{label}/mesh"]["position"][1]
        w = meta[f"{label}/clay_repair"]["wire"]
        assert w["received"] - w["padding"] == \
            (sum(counts) - counts[col]) * plane_bytes
        assert w["received"] * clay.q == \
            (shard - 1) * max(counts) * (8 // dp) * L


def test_mesh_refusals(runs):
    for _arrays, meta in runs[0]:
        errs = meta["errors"]
        assert errs["no_device"][0] == "RuntimeError"
        assert "pass device='cpu'" in errs["no_device"][1]
        assert errs["cuda_on_gloo"][0] == "RuntimeError"
        assert "NCCL" in errs["cuda_on_gloo"][1]
        assert "no gloo fallback" in errs["cuda_on_gloo"][1]
        with pytest.raises(ValueError) as twin:
            JM.default_mesh(np.asarray(jax.devices()[:WORLD]), shard=3)
        assert errs["shard_3"] == ["ValueError", str(twin.value)]
        assert errs["too_many"] == ["RuntimeError",
                                    f"need 8 devices, have {WORLD}"]


@pytest.mark.parametrize("shard", (0, 3, 5))
def test_default_mesh_refuses_a_shard_that_does_not_divide(shard):
    with pytest.raises(ValueError) as twin:
        JM.default_mesh(np.asarray(jax.devices()[:WORLD]), shard=shard)
    with pytest.raises(ValueError) as port:
        TM.default_mesh(list(range(WORLD)), shard=shard)
    assert str(port.value) == str(twin.value)
