"""The compiled schedule of the port's GF(2^8) kernel (ops/gf_kernel.py,
csrc/gf_apply.cu), held on the CPU against the plain version and the
JAX twin.

`run_schedule` walks a schedule's row groups, chunks and entries the way
gf_apply_kernel does, with its PRMT masks; it must give the plain
version's bytes and the twin's: the Pallas kernel in interpret mode
(about 2-10 s a call, so for the small families only) or, for config
#4's and the wide matrices, the twin's numpy oracle. The CUDA kernel
itself is held against the plain version by chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec.matrices import reed_sol_van_matrix
from ceph_tpu.gf import numpy_ref as R
from ceph_tpu.ops.pallas_gf import apply_matrix_pallas
from ceph_tpu_torch.ec import registry as TR
from ceph_tpu_torch.ops import gf_kernel as G


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


def _sparse(m, k, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 256, (m, k)) * (rng.random((m, k)) < density)
            ).astype(np.uint8)


def _clay(k, m, d, lost=None):
    """Clay's encode, single-loss repair of shard 0 from its d helpers,
    and two-loss decode of shards 0 and `lost` (the port's coder)."""
    coder = TR.factory(f"plugin=clay k={k} m={m} d={d}", device="cpu")
    n = coder.get_chunk_count()
    lost = (0, lost if lost is not None else k + 1)
    enc, _ = coder._affine_decode(tuple(range(k, n)), tuple(range(k)))
    rep, _ = coder.repair_plan_matrix(0, list(range(1, d + 1)))
    dec, _ = coder._affine_decode(lost, tuple(c for c in range(n)
                                              if c not in lost))
    return {"encode": enc, "repair": rep, "decode": dec}


def _rs(lost):
    mat = reed_sol_van_matrix(8, 3)
    if not lost:
        return mat
    surv = [s for s in range(11) if s not in lost][:8]
    return R.decode_matrix(mat, list(lost), 8, surv)


def _lrc_layer(i):
    return TR.factory("plugin=lrc k=8 m=4 l=4",
                      device="cpu").layers[i].coder.matrix


SMALL = {
    "rs encode": lambda: _rs(()),
    "rs decode 1-loss": lambda: _rs((3,)),
    "rs decode 2-loss": lambda: _rs((0, 9)),
    "rs decode 3-loss": lambda: _rs((1, 5, 10)),
    "lrc global layer": lambda: _lrc_layer(0),
    "lrc local layer 1": lambda: _lrc_layer(1),
    "lrc local layer 2": lambda: _lrc_layer(2),
    "lrc local layer 3": lambda: _lrc_layer(3),
    "clay k4m2d5 encode": lambda: _clay(4, 2, 5)["encode"],
    "clay k4m2d5 repair": lambda: _clay(4, 2, 5)["repair"],
    "clay k4m2d5 decode": lambda: _clay(4, 2, 5)["decode"],
    "shec k4m3c2 encode": lambda: TR.factory(
        "plugin=shec k=4 m=3 c=2", device="cpu").matrix,
    # zero rows, zero columns, m not a multiple of the row group
    "random m=12 zero rows and columns": lambda: np.where(
        np.isin(np.arange(12)[:, None], [0, 9]) |
        np.isin(np.arange(9)[None, :], [2, 7]), 0, _rand((12, 9), 12)
    ).astype(np.uint8),
    "random m=5 sparse": lambda: _sparse(5, 7, 0.4, 5),
    "random m=3 k=1": lambda: _rand((3, 1), 3) | 1,
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_schedule_equals_plain_and_pallas_twin(name):
    mat = np.ascontiguousarray(SMALL[name](), np.uint8)
    m, k = mat.shape
    data = _rand((2, k, 64), seed=m * 31 + k)
    got = G.run_schedule(G.compile_schedule(mat), torch.from_numpy(data))
    want = G.apply_matrix_plain(mat, torch.from_numpy(data))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(apply_matrix_pallas(mat, data)))


@pytest.fixture(scope="module")
def config4():
    """BASELINE config #4 (Clay k=8 m=4 d=11): encode (256, 512), repair
    of shard 0 (64, 176), two-loss decode of 0 and 9 (128, 640)."""
    return _clay(8, 4, 11, lost=9)


@pytest.mark.parametrize("name,entries", [("encode", 4480),
                                          ("repair", 256),
                                          ("decode", 2556)])
def test_config4_schedule_holds_the_nonzero_groups(config4, name, entries):
    mat = config4[name]
    sched = G.compile_schedule(mat)
    assert sched.mt == 8
    assert len(sched.ent) == G.nonzero_groups(mat, 8) == entries
    # one word per non-zero coefficient and bit, none for a zero one
    assert len(sched.words) == 8 * int((mat != 0).sum())


@pytest.mark.parametrize("name", ["encode", "repair", "decode"])
def test_config4_schedule_equals_plain_and_twin(config4, name):
    mat = config4[name]
    data = _rand((2, mat.shape[1], 64), seed=mat.shape[1])
    got = G.run_schedule(G.compile_schedule(mat), torch.from_numpy(data))
    assert torch.equal(got, G.apply_matrix_plain(mat, torch.from_numpy(data)))
    np.testing.assert_array_equal(got.numpy(), R.encode_ref(mat, data))


@pytest.mark.parametrize("m,k,density", [(8, 640, 0.05), (8, 2560, 0.05),
                                         (20, 2560, 0.01)])
def test_wide_sparse_schedule_equals_plain_and_twin(m, k, density):
    mat = _sparse(m, k, density, seed=k + m)
    mat[:, :5] = 0                  # zero columns
    mat[3] = 0                      # a zero row
    data = _rand((1, k, 12), seed=k)
    got = G.run_schedule(G.compile_schedule(mat), torch.from_numpy(data))
    assert torch.equal(got, G.apply_matrix_plain(mat, torch.from_numpy(data)))
    np.testing.assert_array_equal(got.numpy(), R.encode_ref(mat, data))


# -- the schedule's shared-memory chunks (the kernel's staging) --------------

CHUNKS = [
    # (m, k, density, chunk budget in bytes); None is CHUNK_BYTES
    (3, 8, 1.0, None),              # RS k=8 m=3: one chunk
    (3, 8, 1.0, 128),               # one entry's words a chunk
    (3, 8, 1.0, 300),
    (1, 4, 1.0, 32),                # m=1: 32-byte entries
    (12, 5, 1.0, 256),              # two row groups
    (64, 176, 0.09, None),          # config #4 repair density
    (256, 512, 0.05, None),         # config #4 encode density
    (128, 640, 0.09, None),         # config #4 decode density
    (128, 640, 0.09, 4096),         # ... in 4 KiB chunks
    (8, 250, 1.0, None),            # one 62.5 KiB chunk (past 48 KiB)
    (8, 250, 1.0, 48 * 1024),       # ... cut at 48 KiB
    (8, 2560, 1.0, None),           # 640 KiB in chunks of 96 KiB
    (8, 2560, 0.05, None),          # sparse: one chunk
    (1024, 2560, 0.002, None),      # Clay k=10 m=4 d=13 encode's shape
    (16, 40, 0.0, None),            # no entry at all
]


@pytest.mark.parametrize("m,k,density,budget", CHUNKS)
def test_chunks_cover_each_group_within_the_budget(m, k, density, budget):
    mat = _sparse(m, k, density, seed=m + k) if density < 1 else \
        _rand((m, k), seed=m + k) | 1
    sched = G.compile_schedule(mat, chunk_bytes=budget)
    cw = (G.CHUNK_BYTES if budget is None else budget) // 4
    wo = np.zeros(len(sched.ent) + 1, np.int64)
    np.cumsum([8 * bin(e & 0xFF).count("1") for e in sched.ent], out=wo[1:])
    # each group's entries, counted from the matrix
    mt = sched.mt
    padded = np.zeros((sched.groups * mt, k), np.uint8)
    padded[:m] = mat
    counts = (padded.reshape(sched.groups, mt, k) != 0).any(axis=1).sum(1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for g in range(sched.groups):
        chunks = [(int(sched.cent[c]), int(sched.cent[c + 1]))
                  for c in range(sched.gch[g], sched.gch[g + 1])]
        # the chunks cover the group's entries in order, each of whole
        # entries within the budget, each as long as the budget allows
        bounds = [int(starts[g])] + [b for _, b in chunks]
        assert bounds[-1] == starts[g + 1]
        assert [a for a, _ in chunks] == bounds[:-1]
        for i, (a, b) in enumerate(chunks):
            assert a < b and wo[b] - wo[a] <= cw
            c = sched.gch[g] + i
            assert sched.cwo[c] == wo[a] and sched.cwo[c + 1] == wo[b]
            if i + 1 < len(chunks):
                assert wo[b + 1] - wo[a] > cw
    assert sched.chunk_words == max(
        [int(sched.cwo[c + 1] - sched.cwo[c]) for c in range(len(sched.cwo)
                                                             - 1)] + [0])
    assert sched.chunk_words <= cw and sched.chunk_words % 8 == 0
    rec = sched.group_records()
    assert rec.shape == (sched.groups, 12)
    for g in range(sched.groups):
        c0, c1, e0, e1 = rec[g, :4]
        assert (c0, c1) == (sched.gch[g], sched.gch[g + 1])
        n = min(3, e1 - e0)
        assert list(rec[g, 4:4 + n]) == list(sched.ent[e0:e0 + n])
        if c1 > c0:
            assert list(rec[g, 8:11]) == [sched.cwo[c0], sched.cwo[c0 + 1],
                                          sched.cent[c0 + 1]]


@pytest.mark.parametrize("budget", [32 * 8, 32 * 8 + 96, 1024, None])
def test_chunked_interpreter_equals_plain(budget):
    mat = _sparse(20, 30, 0.4, seed=20)
    data = torch.from_numpy(_rand((2, 30, 40), seed=3))
    sched = G.compile_schedule(mat, chunk_bytes=budget)
    assert torch.equal(G.run_schedule(sched, data),
                       G.apply_matrix_plain(mat, data))


def test_interpreter_masks_are_the_prmt_sign_spread():
    # shift bit b of each byte to bit 7, spread bit 7 over the byte:
    # 0xFF exactly where bit b is set, byte by byte
    x = np.arange(256, dtype=np.uint32) * np.uint32(0x01010101)
    for bit in range(8):
        mask = (((x << np.uint32(7 - bit)) & np.uint32(0x80808080))
                >> np.uint32(7)) * np.uint32(0xFF)
        want = np.where((np.arange(256) >> bit) & 1, 0xFFFFFFFF, 0)
        np.testing.assert_array_equal(mask, want.astype(np.uint32))


def test_row_groups_and_staging_rule(config4):
    assert [G.group_rows(m) for m in (1, 2, 3, 4, 5, 8, 9, 256)] == \
        [1, 2, 4, 4, 8, 8, 8, 8]
    # schedules of at most 512 bytes of words are read from global
    # memory; larger ones, config #4's among them, are staged in shared
    # memory
    for name, staged in (("rs decode 1-loss", False),
                         ("rs decode 2-loss", False),     # 512 bytes
                         ("lrc local layer 1", False),
                         ("shec k4m3c2 encode", False),
                         ("rs encode", True),             # 768 bytes
                         ("lrc global layer", True)):
        assert G.stages(G.compile_schedule(SMALL[name]())) == staged
    assert all(G.stages(G.compile_schedule(mat))
               for mat in config4.values())
    with pytest.raises(ValueError, match="1, 2, 4 or 8"):
        G.compile_schedule(_rs(()), mt=3)
    with pytest.raises(ValueError, match="hold an entry"):
        G.compile_schedule(_rs(()), mt=4, chunk_bytes=64)
