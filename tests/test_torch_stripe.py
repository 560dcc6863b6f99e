"""The port's stripe geometry and HashInfo (ceph_tpu_torch.osd.stripe)
held byte for byte against the twin (ceph_tpu.osd.stripe) on the same
numpy-seeded inputs, on the CPU. Tolerance: none."""

import numpy as np
import pytest
import torch

from ceph_tpu.csum.reference import ceph_crc32c
from ceph_tpu.osd import stripe as JS
from ceph_tpu_torch.osd import stripe as TS


@pytest.mark.parametrize("k,cs,size", [(4, 128, 1200), (8, 4096, 40000),
                                       (3, 256, 1), (4, 128, 512)])
def test_layout_round_trip_matches_twin(k, cs, size):
    rng = np.random.default_rng(size)
    obj = rng.integers(0, 256, (3, size), dtype=np.uint8)
    js, ts = JS.StripeInfo(k, cs), TS.StripeInfo(k, cs)
    shards = ts.object_to_shards(obj)
    np.testing.assert_array_equal(shards, js.object_to_shards(obj))
    np.testing.assert_array_equal(ts.shards_to_object(shards, size), obj)
    for off, ln in ((0, 1), (size // 2, 77), (size - 1, 1)):
        assert ts.offset_len_to_stripe_bounds(off, ln) == \
            js.offset_len_to_stripe_bounds(off, ln)
        assert ts.offset_len_to_chunk_bounds(off, ln) == \
            js.offset_len_to_chunk_bounds(off, ln)
        assert ts.chunk_index_of(off) == js.chunk_index_of(off)
    assert ts.object_size_to_shard_size(size) == \
        js.object_size_to_shard_size(size)


@pytest.mark.parametrize("data", [b"\x01\x02\x03", bytearray(b"xy"),
                                  np.arange(6, dtype=np.uint8).reshape(2, 3)])
def test_as_flat_u8_matches_twin(data):
    np.testing.assert_array_equal(TS.as_flat_u8(data), JS.as_flat_u8(data))


@pytest.mark.parametrize("lengths", [(100, 57), (4096, 5), (1, 1, 7)])
def test_hashinfo_append_matches_twin(lengths):
    rng = np.random.default_rng(sum(lengths))
    jh, th = JS.HashInfo(n_shards=3), TS.HashInfo(n_shards=3)
    at = 0
    parts = []
    for ln in lengths:
        chunk = rng.integers(0, 256, (3, ln), dtype=np.uint8)
        parts.append(chunk)
        jh.append(at, chunk)
        th.append(at, chunk, device="cpu")
        at += ln
    assert th.cumulative_shard_hashes == jh.cumulative_shard_hashes
    assert th.total_chunk_size == jh.total_chunk_size == at
    for s in range(3):
        full = np.concatenate([p[s] for p in parts])
        assert th.get_chunk_hash(s) == ceph_crc32c(0xFFFFFFFF, full)
        assert th.verify_shard(s, full)
    assert not th.verify_shard(0, np.zeros(at, np.uint8))
    assert not th.verify_shard(0, parts[0][0][:-1])


def test_hashinfo_serialization_matches_twin():
    chunk = np.arange(4 * 33, dtype=np.uint8).reshape(4, 33)
    jh, th = JS.HashInfo(n_shards=4), TS.HashInfo(n_shards=4)
    jh.append(0, chunk)
    th.append(0, chunk, device="cpu")
    assert th.to_bytes() == jh.to_bytes()
    back = TS.HashInfo.from_bytes(jh.to_bytes())
    assert back == th
    assert JS.HashInfo.from_bytes(th.to_bytes()).cumulative_shard_hashes \
        == back.cumulative_shard_hashes


def test_hashinfo_append_checks_and_empty_append():
    th = TS.HashInfo(n_shards=2)
    th.append(0, np.zeros((2, 0), np.uint8), device="cpu")
    assert th.cumulative_shard_hashes == [0xFFFFFFFF] * 2
    th.append(0, np.zeros((2, 8), np.uint8), device="cpu")
    with pytest.raises(ValueError, match="shard offset"):
        th.append(0, np.zeros((2, 8), np.uint8), device="cpu")
    with pytest.raises(ValueError, match="must be"):
        th.append(8, np.zeros((3, 8), np.uint8), device="cpu")


def test_hashinfo_append_runs_on_the_card_by_default(monkeypatch):
    # no device argument means the CUDA device, never a quiet CPU run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.HashInfo(n_shards=1).append(0, np.zeros((1, 4), np.uint8))
