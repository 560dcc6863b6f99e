"""The port's chunk-tile streaming (ceph_tpu_torch.ops.streaming) held
against its JAX twin (ceph_tpu.ops.streaming) and the numpy oracle:
every case of tests/test_streaming.py with the same seeds, the port on
the CPU (device="cpu"), for encode and decode, plus the counters."""

import numpy as np
import pytest
import torch

from ceph_tpu.ops import streaming as JS
from ceph_tpu_torch.ec.matrices import reed_sol_van_matrix
from ceph_tpu_torch.gf.numpy_ref import decode_matrix, encode_ref
from ceph_tpu_torch.ops.rs_kernels import make_encoder
from ceph_tpu_torch.ops.streaming import StreamingCodec, make_tiled_encoder
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

K, M = 4, 2
CPU = "cpu"


def data(B=2, L=1 << 16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (B, K, L), dtype=np.uint8)


def oracle(mat, d):
    return np.stack([encode_ref(mat, d[b]) for b in range(len(d))])


class TestTiledEncoder:
    @pytest.mark.parametrize("impl", ["bitlinear", "pallas"])
    def test_matches_oneshot_twin_and_oracle(self, impl):
        mat = reed_sol_van_matrix(K, M)
        d = data(L=1 << 15)
        tiled = make_tiled_encoder(mat, impl, tile=1 << 12)(
            torch.from_numpy(d))
        assert tiled.dtype == torch.uint8 and tiled.device.type == "cpu"
        oneshot = make_encoder(mat, impl)(torch.from_numpy(d))
        assert torch.equal(tiled, oneshot)
        twin = np.asarray(JS.make_tiled_encoder(mat, "bitlinear",
                                                tile=1 << 12)(d))
        np.testing.assert_array_equal(tiled.numpy(), twin)
        np.testing.assert_array_equal(tiled.numpy(), oracle(mat, d))

    def test_rejects_ragged_length_and_bad_shards(self):
        mat = reed_sol_van_matrix(K, M)
        enc = make_tiled_encoder(mat, "bitlinear", tile=1 << 12)
        with pytest.raises(ValueError, match="multiple"):
            enc(torch.from_numpy(data(L=(1 << 12) + 100)))
        with pytest.raises(ValueError, match="multiple"):
            JS.make_tiled_encoder(mat, "bitlinear", tile=1 << 12)(
                data(L=(1 << 12) + 100))
        with pytest.raises(ValueError, match="shards"):
            enc(torch.from_numpy(data(L=1 << 12)[:, :3]))


class TestStreamingCodec:
    def test_encode_matches_oracle_exact_tiles(self):
        mat = reed_sol_van_matrix(K, M)
        d = data(L=1 << 15, seed=1)
        got = StreamingCodec(mat, "bitlinear", tile=1 << 13,
                             device=CPU).encode(d)
        np.testing.assert_array_equal(got, oracle(mat, d))
        twin = JS.StreamingCodec(mat, "bitlinear", tile=1 << 13).encode(d)
        np.testing.assert_array_equal(got, twin)

    @pytest.mark.parametrize("impl", ["bitlinear", "pallas"])
    def test_ragged_tail_exact(self, impl):
        mat = reed_sol_van_matrix(K, M)
        sc = StreamingCodec(mat, impl, tile=1 << 12, device=CPU)
        d = data(L=(1 << 12) * 3 + 777, seed=2)
        got = sc.encode(d)
        np.testing.assert_array_equal(got, oracle(mat, d))
        twin = JS.StreamingCodec(mat, "bitlinear", tile=1 << 12).encode(d)
        np.testing.assert_array_equal(got, twin)
        # the reused tail buffer is zeroed past a shorter tail
        d2 = data(L=(1 << 12) * 2 + 5, seed=12)
        np.testing.assert_array_equal(sc.encode(d2), oracle(mat, d2))

    def test_single_small_object(self):
        mat = reed_sol_van_matrix(K, M)
        d = data(B=1, L=100, seed=3)
        got = StreamingCodec(mat, "bitlinear", tile=1 << 12,
                             device=CPU).encode(d)
        np.testing.assert_array_equal(got, encode_ref(mat, d[0])[None])
        np.testing.assert_array_equal(
            got, JS.StreamingCodec(mat, "bitlinear",
                                   tile=1 << 12).encode(d))

    def test_streaming_decode_roundtrip(self):
        mat = reed_sol_van_matrix(K, M)
        d = data(L=(1 << 12) * 2 + 19, seed=4)
        parity = StreamingCodec(mat, "bitlinear", tile=1 << 12,
                                device=CPU).encode(d)
        erasures = [1, K]  # one data, one parity shard
        survivors = [i for i in range(K + M) if i not in erasures][:K]
        D = decode_matrix(mat, erasures, K, survivors)
        full = np.concatenate([d, parity], axis=1)
        surv = full[:, survivors]
        rebuilt = StreamingCodec(D, "bitlinear", tile=1 << 12,
                                 device=CPU).encode(surv)
        np.testing.assert_array_equal(rebuilt, full[:, erasures])
        np.testing.assert_array_equal(
            rebuilt, JS.StreamingCodec(D, "bitlinear",
                                       tile=1 << 12).encode(surv))

    def test_larger_than_tile_budget(self):
        mat = reed_sol_van_matrix(K, M)
        sc = StreamingCodec(mat, "bitlinear", tile=1 << 18, depth=2,
                            device=CPU)
        d = data(B=1, L=3 << 20, seed=5)
        np.testing.assert_array_equal(sc.encode(d),
                                      encode_ref(mat, d[0])[None])

    def test_preallocated_out_and_bad_shapes(self):
        mat = reed_sol_van_matrix(K, M)
        sc = StreamingCodec(mat, tile=1 << 12, device=CPU)
        d = data(B=2, L=5000, seed=6)
        out = np.empty((2, M, 5000), dtype=np.uint8)
        got = sc.encode(d, out=out)
        assert got is out
        np.testing.assert_array_equal(out, oracle(mat, d))
        with pytest.raises(ValueError):
            sc.encode(d[:, :3])  # wrong shard count
        with pytest.raises(ValueError):
            sc.encode(d, out=np.empty((2, M, 4999), dtype=np.uint8))
        with pytest.raises(ValueError):
            sc.encode(d.astype(np.int16))
        with pytest.raises(ValueError, match="depth"):
            StreamingCodec(mat, depth=0, device=CPU)

    def test_counters_match_the_twin(self):
        def perf(name):
            return (PerfCountersBuilder(name)
                    .add_u64_counter("stream_launches")
                    .add_u64_counter("stream_bytes")
                    .add_time_avg("stream_drain_time")
                    .create_perf_counters())
        from ceph_tpu.utils.perf_counters import PerfCountersBuilder as JB
        jp = (JB("jstream").add_u64_counter("stream_launches")
              .add_u64_counter("stream_bytes")
              .add_time_avg("stream_drain_time").create_perf_counters())
        tp = perf("tstream")
        mat = reed_sol_van_matrix(K, M)
        d = data(B=2, L=(1 << 12) * 3 + 777, seed=7)
        StreamingCodec(mat, "bitlinear", tile=1 << 12, perf=tp,
                       device=CPU).encode(d)
        JS.StreamingCodec(mat, "bitlinear", tile=1 << 12, perf=jp).encode(d)
        for key in ("stream_launches", "stream_bytes"):
            assert tp.get(key) == jp.get(key)
        assert tp.get("stream_launches") == 4
        assert tp.get("stream_bytes") == 4 * 2 * K * (1 << 12)
        assert tp.get("stream_drain_time")["count"] == \
            jp.get("stream_drain_time")["count"] == 4

    def test_the_card_is_the_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StreamingCodec(reed_sol_van_matrix(K, M))
