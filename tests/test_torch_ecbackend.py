"""The port's device programs (ceph_tpu_torch.osd.ecbackend) held
bit-exact against the twin's (ceph_tpu.osd.ecbackend), called directly
on the same numpy-seeded stripes, on the CPU; and the slice as a whole:
write -> lose two shards -> fused recovery -> decode_concat, in both
packages, at k=8 m=3.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.csum.reference import ceph_crc32c
from ceph_tpu.ec import registry as JR
from ceph_tpu.osd import ecbackend as JB
from ceph_tpu_torch.ec import registry as TR
from ceph_tpu_torch.osd import ecbackend as TB

PROFILE = "plugin=jerasure technique=reed_sol_van k=8 m=3"
K, M, SL = 8, 3, 1024
LOST = (0, 9)
SURV = [1, 2, 3, 4, 5, 6, 7, 8]


@pytest.fixture(scope="module")
def coders():
    return TR.factory(PROFILE, device="cpu"), JR.factory(PROFILE + " impl=mxu")


def _stripes(B, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, K, SL), np.uint8)


def _u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("B,bucket", [(4, 4), (3, 4)])
def test_fused_write_matches_jax_twin(coders, B, bucket):
    port, twin = coders
    data = _stripes(bucket, seed=B)
    data[B:] = 0                       # the bucket's padding rows
    mb = twin.matrix.tobytes()
    tp, tc = TB._fused_write_fn(mb, M, K, port.impl, SL, bucket,
                                port.device)(torch.from_numpy(data))
    jp, jc = JB.ECBackend._fused_write_fn(mb, M, K, "mxu", SL, bucket)(data)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_u32(tc), np.asarray(jc))
    rows = np.concatenate([data, tp.numpy()], axis=1)
    assert int(tc[1, 9]) == ceph_crc32c(0xFFFFFFFF, rows[1, 9])


def test_fused_write_rejects_other_shapes(coders):
    port, _ = coders
    fn = TB._fused_write_fn(port.matrix.tobytes(), M, K, port.impl, SL, 4,
                            "cpu")
    with pytest.raises(ValueError, match="fused write wants"):
        fn(torch.zeros((2, K, SL), dtype=torch.uint8))


def test_fold_constants_match_jax_twin():
    exp = np.random.default_rng(1).integers(0, 1 << 32, (5, 8),
                                            dtype=np.uint32)
    for sl in (64, 1024, 524288):
        assert TB._fold_seed_const(sl) == JB._fold_seed_const(sl)
        np.testing.assert_array_equal(TB._expected_fold_crcs(exp, sl),
                                      JB._expected_fold_crcs(exp, sl))


def _helpers_and_exp(port, B, seed):
    data = _stripes(B, seed)
    full = np.concatenate(
        [data, port.encode_chunks(data).numpy()], axis=1)
    stack = np.ascontiguousarray(full[:, SURV])
    exp = np.array([[ceph_crc32c(0xFFFFFFFF, r) for r in obj]
                    for obj in stack], np.uint32)
    return full, stack, exp


@pytest.mark.parametrize("verify", [True, False])
def test_recover_program_device_mode_matches_jax_twin(coders, verify):
    port, twin = coders
    full, stack, exp = _helpers_and_exp(port, 4, seed=7)
    stack[2, 5, 17] ^= 0x40            # a rotten helper in object 2
    expfold = TB._expected_fold_crcs(exp, SL)
    tfn = TB._build_recover_program(port.batch_decoder(LOST, SURV),
                                    verify, False)
    jfn = JB._build_recover_program(twin.batch_decoder(LOST, SURV),
                                    verify, False)
    trb, trc, tok = tfn(torch.from_numpy(stack), expfold)
    jrb, jrc, jok = jfn(stack, expfold)
    np.testing.assert_array_equal(trb.numpy(), np.asarray(jrb))
    np.testing.assert_array_equal(_u32(trc), np.asarray(jrc))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.tolist() == ([True, True, False, True] if verify
                            else [True] * 4)


@pytest.mark.parametrize("verify", [True, False])
def test_recover_program_host_crc_mode_matches_jax_twin(coders, verify):
    port, twin = coders
    _, stack, _ = _helpers_and_exp(port, 2, seed=8)
    tout = TB._build_recover_program(port.batch_decoder(LOST, SURV),
                                     verify, True)(torch.from_numpy(stack))
    jout = JB._build_recover_program(twin.batch_decoder(LOST, SURV),
                                     verify, True)(stack)
    assert len(tout) == len(jout) == (2 if verify else 1)
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_slice_write_lose_recover_matches_jax_twin(coders):
    """The port's main path at small size, end to end, beside the
    twin's: every byte and CRC agrees, every fold check passes, and the
    rebuilt shards and objects are the written ones."""
    port, twin = coders
    B = 4
    data = _stripes(B, seed=11)
    mb = twin.matrix.tobytes()
    tw = TB._fused_write_fn(mb, M, K, port.impl, SL, B, port.device)
    tparity, tcrc = tw(torch.from_numpy(data))
    jparity, jcrc = JB.ECBackend._fused_write_fn(mb, M, K, "mxu", SL, B)(data)
    np.testing.assert_array_equal(tparity.numpy(), np.asarray(jparity))
    np.testing.assert_array_equal(_u32(tcrc), np.asarray(jcrc))
    full = torch.cat([torch.from_numpy(data), tparity], dim=1)
    stack = full[:, SURV]
    exp = _u32(tcrc)[:, SURV]
    expfold = TB._expected_fold_crcs(exp, SL)
    rec = TB._build_recover_program(port.batch_decoder(LOST, SURV), True,
                                    False)
    rebuilt, rcrc, ok = rec(stack, torch.from_numpy(expfold.astype(np.int64)))
    jrebuilt, jrcrc, jok = JB._build_recover_program(
        twin.batch_decoder(LOST, SURV), True, False)(stack.numpy(), expfold)
    assert ok.all() and np.asarray(jok).all()
    np.testing.assert_array_equal(rebuilt.numpy(), np.asarray(jrebuilt))
    np.testing.assert_array_equal(_u32(rcrc), np.asarray(jrcrc))
    for e, s in enumerate(LOST):
        assert torch.equal(rebuilt[:, e], full[:, s])
        assert torch.equal(rcrc[:, e], tcrc[:, s])
    have = {i: full[:, i] for i in range(K + M) if i not in LOST}
    obj = port.decode_concat(have, K * SL - 3)
    jobj = twin.decode_concat({i: v.numpy() for i, v in have.items()},
                              K * SL - 3)
    np.testing.assert_array_equal(obj.numpy(), np.asarray(jobj))
    np.testing.assert_array_equal(obj.numpy(),
                                  data.reshape(B, -1)[:, :K * SL - 3])
