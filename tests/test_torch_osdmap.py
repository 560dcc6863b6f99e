"""The port's OSDMap (ceph_tpu_torch.osd.osdmap) held against its twin
(ceph_tpu.osd.osdmap) on the CPU: object -> PG -> OSD placement through
the scalar oracle path and the batched VectorMapper path, with pg_temp,
primary_temp and upmap overrides, down and out OSDs; and the wire
forms, byte for byte, in both directions. Tolerance: none."""

import numpy as np
import pytest
import torch

import ceph_tpu.crush.map as JCM
import ceph_tpu.osd.osdmap as J
import ceph_tpu_torch.crush.map as TCM
import ceph_tpu_torch.osd.osdmap as T

NONE = JCM.CRUSH_ITEM_NONE
NAMES = ["", "a", "obj1", "rbd_data.1234.0000000000000007",
         "x" * 11, "y" * 12, "z" * 13, "snap@@snap.00000003"]


def build(mod, cmod, **kw):
    """24 OSDs, 4 per host, 3 hosts per rack: an EC pool on an indep
    host rule (pg_num 48, not a power of two) and a replicated pool on
    a firstn rule, then the same run of map changes."""
    crush = cmod.build_hierarchy(24, 4, 3)
    cmod.replicated_rule(crush, 0, choose_type=1)
    cmod.ec_rule(crush, 1, choose_type=1)
    m = mod.OSDMap(crush, **kw)
    m.add_pool(mod.PGPool(1, pg_num=48, size=5, min_size=3, crush_rule=1,
                          is_erasure=True, ec_profile={"k": "3", "m": "2"}))
    m.add_pool(mod.PGPool(2, pg_num=32, size=3, min_size=2, crush_rule=0))
    return m


def mutate(m):
    m.mark_down(5)
    m.mark_out(9)
    m.mark_in(9, 0.5)
    m.mark_out(14)
    m.set_pg_temp((1, 3), [0, 4, 8, 12, 16])
    m.set_pg_temp((2, 7), [1, 5, 9])
    m.set_primary_temp((1, 3), 8)
    m.set_primary_temp((2, 0), 17)
    m.set_pg_upmap_items((1, 10), [(20, 21), (2, 3)])
    m.set_pg_upmap_bulk({(2, 4): [(6, 7)], (2, 5): [(0, 23)]})
    m.record_up_thru(2)
    m.config_set("osd_max_backfills", "3")
    m.pool_mksnap(1, "s1")
    m.set_full_states({4: J.FULL_NEARFULL}, False, [2])
    m.set_pool_quota(2, 1 << 30, 1000)


@pytest.fixture(scope="module")
def maps():
    jm, tm = build(J, JCM), build(T, TCM, device="cpu")
    mutate(jm)
    mutate(tm)
    return jm, tm


def test_hashes_and_masks_match_twin():
    for name in NAMES:
        assert T.str_hash_rjenkins(name) == J.str_hash_rjenkins(name)
    for n in (1, 2, 3, 48, 64, 65, 1000):
        assert T.pg_num_mask(n) == J.pg_num_mask(n)
        xs = np.arange(5000, dtype=np.int64) * 2654435761 % (1 << 32)
        np.testing.assert_array_equal(
            T.ceph_stable_mod(xs, n, T.pg_num_mask(n)),
            J.ceph_stable_mod(xs, n, J.pg_num_mask(n)))


def test_object_and_scalar_placement_match_twin(maps):
    jm, tm = maps
    for pool in (1, 2):
        for name in NAMES + [f"obj{i}" for i in range(200)]:
            assert tm.object_to_pg(pool, name) == jm.object_to_pg(pool, name)
        for ps in range(tm.pools[pool].pg_num):
            assert tm.pg_to_up_acting_osds(pool, ps) == \
                jm.pg_to_up_acting_osds(pool, ps), (pool, ps)
    assert tm.pg_to_up_acting_osds(1, 3)[2:] == ([0, 4, 8, 12, 16], 8)


@pytest.mark.parametrize("pool", [1, 2], ids=["ec-indep", "replicated"])
def test_batched_placement_matches_twin(maps, pool):
    jm, tm = maps
    for fn in ("pgs_to_raw", "pgs_to_up", "pgs_to_acting"):
        got = getattr(tm, fn)(pool)
        assert isinstance(got, np.ndarray) and got.dtype == np.int32
        np.testing.assert_array_equal(got, getattr(jm, fn)(pool), fn)
    # a chosen subset gives the same rows (the twin would compile anew
    # for another lane count, so it is held against the full result)
    ps = np.array([7, 3, 10, 0, 5], np.uint32)
    np.testing.assert_array_equal(tm.pgs_to_acting(pool, ps),
                                  jm.pgs_to_acting(pool)[ps])
    # the batched path agrees with the scalar one, overrides included
    up = tm.pgs_to_up(pool)
    acting = tm.pgs_to_acting(pool)
    for s in range(tm.pools[pool].pg_num):
        u, _, a, _ = tm.pg_to_up_acting_osds(pool, s)
        assert up[s].tolist() == u and acting[s].tolist() == a
    got, want = tm.pg_stats(pool), jm.pg_stats(pool)
    np.testing.assert_array_equal(got["pg_per_osd"], want["pg_per_osd"])
    assert got["degraded_pgs"] == want["degraded_pgs"] > 0
    assert (up == 5).sum() == 0 and (tm.pgs_to_raw(pool) == 14).sum() == 0


def test_encodings_match_twin_both_ways(maps):
    jm, tm = maps
    assert tm.encode() == jm.encode()
    back = T.OSDMap.decode(jm.encode(), device="cpu")
    assert back.encode() == jm.encode()
    assert J.OSDMap.decode(tm.encode()).encode() == tm.encode()
    assert back.device == torch.device("cpu")


def test_incrementals_match_twin_both_ways():
    jm0, tm0 = build(J, JCM), build(T, TCM, device="cpu")
    jm1, tm1 = jm0.shallow_clone(), tm0.shallow_clone()
    assert tm1._vm is tm0._vm and tm1.device == tm0.device
    mutate(jm1)
    mutate(tm1)
    jinc, tinc = J.Incremental.diff(jm0, jm1), T.Incremental.diff(tm0, tm1)
    assert tinc.encode() == jinc.encode()
    # each package applies the other's delta and lands on the same map
    t_applied = T.Incremental.decode(jinc.encode()).apply(
        tm0.shallow_clone())
    j_applied = J.Incremental.decode(tinc.encode()).apply(
        jm0.shallow_clone())
    assert T.same_state(t_applied, tm1) and J.same_state(j_applied, jm1)
    assert t_applied.encode() == j_applied.encode()
    assert t_applied._vm is tm0._vm
    # a topology change ships the full map; it decodes on m's device
    crush2 = TCM.build_hierarchy(28, 4, 3)
    TCM.ec_rule(crush2, 1, choose_type=1)
    full = T.Incremental.diff(tm0, T.OSDMap(crush2, epoch=tm0.epoch + 1,
                                            device="cpu"))
    assert full.full_blob is not None
    got = T.Incremental.decode(full.encode()).apply(tm0.shallow_clone())
    assert got.device == torch.device("cpu") and got.crush.n_devices == 28


def test_no_device_means_the_card():
    crush = TCM.build_hierarchy(8, 2, 2)
    if torch.cuda.is_available():
        assert T.OSDMap(crush).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.OSDMap(crush)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.OSDMap.decode(T.OSDMap(crush, device="cpu").encode())
