"""The port's multi-tenant workload engine (ceph_tpu_torch.workload, a
copy of ceph_tpu.workload) held to the twin and to the committed
artifact WORKLOAD_r20.json on the CPU, then run live over the port's
standalone cluster.

For the artifact's profiles, seed and duration (seed 7, 6 s, the four
builtin tenants) each tenant's op stream through the port has the
twin's ops, sha256 digest and routed counts, and the artifact's. A short
two-tenant run over the port's in-process cluster (cephx, AES-GCM, RS
k=2 m=1 on the CPU) completes ops for every tenant and reports the
digests it replayed; nothing about its timing is asserted.
"""

import json
from pathlib import Path

import pytest

from ceph_tpu import workload as J
from ceph_tpu_torch import workload as T
from ceph_tpu_torch.osd import standalone as TS

ROOT = Path(__file__).resolve().parents[1]
ARTIFACT = json.loads((ROOT / "WORKLOAD_r20.json").read_text())
SEED = int(ARTIFACT["config"]["seed"])
DURATION = float(ARTIFACT["config"]["duration_s"])
TENANTS = sorted(ARTIFACT["streams"])


def _stream(W, name):
    profile = {p.name: p for p in W.parse_profiles(ARTIFACT["profiles"])}
    ops = W.OpStream(profile[name], SEED).generate(DURATION)
    return ops, W.OpStream.digest(ops), W.OpStream.routed_counts(ops)


@pytest.mark.parametrize("name", TENANTS)
def test_stream_matches_twin_and_artifact(name):
    ops, digest, routed = _stream(T, name)
    twin_ops, twin_digest, twin_routed = _stream(J, name)
    assert [tuple(op) for op in ops] == [tuple(op) for op in twin_ops]
    assert digest == twin_digest == ARTIFACT["streams"][name]["digest"]
    assert routed == twin_routed == ARTIFACT["streams"][name]["routed"]
    assert len(ops) == ARTIFACT["streams"][name]["ops"]


@pytest.mark.parametrize("name", TENANTS)
def test_payload_matches_twin(name):
    p = T.builtin_mix([name])[0]
    q = J.builtin_mix([name])[0]
    assert p.to_dict() == q.to_dict()
    assert T.streams.payload_for(p, SEED) == J.streams.payload_for(q, SEED)


def test_artifact_profiles_are_the_builtin_mix():
    assert [p.to_dict() for p in T.builtin_mix()] == \
        [p.to_dict() for p in T.parse_profiles(ARTIFACT["profiles"])]
    assert list(T.BUILTIN_PROFILES) == list(J.BUILTIN_PROFILES)


def test_engine_tables_match_twin():
    a = T.WorkloadEngine(None, T.builtin_mix(), seed=SEED)
    b = J.WorkloadEngine(None, J.builtin_mix(), seed=SEED)
    assert a.mclock_tenant_table() == b.mclock_tenant_table() == \
        ARTIFACT["config"]["mclock_table"]
    assert a.slo_rule_text() == b.slo_rule_text()
    lat = [0.001 * i for i in range(1, 200)]
    assert T.percentiles(lat) == J.percentiles(lat)


@pytest.mark.parametrize("spec,match", [
    ({"name": "x", "write_mode": "sideways"}, "write_mode"),
    ({"name": "x", "read_fraction": 1.5}, "read_fraction"),
    ({"name": "x", "op_size": 9000, "object_size": 4096}, "exceeds"),
    ({"name": "x", "iopz": 3}, "unknown profile keys")])
def test_validation_errors_match_twin(spec, match):
    with pytest.raises(ValueError, match=match) as port:
        T.TenantProfile.from_dict(spec)
    with pytest.raises(ValueError) as twin:
        J.TenantProfile.from_dict(spec)
    assert str(port.value) == str(twin.value)


def test_engine_runs_over_the_ports_cluster():
    quiet = T.TenantProfile(
        name="quiet", klass="interactive", iops=12.0, read_fraction=0.6,
        op_size=(128, 512), write_mode="overwrite", objects=4,
        object_size=2048)
    tail = T.TenantProfile(
        name="tail", klass="bursty", iops=10.0, read_fraction=0.2,
        op_size=256, write_mode="append", objects=2, object_size=1024)
    c = TS.StandaloneCluster(
        n_osds=3, pg_num=2, cephx=True, secret=b"\x33" * 32,
        profile="plugin=tpu_rs k=2 m=1 impl=bitlinear", chunk_size=1024,
        hb_grace=60.0, device="cpu")
    try:
        engine = T.WorkloadEngine(c, [quiet, tail], seed=11,
                                  duration_s=1.5)
        engine.setup()
        engine.run()
        results = engine.results()
    finally:
        c.shutdown()
    for p in (quiet, tail):
        row = results[p.name]
        assert row["ops"] > 0 and "p99_ms" in row, row
        assert row["ops"] + row["errors"] == row["stream_ops"]
        assert row["digest"] == J.OpStream.digest(
            J.OpStream(J.TenantProfile.from_dict(p.to_dict()),
                       11).generate(1.5))
