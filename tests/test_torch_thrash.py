"""The port's seeded chaos thrasher (ceph_tpu_torch.chaos) held to its
twin (ceph_tpu.chaos) on the CPU.

A seed is the experiment: the fault menu and its weights, the reproducer
line and every draw of a run must be the twin's. For seed 42 (one round
of five ops over MemStores, cephx and AES-GCM sessions, socket-failure
and delay injection live) the port's logged schedule, less the "parked"
lines (an op whose ack raced a fault; thread timing decides those),
equals the twin's. The twin's tier-1 sharded smoke cell (seed 43, two
rounds of six ops, two op shards an OSD) passes its invariants in the
port: convergence, exactly-once bytes, no resurrection.
"""

import pytest
import torch

from ceph_tpu import chaos as J
from ceph_tpu_torch import chaos as T


def _schedule(th):
    return [line for line in th.schedule if not line.startswith("parked")]


def test_knobs_match_twin():
    assert T.KNOBS == J.KNOBS


@pytest.mark.parametrize("kw", [
    {}, {"op_shards": 2}, {"osd_procs": True, "rotate_secrets": True},
    {"overwrite_during_faults": True, "transient_fraction": 0.6},
    {"workload_profile": "noisy", "disk_full": True,
     "link_degrade": True}],
    ids=["plain", "sharded", "procs", "overwrite-transient", "streams"])
def test_repro_command_matches_twin(kw):
    args = (42, "tin", 2, 6)
    assert T.repro_command(*args, **kw) == J.repro_command(*args, **kw)


def test_seed_42_draws_the_twins_schedule():
    twin = J.Thrasher(42, store="mem", rounds=1, ops=5)
    twin.run()
    port = T.Thrasher(42, store="mem", rounds=1, ops=5, device="cpu")
    port.run()
    assert _schedule(port) == _schedule(twin)
    assert port.repro == twin.repro
    assert port.c.device == torch.device("cpu")


def test_sharded_smoke_holds_its_invariants():
    th = T.Thrasher(43, store="mem", rounds=2, ops=6, op_shards=2,
                    device="cpu")
    report = th.run()   # raises InvariantViolation on a violation
    assert report["objects_verified"] > 0, report
    assert {str(d.device) for d in th.c.osds.values()} == {"cpu"}


def test_distinct_seeds_draw_the_twins_menu():
    for seed in (11, 23, 37, 41):
        twin, port = J.Thrasher(seed), T.Thrasher(seed, device="cpu")
        assert [f.__name__ for f in port._menu()] == \
            [f.__name__ for f in twin._menu()]
        assert [port.rng.randrange(len(port._menu())) for _ in range(12)] \
            == [twin.rng.randrange(len(twin._menu())) for _ in range(12)]


def test_thrasher_without_a_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.Thrasher(42)
