"""The port's `ceph` CLI, thrash reproducer, profile_diff and corpus
generator held to their JAX twins on the CPU, and every tool's device.

Hermetic `ceph_cli` runs each scenario's command through both packages
(the port's with `--device cpu`): exit codes and stdout equal byte for
byte. Live `ceph_cli` from both packages reads ONE running port
StandaloneCluster of 8 OSDs through its admin sockets; the port asks,
the twin asks, the port asks again, and where the port's two answers
agree the twin's is the same. The cluster's MgrReports are held still
for this (mgr_report_interval set to an hour once every PG is clean and
a report has gone out), so the monitors' aggregate moves only by the
monitor's own count of the commands it answered (`mon_cmds`), which
each query raises, so its value is dropped; a daemon's own counters
move with its heartbeats, between which the three answers fall. The thrash reproducer's report drops its host-clock
field `elapsed_s` (in `torch_tools_helpers.CLOCK_FIELDS`).
"""

import hashlib
import json
import re
import time

import pytest
import torch

from torch_tools_helpers import ROOT, drop_clock, port_tool, run, twin_tool

CPU = ["--device", "cpu"]

# -- ceph, hermetic -----------------------------------------------------------

HEALTHY = [["status"], ["--json", "status"], ["health"], ["--json", "health"],
           ["df"], ["--json", "df"], ["osd-df"], ["--json", "osd-df"],
           ["pg", "stat"], ["--json", "pg", "stat"], ["perf", "dump"],
           ["prometheus"], ["autoscale-status"], ["--json", "autoscale-status"],
           ["balancer"], ["--json", "balancer"],
           ["tier", "--objects", "12", "--target-max-bytes", "4096"],
           ["config", "set", "osd_max_backfills", "4"],
           ["config", "get", "osd_max_backfills"], ["config", "dump"],
           ["config", "get", "no_such_option"], ["config", "set"],
           ["top"]]
CASES = [("healthy", c) for c in HEALTHY] + [
    (s, c) for s in ("osd-failure", "mon-loss", "backfill")
    for c in (["status"], ["health"], ["pg", "stat"], ["--json", "status"])] + [
    ("mon-loss", ["config", "set", "osd_max_backfills", "2"]),
    ("backfill", ["osd-df"])]


@pytest.mark.parametrize("scenario,cmd", CASES,
                         ids=[f"{s}-{'-'.join(c)}" for s, c in CASES])
def test_hermetic_ceph_prints_the_twins(scenario, cmd):
    argv = ["--scenario", scenario, "--num-osds", "12", "--pg-num", "8"] + cmd
    t = run(twin_tool("ceph_cli"), argv)
    p = run(port_tool("ceph_cli"), CPU + argv)
    assert (p[0], p[1]) == (t[0], t[1])
    if t[0] and "usage:" not in t[2]:
        assert p[2] == t[2]


# -- ceph, live ---------------------------------------------------------------

@pytest.fixture(scope="module")
def live():
    from ceph_tpu_torch.osd.standalone import StandaloneCluster
    from ceph_tpu_torch.utils.config import g_conf
    # a beat a second: the daemons' own counters hold still between
    # beats for longer than three answers take on a loaded host
    c = StandaloneCluster(n_osds=8, pg_num=4, chunk_size=256, device="cpu",
                          hb_interval=1.0, hb_grace=60.0)
    try:
        for d in c.osds.values():
            d.config.set("daemon_profile_hz", 0, level="override")
        c.client().write({f"live-{i}": bytes([i]) * 3000 for i in range(8)})
        c.wait_for_clean(60)
        time.sleep(3.5)        # every daemon reports (mgr_report_interval)
        for d in c.osds.values():
            d.config.set("mgr_report_interval", 3600.0, level="override")
        g_conf.set("mgr_report_interval", 3600.0, level="override")
        time.sleep(0.5)
        yield c
    finally:
        g_conf.rm("mgr_report_interval", level="override")
        c.shutdown()


def _still(out: bytes) -> bytes:
    """The answer less the monitor's own command counter."""
    out = re.sub(rb"(mon_cmds\{[^}]*\}) \d+", rb"\1 N", out)
    return re.sub(rb'("mon_cmds": )\d+', rb"\1N", out)


LIVE = [["status"], ["--json", "status"], ["health"], ["health", "detail"],
        ["--json", "health", "detail"], ["prometheus"], ["perf", "dump"],
        ["pg", "stat"], ["--json", "pg", "stat"],
        ["daemon", "osd.0", "perf", "dump"], ["daemon", "osd.5", "perf",
                                              "dump"],
        ["daemon", "mon.0", "perf", "dump"], ["trace"], ["trace", "list"],
        ["--json", "trace", "slow"], ["df"], ["slo"], ["daemon", "osd.9",
                                                       "perf", "dump"]]


@pytest.mark.parametrize("cmd", LIVE, ids=["-".join(c) for c in LIVE])
def test_live_ceph_of_both_packages_reads_one_port_cluster(live, cmd):
    argv = ["--asok-dir", live.admin_dir] + cmd
    # a daemon's own counters move with each heartbeat: ask again
    # until no beat falls between the port's two answers
    for _ in range(20):
        p1 = run(port_tool("ceph_cli"), CPU + argv)
        t = run(twin_tool("ceph_cli"), argv)
        p2 = run(port_tool("ceph_cli"), CPU + argv)
        if (p1[0], _still(p1[1])) == (p2[0], _still(p2[1])):
            break
        time.sleep(0.05)
    else:
        pytest.fail(f"the port's answers to {cmd} never held still")
    assert t[0] == p1[0] and _still(t[1]) == _still(p1[1])
    if cmd[:2] == ["daemon", "osd.9"]:
        assert p1[0] == 1 and t[2] == p1[2]
    else:
        assert p1[0] == 0 and p1[1]
    if cmd == ["status"]:
        assert b"osd: 8 osds: 8 up, 8 in" in p1[1]


def test_live_only_commands_refuse_hermetic_mode():
    t = run(twin_tool("ceph_cli"), ["trace"])
    p = run(port_tool("ceph_cli"), CPU + ["trace"])
    assert t == p and p[0] == 1 and "needs --asok-dir" in p[2]


# -- thrash -------------------------------------------------------------------

# the twin's seed-42 schedule over TinStores, one round (its tool with
# --seed 42 --store tin --rounds 1 --repro, less "parked" lines); the
# same seed over MemStores at 5 ops a round gives 493aa142...
THRASH_TIN_SHA = \
    "2a00c41c4904d0984149ff726f21ecf4fc118e2d7123f1fc05dcf7148855fdc0"


def thrash_schedule(out: bytes, seed: int = 42) -> list:
    tag = f"thrash[{seed}]: "
    return [line[len(tag):] for line in out.decode().splitlines()
            if line.startswith(tag)]


def test_thrash_replays_the_twins_cell():
    argv = ["--seed", "42", "--store", "tin", "--rounds", "1", "--repro"]
    t = run(twin_tool("thrash"), argv)
    p = run(port_tool("thrash"), CPU + argv)
    assert t[0] == p[0] == 0
    schedules = []
    for out in (t[1], p[1]):
        sched = [x for x in thrash_schedule(out) if not x.startswith("parked")]
        schedules.append(hashlib.sha256("\n".join(sched).encode()).hexdigest())
    assert schedules == [THRASH_TIN_SHA] * 2
    reports = [json.loads(out.decode().splitlines()[-1]) for out in (t[1], p[1])]
    for rep in reports:
        rep.pop("elapsed_s")            # host clock
    if not any(x.startswith("parked") for out in (t[1], p[1])
               for x in thrash_schedule(out)):
        # thread timing decides the parked ops; without them the whole
        # output is the twin's
        assert drop_clock(t[1]) == drop_clock(p[1])
    else:
        for rep in reports:
            for key in ("schedule_len", "objects_verified", "unknown_fate"):
                rep.pop(key)
    assert reports[0] == reports[1] and reports[1]["ok"]


def test_thrash_matrix_runs_the_twins_cells():
    """--matrix N runs seeds 1..N; each cell's report is the twin's but
    for its host clock and what thread timing decides (parked ops)."""
    argv = ["--matrix", "2", "--rounds", "1", "--ops", "1"]
    t = run(twin_tool("thrash"), argv)
    p = run(port_tool("thrash"), CPU + argv)
    assert t[0] == p[0] == 0
    reports = []
    for out in (t[1], p[1]):
        rows = [json.loads(line) for line in out.decode().splitlines()]
        for rep in rows:
            for key in ("elapsed_s", "schedule_len", "objects_verified",
                        "unknown_fate"):
                rep.pop(key)
        reports.append(rows)
    assert reports[0] == reports[1]
    assert [r["seed"] for r in reports[1]] == [1, 2]


def test_thrash_lists_the_twins_knobs():
    t = run(twin_tool("thrash"), ["--list-knobs"])
    p = run(port_tool("thrash"), CPU + ["--list-knobs"])
    assert t == p and p[0] == 0 and b"fault menu" in p[1]


# -- profile_diff -------------------------------------------------------------

def _profiles(tmp_path):
    before = {"profile": {"samples": 100,
                          "categories": {"queue": 40, "crypto": 10,
                                         "encode": 30, "store": 20},
                          "top_stacks": [
                              {"category": "queue", "stack": "a;b;c",
                               "samples": 30},
                              {"category": "encode", "stack": "x;" * 50 + "y",
                               "samples": 30}]}}
    after = {"encode": {"x;y": 70, "x;z": 10}, "queue": {"a;b;c": 20}}
    (tmp_path / "before.json").write_text(json.dumps(before))
    (tmp_path / "after.json").write_text(json.dumps(after))
    (tmp_path / "bad.json").write_text("[1, 2]")
    return [str(tmp_path / n) for n in ("before.json", "after.json",
                                        "bad.json")]


@pytest.mark.parametrize("order,extra,rc", [
    ((0, 1), [], 1), ((0, 1), ["--json"], 1),
    ((1, 0), ["--threshold", "0.5"], 0), ((0, 0), ["--top", "1"], 0),
    ((0, 2), [], 2), ((0, 2), ["--json"], 2)],
    ids=["regressed", "json", "ok", "same", "bad", "bad-json"])
def test_profile_diff_prints_the_twins(order, extra, rc, tmp_path):
    files = _profiles(tmp_path)
    argv = [files[order[0]], files[order[1]]] + extra
    t = run(twin_tool("profile_diff"), argv)
    p = run(port_tool("profile_diff"), CPU + argv)
    assert t == p and p[0] == rc


# -- make_corpus --------------------------------------------------------------

def test_make_corpus_regenerates_the_pinned_corpus(tmp_path):
    out = tmp_path / "corpus.json"
    rc, text, _ = run(port_tool("make_corpus"), CPU + ["--out", str(out)])
    assert rc == 0 and text == f"wrote {out}: 12 entries\n".encode()
    with open(f"{ROOT}/tests/corpus/corpus.json", "rb") as f:
        assert out.read_bytes() == f.read()


# -- every tool's device ------------------------------------------------------

TOOLS = {"crushtool": ["--build"], "osdmaptool": ["map.bin", "--print"],
         "rados_cli": ["ls"], "rbd_cli": ["ls"],
         "objectstore_tool": ["inspect", "x"], "ceph_cli": ["status"],
         "ceph_dencoder": ["list"], "thrash": ["--list-knobs"],
         "profile_diff": ["a.json", "b.json"],
         "make_corpus": ["--out", "corpus.json"]}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_without_a_device_raises_without_cuda(name, monkeypatch,
                                                   tmp_path):
    """No --device on a host without CUDA raises before any work: the
    tool neither falls back to the CPU nor writes a file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_tool(name).main(TOOLS[name])
    assert list(tmp_path.iterdir()) == []


def test_tool_pools_name_the_hand_kernel_on_the_card():
    """The tools' pools are the twin's clusters' defaults; on the card
    their `impl=bitlinear` (the twin's lowering; plain torch ops in the
    port) names the hand kernel, on the CPU it stays."""
    import inspect

    from ceph_tpu.osd.cluster import SimCluster as JSim
    from ceph_tpu.osd.standalone import StandaloneCluster as JSa
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.osd.cluster import SimCluster
    from ceph_tpu_torch.osd.standalone import StandaloneCluster
    from ceph_tpu_torch.tools import (SIM_PROFILE, STANDALONE_PROFILE,
                                      pool_profile)
    for cls, want in ((SimCluster, SIM_PROFILE), (JSim, SIM_PROFILE),
                      (StandaloneCluster, STANDALONE_PROFILE),
                      (JSa, STANDALONE_PROFILE)):
        assert inspect.signature(cls).parameters["profile"].default == want
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    for prof in (SIM_PROFILE, STANDALONE_PROFILE):
        assert pool_profile(cpu, prof) == prof
        assert factory(prof, device="cpu").impl == "bitlinear"
        assert factory(pool_profile(card, prof), device="cpu").impl == \
            "pallas"
