"""A run's result line, the command's refusals, the import check, and
correct=False under the control and under faults planted in the timed
path (CPU, tiny sizes)."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from ecbench import harness as H
from ecbench.tests.helpers import CELLS, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    out = run_tiny(cell, trace=trace)
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in H.metrics_of(H.manifest(), cell, trace)}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(out["device"])
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "window_s" in out["device"] and "busy_s" in out["device"]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_same_seed_same_inputs():
    from ecbench.ops import data_block
    a = data_block(5, 3, 8, 64, torch.device("cpu"))
    b = data_block(5, 3, 8, 64, torch.device("cpu"))
    c = data_block(6, 3, 8, 64, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_the_command_refuses_without_a_card(no_card):
    p = subprocess.run([sys.executable, "-m", "ecbench.run", "--workload",
                        "rs-write", "--seed", str(2**31 + 5), "--seconds",
                        "1", "--trace", "0"], cwd=H.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_command_fails_in_a_bare_checkout(tmp_path):
    shutil.copytree(H.HERE, tmp_path / "ecbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(H.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "ecbench.run", "--workload",
                        "rs-write", "--seed", "7", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_no_jax():
    code = ("import torch\n"
            "from ecbench import harness as H\n"
            "from ecbench.tests.helpers import run_tiny\n"
            "for cell in ('rs-write', 'clay-repair'):\n"
            "    assert run_tiny(cell, trace=True)['correct']\n"
            "print(H.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole(monkeypatch):
    for name in ("ceph_tpu_torch", "ceph_tpu_torch.osd", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(H.forbidden_modules()) & {"ceph_tpu_torch", "jaxtyping"}
    monkeypatch.setitem(sys.modules, "ceph_tpu.osd", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"ceph_tpu", "jaxlib"} <= set(H.forbidden_modules())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    out = run_tiny(cell, adjust=lambda op: op.use_control())
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def _stale(entry):
    first = []

    def fn(*args):
        outs = entry(*args)
        if not first:
            first.append(outs)
        return first[0]
    return fn


def _half(entry):
    def fn(*args):
        outs = [o.clone() for o in entry(*args)]
        for o in outs:
            o[o.shape[0] // 2:] = 0
        return tuple(outs)
    return fn


def _altered(entry):
    def fn(*args):
        outs = [o.clone() for o in entry(*args)]
        if len(outs) == 3:      # recovery: a byte of a verified object
            good = outs[2].nonzero().flatten()
            outs[0][int(good[0]), 0, 0] ^= 1
        else:                   # write: a parity byte
            outs[0][-1, -1, -1] ^= 1
        return tuple(outs)
    return fn


FAULTS = {"state_unchanged": _stale, "half_the_batch": _half,
          "answer_altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_timed_path_fails(cell, fault):
    def adjust(op):
        op.entry = FAULTS[fault](op.entry)
    # one warm op: the window's first op, always in the sample, is of
    # the other slice of the pool than the warm op a stale state repeats
    out = run_tiny(cell, adjust=adjust, mix={"warm_ops": 1})
    assert not out["correct"], out["checks"]
