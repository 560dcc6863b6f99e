"""The manifest against the contract's form, and a cell, mix,
configuration and metric added by new files and entries alone."""

import json
import re
import shutil

import pytest

from ecbench import harness as H
from ecbench.tests.helpers import TINY, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_manifest_keys_names_and_files():
    man = H.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["ecbench"]
    assert 1 <= man["run_seconds"] <= 51
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("ecbench/")
        assert (H.ROOT / c["file"]).exists()
        assert c["reduced"] == H.config(man, c["name"])["reduced"]
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
    names = [w["name"] for w in man["workloads"]]
    assert len(set(names)) == len(names)
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        H.mix(w["traffic"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        H.reader(m["name"])
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  H.manifest()["workloads"]])
def test_every_cell_reports_what_the_contract_asks(cell):
    man = H.manifest()
    e2e = {m["name"] for m in H.metrics_of(man, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = H.metrics_of(man, cell, True)
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e


def _checkout_with_additions(tmp_path):
    """A copy of the manifest and the configurations, with a new mix,
    configuration, metric and cell added as files and entries."""
    root = tmp_path / "checkout"
    (root / "ecbench").mkdir(parents=True)
    shutil.copytree(H.HERE / "configs", root / "ecbench" / "configs")
    shutil.copytree(H.HERE / "traffic", root / "ecbench" / "traffic")
    shutil.copytree(H.HERE / "ops", root / "ecbench" / "ops")
    (root / "ecbench" / "metrics").mkdir()
    for f in (H.HERE / "metrics").glob("*.py"):
        shutil.copy(f, root / "ecbench" / "metrics")
    man = H.manifest()
    mix = H.mix("write")
    mix["batch"] = 64
    (root / "ecbench" / "traffic" / "write64.json").write_text(
        json.dumps(mix))
    cfg = H.config(man, "rs-k8m3")
    cfg["name"] = "rs-k8m3-copy"
    (root / "ecbench" / "configs" / "rs-k8m3-copy.json").write_text(
        json.dumps(cfg))
    (root / "ecbench" / "metrics" / "ops_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.ops)\n")
    man["configs"].append({"name": "rs-k8m3-copy", "source": "a copy",
                           "file": "ecbench/configs/rs-k8m3-copy.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "added", "config": "rs-k8m3-copy",
                             "traffic": "write64", "chips": 1,
                             "why": "a test"})
    for m in man["end_to_end"]:
        if "workloads" in m and m["name"] == "write_GBps":
            m["workloads"].append("added")
    man["per_layer"].append({"name": "ops_in_window", "unit": "ops",
                             "better": "higher", "source": "host_clock",
                             "layer": "harness", "moves": "write_GBps",
                             "workloads": ["added"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def test_added_files_are_found_without_an_edit(tmp_path):
    root = _checkout_with_additions(tmp_path)
    man = H.manifest(root)
    assert H.cell(man, "added")["traffic"] == "write64"
    assert H.mix("write64", root)["batch"] == 64
    assert H.config(man, "rs-k8m3-copy", root)["k"] == 8
    names = [m["name"] for m in H.metrics_of(man, "added", True)]
    assert "ops_in_window" in names
    TINY["rs-k8m3-copy"] = TINY["rs-k8m3"]
    try:
        out = run_tiny("added", trace=True, root=root)
    finally:
        del TINY["rs-k8m3-copy"]
    assert out["correct"]
    assert out["metrics"]["ops_in_window"]["value"] >= 1
