"""The port's map and wire-type tools held to their JAX twins on the CPU.

`ceph_tpu_torch.tools.{ceph_dencoder,crushtool,osdmaptool}` against
`tools/{ceph_dencoder,crushtool,osdmaptool}.py`: the same arguments
through both packages (the port's with `--device cpu`), each run in a
directory of its own with relative paths, so stdout, exit codes and
every written file compare byte for byte. Only the host-clock fields
(`torch_tools_helpers.CLOCK_FIELDS`: seconds, mappings_per_s,
candidates_per_s) are dropped. A file written by one package's tool is
read by the other's.
"""

import json
import shutil

import pytest

from torch_tools_helpers import drop_clock, port_tool, run, twin_tool

CPU = ["--device", "cpu"]


def both(name, argv, tmp_path, monkeypatch, port_extra=CPU):
    """Run `argv` through the twin in tmp/twin and the port in
    tmp/port; return {"twin": (rc, out, err), "port": ...}."""
    res = {}
    for pkg, mod, extra in (("twin", twin_tool(name), []),
                            ("port", port_tool(name), port_extra)):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        res[pkg] = run(mod, argv + extra)
    return res


def same(res, clock=False):
    """Exit codes and stdout equal (less the clock fields if asked), and
    an error's message too (argparse's usage lines name --device)."""
    t, p = res["twin"], res["port"]
    assert t[0] == p[0], (t, p)
    if t[0] and "usage:" not in t[2]:
        assert t[2] == p[2]
    if clock:
        assert drop_clock(t[1]) == drop_clock(p[1])
    else:
        assert t[1] == p[1]
    return p


# -- ceph-dencoder ------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [], ["list"], ["roundtrip"], ["roundtrip", "all"], ["roundtrip", "OSDMap"],
    ["dump", "CrushMap"], ["dump", "OSDMap"], ["dump", "PGLog"],
    ["dump", "HashInfo"], ["dump", "Transaction"], ["dump", "Message"],
    ["dump", "MOSDFailure"], ["dump", "all"], ["roundtrip", "Nope"],
    ["frobnicate", "PGLog"]],
    ids=lambda a: "-".join(a) or "none")
def test_dencoder_prints_the_twins(argv, tmp_path, monkeypatch):
    p = same(both("ceph_dencoder", argv, tmp_path, monkeypatch))
    if argv[:2] == ["roundtrip", "all"]:
        assert p[1].decode().count("OK ") == 7


@pytest.mark.parametrize("name", list(twin_tool("ceph_dencoder").TYPES))
def test_dencoder_instances_encode_to_the_twins_bytes(name):
    """The same instance encodes to the same bytes in both packages, and
    each package decodes the other's bytes back to them."""
    J = twin_tool("ceph_dencoder").TYPES[name]
    T = port_tool("ceph_dencoder").TYPES[name]
    jb = J["enc"](J["make"]())
    tb = T["enc"](T["make"]("cpu"))
    assert tb == jb
    assert T["enc"](T["dec"](jb, "cpu")) == jb
    assert J["enc"](J["dec"](tb)) == tb


# -- crushtool ----------------------------------------------------------------

MAP = ["--build", "--num-osds", "64", "--osds-per-host", "4",
       "--hosts-per-rack", "4"]


def test_crushtool_test_prints_the_twins_mappings_and_stats(
        tmp_path, monkeypatch):
    # the vector mapper at --max-x 4096, with out and reweighted OSDs
    argv = MAP + ["--test", "--rule", "ec", "--num-rep", "6", "--max-x",
                  "4096", "--mark-out", "0,17", "--reweight", "3:0.5,9:0",
                  "--show-mappings", "20", "--json"]
    p = same(both("crushtool", argv, tmp_path, monkeypatch), clock=True)
    lines = p[1].decode().splitlines()
    assert len(lines) == 21 and lines[0].startswith("CRUSH rule 1 x 0 [")
    stats = json.loads(lines[-1])
    assert stats["inputs"] == 4096 and 0.99 < stats["fill"] <= 1.0
    # the port's vector mapper agrees with its scalar oracle
    rc, out, _ = run(port_tool("crushtool"), argv[:-1] + ["--max-x", "20",
                                                          "--oracle"] + CPU)
    assert rc == 0 and out.decode().splitlines()[:20] == lines[:20]


@pytest.mark.parametrize("argv", [
    ["--rule", "replicated", "--num-rep", "3", "--max-x", "300",
     "--show-mappings", "4"],
    ["--rule", "ec", "--num-rep", "6", "--min-x", "100", "--max-x", "260",
     "--mark-out", "5", "--no-show-statistics", "--show-mappings", "3"]],
    ids=["replicated", "ec-no-stats"])
def test_crushtool_oracle_prints_the_twins(argv, tmp_path, monkeypatch):
    same(both("crushtool", MAP + ["--test", "--oracle"] + argv, tmp_path,
              monkeypatch), clock=True)


def test_crushtool_map_files_cross_packages(tmp_path, monkeypatch):
    """-o, -d and -c through both packages; each decompiles and compiles
    the other's files, and every file is the twin's byte for byte."""
    same(both("crushtool", MAP + ["-o", "map.bin"], tmp_path, monkeypatch))
    same(both("crushtool", MAP, tmp_path, monkeypatch))
    twin, port = tmp_path / "twin", tmp_path / "port"
    assert (twin / "map.bin").read_bytes() == (port / "map.bin").read_bytes()
    # each package decompiles the OTHER's binary map
    shutil.copy(twin / "map.bin", port / "other.bin")
    shutil.copy(port / "map.bin", twin / "other.bin")
    same(both("crushtool", ["-d", "other.bin", "-o", "map.txt"], tmp_path,
              monkeypatch))
    p = same(both("crushtool", ["-d", "other.bin"], tmp_path, monkeypatch))
    assert p[1] == (port / "map.txt").read_bytes()
    assert (twin / "map.txt").read_bytes() == (port / "map.txt").read_bytes()
    same(both("crushtool", ["-c", "map.txt", "-o", "map2.bin"], tmp_path,
              monkeypatch))
    same(both("crushtool", ["-c", "map.txt"], tmp_path, monkeypatch))
    for d in (twin, port):
        assert (d / "map2.bin").read_bytes() == (twin / "map.bin").read_bytes()
    # a compiled map refuses an unknown rule id
    same(both("crushtool", ["-c", "map.txt", "--test", "--rule-id", "7"],
              tmp_path, monkeypatch))
    # not a map, not a text map
    for d in (twin, port):
        (d / "junk").write_bytes(b"\x00junk")
    r = both("crushtool", ["-d", "junk"], tmp_path, monkeypatch)
    assert r["twin"][0] == r["port"][0] == 1
    assert r["twin"][2] == r["port"][2]
    same(both("crushtool", ["--test"], tmp_path, monkeypatch))


# -- osdmaptool ---------------------------------------------------------------

CREATE = ["--createsimple", "64", "--pool-pgs", "256"]


def test_osdmaptool_files_and_output_are_the_twins(tmp_path, monkeypatch):
    same(both("osdmaptool", ["map.bin"] + CREATE, tmp_path, monkeypatch))
    twin, port = tmp_path / "twin", tmp_path / "port"
    assert (twin / "map.bin").read_bytes() == (port / "map.bin").read_bytes()
    # each package reads the OTHER's map
    shutil.copy(twin / "map.bin", port / "other.bin")
    shutil.copy(port / "map.bin", twin / "other.bin")
    p = same(both("osdmaptool", ["other.bin", "--print", "--test-map-pgs"],
                  tmp_path, monkeypatch))
    assert b" avg 12.00 " in p[1]
    # the batch balancer (the scorer kernel's plain version here)
    p = same(both("osdmaptool", ["other.bin", "--upmap", "up.txt", "--save"],
                  tmp_path, monkeypatch), clock=True)
    assert b"converged=True" in p[1]
    for f in ("up.txt", "other.bin"):
        assert (twin / f).read_bytes() == (port / f).read_bytes(), f
    assert (port / "up.txt").read_text().startswith(
        "ceph osd pg-upmap-items 1.")
    # the saved map, upmaps and all, prints alike in both
    same(both("osdmaptool", ["other.bin", "--print"], tmp_path, monkeypatch))
    # the scalar balancer on a fresh copy, a movement budget in batch mode
    for d in (twin, port):
        shutil.copy(d / "map.bin", d / "s.bin")
    same(both("osdmaptool", ["s.bin", "--upmap", "s.txt", "--upmap-mode",
                             "scalar", "--upmap-max", "10", "--save"],
              tmp_path, monkeypatch))
    for d in (twin, port):
        shutil.copy(d / "map.bin", d / "b.bin")
    same(both("osdmaptool", ["b.bin", "--upmap", "b.txt", "--upmap-budget",
                             "6"], tmp_path, monkeypatch), clock=True)
    for f in ("s.txt", "s.bin", "b.txt"):
        assert (twin / f).read_bytes() == (port / f).read_bytes(), f


@pytest.mark.parametrize("argv", [
    ["map.bin"], ["map.bin", "--test-map-pgs", "--pool", "9"],
    ["map.bin", "--upmap", "u.txt", "--pool", "9"], ["junk.bin", "--print"],
    ["missing.bin", "--print"]],
    ids=["nothing-to-do", "no-pool", "upmap-no-pool", "not-a-map", "missing"])
def test_osdmaptool_errors_are_the_twins(argv, tmp_path, monkeypatch):
    for pkg in ("twin", "port"):
        d = tmp_path / pkg
        d.mkdir()
        (d / "junk.bin").write_bytes(b"\x07 not a map")
    same(both("osdmaptool", ["map.bin", "--createsimple", "8", "--pool-pgs",
                             "16", "--osds-per-host", "2"], tmp_path,
              monkeypatch))
    if argv[0] == "missing.bin":
        with pytest.raises(FileNotFoundError):
            run(twin_tool("osdmaptool"), argv)
        with pytest.raises(FileNotFoundError):
            run(port_tool("osdmaptool"), argv + CPU)
        return
    r = both("osdmaptool", argv, tmp_path, monkeypatch)
    assert r["twin"][0] == r["port"][0] != 0
    assert r["twin"][2] == r["port"][2]
