"""The port stands alone: importing any ceph_tpu_torch module loads
neither jax nor anything of ceph_tpu, builds no kernel, and its entry
points run on the CUDA device unless the caller asks for the CPU."""

import json
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import ceph_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    names = ["ceph_tpu_torch"]
    for info in pkgutil.walk_packages(ceph_tpu_torch.__path__,
                                      "ceph_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for name in ("gf.tables", "gf.numpy_ref", "ec.matrices", "csum.reference",
                 "ops.gf_kernel", "ops.rs_kernels", "csum.kernels",
                 "ec.interface", "ec.linearize", "ec.registry", "ec.rs",
                 "ops.xor_kernels", "ec.bitmatrix", "osd.ecbackend",
                 "utils.perf_counters", "utils.profiler",
                 "utils.flight_recorder", "utils.tracing", "utils.encoding",
                 "mgr.tracing", "osd.memstore", "osd.pglog", "osd.stripe",
                 "osd.repairplan", "osd.pgbackend", "crush.hash",
                 "crush.ln48", "crush.map", "crush.oracle", "crush.mapper",
                 "osd.osdmap", "utils.log", "utils.config",
                 "utils.op_tracker", "mon.monitor", "osd.peering",
                 "osd.scheduler", "osd.objclass", "mgr.pg_autoscaler",
                 "osd.cluster", "ec.lrc", "ec.clay", "ec.shec",
                 "csum.checksummer", "ops.streaming", "utils.nvcc",
                 "crush.compiler", "mgr.balancer", "mgr.placement", "kv",
                 "kv.interface", "kv.tindb", "osd.tinstore", "native",
                 "utils.throttle", "client", "client.objecter",
                 "client.rados", "client.rbd", "fs", "fs.client", "rgw",
                 "rgw.gateway", "rgw.auth", "parallel", "parallel.mesh",
                 "parallel.distributed", "utils.admin_socket", "auth",
                 "auth.aead", "auth.cephx", "mgr.reports", "mgr.health",
                 "mgr.telemetry", "mgr.profiles", "mgr.netobs",
                 "osd.repairpolicy", "osd.pg_export", "msgr",
                 "msgr.messenger", "osd.standalone"):
        assert f"ceph_tpu_torch.{name}" in mods, name


def test_importing_the_port_loads_no_jax_and_no_ceph_tpu(tmp_path):
    code = (
        "import importlib, json, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'ceph_tpu' or m.startswith('ceph_tpu.'))\n"
        "print(json.dumps(bad))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_factory_without_device_raises_when_cuda_is_absent(monkeypatch):
    from ceph_tpu_torch.ec.registry import factory
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        factory("plugin=jerasure technique=reed_sol_van k=8 m=3")
    from ceph_tpu_torch.ec.rs import ReedSolomon
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReedSolomon({"k": "4", "m": "2"})
    assert factory("k=8 m=3", device="cpu").device == torch.device("cpu")
    for prof in ("plugin=lrc k=8 m=4 l=4", "plugin=clay k=8 m=4 d=11",
                 "plugin=shec k=4 m=3 c=2"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            factory(prof)
        coder = factory(prof, device="cpu")
        assert coder.device == torch.device("cpu")
        assert coder.impl == "pallas"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    # the smoke test must fail, printing no result, where there is no GPU
    # or where it stands alone without the package beside it
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    runs = [(lone, tmp_path)]
    if not torch.cuda.is_available():
        runs.append((ROOT / "chip_smoke.py", ROOT))
    for script, cwd in runs:
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
