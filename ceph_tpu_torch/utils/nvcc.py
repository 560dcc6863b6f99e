"""Build a hand-written CUDA source of the port into a shared library.

Each kernel source (`ops/csrc/gf_apply.cu`, `csum/csrc/csum.cu`) has a
plain C interface and is loaded with ctypes. `build` compiles it with
nvcc for sm_90a into `BUILD_DIR`, once per content of source and flags
(the library's name carries their hash), and returns the library's
path. Nothing here runs when a module is imported: a kernel's wrapper
builds at its first launch, so the port imports without a compiler.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")


def find() -> str:
    """The nvcc to build with: $CUDA_HOME/bin, $CUDA_PATH/bin, PATH, then
    /usr/local/cuda/bin. Raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def build(src: Path, build_dir: Path = BUILD_DIR, compiler=find) -> Path:
    """Compile `src` into `build_dir`/lib<stem>_<hash>.so unless that
    library exists, and return its path. `compiler()` names the nvcc; it
    is asked only when a build is due. Raises on a failed build and
    leaves no library behind."""
    src = Path(src)
    tag = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    out = build_dir / f"lib{src.stem}_{tag.hexdigest()[:16]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([compiler(), *FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(rc={proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out
