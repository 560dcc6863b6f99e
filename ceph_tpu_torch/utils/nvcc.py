"""Build a hand-written source of the port into a shared library.

Each CUDA kernel source (`ops/csrc/gf_apply.cu`, `csum/csrc/csum.cu`,
`mgr/csrc/placement.cu`) has a plain C interface and is loaded with
ctypes. `build` compiles it with nvcc for sm_90a into `BUILD_DIR`, once
per content of source and flags (the library's name carries their
hash), and returns the library's path. The host C++ library
(`native/ec_tpu.cpp`, the `native` package) is built the same way with
g++ (`find_host`, `HOST_FLAGS`). Nothing here runs when a module is
imported: a wrapper builds at its first call, so the port imports
without a compiler.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")
# native/Makefile's CXXFLAGS, plus -shared as its library rule adds
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")


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


def find_host() -> str:
    """The C++ compiler for host libraries: g++ on PATH. Raises when
    there is none."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: put g++ on PATH to build the "
                           "port's native host library")
    return gxx


def library_path(src: Path, build_dir: Path = BUILD_DIR,
                 flags: tuple = FLAGS) -> Path:
    """Where `build` puts the library of `src` built with `flags`:
    `build_dir`/lib<stem>_<hash of source and flags>.so."""
    src = Path(src)
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return build_dir / f"lib{src.stem}_{tag.hexdigest()[:16]}.so"


def build(src: Path, build_dir: Path = BUILD_DIR, compiler=find,
          flags: tuple = FLAGS, force: bool = False,
          label: str = "nvcc") -> Path:
    """Compile `src` with `flags` into `library_path` unless that library
    exists (or `force`), and return its path.
    `compiler()` names the compiler; it is asked only when a build is
    due. The library is written under a temporary name and moved into
    place, so processes that build at once never see half a file.
    Raises on a failed build and leaves no library behind.
    A build holds an exclusive lock on `out`'s `.lock` file (removed
    when it ends), so that processes that need one library at once (the
    ranks of a mesh) run one compiler between them: the others wait and
    find the library. The lock goes with its holder's process."""
    src = Path(src)
    out = library_path(src, build_dir, flags)
    if out.exists() and not force:
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    lock_path = out.with_suffix(".lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists() and not force:
                return out
            cc = compiler()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cc, *flags, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{label} failed on {src.name} "
                                   f"(rc={proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            lock_path.unlink(missing_ok=True)
    return out
