"""XOR fold of a tensor along one dimension: the hand-written Hopper
kernel and its plain PyTorch version.

`ops/rs_kernels.py::xor_reduce(t, dim)` routes here. Its main caller is
the recovery program (`osd/ecbackend.py::_build_recover_program`), which
folds the (B, H, rl) helper stack into (B, rl) before the CRC checks
it; `apply_matrix_traced` folds its (..., m, k, L) products along k.

- On a CUDA tensor `xor_fold` launches `csrc/xor_fold.cu` (sm_90a),
  built with nvcc on first use into `ceph_tpu_torch/_build/` and loaded
  with ctypes (utils/nvcc.py). The tensor is viewed as (outer, H,
  inner), which asks that the dimensions after `dim` be contiguous and
  those before it merge into one stride; the kernel writes a fresh
  contiguous (outer, inner) output. A tensor that does not view so, a
  dtype other than uint8, a build or a launch failure raises; nothing
  falls back. Each launch counts in `xor_fold.launches`.
- On any other tensor `xor_fold_plain` runs: the first row cloned, then
  one `^=` a further row.

The design note and the bound on the H100 are in the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from pathlib import Path

import torch

from ..utils import nvcc

_SRC = Path(__file__).resolve().parent / "csrc" / "xor_fold.cu"
BUILD_DIR = nvcc.BUILD_DIR
_nvcc = nvcc.find

_lib = None
_lib_lock = threading.Lock()


def build() -> Path:
    """Compile xor_fold.cu into BUILD_DIR (once per source content) and
    return the shared library's path. Raises on a failed build."""
    return nvcc.build(_SRC, BUILD_DIR, _nvcc)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.xor_fold
            P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            fn.argtypes = [P, P, LL, I, LL, LL, LL, I, I, I, P]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _out_shape(t: torch.Tensor, dim: int) -> list:
    shape = list(t.shape)
    del shape[dim]
    return shape


def fold_view(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` as (outer, H, inner) without a copy: H = t.shape[dim], outer
    the product of the dimensions before it, inner of those after. Raises
    ValueError where the dimensions after `dim` are not contiguous or
    those before it do not merge into one stride."""
    dim = dim % t.ndim
    outer, H = math.prod(t.shape[:dim]), t.shape[dim]
    try:
        x = t.view(outer, H, math.prod(t.shape[dim + 1:]))
    except RuntimeError:
        x = None
    if x is None or (x.shape[2] > 1 and x.numel() and x.stride(2) != 1):
        raise ValueError(
            f"xor_fold takes dimensions after dim {dim} that are "
            f"contiguous and dimensions before it that merge into one "
            f"stride; got shape {tuple(t.shape)} strides {t.stride()}")
    return x


def place_bytes(ptr: int, batch_stride: int, row_stride: int,
                inner: int, out_ptr: int) -> int:
    """Bytes of the place one kernel thread folds: 16 where the input's
    and the output's addresses, both strides and `inner` are multiples
    of 16, else 1."""
    grid = ptr | out_ptr | batch_stride | row_stride | inner
    return 16 if grid % 16 == 0 else 1


def xor_fold_plain(t: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of `t` along `dim` in torch ops (torch has no XOR reduce):
    the first row cloned, then `^=` each further row; zeros for an empty
    `dim`."""
    parts = t.unbind(dim)
    if not parts:
        return torch.zeros(_out_shape(t, dim), dtype=t.dtype,
                           device=t.device)
    acc = parts[0].clone()
    for p in parts[1:]:
        acc ^= p
    return acc


def xor_fold(t: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of the uint8 CUDA tensor `t` along `dim`: one launch of the
    hand kernel on the current stream of `t`'s device, counted in
    `xor_fold.launches` (none for an empty result or an empty `dim`,
    which gives zeros). The recovery program's host time an op runs
    through here, so the wrapper asks torch for little: the raw stream
    handle, and no device guard (the C entry makes `t`'s device current
    for the launch where another is)."""
    if t.device.type != "cuda":
        raise ValueError(f"xor_fold runs on cuda tensors, got {t.device}")
    if t.dtype != torch.uint8:
        raise ValueError(f"xor_fold takes uint8, got {t.dtype}")
    x = fold_view(t, dim)
    outer, H, inner = x.shape
    index = t.get_device()
    out = torch.empty(_out_shape(t, dim % t.ndim), dtype=torch.uint8,
                      device=t.device)
    if outer == 0 or inner == 0:
        return out
    if H == 0:
        return out.zero_()
    bs, rs, _ = x.stride()
    ptr, optr = x.data_ptr(), out.data_ptr()
    pb = place_bytes(ptr, bs, rs, inner, optr)
    rc = (_lib or _load()).xor_fold(
        ptr, optr, outer, H, inner, bs, rs, pb, index, _sms(index),
        torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"xor_fold launch failed: cudaError {rc} "
                           f"(outer={outer} H={H} inner={inner} "
                           f"strides=({bs}, {rs}) place={pb})")
    xor_fold.launches += 1
    return out


xor_fold.launches = 0
