"""ceph_tpu_torch — the PyTorch/CUDA port of ceph_tpu.

A second package beside `ceph_tpu` (the JAX reference, which stays as it
is). Module paths mirror the twin (`ceph_tpu/x/y.py` ->
`ceph_tpu_torch/x/y.py`); public signatures, dtypes and layouts are the
twin's: stripes are (B, k, L) uint8 tensors, CRCs (B,) uint32 in the raw
`ceph_crc32c(seed, ·)` convention. It imports torch and numpy, never jax
and nothing of `ceph_tpu`. Entry points run on the CUDA device unless the
caller passes `device="cpu"`; the hand-written kernels under `ops/csrc/`
are built with nvcc on first use.
"""

__version__ = "0.1.0"
