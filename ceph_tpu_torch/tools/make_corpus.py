"""Generate the non-regression corpus: pin codec output bytes forever.

Rebuild of the reference's ceph_erasure_code_non_regression harness
(ref: src/test/erasure-code/ceph_erasure_code_non_regression.cc —
SURVEY.md §4): deterministic input, encode, store content digests; any
future change to matrices, tables, or kernels that alters one output
byte fails tests/test_non_regression.py and
tests/test_torch_non_regression.py.

A copy of the JAX package's tools/make_corpus.py over the port: the
parity comes from the port's gf_apply on --device (the hand kernel on
the CUDA device, its plain version with --device cpu), and the file it
writes is the twin's, byte for byte.

Run: python -m ceph_tpu_torch.tools.make_corpus [--out PATH]
     (default: tests/corpus/corpus.json of the checkout)
"""

import argparse
import hashlib
import json
import os

import numpy as np
import torch

from ..ec.matrices import coding_matrix
from ..gf.tables import GF_EXP
from ..ops.gf_kernel import apply_matrix_gf
from . import _device, add_device_flag

CONFIGS = [
    ("reed_sol_van", 4, 2),
    ("reed_sol_van", 8, 3),
    ("reed_sol_van", 8, 4),
    ("cauchy_orig", 4, 2),
    ("cauchy_orig", 8, 3),
    ("cauchy_good", 8, 3),
    ("cauchy_good", 8, 4),
    ("reed_sol_r6_op", 8, 2),
    ("isa_reed_sol_van", 4, 2),
    ("isa_reed_sol_van", 8, 3),
    ("isa_cauchy", 4, 2),
    ("isa_cauchy", 8, 3),
]

CHUNK = 512
SEED = 0xCE9

DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "corpus", "corpus.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="corpus file to write (default: "
                         "tests/corpus/corpus.json of the checkout)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = _device(args)
    out = {
        "comment": "Pinned codec bytes. Regenerating must be a deliberate, "
                   "reviewed act: it redefines the on-disk stripe format.",
        "prim_poly": 0x11D,
        "gf_exp_sha256": hashlib.sha256(GF_EXP.tobytes()).hexdigest(),
        "entries": [],
    }
    for tech, k, m in CONFIGS:
        mat = coding_matrix(tech, k, m)
        rng = np.random.default_rng(SEED + k * 16 + m)
        data = rng.integers(0, 256, size=(1, k, CHUNK), dtype=np.uint8)
        parity = apply_matrix_gf(
            mat, torch.from_numpy(data).to(device)).cpu().numpy()
        out["entries"].append({
            "technique": tech, "k": k, "m": m,
            "matrix": mat.tolist(),
            "data_sha256": hashlib.sha256(data.tobytes()).hexdigest(),
            "parity_sha256": hashlib.sha256(parity.tobytes()).hexdigest(),
            "parity_head": parity[0, :, :16].tolist(),
        })
    path = args.out
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}: {len(out['entries'])} entries")


if __name__ == "__main__":
    main()
