"""Non-regression for the port: its codecs reproduce the pinned corpus.

The port's half of tests/test_non_regression.py: every entry of
tests/corpus/corpus.json (technique, k, m, matrix, data and parity
digests, the parity's first bytes) through the port's own tables,
matrices, numpy reference, gf_apply (its plain version here, the code
the CUDA kernel is held to on the card) and coders built by the
registry from a profile, on the CPU. `ceph_tpu_torch.tools.make_corpus
--out` rewrites the file byte for byte (tests/test_torch_tools_cli.py).
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec.matrices import coding_matrix
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.gf.numpy_ref import encode_ref
from ceph_tpu_torch.gf.tables import GF_EXP
from ceph_tpu_torch.ops.gf_kernel import apply_matrix_gf

CORPUS = os.path.join(os.path.dirname(__file__), "corpus", "corpus.json")

with open(CORPUS) as f:
    _C = json.load(f)

IDS = [f"{e['technique']}-k{e['k']}m{e['m']}" for e in _C["entries"]]


def _data_for(e):
    rng = np.random.default_rng(0xCE9 + e["k"] * 16 + e["m"])
    return rng.integers(0, 256, size=(1, e["k"], 512), dtype=np.uint8)


def _profile(e):
    """The registry profile whose coder uses the entry's matrix."""
    tech = e["technique"]
    if tech.startswith("isa_"):
        tech = {"isa_reed_sol_van": "reed_sol_van",
                "isa_cauchy": "cauchy"}[tech]
        return f"plugin=isa technique={tech} k={e['k']} m={e['m']}"
    return f"plugin=jerasure technique={tech} k={e['k']} m={e['m']}"


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_gf_tables_pinned():
    assert _sha(GF_EXP) == _C["gf_exp_sha256"]
    assert _C["prim_poly"] == 0x11D


@pytest.mark.parametrize("entry", _C["entries"], ids=IDS)
def test_matrix_pinned(entry):
    mat = coding_matrix(entry["technique"], entry["k"], entry["m"])
    assert mat.tolist() == entry["matrix"]


@pytest.mark.parametrize("entry", _C["entries"], ids=IDS)
def test_parity_bytes_pinned(entry):
    data = _data_for(entry)
    assert _sha(data) == entry["data_sha256"]
    mat = np.array(entry["matrix"], dtype=np.uint8)
    ref = encode_ref(mat, data)
    assert _sha(ref) == entry["parity_sha256"]
    assert ref[0, :, :16].tolist() == entry["parity_head"]
    got = apply_matrix_gf(mat, torch.from_numpy(data)).numpy()
    assert _sha(got) == entry["parity_sha256"]


@pytest.mark.parametrize("entry", _C["entries"], ids=IDS)
def test_registry_coder_reproduces_the_pinned_parity(entry):
    coder = factory(_profile(entry), device="cpu")
    assert coder.matrix.tolist() == entry["matrix"]
    parity = coder.encode_chunks(torch.from_numpy(_data_for(entry)))
    assert parity.device == torch.device("cpu")
    assert _sha(parity.numpy()) == entry["parity_sha256"]
