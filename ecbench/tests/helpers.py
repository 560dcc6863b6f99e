"""Tiny sizes for the CPU tests: the port's plain versions at chunks of
a few KiB, a pool of 8 objects in ops of 4, every op of the window kept
for the check."""

import torch

from ecbench import harness as H

CELLS = ["rs-write", "clay-repair", "rs-recover", "clay-write"]
SEED = 2**40 + 17

_MIX = {"pool_objects": 8, "batch": 4, "check_objects": 64, "warm_ops": 2}
TINY = {
    "rs-k8m3": {"config": {"object_bytes": 8 * 4096, "chunk_bytes": 4096},
                "mix": _MIX},
    "clay-k8m4d11": {"config": {"object_bytes": 8 * 64 * 16,
                                "chunk_bytes": 64 * 16},
                     "mix": _MIX},
}


def run_tiny(cell: str, seed: int = SEED, trace: bool = False,
             adjust=None, seconds: float = 0.4, root=H.ROOT,
             mix: dict | None = None) -> dict:
    c = H.cell(H.manifest(root), cell)
    tiny = TINY[c["config"]]
    over = {"config": tiny["config"], "mix": {**tiny["mix"], **(mix or {})}}
    return H.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                      root=root, adjust=adjust, overrides=over)
