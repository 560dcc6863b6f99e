"""The port's operator tools: Ceph's CLIs over ceph_tpu_torch.

Twins of the JAX package's root `tools/` (crushtool, osdmaptool, rados,
rbd, ceph, ceph-objectstore-tool, ceph-dencoder, the thrash reproducer,
profile_diff and make_corpus), each run as

    python -m ceph_tpu_torch.tools.<name> [--device DEV] ...

A twin keeps its tool's arguments, subcommands, output text, JSON keys,
exit codes and file formats, and adds one flag, `--device`, resolved as
every entry point of the port resolves it: absent, the tool runs on the
CUDA device and raises where there is none; `--device cpu` runs it on
the CPU (the kernels' plain versions). Every tool resolves it first,
before any other work.

The clusters of the JAX tools name `impl=bitlinear`, the twin's own
lowering of the GF apply; in the port that name is plain torch ops. So
on the card a tool's pool names `impl=pallas`, the hand kernel
(gf_apply), instead (`pool_profile`); on the CPU it keeps the twin's
string, and with it every file that records the profile stays the
twin's byte for byte. Both give the same parity.
"""

from __future__ import annotations

import argparse

import torch

from ..ec.interface import resolve_device


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device the tool runs on (default: the "
                         "CUDA device; raises without one); cpu runs "
                         "the kernels' plain versions")


def _device(args) -> torch.device:
    """The tool's device from its parsed `--device`."""
    return resolve_device(args.device)


# the default profiles of SimCluster and StandaloneCluster: the pools of
# the JAX tools' clusters
SIM_PROFILE = "plugin=tpu_rs k=4 m=2 impl=bitlinear"
STANDALONE_PROFILE = "plugin=tpu_rs k=2 m=1 impl=bitlinear"


def pool_profile(device: torch.device, profile: str = SIM_PROFILE) -> str:
    """The EC profile a tool's cluster is built with on `device`: the
    twin's, with `impl=bitlinear` naming the hand kernel on the card."""
    if device.type == "cuda":
        return profile.replace("impl=bitlinear", "impl=pallas")
    return profile
