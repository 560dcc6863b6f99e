"""Op kinds: what one op of a traffic mix hands to the port.

A mix names its kind in "op"; the harness loads `ecbench/ops/<op>.py`
and builds its `Op(config, mix, seed, device)`. An op kind owns its
device pool (made from the seed in set-up), the entry of the port that
an op calls (`entry`, over `inputs(i)`), and the check of a sample of
the window's outputs against the plain reference (`check`). What is
shared between kinds is here: the seeded data, the port's write path,
and counting mismatches.
"""

from __future__ import annotations

import hashlib

import torch

GEN_OBJECTS = 32        # objects made by one generator call


def subseed(seed: int, tag: str, i: int = 0) -> int:
    """A 63-bit seed for one stream of the run's inputs."""
    h = hashlib.sha256(f"{seed}/{tag}/{i}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def data_block(seed: int, block: int, k: int, sl: int,
               device: torch.device) -> torch.Tensor:
    """Objects [32 block, 32 block + 32) of the run's data: (32, k, sl)
    uint8 made on `device` by its own generator, so that the reference
    can make any block again."""
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, "data", block))
    return torch.randint(0, 256, (GEN_OBJECTS, k, sl), generator=g,
                         dtype=torch.uint8, device=device)


def objects_data(seed: int, objects, k: int, sl: int,
                 device: torch.device) -> torch.Tensor:
    """(len(objects), k, sl): the data of the given objects."""
    blocks = {}
    rows = []
    for o in objects:
        b = o // GEN_OBJECTS
        if b not in blocks:
            blocks[b] = data_block(seed, b, k, sl, device)
        rows.append(blocks[b][o % GEN_OBJECTS])
    return torch.stack(rows)


def profile_of(config: dict) -> dict:
    return {key: str(v) for key, v in config["profile"].items()}


def port_write(coder, batch: int, sl: int, device: torch.device):
    """The port's full-object write of (batch, k, sl) data on the device:
    ((batch, m, sl) parity, (batch, k+m) raw hinfo CRCs in dense row
    order). As ECBackend chooses: the fused RS program for the RS coder,
    else the coder's encode on the device and, as the fused program
    takes them, the CRCs of the data and parity rows in one CRC32C
    launch over both row sets, nothing concatenated. (The port's
    generic write copies the parity to the host and takes the CRCs
    there; it has no device program to drive yet.)"""
    from ceph_tpu_torch.csum.kernels import CrcRows, crc32c_sets
    from ceph_tpu_torch.ec.rs import ReedSolomon
    from ceph_tpu_torch.osd.ecbackend import _fused_write_fn

    k, m = coder.k, coder.m
    if isinstance(coder, ReedSolomon):
        mat = coder.matrix.astype("uint8").tobytes()
        return _fused_write_fn(mat, m, k, coder.impl, sl, batch, device)

    def generic(d: torch.Tensor):
        B = d.shape[0]
        parity = coder.encode_chunks(d)
        crc = crc32c_sets([CrcRows(d.reshape(B * k, sl), 0xFFFFFFFF, 0),
                           CrcRows(parity.reshape(B * m, sl), 0xFFFFFFFF,
                                   0)])
        return parity, torch.cat([crc[:B * k].reshape(B, k),
                                  crc[B * k:].reshape(B, m)], dim=1)
    return generic


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements that differ (a shape that differs counts every one)."""
    if tuple(a.shape) != tuple(b.shape):
        return max(a.numel(), b.numel())
    return int((a.to(b.device) != b).sum())
