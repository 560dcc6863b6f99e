"""Full-object writes: parity and the hinfo CRC32C of every shard.

Each op hands `batch` objects of the device pool to the port's write
path (`ops.port_write`: the fused RS program, or the coder's encode and
one CRC launch). The check recomputes each sampled op's parity and its
k+m raw CRCs (seed 0xFFFFFFFF) with the plain reference, from data made
again from the seed.
"""

from __future__ import annotations

import functools

import torch

from ecbench.ops import GEN_OBJECTS, data_block, mismatches, \
    objects_data, port_write, profile_of
from ecbench.reference import codes, crc, gf


def reference_code(config: dict):
    """(kind, code) from the configuration's profile: ("rs", (m, k)
    matrix) or ("clay", Clay)."""
    p = config["profile"]
    return _code(p["plugin"], p.get("technique", "reed_sol_van"),
                 int(p["k"]), int(p["m"]), int(p.get("d", 0)))


@functools.lru_cache(maxsize=8)
def _code(plugin: str, technique: str, k: int, m: int, d: int):
    if plugin == "clay":
        return "clay", codes.Clay(k, m, d)
    if technique != "reed_sol_van":
        raise ValueError(f"no reference for technique {technique}")
    return "rs", codes.rs_matrix(k, m)


def reference_parity(config: dict, data: torch.Tensor) -> torch.Tensor:
    """(B, k, L) data -> (B, m, L) parity by the plain reference."""
    kind, code = reference_code(config)
    if kind == "rs":
        return gf.apply(code, data)
    B, k, L = data.shape
    P = code.planes
    sub = data.reshape(B, k * P, L // P)
    return gf.apply(code.encode_matrix(), sub).reshape(B, code.m, L)


class Op:
    kind = "write"

    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        from ceph_tpu_torch.ec.registry import factory

        self.config, self.seed, self.device = config, seed, device
        self.coder = factory(profile_of(config), device=device)
        self.k, self.m = self.coder.k, self.coder.m
        self.sl = config["chunk_bytes"]
        if self.sl * self.k != config["object_bytes"]:
            raise ValueError("object_bytes must be k * chunk_bytes")
        self.batch = mix["batch"]
        pool = mix["pool_objects"]
        if pool % self.batch:
            raise ValueError("pool_objects must be a multiple of batch")
        self.slices = pool // self.batch
        self.objects_per_op = self.batch
        self.client_bytes_per_op = self.batch * config["object_bytes"]
        self.pool = torch.empty((pool, self.k, self.sl), dtype=torch.uint8,
                                device=device)
        for b in range(-(-pool // GEN_OBJECTS)):
            part = self.pool[b * GEN_OBJECTS:(b + 1) * GEN_OBJECTS]
            part.copy_(data_block(seed, b, self.k, self.sl,
                                  device)[:part.shape[0]])
        self.entry = port_write(self.coder, self.batch, self.sl, device)

    def objects(self, i: int) -> range:
        s = i % self.slices
        return range(s * self.batch, (s + 1) * self.batch)

    def inputs(self, i: int) -> tuple:
        r = self.objects(i)
        return (self.pool[r.start:r.stop],)

    def use_control(self) -> None:
        """The control: the plain reference in the port's place, with the
        parity rows left out of the hinfo CRCs (reported as 0), which
        breaks the guarantee that every shard's CRC is kept."""
        def control(d: torch.Tensor):
            parity = reference_parity(self.config, d)
            B = d.shape[0]
            c = torch.zeros((B, self.k + self.m), dtype=torch.int64,
                            device=d.device)
            c[:, :self.k] = crc.crc32c_raw(d.reshape(-1, self.sl)) \
                .reshape(B, self.k)
            return parity, c
        self.entry = control

    def free(self) -> None:
        del self.pool

    def gf_matrices(self) -> list:
        """The GF matrices the window's gf_apply launches apply, by the
        reference: (launch batch, matrix)."""
        kind, code = reference_code(self.config)
        return [(self.batch, code if kind == "rs"
                 else code.encode_matrix())]

    def check(self, samples) -> dict:
        """Mismatches over the sampled ops [(op index, outputs)]."""
        wrong = {"parity_bytes_wrong": 0, "hinfo_crc_wrong": 0}
        for i, (parity, crcs) in samples:
            d = objects_data(self.seed, self.objects(i), self.k, self.sl,
                             self.device)
            ref = reference_parity(self.config, d)
            rows = torch.cat([d, ref], dim=1).reshape(-1, self.sl)
            ref_crc = crc.crc32c_raw(rows).reshape(len(d), -1)
            wrong["parity_bytes_wrong"] += mismatches(parity, ref)
            wrong["hinfo_crc_wrong"] += mismatches(crcs, ref_crc)
            del d, ref, rows
        return {name: (v, 0) for name, v in wrong.items()}
