"""One lost shard rebuilt from its planned helpers, verify on.

Set-up writes the pool through the port's write path, as an OSD's
objects were written, and stages what recovery would receive: the
helpers' rows that `plan_repair` names (for a Clay single loss, only
their repair planes), the helpers' expected CRCs (the hinfo CRCs of
full rows; for shipped planes the CRC the source takes of the bytes it
ships), and the fold expectation the runner works out from them
(`_expected_fold_crcs`). Then one byte of one helper row per op slice
is flipped (seeded), as bit rot after the write: verification has to
flag exactly those objects.

Each op hands `batch` staged objects to the recovery program that
`RecoveryRunner` runs (`_build_recover_program` over the coder's
`batch_decoder`, or `range_batch_decoder` for shipped planes). The
check rebuilds each sampled op's expectation with the plain reference
from data made again from the seed: the verdict of every object (the
XOR of its shipped helper bytes against that of the clean rows, by
CRC), and, for the objects that verify, the lost shard's bytes and
their raw CRC.
"""

from __future__ import annotations

import random

import torch

from ecbench.ops import GEN_OBJECTS, data_block, mismatches, \
    objects_data, port_write, profile_of, subseed
from ecbench.ops.write import reference_code, reference_parity
from ecbench.reference import crc, gf


class Op:
    kind = "recover"

    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        from ceph_tpu_torch.csum.kernels import crc32c_blocks
        from ceph_tpu_torch.ec.registry import factory
        from ceph_tpu_torch.osd.ecbackend import (_build_recover_program,
                                                  _expected_fold_crcs)
        from ceph_tpu_torch.osd.repairplan import plan_repair

        self.config, self.mix, self.seed, self.device = \
            config, mix, seed, device
        coder = factory(profile_of(config), device=device)
        self.coder = coder
        k, n = coder.k, coder.k + coder.m
        self.k, self.sl = k, config["chunk_bytes"]
        self.lost = sorted(mix["lost"])
        plan = plan_repair(coder, self.lost,
                           [s for s in range(n) if s not in self.lost])
        self.helpers = list(plan.helpers)
        self.planes = None if plan.planes is None else list(plan.planes)
        if self.planes is None:
            dec, self.rl = coder.batch_decoder(self.lost, self.helpers), \
                self.sl
        else:
            dec = coder.range_batch_decoder(self.lost, self.helpers)
            self.rl = len(self.planes) * (self.sl // plan.sub_chunk_count)
            self.sub = self.sl // plan.sub_chunk_count
        if dec is None:
            raise ValueError("the coder has no batched decoder for "
                             f"{self.lost} from {self.helpers}")
        self._dec = dec
        self.entry = _build_recover_program(dec, verify=mix["verify"],
                                            host_crc=False)
        self.batch = mix["batch"]
        pool = mix["pool_objects"]
        if self.batch < 1 or pool % self.batch:
            raise ValueError(f"pool_objects {pool} is not a multiple of "
                             f"the batch {self.batch}")
        self.slices = pool // self.batch
        self.objects_per_op = self.batch
        # the rotted objects of an op fail verification: not rebuilt
        self.rebuilt_per_op = self.batch - mix["corrupt_per_op"]
        self.client_bytes_per_op = 0
        H = len(self.helpers)
        self.stack = torch.empty((pool, H, self.rl), dtype=torch.uint8,
                                 device=device)
        exp = torch.empty((pool, H), dtype=torch.int64, device=device)
        write = port_write(coder, GEN_OBJECTS, self.sl, device)
        for b in range(-(-pool // GEN_OBJECTS)):
            d = data_block(seed, b, k, self.sl, device)
            parity, hinfo = write(d)
            rows = self.shipped(torch.cat([d, parity], dim=1))
            part = slice(b * GEN_OBJECTS, (b + 1) * GEN_OBJECTS)
            cnt = self.stack[part].shape[0]
            self.stack[part] = rows[:cnt]
            if self.planes is None:
                exp[part] = hinfo[:cnt, self.helpers]
            else:
                exp[part] = crc32c_blocks(
                    rows[:cnt].reshape(-1, self.rl), init=0xFFFFFFFF,
                    xorout=0).reshape(cnt, H)
            del d, parity, hinfo, rows
        fold = _expected_fold_crcs(exp.cpu().numpy().astype("uint32"),
                                   self.rl)
        self.expfold = torch.from_numpy(fold.astype("int64")).to(device)
        self.corrupt = self.corruption(pool, H)
        for o, h, off, x in self.corrupt:
            self.stack[o, h, off] ^= x

    def corruption(self, pool: int, H: int) -> list:
        """[(object, helper position, byte, xor)]: mix["corrupt_per_op"]
        objects of each op slice, drawn from the seed."""
        rng = random.Random(subseed(self.seed, "corrupt"))
        out = []
        for s in range(pool // self.batch):
            for o in rng.sample(range(s * self.batch, (s + 1) * self.batch),
                                self.mix["corrupt_per_op"]):
                out.append((o, rng.randrange(H), rng.randrange(self.rl),
                            rng.randrange(1, 256)))
        return out

    def shipped(self, rows: torch.Tensor) -> torch.Tensor:
        """(B, k+m, sl) full rows -> (B, H, rl): what the helpers ship,
        helper-major and plane-minor."""
        rows = rows[:, self.helpers]
        if self.planes is None:
            return rows.contiguous()
        B, H = rows.shape[:2]
        idx = torch.tensor(self.planes, device=rows.device)
        return rows.reshape(B, H, -1, self.sub).index_select(2, idx) \
            .reshape(B, H, self.rl)

    def objects(self, i: int) -> range:
        s = i % self.slices
        return range(s * self.batch, (s + 1) * self.batch)

    def inputs(self, i: int) -> tuple:
        r = self.objects(i)
        return self.stack[r.start:r.stop], self.expfold[r.start:r.stop]

    def use_control(self) -> None:
        """The control: the port's own program with verification
        switched off, which breaks the guarantee that a helper that no
        longer matches its hinfo is caught."""
        from ceph_tpu_torch.osd.ecbackend import _build_recover_program
        self.entry = _build_recover_program(self._dec, verify=False,
                                            host_crc=False)

    def free(self) -> None:
        del self.stack, self.expfold

    def gf_matrices(self) -> list:
        """(launch batch, matrix) of the window's gf_apply launches, by
        the reference: the lost shards from the shipped helper rows (a
        Clay op always ships planes: its single-loss range decoder)."""
        from ecbench.reference.codes import decode_matrix, rs_generator
        kind, code = reference_code(self.config)
        if kind == "clay":
            return [(self.batch,
                     code.repair_matrix(self.lost[0], self.helpers))]
        m, k = code.shape
        return [(self.batch, decode_matrix(rs_generator(k, m),
                                           self.helpers[:k], self.lost))]

    def _reference_parts(self, d: torch.Tensor) -> tuple:
        """(B, k, sl) data -> (the helpers' shipped rows (B, H, rl), the
        lost shards' rows (B, E, sl)) by the plain reference. For Clay
        only the parity sub-chunks that are shipped or lost are
        computed, from the rows of the reference's generator."""
        kind, code = reference_code(self.config)
        if kind == "rs":
            rows = torch.cat([d, reference_parity(self.config, d)], dim=1)
            return self.shipped(rows), rows[:, self.lost]
        B, k, P = d.shape[0], self.k, code.planes
        want = code.shipped_rows(self.helpers, self.planes) \
            + code.shipped_rows(self.lost, list(range(P)))
        data_sub = d.reshape(B, k * P, self.sub)
        par = [r for r in want if r >= k * P]
        computed = dict(zip(par, gf.apply(code.generator()[par],
                                          data_sub).unbind(1)))
        out = torch.stack([data_sub[:, r] if r < k * P else computed[r]
                           for r in want], dim=1)
        H, nship = len(self.helpers), len(self.helpers) * len(self.planes)
        return (out[:, :nship].reshape(B, H, self.rl),
                out[:, nship:].reshape(B, len(self.lost), self.sl))

    def check(self, samples) -> dict:
        """Mismatches over the sampled ops [(op index, outputs)]."""
        bad = {}
        for o, h, off, x in self.corrupt:
            bad.setdefault(o, []).append((h, off, x))
        wrong = {"verdict_wrong": 0, "rebuilt_bytes_wrong": 0,
                 "rebuilt_crc_wrong": 0}
        for i, (rebuilt, rcrc, ok) in samples:
            objs = list(self.objects(i))
            d = objects_data(self.seed, objs, self.k, self.sl, self.device)
            clean, want = self._reference_parts(d)
            dirty = clean.clone()
            for r, o in enumerate(objs):
                for h, off, x in bad.get(o, ()):
                    dirty[r, h, off] ^= x
            fold_clean = clean[:, 0].clone()
            fold_dirty = dirty[:, 0].clone()
            for h in range(1, clean.shape[1]):
                fold_clean ^= clean[:, h]
                fold_dirty ^= dirty[:, h]
            verdict = crc.crc32c_raw(fold_dirty) == crc.crc32c_raw(fold_clean)
            wrong["verdict_wrong"] += mismatches(ok, verdict)
            good = verdict.nonzero().flatten()
            wrong["rebuilt_bytes_wrong"] += mismatches(
                rebuilt.to(self.device)[good], want[good])
            want_crc = crc.crc32c_raw(want.reshape(-1, self.sl)) \
                .reshape(len(objs), -1)
            wrong["rebuilt_crc_wrong"] += mismatches(
                rcrc.to(self.device)[good], want_crc[good])
            del d, clean, dirty, want
        return {name: (v, 0) for name, v in wrong.items()}
