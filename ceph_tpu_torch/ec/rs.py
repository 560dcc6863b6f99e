"""Reed-Solomon coder — the jerasure/isa plugin equivalent.

Twin of ceph_tpu/ec/rs.py. Covers the reference's `jerasure` plugin
techniques reed_sol_van / cauchy_orig / cauchy_good (ref:
src/erasure-code/jerasure/ErasureCodeJerasure.cc) and the `isa` plugin
(ref: src/erasure-code/isa/ErasureCodeIsa.cc).

Encode: parity = C (GF@) data on the coder's device with a static
matrix. Decode: invert the surviving k x k submatrix on the host (tiny,
as jerasure_matrix_decode does) and run the same static-matrix apply
with the decode matrix; decode functions are cached per erasure pattern.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from ..gf.numpy_ref import decode_matrix
from ..ops.rs_kernels import _IMPLS, DEFAULT_IMPL, make_encoder
from .interface import ErasureCode
from .matrices import coding_matrix
from .registry import register


class ReedSolomon(ErasureCode):
    """MDS Reed-Solomon over GF(2^8), batched on the coder's device."""

    def init(self, profile: Mapping[str, str]) -> None:
        self.k = int(profile.get("k", 7))
        self.m = int(profile.get("m", 3))
        technique = profile.get("technique", "reed_sol_van")
        self.technique = technique
        self.impl = profile.get("impl", DEFAULT_IMPL)
        if self.impl not in _IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; "
                             f"available: {sorted(_IMPLS)}")
        if self.k < 1 or self.m < 1 or self.k + self.m > 256:
            raise ValueError(f"bad geometry k={self.k} m={self.m} (w=8)")
        self.matrix = coding_matrix(technique, self.k, self.m)
        self._encode_fn = make_encoder(self.matrix, self.impl)
        self._decode_cache: dict[tuple[tuple[int, ...], tuple[int, ...]],
                                 tuple] = {}

    def encode_chunks(self, data) -> torch.Tensor:
        return self._encode_fn(self.as_chunks(data))

    def delta_matrix(self, touched):
        # exact: the parity-delta matrix IS the coding matrix's
        # touched columns
        touched = tuple(int(t) for t in touched)
        if any(not 0 <= t < self.k for t in touched):
            raise ValueError(f"touched rows must be in [0, {self.k})")
        return self.matrix[:, list(touched)].copy()

    def _decoder_for(self, erasures: tuple[int, ...],
                     survivors: tuple[int, ...]):
        key = (erasures, survivors)
        hit = self._decode_cache.get(key)
        if hit is None:
            D = decode_matrix(self.matrix, list(erasures), self.k,
                              list(survivors))
            hit = (make_encoder(D, self.impl), survivors)
            self._decode_cache[key] = hit
        return hit

    def batch_decoder(self, erasures: Sequence[int],
                      survivors: Sequence[int]):
        # stack rows arrive in `survivors` order, outputs leave in
        # `erasures` order; only the first k survivors are consumed
        erasures = tuple(erasures)
        survivors = tuple(survivors)[:self.k]
        if len(survivors) < self.k:
            return None
        fn, _ = self._decoder_for(erasures, survivors)
        return fn

    def decode_chunks(self, want_to_read: Sequence[int],
                      chunks: Mapping[int, object]
                      ) -> dict[int, torch.Tensor]:
        erasures = tuple(sorted(want_to_read))
        survivors = tuple(sorted(
            i for i in chunks if i not in set(erasures))[:self.k])
        if len(survivors) < self.k:
            raise ValueError(
                f"need {self.k} chunks to decode, have {len(survivors)}")
        fn, surv = self._decoder_for(erasures, survivors)
        stack = torch.stack([self.as_chunks(chunks[s]) for s in surv],
                            dim=-2)
        squeeze = stack.ndim == 2
        if squeeze:
            stack = stack[None]
        rec = fn(stack)  # (B, E, L)
        if squeeze:
            rec = rec[0]
        return {e: rec[..., i, :] for i, e in enumerate(erasures)}


@register("tpu_rs")
@register("jerasure")  # accept reference profile strings unchanged
def _jerasure_factory(profile: Mapping[str, str],
                      device=None) -> ErasureCode:
    """The jerasure plugin face: matrix techniques go to ReedSolomon,
    bitmatrix techniques (liberation, blaum_roth, liber8tion) to the
    XOR-schedule coder (ref: ErasureCodePluginJerasure::factory)."""
    from .bitmatrix import BITMATRIX_TECHNIQUES, JerasureBitmatrix
    technique = dict(profile).get("technique", "reed_sol_van")
    if technique in BITMATRIX_TECHNIQUES:
        return JerasureBitmatrix(profile, device=device)
    return ReedSolomon(profile, device=device)


@register("isa")
class IsaReedSolomon(ReedSolomon):
    """The isa plugin's coder (ref: src/erasure-code/isa/ErasureCodeIsa.cc
    ErasureCodeIsaDefault, techniques reed_sol_van / cauchy).

    ISA-L's reed_sol_van builds its matrix as gf_gen_rs_matrix does (row
    r = powers of 2^r), a different byte format from jerasure's. That
    construction is not MDS for every geometry, so init() verifies
    decodability for small codes and rejects degenerate setups.
    """

    # exhaustive MDS verification is C(k+m, m) tiny matrix inversions;
    # above this budget reed_sol_van is refused rather than trusted.
    _MDS_CHECK_BUDGET = 200_000

    def init(self, profile: Mapping[str, str]) -> None:
        prof = dict(profile)
        technique = prof.get("technique", "reed_sol_van")
        if technique == "reed_sol_van":
            prof["technique"] = "isa_reed_sol_van"
        elif technique == "cauchy":
            prof["technique"] = "isa_cauchy"
        else:
            raise ValueError(f"isa plugin technique must be reed_sol_van or "
                             f"cauchy, got {technique!r}")
        super().init(prof)
        self.technique = technique
        if technique == "reed_sol_van":
            from math import comb

            from .matrices import is_mds
            if comb(self.k + self.m, self.m) > self._MDS_CHECK_BUDGET:
                raise ValueError(
                    f"isa reed_sol_van k={self.k} m={self.m}: MDS property "
                    f"cannot be verified exhaustively at this size and the "
                    f"construction is not guaranteed MDS; use "
                    f"technique=cauchy (always MDS)")
            if not is_mds(self.matrix, self.k):
                raise ValueError(
                    f"isa reed_sol_van matrix is not MDS for k={self.k} "
                    f"m={self.m}; use technique=cauchy")
