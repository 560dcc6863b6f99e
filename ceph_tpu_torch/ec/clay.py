"""Clay — coupled-layer MSR regenerating code, on torch tensors.

Twin of ceph_tpu/ec/clay.py, the reference's clay plugin (ref:
src/erasure-code/clay/ErasureCodeClay.{h,cc} + ErasureCodePluginClay.cc):
an MDS code with repair-bandwidth-optimal single-node recovery. Each of
the k+m chunks is split into q^t sub-chunks (q = d-k+1, t =
ceil((k+m)/q)); nodes sit on a q x t grid and sub-chunks are pairwise
*coupled* across grid columns, so
repairing one chunk needs only beta = q^(t-1) = subchunks/q sub-chunks
from each of d helpers — total repair I/O d/(d-k+1) chunk-equivalents
instead of k full chunks.

Construction (FAST'18 Clay paper; same math the reference implements):

  * Grid: node i -> (x, y) = (i % q, i // q). Chunk ids map to nodes as
    [data 0..k-1, virtual k..k+nu-1, parity]: nu = q*t - (k+m) virtual
    nodes are all-zero chunks (code shortening), so chunk id k+j is node
    k+nu+j.
  * Planes: sub-chunk index z in [0, q^t) with base-q digits z_y.
  * Pairing: in plane z, node (x, y) with z_y != x pairs its sub-chunk
    with node (z_y, y)'s sub-chunk in plane z' = z with digit y set to x.
    Coupled C and uncoupled U values relate by the symmetric transform
        C1 = U1 + g*U2,   C2 = g*U1 + U2     (g = gamma, g^2 != 1)
    and unpaired sub-chunks (z_y == x) have C = U.
  * Per plane, the uncoupled symbols form a codeword of an (q*t, q*t - m)
    systematic MDS base code (jerasure reed_sol_van by default).

Design: the whole decode/repair is LINEAR over GF(2^8), so the coupled
system is solved symbolically ONCE per erasure pattern (numpy, on the
host, as in the twin) and cached as a single (outputs x inputs) GF
matrix. Applying it is one batched static-matrix apply on the coder's
device. Encode is "decode the parities". The twin defaults to
impl="mxu", an XLA bit-plane matmul chosen for the TPU; here the
default is the hand GF kernel ("pallas", ops/csrc/gf_apply.cu), which
takes these matrices at any k. Profiles that name impl=mxu, bitlinear,
logexp or ref keep working and give the same bytes (ref, the numpy
oracle, runs on a CPU coder only). Data stays on the device through encode,
decode and the fused repair paths; the plane selection of
batch_decoder is a gather there with a long index tensor.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Mapping, Sequence

import numpy as np
import torch

from ..gf.numpy_ref import encode_ref, gf_mul
from ..gf.tables import inv_table, mul_table
from ..ops.rs_kernels import _IMPLS, DEFAULT_IMPL, make_encoder
from ..utils.flight_recorder import declare_span_names
from ..utils.tracing import span
from .interface import CHUNK_ALIGNMENT, ErasureCode, host_array
from .matrices import coding_matrix
from .registry import register


def _solve_affine(M: np.ndarray, K: np.ndarray,
                  A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Reduce outputs A @ v + B @ c to pure-input form D @ c, given the
    (consistent) constraint system M @ v = K @ c over GF(2^8).

    The system may be rank-deficient in v (e.g. Clay repair where a
    non-helper shares the failed node's grid column): free variables are
    fine as long as every output's dependence on them cancels — the MSR
    theory guarantees it for valid helper sets; we verify and raise if a
    free variable survives into an output.
    """
    M = np.array(M, dtype=np.uint8, copy=True)
    K = np.array(K, dtype=np.uint8, copy=True)
    neq, nv = M.shape
    mt = mul_table()
    invt = inv_table()
    row = 0
    pivots: list[tuple[int, int]] = []  # (col, row)
    for col in range(nv):
        pivot = row
        while pivot < neq and M[pivot, col] == 0:
            pivot += 1
        if pivot == neq:
            continue  # free variable
        if pivot != row:
            M[[row, pivot]] = M[[pivot, row]]
            K[[row, pivot]] = K[[pivot, row]]
        p = M[row, col]
        if p != 1:
            pinv = invt[p]
            M[row] = mt[pinv, M[row]]
            K[row] = mt[pinv, K[row]]
        f = M[:, col].copy()
        f[row] = 0
        nz = f.nonzero()[0]
        if nz.size:
            M[nz] ^= mt[f[nz, None], M[row][None, :]]
            K[nz] ^= mt[f[nz, None], K[row][None, :]]
        pivots.append((col, row))
        row += 1
        if row == neq:
            break
    # substitute pivot vars into the outputs:
    #   v_col = K[row] @ c  ^  (free-col part of M[row]) @ v_free
    A = np.array(A, dtype=np.uint8, copy=True)
    D = np.array(B, dtype=np.uint8, copy=True)
    for col, prow in pivots:
        f = A[:, col].copy()
        nz = f.nonzero()[0]
        if nz.size:
            A[nz] ^= mt[f[nz, None], M[prow][None, :]]
            D[nz] ^= mt[f[nz, None], K[prow][None, :]]
    if A.any():
        raise ValueError(
            "clay system underdetermined: outputs depend on unread data "
            "(invalid helper set, gamma, or base code)")
    return D


ENCODE_SPAN = "ec.clay.encode_chunks"
declare_span_names(ENCODE_SPAN)


@register("clay")
class Clay(ErasureCode):
    """Coupled-layer MSR code: MDS with optimal single-failure repair."""

    DEFAULT_GAMMA = 2
    # bytes are coupled across the sub-chunk axis of each chunk, so a
    # sub-window of a chunk is not independently en/decodable
    positionwise = False

    def init(self, profile: Mapping[str, str]) -> None:
        self.k = int(profile.get("k", 4))
        self.m = int(profile.get("m", 2))
        self.d = int(profile.get("d", self.k + self.m - 1))
        if self.m < 2:
            raise ValueError(f"clay m={self.m}: need m >= 2")
        if not self.k + 1 <= self.d <= self.k + self.m - 1:
            raise ValueError(
                f"clay d={self.d} must be in [k+1={self.k + 1}, "
                f"k+m-1={self.k + self.m - 1}]")
        self.q = self.d - self.k + 1
        self.t = -(-(self.k + self.m) // self.q)
        self.nu = self.q * self.t - (self.k + self.m)
        self.sub_chunk_count = self.q ** self.t
        if self.sub_chunk_count > 1024:
            raise ValueError(
                f"clay k={self.k} m={self.m} d={self.d}: q^t = "
                f"{self.sub_chunk_count} sub-chunks exceeds the supported "
                f"1024 (matrix-cache construction cost)")
        self.gamma = int(profile.get("gamma", self.DEFAULT_GAMMA))
        if self.gamma in (0, 1) or gf_mul(self.gamma, self.gamma) == 1:
            raise ValueError(f"clay gamma={self.gamma}: need gamma^2 != 1")
        # base MDS code over the q*t grid symbols: k+nu data + m parity
        # (ref: ErasureCodeClay uses a jerasure/isa MDS coder the same way)
        technique = profile.get("technique", "reed_sol_van")
        self.base_matrix = coding_matrix(technique, self.k + self.nu, self.m)
        self.technique = technique
        self.impl = profile.get("impl", DEFAULT_IMPL)
        if self.impl != "ref" and self.impl not in _IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; available: "
                             f"{sorted(_IMPLS) + ['ref']}")
        if self.impl == "ref" and self.device.type != "cpu":
            raise ValueError(f"impl=ref is the host numpy oracle and runs "
                             f"on a CPU coder only, not on {self.device}")
        nn = self.q * self.t
        # parity-check H = [C | I_m] over node order [data, virtual, parity]
        self.H = np.concatenate(
            [self.base_matrix, np.eye(self.m, dtype=np.uint8)], axis=1)
        assert self.H.shape == (self.m, nn)
        self._affine_cache: dict[tuple, tuple] = {}
        # id(D) -> (D, fn): D is held so that its id cannot be reused
        self._fn_cache: dict[int, tuple] = {}
        self._plane_idx: dict[tuple, torch.Tensor] = {}

    # -- grid / plane coordinate helpers ----------------------------------

    def _node_of_chunk(self, c: int) -> int:
        return c if c < self.k else c + self.nu

    def _chunk_of_node(self, n: int) -> int | None:
        """Inverse of _node_of_chunk; None for virtual nodes."""
        if n < self.k:
            return n
        if n < self.k + self.nu:
            return None
        return n - self.nu

    def _xy(self, n: int) -> tuple[int, int]:
        return n % self.q, n // self.q

    def _digit(self, z: int, y: int) -> int:
        return (z // self.q ** y) % self.q

    def _set_digit(self, z: int, y: int, v: int) -> int:
        return z + (v - self._digit(z, y)) * self.q ** y

    # -- geometry ----------------------------------------------------------

    def get_chunk_size(self, stripe_width: int) -> int:
        # chunk splits into q^t sub-chunks, each a full TPU lane wide
        sub_align = CHUNK_ALIGNMENT * self.sub_chunk_count
        align = self.k * sub_align
        padded = -(-stripe_width // align) * align
        return padded // self.k

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_count

    # -- symbolic affine construction --------------------------------------
    #
    # Expressions are (var_vec, const_vec) uint8 rows: a GF(2^8) linear
    # combination of the unknown U values (vars) and the known coupled
    # sub-chunks read as input (consts). Everything below manipulates
    # those rows; the data never appears until apply time.

    def _u_expr(self, n: int, z: int, var_idx, const_idx, nv: int, nc: int,
                is_var) -> tuple[np.ndarray, np.ndarray]:
        """Uncoupled symbol U(n, z) of a KNOWN node as an affine row."""
        g = self.gamma
        invdet = int(inv_table()[1 ^ gf_mul(g, g)])  # 1/(1+g^2)
        V = np.zeros(nv, np.uint8)
        C = np.zeros(nc, np.uint8)
        x, y = self._xy(n)
        zy = self._digit(z, y)

        def cconst(node, plane, coef):
            ci = const_idx.get((node, plane))
            if ci is not None:  # virtual/zero chunks simply drop out
                C[ci] ^= np.uint8(coef)

        if zy == x:  # unpaired: C == U
            cconst(n, z, 1)
            return V, C
        p = y * self.q + zy
        zp = self._set_digit(z, y, x)
        if is_var(p):
            # partner U is unknown: U_self = C_self + g * U_partner
            cconst(n, z, 1)
            V[var_idx[(p, zp)]] ^= np.uint8(g)
        else:
            # both coupled values known: U_self = (C_self + g*C_partner)/(1+g^2)
            cconst(n, z, invdet)
            cconst(p, zp, gf_mul(g, invdet))
        return V, C

    def _affine_decode(self, erased_chunks: tuple[int, ...],
                       avail_chunks: tuple[int, ...]) -> tuple[np.ndarray, list]:
        """Full-decode matrix: erased chunks' coupled bytes from survivors.

        Returns (D, inputs) with D: (|E|*planes, len(inputs)*planes) and
        inputs the chunk ids consumed, so that
        stacked_erased_subchunks = D @ stacked_input_subchunks.
        Also used for encode (erased = the m parity chunks).
        """
        key = ("dec", erased_chunks, avail_chunks)
        hit = self._affine_cache.get(key)
        if hit is not None:
            return hit
        nn, P = self.q * self.t, self.sub_chunk_count
        E = [self._node_of_chunk(c) for c in erased_chunks]
        eset = set(E)
        inputs = list(avail_chunks)
        in_nodes = [self._node_of_chunk(c) for c in inputs]
        var_idx = {(n, z): i * P + z for i, n in enumerate(E) for z in range(P)}
        const_idx = {(n, z): i * P + z
                     for i, n in enumerate(in_nodes) for z in range(P)}
        nv, nc = len(E) * P, len(inputs) * P
        is_var = eset.__contains__
        known = [n for n in range(nn) if n not in eset]
        # cache U rows for known nodes per (node, plane)
        u_rows = {}
        for n in known:
            for z in range(P):
                u_rows[(n, z)] = self._u_expr(n, z, var_idx, const_idx,
                                              nv, nc, is_var)
        M = np.zeros((self.m * P, nv), np.uint8)
        K = np.zeros((self.m * P, nc), np.uint8)
        mt = mul_table()
        for z in range(P):
            for r in range(self.m):
                eq = z * self.m + r
                for n in range(nn):
                    h = int(self.H[r, n])
                    if h == 0:
                        continue
                    if n in eset:
                        M[eq, var_idx[(n, z)]] ^= np.uint8(h)
                    else:
                        V, C = u_rows[(n, z)]
                        M[eq] ^= mt[h, V]
                        K[eq] ^= mt[h, C]
        # coupled output expressions over (vars, consts), then eliminate
        g = self.gamma
        one_g2 = 1 ^ gf_mul(g, g)
        A = np.zeros((len(E) * P, nv), np.uint8)
        B = np.zeros((len(E) * P, nc), np.uint8)
        for i, n in enumerate(E):
            x, y = self._xy(n)
            for z in range(P):
                out = i * P + z
                zy = self._digit(z, y)
                if zy == x:
                    A[out, var_idx[(n, z)]] = 1
                    continue
                p = y * self.q + zy
                zp = self._set_digit(z, y, x)
                if p in eset:
                    # C = U + g * U_partner (both unknowns)
                    A[out, var_idx[(n, z)]] ^= np.uint8(1)
                    A[out, var_idx[(p, zp)]] ^= np.uint8(g)
                else:
                    # C = (1+g^2) U + g * C_partner
                    A[out, var_idx[(n, z)]] = one_g2
                    ci = const_idx.get((p, zp))
                    if ci is not None:
                        B[out, ci] ^= np.uint8(g)
        D = _solve_affine(M, K, A, B)
        result = (D, inputs)
        self._affine_cache[key] = result
        return result

    def _repair_planes(self, failed_chunk: int) -> list[int]:
        """Planes each helper must send for a single-chunk repair."""
        x0, y0 = self._xy(self._node_of_chunk(failed_chunk))
        return [z for z in range(self.sub_chunk_count)
                if self._digit(z, y0) == x0]

    def _affine_repair(self, failed_chunk: int,
                       helper_chunks: tuple[int, ...]) -> tuple[np.ndarray, list]:
        """Repair matrix: failed chunk's full sub-chunks from the d
        helpers' repair-plane sub-chunks only (the MSR bandwidth win)."""
        key = ("rep", failed_chunk, helper_chunks)
        hit = self._affine_cache.get(key)
        if hit is not None:
            return hit
        nn, P, q = self.q * self.t, self.sub_chunk_count, self.q
        nstar = self._node_of_chunk(failed_chunk)
        x0, y0 = self._xy(nstar)
        helpers = [self._node_of_chunk(c) for c in helper_chunks]
        hset = set(helpers)
        rplanes = self._repair_planes(failed_chunk)
        rpos = {z: i for i, z in enumerate(rplanes)}
        nrp = len(rplanes)  # q^(t-1)
        virt = set(range(self.k, self.k + self.nu))
        nonhelp = [n for n in range(nn)
                   if n != nstar and n not in hset and n not in virt]
        # vars: U(failed, every plane) + U(non-helper, repair planes)
        var_idx: dict[tuple[int, int], int] = {}
        for z in range(P):
            var_idx[(nstar, z)] = z
        base = P
        for j, n in enumerate(nonhelp):
            for z in rplanes:
                var_idx[(n, z)] = base + j * nrp + rpos[z]
        nv = P + len(nonhelp) * nrp
        const_idx = {(n, z): i * nrp + rpos[z]
                     for i, n in enumerate(helpers) for z in rplanes}
        nc = len(helpers) * nrp
        unknown = {nstar, *nonhelp}
        is_var = unknown.__contains__
        mt = mul_table()
        M = np.zeros((self.m * nrp, nv), np.uint8)
        K = np.zeros((self.m * nrp, nc), np.uint8)
        u_rows = {(n, z): self._u_expr(n, z, var_idx, const_idx, nv, nc, is_var)
                  for n in range(nn) if n not in unknown for z in rplanes}
        for zi, z in enumerate(rplanes):
            for r in range(self.m):
                eq = zi * self.m + r
                for n in range(nn):
                    h = int(self.H[r, n])
                    if h == 0:
                        continue
                    if n in unknown:
                        M[eq, var_idx[(n, z)]] ^= np.uint8(h)
                    else:
                        V, C = u_rows[(n, z)]
                        M[eq] ^= mt[h, V]
                        K[eq] ^= mt[h, C]
        g = self.gamma
        one_g2 = 1 ^ gf_mul(g, g)
        A = np.zeros((P, nv), np.uint8)
        B = np.zeros((P, nc), np.uint8)
        for z in range(P):
            zy = self._digit(z, y0)
            if zy == x0:  # repair plane: failed node is unpaired there
                A[z, var_idx[(nstar, z)]] = 1
                continue
            p = y0 * q + zy
            zp = self._set_digit(z, y0, x0)  # a repair plane
            if p in virt:
                A[z, var_idx[(nstar, z)]] = one_g2
            elif p in hset:
                A[z, var_idx[(nstar, z)]] = one_g2
                B[z, const_idx[(p, zp)]] ^= np.uint8(g)
            else:  # partner is a non-helper: its repair-plane U is a var
                A[z, var_idx[(nstar, z)]] ^= np.uint8(1)
                A[z, var_idx[(p, zp)]] ^= np.uint8(g)
        D = _solve_affine(M, K, A, B)
        result = (D, list(helper_chunks))
        self._affine_cache[key] = result
        return result

    def repair_plan_matrix(self, failed_chunk: int,
                           helper_chunks: Sequence[int]
                           ) -> tuple[np.ndarray, list[int]]:
        """Public face of the cached affine repair solve: returns
        (D, repair_planes) such that stacking the helpers' repair-plane
        sub-chunks as (B, d*len(planes), s) and applying the static GF
        matrix D yields the failed chunk's full (B, q^t, s) sub-chunks.
        Lets callers (the sharded mesh path) run the bandwidth-optimal
        MSR repair as one device matrix-apply."""
        D, _ = self._affine_repair(int(failed_chunk), tuple(helper_chunks))
        return D, self._repair_planes(int(failed_chunk))

    # -- device fast path ---------------------------------------------------

    def batch_decoder(self, erasures: Sequence[int],
                      survivors: Sequence[int]):
        """Fused single-chunk MSR repair: one jittable fn mapping the
        full helper stack (B, d, sl) to the rebuilt chunk (B, 1, sl).
        The repair-plane selection (each helper contributes only
        beta = sl/(d-k+1) bytes of GF math) happens ON DEVICE, so the
        whole repair is one launch — the bandwidth-optimal plan from
        repair_plan_matrix without the host-side sub-chunk staging.
        Multi-loss falls back (returns None → decode_chunks). Ref:
        ErasureCodeClay::repair / minimum_to_decode sub-chunk ranges."""
        erasures = tuple(int(e) for e in erasures)
        survivors = tuple(int(s) for s in survivors)
        if len(erasures) != 1 or len(survivors) != self.d \
                or self.impl == "ref":   # ref = numpy oracle, no
            return None                  # device path to fuse into
        key = ("bd", erasures, survivors)
        fn = self._affine_cache.get(key)
        if fn is None:
            lost = erasures[0]
            D, planes = self.repair_plan_matrix(lost, survivors)
            mfn = make_encoder(D, self.impl)
            P = self.sub_chunk_count
            beta = len(planes)

            def fn(stack):                      # (B, H, sl) u8
                B, H_, sl = stack.shape
                if sl % P:
                    raise ValueError(
                        f"shard length {sl} not divisible into "
                        f"{P} sub-chunks")
                s = sl // P
                idx = self._planes_on(planes, stack.device)
                sub = stack.reshape(B, H_, P, s).index_select(2, idx)
                out = mfn(sub.reshape(B, H_ * beta, s))  # (B, P, s)
                return out.reshape(B, 1, sl)
            self._affine_cache[key] = fn
        return fn

    def _planes_on(self, planes: Sequence[int],
                   device: torch.device) -> torch.Tensor:
        """The plane ids as a long index tensor on `device` (a uint8
        index would be a mask), made once per (planes, device)."""
        key = (tuple(planes), device)
        idx = self._plane_idx.get(key)
        if idx is None:
            idx = torch.as_tensor(list(planes), dtype=torch.long,
                                  device=device)
            self._plane_idx[key] = idx
        return idx

    def range_batch_decoder(self, erasures: Sequence[int],
                            survivors: Sequence[int]):
        """Sub-chunk-granular MSR repair for the range-read wire path:
        one jittable fn mapping the helpers' SHIPPED repair planes
        (B, d, rl) — rl = beta * sub_size, each row the concatenation
        of that helper's repair planes in ascending plane order — to
        the rebuilt chunk (B, 1, q^t * sub_size). Unlike batch_decoder
        the plane selection already happened at the SOURCE (the readv
        range list), so the wire moved only beta/q^t of each helper
        row; the device just applies the cached repair matrix."""
        erasures = tuple(int(e) for e in erasures)
        survivors = tuple(int(s) for s in survivors)
        if len(erasures) != 1 or len(survivors) != self.d \
                or self.impl == "ref":
            return None
        key = ("bdr", erasures, survivors)
        fn = self._affine_cache.get(key)
        if fn is None:
            D, planes = self.repair_plan_matrix(erasures[0], survivors)
            mfn = make_encoder(D, self.impl)
            beta = len(planes)
            P = self.sub_chunk_count

            def fn(stack):                  # (B, H, rl) u8
                B, H_, rl = stack.shape
                if rl % beta:
                    raise ValueError(
                        f"range row length {rl} not divisible into "
                        f"{beta} repair planes")
                s = rl // beta
                # helper-major, plane-minor — the repair matrix's
                # input order (const_idx in _affine_repair)
                out = mfn(stack.reshape(B, H_ * beta, s))  # (B, P, s)
                return out.reshape(B, 1, P * s)
            self._affine_cache[key] = fn
        return fn

    def range_decode_program_key(self, erasures: Sequence[int],
                                 survivors: Sequence[int]):
        erasures = tuple(int(e) for e in erasures)
        survivors = tuple(int(s) for s in survivors)
        if self.range_batch_decoder(erasures, survivors) is None:
            return None
        D, planes = self.repair_plan_matrix(erasures[0], survivors)
        return ("clayrng", D.tobytes(), D.shape, tuple(planes),
                self.impl)

    # -- data paths ---------------------------------------------------------

    def _apply(self, D: np.ndarray, stacked: torch.Tensor) -> torch.Tensor:
        """(B, nin, sub) -> (B, nout, sub) via the cached GF matrix, on
        the coder's device."""
        if self.impl == "ref":
            return torch.from_numpy(encode_ref(D, host_array(stacked))
                                    ).to(self.device)
        hit = self._fn_cache.get(id(D))
        if hit is None or hit[0] is not D:
            hit = (D, make_encoder(D, self.impl))
            self._fn_cache[id(D)] = hit
        return hit[1](stacked)

    def _split(self, chunk: torch.Tensor) -> torch.Tensor:
        """(..., L) chunk -> (..., q^t, sub) sub-chunks."""
        L = chunk.shape[-1]
        P = self.sub_chunk_count
        if L % P:
            raise ValueError(f"chunk size {L} not divisible into {P} sub-chunks")
        return chunk.reshape(tuple(chunk.shape[:-1]) + (P, L // P))

    def encode_chunks(self, data) -> torch.Tensor:
        with span(ENCODE_SPAN, ring=False):
            data = self.as_chunks(data)
            B, k, L = data.shape
            assert k == self.k
            parity_ids = tuple(range(self.k, self.k + self.m))
            D, inputs = self._affine_decode(parity_ids,
                                            tuple(range(self.k)))
            sub = self._split(data)  # (B, k, P, s)
            stacked = sub.reshape(B, self.k * self.sub_chunk_count, -1)
            out = self._apply(D, stacked)  # (B, m*P, s)
            return out.reshape(B, self.m, L)

    def decode_chunks(self, want_to_read: Sequence[int],
                      chunks: Mapping[int, object]
                      ) -> dict[int, torch.Tensor]:
        want = tuple(sorted(set(want_to_read)))
        passthrough = {c: self.as_chunks(chunks[c])
                       for c in want if c in chunks}
        missing = tuple(c for c in want if c not in chunks)
        if not missing:
            return passthrough
        have = tuple(sorted(chunks))
        n = self.get_chunk_count()
        # the coupled system ties every chunk's sub-chunks together, so a
        # chunk neither wanted nor provided must be treated as ERASED too —
        # silently assuming it zero would corrupt the solve. Single-failure
        # reads that provide only the d chosen helpers (the
        # minimum_to_decode contract) go through the repair path instead.
        erased = tuple(sorted(set(range(n)) - set(have)))
        if len(erased) > self.m:
            if len(missing) == 1 and len(have) >= self.d:
                rebuilt = self.repair_from_chunks(missing[0], dict(chunks))
                return {**passthrough, missing[0]: rebuilt}
            raise ValueError(
                f"cannot decode {sorted(want)}: {len(erased)} chunks "
                f"unavailable (m={self.m}); provide more survivors")
        D, inputs = self._affine_decode(erased, have)
        arrs = [self.as_chunks(chunks[c]) for c in inputs]
        squeeze = arrs[0].ndim == 1
        if squeeze:
            arrs = [a[None] for a in arrs]
        B, L = arrs[0].shape
        sub = torch.stack([self._split(a) for a in arrs], dim=1)
        stacked = sub.reshape(B, len(inputs) * self.sub_chunk_count, -1)
        out = self._apply(D, stacked).reshape(B, len(erased), L)
        if squeeze:
            out = out[0]
        wanted = set(missing)
        solved = {e: out[..., i, :] for i, e in enumerate(erased) if e in wanted}
        return {**passthrough, **solved}

    # -- repair (the point of Clay) ----------------------------------------

    def minimum_to_decode(self, want_to_read: Sequence[int],
                          available: Sequence[int]) -> set[int]:
        """Single erasure: d helpers (sub-chunk ranges via
        minimum_to_decode_subchunks). Multi erasure: all survivors
        (the coupled decode consumes every available chunk)."""
        want = set(want_to_read)
        avail = set(available)
        missing = want - avail
        if not missing:
            return want
        if len(missing) == 1:
            helpers = sorted(avail - want)
            if len(helpers) < self.d:
                # degraded below d: fall back to full decode if possible
                if len(avail) >= self.get_chunk_count() - self.m:
                    return set(avail)
                raise ValueError(
                    f"clay repair needs {self.d} helpers, have {len(helpers)}")
            failed = next(iter(missing))
            return set(self._pick_helpers(failed, helpers)) | (want & avail)
        survivors = avail - want
        if len(survivors) < self.get_chunk_count() - self.m:
            raise ValueError(
                f"cannot decode {sorted(missing)} from {sorted(avail)}")
        return set(avail)

    def _pick_helpers(self, failed_chunk: int,
                      candidates: Sequence[int],
                      costs: Mapping[int, int] | None = None) -> list[int]:
        """Choose d helpers for a single-chunk repair.

        The failed node's non-repair-plane sub-chunks are coupled only
        with its grid-COLUMN mates, so every surviving same-column chunk
        must be a helper or the repair system is underdetermined; the
        remaining slots are filled with the cheapest surviving ids
        (lowest id when no costs are given).
        """
        _, y0 = self._xy(self._node_of_chunk(failed_chunk))
        cand = sorted(set(candidates) - {failed_chunk})
        mates = [c for c in cand
                 if self._xy(self._node_of_chunk(c))[1] == y0]
        rest = [c for c in cand if c not in set(mates)]
        if costs:
            rest.sort(key=lambda c: (int(costs.get(c, 0)), c))
        # at most q-1 = d-k column mates survive, so mates never fill d
        helpers = sorted(mates + rest[:self.d - len(mates)])
        if len(helpers) < self.d:
            raise ValueError(f"need {self.d} helpers, have {len(helpers)}")
        return helpers

    def minimum_to_decode_with_cost(self, want_to_read: Sequence[int],
                                    available: Mapping[int, int]) -> set[int]:
        """Cost-aware override: the MDS default's 'k cheapest' is wrong
        for a coupled code (single-loss repair needs d helpers
        INCLUDING every surviving grid-column mate; multi-loss consumes
        every survivor), so pick structurally and spend the costs only
        on the free helper slots."""
        want = set(want_to_read)
        avail = set(available)
        missing = want - avail
        if not missing:
            return want
        if len(missing) == 1:
            helpers = sorted(avail - want)
            if len(helpers) >= self.d:
                failed = next(iter(missing))
                return set(self._pick_helpers(failed, helpers,
                                              costs=available)) \
                    | (want & avail)
        return self.minimum_to_decode(sorted(want), sorted(avail))

    def minimum_to_decode_subchunks(
            self, failed_chunk: int,
            available: Sequence[int]) -> dict[int, list[int]]:
        """{helper chunk id: sub-chunk (plane) indices to read} for one
        failed chunk — beta = q^(t-1) planes per helper (ref:
        ErasureCodeClay::minimum_to_decode returning sub-chunk ranges)."""
        helpers = self._pick_helpers(failed_chunk, available)
        planes = self._repair_planes(failed_chunk)
        return {h: list(planes) for h in helpers}

    def repair_chunk(self, failed_chunk: int,
                     subchunks: Mapping[int, object]) -> torch.Tensor:
        """Rebuild one chunk from helpers' repair-plane sub-chunks.

        subchunks: {helper chunk id: (..., beta, sub_size) uint8} holding
        ONLY the repair planes (order = minimum_to_decode_subchunks).
        Returns the full (..., chunk_size) failed chunk.
        """
        helpers = tuple(sorted(subchunks))
        if len(helpers) != self.d:
            raise ValueError(f"need exactly d={self.d} helpers, got {len(helpers)}")
        D, order = self._affine_repair(failed_chunk, helpers)
        arrs = [self.as_chunks(subchunks[h]) for h in order]
        squeeze = arrs[0].ndim == 2
        if squeeze:
            arrs = [a[None] for a in arrs]
        B, beta, s = arrs[0].shape
        stacked = torch.stack(arrs, dim=1).reshape(B, len(order) * beta, s)
        out = self._apply(D, stacked)  # (B, P, s)
        out = out.reshape(B, self.sub_chunk_count * s)
        if squeeze:
            out = out[0]
        return out

    def repair_from_chunks(self, failed_chunk: int,
                           chunks: Mapping[int, object]) -> torch.Tensor:
        """Convenience: slice repair planes out of full helper chunks and
        repair — still touching only beta/q^t of each helper's bytes."""
        need = self.minimum_to_decode_subchunks(failed_chunk, list(chunks))
        picked = {}
        for h, planes in need.items():
            sub = self._split(self.as_chunks(chunks[h]))
            picked[h] = sub.index_select(
                sub.ndim - 2, self._planes_on(planes, sub.device))
        return self.repair_chunk(failed_chunk, picked)
