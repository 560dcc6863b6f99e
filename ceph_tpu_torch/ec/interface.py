"""The erasure-code contract, batched-tensor edition.

Twin of ceph_tpu/ec/interface.py (ref: src/erasure-code/
ErasureCodeInterface.h and ErasureCode.{h,cc}). The unit of work is a
BATCH of objects; chunks are uint8 tensors of shape (batch, L) on the
coder's device, and the hot paths run the static-matrix kernels of
ceph_tpu_torch.ops.rs_kernels. A profile is a {str: str} dict exactly
like ErasureCodeProfile, so reference profile strings round-trip
unchanged.

A coder lives on one device, chosen at construction: `device=None`
means the CUDA device and raises when CUDA is not available; the CPU
is used only when asked for (`device="cpu"`). Inputs may be bytes,
numpy arrays or tensors; outputs are tensors on the coder's device.
"""

from __future__ import annotations

import abc
from typing import Mapping, Sequence

import numpy as np
import torch

# Chunk sizes are multiples of this (the twin's TPU lane width; it
# also satisfies the jerasure and BlueStore alignments).
CHUNK_ALIGNMENT = 128

ErasureCodeProfile = dict  # {str: str}


def resolve_device(device) -> torch.device:
    """None -> the current CUDA device (raises without CUDA); else as
    given. A CUDA device always carries its index, so that it compares
    equal to the `.device` of the tensors made on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "port on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def host_array(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ErasureCode(abc.ABC):
    """Base class: geometry + padding/split/concat defaults.

    Subclasses set self.k, self.m after init() and implement the chunk
    codecs. All byte-level layout rules (padding to stripe width, chunk
    order) live here so every codec shares one bit-exact object<->chunk
    mapping (ref: ErasureCode::encode prep + ECUtil stripe math).
    """

    k: int
    m: int

    # True when encode/decode act independently on every byte position
    # of a chunk (all matrix codes). Vector codes that couple bytes
    # across a chunk set this False.
    positionwise: bool = True

    def __init__(self, profile: Mapping[str, str] | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.profile: ErasureCodeProfile = dict(profile or {})
        if profile is not None:
            self.init(self.profile)

    def as_chunks(self, x) -> torch.Tensor:
        """bytes / array / tensor -> uint8 tensor on the coder's device."""
        if isinstance(x, (bytes, bytearray, memoryview)):
            x = np.frombuffer(x, dtype=np.uint8).copy()
        elif isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()
        return torch.as_tensor(x, dtype=torch.uint8, device=self.device)

    # -- lifecycle ---------------------------------------------------------

    @abc.abstractmethod
    def init(self, profile: Mapping[str, str]) -> None:
        """Parse/validate the profile; set k, m; build matrices."""

    # -- geometry ----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_chunk_mapping(self) -> list[int]:
        """Shard-id permutation; identity unless a subclass remaps."""
        return list(range(self.get_chunk_count()))

    def get_chunk_size(self, stripe_width: int) -> int:
        """Bytes per chunk for an object of `stripe_width` logical bytes,
        padded so chunk_size is CHUNK_ALIGNMENT-aligned."""
        align = self.k * CHUNK_ALIGNMENT
        padded = -(-stripe_width // align) * align
        return padded // self.k

    # -- device fast path --------------------------------------------------

    def batch_decoder(self, erasures: Sequence[int],
                      survivors: Sequence[int]):
        """A function mapping a survivor stack (B, H, L) uint8 (rows in
        `survivors` order) to the rebuilt chunks (B, len(erasures), L)
        in `erasures` order, for fusing into larger device programs
        (recovery decode + CRC). Returns None when the codec has no
        static-matrix form for this pattern; callers then use
        decode_chunks."""
        if not getattr(self, "positionwise", True):
            return None
        impl = getattr(self, "impl", None) or "mxu"
        if impl == "ref":
            return None
        erasures = tuple(int(e) for e in erasures)
        survivors = tuple(int(s) for s in survivors)
        cache = self.__dict__.setdefault("_bd_cache", {})
        fn = cache.get((erasures, survivors))
        if fn is None:
            from ..ops.rs_kernels import make_encoder
            from .linearize import derive_repair_matrix
            R = None
            for seed in range(3):  # a random probe matrix is singular
                try:               # ~0.4% of the time even when the
                    R = derive_repair_matrix(   # helpers suffice
                        self, erasures, survivors, seed=seed)
                    break
                except ValueError:
                    continue
            fn = make_encoder(R, impl) if R is not None else False
            cache[(erasures, survivors)] = fn
        return fn or None

    # -- parity-delta fast path (partial-stripe RMW) -----------------------

    def delta_matrix(self, touched: Sequence[int]):
        """(m, len(touched)) GF matrix D with parity_delta =
        D (GF@) data_delta byte-wise, or None when the codec has no
        static scalar form. `touched` names DENSE data rows.
        Cached per instance; derivation is probe-verified."""
        if not getattr(self, "positionwise", True):
            return None
        touched = tuple(int(t) for t in touched)
        cache = self.__dict__.setdefault("_dm_cache", {})
        if touched not in cache:
            from .linearize import derive_delta_matrix
            try:
                cache[touched] = derive_delta_matrix(self, touched)
            except ValueError:
                cache[touched] = None
        return cache[touched]

    def parity_delta(self, touched: Sequence[int], deltas) -> torch.Tensor:
        """(B, len(touched), L) data-shard deltas (new ^ old, DENSE row
        order per `touched`) -> (B, m, L) parity deltas. Uses the static
        delta matrix on the device when one exists (the twin applies it
        with the numpy oracle; the bytes are the same), else encodes the
        zero-padded delta through encode_chunks (linearity)."""
        deltas = self.as_chunks(deltas)
        touched = tuple(int(t) for t in touched)
        if deltas.ndim != 3 or deltas.shape[1] != len(touched):
            raise ValueError(
                f"deltas must be (B, {len(touched)}, L), "
                f"got {tuple(deltas.shape)}")
        D = self.delta_matrix(touched)
        if D is not None:
            from ..ops.rs_kernels import apply_matrix
            impl = getattr(self, "impl", None) or "mxu"
            return apply_matrix(D, deltas, impl)
        B, t, L = deltas.shape
        full = torch.zeros((B, self.k, L), dtype=torch.uint8,
                           device=self.device)
        for ti, tr in enumerate(touched):
            full[:, tr, :] = deltas[:, ti, :]
        return self.encode_chunks(full)

    # -- availability ------------------------------------------------------

    def minimum_to_decode(self, want_to_read: Sequence[int],
                          available: Sequence[int]) -> set[int]:
        """Smallest chunk set from `available` able to produce
        `want_to_read` (MDS default: any k, wanted ones first)."""
        avail = set(available)
        want = set(want_to_read)
        n = self.get_chunk_count()
        bad = [i for i in want | avail if not 0 <= i < n]
        if bad:
            raise ValueError(f"chunk ids must be in [0, {n}), got {sorted(bad)}")
        if want - avail:
            need = want & avail
            rest = sorted(avail - want)
            need.update(rest[:max(0, self.k - len(need))])
            if len(need) < self.k:
                raise ValueError(
                    f"cannot decode {sorted(want)} from {sorted(avail)}: "
                    f"only {len(avail)} chunks available, need {self.k}")
            return need
        return want

    def minimum_to_decode_with_cost(self, want_to_read: Sequence[int],
                                    available: Mapping[int, int]) -> set[int]:
        """Like minimum_to_decode but with per-chunk read costs; default
        picks the k cheapest."""
        want = set(want_to_read)
        avail = set(available)
        n = self.get_chunk_count()
        bad = [i for i in want | avail if not 0 <= i < n]
        if bad:
            raise ValueError(f"chunk ids must be in [0, {n}), got {sorted(bad)}")
        if want - avail:
            ordered = sorted(avail, key=lambda c: (available[c], c))
            need = set(ordered[:self.k])
            if len(need) < self.k:
                raise ValueError("not enough chunks")
            return need
        return want

    # -- byte-level encode/decode -----------------------------------------

    def encode(self, want_to_encode: Sequence[int],
               data) -> dict[int, torch.Tensor]:
        """Full-object encode: pad to stripe width, split into k data
        chunks, compute parity, return the requested chunk ids.

        data: bytes or (object_bytes,) uint8, or (batch, object_bytes).
        Returns {chunk_id: (batch, chunk_size) uint8} (batch dim kept
        unless data was 1-D).
        """
        n_chunks = self.get_chunk_count()
        bad = [i for i in want_to_encode if not 0 <= i < n_chunks]
        if bad:
            raise ValueError(
                f"chunk ids must be in [0, {n_chunks}), got {sorted(bad)}")
        arr = self.as_chunks(data)
        squeeze = arr.ndim == 1
        if squeeze:
            arr = arr[None, :]
        b, n = arr.shape
        cs = self.get_chunk_size(n)
        padded = torch.zeros((b, self.k * cs), dtype=torch.uint8,
                             device=self.device)
        padded[:, :n] = arr
        chunks = padded.reshape(b, self.k, cs)
        coded = self.encode_chunks(chunks)  # (b, m, cs)
        full = {i: chunks[:, i, :] for i in range(self.k)}
        full.update({self.k + i: coded[:, i, :] for i in range(self.m)})
        out = {i: full[i] for i in want_to_encode}
        if squeeze:
            out = {i: v[0] for i, v in out.items()}
        return out

    @abc.abstractmethod
    def encode_chunks(self, data) -> torch.Tensor:
        """(batch, k, L) data chunks -> (batch, m, L) coding chunks."""

    def decode(self, want_to_read: Sequence[int],
               chunks: Mapping[int, object]) -> dict[int, torch.Tensor]:
        """Reconstruct `want_to_read` chunk ids from available `chunks`:
        wanted chunks that are present pass through, the rest go to
        decode_chunks."""
        out: dict[int, torch.Tensor] = {}
        missing = []
        for i in want_to_read:
            if i in chunks:
                out[i] = self.as_chunks(chunks[i])
            else:
                missing.append(i)
        if missing:
            out.update(self.decode_chunks(missing, chunks))
        return out

    @abc.abstractmethod
    def decode_chunks(self, want_to_read: Sequence[int],
                      chunks: Mapping[int, object]
                      ) -> dict[int, torch.Tensor]:
        """Reconstruct the (erased) `want_to_read` ids from `chunks`."""

    def decode_concat(self, chunks: Mapping[int, object],
                      object_size: int | None = None) -> torch.Tensor:
        """Recover and concatenate the data chunks, trimming padding if
        object_size is given."""
        rec = self.decode(list(range(self.k)), chunks)
        out = torch.cat([rec[i] for i in range(self.k)], dim=-1)
        if object_size is not None:
            out = out[..., :object_size]
        return out


def profile_from_string(s: str) -> ErasureCodeProfile:
    """Parse 'k=8 m=3 plugin=tpu technique=reed_sol_van' profile strings."""
    out: ErasureCodeProfile = {}
    for tok in s.split():
        if "=" not in tok:
            raise ValueError(f"bad profile token {tok!r}")
        key, val = tok.split("=", 1)
        out[key] = val
    return out
