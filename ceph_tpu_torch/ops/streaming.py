"""Chunk-dim tiling — stream stripes bigger than device memory.

Twin of ceph_tpu/ops/streaming.py. GF codecs are positionwise over the
byte axis: parity byte i depends only on data bytes i across shards, so
a stripe of any length streams through the codec tile by tile with
bit-exact results. Both entry points serve encode and decode alike: the
matrix is any static GF matrix (coding or inverted decode matrix), and
each tile is one `apply_matrix` (the hand GF kernel by default).

* `make_tiled_encoder` — a (B, k, L) tensor already on the device, L a
  multiple of the tile: one apply per tile view into one output.
* `StreamingCodec` — host-resident stripes (bigger than the card's
  memory): tiles staged through a ring of `depth` pinned host buffers,
  copied to the card on a side stream ordered against the launch by
  CUDA events, the parity copied back into pinned buffers on another
  side stream and from there into the caller's `out`, one tile behind.
  On the CPU (device="cpu") the same tiles run the plain version.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ec.interface import resolve_device
from .rs_kernels import DEFAULT_IMPL, apply_matrix


def make_tiled_encoder(matrix: np.ndarray, impl: str = DEFAULT_IMPL,
                       tile: int = 1 << 20):
    """(B, k, L) uint8 -> (B, m, L) uint8 on the data's device, one
    apply per tile of the chunk axis. L must be a multiple of `tile`
    (the stripe layer already pads chunks to alignment)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    m, k = matrix.shape
    tile = int(tile)

    def enc(data) -> torch.Tensor:
        data = torch.as_tensor(data, dtype=torch.uint8)
        B, kk, L = data.shape
        if kk != k:
            raise ValueError(f"data has {kk} shards, matrix wants {k}")
        if L % tile:
            raise ValueError(f"chunk len {L} not a multiple of "
                             f"tile {tile}")
        out = torch.empty((B, m, L), dtype=torch.uint8, device=data.device)
        for off in range(0, L, tile):
            out[:, :, off:off + tile] = apply_matrix(
                matrix, data[:, :, off:off + tile], impl)
        return out

    return enc


class StreamingCodec:
    """Host-resident stripes streamed tile-by-tile through the device.

    encode(data) accepts a HOST (B, k, L) uint8 array of any L and
    returns host (B, m, L) parity without ever holding more than `depth`
    tiles on the device. Every tile has the fixed shape (B, k, tile):
    the ragged tail is zero-padded in its staging buffer (padding
    encodes to padding for any linear code, so the tail slice of the
    output is exact).
    """

    def __init__(self, matrix: np.ndarray, impl: str = DEFAULT_IMPL,
                 tile: int = 1 << 20, depth: int = 2, perf=None,
                 device=None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        self.m, self.k = self.matrix.shape
        self.impl = impl
        self.tile = int(tile)
        self.depth = depth  # tiles in flight (double buffering = 2)
        self.device = resolve_device(device)
        # optional instrumentation: a PerfCounters with
        # stream_launches / stream_bytes / stream_drain_time declared
        # (the daemon's "ec" logger fits; None = uncounted)
        self.perf = perf
        self._ring: dict | None = None      # the card's staging, by B
        self._pad: np.ndarray | None = None  # the CPU path's tail buffer

    def encode(self, data: np.ndarray, out: np.ndarray | None = None
               ) -> np.ndarray:
        data = np.asarray(data)
        if data.ndim != 3 or data.shape[1] != self.k \
                or data.dtype != np.uint8:
            raise ValueError(
                f"want (B, {self.k}, L) uint8, got "
                f"{data.shape} {data.dtype}")
        B, _, L = data.shape
        if out is None:
            out = np.empty((B, self.m, L), dtype=np.uint8)
        elif out.shape != (B, self.m, L) or out.dtype != np.uint8:
            raise ValueError(f"out must be ({B}, {self.m}, {L}) uint8")
        if self.device.type == "cuda":
            self._encode_card(data, out)
        else:
            self._encode_plain(data, out)
        return out

    def _count(self, nbytes: int) -> None:
        if self.perf is not None:
            self.perf.inc_many((("stream_launches", 1),
                                ("stream_bytes", nbytes)))

    def _drain_timer(self):
        if self.perf is None:
            return contextlib.nullcontext()
        return self.perf.time("stream_drain_time")

    def _tiles(self, L: int):
        for ti in range(max(1, -(-L // self.tile))):
            off = ti * self.tile
            yield ti, off, min(self.tile, L - off)

    def _encode_plain(self, data: np.ndarray, out: np.ndarray) -> None:
        B, tl = data.shape[0], self.tile
        for _ti, off, ln in self._tiles(data.shape[2]):
            src = data[:, :, off:off + tl]
            if ln < tl:  # ragged tail: one reused zero-padded buffer
                if self._pad is None or self._pad.shape != (B, self.k, tl):
                    self._pad = np.zeros((B, self.k, tl), dtype=np.uint8)
                else:
                    self._pad[:, :, ln:] = 0
                self._pad[:, :, :ln] = src
                src = self._pad
            res = apply_matrix(self.matrix, torch.from_numpy(
                np.ascontiguousarray(src)).to(self.device), self.impl)
            self._count(int(src.size))
            with self._drain_timer():
                out[:, :, off:off + ln] = res[:, :, :ln].cpu().numpy()

    def _staging(self, B: int) -> dict:
        """Pinned host buffers, device input buffers, two side streams
        and the ring's events, made once per batch size."""
        if self._ring is None or self._ring["B"] != B:
            dev, tl, n = self.device, self.tile, self.depth
            self._ring = {
                "B": B,
                "host_in": [torch.empty((B, self.k, tl), dtype=torch.uint8,
                                        pin_memory=True) for _ in range(n)],
                "host_out": [torch.empty((B, self.m, tl), dtype=torch.uint8,
                                         pin_memory=True) for _ in range(n)],
                "dev_in": [torch.empty((B, self.k, tl), dtype=torch.uint8,
                                       device=dev) for _ in range(n)],
                "h2d": torch.cuda.Stream(dev), "d2h": torch.cuda.Stream(dev),
                # per slot: its upload done, its launch done (dev_in free
                # again), its download done (host_out readable)
                "up": [torch.cuda.Event() for _ in range(n)],
                "ran": [torch.cuda.Event() for _ in range(n)],
                "down": [torch.cuda.Event() for _ in range(n)],
            }
        return self._ring

    def _encode_card(self, data: np.ndarray, out: np.ndarray) -> None:
        B, tl, n = data.shape[0], self.tile, self.depth
        r = self._staging(B)
        main = torch.cuda.current_stream(self.device)
        inflight: list[tuple[int, int, int]] = []     # (slot, off, len)

        def drain(slot: int, off: int, ln: int) -> None:
            with self._drain_timer():
                r["down"][slot].synchronize()
                out[:, :, off:off + ln] = r["host_out"][slot][:, :, :ln] \
                    .numpy()

        for ti, off, ln in self._tiles(data.shape[2]):
            slot = ti % n
            hin = r["host_in"][slot]
            # the slot's previous upload must be done before its pinned
            # buffer is written again
            r["up"][slot].synchronize()
            hv = hin.numpy()
            hv[:, :, :ln] = data[:, :, off:off + ln]
            if ln < tl:  # ragged tail: zero-padded in its staging slot
                hv[:, :, ln:] = 0
            dev_in = r["dev_in"][slot]
            with torch.cuda.stream(r["h2d"]):
                # dev_in is free once the launch that read it has run
                r["h2d"].wait_event(r["ran"][slot])
                dev_in.copy_(hin, non_blocking=True)
                r["up"][slot].record(r["h2d"])
            main.wait_event(r["up"][slot])
            res = apply_matrix(self.matrix, dev_in, self.impl)
            r["ran"][slot].record(main)
            self._count(int(hin.numel()))
            with torch.cuda.stream(r["d2h"]):
                r["d2h"].wait_event(r["ran"][slot])
                r["host_out"][slot].copy_(res, non_blocking=True)
                res.record_stream(r["d2h"])
                r["down"][slot].record(r["d2h"])
            inflight.append((slot, off, ln))
            if len(inflight) >= n:
                drain(*inflight.pop(0))
        while inflight:
            drain(*inflight.pop(0))
