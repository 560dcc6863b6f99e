"""Repair-locality planner — code-family-aware minimal-helper recovery.

The codecs have known HOW to repair cheaply for a while (LRC's local
groups, Clay's repair planes, SHEC's shingle windows), but the live
recovery and degraded-read paths asked only the generic availability
question ("which chunks decode this?") and then pulled FULL shards
from the answer. This module is the missing middle layer: per code
family it emits a `RepairPlan` naming the minimal helper set AND the
byte ranges each helper must ship, so the wire moves the bytes the
math actually needs — the repair-network-traffic problem of the
Facebook warehouse study (arxiv 1309.0186) and the regenerating-codes
bandwidth line (arxiv 1412.3022), where repair traffic, not decode
FLOPs, dominates rebuild cost at fleet scale.

Plan shapes per family (ref: the reference's per-plugin
minimum_to_decode overrides, src/erasure-code/*/ErasureCode*.cc):

* LRC   — single-shard loss repairs inside ONE local group
          (`_repair_plan`'s structural layer walk); a second loss in
          the same group breaks locality and the plan ladders to the
          wider/global layers automatically. Full rows, `row`
          integrity (the r10 whole-row hinfo fold).
* Clay  — single-shard loss reads only the `repair_plan_matrix`
          repair planes: beta = subchunks/q sub-chunks from each of d
          helpers (`range` integrity — see below). Multi-loss or
          degraded-below-d ladders to the coupled full decode.
* SHEC  — cost-ranked structural search over shingle windows
          (`minimum_to_decode_with_cost`); full rows.
* RS    — MDS default: k cheapest available chunks; full rows.

Integrity modes (the plan carries its own): `row` keeps the r10
whole-row CRC fold against stored hinfo. Sub-chunk reads break that
fold — the receiver never sees the whole helper row — so `range` mode
moves rot detection to the SOURCE (the helper checksums its full
shard against its stored hinfo before slicing) and ships range-level
crc32c over the planned bytes, which the receiver fold-verifies
exactly like r10 (CRC32C stays GF(2)-linear at any row length). The
rebuilt output is re-CRC'd and stamped into fresh hinfo either way.

Costs: `plan_repair`/`plan_read` accept a {chunk: cost} mapping (the
daemon feeds per-helper costs from its down/slow complaint memory and
peer-latency EWMAs) and route it into each family's
minimum_to_decode_with_cost, so helper selection prefers fast, trusted
sources instead of pretending reads are uniform.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

__all__ = ["RepairPlan", "plan_repair", "plan_read", "coalesce_ranges"]


def coalesce_ranges(ranges: Sequence[tuple[int, int]]
                    ) -> tuple[tuple[int, int], ...]:
    """Merge adjacent/overlapping (offset, length) pairs — fewer wire
    range entries for runs of contiguous repair planes."""
    out: list[list[int]] = []
    for off, ln in sorted((int(o), int(l)) for o, l in ranges):
        if out and off <= out[-1][0] + out[-1][1]:
            out[-1][1] = max(out[-1][1], off + ln - out[-1][0])
        else:
            out.append([off, ln])
    return tuple((o, l) for o, l in out)


@dataclass(frozen=True)
class RepairPlan:
    """One loss pattern's repair recipe: who ships what, verified how.

    helpers are chunk ids (= shard slots) in ascending order — the
    staging/stacking order every consumer (range decoder row layout,
    readv frames) relies on. `planes` names the sub-chunk indices each
    helper ships (identical across helpers for Clay, the only
    sub-chunk family); None means full rows."""

    family: str                      # "lrc_local" | "lrc_multi" |
    #                                  "clay_planes" | "clay_full" |
    #                                  "shec_cost" | "mds" | "direct"
    lost: tuple[int, ...]
    helpers: tuple[int, ...]
    planes: tuple[int, ...] | None   # sub-chunk ids per helper, or None
    sub_chunk_count: int             # q^t for clay; 1 otherwise
    integrity: str                   # "row" | "range"
    cost_ranked: bool = False        # helper pick consumed real costs

    @property
    def wire_fraction(self) -> float:
        """Fraction of each helper row that ships (beta/q^t for Clay,
        1.0 for full-row families) — the per-helper bandwidth saving."""
        if self.planes is None:
            return 1.0
        return len(self.planes) / self.sub_chunk_count

    def row_bytes(self, shard_len: int) -> int:
        """Bytes one helper ships for a shard of `shard_len` bytes."""
        if self.planes is None:
            return shard_len
        return len(self.planes) * (shard_len // self.sub_chunk_count)

    def ranges(self, shard_len: int) -> tuple[tuple[int, int], ...] | None:
        """The (offset, length) list each helper reads at this shard
        length (coalesced), or None for full-row plans."""
        if self.planes is None:
            return None
        P = self.sub_chunk_count
        if shard_len % P:
            raise ValueError(
                f"shard length {shard_len} not divisible into {P} "
                f"sub-chunks")
        s = shard_len // P
        return coalesce_ranges((z * s, s) for z in self.planes)

    def wire_bytes(self, shard_len: int, n_objects: int) -> int:
        """Total helper bytes on the wire for `n_objects` rebuilds."""
        return self.row_bytes(shard_len) * len(self.helpers) * n_objects


def _with_costs(coder, want, avail: set[int],
                costs: Mapping[int, int] | None) -> set[int]:
    """Route through minimum_to_decode_with_cost when costs are known
    (every family overrides it structurally where the MDS default's
    'k cheapest' could pick an undecodable set)."""
    if costs:
        table = {c: int(costs.get(c, 0)) for c in avail}
        return set(coder.minimum_to_decode_with_cost(sorted(want), table))
    return set(coder.minimum_to_decode(sorted(want), sorted(avail)))


def _plan_lrc(coder, lost: list[int], avail: set[int],
              costs: Mapping[int, int] | None) -> RepairPlan:
    """Structural layer walk (the codec's own `_repair_plan`): local
    when ONE small layer covers the loss, laddering to the wider
    layers when a second loss in the group breaks locality."""
    steps, reads, _ = coder._repair_plan(set(lost), avail, costs=costs)
    local = (len(steps) >= 1
             and all(layer.k < coder.k for layer, _missing in steps))
    return RepairPlan(
        family="lrc_local" if local else "lrc_multi",
        lost=tuple(lost), helpers=tuple(sorted(reads)),
        planes=None, sub_chunk_count=1, integrity="row",
        cost_ranked=bool(costs))


def _plan_clay(coder, lost: list[int], avail: set[int],
               costs: Mapping[int, int] | None) -> RepairPlan:
    """Single loss with >= d live helpers: the MSR repair planes —
    beta = q^(t-1) sub-chunks per helper. Anything else ladders to the
    coupled full decode over every survivor."""
    if len(lost) == 1 and len(avail) >= coder.d:
        helpers = coder._pick_helpers(lost[0], sorted(avail),
                                      costs=costs)
        return RepairPlan(
            family="clay_planes", lost=tuple(lost),
            helpers=tuple(sorted(helpers)),
            planes=tuple(coder._repair_planes(lost[0])),
            sub_chunk_count=coder.get_sub_chunk_count(),
            integrity="range", cost_ranked=bool(costs))
    need = _with_costs(coder, set(lost), avail, costs)
    return RepairPlan(
        family="clay_full", lost=tuple(lost),
        helpers=tuple(sorted(need - set(lost))),
        planes=None, sub_chunk_count=1, integrity="row",
        cost_ranked=bool(costs))


def plan_repair(coder, lost_chunks: Sequence[int],
                available: Sequence[int],
                costs: Mapping[int, int] | None = None) -> RepairPlan:
    """Plan the rebuild of `lost_chunks` from `available` survivors.

    Raises ValueError (before anyone moved a byte) when the survivors
    cannot reconstruct the loss — the same no-partial-state contract
    plan_recovery always had."""
    lost = sorted(int(c) for c in set(lost_chunks))
    avail = {int(c) for c in available} - set(lost)
    if not lost:
        return RepairPlan("direct", (), (), None, 1, "row")
    if hasattr(coder, "_repair_plan"):               # LRC layer stack
        return _plan_lrc(coder, lost, avail, costs)
    if hasattr(coder, "repair_plan_matrix"):         # Clay / MSR
        return _plan_clay(coder, lost, avail, costs)
    need = _with_costs(coder, set(lost), avail, costs)
    family = "shec_cost" if hasattr(coder, "windows") else "mds"
    return RepairPlan(
        family=family, lost=tuple(lost),
        helpers=tuple(sorted(need - set(lost))),
        planes=None, sub_chunk_count=1, integrity="row",
        cost_ranked=bool(costs))


def plan_read(coder, want: Sequence[int], available: Sequence[int],
              costs: Mapping[int, int] | None = None
              ) -> tuple[set[int], str]:
    """Read-path twin of plan_repair: the chunk set a (possibly
    degraded) read must gather to produce `want`, plus the family
    label for accounting. Chunks in `want` that are available read
    themselves; the missing ones are planned like a repair — so an LRC
    single-shard degraded read gathers its local group, not k shards."""
    want_s = {int(c) for c in want}
    avail = {int(c) for c in available}
    missing = want_s - avail
    if not missing:
        return set(want_s), "direct"
    rp = plan_repair(coder, sorted(missing), avail, costs=costs)
    return (want_s & avail) | set(rp.helpers), rp.family
