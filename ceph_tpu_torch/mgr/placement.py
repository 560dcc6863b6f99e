"""Placement plane — the device-batched balancer/upmap loop.

Twin of ceph_tpu/mgr/placement.py. The scalar balancer
(`balancer.calc_pg_upmaps`, kept as the parity oracle) walks PGs one at
a time in Python; this module runs the same greedy max-deviation
optimization over arrays:

* ONE batched `pgs_to_raw` pass per optimize() call maps every PG of
  the pool through the vectorized CRUSH mapper on the OSDMap's device
  (chunked, so that every launch has the same lane count). The raw
  mapping is invariant under upmap edits, so rounds after the first
  re-score against a host-side effective view.
* Candidate generation is vectorized on the host: every (pg, src_osd)
  shard held by an overfull device crossed with the most-underfull
  target set.
* Scoring runs on the OSDMap's device (`score_candidates`): legality
  (target not already a member, failure-domain separation at the pool
  rule's chooseleaf type) and gain (deviation transfer) for the whole
  (N candidates x U targets) block, and its top `topk` targets per
  candidate, in one launch of the hand kernel `csrc/placement.cu` on
  the card (its plain torch version on the CPU). The kernel walks each
  row's targets in deviation order and stops once its top k are
  settled; `score_visits_plain` counts what that walk visits.
* Selection is a cheap host greedy over the device-ranked survivors,
  bounded by a DATA-MOVEMENT BUDGET (each accepted move migrates one
  PG shard).

Objective and legality match the scalar oracle: weight-proportional
expected load over up+in devices, moves only from overfull to
strictly-better targets (gain = dev[src] - dev[dst] - 1 > 0), domain
membership derived from the RAW set plus redirect targets (a
down-but-in member still owns its slot). The host code is the twin's
line for line; tests/test_torch_placement.py holds the results equal.
"""

from __future__ import annotations

import ctypes
import math
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..crush.map import CRUSH_ITEM_NONE
from ..utils import nvcc
from .balancer import _domain_of, _rule_domain_type

_NONE = np.int32(CRUSH_ITEM_NONE)
# the domain id masked-out member slots take: no real domain id can
# hold it (bucket ids are small negatives; -1 is a REAL bucket, and
# osd_domains' no-ancestor ids stay above -(10^7 + n_osds))
MASKED_DOMAIN = -(2 ** 31) + 1
MAX_TOPK = 8          # the kernel keeps 8 ranked targets a candidate
MAX_SLOTS = 32        # 2S: raw + effective set of a PG of size <= 16
# the most targets the kernel's walk instance stages in shared memory;
# above it the exhaustive scan instance runs (placement.cu's kMaxWalk,
# which _load checks)
WALK_MAX_TARGETS = 4096

_SRC = Path(__file__).resolve().parent / "csrc" / "placement.cu"
_lib = None
_lib_lock = threading.Lock()
# launches of the scorer kernel (score_candidates on CUDA tensors), in
# all and by instance
launches = 0
instance_launches = {"walk": 0, "scan": 0}


def osd_domains(crush, type_id: int, n_osds: int) -> np.ndarray:
    """Per-device failure-domain id at bucket level `type_id` — the
    dense form of balancer._domain_of for every OSD at once. Devices
    with no ancestor at that level get a unique negative id (they can
    never clash with anything)."""
    dom = np.empty(n_osds, dtype=np.int32)
    cache: dict = {}
    for o in range(n_osds):
        d = _domain_of(crush, o, type_id, cache)
        # no-ancestor devices get unique ids far below any bucket id
        # (bucket ids are small negatives) but above the kernel's
        # masked-slot sentinel
        dom[o] = d if d is not None else -(10 ** 7) - o
    return dom


def chunked_pgs_to_raw(osdmap, pool_id: int,
                       chunk: int = 1 << 16) -> np.ndarray:
    """Full-pool raw mapping through fixed-size device launches: every
    launch maps `chunk` lanes, whatever pg_num is, so no intermediate
    of a 1M-lane batch is ever live at once."""
    pool = osdmap.pools[pool_id]
    B = pool.pg_num
    if B <= chunk:
        return osdmap.pgs_to_raw(pool_id)
    out = np.empty((B, pool.size), np.int32)
    for s in range(0, B, chunk):
        n = min(chunk, B - s)
        ps = np.arange(s, s + chunk, dtype=np.uint32)  # pad past pg_num
        ps[n:] = s  # padded lanes recompute a real pg; result sliced off
        out[s:s + n] = osdmap.pgs_to_raw(pool_id, ps)[:n]
    return out


def apply_upmaps_to_raw(raw: np.ndarray, pool_id: int,
                        pg_upmap_items: dict) -> np.ndarray:
    """Effective placement: raw with every pg_upmap_items redirect
    applied (same semantics as OSDMap._apply_upmap, vectorized over
    the dense raw array with a sparse host overlay — upmaps are rare
    relative to pg_num)."""
    eff = raw.copy()
    B = raw.shape[0]
    for (pid, ps), items in pg_upmap_items.items():
        if pid != pool_id or ps >= B:
            continue
        row = eff[ps]
        for frm, to in items:
            if (row == to).any():
                continue  # a duplicate target would break slot sets
            hits = np.nonzero(row == frm)[0]
            if hits.size:
                row[hits[0]] = to
    return eff


# ------------------------------------------------------------ the scorer

def score_candidates_plain(members: torch.Tensor, src: torch.Tensor,
                           dsts: torch.Tensor, dev: torch.Tensor,
                           dom: torch.Tensor, topk: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scorer in torch ops, the twin's `_score_kernel` expression by
    expression: the CPU path, and the card kernel's yardstick.

    members: (N, 2S) int32 raw-set + effective-set of each candidate's
    PG (CRUSH_ITEM_NONE padding); src: (N,) int32 the overfull device
    each candidate would move a shard off; dsts: (U,) int32 target
    devices; dev: (n_osds,) float32 load deviation; dom: (n_osds,)
    int32 failure-domain ids at the rule's separation level.

    Returns (best (N, topk) int32, score (N, topk) float32): per
    candidate the indices into dsts of the topk highest-gain LEGAL
    targets, score -inf past the legal count, in `lax.top_k`'s order:
    XLA's total order of floats (a NaN with its sign bit set below
    -inf, one without above +inf; `torch.sort` ranks every NaN above
    every number), ties to the lower index and -inf slots in index
    order (a stable descending sort of `_order_key`; `torch.topk`
    orders ties otherwise). Legality:
    target not already a member of the PG, and its failure domain
    serves no OTHER shard (the source device's own occurrences are
    masked out)."""
    valid = (members != CRUSH_ITEM_NONE) & (members != src[:, None])
    midx = members.clamp(0, dom.shape[0] - 1).long()
    mdom = torch.where(valid, dom[midx],
                       torch.tensor(MASKED_DOMAIN, dtype=dom.dtype,
                                    device=dom.device))       # (N, 2S)
    ddom = dom[dsts.long()]                                   # (U,)
    clash = (mdom[:, :, None] == ddom[None, None, :]).any(dim=1)
    member = (members[:, :, None] == dsts[None, None, :]).any(dim=1)
    gain = dev[src.long()][:, None] - dev[dsts.long()][None, :] - 1.0
    score = torch.where(clash | member | (gain <= 0.0),
                        torch.tensor(float("-inf"), dtype=gain.dtype,
                                     device=gain.device), gain)
    best = torch.sort(_order_key(score), dim=1, descending=True,
                      stable=True).indices[:, :topk]
    return best.to(torch.int32), score.gather(1, best)


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving bits of float32 `x` as int64: IEEE 754's total
    order (-NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN), the key of
    the kernel's sort and of its NaN-aware ranking."""
    bits = x.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                       bits | 0x80000000)


def score_visits_plain(members: torch.Tensor, src: torch.Tensor,
                       dsts: torch.Tensor, dev: torch.Tensor,
                       dom: torch.Tensor, topk: int) -> torch.Tensor:
    """The work the kernel does for each row, in torch ops: (N,) int32,
    the targets whose legality it tests plus the checks of its -inf
    fill (what `score_candidates(..., visits=)` writes on the card).

    The walk instance (U <= WALK_MAX_TARGETS) visits the targets in
    (dev[dsts[u]] ascending, u ascending) order, along which a row's
    gain never increases, and stops before the first target whose gain
    is <= 0, or is strictly below the topk-th legal gain once topk
    legal entries are held. A row with c < topk legal entries then
    checks u = 0, 1, ... until it has found topk - c that hold none.
    Rows whose dev[src] is not finite, every row when some dev[dsts]
    is not finite, and every row of the scan instance (U above the cap)
    visit all U targets."""
    N, U = members.shape[0], dsts.shape[0]
    full = torch.full((N,), U, dtype=torch.int32, device=members.device)
    ddev = dev[dsts.long()]
    if U > WALK_MAX_TARGETS or not bool(torch.isfinite(ddev).all()):
        return full
    dsrc = dev[src.long()]
    valid = (members != CRUSH_ITEM_NONE) & (members != src[:, None])
    mdom = torch.where(valid, dom[members.clamp(0, dom.shape[0] - 1).long()],
                       torch.tensor(MASKED_DOMAIN, dtype=dom.dtype,
                                    device=dom.device))
    order = torch.sort(_order_key(ddev), stable=True).indices
    wd = dsts[order]                                       # walk order
    legal = ~((mdom[:, :, None] == dom[wd.long()][None, None, :]).any(1)
              | (members[:, :, None] == wd[None, None, :]).any(1))
    gain = dsrc[:, None] - ddev[order][None, :] - 1.0      # (N, U)
    pos = torch.arange(U, device=members.device)
    ok = legal & (gain > 0.0)
    cnt = torch.cumsum(ok, dim=1, dtype=torch.int32)
    # the walk's stops: the first gain <= 0; once the topk-th legal
    # entry (at jk) is held, the first later gain strictly below its gain
    stop = torch.where(gain <= 0.0, pos, U).amin(dim=1)
    jk = torch.where(cnt >= topk, pos, U).amin(dim=1)
    kth = gain.gather(1, jk.clamp(max=U - 1)[:, None])
    later = (pos[None, :] > jk[:, None]) & (gain < kth)
    stop = torch.minimum(stop, torch.where(later, pos, U).amin(dim=1))
    held = torch.where(stop > 0, cnt.gather(
        1, (stop - 1).clamp(min=0)[:, None])[:, 0], 0)
    # the fill: u = 0, 1, ... examined until topk - held of them hold no
    # legal entry (with held < topk the walk has met every legal entry)
    need = (topk - held).clamp(min=0)
    free = torch.cumsum(~ok[:, torch.argsort(order)], dim=1,
                        dtype=torch.int32)                 # index order
    fill = torch.where(free >= need[:, None], pos, U).amin(dim=1) + 1
    visits = stop + torch.where(need > 0, fill, 0)
    return torch.where(torch.isfinite(dsrc), visits.to(torch.int32), full)


def build() -> Path:
    """Compile placement.cu into the build directory (once per source
    content) and return the shared library's path. Raises on a failed
    build."""
    return nvcc.build(_SRC)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.score_candidates.argtypes = [P, P, P, P, P, I, I, I, I, I,
                                             P, P, P]
            lib.score_candidates.restype = I
            lib.score_candidates_visits.argtypes = [P, P, P, P, P, I, I, I,
                                                    I, I, P, P, P, P]
            lib.score_candidates_visits.restype = I
            lib.score_walk_max_targets.argtypes = []
            lib.score_walk_max_targets.restype = I
            if lib.score_walk_max_targets() != WALK_MAX_TARGETS:
                raise RuntimeError(
                    f"placement.cu stages {lib.score_walk_max_targets()} "
                    f"targets, placement.py expects {WALK_MAX_TARGETS}")
            _lib = lib
    return _lib


def _check(members, src, dsts, dev, dom, topk) -> None:
    N, S2 = members.shape
    if members.dtype != torch.int32 or src.dtype != torch.int32 \
            or dsts.dtype != torch.int32 or dom.dtype != torch.int32 \
            or dev.dtype != torch.float32:
        raise ValueError("score_candidates takes int32 members, src, dsts "
                         "and dom and float32 dev")
    if src.shape != (N,) or dsts.ndim != 1 or dev.ndim != 1 \
            or dom.shape != dev.shape:
        raise ValueError(f"shapes: members {tuple(members.shape)}, src "
                         f"{tuple(src.shape)}, dsts {tuple(dsts.shape)}, "
                         f"dev {tuple(dev.shape)}, dom {tuple(dom.shape)}")
    if not 1 <= topk <= min(MAX_TOPK, dsts.shape[0]):
        raise ValueError(f"topk {topk} not in 1..min({MAX_TOPK}, U="
                         f"{dsts.shape[0]})")
    if not 1 <= S2 <= MAX_SLOTS:
        raise ValueError(f"{S2} member slots; the kernel takes 1 to "
                         f"{MAX_SLOTS}")
    devs = {t.device for t in (members, src, dsts, dev, dom)}
    if len(devs) != 1:
        raise ValueError(f"score_candidates: tensors on {sorted(map(str, devs))}")


def score_candidates(members: torch.Tensor, src: torch.Tensor,
                     dsts: torch.Tensor, dev: torch.Tensor,
                     dom: torch.Tensor, topk: int,
                     visits: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Score the (N, U) candidate block (see `score_candidates_plain`
    for the function). CUDA tensors launch the hand kernel, each launch
    counted in the module's `launches` and, by the instance that ran, in
    `instance_launches` ("walk" for U <= WALK_MAX_TARGETS, else
    "scan"); CPU tensors run the plain version; any other device raises.

    `visits`, an (N,) int32 tensor on the same device, receives each
    row's work: on the card the kernel's own count, on the CPU
    `score_visits_plain`'s."""
    global launches
    _check(members, src, dsts, dev, dom, topk)
    device = members.device
    N, S2 = members.shape
    if visits is not None and (visits.shape != (N,)
                               or visits.dtype != torch.int32
                               or visits.device != device
                               or not visits.is_contiguous()):
        raise ValueError("visits must be a contiguous (N,) int32 tensor "
                         "on the scorer's device")
    if device.type == "cpu":
        if visits is not None:
            visits.copy_(score_visits_plain(members, src, dsts, dev, dom,
                                            topk))
        return score_candidates_plain(members, src, dsts, dev, dom, topk)
    if device.type != "cuda":
        raise ValueError(f"score_candidates runs on cuda or cpu tensors, "
                         f"got {device}")
    members, src, dsts, dev, dom = (t.contiguous() for t in
                                    (members, src, dsts, dev, dom))
    best = torch.empty((N, topk), dtype=torch.int32, device=device)
    score = torch.empty((N, topk), dtype=torch.float32, device=device)
    lib = _load()
    args = (members.data_ptr(), src.data_ptr(), dsts.data_ptr(),
            dev.data_ptr(), dom.data_ptr(), N, S2, dsts.shape[0],
            dev.shape[0], topk, best.data_ptr(), score.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if visits is None:
            rc = lib.score_candidates(*args, stream)
        else:
            rc = lib.score_candidates_visits(*args, visits.data_ptr(),
                                             stream)
    if rc != 0:
        raise RuntimeError(f"score_candidates launch failed: cudaError "
                           f"{rc} (N={N}, 2S={S2}, U={dsts.shape[0]})")
    launches += 1
    instance_launches["walk" if dsts.shape[0] <= WALK_MAX_TARGETS
                      else "scan"] += 1
    return best, score


def _pow2_pad(n: int) -> int:
    return 1 << max(6, (n - 1).bit_length())


@dataclass
class BalanceResult:
    """What one batched optimize() run did — the numbers scale_sim
    commits and the bench schema pins."""
    moves: list = field(default_factory=list)
    proposed: dict = field(default_factory=dict)
    rounds: int = 0
    candidates_scored: int = 0
    score_elapsed_s: float = 0.0
    elapsed_s: float = 0.0
    max_dev_before: float = 0.0
    max_dev_after: float = 0.0
    spread_before: int = 0
    spread_after: int = 0
    budget: int | None = None
    budget_used: int = 0
    converged: bool = False

    @property
    def candidates_per_s(self) -> float:
        if self.score_elapsed_s <= 0:
            return 0.0
        return self.candidates_scored / self.score_elapsed_s

    def to_dict(self) -> dict:
        return {
            "moves": len(self.moves), "rounds": self.rounds,
            "candidates_scored": self.candidates_scored,
            "candidates_per_s": round(self.candidates_per_s, 1),
            "score_elapsed_s": round(self.score_elapsed_s, 4),
            "elapsed_s": round(self.elapsed_s, 4),
            "max_dev_before": round(self.max_dev_before, 3),
            "max_dev_after": round(self.max_dev_after, 3),
            "spread_before": self.spread_before,
            "spread_after": self.spread_after,
            "budget": self.budget, "budget_used": self.budget_used,
            "converged": self.converged,
        }


def telemetry_movement_budget(telemetry, base_budget: int,
                              pool_id: int = 1,
                              p99_ceiling_s: float | None = None) -> int:
    """Movement budget derived from live client latency: the base
    budget shrinks linearly with the telemetry plane's hottest
    fast-window SLO burn rate (rebalancing yields to suffering traffic;
    a fully burning SLO stops movement entirely), and `p99_ceiling_s`
    adds a rule-free guard — when the observed_client_latency feed's
    p99 exceeds it, movement stops regardless of declared rules.

    telemetry is a TelemetryAggregator (or None: the base budget
    passes through — offline tools without a live feed keep their old
    semantics)."""
    if telemetry is None or base_budget is None:
        return base_budget
    burn = float(telemetry.burn_rate())
    if p99_ceiling_s is not None:
        ocl = telemetry.observed_client_latency(pool_id)
        if ocl.get("count") and ocl.get("p99_ms", 0.0) / 1e3 \
                > p99_ceiling_s:
            burn = 1.0
    return max(0, int(base_budget * (1.0 - min(1.0, burn))))


def batch_calc_pg_upmaps(osdmap, pool_id: int, max_deviation: int = 1,
                         max_movement: int | None = None,
                         max_src: int = 64, max_dst: int = 64,
                         max_rounds: int = 256, chunk: int = 1 << 16,
                         apply: bool = True,
                         raw: np.ndarray | None = None,
                         telemetry=None,
                         p99_ceiling_s: float | None = None
                         ) -> BalanceResult:
    """One device-batched optimization run over a whole pool, on the
    OSDMap's device (the card unless the map was built with
    device="cpu").

    max_movement is the data-movement budget in PG shards (each move
    migrates one shard's worth of data); None = unbounded. Pass a
    precomputed `raw` (chunked_pgs_to_raw) to skip the mapping pass.

    telemetry: a TelemetryAggregator whose SLO burn rate / observed
    client latency SHRINKS the movement budget before the run
    (telemetry_movement_budget). Requires max_movement (an unbounded
    run has no budget to shrink).

    Returns a BalanceResult; with apply=True the winning upmap set is
    landed on the map as ONE epoch (set_pg_upmap_bulk).
    """
    if telemetry is not None and max_movement is not None:
        max_movement = telemetry_movement_budget(
            telemetry, max_movement, pool_id=pool_id,
            p99_ceiling_s=p99_ceiling_s)
    t_all = time.monotonic()
    crush = osdmap.crush
    pool = osdmap.pools[pool_id]
    n_osds = len(osdmap.osd_weight)
    device = osdmap.device
    dom = osd_domains(crush, _rule_domain_type(crush, pool.crush_rule),
                      n_osds)
    if raw is None:
        raw = chunked_pgs_to_raw(osdmap, pool_id, chunk)
    items_now = {pg: list(v) for pg, v in osdmap.pg_upmap_items.items()
                 if pg[0] == pool_id}
    eff = apply_upmaps_to_raw(raw, pool_id, items_now)

    res = BalanceResult(budget=max_movement)
    up_mask = np.asarray(osdmap.osd_up)
    usable = up_mask & (np.asarray(osdmap.osd_weight) > 0)
    if usable.sum() < 2:
        res.elapsed_s = time.monotonic() - t_all
        return res
    w = np.asarray(osdmap.osd_weight, dtype=np.float64) / 0x10000
    wsum = w[usable].sum()

    def histo():
        flat = eff[(eff != _NONE) & up_mask[np.clip(eff, 0, n_osds - 1)]
                   & (eff >= 0)]
        return np.bincount(flat, minlength=n_osds).astype(np.float64)

    load = histo()
    expected = np.zeros(n_osds)
    expected[usable] = load[usable].sum() * w[usable] / wsum
    dev = np.where(usable, load - expected, 0.0)

    def spread():
        d = dev[usable]
        return float(d.max() - d.min()), float(np.abs(d).max())

    res.spread_before = int(round(spread()[0]))
    res.max_dev_before = spread()[1]
    touched: dict = {}
    dom_dev = torch.as_tensor(dom, device=device)  # int32 domain ids

    for _round in range(max_rounds):
        sp, _ = spread()
        if sp <= max_deviation:
            res.converged = True
            break
        if max_movement is not None and res.budget_used >= max_movement:
            break
        order = np.argsort(-dev)
        srcs = [int(o) for o in order[:max_src]
                if usable[o] and dev[o] > 0][:max_src]
        under = np.argsort(dev)
        dsts = np.asarray([int(o) for o in under[:max_dst]
                           if usable[o]], dtype=np.int32)
        if not srcs or dsts.size == 0:
            break
        t0 = time.monotonic()
        # every (pg, slot) shard currently on an overfull device
        src_of = np.full(n_osds, -1, dtype=np.int32)
        src_of[srcs] = np.arange(len(srcs))
        eff_c = np.clip(eff, 0, n_osds - 1)
        # NONE is a large POSITIVE sentinel: clip would alias it onto
        # the last device, minting phantom candidates
        hit = (eff != _NONE) & (eff >= 0) & (src_of[eff_c] >= 0)
        pg_idx, slot_idx = np.nonzero(hit)
        if pg_idx.size == 0:
            break
        src_arr = eff[pg_idx, slot_idx].astype(np.int32)
        members = np.concatenate([raw[pg_idx], eff[pg_idx]], axis=1)
        # pad N to a pow2 bucket, as the twin does for its compiled
        # program: padded rows (NONE members, src 0) go through the
        # same code and are sliced off
        N = pg_idx.size
        Np = _pow2_pad(N)
        if Np != N:
            members = np.concatenate(
                [members, np.full((Np - N, members.shape[1]), _NONE,
                                  np.int32)])
            src_arr = np.concatenate(
                [src_arr, np.zeros(Np - N, np.int32)])
        topk = int(min(8, dsts.size))
        # dev cast to float32 on the host, as the twin's jnp.asarray
        best, score = score_candidates(
            torch.as_tensor(members, device=device),
            torch.as_tensor(src_arr, device=device),
            torch.as_tensor(dsts, device=device),
            torch.as_tensor(dev.astype(np.float32), device=device),
            dom_dev, topk)
        best = best.cpu().numpy()[:N]               # (N, topk)
        score = score.cpu().numpy()[:N]
        res.candidates_scored += N * int(dsts.size)
        res.score_elapsed_s += time.monotonic() - t0

        moved_pgs: set[int] = set()
        accepted = 0
        # the walk below visits up to N candidates one at a time: it
        # reads Python lists (the same float64 and float32 values, so
        # the same comparisons) where numpy's scalar indexing would
        # cost ten times as much a step; devl follows dev
        order = np.argsort(-score[:, 0]).tolist()
        score_l, best_l = score.tolist(), best.tolist()
        pg_l, src_l, dsts_l = pg_idx.tolist(), src_arr.tolist(), \
            dsts.tolist()
        devl = dev.tolist()
        for ci in order:
            row = score_l[ci]
            if not math.isfinite(row[0]):
                break
            if max_movement is not None \
                    and res.budget_used >= max_movement:
                break
            ps = pg_l[ci]
            if ps in moved_pgs:
                continue
            src = src_l[ci]
            # devs moved under us this round: walk this candidate's
            # ranked legal targets for the first whose gain survives.
            # Sign guards keep the movement budget honest: a shard
            # must leave a device still ABOVE target for one still
            # BELOW it, so every accepted move shrinks sum|dev|
            if devl[src] <= 0:
                continue
            dst = -1
            for k in range(topk):
                if not math.isfinite(row[k]):
                    break
                cand = dsts_l[best_l[ci][k]]
                if devl[cand] < 0 and devl[src] - devl[cand] > 1.0:
                    dst = cand
                    break
            if dst < 0:
                continue
            pg = (pool_id, ps)
            items = touched.get(pg, items_now.get(pg, []))
            raw_row = raw[ps]
            if (raw_row == src).any():
                new_items = list(items) + [(src, dst)]
            else:
                act = [f for f, t in items
                       if t == src and (raw_row == f).any()]
                if not act:
                    continue  # inactive redirect: wrong shard
                new_items = [(f, t) for f, t in items
                             if (f, t) != (act[0], src)]
                new_items.append((act[0], dst))
            slot = int(np.nonzero(eff[ps] == src)[0][0])
            eff[ps, slot] = dst
            touched[pg] = new_items
            res.moves.append((pg, (src, dst)))
            moved_pgs.add(ps)
            res.budget_used += 1
            accepted += 1
            load[src] -= 1
            load[dst] += 1
            dev[src] = load[src] - expected[src]
            dev[dst] = load[dst] - expected[dst]
            devl[src], devl[dst] = float(dev[src]), float(dev[dst])
        res.rounds += 1
        if accepted == 0:
            break

    sp, mx = spread()
    res.spread_after = int(round(sp))
    res.max_dev_after = mx
    res.converged = res.converged or sp <= max_deviation
    res.proposed = touched
    if apply and touched:
        osdmap.set_pg_upmap_bulk(touched)
    res.elapsed_s = time.monotonic() - t_all
    return res
