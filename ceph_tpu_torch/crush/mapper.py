"""Vectorized CRUSH mapper — crush_do_rule over a batch of PGs, as torch ops.

Twin of ceph_tpu/crush/mapper.py (ref: src/crush/mapper.c
crush_do_rule / crush_choose_{firstn,indep} / bucket_*_choose). The
rule program runs as tensor ops over a (B,) batch of inputs on the
mapper's device, bit-identical to the scalar oracle (oracle.py) and to
the twin.

Where the twin's XLA program differs from eager torch:
- 32-bit lanes. The rjenkins hash runs on int32 tensors, whose add,
  subtract and left shift wrap like uint32; right shifts are masked
  to be logical. Values that need unsigned compares or products
  (list and straw draws, tree weights) ride in int64.
- Retry loops. The twin's `lax.while_loop` rounds become a Python loop
  over `choose_total_tries` that ends when no lane is undecided. Each
  check is one host sync (`host_syncs` counts them); after the first
  round only the undecided lanes are gathered and worked on, which
  gives the same results because lanes are independent.
- Static descent depth. `_plan` walks the map once per rule step: how
  many bucket_choose steps a descent can take from the step's start
  nodes, and the widest bucket at each of them. The twin always runs
  max_depth + 1 steps over the widest bucket; the steps left out are
  no-ops for every lane, and the columns left out are padding.

Call shape: VectorMapper(map, device=...).do_rule(rule_id, xs,
weights, result_max) -> (B, R) int32 tensor of device ids with
CRUSH_ITEM_NONE holes (indep) or NONE-padded tails (firstn).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ec.interface import resolve_device
from .hash import _X, _Y, CRUSH_HASH_SEED
from .map import (ALG_LIST, ALG_STRAW, ALG_STRAW2, ALG_TREE, ALG_UNIFORM,
                  CRUSH_ITEM_NONE, CrushMap, STEP_CHOOSE_FIRSTN,
                  STEP_CHOOSE_INDEP, STEP_CHOOSELEAF_FIRSTN,
                  STEP_CHOOSELEAF_INDEP, STEP_EMIT, STEP_TAKE)
from .oracle import ln16_table

_NONE = CRUSH_ITEM_NONE
_M32 = 0xFFFFFFFF
_QMAX = 1 << 62            # above every q = A48 // w (q < 2^48)


# -- rjenkins1 on int32 lanes -------------------------------------------------

def _i32(v):
    """A uint32 value: an int becomes the int32 with the same bits; a
    tensor is taken to hold int32 bits already."""
    if isinstance(v, torch.Tensor):
        return v
    v = int(v) & _M32
    return v - (1 << 32) if v >= 1 << 31 else v


def _srl(v: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 lanes (>> on int32 is arithmetic)."""
    return (v >> s) & ((1 << (32 - s)) - 1)


def _mix(a, b, c):
    """One crush_hashmix round (crush/hash.py::_mix) on int32 lanes."""
    a = a - b - c
    a = a ^ _srl(c, 13)
    b = b - c - a
    b = b ^ (a << 8)
    c = c - a - b
    c = c ^ _srl(b, 13)
    a = a - b - c
    a = a ^ _srl(c, 12)
    b = b - c - a
    b = b ^ (a << 16)
    c = c - a - b
    c = c ^ _srl(b, 5)
    a = a - b - c
    a = a ^ _srl(c, 3)
    b = b - c - a
    b = b ^ (a << 10)
    c = c - a - b
    c = c ^ _srl(b, 15)
    return a, b, c


def hash32_2(a, b) -> torch.Tensor:
    a, b = _i32(a), _i32(b)
    h = CRUSH_HASH_SEED ^ a ^ b
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash32_3(a, b, c) -> torch.Tensor:
    a, b, c = _i32(a), _i32(b), _i32(c)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def hash32_4(a, b, c, d) -> torch.Tensor:
    a, b, c, d = _i32(a), _i32(b), _i32(c), _i32(d)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def _mulhi32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact (h * w) >> 32 for uint32 values held in int64 lanes (the
    tree draw's __u64 product). The 32x32 product overflows signed
    int64, so w is split at bit 16: both partial products stay < 2^48."""
    return (h * (w >> 16) + ((h * (w & 0xFFFF)) >> 16)) >> 16


def _col(r):
    """Replica rank r as a column against (B, S) item tensors."""
    return r[:, None] if isinstance(r, torch.Tensor) else r


def _xor_fold(t: torch.Tensor) -> torch.Tensor:
    """XOR of every element as a 0-d tensor (torch has no XOR-reduce):
    a log-depth fold of halves, odd tails carried aside."""
    v = t.reshape(-1)
    acc = torch.zeros((), dtype=v.dtype, device=v.device)
    while v.numel() > 1:
        n = v.numel()
        if n & 1:
            acc = acc ^ v[-1]
            v = v[:-1]
            n -= 1
        v = v[:n // 2] ^ v[n // 2:]
    return acc ^ v[0] if v.numel() else acc


class VectorMapper:
    def __init__(self, m: CrushMap, draw: str = "fixed", device=None):
        if draw not in ("fixed", "float"):
            raise ValueError(f"draw must be 'fixed' or 'float', got {draw!r}")
        self.m = m
        self.draw = draw
        self.device = resolve_device(device)
        p = m.pack()
        self.tries = m.tunables.choose_total_tries
        self.max_depth = p.max_depth
        self.S = p.max_size

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=self.device, dtype=dtype)
        # device-resident map tables, uploaded once
        self.t_items = up(p.items, torch.int32)                  # (NB, S)
        self.t_w32 = up((p.weights.astype(np.float64) / 65536.0)
                        .astype(np.float32), torch.float32)
        self.t_wzero = up(p.weights == 0, torch.bool)
        self.t_size = up(p.size, torch.int32)                    # (NB,)
        self.t_alg = up(p.alg, torch.int32)
        self.t_type = up(p.type_id, torch.int32)
        # list-bucket cumulative weights, split as the twin splits them
        sw = p.sum_weights.astype(np.uint64)
        self.t_sw_lo = up((sw & 0xFFFF).astype(np.int64), torch.int64)
        self.t_sw_hi = up((sw >> 16).astype(np.uint32).astype(np.int64),
                          torch.int64)
        self.t_iw = up(p.weights.astype(np.uint32).astype(np.int64),
                       torch.int64)
        self.t_ln16 = up(ln16_table(), torch.float32)
        self._cols = torch.arange(max(self.S, 1), device=self.device)
        if draw == "fixed":
            # per-distinct-weight q = A48 // w tables (ln48.py), joined
            # into one int64 q < 2^48: the draw is a gather and an argmin
            from .ln48 import quotient_tables
            widx_of, qhi, qlo = quotient_tables(p.weights.ravel())
            widx = np.zeros(p.weights.shape, dtype=np.int64)
            for w, i in widx_of.items():
                widx[p.weights == w] = i
            self.t_widx = up(widx, torch.int64)                  # (NB, S)
            q = (qhi.astype(np.int64) << 32) | qlo.astype(np.int64)
            self.t_q = up(q.reshape(-1), torch.int64)            # (D*65536,)
        self.algs_used = set(int(a) for a in np.unique(p.alg) if a != 0)
        self.S_uniform = p.max_size_by_alg.get(ALG_UNIFORM, 1)
        if p.tree_nodes is not None:
            # calc_tree_nodes already wraps mod 2^32 (__u32 parity
            # with the oracle)
            self.t_tree_nodes = up(p.tree_nodes, torch.int64)
            self.t_tree_nn = up(p.tree_num_nodes, torch.int64)
            self.tree_depth = int(np.log2(p.tree_nodes.shape[1])) + 1
        if p.straws is not None:
            st = p.straws.astype(np.uint64)
            self.t_straw_hi = up((st >> 16).astype(np.uint32)
                                 .astype(np.int64), torch.int64)
            self.t_straw_lo = up((st & 0xFFFF).astype(np.int64), torch.int64)
            self.t_straw_zero = up(p.straws == 0, torch.bool)
        self._plans: dict[int, dict] = {}
        #: host syncs taken by the retry loops (one per round after the
        #: first, per choose step and column)
        self.host_syncs = 0

    # -- static plan ----------------------------------------------------------

    def _walk(self, starts, want_type: int):
        """One descent from any of `starts` toward an item of
        `want_type`: the widest bucket a lane can stand in at each
        bucket_choose step (one entry per step that can move a lane),
        and the items of `want_type` it can reach."""
        widths, reach = [], set()
        frontier = set(starts)
        for _ in range(self.max_depth + 1):
            active = set()
            for n in frontier:
                t = 0 if n >= 0 else self.m.buckets[n].type_id
                if t == want_type:
                    reach.add(n)
                elif n < 0:
                    active.add(n)
            if not active:
                break
            widths.append(max(1, max(self.m.buckets[b].size
                                     for b in active)))
            frontier = {it for b in active for it in self.m.buckets[b].items}
        return widths, reach

    def _plan(self, rule_id: int) -> dict:
        """Per choose step of the rule: (descent widths, leaf-descent
        widths)."""
        plan = self._plans.get(rule_id)
        if plan is None:
            plan, starts = {}, set()
            for si, step in enumerate(self.m.rules[rule_id].steps):
                if step.op == STEP_TAKE:
                    starts = {step.arg}
                elif step.op == STEP_EMIT:
                    starts = set()
                else:
                    widths, reach = self._walk(starts, step.type_id)
                    leaf_widths = []
                    if step.op in (STEP_CHOOSELEAF_FIRSTN,
                                   STEP_CHOOSELEAF_INDEP):
                        leaf_widths, reach = self._walk(reach, 0)
                    plan[si] = (widths, leaf_widths)
                    starts = reach
            self._plans[rule_id] = plan
        return plan

    # -- bucket choose (batched over lanes) -----------------------------------

    def _rows(self, node):
        """bucket id (negative) -> packed row (int64); invalid lanes ->
        row 0."""
        return (-1 - node).clamp(0, self.t_items.shape[0] - 1).long()

    def _straw2(self, row, x, r, S):
        items = self.t_items[row, :S]                       # (B, S)
        slot_ok = (self._cols[:S] < self.t_size[row][:, None]) \
            & ~self.t_wzero[row, :S]
        h16 = hash32_3(x[:, None], items, _col(r)) & 0xFFFF
        if self.draw == "fixed":
            # first strictly-smallest q = A48 // w: argmin keeps the
            # first of equal values, mapper.c keeps the earlier item
            q = self.t_q[self.t_widx[row, :S] * 65536 + h16]
            best = q.masked_fill(~slot_ok, _QMAX).argmin(dim=1)
        else:
            draws = self.t_ln16[h16.long()] / self.t_w32[row, :S]
            best = draws.masked_fill(~slot_ok, -np.inf).argmax(dim=1)
        item = items.gather(1, best[:, None])[:, 0]
        return torch.where(slot_ok.any(dim=1), item, _NONE)

    def _uniform(self, row, x, r):
        size = self.t_size[row]                             # (B,)
        bid = (-1 - row).int()
        B = row.shape[0]
        # unroll bound: the largest UNIFORM bucket, as in the twin
        SU = self.S_uniform
        cols = torch.arange(SU, device=row.device)
        perm = cols.expand(B, SU)
        for i in range(SU - 1):
            rem = (size - i).clamp(min=1).long()
            h = hash32_3(x, bid, i).long() & _M32
            # lanes of other algs may index past SU: clamped, discarded
            j = (i + h % rem).clamp(max=SU - 1)
            vi = perm[:, i]
            vj = perm.gather(1, j[:, None])[:, 0]
            swapped = torch.where(cols == i, vj[:, None],
                                  torch.where(cols == j[:, None],
                                              vi[:, None], perm))
            perm = torch.where((i < size)[:, None], swapped, perm)
        pr = (r % size.clamp(min=1)).long().clamp(max=SU - 1)
        slot = perm.gather(1, pr[:, None])[:, 0]
        item = self.t_items[row, slot]
        return torch.where(size > 0, item, _NONE)

    def _list(self, row, x, r, S):
        items = self.t_items[row, :S]
        bid = (-1 - row).int()
        h16 = (hash32_4(x[:, None], items, _col(r), bid[:, None])
               & 0xFFFF).long()
        # floor((h16 * sum_w) / 2^16) < item_w, in the twin's wrapping
        # 32-bit pieces
        p_lo = h16 * self.t_sw_lo[row, :S]
        p_hi = (h16 * self.t_sw_hi[row, :S]) & _M32
        lhs = (p_hi + (p_lo >> 16)) & _M32
        size = self.t_size[row]
        mask = (lhs < self.t_iw[row, :S]) & (self._cols[:S] < size[:, None])
        # the last slot that holds: first winner of the reversed mask
        rev = mask.flip(1)
        idx = S - 1 - rev.to(torch.uint8).argmax(dim=1)
        slot = torch.where(rev.any(dim=1), idx, 0)
        item = items.gather(1, slot[:, None])[:, 0]
        return torch.where(size > 0, item, _NONE)

    def _tree(self, row, x, r):
        """In-order binary-tree walk, all lanes in lockstep for
        tree_depth steps (ref: mapper.c bucket_tree_choose). Terminal
        (odd) nodes self-loop: half = lowest-set-bit(n) >> 1 is 0."""
        nodes_b = self.t_tree_nodes[row]                    # (B, MN)
        n = self.t_tree_nn[row] >> 1
        bid = (-1 - row).int()
        root_w = nodes_b.gather(1, n[:, None])[:, 0]
        for _ in range(self.tree_depth):
            half = (n & -n) >> 1
            w = nodes_b.gather(1, n[:, None])[:, 0]
            h = hash32_4(x, n.int(), r, bid).long() & _M32
            t = _mulhi32(h, w)
            left = n - half
            wl = nodes_b.gather(1, left[:, None])[:, 0]
            n = torch.where(half > 0, torch.where(t < wl, left, n + half), n)
        slot = (n >> 1).clamp(max=self.S - 1)
        item = self.t_items[row].gather(1, slot[:, None])[:, 0]
        ok = ((n & 1) == 1) & (root_w > 0)
        return torch.where(ok, item, _NONE)

    def _straw(self, row, x, r, S):
        """Legacy straw: draw = h16 * straw (48-bit) with the replica
        rank hashed in, first-wins max (ref: bucket_straw_choose)."""
        items = self.t_items[row, :S]
        h16 = (hash32_3(x[:, None], items, _col(r)) & 0xFFFF).long()
        size = self.t_size[row]
        slot_ok = self._cols[:S] < size[:, None]
        p_lo = h16 * self.t_straw_lo[row, :S]
        hi = (h16 * self.t_straw_hi[row, :S] + (p_lo >> 16)) & _M32
        # the twin's (hi, lo16) u32 pair as one 48-bit key; padding
        # draws 0, like the twin's
        key = torch.where(slot_ok, (hi << 16) | (p_lo & 0xFFFF), 0)
        best = key.argmax(dim=1)                            # first winner
        item = items.gather(1, best[:, None])[:, 0]
        dead = self.t_straw_zero[row, :S].gather(1, best[:, None])[:, 0]
        return torch.where((size > 0) & ~dead, item, _NONE)

    def _bucket_choose(self, node, x, r, S: int):
        """node (B,) bucket ids (negative) -> chosen child item (B,);
        S bounds the size of every bucket an active lane stands in."""
        row = self._rows(node)
        alg = self.t_alg[row]
        out = torch.full(node.shape, _NONE, dtype=torch.int32,
                         device=node.device)
        if ALG_STRAW2 in self.algs_used:
            out = torch.where(alg == ALG_STRAW2, self._straw2(row, x, r, S),
                              out)
        if ALG_UNIFORM in self.algs_used:
            out = torch.where(alg == ALG_UNIFORM, self._uniform(row, x, r),
                              out)
        if ALG_LIST in self.algs_used:
            out = torch.where(alg == ALG_LIST, self._list(row, x, r, S), out)
        if ALG_TREE in self.algs_used:
            out = torch.where(alg == ALG_TREE, self._tree(row, x, r), out)
        if ALG_STRAW in self.algs_used:
            out = torch.where(alg == ALG_STRAW, self._straw(row, x, r, S),
                              out)
        return out

    # -- descent / rejection --------------------------------------------------

    def _item_type(self, item):
        return torch.where(item >= 0, 0, self.t_type[self._rows(item)])

    def _descend(self, node, x, r, want_type: int, widths):
        cur = node
        for S in widths:
            t = self._item_type(cur)
            done = (t == want_type) | (cur == _NONE)
            dead_end = (cur >= 0) & (t != want_type)
            active = ~done & ~dead_end
            nxt = self._bucket_choose(torch.where(active, cur, -1), x, r, S)
            cur = torch.where(active, nxt,
                              torch.where(dead_end, _NONE, cur))
        final_ok = self._item_type(cur) == want_type
        return torch.where(final_ok & (cur != _NONE), cur, _NONE)

    def _is_out(self, weights, item, x):
        """weights: (n_devices,) int32 16.16; item may be NONE/bucket."""
        w = weights[item.clamp(0, weights.shape[0] - 1).long()]
        h16 = hash32_2(x, item) & 0xFFFF
        rejected = (w < 0x10000) & ((w == 0) | (h16 >= w))
        return rejected & (item >= 0)

    # -- choose ---------------------------------------------------------------

    def _pending(self, mask):
        """Indices of the lanes still to work on (one host sync)."""
        self.host_syncs += 1
        return mask.nonzero().squeeze(1)

    def _choose_indep(self, take, x, numrep: int, want_type: int,
                      weights, to_leaf: bool, plan):
        widths, leaf_widths = plan
        B = x.shape[0]
        out = torch.full((B, numrep), _NONE, dtype=torch.int32,
                         device=x.device)
        leaves = out.clone()
        idx = None
        for rnd in range(self.tries):
            if rnd:
                # the twin's while_loop condition; later rounds run on
                # the undecided lanes only
                idx = self._pending(
                    ((leaves if to_leaf else out) == _NONE).any(dim=1))
                if not idx.numel():
                    break
            if idx is None:
                tk, xs, o, lv = take, x, out, leaves
            else:
                tk, xs, o, lv = take[idx], x[idx], out[idx], leaves[idx]
            for rep in range(numrep):
                r = rep + rnd * numrep
                undecided = o[:, rep] == _NONE
                item = self._descend(tk, xs, r, want_type, widths)
                valid = item != _NONE
                ok = undecided & valid & ~(item[:, None] == o).any(dim=1)
                if to_leaf:
                    leaf = self._descend(torch.where(valid, item, -1), xs, r,
                                         0, leaf_widths)
                    ok &= (leaf != _NONE) \
                        & ~(leaf[:, None] == lv).any(dim=1) \
                        & ~self._is_out(weights, leaf, xs)
                    lv[:, rep] = torch.where(ok, leaf, lv[:, rep])
                else:
                    ok &= ~self._is_out(weights, item, xs)
                o[:, rep] = torch.where(ok, item, o[:, rep])
            if idx is not None:
                out[idx] = o
                leaves[idx] = lv
        return leaves if to_leaf else out

    def _choose_firstn(self, take, x, numrep: int, want_type: int,
                       weights, to_leaf: bool, plan):
        widths, leaf_widths = plan
        B = x.shape[0]
        out = torch.full((B, numrep), _NONE, dtype=torch.int32,
                         device=x.device)
        leaves = out.clone()
        ftotal = torch.zeros(B, dtype=torch.int32, device=x.device)
        for rep in range(numrep):
            found = torch.zeros(B, dtype=torch.bool, device=x.device)
            idx = None
            while True:
                if idx is None:
                    tk, xs, o, lv, ft, fd = take, x, out, leaves, ftotal, found
                else:
                    tk, xs, o, lv, ft, fd = (t[idx] for t in (
                        take, x, out, leaves, ftotal, found))
                active = ~fd & (ft < self.tries)
                r = rep + ft
                item = self._descend(tk, xs, r, want_type, widths)
                valid = item != _NONE
                ok = active & valid & ~(item[:, None] == o).any(dim=1)
                if to_leaf:
                    leaf = self._descend(torch.where(valid, item, -1), xs, r,
                                         0, leaf_widths)
                    ok &= (leaf != _NONE) \
                        & ~(leaf[:, None] == lv).any(dim=1) \
                        & ~self._is_out(weights, leaf, xs)
                    lv[:, rep] = torch.where(ok, leaf, lv[:, rep])
                else:
                    ok &= ~self._is_out(weights, item, xs)
                o[:, rep] = torch.where(ok, item, o[:, rep])
                ft = torch.where(active & ~ok, ft + 1, ft)
                fd = fd | ok
                if idx is None:
                    ftotal, found = ft, fd
                else:
                    out[idx], leaves[idx] = o, lv
                    ftotal[idx], found[idx] = ft, fd
                # the twin's while_loop condition, on the lanes left
                idx = self._pending(~found & (ftotal < self.tries))
                if not idx.numel():
                    break
        return leaves if to_leaf else out

    # -- rule execution -------------------------------------------------------

    def _do_rule_impl(self, rule_id: int, result_max: int, xs, weights):
        rule = self.m.rules[rule_id]
        plan = self._plan(rule_id)
        working = None
        results = []
        B = xs.shape[0]
        for si, step in enumerate(rule.steps):
            if step.op == STEP_TAKE:
                working = torch.full((B, 1), step.arg, dtype=torch.int32,
                                     device=xs.device)
            elif step.op == STEP_EMIT:
                results.append(working)
                working = None
            else:
                numrep = step.arg if step.arg > 0 else result_max + step.arg
                indep = step.op in (STEP_CHOOSE_INDEP, STEP_CHOOSELEAF_INDEP)
                to_leaf = step.op in (STEP_CHOOSELEAF_FIRSTN,
                                      STEP_CHOOSELEAF_INDEP)
                fn = self._choose_indep if indep else self._choose_firstn
                working = torch.cat([
                    fn(working[:, w], xs, numrep, step.type_id, weights,
                       to_leaf, plan[si])
                    for w in range(working.shape[1])], dim=1)
        return torch.cat(results, dim=1)

    def _lanes(self, xs) -> torch.Tensor:
        """PG seeds (any integer array or tensor) -> int32 lanes holding
        their uint32 bits, on this device."""
        if isinstance(xs, torch.Tensor):
            v = xs.to(self.device, torch.int64) & _M32
            return torch.where(v >= 1 << 31, v - (1 << 32), v).int()
        xs = np.asarray(xs).astype(np.uint32).view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(xs)).to(self.device)

    def _weights(self, weights) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            weights, dtype=np.int32)).to(self.device)

    def do_rule(self, rule_id: int, xs, weights, result_max: int):
        """xs: (B,) int/uint32 PG seeds; weights: (n_devices,) 16.16
        int32 reweights. Returns a (B, R) int32 tensor of items on this
        device, CRUSH_ITEM_NONE for unfilled slots."""
        return self._do_rule_impl(rule_id, result_max, self._lanes(xs),
                                  self._weights(weights))

    def scan_rule(self, rule_id: int, weights, result_max: int,
                  start: int, sub: int, n_batches: int):
        """Place n_batches consecutive sub-batches of `sub` PGs, seeds
        start, start+1, ... made on the device. Returns (digest, last):
        digest is the int32 XOR fold over every placement, kept on the
        device and read once at the end; last is the final (sub,
        result_max) placement batch for spot validation. The digest
        does not depend on how the placements are split into batches."""
        weights = self._weights(weights)
        base = torch.arange(sub, dtype=torch.int64, device=self.device)
        acc = torch.zeros((), dtype=torch.int32, device=self.device)
        last = torch.zeros((sub, result_max), dtype=torch.int32,
                           device=self.device)
        for i in range(n_batches):
            last = self._do_rule_impl(rule_id, result_max,
                                      self._lanes(base + (start + i * sub)),
                                      weights)
            acc = acc ^ _xor_fold(last)
        return int(acc), last


def full_weights(n_devices: int) -> np.ndarray:
    return np.full(n_devices, 0x10000, dtype=np.int32)
