"""Scalar CRUSH mapper — the host-side oracle.

Semantic rebuild of the reference's mapper (ref: src/crush/mapper.c —
crush_do_rule, crush_choose_firstn, crush_choose_indep,
crush_bucket_choose, bucket_straw2_choose, bucket_perm_choose,
bucket_list_choose, is_out weight rejection). Slow Python loops,
obviously correct; the vectorized JAX mapper in mapper.py must match it
bit-for-bit (parity tests pin that).

Divergences from upstream, frozen deliberately (reference unverifiable
at build time — see SURVEY.md):
  * straw2 draws default to FIXED-POINT crush_ln semantics (draw=
    "fixed"): q = (2^48 - crush_ln(u)) // weight compared ascending,
    first index winning ties — exactly the reference's truncating s64
    division compare (see ln48.py; table values are the exact
    mathematical log2 rather than upstream's two-level interpolation,
    whose byte-exact tables cannot be verified against the empty
    mount). The r01 float32 ln-table draw is kept as draw="float" for
    comparison.
  * retry schedule: `choose_total_tries` rounds with r' = rep +
    round*numrep (indep) or r' = rep + ftotal (firstn); modern-profile
    behaviors (vary_r/stable) are the only semantics (no legacy modes).
"""

from __future__ import annotations

import functools

import numpy as np

from .hash import hash32_2, hash32_3, hash32_4
from .map import (ALG_LIST, ALG_STRAW, ALG_STRAW2, ALG_TREE, ALG_UNIFORM,
                  CRUSH_ITEM_NONE, CrushMap, Rule, Step,
                  STEP_CHOOSE_FIRSTN, STEP_CHOOSE_INDEP,
                  STEP_CHOOSELEAF_FIRSTN, STEP_CHOOSELEAF_INDEP,
                  STEP_EMIT, STEP_TAKE, calc_straws, calc_tree_nodes)


@functools.cache
def ln16_table() -> np.ndarray:
    """float32 ln((h+1)/65536) for the 16-bit straw2 hash domain —
    the role of crush_ln's __RH_LH_tbl/__LL_tbl lookup pyramid."""
    h = np.arange(65536, dtype=np.float64)
    return np.log((h + 1.0) / 65536.0).astype(np.float32)


def _u32(v: int) -> np.uint32:
    return np.uint32(v & 0xFFFFFFFF)


class OracleMapper:
    def __init__(self, m: CrushMap, draw: str = "fixed"):
        if draw not in ("fixed", "float"):
            raise ValueError(f"draw must be 'fixed' or 'float', got {draw!r}")
        self.m = m
        self.draw = draw
        self.tries = m.tunables.choose_total_tries
        self._tree_cache: dict[int, list[int]] = {}
        self._straw_cache: dict[int, list[int]] = {}

    # -- bucket choose ------------------------------------------------------

    def bucket_choose(self, bucket_id: int, x: int, r: int) -> int:
        b = self.m.buckets[bucket_id]
        if b.size == 0:
            return CRUSH_ITEM_NONE
        with np.errstate(over="ignore"):
            if b.alg == ALG_STRAW2:
                return self._straw2_choose(b, x, r)
            if b.alg == ALG_UNIFORM:
                return self._perm_choose(b, x, r)
            if b.alg == ALG_LIST:
                return self._list_choose(b, x, r)
            if b.alg == ALG_TREE:
                return self._tree_choose(b, x, r)
            if b.alg == ALG_STRAW:
                return self._straw_choose(b, x, r)
        raise ValueError(f"unsupported bucket alg {b.alg}")

    def _tree_choose(self, b, x: int, r: int) -> int:
        """In-order binary tree walk (ref: mapper.c bucket_tree_choose):
        at internal node n (height h = lowest set bit), draw
        t = (hash32_4(x, n, r, id) * node_weight(n)) >> 32 and descend
        left iff t < weight(left subtree). Leaves are odd nodes; leaf
        2i+1 holds item i."""
        nodes = self._tree_cache.get(b.id)
        if nodes is None:
            nodes = calc_tree_nodes(b.weights)
            self._tree_cache[b.id] = nodes
        n = len(nodes) >> 1
        if nodes[n] == 0:
            return CRUSH_ITEM_NONE
        while not (n & 1):
            h = 1
            while not (n >> h) & 1:
                h += 1
            half = 1 << (h - 1)
            w = nodes[n]
            t = (int(hash32_4(_u32(x), _u32(n), _u32(r), _u32(b.id)))
                 * w) >> 32
            left = n - half
            n = left if t < nodes[left] else n + half
        return b.items[n >> 1]

    def _straw_choose(self, b, x: int, r: int) -> int:
        """Legacy straw draw (ref: mapper.c bucket_straw_choose):
        draw = (hash32_3(x, item, r) & 0xffff) * straws[i], max wins,
        first index on ties. The replica rank r MUST be hashed in or
        every rank would draw the same winner and multi-replica straw
        placement could never fill >1 slot."""
        straws = self._straw_cache.get(b.id)
        if straws is None:
            straws = calc_straws(b.weights)
            self._straw_cache[b.id] = straws
        best_i = -1
        best = -1
        for i, item in enumerate(b.items):
            h = int(hash32_3(_u32(x), _u32(item), _u32(r))) & 0xFFFF
            draw = h * straws[i]
            if draw > best:
                best = draw
                best_i = i
        if best_i < 0 or straws[best_i] == 0:
            return CRUSH_ITEM_NONE
        return b.items[best_i]

    def _straw2_choose(self, b, x: int, r: int) -> int:
        if self.draw == "fixed":
            return self._straw2_choose_fixed(b, x, r)
        ln = ln16_table()
        best_i = -1
        best_draw = None
        for i, (item, w) in enumerate(zip(b.items, b.weights)):
            if w == 0:
                continue  # zero crush weight never places (all-zero
                # buckets yield NONE so the retry loop moves on)
            h = int(hash32_3(_u32(x), _u32(item), _u32(r))) & 0xFFFF
            draw = ln[h] / (np.float32(w) / np.float32(65536.0))
            if best_draw is None or draw > best_draw:
                best_draw = draw
                best_i = i
        if best_i < 0:
            return CRUSH_ITEM_NONE
        return b.items[best_i]

    def _straw2_choose_fixed(self, b, x: int, r: int) -> int:
        """Reference integer semantics: draw = (crush_ln(u) - 2^48)/w,
        truncating s64 division, first strictly-greatest draw wins —
        equivalently first strictly-smallest q = A48 // w (ln48.py)."""
        from .ln48 import a48_table
        A = a48_table()
        best_i = -1
        best_q = None
        for i, (item, w) in enumerate(zip(b.items, b.weights)):
            if w == 0:
                continue
            h = int(hash32_3(_u32(x), _u32(item), _u32(r))) & 0xFFFF
            q = int(A[h]) // int(w)
            if best_q is None or q < best_q:
                best_q = q
                best_i = i
        if best_i < 0:
            return CRUSH_ITEM_NONE
        return b.items[best_i]

    def _perm_choose(self, b, x: int, r: int) -> int:
        pr = r % b.size
        perm = list(range(b.size))
        for i in range(pr + 1):
            rem = b.size - i
            j = i + int(hash32_3(_u32(x), _u32(b.id), _u32(i))) % rem
            perm[i], perm[j] = perm[j], perm[i]
        return b.items[perm[pr]]

    def _list_choose(self, b, x: int, r: int) -> int:
        csum = np.cumsum(b.weights)
        for i in range(b.size - 1, -1, -1):
            w = int(hash32_4(_u32(x), _u32(b.items[i]), _u32(r),
                             _u32(b.id))) & 0xFFFF
            w = (w * int(csum[i])) >> 16
            if w < b.weights[i]:
                return b.items[i]
        return b.items[0]

    # -- device rejection ---------------------------------------------------

    def is_out(self, weights: np.ndarray, item: int, x: int) -> bool:
        """weights: (n_devices,) 16.16 reweight vector (OSDMap's
        osd_weight); full weight never rejects, zero always does."""
        w = int(weights[item])
        if w >= 0x10000:
            return False
        if w == 0:
            return True
        return (int(hash32_2(_u32(x), _u32(item))) & 0xFFFF) >= w

    # -- descent ------------------------------------------------------------

    def descend(self, node: int, x: int, r: int, want_type: int) -> int:
        """bucket_choose down the hierarchy until an item of want_type."""
        for _ in range(self.m.pack().max_depth + 1):
            if self.m.item_type(node) == want_type:
                return node
            if node >= 0:
                return CRUSH_ITEM_NONE  # hit a device above wanted type
            node = self.bucket_choose(node, x, r)
            if node == CRUSH_ITEM_NONE:
                return CRUSH_ITEM_NONE
        return CRUSH_ITEM_NONE

    # -- choose -------------------------------------------------------------

    def choose_indep(self, take: int, x: int, numrep: int, want_type: int,
                     weights: np.ndarray, to_leaf: bool) -> list[int]:
        out = [CRUSH_ITEM_NONE] * numrep
        leaves = [CRUSH_ITEM_NONE] * numrep
        for rnd in range(self.tries):
            for rep in range(numrep):
                if out[rep] != CRUSH_ITEM_NONE:
                    continue
                r = rep + rnd * numrep
                item = self.descend(take, x, r, want_type)
                if item == CRUSH_ITEM_NONE:
                    continue
                if item in out:
                    continue
                if to_leaf:
                    leaf = self.descend(item, x, r, 0)
                    if leaf == CRUSH_ITEM_NONE or leaf in leaves:
                        continue
                    if self.is_out(weights, leaf, x):
                        continue
                    leaves[rep] = leaf
                elif item >= 0 and self.is_out(weights, item, x):
                    continue
                out[rep] = item
        return leaves if to_leaf else out

    def choose_firstn(self, take: int, x: int, numrep: int, want_type: int,
                      weights: np.ndarray, to_leaf: bool) -> list[int]:
        out: list[int] = []
        leaves: list[int] = []
        ftotal = 0
        for rep in range(numrep):
            while ftotal < self.tries:
                r = rep + ftotal
                item = self.descend(take, x, r, want_type)
                bad = (item == CRUSH_ITEM_NONE or item in out)
                leaf = CRUSH_ITEM_NONE
                if not bad and to_leaf:
                    leaf = self.descend(item, x, r, 0)
                    bad = (leaf == CRUSH_ITEM_NONE or leaf in leaves
                           or self.is_out(weights, leaf, x))
                elif not bad and item >= 0:
                    bad = self.is_out(weights, item, x)
                if bad:
                    ftotal += 1
                    continue
                out.append(item)
                leaves.append(leaf)
                break
        return leaves if to_leaf else out

    # -- rule execution -----------------------------------------------------

    def do_rule(self, rule: Rule | int, x: int, weights: np.ndarray,
                result_max: int) -> list[int]:
        """Execute a rule for input x (the PG seed); returns item ids
        (devices for chooseleaf/choose-to-osd rules). Mirrors
        crush_do_rule's working-vector semantics."""
        if isinstance(rule, int):
            rule = self.m.rules[rule]
        working: list[int] = []
        result: list[int] = []
        for step in rule.steps:
            if step.op == STEP_TAKE:
                working = [step.arg]
            elif step.op == STEP_EMIT:
                result.extend(working)
                working = []
            else:
                numrep = step.arg if step.arg > 0 else result_max + step.arg
                indep = step.op in (STEP_CHOOSE_INDEP, STEP_CHOOSELEAF_INDEP)
                to_leaf = step.op in (STEP_CHOOSELEAF_FIRSTN,
                                      STEP_CHOOSELEAF_INDEP)
                nxt: list[int] = []
                for parent in working:
                    if indep:
                        nxt.extend(self.choose_indep(
                            parent, x, numrep, step.type_id, weights, to_leaf))
                    else:
                        nxt.extend(self.choose_firstn(
                            parent, x, numrep, step.type_id, weights, to_leaf))
                working = nxt
        return result
