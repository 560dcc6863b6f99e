"""profile_diff — before/after CPU-flame attribution diffs (r19).

The regression-hunting half of the continuous-profiling plane: given
two profile blocks (a baseline and a candidate — raw `profile` blocks,
`profile cpu` dumps, or whole BENCH_*.json artifacts carrying a
`profile` key), answer "where did the CPU go that didn't go there
before" in the span-category units the trace plane uses, so a flame
diff and a `trace slow` attribution point at the same suspect.

Samples are wall-clock sampler counts, so absolute counts are not
comparable across runs of different lengths — the diff works in
CATEGORY SHARES (fraction of all samples) and flags a category as
regressed when its share grows by more than `--threshold` (absolute
share points, default 0.05). Stack-level deltas are reported in
shares too, signed, heaviest movers first.

  python -m ceph_tpu_torch.tools.profile_diff before.json after.json
  python -m ceph_tpu_torch.tools.profile_diff before.json after.json --json
  python -m ceph_tpu_torch.tools.profile_diff before.json after.json \
      --threshold 0.10

Exit status: 0 = no category regressed past the threshold, 1 = at
least one did (CI-gateable), 2 = unusable input.

A copy of the JAX package's tools/profile_diff.py over the port's
utils/profiler.py (its output, the schema name included, is the
twin's); like every tool of the port it resolves --device first
(default the CUDA device), though the diff itself is host work.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils.profiler import PROFILE_CATEGORIES
from . import _device, add_device_flag


def extract_block(doc: dict) -> dict:
    """Accept any of the shapes that carry a flame profile: a bench
    artifact ({"profile": {...}}), a bench/mon block with
    categories+samples, or a raw {category: {stack: n}} stacks dict."""
    if not isinstance(doc, dict):
        raise ValueError("profile document must be a JSON object")
    if isinstance(doc.get("profile"), dict):        # BENCH_*.json
        doc = doc["profile"]
    if "categories" in doc:                         # block / cpu dump
        return doc
    if doc and all(isinstance(v, dict) for v in doc.values()) \
            and set(doc) <= set(PROFILE_CATEGORIES):
        # raw stacks: synthesize the block shape
        from ..utils.profiler import category_split, top_stacks
        split = category_split(doc)
        total = sum(split.values())
        return {"samples": total, "categories": split,
                "category_share": {
                    c: round(v / total, 4) if total else 0.0
                    for c, v in split.items()},
                "top_stacks": top_stacks(doc, n=50)}
    raise ValueError("no profile block found (expected a 'profile' "
                     "key, a 'categories' key, or raw stacks)")


def _shares(block: dict) -> dict[str, float]:
    total = sum(int(v) for v in block.get("categories", {}).values())
    return {c: (int(block.get("categories", {}).get(c, 0)) / total
                if total else 0.0)
            for c in PROFILE_CATEGORIES}


def _stack_shares(block: dict) -> dict[tuple[str, str], float]:
    total = sum(int(v) for v in block.get("categories", {}).values())
    out: dict[tuple[str, str], float] = {}
    for row in block.get("top_stacks") or []:
        key = (row.get("category", "other"), row.get("stack", ""))
        if total:
            out[key] = out.get(key, 0.0) + int(row.get("samples", 0)) / total
    return out


def diff_blocks(before: dict, after: dict,
                threshold: float = 0.05, top_n: int = 10) -> dict:
    """Deterministic diff of two profile blocks: per-category share
    deltas + the heaviest stack-share movers + a verdict naming every
    category whose share grew past the threshold."""
    sb, sa = _shares(before), _shares(after)
    cats = {c: {"before_share": round(sb[c], 4),
                "after_share": round(sa[c], 4),
                "delta_share": round(sa[c] - sb[c], 4)}
            for c in PROFILE_CATEGORIES}
    regressed = sorted((c for c in PROFILE_CATEGORIES
                        if sa[c] - sb[c] > threshold),
                       key=lambda c: sb[c] - sa[c])
    stb, sta = _stack_shares(before), _stack_shares(after)
    movers = []
    for key in set(stb) | set(sta):
        d = sta.get(key, 0.0) - stb.get(key, 0.0)
        if abs(d) > 1e-9:
            movers.append({"category": key[0], "stack": key[1],
                           "delta_share": round(d, 4)})
    movers.sort(key=lambda r: (-abs(r["delta_share"]),
                               r["category"], r["stack"]))
    return {
        "schema": "ceph_tpu.profile_diff.v1",
        "threshold": threshold,
        "samples": {"before": int(before.get("samples", 0)),
                    "after": int(after.get("samples", 0))},
        "categories": cats,
        "top_movers": movers[:top_n],
        "regressed": regressed,
        "verdict": ("REGRESSED: " + ", ".join(
            f"{c} +{cats[c]['delta_share']:.1%}" for c in regressed)
            if regressed else "OK"),
    }


def _load(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def render(d: dict) -> str:
    lines = [f"profile diff (threshold {d['threshold']:.0%} share)",
             f"  samples: {d['samples']['before']} -> "
             f"{d['samples']['after']}",
             f"  {'category':<10} {'before':>8} {'after':>8} "
             f"{'delta':>8}"]
    for c in PROFILE_CATEGORIES:
        row = d["categories"][c]
        mark = "  <-- regressed" if c in d["regressed"] else ""
        lines.append(f"  {c:<10} {row['before_share']:>7.1%} "
                     f"{row['after_share']:>7.1%} "
                     f"{row['delta_share']:>+7.1%}{mark}")
    if d["top_movers"]:
        lines.append("  heaviest stack movers:")
        for m in d["top_movers"]:
            stk = m["stack"]
            if len(stk) > 72:
                stk = "..." + stk[-69:]
            lines.append(f"    {m['delta_share']:>+7.1%} "
                         f"[{m['category']}] {stk}")
    lines.append(d["verdict"])
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before", help="baseline profile JSON")
    ap.add_argument("after", help="candidate profile JSON")
    ap.add_argument("--threshold", type=float, default=0.05,
                    help="share growth that counts as a regression "
                         "(absolute points, default 0.05)")
    ap.add_argument("--top", type=int, default=10,
                    help="stack movers to show (default 10)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    _device(args)
    try:
        before = extract_block(_load(args.before))
        after = extract_block(_load(args.after))
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"profile_diff: {e}", file=sys.stderr)
        return 2
    d = diff_blocks(before, after, threshold=args.threshold,
                    top_n=args.top)
    print(json.dumps(d, indent=2, sort_keys=True) if args.json
          else render(d))
    return 1 if d["regressed"] else 0


if __name__ == "__main__":
    sys.exit(main())
