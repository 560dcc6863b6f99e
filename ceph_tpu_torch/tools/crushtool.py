"""crushtool — offline CRUSH map build/test CLI, on the port.

Recreation of the reference's placement harness (ref:
src/tools/crushtool.cc `crushtool --build/--test --show-mappings
--show-statistics`; test engine ref: src/crush/CrushTester.cc): builds a
hierarchy, runs a rule over a range of inputs through the VECTORIZED
mapper in one launch, and reports per-device utilization + fill.
Twin of the JAX package's tools/crushtool.py: the mapper is the port's
VectorMapper on --device (default the CUDA device); binary maps
written by either package decode in the other.

Examples:
  python -m ceph_tpu_torch.tools.crushtool --build --num-osds 64 \
      --osds-per-host 4 --hosts-per-rack 4 --test --rule ec \
      --num-rep 6 --max-x 4096
  python -m ceph_tpu_torch.tools.crushtool --build --num-osds 10000 \
      --test --rule ec --num-rep 11 --max-x 100000 --mark-out 0,17 \
      --show-mappings 5
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import _device, add_device_flag


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--build", action="store_true",
                    help="build a root/rack/host/osd hierarchy")
    ap.add_argument("--num-osds", type=int, default=64)
    ap.add_argument("--osds-per-host", type=int, default=8)
    ap.add_argument("--hosts-per-rack", type=int, default=16)
    ap.add_argument("--alg", default="straw2",
                    choices=["straw2", "uniform", "list", "tree", "straw"])
    ap.add_argument("-d", "--decompile", metavar="MAPFILE",
                    help="decompile a binary map file to text "
                         "(use with --build to decompile the built map)")
    ap.add_argument("-c", "--compile", dest="compile_txt", metavar="TXTFILE",
                    help="compile a text map file (use as the test map)")
    ap.add_argument("-o", "--outfn", metavar="OUT",
                    help="write binary map / text output here "
                         "(default stdout for text)")
    ap.add_argument("--test", action="store_true", help="run a placement test")
    ap.add_argument("--rule", default="replicated",
                    help="rule to test: 'replicated', 'ec', or a rule "
                         "name from a compiled map")
    ap.add_argument("--rule-id", type=int, default=None,
                    help="test this exact rule id (compiled maps)")
    ap.add_argument("--num-rep", type=int, default=3)
    ap.add_argument("--min-x", type=int, default=0)
    ap.add_argument("--max-x", type=int, default=1024)
    ap.add_argument("--mark-out", default="",
                    help="comma-separated osd ids to mark out")
    ap.add_argument("--reweight", default="",
                    help="osd:weight,... (e.g. 3:0.5,7:0)")
    ap.add_argument("--tries", type=int, default=7,
                    help="choose_total_tries tunable")
    ap.add_argument("--show-mappings", type=int, default=0, metavar="N",
                    help="print the first N mappings")
    ap.add_argument("--show-statistics", action=argparse.BooleanOptionalAction,
                    default=True, help="print the stats block")
    ap.add_argument("--oracle", action="store_true",
                    help="use the scalar oracle mapper (slow, for checking)")
    ap.add_argument("--json", action="store_true")
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = _device(args)
    from ..crush.compiler import CompileError, compile_text, decompile
    from ..crush.map import (CRUSH_ITEM_NONE, CrushMap, Tunables,
                             build_hierarchy, ec_rule, replicated_rule)
    from ..crush.mapper import VectorMapper, full_weights
    from ..utils.encoding import EncodingError

    if args.decompile:
        # binary wire form -> editable text (crushtool -d)
        with open(args.decompile, "rb") as f:
            try:
                m = CrushMap.decode(f.read())
            except (EncodingError, ValueError) as e:
                raise SystemExit(
                    f"crushtool: {args.decompile}: not a crush map "
                    f"({e})")
        text = decompile(m)
        if args.outfn:
            with open(args.outfn, "w") as f:
                f.write(text)
        else:
            sys.stdout.write(text)
        return

    if args.compile_txt:
        # text -> map (crushtool -c); -o writes the binary wire form;
        # --test runs placements against the compiled map
        with open(args.compile_txt) as f:
            try:
                m = compile_text(f.read())
            except (CompileError, ValueError) as e:
                raise SystemExit(f"crushtool: {args.compile_txt}: {e}")
        if args.outfn:
            with open(args.outfn, "wb") as f:
                f.write(m.encode())
            print(f"wrote {args.outfn} ({len(m.buckets)} buckets, "
                  f"{len(m.rules)} rules)")
        if not args.test:
            if not args.outfn:  # compile-only: confirm what was built
                print(f"compiled map: {m.n_devices} osds, "
                      f"{len(m.buckets)} buckets, {len(m.rules)} rules, "
                      f"depth {m.pack().max_depth}")
            return
        # pick the test rule: --rule-id wins; a single-rule map is
        # unambiguous; otherwise match --rule against rule names
        rules = sorted(m.rules)
        if args.rule_id is not None:
            if args.rule_id not in m.rules:
                raise SystemExit(
                    f"crushtool: no rule id {args.rule_id} "
                    f"(map has {rules})")
            rule_id = args.rule_id
        elif len(rules) == 1:
            rule_id = rules[0]
        else:
            by_name = {r.name: rid for rid, r in m.rules.items()}
            if args.rule in by_name:
                rule_id = by_name[args.rule]
            elif args.rule == "replicated" and 0 in m.rules:
                rule_id = 0
            elif args.rule == "ec" and 1 in m.rules:
                rule_id = 1
            else:
                raise SystemExit(
                    f"crushtool: ambiguous rule; pass --rule-id "
                    f"(map has ids {rules}, names "
                    f"{sorted(by_name)})")
        args.num_osds = m.n_devices
    elif args.build:
        m = build_hierarchy(args.num_osds, args.osds_per_host,
                            args.hosts_per_rack, alg=args.alg)
        m.tunables = Tunables(choose_total_tries=args.tries)
        replicated_rule(m, 0, choose_type=1, firstn=True)
        ec_rule(m, 1, choose_type=1)
        if args.outfn:
            with open(args.outfn, "wb") as f:
                f.write(m.encode())
            print(f"wrote {args.outfn}")
        rule_id = 0 if args.rule == "replicated" else 1
    else:
        raise SystemExit("need --build, --compile, or --decompile")

    if not args.test:
        print(f"built map: {args.num_osds} osds, "
              f"{len(m.buckets)} buckets, depth {m.pack().max_depth}")
        return

    weights = full_weights(args.num_osds)
    for tok in filter(None, args.mark_out.split(",")):
        weights[int(tok)] = 0
    for tok in filter(None, args.reweight.split(",")):
        osd, w = tok.split(":")
        weights[int(osd)] = int(float(w) * 0x10000)

    xs = np.arange(args.min_x, args.max_x, dtype=np.uint32)
    n = args.num_rep
    if args.oracle:
        from ..crush.oracle import OracleMapper
        om = OracleMapper(m)
        t0 = time.perf_counter()
        rows = [om.do_rule(rule_id, int(x), weights, n) for x in xs]
        out = np.array([(r + [CRUSH_ITEM_NONE] * n)[:n] for r in rows],
                       dtype=np.int64)
        dt = time.perf_counter() - t0
    else:
        vm = VectorMapper(m, device=device)
        vm.do_rule(rule_id, xs, weights, n).cpu()
        t0 = time.perf_counter()
        out = vm.do_rule(rule_id, xs, weights, n).cpu().numpy()
        dt = time.perf_counter() - t0

    real = out[out != CRUSH_ITEM_NONE]
    counts = np.bincount(real, minlength=args.num_osds)
    in_w = weights.astype(np.float64) / 0x10000
    expect = len(xs) * n * (in_w / in_w.sum())
    fill = (out != CRUSH_ITEM_NONE).mean()
    stats = {
        "rule": args.rule, "num_rep": n, "inputs": len(xs),
        "fill": round(float(fill), 6),
        "seconds": round(dt, 4),
        "mappings_per_s": round(len(xs) / dt, 1),
        "device_util_min": int(counts.min()),
        "device_util_max": int(counts.max()),
        "device_util_stddev_vs_expected": round(float(
            np.std((counts - expect)[in_w > 0])), 2),
    }
    for i in range(min(args.show_mappings, len(xs))):
        print(f"CRUSH rule {rule_id} x {int(xs[i])} "
              f"{[int(v) if v != CRUSH_ITEM_NONE else -1 for v in out[i]]}")
    if args.json:
        print(json.dumps(stats))
    elif args.show_statistics:
        for k, v in stats.items():
            print(f"{k}: {v}")


if __name__ == "__main__":
    main()
