"""CRUSH text compiler/decompiler.

Rebuild of the reference's map text tooling (ref: src/crush/
CrushCompiler.{h,cc} — `crushtool -d` decompiles a map to the editable
text form, `crushtool -c` compiles it back; the canonical grammar is
the one in the upstream docs: tunable lines, `device N osd.N`,
`type N <name>`, bucket blocks `<typename> <name> { id/alg/hash/item }`,
and rule blocks with `step take/choose/chooseleaf/emit`).

Round-trip property: compile(decompile(m)) places identically to m —
pinned by tests/test_crushtext.py.
"""

from __future__ import annotations

from .map import (ALG_NAMES, _SUPPORTED_ALGS, CrushMap, Rule, Step,
                  STEP_CHOOSE_FIRSTN, STEP_CHOOSE_INDEP,
                  STEP_CHOOSELEAF_FIRSTN, STEP_CHOOSELEAF_INDEP,
                  STEP_EMIT, STEP_TAKE, Tunables)

_CHOOSE_OPS = {
    ("choose", "firstn"): STEP_CHOOSE_FIRSTN,
    ("choose", "indep"): STEP_CHOOSE_INDEP,
    ("chooseleaf", "firstn"): STEP_CHOOSELEAF_FIRSTN,
    ("chooseleaf", "indep"): STEP_CHOOSELEAF_INDEP,
}
_OP_WORDS = {v: k for k, v in _CHOOSE_OPS.items()}


class CompileError(ValueError):
    pass


# ---------------------------------------------------------------- decompile

def decompile(m: CrushMap) -> str:
    """Map -> editable text (crushtool -d)."""
    lines: list[str] = ["# begin crush map",
                        f"tunable choose_total_tries "
                        f"{m.tunables.choose_total_tries}", ""]
    lines.append("# devices")
    for d in range(m.n_devices):
        lines.append(f"device {d} osd.{d}")
    lines.append("")
    lines.append("# types")
    for tid in sorted(m.types):
        lines.append(f"type {tid} {m.types[tid]}")
    lines.append("")
    lines.append("# buckets")

    def item_name(it: int) -> str:
        return f"osd.{it}" if it >= 0 else m.buckets[it].name

    # children before parents so every reference is already defined
    for bid in sorted(m.buckets, key=lambda b: (m.depth_below(b), -b)):
        b = m.buckets[bid]
        tname = m.types.get(b.type_id, f"type{b.type_id}")
        lines.append(f"{tname} {b.name} {{")
        lines.append(f"\tid {b.id}")
        lines.append(f"\talg {ALG_NAMES[b.alg]}")
        lines.append(f"\thash {b.hash_id}\t# rjenkins1")
        for it, w in zip(b.items, b.weights):
            # .5f makes text->map exact for any 16.16 weight
            # (0.00001 * 65536 < 1), matching the reference's precision
            lines.append(f"\titem {item_name(it)} "
                         f"weight {w / 65536.0:.5f}")
        lines.append("}")
    lines.append("")
    lines.append("# rules")
    for rid in sorted(m.rules):
        r = m.rules[rid]
        indep = any(s.op in (STEP_CHOOSE_INDEP, STEP_CHOOSELEAF_INDEP)
                    for s in r.steps)
        lines.append(f"rule {r.name} {{")
        lines.append(f"\tid {r.id}")
        lines.append(f"\ttype {'erasure' if indep else 'replicated'}")
        for s in r.steps:
            if s.op == STEP_TAKE:
                lines.append(f"\tstep take {item_name(s.arg)}")
            elif s.op == STEP_EMIT:
                lines.append("\tstep emit")
            else:
                kw, mode = _OP_WORDS[s.op]
                tname = m.types.get(s.type_id, f"type{s.type_id}")
                lines.append(f"\tstep {kw} {mode} {s.arg} type {tname}")
        lines.append("}")
    lines.append("# end crush map")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------------ compile

def _tokens(text: str):
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        yield ln, line.replace("{", " { ").replace("}", " } ").split()


def compile_text(text: str) -> CrushMap:
    """Text -> map (crushtool -c). Grammar errors raise CompileError
    with the line number."""
    m = CrushMap()
    type_by_name: dict[str, int] = {}
    bucket_by_name: dict[str, int] = {}
    toks = list(_tokens(text))
    i = 0

    def err(ln: int, msg: str):
        raise CompileError(f"line {ln}: {msg}")

    def resolve_item(ln: int, name: str) -> int:
        if name.startswith("osd."):
            try:
                return int(name[4:])
            except ValueError:
                err(ln, f"bad device name {name!r}")
        if name in bucket_by_name:
            return bucket_by_name[name]
        err(ln, f"unknown item {name!r} (buckets must be defined "
                f"before use)")

    def parse_block(start: int) -> tuple[list[tuple], int]:
        """Collect lines until the matching '}' (flat blocks only)."""
        body = []
        j = start
        while j < len(toks):
            ln, words = toks[j]
            if words == ["}"]:
                return body, j + 1
            body.append((ln, words))
            j += 1
        err(toks[start - 1][0], "unterminated block")

    while i < len(toks):
        ln, words = toks[i]
        head = words[0]
        if head == "tunable":
            if len(words) != 3:
                err(ln, "tunable <name> <value>")
            if words[1] == "choose_total_tries":
                m.tunables = Tunables(choose_total_tries=int(words[2]))
            i += 1
        elif head == "device":
            if len(words) != 3 or not words[2].startswith("osd."):
                err(ln, "device <id> osd.<id>")
            m.max_device = max(m.max_device, int(words[1]))
            i += 1
        elif head == "type":
            if len(words) != 3:
                err(ln, "type <id> <name>")
            tid = int(words[1])
            m.add_type(tid, words[2])
            type_by_name[words[2]] = tid
            i += 1
        elif head == "rule":
            if len(words) != 3 or words[2] != "{":
                err(ln, "rule <name> {")
            rname = words[1]
            body, i = parse_block(i + 1)
            rid = None
            steps: list[Step] = []
            for bln, bw in body:
                if bw[0] == "id":
                    rid = int(bw[1])
                elif bw[0] == "type":
                    pass  # replicated/erasure is derived from steps
                elif bw[0] in ("min_size", "max_size"):
                    pass  # legacy fields, accepted and ignored
                elif bw[0] == "step":
                    if len(bw) < 2:
                        err(bln, "bare 'step'")
                    if bw[1] == "take":
                        # reject qualifiers we don't implement (e.g.
                        # 'class ssd') rather than silently dropping a
                        # placement constraint
                        if len(bw) != 3:
                            err(bln, "step take <bucketname> (device-"
                                     "class qualifiers unsupported)")
                        steps.append(Step(STEP_TAKE,
                                          arg=resolve_item(bln, bw[2])))
                    elif bw[1] == "emit":
                        steps.append(Step(STEP_EMIT))
                    elif len(bw) >= 3 and (bw[1], bw[2]) in _CHOOSE_OPS:
                        if len(bw) != 6 or bw[4] != "type":
                            err(bln, "step choose* <firstn|indep> <n> "
                                     "type <typename>")
                        if bw[5] not in type_by_name:
                            err(bln, f"unknown type {bw[5]!r}")
                        steps.append(Step(_CHOOSE_OPS[(bw[1], bw[2])],
                                          arg=int(bw[3]),
                                          type_id=type_by_name[bw[5]]))
                    else:
                        err(bln, f"unknown step {bw[1]!r}")
                else:
                    err(bln, f"unknown rule field {bw[0]!r}")
            if rid is None:
                err(ln, f"rule {rname!r} has no id")
            m.add_rule(rid, steps, name=rname)
        elif head in type_by_name:
            # bucket block: <typename> <name> {
            if len(words) != 3 or words[2] != "{":
                err(ln, f"{head} <name> {{")
            bname = words[1]
            body, i = parse_block(i + 1)
            bid = alg = None
            hash_id = 0
            items: list[int] = []
            weights: list[float] = []
            for bln, bw in body:
                if bw[0] == "id":
                    bid = int(bw[1])
                elif bw[0] == "alg":
                    if bw[1] not in _SUPPORTED_ALGS:
                        err(bln, f"unknown alg {bw[1]!r}")
                    alg = bw[1]
                elif bw[0] == "hash":
                    hash_id = int(bw[1])
                elif bw[0] == "item":
                    w = 1.0
                    if len(bw) >= 4 and bw[2] == "weight":
                        w = float(bw[3])
                    items.append(resolve_item(bln, bw[1]))
                    weights.append(w)
                else:
                    err(bln, f"unknown bucket field {bw[0]!r}")
            if bid is None:
                err(ln, f"bucket {bname!r} has no id")
            if alg is None:
                err(ln, f"bucket {bname!r} has no alg")
            b = m.add_bucket(bid, type_by_name[head], alg, items,
                             weights, name=bname)
            b.hash_id = hash_id
            bucket_by_name[bname] = bid
        else:
            err(ln, f"unknown directive {head!r}")

    # topmost bucket (referenced by nothing) becomes the default root
    referenced = {it for b in m.buckets.values() for it in b.items
                  if it < 0}
    roots = [bid for bid in m.buckets if bid not in referenced]
    if len(roots) == 1:
        m.root_id = roots[0]
    m.validate()
    return m
