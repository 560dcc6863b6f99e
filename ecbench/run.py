"""One run of one benchmark cell on the card.

    python3 -m ecbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up the cell (its pool made on the card from the seed, every shape
warmed), measures for --seconds, checks a sample of the window's
outputs against the plain reference, and prints one JSON line last on
standard output (with --trace 1 the per-layer metrics, else the
end-to-end ones). Exits 2 without a result where CUDA or the cell's
cards are missing, and 3 where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("OMP_NUM_THREADS", "1")


def card_line() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ecbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import harness as H

    man = H.manifest()
    try:
        cell = H.cell(man, args.workload)
    except KeyError as e:
        H.log(str(e))
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        H.log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(1)
    out = H.run_cell(args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", 0), T_START)
    H.log(f"card: {card_line()}")
    bad = H.forbidden_modules()
    if bad:
        H.log(f"loaded in this process: {', '.join(bad)}; no result")
        return 3
    for n, c in out["checks"].items():
        H.log(f"check {n} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
