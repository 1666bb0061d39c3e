"""The readings that a cell's limits are set from (not run by the
benchmark's own runs): on each seed, in one process, the program's
numbers (the timed path at the cell's sizes: set-up's checked steps, or
the checked requests), the control's (the reference computed in fp8 in the
program's place), and each fault's (the timed path broken underneath).

    python -m portbench.readings --workload <name> --seeds 1 2 3 \\
        [--control-seeds 4 5 6] [--fault-seeds 7 8 9] [--out file.jsonl]

One JSON line a reading: ``{"workload", "seed", "what", "numbers"}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

FAULTS = {"train": ("unchanged", "half"), "serve": ("half", "altered")}


def program_numbers(drv, cfg, traffic, seed, device, fault=None):
    from portbench import check

    c = drv.setup(cfg, traffic, seed, device, fault)
    if c.kind == "serve":
        for i in sorted(c.checked):
            c.item(i)
    numbers = c.check()
    if getattr(c, "compared", None):
        numbers["worst_leaves"] = check.worst_leaves(*c.compared)
    return c.kind, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from portbench.run import cache_env
    cache_env(Path.cwd().resolve())
    import torch

    from portbench import spec
    from portbench.drivers import common

    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA device", file=sys.stderr)
        return 3
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg, traffic = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    drv = spec.driver(traffic["kind"])
    out = open(args.out, "a") if args.out else None

    def emit(seed, what, numbers, t0):
        line = json.dumps({"workload": args.workload, "seed": seed, "what": what,
                           "numbers": numbers, "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        common.release()

    kind = None
    for seed in args.seeds:
        t0 = time.perf_counter()
        kind, numbers = program_numbers(drv, cfg, traffic, seed, "cuda:0")
        emit(seed, "program", numbers, t0)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        emit(seed, "control", drv.control(cfg, traffic, seed, "cuda:0"), t0)
    for seed in args.fault_seeds:
        for fault in FAULTS["serve" if traffic["kind"] == "serve_cohort" else "train"]:
            t0 = time.perf_counter()
            _, numbers = program_numbers(drv, cfg, traffic, seed, "cuda:0", fault)
            emit(seed, f"fault:{fault}", numbers, t0)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
