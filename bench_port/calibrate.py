#!/usr/bin/env python3
"""Readings for the limits of a cell's comparison, in one process.

    python3 bench_port/calibrate.py --workload <name> --seconds <s> \
        --group program:<seed>,<seed>,... --group control=fp8:<seed>,... \
        --group fault=half_batch:<seed>,... --group full_precision:<seed>

Runs the cell's driver once for each seed of each group, at the cell's
own sizes and with a window of ``--seconds``: ``program`` as the
benchmark runs it, ``control=<name>`` with the comparison's control in
the program's place, ``fault=<name>`` with a fault planted in the timed
path, ``full_precision`` with the program under its full-precision
policy. Prints one JSON line per run: the group, the seed, the numbers
compared and the end-to-end metrics. The benchmark's own runs never run
this; ``PERF.md`` gives the limits set from its readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--group", action="append", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import run as bench
    bench._environment()
    from benchlib import registry
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = registry.load_cell(ROOT, args.workload)
    driver = registry.driver(cell.driver)
    for group in args.group:
        kind, seeds = group.split(":", 1)
        for seed in seeds.split(","):
            ns = bench.parse(["--workload", args.workload, "--seed", seed,
                              "--seconds", str(args.seconds)])
            if kind.startswith("control="):
                ns.control = kind.split("=", 1)[1]
            elif kind.startswith("fault="):
                ns.fault = kind.split("=", 1)[1]
            elif kind == "full_precision":
                ns.full_precision = True
            elif kind != "program":
                raise SystemExit(f"unknown group {kind!r}")
            opts = bench.Options(ns, torch.device("cuda", 0),
                                 time.perf_counter())
            out = driver.run(cell, opts)
            print(json.dumps({"group": kind, "seed": int(seed),
                              "checks": {c["name"]: c["value"]
                                         for c in out["checks"]},
                              "e2e": out["e2e"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
