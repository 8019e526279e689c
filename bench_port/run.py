#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``multimodalsimilar_tpu_torch``).

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on this machine's card: finds its
configuration, traffic mix and driver by name (``benchlib/registry.py``),
sets the program up and warms every shape the cell uses (``setup_s``),
measures for ``--seconds``, then compares what the timed path produced
with the plain reference (``reference/``). The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, read under ``torch.profiler``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each number compared
beside its limit. The same numbers are the last lines of standard error.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and when JAX, Flax, optax or the JAX package is
loaded once the window has closed and the result line, the per-layer
metric readers' values included, has been built. ``--control``, ``--fault`` and
``--full_precision`` run the comparison's controls, planted faults and
the program's full-precision witness (``calibrate.py``); the benchmark's
own runs use none of them.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multimodalsimilar_tpu")


def _environment() -> None:
    """Caches at fixed paths inside the checkout, and no JAX behind
    libraries that would load it."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list:
    """Modules whose whole top-level name is JAX's, Flax's, optax's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None,
                   help="run the comparison's control in the program's "
                        "place (calibration only)")
    p.add_argument("--fault", default=None,
                   help="plant a fault in the timed path (calibration "
                        "only)")
    p.add_argument("--full_precision", action="store_true",
                   help="run the program under its full-precision policy "
                        "with TF32 off, a witness beside the reference "
                        "(calibration only)")
    return p.parse_args(argv)


class Options:
    def __init__(self, args, device, t_start):
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.control = args.control
        self.fault = args.fault
        self.full_precision = args.full_precision
        self.device = device
        self.t_start = t_start

    def log(self, what: str) -> None:
        """A line of the run's record on standard error, with the
        seconds since the process started."""
        print(f"[{time.perf_counter() - self.t_start:8.2f} s] {what}",
              file=sys.stderr, flush=True)


def verdict(checks: list) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks)


def result_line(cell, outcome: dict, trace: bool) -> dict:
    """The contract's last line (``checks`` last)."""
    from benchlib import registry
    import torch
    checks = outcome["checks"]
    if trace:
        metrics = registry.read_metrics(cell, outcome["obs"])
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {n: {"value": float(v), "unit": units[n]}
                   for n, v in outcome["e2e"].items() if n in units}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(outcome["memory_peak_bytes"])}
    line = {"correct": verdict(checks), "attempted": outcome["attempted"],
            "failed": outcome["failed"], "metrics": metrics,
            "device": device}
    if trace:
        dev = outcome["obs"]["device"]
        device["busy_s"] = dev["busy_s"]
        device["window_s"] = dev["window_s"]
        line["breakdown"] = {"device_ops": dev["device_ops"],
                             "idle_gaps": dev["idle_gaps"]}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    from benchlib import registry
    cell = registry.load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"bench_port: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    opts = Options(args, torch.device("cuda", 0), T_START)
    outcome = registry.driver(cell.driver).run(cell, opts)
    line = result_line(cell, outcome, opts.trace)
    bad = loaded_forbidden()
    if bad:
        print(f"bench_port: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
