"""The controls and planted faults of a cell's correctness check, read at
the cell's own size (not part of a benchmark run):

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--seconds s]

For each seed it prints, as one JSON line, what the cell's driver reads for
them: ``control_readings(ctx, seconds)`` of ``drivers/<driver>.py``, the
numbers the cell compares as the control (the reference in the precision
below the configuration's) and each planted fault would give them.  The
limits in ``workloads/<cell>.json`` lie between the program's readings and
these.  ``--seconds`` is the window a driver runs where its control needs
the program's output (default: ``BENCHMARK.json``'s ``run_seconds``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench.harness import context, driver_module, load_json  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args()
    cache = BENCH / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    spec = load_json(ROOT / "BENCHMARK.json")
    seconds = args.seconds or float(spec["run_seconds"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = context(args.workload, seed, False, bench_dir=BENCH, spec=spec)
        r = driver_module(ctx, BENCH).control_readings(ctx, seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t,
                          "readings": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
