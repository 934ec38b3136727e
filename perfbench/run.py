"""Run one benchmark cell once, from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It measures the PyTorch/CUDA port (``src/repro_torch``) on the card, checks
what the timed path produced against the plain reference, and prints the
result as the last line of standard output (``perfbench/README.md``).  It
exits with another code than 0, and prints no result, without a CUDA
device, without the port's sources, or when a module of JAX or of the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: the port's sources are not under {ROOT / 'src'}",
              file=sys.stderr)
        return 2
    # caches of the program stay inside the checkout, at fixed paths
    cache = BENCH / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import guard
    from perfbench.harness import load_json, run_cell
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench_dir=BENCH,
                      spec=load_json(ROOT / "BENCHMARK.json"),
                      t_start=T_START)
    found = guard.forbidden_modules()
    print(f"[imports] forbidden modules loaded: {found or 'none'}; the "
          f"reference and generator import of the program: "
          f"{guard.program_imports(BENCH) or 'nothing'}", flush=True)
    if found:
        print(f"perfbench: {found} loaded in the measuring process",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
