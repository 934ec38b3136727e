#!/usr/bin/env python3
"""The cost of the program's span (``instrument/tracer.py::span``).

Run from the repository root:

    python3 tools/span_cost.py [--cell C] [--seed N] [--rounds 2] [--steps 8]

It prints the host's microseconds for one span opened and closed with the
record and the profiler off, with the record on (``record_spans``), and,
for scale, ``torch.profiler.record_function`` entered with the profiler
off.  On a machine with a CUDA card it then builds the benchmark's cell
``--cell`` (default ``train.mamba2-2.7b.plain``; mamba2-2.7b at its
published size, 1 x 2048 tokens) through its driver, and times blocks of
``--steps`` steps, each step ended by a wait for the card (the profiled
cell's window closing every ``window_steps`` steps, as in the benchmark),
in three variants in turns: ``none``, every span swapped for a null
context (the code before the spans), ``off``, the spans as they are with
the record off, and ``on``, the record on.  It prints the card's name
and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from repro_torch.instrument.tracer import record_spans, span  # noqa: E402


def us_per_span(n: int) -> float:
    t = time.perf_counter()
    for _ in range(n):
        with span("x"):
            pass
    return (time.perf_counter() - t) / n * 1e6


def host_costs(n: int = 200_000) -> None:
    record_spans(False)
    off = us_per_span(n)
    record_spans(True)
    on = us_per_span(n)
    record_spans(False)
    t = time.perf_counter()
    for _ in range(n // 10):
        with torch.profiler.record_function("x"):
            pass
    rf = (time.perf_counter() - t) / (n // 10) * 1e6
    print(f"[host] us a span: both off {off!r}, record on {on!r}; "
          f"record_function with the profiler off {rf!r}", flush=True)


def card_steps(cell: str, seed: int, rounds: int, steps: int) -> None:
    import contextlib
    import statistics
    from perfbench.harness import context, driver_module, load_json
    from repro_torch.instrument import tracer
    from repro_torch.optim import adamw
    from repro_torch.train import loop, step
    spec = load_json(ROOT / "BENCHMARK.json")
    ctx = context(cell, seed, False, bench_dir=ROOT / "perfbench", spec=spec)
    drv = driver_module(ctx, ROOT / "perfbench").Driver(ctx)
    drv.setup()
    every = int(ctx.traffic.get("window_steps", 0))
    users = (tracer, step, adamw, loop)
    times = {"none": [], "off": [], "on": []}
    spans = done = 0
    for variant in ["none", "off", "on", "on", "off", "none"] * rounds:
        for mod in users:
            mod.span = (span if variant != "none"
                        else lambda name: contextlib.nullcontext())
        record_spans(variant == "on")
        for _ in range(steps):
            t = time.perf_counter()
            drv._step()
            drv._sync()
            times[variant].append(time.perf_counter() - t)
            done += 1
            if every and done % every == 0:
                drv._close()
        spans += len(record_spans(False))
    for mod in users:
        mod.span = span
    for variant, v in times.items():
        print(f"[card] {cell} {variant}: {len(v)} steps, median "
              f"{statistics.median(v)!r} s, quartiles "
              f"{statistics.quantiles(v, n=4)!r}", flush=True)
    print(f"[card] spans recorded {spans} "
          f"({spans / len(times['on'])!r} a step with the record on)",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", default="train.mamba2-2.7b.plain")
    ap.add_argument("--seed", type=int, default=3250000101)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if torch.cuda.is_available():
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    host_costs()
    if torch.cuda.is_available():
        card_steps(args.cell, args.seed, args.rounds, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
