#!/usr/bin/env python3
"""Where a training step's peak of device memory goes: one step of a
benchmark cell's job under PyTorch's allocation history, the peak found by
replaying that history, and the bytes live at the peak grouped by what
allocated them.

  python3 tools/memory_peak.py [--cell train.mamba2-2.7b.plain] [--seed N]

Runs from the repository root on a machine with a CUDA card.  It builds
the cell's job with the benchmark's own code for the cell (``perfbench/``:
its weights, optimizer and batches from the seed, and the check's first
steps), then records one more step with ``torch.cuda.memory``'s history.
It prints the step's peak (replayed, and ``max_memory_allocated`` beside
it), the call that allocated the block that reached it, and the bytes live
at the peak: what was allocated before the step (parameters, optimizer
state) and, for the step's own blocks, by the innermost frame in the
port's package that allocated them, largest first.  Blocks that autograd's
engine allocates from C++ (a backward's own temporaries) carry no Python
frame and are grouped as such.
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

PACKAGE = "repro_torch"
FREED = ("free_completed", "free_requested")


def frame_of(event) -> str:
    """The innermost frame in the port's package of an allocation."""
    for f in event.get("frames", []):
        name = f.get("filename", "")
        if PACKAGE in name:
            short = name.split(PACKAGE + "/", 1)[-1]
            return f"{short}:{f.get('name', '?')}"
    return "(no frame in the port: autograd's engine or the benchmark)"


def replay(events, base: int):
    """(peak bytes, the index of the event that reached it, live blocks at
    it as {addr: event}) over ``events``, starting from ``base`` bytes."""
    freed = next((a for a in FREED if any(e["action"] == a
                                          for e in events)), FREED[0])
    cur, peak, at = base, base, -1
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            cur += e["size"]
            if cur > peak:
                peak, at = cur, i
        elif e["action"] == freed:
            cur -= e["size"]
    live = {}
    for e in events[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == freed:
            live.pop(e["addr"], None)
    return peak, at, live


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="train.mamba2-2.7b.plain")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("memory_peak: no CUDA device", file=sys.stderr)
        return 2
    bench = ROOT / "perfbench"
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    ctx = harness.context(args.cell, args.seed, False, bench_dir=bench,
                          spec=spec)
    drv = harness.driver_module(ctx, bench).Driver(ctx)
    t = time.perf_counter()
    drv.setup()
    torch.cuda.synchronize()
    step = getattr(drv, "_step", None)
    if step is None:
        print(f"memory_peak: the benchmark's code for {args.cell} has no "
              f"one-step call", file=sys.stderr)
        return 2
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="python")
    step()
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    allocator_peak = torch.cuda.max_memory_allocated()
    events = [e for e in snap["device_traces"][0]
              if e["action"] in ("alloc",) + FREED]
    peak, at, live = replay(events, base)
    groups = defaultdict(int)
    for e in live.values():
        groups[frame_of(e)] += e["size"]
    step_bytes = sum(groups.values())
    gb = 1e9
    print(f"[memory] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}; {args.cell} seed {args.seed}; set-up "
          f"{time.perf_counter() - t:.1f} s")
    print(f"[memory] one step: peak {peak} bytes ({peak / gb:.3f} GB) by "
          f"replay, max_memory_allocated {allocator_peak} bytes; held "
          f"before the step {base} bytes ({base / gb:.3f} GB); the step's "
          f"blocks live at the peak {step_bytes} bytes "
          f"({step_bytes / gb:.3f} GB) in {len(live)} blocks")
    if at >= 0:
        print(f"[memory] the block that reached the peak: "
              f"{events[at]['size']} bytes from {frame_of(events[at])}")
    for name, b in sorted(groups.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"[memory]   {b / gb:9.4f} GB  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
