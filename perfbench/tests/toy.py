"""Toy-size copies of the benchmark's cells for the CPU tests: the same
files, drivers and readers, with the configuration cut to a two-layer model
so that a whole run takes about a second; and a toy profiling window."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from perfbench.gen import mamba2 as gm
from perfbench.harness import load_json, run_cell

BENCH = Path(__file__).resolve().parents[1]
SPEC = load_json(BENCH.parent / "BENCHMARK.json")

MAMBA = dict(num_layers=2, d_model=64, head_dim=16, d_state=16,
             chunk_size=16, vocab_size=250)
TRAFFIC = {"pretrain-2k.profiled": dict(seq_len=64, window_steps=2)}


def toy_bench(tmp: Path) -> Path:
    """A copy of the benchmark's folder whose configurations are toys."""
    out = tmp / "perfbench"
    shutil.copytree(BENCH, out, ignore=shutil.ignore_patterns(
        "tests", "__pycache__", ".cache"))
    for path in (out / "configs").glob("*.json"):
        c = load_json(path)
        c.update(MAMBA)
        c["n_params"] = gm.n_params(c)
        path.write_text(json.dumps(c))
    for name, over in TRAFFIC.items():
        path = out / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**load_json(path), **over}))
    return out


def run_toy(bench: Path, cell: str, seed: int = 2**31 + 5,
            seconds: float = 0.3, trace: bool = False,
            spec: Optional[Dict] = None) -> Dict:
    """A run on the CPU, torch on one thread (the suite runs beside
    timing-sensitive tests)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_cell(cell, seed, seconds, trace, bench_dir=bench,
                        spec=spec or SPEC, t_start=time.perf_counter(),
                        device="cpu", emit=lambda line: None)
    finally:
        torch.set_num_threads(threads)


def worker_profile(seed: int):
    """One worker's window as the program's tracer would record it: Python
    and GPU executions, some on another thread, some reading a stream the
    window lacks, and a cpu stream with zero runs."""
    from repro_torch.core.events import (FunctionEvent, Kind, SampleStream,
                                         WorkerProfile)
    rng = np.random.default_rng(seed)
    vals = rng.random(900)
    vals[rng.random(900) < 0.4] = 0.0
    events, t = [], 0.05
    for i in range(12):
        d = float(rng.uniform(0.05, 0.3))
        events.append(FunctionEvent("dataloader.next", Kind.PYTHON, t,
                                    t + d / 4))
        events.append(FunctionEvent("train.step", Kind.GPU, t + d / 4,
                                    t + d, depth=1, resource="cpu"))
        events.append(FunctionEvent("optimizer.step", Kind.PYTHON, t + d / 2,
                                    t + d, depth=2))
        events.append(FunctionEvent("xla.other", Kind.GPU, t, t + d / 2,
                                    depth=2))
        events.append(FunctionEvent("logger", Kind.PYTHON, t, t + d,
                                    thread="log"))
        t += d
    return WorkerProfile(worker=0, window=(0.0, t + 0.01), events=events,
                         streams={"cpu": SampleStream(300.0, 0.0, vals)})
