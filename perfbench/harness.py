"""The benchmark's one general runner: it knows no configuration, traffic,
driver or metric by name.

A cell named in ``BENCHMARK.json`` is a file ``workloads/<cell>.json``
under the benchmark's folder, which names its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``), its
driver (``drivers/<driver>.py``, a class ``Driver``) and the limits of its
correctness check.  Each metric is ``metrics/<metric>.py``, whose ``read``
takes the run's record and returns a number, or None when the run holds
nothing to read.  A later cell, configuration, driver or metric is a new
file and a new entry: nothing here changes.

A run: the driver's set-up (warming every shape the window uses), the
measured window, with ``--trace 1`` a short sub-window under the profiler,
then the driver frees the program's state and checks the timed path's
output against the plain reference.  ``run.py`` prints the result as the
last line of standard output.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch


@dataclass
class Context:
    """What a driver is given, and the record it fills for the readers."""
    cell: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    trace: bool
    device: torch.device
    chips: int
    record: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Check:
    """One number compared, with its limit: correct while value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str):
    """The Python file at ``path`` as a module (names may hold dots)."""
    name = prefix + "_" + "".join(c if c.isalnum() else "_"
                                  for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(spec: Dict[str, Any], cell: str) -> Dict[str, Any]:
    for w in spec["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in the benchmark; cells: "
                   f"{[w['name'] for w in spec['workloads']]}")


def metrics_of(spec: Dict[str, Any], cell: str, trace: bool
               ) -> List[Dict[str, Any]]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones:
    those that list the cell, and those that list no cells (for a per-layer
    metric: when the cell reports the end-to-end metric it moves)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def device_for(chips: int, device: Optional[str]) -> torch.device:
    """The card, which must exist; ``device`` names another only for the
    harness's own tests."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise SystemExit("perfbench: no CUDA device (torch.cuda.is_available()"
                         " is False): nothing is measured")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"perfbench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def device_block(ctx: Context, summary) -> Dict[str, Any]:
    if ctx.device.type == "cuda":
        out = {"platform": "gpu",
               "kind": torch.cuda.get_device_name(ctx.device),
               "count": ctx.chips,
               "memory_peak_bytes": int(ctx.record.get(
                   "memory_peak_bytes", 0))}
    else:
        out = {"platform": ctx.device.type, "kind": ctx.device.type,
               "count": ctx.chips, "memory_peak_bytes": 0}
    if summary is not None:
        out["busy_s"] = summary.busy_s
        out["window_s"] = summary.window_s
    return out


def span_mean(rec: Dict[str, Any], name: str) -> Optional[float]:
    """The mean of the program's spans of one name kept in the record, or
    None when it holds none."""
    v = rec.get("spans", {}).get(name)
    return sum(v) / len(v) if v else None


def context(cell: str, seed: int, trace: bool, *, bench_dir: Path,
            spec: Dict[str, Any], device: Optional[str] = None) -> Context:
    """A cell's files, read by the names ``BENCHMARK.json`` gives."""
    entry = cell_entry(spec, cell)
    wl = load_json(bench_dir / "workloads" / f"{cell}.json")
    return Context(cell=cell, workload=wl,
                   config=load_json(bench_dir / "configs"
                                    / f"{wl['config']}.json"),
                   traffic=load_json(bench_dir / "traffic"
                                     / f"{wl['traffic']}.json"),
                   seed=int(seed), trace=bool(trace),
                   device=device_for(int(entry["chips"]), device),
                   chips=int(entry["chips"]))


def driver_module(ctx: Context, bench_dir: Path):
    return load_module(bench_dir / "drivers"
                       / f"{ctx.workload['driver']}.py", "perfbench_driver")


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             bench_dir: Path, spec: Dict[str, Any], t_start: float,
             device: Optional[str] = None,
             emit: Callable[[str], None] = print) -> Dict[str, Any]:
    """Run one cell once; returns its result."""
    ctx = context(cell, seed, trace, bench_dir=bench_dir, spec=spec,
                  device=device)
    wanted = metrics_of(spec, cell, trace)
    readers = {m["name"]: load_module(bench_dir / "metrics"
                                      / f"{m['name']}.py", "perfbench_metric")
               for m in wanted}
    drv = driver_module(ctx, bench_dir).Driver(ctx)

    drv.setup()
    ctx.record["setup_s"] = time.perf_counter() - t_start
    drv.window(float(seconds))
    summary = drv.traced() if trace else None
    ctx.record["trace"] = summary
    if ctx.device.type == "cuda":
        ctx.record["memory_peak_bytes"] = max(
            torch.cuda.max_memory_allocated(d) for d in range(ctx.chips))
    # a number that is not finite fails its check, and is printed as the
    # largest float so that the result stays plain JSON
    checks: List[Check] = [
        Check(c.name, c.value if math.isfinite(c.value) else 1.0e308,
              c.limit) for c in drv.check()]

    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(ctx.record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    for line in drv.notes():
        emit(line)
    correct = all(c.ok for c in checks)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    result = {"correct": correct,
              "attempted": int(ctx.record.get("attempted", 0)),
              "failed": int(ctx.record.get("failed", 0)),
              "metrics": metrics,
              "device": device_block(ctx, summary)}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result
