#!/usr/bin/env python3
"""The dry run's reports as one markdown table (PERF.md's dry-run table):
a row per (arch, shape), the single-pod and multi-pod cells side by side.

    python3 tools/dryrun_table.py OUT_DIR

OUT_DIR is where ``tools/dryrun_parallel.sh`` (or ``python -m
repro_torch.launch.dryrun --out``) wrote its reports.  A cell reads
``status dominant, t_compute / t_memory / t_collective s, peak GB
(fraction of 80 GB), trace s``; a cell with no report, or ``[FAIL]`` in
``OUT_DIR/summary.txt``, reads ``FAIL``.  The roofline terms are analytic
(``launch/analysis.py``: the H100 SXM5 data sheet's peaks); the peak is
the report's ``total_per_device`` (arguments and the peak of live
temporaries) against the card's 80 GB; the trace seconds are the
report's ``compile_s``.
"""
import json
import sys
from pathlib import Path

HBM_BYTES = 80e9
MESHES = ("16x16", "2x16x16")


def cell(out: Path, mesh: str, arch: str, shape: str, failed: set) -> str:
    rep = out / mesh / f"{arch}__{shape}.json"
    if (mesh, arch, shape) in failed or not rep.exists():
        return "FAIL"
    r = json.loads(rep.read_text())
    t = r["roofline"]
    peak = r["memory"]["total_per_device"]
    return (f"ok {t['dominant']}, {t['t_compute_s']:.4f} / "
            f"{t['t_memory_s']:.4f} / {t['t_collective_s']:.4f}, "
            f"{peak / 1e9:.2f} ({peak / HBM_BYTES:.2f}), {r['compile_s']}")


def main(argv=None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.configs.base import shapes_for
    from repro_torch.configs.registry import ARCHS
    out = Path((argv or sys.argv[1:])[0])
    summary = out / "summary.txt"
    failed = set()
    if summary.exists():
        for ln in summary.read_text().splitlines():
            if ln.startswith("[FAIL]"):
                mesh, arch, shape = ln.split()[1:4]
                mesh = {"single": "16x16", "multi": "2x16x16"}.get(mesh, mesh)
                failed.add((mesh, arch, shape.rstrip(":")))
    print("| Arch | Shape | 16x16 (256 ranks) | 2x16x16 (512 ranks) |")
    print("| --- | --- | --- | --- |")
    for arch, cfg in ARCHS.items():
        for shape in shapes_for(cfg):
            print(f"| {arch} | {shape.name} | "
                  + " | ".join(cell(out, m, arch, shape.name, failed)
                               for m in MESHES) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
