"""The harness on the CPU: every cell end to end at a toy size, additions
taken as data, the import checks, and the refusals of ``run.py``."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import guard
from perfbench.tests import toy

ROOT = toy.BENCH.parent
CELLS = [w["name"] for w in toy.SPEC["workloads"]]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return toy.toy_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct_at_toy_size(bench, cell, trace):
    res = toy.run_toy(bench, cell, trace=trace, seconds=1.0)
    assert res["correct"], res
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    # device metrics have nothing to read on the CPU: they stay out
    want = {m["name"] for m in toy.SPEC["end_to_end"]
            if cell in m.get("workloads", [cell])
            and m["source"] != "device_trace"}
    if trace:
        want = {m["name"] for m in toy.SPEC["per_layer"]
                if cell in m["workloads"] and m["source"] != "device_trace"}
    # a window close needs window_steps steps inside the window, which a
    # loaded CPU may not reach
    assert want - {"train.window_close_s"} <= set(res["metrics"]) <= want


def test_additions_are_data(bench, tmp_path):
    """A new configuration, traffic, cell, driver and metric, as new files
    and new entries, run with no change to any file already there."""
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "configs" / "toy-cfg.json").write_text(json.dumps({"n": 3}))
    (bench / "traffic" / "toy-traffic.json").write_text(
        json.dumps({"reps": 4}))
    (bench / "workloads" / "toy.cell.json").write_text(json.dumps({
        "config": "toy-cfg", "traffic": "toy-traffic", "driver": "toydrv",
        "why": "a throwaway cell", "limits": {"err": 0.5}}))
    (bench / "drivers" / "toydrv.py").write_text('''
from perfbench.harness import Check


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self):
        self.n = self.ctx.config["n"] * self.ctx.traffic["reps"]

    def window(self, seconds):
        self.ctx.record.update(window_s=1.0, count=self.n, attempted=self.n)

    def traced(self):
        return None

    def check(self):
        return [Check("err", 0.0, self.ctx.workload["limits"]["err"])]

    def notes(self):
        return []
''')
    (bench / "metrics" / "toy.ops_per_s.py").write_text(
        "def read(rec):\n    return rec['count'] / rec['window_s']\n")
    spec = json.loads(json.dumps(toy.SPEC))
    spec["configs"].append({"name": "toy-cfg", "source": "none",
                            "file": "x", "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": "toy.cell", "config": "toy-cfg",
                              "traffic": "toy-traffic", "chips": 1,
                              "why": "toy"})
    spec["end_to_end"].append({"name": "toy.ops_per_s", "unit": "1/s",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["toy.cell"]})
    res = toy.run_toy(bench, "toy.cell", spec=spec)
    assert res["correct"]
    assert res["metrics"]["toy.ops_per_s"]["value"] == 12.0
    assert "setup_s" in res["metrics"]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like.x", None)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", None)
    assert not [m for m in guard.forbidden_modules()
                if m.startswith(("repro_torch", "jaxtyping"))]
    monkeypatch.setitem(sys.modules, "repro.core", None)
    assert "repro.core" in guard.forbidden_modules()


def test_generator_and_reference_import_nothing_of_the_program():
    assert guard.program_imports(toy.BENCH) == []


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A fresh process runs each cell at a toy size: afterwards
    no module named jax, jaxlib, flax or repro is loaded."""
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from pathlib import Path\n"
        "from perfbench.tests import toy\n"
        "from perfbench import guard\n"
        "b = toy.toy_bench(Path(%r))\n"
        "for c in %r:\n"
        "    assert toy.run_toy(b, c, seconds=0.1)['correct']\n"
        "print(json.dumps(guard.forbidden_modules()))\n"
        % (str(ROOT / "src"), str(ROOT), str(tmp_path), CELLS))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _run_py(cwd: Path):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_run_refuses_without_a_card():
    out = _run_py(ROOT)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_run_refuses_without_the_port(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(toy.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run_py(tmp_path)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_the_contract():
    spec = toy.SPEC
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for w in spec["workloads"]:
        wl = toy.load_json(toy.BENCH / "workloads" / f"{w['name']}.json")
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        assert (toy.BENCH / "drivers" / f"{wl['driver']}.py").is_file()
        assert len(w["why"]) <= 200
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (toy.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
