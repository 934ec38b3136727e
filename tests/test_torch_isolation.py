"""The port stands alone: ``repro_torch`` imports neither JAX nor the JAX
reference package ``repro``, and it does not fall back to the CPU when a
CUDA device is expected.  The ``gpu`` test (a catalog scenario on the card
against its host ``numpy`` run) skips without a CUDA device; on the card's
machine: ``python -m pytest -q -m gpu tests/test_torch_isolation.py``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.ckpt import RecoveryManager, SimTrainState
from repro_torch.core.service import PerfTrackerService
from repro_torch.core.simulation import SimConfig
from repro_torch.online import OnlinePipeline, ScenarioRunner
from repro_torch.online.catalog import by_name, evaluate, run_scenario

from _torch_trace import run_trace

SRC = Path(__file__).resolve().parents[1] / "src"


def test_importing_every_module_pulls_in_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20


def test_sources_name_no_jax_or_reference_import():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                     r"from\s+(jax|repro)\b(?!_))", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, (f, hits)


def test_service_without_cuda_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PerfTrackerService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PerfTrackerService(summarize_backend="numpy", device="cuda")
    svc = PerfTrackerService(device="cpu")
    assert svc.device.type == "cpu"
    assert svc.summarize_backend.name == "torch"


def test_online_entry_points_without_cuda_raise_unless_cpu_is_asked(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = by_name("C1P1_gpu_throttle")
    for make in (lambda: OnlinePipeline(4),
                 lambda: ScenarioRunner(SimConfig(n_workers=4), []),
                 lambda: run_scenario(sc),
                 lambda: run_scenario(sc, summarize_backend="numpy"),
                 lambda: SimTrainState(seed=3),
                 lambda: RecoveryManager.for_sim(seed=3, save_every=0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert OnlinePipeline(4, device="cpu").service.device.type == "cpu"
    assert SimTrainState(seed=3, device="cpu").params["w"].device.type \
        == "cpu"
    mgr = RecoveryManager.for_sim(seed=3, save_every=0, device="cpu")
    assert mgr.state.params["mu"].device.type == "cpu"
    mgr.close()
    runner = ScenarioRunner(SimConfig(n_workers=4), [], device="cpu")
    assert runner.pipeline.service.summarize_backend.name == "torch"


@pytest.mark.gpu
def test_catalog_scenario_on_card_equals_numpy_run():
    """One catalog scenario on the card (every window's Algorithm 1 in K1)
    gives its host ``numpy`` run's incidents, plans and windows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.pattern_summary import pattern_summary
    sc = by_name("C1P1_gpu_throttle")
    before = pattern_summary.launches_by_variant["warp"]
    runner, res = run_scenario(sc)
    assert runner.pipeline.service.summarize_backend.name == "cuda"
    assert pattern_summary.launches_by_variant["warp"] - before \
        >= sc.n_windows
    host, host_res = run_scenario(sc, device="cpu",
                                  summarize_backend="numpy")
    assert evaluate(sc, runner, res) == evaluate(sc, host, host_res)
    assert all(row["ok"] for row in evaluate(sc, runner, res))
    assert run_trace(runner, res) == run_trace(host, host_res)
    runner.engine.recovery.close()
    host.engine.recovery.close()
