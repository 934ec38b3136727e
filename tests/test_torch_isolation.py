"""The port stands alone: ``repro_torch`` imports neither JAX nor the JAX
reference package ``repro``, and it does not fall back to the CPU when a
CUDA device is expected."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.service import PerfTrackerService

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
