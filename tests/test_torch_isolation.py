"""The port stands alone: ``repro_torch`` imports neither JAX nor the JAX
reference package ``repro`` nor ``msgpack`` (its frames are packed by its
own codec), and it does not fall back to the CPU when a CUDA device is
expected.  The ``gpu`` tests (a catalog scenario on the card against its
host ``numpy`` run; a serving scenario on the card) skip without a CUDA
device; on the card's machine:
``python -m pytest -q -m gpu tests/test_torch_isolation.py``."""
import ast
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


def test_examples_import_no_jax_and_no_reference():
    """The five examples (``examples_torch/``): importing each pulls in
    neither JAX nor ``repro``."""
    examples = sorted((SRC.parent / "examples_torch").glob("*.py"))
    assert [p.stem for p in examples] == [
        "diagnose_ring_fault", "online_demo", "quickstart", "serve_lm",
        "train_lm"]
    code = (
        "import importlib.util, sys\n"
        "for path in sys.argv[1:]:\n"
        "    spec = importlib.util.spec_from_file_location('ex', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code, *map(str, examples)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_sources_name_no_jax_or_reference_import():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                     r"from\s+(jax|repro)\b(?!_))", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    files += sorted((SRC.parent / "examples_torch").glob("*.py"))
    assert len(files) > 20
    assert SRC.parent / "examples_torch/online_demo.py" in files
    assert SRC / "repro_torch/models/moe.py" in files
    assert SRC / "repro_torch/models/attention.py" in files
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, (f, hits)


def _imported_modules(path: Path) -> set:
    """Every module ``path`` imports, at its top or inside a function; a
    ``from m import n`` names both m and m.n."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


def test_kernels_and_models_import_no_launcher():
    """The launcher (``repro_torch.launch``: the step cost, the dry run)
    calls the models and the kernels, never the other way round."""
    files = sorted((SRC / "repro_torch/kernels").glob("*.py")) \
        + sorted((SRC / "repro_torch/models").glob("*.py"))
    assert SRC / "repro_torch/models/attention_core.py" in files
    for f in files:
        bad = [n for n in _imported_modules(f)
               if n == "repro_torch.launch"
               or n.startswith("repro_torch.launch.")]
        assert not bad, (f, bad)


def test_no_kernel_wrapper_imports_another():
    """Each kernel wrapper imports the shared ``kernels.common`` and
    ``kernels._build`` and no other wrapper."""
    kernels = SRC / "repro_torch/kernels"
    wrappers = {p.stem for p in kernels.glob("*.py")} - {
        "__init__", "_build", "common"}
    assert wrappers == {"pattern_summary", "flash_attention", "ssd_scan",
                        "rms_norm", "causal_conv", "cross_entropy"}
    for f in sorted(kernels.glob("*.py")):
        used = {n.split(".")[2] for n in _imported_modules(f)
                if n.startswith("repro_torch.kernels.")}
        assert not (used & wrappers) - {f.stem}, (f, used)


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


def test_model_init_without_cuda_raises_unless_cpu_is_asked(monkeypatch):
    """``Transformer.init``, ``Transformer.init_cache`` and
    ``params_from_reference`` build on the card when no device is given,
    and raise on a host without one."""
    import numpy as np
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.transformer import Transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Transformer(reduced(ARCHS["deepseek-v2-lite-16b"]))
    tree = {"embed": {"table": np.zeros((4, 2), np.float32)}}
    for make in (lambda: model.init(0), lambda: model.init_cache(2, 8),
                 lambda: params_from_reference(tree, model.cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert model.init(0, device="cpu")["embed"]["table"].device.type == "cpu"
    cache = model.init_cache(2, 8, device="cpu")
    assert cache[0]["latent"].device.type == "cpu"


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


def test_no_module_imports_msgpack():
    """Neither in ``sys.modules`` after importing every module of the port
    nor as an import line in its sources (the card's machine has no
    msgpack)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('msgpack', 'jax', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.transport.tree' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    pat = re.compile(r"^\s*(import\s+msgpack\b|from\s+msgpack\b)", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    assert any(f.name == "codec.py" for f in files)
    for f in files:
        assert not pat.findall(f.read_text()), f


def test_serving_and_wire_entry_points_without_cuda_raise_unless_cpu_is_asked(
        monkeypatch, tmp_path):
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.core.daemon import PerfTrackerDaemon
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.workload import ServeWorkload
    from repro_torch.transport import DaemonServer, WindowCollector
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(ARCHS["gemma2-2b"])
    collector = WindowCollector([0])
    with DaemonServer(collector) as server:
        for make in (lambda: Engine(cfg, None, ServeConfig()),
                     lambda: ServeWorkload(n_workers=2),
                     lambda: PerfTrackerDaemon(0, server.address),
                     lambda: PerfTrackerDaemon(0, server.address,
                                               backend="numpy"),
                     lambda: PerfTrackerService(summarize_backend="numpy"),
                     lambda: ScenarioRunner(SimConfig(n_workers=4), [],
                                            summarize_backend="numpy")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        assert Engine(cfg, None, ServeConfig(), device="cpu").device.type \
            == "cpu"
        assert ServeWorkload(n_workers=2, device="cpu").device.type == "cpu"
        d = PerfTrackerDaemon(0, server.address, device="cpu")
        assert d.backend.name == "torch"
        d.close()
    svc = PerfTrackerService(summarize_backend="numpy", device="cpu")
    assert svc.diagnose_profiles([], mode="wire").fleet_size == 0


@pytest.mark.gpu
def test_serve_scenario_on_card_localizes_burst():
    """One serving scenario on the card: a 4-worker ``ServeWorkload`` of the
    reference's tiny gemma2-2b, ``BurstArrivals`` on every worker in
    windows 2-6, every window's Algorithm 1 in K1: the slo incident on the
    queue wait of all 4 workers, shedding load first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.mitigation import Action
    from repro_torch.kernels.pattern_summary import pattern_summary
    from repro_torch.online import ScheduledFault
    from repro_torch.serve.workload import (QUEUE_WAIT, BurstArrivals,
                                            ServeWorkload)
    from repro_torch.train.workload import default_trainer_detector_cfg
    wl = ServeWorkload(n_workers=4)
    before = pattern_summary.launches_by_variant["warp"]
    runner = ScenarioRunner(
        None, [ScheduledFault(BurstArrivals(workers=()), 2, 7)],
        n_windows=7, iters_per_window=8,
        detector_cfg=default_trainer_detector_cfg(8), workload=wl)
    res = runner.run()
    wl.close()
    assert runner.pipeline.service.summarize_backend.name == "cuda"
    assert pattern_summary.launches_by_variant["warp"] - before >= 7
    inc = next(i for i in res.incidents if i.function == QUEUE_WAIT
               and i.channel == "slo")
    assert sorted(inc.workers) == [0, 1, 2, 3]
    assert inc.plans[0].action == Action.SHED_LOAD


def test_serve_playbook_import_pulls_in_no_model():
    """``repro_torch.serve`` exports ``Engine`` and ``ServeConfig`` lazily:
    importing the playbook (the mitigation registry needs it) loads no
    model, and the lazy names resolve on first use."""
    code = (
        "import sys\n"
        "import repro_torch.serve.playbook\n"
        "assert 'repro_torch.serve.engine' not in sys.modules\n"
        "assert 'repro_torch.models.transformer' not in sys.modules\n"
        "import repro_torch.serve as S\n"
        "assert S.Engine.__module__ == 'repro_torch.serve.engine'\n"
        "assert S.ServeConfig().batch == 4\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
