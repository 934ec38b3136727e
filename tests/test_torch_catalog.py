"""The port's 22-scenario catalog against the JAX reference, on the CPU.

* Every scenario under the standard deployment shape (W = 24 + 4 standbys,
  1 s windows, 250/2000 Hz, seed 5, mitigation closed) gives the
  reference's ``evaluate`` rows, and the same run window by window:
  diagnoses, incident transitions, escalation sets, executed plans, the
  engine's log and the timeline.  On the port's ``numpy`` backend every
  window's EMA matrix equals the reference's bit for bit; on its default
  ``torch`` backend (the plain version of kernel K1) within 1e-5.
* The catalog's shape (size, classes, the bad-standby family) and
  ``by_name`` are the reference's.
* The port's diagnosis path stays scenario-agnostic: no scenario name, and
  no import of the catalog, in any of its diagnosis-path modules.
"""
from pathlib import Path

import pytest

from repro.online import catalog as RC

from repro_torch.online import catalog as PC
from repro_torch.online.catalog import (FAULT_CLASSES, SCENARIOS, by_name,
                                        evaluate)

from _torch_trace import assert_same_ema, record_ema, run_trace
# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
EMA_ATOL = 1e-5     # torch backend vs numpy: moments in another order

#: the port's diagnosis path: everything between raw profiles and
#: executed plans, kernels and summarize backends included
DIAGNOSIS_PATH = [
    "src/repro_torch/core/channels.py",
    "src/repro_torch/core/detector.py",
    "src/repro_torch/core/localizer.py",
    "src/repro_torch/core/expectations.py",
    "src/repro_torch/core/report.py",
    "src/repro_torch/core/mitigation.py",
    "src/repro_torch/core/service.py",
    "src/repro_torch/summarize/fleet.py",
    "src/repro_torch/summarize/backends.py",
    "src/repro_torch/kernels/pattern_summary.py",
    "src/repro_torch/csrc/pattern_summary.cu",
    "src/repro_torch/online/ema.py",
    "src/repro_torch/online/escalation.py",
    "src/repro_torch/online/pipeline.py",
    "src/repro_torch/online/incident.py",
    "src/repro_torch/online/mitigation.py",
    "src/repro_torch/serve/playbook.py",
]


def _run(monkeypatch, module, sc, **kw):
    """``module.run_scenario(sc)`` with the EMA recorded per window."""
    snaps = []
    real_run = module.ScenarioRunner.run

    def traced(self, verbose=False):
        snaps.extend(record_ema(self))
        return real_run(self, verbose)
    with monkeypatch.context() as m:
        m.setattr(module.ScenarioRunner, "run", traced)
        runner, res = module.run_scenario(sc, **kw)
    return runner, res, snaps


@pytest.mark.parametrize("name", [s.name for s in SCENARIOS])
def test_scenario_matches_reference(name, monkeypatch):
    sc, rsc = by_name(name), RC.by_name(name)
    ref_runner, ref_res, ref_ema = _run(monkeypatch, RC, rsc)
    ref_rows = RC.evaluate(rsc, ref_runner, ref_res)
    ref_trace = run_trace(ref_runner, ref_res)
    for backend, atol in (("numpy", None), (None, EMA_ATOL)):
        runner, res, ema = _run(monkeypatch, PC, sc, device="cpu",
                                summarize_backend=backend)
        assert runner.pipeline.service.summarize_backend.name == \
            (backend or "torch")
        rows = evaluate(sc, runner, res)
        assert rows == ref_rows
        assert all(r["ok"] for r in rows), rows
        assert run_trace(runner, res) == ref_trace
        assert_same_ema(ref_ema, ema, atol=atol)
        runner.engine.recovery.close()


def _scheduled(f):
    return (repr(f.fault), f.start_window, f.end_window,
            f.cures and [a.value for a in f.cures], repr(f.on_cure))


def test_catalog_shape_matches_reference():
    assert FAULT_CLASSES == RC.FAULT_CLASSES
    assert len(SCENARIOS) == len(RC.SCENARIOS) == 22
    for sc, rsc in zip(SCENARIOS, RC.SCENARIOS):
        assert (sc.name, sc.fault_class, sc.n_windows, sc.workload) == \
            (rsc.name, rsc.fault_class, rsc.n_windows, rsc.workload)
        assert [(e.function, e.channel, e.outcome,
                 e.first_action and e.first_action.value) for e in sc.expect] \
            == [(e.function, e.channel, e.outcome,
                 e.first_action and e.first_action.value) for e in rsc.expect]
        assert [_scheduled(f) for f in sc.schedule] == \
            [_scheduled(f) for f in rsc.schedule]
    esc = [s for s in SCENARIOS
           if any(e.outcome == "escalated" for e in s.expect)]
    assert len(esc) >= 2
    assert all(s.fault_class == "environment" for s in esc)


def test_by_name():
    assert by_name("C1P1_gpu_throttle").fault_class == "perf"
    with pytest.raises(KeyError):
        by_name("no_such_scenario")


def test_diagnosis_path_is_scenario_agnostic():
    """No scenario name in the port's diagnosis path: a match means a
    scenario was special-cased instead of the playbook learning a
    pattern."""
    names = [s.name for s in SCENARIOS]
    offenders = []
    for rel in DIAGNOSIS_PATH:
        path = REPO / rel
        assert path.exists(), rel
        text = path.read_text()
        offenders += [(rel, n) for n in names if n in text]
    assert offenders == [], offenders


def test_diagnosis_path_does_not_import_catalog():
    for rel in DIAGNOSIS_PATH:
        assert "catalog" not in (REPO / rel).read_text(), rel
