"""The port's online incident loop against the JAX reference, on the CPU.

* Scenario parity: both packages' runners see the same simulator windows
  (same seeds) and must agree window by window on diagnoses, incident
  transitions, escalation sets, executed plans, the engine's log, the
  detector's triggers and recoveries and ``timeline()``; the EMA matrix is
  bit-equal on the port's ``numpy`` backend and within 1e-5 on its
  default ``torch`` backend.  The schedules are those of
  tests/test_online.py (six faults injected at window 2 and removed at 6,
  overlapping incidents, a healthy run) and the in-process cases of
  tests/test_mitigation.py (the act -> verify -> resolve matrix, the
  wrong-plan-first family, ladder exhaustion, a partial fix, recurrence
  linking, mesh membership), each also held to the reference test's own
  assertions.
* Unit twins of tests/test_online.py's non-runner cases (EMA, escalation,
  per-worker profile rates, incidents, detector recoveries, config
  aliasing) and of tests/test_mitigation.py's fault-model and standby
  helpers, with random fold and escalation sequences compared between the
  packages; ``critical_intervals`` against the reference's.
The port always runs with ``device="cpu"`` here.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import faults as RF
from repro.core.critical_path import critical_intervals as ref_intervals
from repro.core.events import Kind as RKind
from repro.core.localizer import Abnormality as RAbnormality
from repro.core.mitigation import Action as RAction
from repro.core.simulation import SimConfig as RSimConfig
from repro.online import EmaPatternAggregator as REma
from repro.online import EscalationPolicy as REsc
from repro.online import ScenarioRunner as RRunner
from repro.online import ScheduledFault as RSched

from repro_torch.core import faults as F
from repro_torch.core.critical_path import critical_intervals
from repro_torch.core.detector import (DetectorConfig, IterationDetector,
                                       Recovery, Trigger)
from repro_torch.core.events import Kind, profile_from_reference
from repro_torch.core.localizer import Abnormality
from repro_torch.core.mitigation import Action
from repro_torch.core.service import PerfTrackerService
from repro_torch.core.simulation import (ALLGATHER, DATALOADER_STACK,
                                         FORWARD_STACK, GC_STACK, GEMM,
                                         FleetSimulator, SimConfig)
from repro_torch.online import (CONFIRMED, ESCALATED, MITIGATING, OPEN,
                                RESOLVED, STATES, EmaPatternAggregator,
                                EscalationPolicy, IncidentManager,
                                OnlinePipeline, ScenarioRunner,
                                ScheduledFault)
from repro_torch.summarize.aggregate import PatternAggregator

from _torch_trace import assert_same_ema, record_ema, run_trace
# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

W = 24
N_STANDBY = 4
INJECT, REMOVE = 2, 6
BASE_HZ, FULL_HZ = 250.0, 2000.0
VERIFY, SETTLE = 2, 1
EMA_ATOL = 1e-5     # torch backend vs numpy: moments in another order

REF = SimpleNamespace(F=RF, Action=RAction, SimConfig=RSimConfig,
                      Esc=REsc, Runner=RRunner, Sched=RSched, kw={})
PORT = SimpleNamespace(F=F, Action=Action, SimConfig=SimConfig,
                       Esc=EscalationPolicy, Runner=ScenarioRunner,
                       Sched=ScheduledFault, kw={"device": "cpu"})


def _runner(ns, schedule, n_windows=10, n_standby=0, escalation=True,
            mitigation=False, backend=None, **kw):
    """One package's runner over ``schedule(ns)``: the tests/test_online.py
    deployment (``n_standby=0``, no mitigation) or tests/test_mitigation.py's
    (standbys, mitigation, verify 2, settle 1)."""
    esc = ns.Esc(n_workers=W + n_standby, base_rate_hz=BASE_HZ,
                 full_rate_hz=FULL_HZ) if escalation else None
    if mitigation:
        kw.update(verify_windows=VERIFY, settle_windows=SETTLE)
    if ns is PORT:
        kw.update(ns.kw, summarize_backend=backend)
    return ns.Runner(
        ns.SimConfig(n_workers=W, window_s=1.0, rate_hz=FULL_HZ, seed=5,
                     n_standby=n_standby),
        schedule(ns), n_windows=n_windows, escalation=esc,
        mitigation=mitigation, **kw)


def run_both(schedule, backend=None, **kw):
    """Run ``schedule`` in both packages; assert the same run window by
    window and the EMA bit-equal (``numpy``) or within 1e-5 (``torch``).
    Returns the port's (runner, result)."""
    out = []
    for ns in (REF, PORT):
        runner = _runner(ns, schedule, backend=backend, **kw)
        ema = record_ema(runner)
        out.append((runner, runner.run(), ema))
    (rr, rres, rema), (pr, pres, pema) = out
    assert pr.pipeline.service.summarize_backend.name == (backend or "torch")
    assert run_trace(pr, pres) == run_trace(rr, rres)
    assert_same_ema(rema, pema, atol=None if backend == "numpy" else EMA_ATOL)
    if pr.engine is not None and pr.engine.recovery is not None:
        pr.engine.recovery.close()
    return pr, pres


def _assert_monotone(res):
    order = {s: i for i, s in enumerate(STATES)}
    for inc in res.incidents:
        seq = [order[s] for _, s in inc.history]
        assert seq == sorted(seq), (inc.id, inc.history)
        assert len(set(seq)) == len(seq), (inc.id, inc.history)


# -- the multi-window fault matrix of tests/test_online.py ---------------------

#: (schedule factory, incident function, culprits or None = fleet-wide)
LIFECYCLE = [
    pytest.param(lambda ns: ns.F.GpuThrottle(workers=(3, 11)), GEMM,
                 {3, 11}, id="C1P1_gpu_throttle"),
    pytest.param(lambda ns: ns.F.NvlinkDown(workers=[5], group_size=8),
                 ALLGATHER, {5}, id="C1P2_nvlink_down"),
    pytest.param(lambda ns: ns.F.RingSlowLink(slow_worker=9, rho=0.4),
                 ALLGATHER, {9}, id="S3_ring_slow_link"),
    pytest.param(lambda ns: ns.F.SlowDataloader(), DATALOADER_STACK, None,
                 id="C2P1_slow_dataloader"),
    pytest.param(lambda ns: ns.F.CpuBoundForward(workers=range(6)),
                 FORWARD_STACK, set(range(6)), id="C2P2_cpu_forward"),
    pytest.param(lambda ns: ns.F.AsyncGc(probability=0.5, pause_s=0.25),
                 GC_STACK, None, id="C2P3_async_gc"),
]


@pytest.mark.parametrize("backend", ["numpy", None], ids=["numpy", "torch"])
@pytest.mark.parametrize("fault,expect,culprits", LIFECYCLE)
def test_scenario_lifecycle_matches_reference(fault, expect, culprits,
                                              backend):
    _, res = run_both(lambda ns: [ns.Sched(fault(ns), INJECT, REMOVE)],
                      backend=backend)
    inc = next(i for i in res.incidents if i.function == expect)
    assert INJECT <= res.window_of(inc.opened_at) <= INJECT + 2
    if culprits is not None:
        assert culprits <= set(inc.workers)
    assert [s for _, s in inc.history] == [OPEN, CONFIRMED, MITIGATING,
                                           RESOLVED]
    assert res.window_of(inc.resolved_at) <= REMOVE + 2
    assert inc.plans


def test_healthy_run_matches_reference():
    _, res = run_both(lambda ns: [])
    assert res.incidents == []
    assert all(r.functions() == [] for r in res.reports)


def test_escalates_implicated_workers_only():
    _, res = run_both(lambda ns: [ns.Sched(ns.F.GpuThrottle(workers=(3, 11)),
                                           INJECT, REMOVE)])
    assert res.reports[0].escalated == []
    np.testing.assert_allclose(res.reports[1].rates, BASE_HZ)
    mid = res.reports[INJECT + 1]
    assert {3, 11} <= set(mid.escalated) and len(mid.escalated) <= 4
    assert mid.rates[3] == FULL_HZ and mid.rates[0] == BASE_HZ
    assert res.reports[-1].escalated == []
    # the sharpened diagnosis holds every window of the incident
    assert all(GEMM in r.functions() for r in res.reports[INJECT + 1:REMOVE])


def test_overlapping_incidents_stay_distinct():
    _, res = run_both(lambda ns: [
        ns.Sched(ns.F.GpuThrottle(workers=(3, 11)), 2, 8),
        ns.Sched(ns.F.SlowDataloader(), 4, 10)], n_windows=14)
    gemm = next(i for i in res.incidents if i.function == GEMM)
    dl = next(i for i in res.incidents if i.function == DATALOADER_STACK)
    assert gemm.id != dl.id
    assert 4 <= res.window_of(dl.opened_at) <= 6
    assert gemm.state == RESOLVED and dl.state == RESOLVED
    assert {3, 11} <= set(gemm.workers)


# -- the closed loop of tests/test_mitigation.py -------------------------------

MITIGATED = dict(n_windows=12, n_standby=N_STANDBY, mitigation=True)

#: (fault factory, incident function, first action value)
ACT_VERIFY = [
    pytest.param(lambda ns: ns.F.GpuThrottle(workers=(3, 11)), GEMM,
                 "replace_hosts", id="C1P1_gpu_throttle"),
    pytest.param(lambda ns: ns.F.NvlinkDown(workers=[5], group_size=8),
                 ALLGATHER, "replace_hosts", id="C1P2_nvlink_down"),
    pytest.param(lambda ns: ns.F.RingSlowLink(slow_worker=9, rho=0.4),
                 ALLGATHER, "replace_hosts", id="S3_ring_slow_link"),
    pytest.param(lambda ns: ns.F.SlowDataloader(), DATALOADER_STACK,
                 "migrate_dataloader", id="C2P1_slow_dataloader"),
    pytest.param(lambda ns: ns.F.CpuBoundForward(workers=range(6)),
                 FORWARD_STACK, "flag_code_for_optimization",
                 id="C2P2_cpu_forward"),
    pytest.param(lambda ns: ns.F.AsyncGc(probability=0.5, pause_s=0.25),
                 GC_STACK, "synchronize_gc", id="C2P3_async_gc"),
]


@pytest.mark.parametrize("fault,expect,action", ACT_VERIFY)
def test_mitigation_act_verify_resolve_matches_reference(fault, expect,
                                                         action):
    runner, res = run_both(lambda ns: [ns.Sched(fault(ns), INJECT, 12)],
                           **MITIGATED)
    inc = next(i for i in res.incidents if i.function == expect)
    mine = [m for m in runner.engine.log if m.incident_id == inc.id]
    assert mine and mine[0].plan.action.value == action
    assert inc.escalations == 0
    assert runner.engine.cured_window(0) == mine[0].window
    assert runner.engine.faults_at(mine[0].window + 1) == []
    assert inc.state == RESOLVED
    assert res.window_of(inc.resolved_at) - mine[0].window <= VERIFY
    assert [s for _, s in inc.history] == ["open", "confirmed", "mitigating",
                                           "verifying", "resolved"]
    _assert_monotone(res)


def test_membership_and_remesh_match_reference():
    runner, res = run_both(
        lambda ns: [ns.Sched(ns.F.GpuThrottle(workers=(3, 11)), INJECT, 12)],
        **MITIGATED)
    assert runner.pipeline.n_workers == W + N_STANDBY
    assert runner.pipeline.incidents.fleet_size == W
    active = runner.sim.active_workers
    assert 3 not in active and 11 not in active and {24, 25} <= set(active)
    last = res.reports[-1]
    assert not last.present[3] and last.present[24]
    # no engine: standbys still stay out of the mesh statistics
    r2, res2 = run_both(lambda ns: [], n_windows=2, n_standby=2)
    assert r2.pipeline.incidents.fleet_size == W
    assert res2.incidents == []


WRONG_PLAN = [
    pytest.param(lambda ns: ns.F.GpuThrottle(workers=(3, 11)), GEMM,
                 lambda ns: (ns.Action.FLAG_CODE,),
                 ["replace_hosts", "flag_code_for_optimization"],
                 id="gpu_actually_software"),
    pytest.param(lambda ns: ns.F.CpuBoundForward(workers=(4, 9)),
                 FORWARD_STACK, lambda ns: (ns.Action.REPLACE_HOSTS,),
                 ["flag_code_for_optimization", "replace_hosts"],
                 id="python_actually_hardware"),
]


@pytest.mark.parametrize("fault,expect,cures,actions", WRONG_PLAN)
def test_wrong_plan_first_matches_reference(fault, expect, cures, actions):
    runner, res = run_both(
        lambda ns: [ns.Sched(fault(ns), INJECT, 14, cures=cures(ns))],
        n_windows=14, n_standby=N_STANDBY, mitigation=True)
    inc = next(i for i in res.incidents if i.function == expect)
    assert inc.state == RESOLVED and inc.escalations == 1
    assert [p.action.value for _, p in inc.applied] == actions
    mine = [m for m in runner.engine.log if m.incident_id == inc.id]
    assert mine[-1].cured == [type(fault(PORT)).__name__]
    assert res.window_of(inc.resolved_at) - mine[0].window <= VERIFY * 2
    if expect == GEMM:           # the replace moved the fault to standbys
        assert runner.engine.log[0].remapped == ["GpuThrottle"]
        assert {24, 25} <= set(inc.workers)
    _assert_monotone(res)


def test_ladder_exhaustion_matches_reference():
    _, res = run_both(
        lambda ns: [ns.Sched(ns.F.GpuThrottle(workers=(3, 11)), INJECT, 9,
                             cures=())],
        n_windows=13, n_standby=N_STANDBY, mitigation=True)
    incs = [i for i in res.incidents if i.function == GEMM]
    assert len(incs) == 1
    inc = incs[0]
    assert inc.state == ESCALATED and inc.resolved_at is None
    assert len(inc.applied) == len(inc.plans)
    _assert_monotone(res)


def test_partial_fix_matches_reference():
    runner, _ = run_both(
        lambda ns: [ns.Sched(ns.F.SlowDataloader(slowdown=20.0), INJECT, 12,
                             on_cure=ns.F.SlowDataloader(slowdown=5.0))],
        **MITIGATED)
    cure_w = runner.engine.cured_window(0)
    residual = runner.engine.faults_at(cure_w + 1)
    assert len(residual) == 1 and residual[0].slowdown == 5.0


def test_recurrence_links_with_engine_matches_reference():
    _, res = run_both(lambda ns: [ns.Sched(ns.F.SlowDataloader(), 2, 14),
                                  ns.Sched(ns.F.SlowDataloader(), 8, 14)],
                      n_windows=14, n_standby=N_STANDBY, mitigation=True)
    first, second = [i for i in res.incidents
                     if i.function == DATALOADER_STACK]
    assert second.recurrence_of == first.id
    assert f"recurrence_of=#{first.id}" in res.timeline()


def test_recurrence_links_without_engine_matches_reference():
    _, res = run_both(lambda ns: [
        ns.Sched(ns.F.GpuThrottle(workers=(3, 11)), 2, 5),
        ns.Sched(ns.F.GpuThrottle(workers=(3, 11)), 9, 12)], n_windows=15)
    incs = [i for i in res.incidents if i.function == GEMM]
    assert len(incs) == 2 and incs[1].recurrence_of == incs[0].id
    _assert_monotone(res)


# -- EMA aggregator ------------------------------------------------------------

def _window_agg(values):
    """A (W=2, F, 3) one-window aggregator from {name: [w0row, w1row]}."""
    agg = PatternAggregator(expected_workers=2)
    agg.reserve_workers(2)
    names = list(values)
    for nm in names:
        agg.intern(nm, Kind.GPU)
    block = np.stack([np.asarray(values[nm], np.float32).reshape(2, 3)
                      for nm in names], axis=1)
    agg.scatter_block(0, block)
    return agg


def test_ema_first_window_initializes_full_value():
    ema = EmaPatternAggregator(2, alpha=0.5)
    ema.fold(_window_agg({"f": [[0.4, 0.8, 0.1]] * 2}))
    pats, kinds = ema.finalize()
    np.testing.assert_allclose(pats["f"], [[0.4, 0.8, 0.1]] * 2, rtol=1e-6)
    assert kinds["f"] == Kind.GPU


def test_ema_fold_is_exponential_average():
    ema = EmaPatternAggregator(2, alpha=0.5)
    ema.fold(_window_agg({"f": [[0.4, 0.8, 0.1]] * 2}))
    ema.fold(_window_agg({"f": [[0.8, 0.4, 0.3]] * 2}))
    pats, _ = ema.finalize()
    np.testing.assert_allclose(pats["f"], [[0.6, 0.6, 0.2]] * 2, rtol=1e-6)


def test_ema_absent_function_decays_toward_zero():
    ema = EmaPatternAggregator(2, alpha=0.5)
    ema.fold(_window_agg({"f": [[0.4, 0.8, 0.1]] * 2}))
    ema.fold(_window_agg({"g": [[0.2, 0.2, 0.2]] * 2}))
    pats, _ = ema.finalize()
    np.testing.assert_allclose(pats["f"], [[0.2, 0.4, 0.05]] * 2, rtol=1e-6)
    np.testing.assert_allclose(pats["g"], [[0.2, 0.2, 0.2]] * 2, rtol=1e-6)


def test_ema_rejects_worker_and_mask_mismatch():
    with pytest.raises(ValueError):
        EmaPatternAggregator(3, alpha=0.5).fold(
            _window_agg({"f": [[0.4, 0.8, 0.1]] * 2}))
    with pytest.raises(ValueError):
        EmaPatternAggregator(2, alpha=0.5).fold(
            _window_agg({"f": [[0.4, 0.8, 0.1]] * 2}),
            present=np.ones(3, bool))
    with pytest.raises(ValueError):
        EmaPatternAggregator(2, alpha=0.0)


def test_ema_grows_function_axis():
    ema = EmaPatternAggregator(2, alpha=0.5, expected_functions=1)
    for i in range(10):
        ema.fold(_window_agg({f"f{i}": [[0.1, 0.2, 0.3]] * 2}))
    assert ema.n_functions == 10
    assert ema.finalize()[0]["f9"].shape == (2, 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ema_random_folds_bit_equal_to_reference(seed):
    """Random windows over a growing function set, with absent functions
    and partial present masks (frozen rows, per-row first evidence): the
    port's EMA equals the reference's bit for bit after every fold."""
    rng = np.random.default_rng(seed)
    Wn, names = 6, [f"fn{i}" for i in range(9)]
    ref = REma(Wn, alpha=0.6, expected_functions=2)
    port = EmaPatternAggregator(Wn, alpha=0.6, expected_functions=2)
    for _ in range(12):
        pick = [n for n in names if rng.random() < 0.6] or names[:1]
        block = rng.random((Wn, len(pick), 3)).astype(np.float32)
        present = rng.random(Wn) < 0.7 if rng.random() < 0.5 else None
        for ema, kind in ((ref, RKind.GPU), (port, Kind.GPU)):
            ema.fold_block(block, pick, {n: kind for n in pick},
                           present=present)
        (a, na), (b, nb) = ref.matrix(), port.matrix()
        assert na == nb
        np.testing.assert_array_equal(a, b)


# -- escalation policy ---------------------------------------------------------

def _abn(workers, cls=Abnormality, kind=Kind.GPU):
    idx = np.asarray(sorted(workers), np.int64)
    return cls(function="f", workers=idx, kind=kind,
               d_expect=np.zeros(idx.size), delta=np.zeros(idx.size),
               patterns=np.zeros((idx.size, 3), np.float32),
               typical=np.zeros(3, np.float32))


def test_escalation_base_until_implicated_and_cooldown():
    esc = EscalationPolicy(8, base_rate_hz=100.0, full_rate_hz=1000.0,
                           cooldown_windows=2)
    np.testing.assert_allclose(esc.rates(), 100.0)
    esc.observe([_abn({2, 5})])
    assert esc.rates()[2] == esc.rates()[5] == 1000.0
    assert esc.rates()[0] == 100.0 and esc.escalated == [2, 5]
    esc.observe([])
    assert esc.escalated == [2, 5]
    esc.observe([])
    assert esc.escalated == []


def test_escalation_reimplication_resets_cooldown():
    esc = EscalationPolicy(8, base_rate_hz=100.0, full_rate_hz=1000.0,
                           cooldown_windows=2)
    esc.observe([_abn({2})])
    esc.observe([_abn({2})])
    esc.observe([])
    assert esc.escalated == [2]


def test_escalation_budget_caps_fleet_wide_faults():
    esc = EscalationPolicy(16, base_rate_hz=100.0, full_rate_hz=1000.0,
                           cooldown_windows=2, max_escalated=4)
    esc.observe([_abn(set(range(16)))])
    assert len(esc.escalated) == 4 and (esc.rates() == 1000.0).sum() == 4
    esc.observe([_abn({8, 9, 10, 11})])
    assert esc.escalated == [8, 9, 10, 11]


def test_escalation_budget_is_hard_with_truncated_holdovers():
    esc = EscalationPolicy(8, base_rate_hz=100.0, full_rate_hz=1000.0,
                           cooldown_windows=2, max_escalated=2)
    esc.observe([_abn({5, 6})])
    esc.observe([_abn({1, 2, 3, 5})])
    assert esc.escalated == [1, 2]


def test_escalation_rejects_inverted_rates_and_counts_bytes():
    with pytest.raises(ValueError):
        EscalationPolicy(8, base_rate_hz=1000.0, full_rate_hz=100.0)
    esc = EscalationPolicy(4, base_rate_hz=100.0, full_rate_hz=1000.0)
    base = esc.window_bytes(window_s=2.0)
    assert base == 4 * 100.0 * 2.0 * 4 * 8
    esc.escalate([0])
    assert esc.window_bytes(window_s=2.0) > base


@pytest.mark.parametrize("budget", [None, 3])
def test_escalation_random_sequence_matches_reference(budget):
    rng = np.random.default_rng(11)
    ref = REsc(12, base_rate_hz=100.0, full_rate_hz=1000.0,
               cooldown_windows=2, max_escalated=budget)
    port = EscalationPolicy(12, base_rate_hz=100.0, full_rate_hz=1000.0,
                            cooldown_windows=2, max_escalated=budget)
    for _ in range(20):
        sets = [set(rng.choice(12, int(rng.integers(1, 5)), replace=False)
                    .tolist()) for _ in range(int(rng.integers(0, 3)))]
        assert port.observe([_abn(s) for s in sets]) == \
            ref.observe([_abn(s, RAbnormality, RKind.GPU) for s in sets])
        np.testing.assert_array_equal(port.rates(), ref.rates())


# -- per-worker sample rates through the simulator ----------------------------

def test_profile_window_per_worker_rates():
    cfg = SimConfig(n_workers=4, window_s=1.0, rate_hz=2000.0, seed=3)
    rates = np.array([250.0, 2000.0, 250.0, 250.0])
    profiles = FleetSimulator(cfg, [F.GpuThrottle(workers=[1])]) \
        .profile_window(rates=rates)
    for p, r in zip(profiles, rates):
        for st in p.streams.values():
            assert st.rate_hz == r
            assert len(st.values) == int(r * cfg.window_s)
    with pytest.raises(ValueError):
        FleetSimulator(SimConfig(n_workers=4)).profile_window(
            rates=np.array([100.0, 200.0]))


def test_profile_window_uniform_rates_match_default():
    cfg = SimConfig(n_workers=3, window_s=1.0, rate_hz=500.0, seed=3)
    a = FleetSimulator(cfg, [F.GpuThrottle(workers=[1])]).profile_window()
    b = FleetSimulator(cfg, [F.GpuThrottle(workers=[1])]).profile_window(
        rates=np.full(3, cfg.rate_hz))
    for pa, pb in zip(a, b):
        assert [e.name for e in pa.events] == [e.name for e in pb.events]
        for k in pa.streams:
            np.testing.assert_array_equal(pa.streams[k].values,
                                          pb.streams[k].values)


# -- incident manager, detector recoveries, config aliasing -------------------

def test_incident_single_trigger_and_transient_recovery():
    mgr = IncidentManager(fleet_size=8)
    assert mgr.on_trigger(Trigger("slowdown", 10.0, 1.3, 1.0)) is not None
    assert mgr.on_trigger(Trigger("slowdown", 20.0, 1.3, 1.0)) is None
    assert len(mgr.incidents) == 1
    resolved = mgr.on_recovery(Recovery("slowdown", 30.0))
    assert [i.state for i in resolved] == [RESOLVED] and mgr.active == []


def test_incident_triggerless_needs_consecutive_windows():
    mgr = IncidentManager(fleet_size=8, confirm_windows=2)
    d = PerfTrackerService(device="cpu").diagnose_patterns(
        {"f": np.tile([0.5, 0.2, 0.1], (8, 1)).astype(np.float32)},
        {"f": Kind.PYTHON}).diagnoses
    assert d
    mgr.on_window(1.0, d)
    assert mgr.incidents == []
    mgr.on_window(2.0, [])
    mgr.on_window(3.0, d)
    assert mgr.incidents == []
    mgr.on_window(4.0, d)
    assert len(mgr.incidents) == 1 and mgr.incidents[0].state == CONFIRMED


def _feed(det, n, t0, dur):
    t = t0
    for _ in range(n):
        det.feed("dataloader.next", t)
        det.feed("optimizer.step", t + dur * 0.97)
        t += dur
    return t


def test_detector_emits_slowdown_and_blockage_recoveries():
    det = IterationDetector(DetectorConfig(n_recent=20, rearm_cooldown=0))
    t = _feed(det, 30, 0.0, 1.0)
    t = _feed(det, 30, t, 1.3)
    assert len(det.triggers) == 1 and not det.healthy
    _feed(det, 40, t, 1.0)
    assert [r.reason for r in det.recoveries] == ["slowdown"]
    assert det.healthy
    det = IterationDetector()
    t = _feed(det, 15, 0.0, 1.0)
    assert det.check_blockage(t + 10.0) is not None and not det.healthy
    _feed(det, 1, t + 60.0, 1.0)
    assert [r.reason for r in det.recoveries] == ["blockage"]


def test_service_and_detector_cfg_not_aliased():
    a, b = PerfTrackerService(device="cpu"), PerfTrackerService(device="cpu")
    assert a.detector.cfg is not b.detector.cfg
    a.detector.cfg.slowdown_ratio = 99.0
    assert b.detector.cfg.slowdown_ratio == 1.05
    c, d = IterationDetector(), IterationDetector()
    c.cfg.n_recent = 7
    assert d.cfg.n_recent == 50


# -- fault-model helpers and standbys (tests/test_mitigation.py) --------------

def test_affected_and_remap_workers():
    assert F.affected_workers(F.GpuThrottle(workers=(3, 11))) == {3, 11}
    assert F.affected_workers(F.RingSlowLink(slow_worker=9)) == {9}
    assert F.affected_workers(F.SlowDataloader()) is None
    assert F.affected_workers(F.CpuBoundForward(workers=(1,))) == {1}
    f = F.GpuThrottle(workers=(3, 11))
    assert set(F.remap_workers(f, {3: 24, 11: 25}).workers) == {24, 25}
    assert F.remap_workers(f, {7: 26}) is f
    assert F.remap_workers(f, {3: None, 11: None}) is None
    assert set(F.remap_workers(f, {3: None}).workers) == {11}
    ring = F.RingSlowLink(slow_worker=9)
    assert F.remap_workers(ring, {9: 24}) is ring


def test_replace_hosts_mapping_and_standby_exhaustion():
    sim = FleetSimulator(SimConfig(n_workers=6, n_standby=1))
    assert sim.total_workers == 7
    assert sim.replace_hosts([1, 4, 4, 99]) == {1: 6, 4: None}
    assert sim.active_workers == [0, 2, 3, 5, 6]
    assert sim.replace_hosts([1]) == {}
    sim = FleetSimulator(SimConfig(n_workers=8, n_standby=2),
                         [F.GpuThrottle(workers=(3,))])
    assert sim.iteration_multiplier() > 1.0
    sim.replace_hosts([3])
    assert sim.iteration_multiplier() == 1.0
    sim.faults = [F.SlowDataloader()]
    assert sim.iteration_multiplier() > 1.0


def test_window_tick_batch_waits_for_the_transport_slice():
    """The transport slice is ported: a window assembled over the socket
    transport folds like the same profiles through ``window_tick`` (the
    multi-process runner is held in tests/test_torch_multiprocess*.py)."""
    from repro_torch.core.daemon import summarize_and_upload
    from repro_torch.transport import LoopbackWire
    sim = FleetSimulator(SimConfig(n_workers=8, window_s=1.0, rate_hz=1000,
                                   seed=3), [F.GpuThrottle(workers=(3,))])
    profiles = sim.profile_window()
    a = OnlinePipeline(8, summarize_backend="numpy", device="cpu")
    b = OnlinePipeline(8, summarize_backend="numpy", device="cpu")
    ra = a.window_tick(profiles, t=1.0)
    with LoopbackWire(range(8)) as wire:
        batch = wire.send_round(
            [summarize_and_upload(p, backend="numpy") for p in profiles])
    rb = b.window_tick_batch(batch, t=1.0)
    np.testing.assert_array_equal(a.ema.matrix()[0], b.ema.matrix()[0])
    assert ra.functions() == rb.functions()
    assert rb.transport["present"] == 8 and ra.transport is None
    assert "transport: 8/8 workers reported" in rb.report(8)


# -- critical_intervals --------------------------------------------------------

def test_critical_intervals_match_reference():
    from repro.core.simulation import FleetSimulator as RSim
    cfg = dict(n_workers=3, window_s=1.0, rate_hz=500.0, seed=4)
    ref_profiles = RSim(RSimConfig(**cfg),
                        [RF.AsyncGc(probability=0.5)]).profile_window()
    port_profiles = FleetSimulator(SimConfig(**cfg),
                                   [F.AsyncGc(probability=0.5)]) \
        .profile_window()
    for rp, pp in zip(ref_profiles, port_profiles):
        window = rp.window
        want = ref_intervals(rp.events, window)
        assert want
        assert critical_intervals(pp.events, window) == want
        assert critical_intervals(
            profile_from_reference(rp).events, window) == want
    assert critical_intervals([], (0.0, 1.0)) == {}
