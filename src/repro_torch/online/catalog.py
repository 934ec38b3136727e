"""The gated fault-scenario catalog (DESIGN.md §12): every troubleshooting
ability the repo claims, declared as DATA.

A catalog entry is a fault schedule plus the incidents the closed
act -> verify -> escalate loop is expected to produce — nothing else.  The
diagnosis path (detector -> localizer -> report -> plan ladder -> engine)
contains no knowledge of any scenario: adding a fault class means adding a
fault model + its pattern signature + a playbook rule, then DECLARING the
scenario here.  ``tests/test_torch_catalog.py`` enforces the invariant by
grepping the port's diagnosis-path modules for scenario names.

Five fault classes (the class is metadata for reporting, not dispatch):

  * ``perf``        — the six original paper cases (C1P1, C1P2, §3 ring,
    C2P1, C2P2, C2P3);
  * ``numerics``    — loss spikes / gradient-norm explosions on the
    numerics channel, cured by ``ROLLBACK_TO_CHECKPOINT``;
  * ``host``        — cross-layer OS faults fused with GPU profiles
    (cgroup CPU quota, page-cache thrash);
  * ``environment`` — bad-host environments (driver/kernel mismatch,
    degraded NIC), including the BAD-STANDBY family: ``replace_hosts``
    lands on a poisoned standby, verification fails honestly, and the
    incident must ESCALATE — a green "resolved" there would be a lie;
  * ``serve``       — latency-SLO violations under the simulator's serve
    workload shape (DESIGN.md §13): the ``slo`` detector channel opens
    the incident, localization runs over the serve profiles, and the
    serving playbook (``repro_torch.serve.playbook``) plans ``SHED_LOAD`` /
    ``DRAIN_AND_REPLACE`` ladders.

Every scenario runs under one standard deployment shape (``run_scenario``)
with mitigation closed-loop; ``evaluate`` scores the outcome against the
declared expectations.  The matrix is deterministic (seeded simulator,
fixed schedules), so the outcomes — incidents, first actions,
escalations and windows-to-resolution — are the reference's, scenario by
scenario.  ``run_scenario`` runs on ``device`` (``None`` means ``"cuda"``:
every window's Algorithm 1 in kernel K1) unless told ``"cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import repro_torch.serve.playbook  # noqa: F401  (registers the slo ladder rules)
from repro_torch.core import faults as F
from repro_torch.core.mitigation import Action
from repro_torch.core.simulation import (ALLGATHER, DATALOADER_STACK, DECODE_GEMM,
                                   FORWARD_STACK, GC_STACK, GEMM, KV_FETCH,
                                   SERVE_QUEUE_STACK, SimConfig, TOKEN_SYNC)
from repro_torch.online.escalation import EscalationPolicy
from repro_torch.online.scenario import (ScenarioResult, ScenarioRunner,
                                   ScheduledFault)

#: the standard catalog deployment shape (mirrors benchmarks/mitigation_loop)
W = 24
N_STANDBY = 4
WINDOW_S = 1.0
BASE_HZ, FULL_HZ = 250.0, 2000.0
SEED = 5
INJECT = 2                    # faults switch on at window 2
N_WINDOWS = 12

#: the numerics channel's synthesized function names
#: (``OnlinePipeline._finish_tick``)
LOSS_FN = "numerics.loss"
GRAD_FN = "numerics.grad_norm"

FAULT_CLASSES = ("perf", "numerics", "host", "environment", "serve")


@dataclass(frozen=True)
class ExpectedIncident:
    """One incident the closed loop must produce for a scenario."""
    function: str
    channel: str = "perf"
    #: first plan the engine must execute for it (None = don't care)
    first_action: Optional[Action] = None
    #: terminal state the incident must reach: "resolved" incidents must
    #: get there with ZERO escalations; "escalated" incidents must NOT be
    #: reported resolved (the honest-failure family)
    outcome: str = "resolved"


@dataclass(frozen=True)
class Scenario:
    """One catalog entry: a schedule plus its expected incidents."""
    name: str
    fault_class: str              # one of FAULT_CLASSES
    schedule: Tuple[ScheduledFault, ...]
    expect: Tuple[ExpectedIncident, ...]
    n_windows: int = N_WINDOWS
    #: which simulator workload shape the scenario runs under ("train"
    #: iterations or "serve" continuous-batched decode, DESIGN.md §13)
    workload: str = "train"


def _never_removed(fault: F.Fault, n_windows: int = N_WINDOWS,
                   start: int = INJECT) -> ScheduledFault:
    """A fault only a mitigation can clear (active through the last window)."""
    return ScheduledFault(fault, start, n_windows)


SCENARIOS: Tuple[Scenario, ...] = (
    # -- perf: the six original paper cases --------------------------------
    Scenario(
        "C1P1_gpu_throttle", "perf",
        (_never_removed(F.GpuThrottle(workers=(3, W // 2 + 1))),),
        (ExpectedIncident(GEMM, first_action=Action.REPLACE_HOSTS),)),
    Scenario(
        "C1P2_nvlink_down", "perf",
        (_never_removed(F.NvlinkDown(workers=(5,), group_size=8)),),
        (ExpectedIncident(ALLGATHER, first_action=Action.REPLACE_HOSTS),)),
    Scenario(
        "S3_ring_slow_link", "perf",
        (_never_removed(F.RingSlowLink(slow_worker=9, rho=0.4)),),
        (ExpectedIncident(ALLGATHER, first_action=Action.REPLACE_HOSTS),)),
    Scenario(
        "C2P1_slow_dataloader", "perf",
        (_never_removed(F.SlowDataloader()),),
        (ExpectedIncident(DATALOADER_STACK,
                          first_action=Action.MIGRATE_DATALOADER),)),
    Scenario(
        "C2P2_cpu_forward", "perf",
        (_never_removed(F.CpuBoundForward(workers=tuple(range(6)))),),
        (ExpectedIncident(FORWARD_STACK, first_action=Action.FLAG_CODE),)),
    Scenario(
        "C2P3_async_gc", "perf",
        (_never_removed(F.AsyncGc(probability=0.5, pause_s=0.25)),),
        (ExpectedIncident(GC_STACK, first_action=Action.SYNCHRONIZE_GC),)),

    # -- numerics: divergence signatures, rollback-shaped plans ------------
    Scenario(
        "N1_loss_spike", "numerics",
        (_never_removed(F.LossSpike()),),
        (ExpectedIncident(LOSS_FN, channel="numerics",
                          first_action=Action.ROLLBACK_TO_CHECKPOINT),)),
    Scenario(
        "N2_grad_explosion", "numerics",
        (_never_removed(F.GradExplosion()),),
        (ExpectedIncident(GRAD_FN, channel="numerics",
                          first_action=Action.ROLLBACK_TO_CHECKPOINT),)),
    Scenario(
        "N3_grad_norm_nan", "numerics",
        (_never_removed(F.GradExplosion(nan=True)),),
        (ExpectedIncident(GRAD_FN, channel="numerics",
                          first_action=Action.ROLLBACK_TO_CHECKPOINT),)),
    Scenario(
        # a loss spike UNDER an open perf incident: the channels are
        # independent sensors, both incidents must run to resolution
        "N4_loss_spike_under_perf", "numerics",
        (_never_removed(F.GpuThrottle(workers=(3, W // 2 + 1)),
                        n_windows=14),
         _never_removed(F.LossSpike(), n_windows=14)),
        (ExpectedIncident(GEMM, first_action=Action.REPLACE_HOSTS),
         ExpectedIncident(LOSS_FN, channel="numerics",
                          first_action=Action.ROLLBACK_TO_CHECKPOINT)),
        n_windows=14),

    # -- host: cross-layer OS faults fused with GPU profiles ---------------
    Scenario(
        "H1_cgroup_cpu_throttle", "host",
        (_never_removed(F.CgroupCpuThrottle(workers=(7, 19))),),
        (ExpectedIncident(FORWARD_STACK,
                          first_action=Action.REPLACE_HOSTS),)),
    Scenario(
        "H2_page_cache_thrash", "host",
        (_never_removed(F.PageCacheThrash(workers=(2, 9))),),
        (ExpectedIncident(DATALOADER_STACK,
                          first_action=Action.REPLACE_HOSTS),)),
    Scenario(
        # fleet-wide thrash reads as slow shared storage, not sick hosts:
        # the playbook must migrate the dataloader, not replace 24 hosts
        "H3_page_cache_fleetwide", "host",
        (_never_removed(F.PageCacheThrash(workers=())),),
        (ExpectedIncident(DATALOADER_STACK,
                          first_action=Action.MIGRATE_DATALOADER),)),

    # -- environment: bad-host environments + the bad-standby family -------
    Scenario(
        "E1_driver_mismatch", "environment",
        (_never_removed(F.DriverMismatch(workers=(3, 11))),),
        (ExpectedIncident(GEMM, first_action=Action.REPLACE_HOSTS),)),
    Scenario(
        "E2_degraded_nic", "environment",
        (_never_removed(F.DegradedNic(workers=(9,))),),
        (ExpectedIncident(ALLGATHER, first_action=Action.REPLACE_HOSTS),)),
    Scenario(
        # replace_hosts lands on standby W (first in the pool), whose
        # driver stack is bad: verification must FAIL and the incident
        # must escalate to a human — never report a poisoned fleet healthy
        "E3_bad_standby_driver", "environment",
        (_never_removed(F.GpuThrottle(workers=(3, W // 2 + 1)),
                        n_windows=14),
         ScheduledFault(F.DriverMismatch(workers=(W,)), 0, 14)),
        (ExpectedIncident(GEMM, first_action=Action.REPLACE_HOSTS,
                          outcome="escalated"),),
        n_windows=14),
    Scenario(
        "E4_bad_standby_nic", "environment",
        (_never_removed(F.NvlinkDown(workers=(5,), group_size=8),
                        n_windows=14),
         ScheduledFault(F.DegradedNic(workers=(W,)), 0, 14)),
        (ExpectedIncident(ALLGATHER, first_action=Action.REPLACE_HOSTS,
                          outcome="escalated"),),
        n_windows=14),

    # -- serve: latency-SLO incidents under the serve workload shape -------
    Scenario(
        # one serving host's decode GPU throttled: p99 TBT blows the SLO,
        # localization pins the decode GEMMs to that host, the serving
        # playbook drains + replaces it
        "SV1_hot_worker_decode", "serve",
        (ScheduledFault(F.GpuThrottle(workers=(4,), slowdown=3.0),
                        INJECT, N_WINDOWS,
                        cures=(Action.DRAIN_AND_REPLACE,)),),
        (ExpectedIncident(DECODE_GEMM, channel="slo",
                          first_action=Action.DRAIN_AND_REPLACE),),
        workload="serve"),
    Scenario(
        # sustained arrival burst: TTFT explodes fleet-wide while decode
        # stays healthy; queue buildup is cured by shedding load, never by
        # replacing hosts
        "SV2_arrival_burst", "serve",
        (_never_removed(F.ArrivalBurst()),),
        (ExpectedIncident(SERVE_QUEUE_STACK, channel="slo",
                          first_action=Action.SHED_LOAD),),
        workload="serve"),
    Scenario(
        # KV working set exceeds device memory: every decode step's block
        # reads go to the fetch path, TBT blows the SLO fleet-wide
        "SV3_kv_cache_thrash", "serve",
        (_never_removed(F.KvCacheThrash()),),
        (ExpectedIncident(KV_FETCH, channel="slo",
                          first_action=Action.SHED_LOAD),),
        workload="serve"),
    Scenario(
        # degraded NIC on one serving host: its token-path collectives
        # collapse, stretching time-between-tokens; drain + replace
        "SV4_degraded_nic_serve", "serve",
        (ScheduledFault(F.DegradedNic(workers=(9,)), INJECT, N_WINDOWS,
                        cures=(Action.DRAIN_AND_REPLACE,)),),
        (ExpectedIncident(TOKEN_SYNC, channel="slo",
                          first_action=Action.DRAIN_AND_REPLACE),),
        workload="serve"),
    Scenario(
        # an arrival burst lands while one host's decode GPU is already
        # hot: two independent slo incidents, two different cures, both
        # must resolve
        "SV5_burst_under_hot_worker", "serve",
        (ScheduledFault(F.GpuThrottle(workers=(4,), slowdown=3.0),
                        INJECT, 14, cures=(Action.DRAIN_AND_REPLACE,)),
         _never_removed(F.ArrivalBurst(), n_windows=14)),
        (ExpectedIncident(DECODE_GEMM, channel="slo",
                          first_action=Action.DRAIN_AND_REPLACE),
         ExpectedIncident(SERVE_QUEUE_STACK, channel="slo",
                          first_action=Action.SHED_LOAD)),
        n_windows=14, workload="serve"),
)


def by_name(name: str) -> Scenario:
    for sc in SCENARIOS:
        if sc.name == name:
            return sc
    raise KeyError(f"unknown scenario {name!r} "
                   f"(known: {', '.join(s.name for s in SCENARIOS)})")


def run_scenario(sc: Scenario, verbose: bool = False, history=None,
                 device=None, summarize_backend=None
                 ) -> Tuple[ScenarioRunner, ScenarioResult]:
    """Run one catalog scenario under the standard deployment shape with
    the mitigation loop closed; returns (runner, result).  ``history``
    optionally threads a chronic-fault store through the run (a restarted
    job re-ranking its ladders from persisted outcomes).  ``device`` and
    ``summarize_backend`` select where and how each window is summarized
    (``None``: the device's backend)."""
    esc = EscalationPolicy(n_workers=W + N_STANDBY, base_rate_hz=BASE_HZ,
                           full_rate_hz=FULL_HZ,
                           max_escalated=max(4, W // 16))
    runner = ScenarioRunner(
        SimConfig(n_workers=W, window_s=WINDOW_S, rate_hz=FULL_HZ,
                  seed=SEED, n_standby=N_STANDBY, workload=sc.workload),
        list(sc.schedule), n_windows=sc.n_windows,
        escalation=esc, mitigation=True, history=history, device=device,
        summarize_backend=summarize_backend)
    return runner, runner.run(verbose=verbose)


def evaluate(sc: Scenario, runner: ScenarioRunner,
             result: ScenarioResult) -> List[Dict]:
    """Score a scenario run against its declared expectations.

    One row per ``ExpectedIncident``: ``ok`` is the gate, ``wtr`` the
    windows from first plan application to resolution (None when the
    expectation is an escalation, or when the run missed it)."""
    rows: List[Dict] = []
    for exp in sc.expect:
        inc = next((i for i in result.incidents
                    if i.function == exp.function
                    and i.channel == exp.channel), None)
        mine = ([m for m in runner.engine.log if m.incident_id == inc.id]
                if inc is not None and runner.engine is not None else [])
        first = mine[0].plan.action if mine else None
        resolved = inc is not None and inc.state == "resolved"
        escalated = inc is not None and inc.state == "escalated"
        wtr: Optional[int] = None
        if exp.outcome == "resolved":
            ok = (resolved and inc.escalations == 0
                  and (exp.first_action is None
                       or first is exp.first_action))
            if ok:
                wtr = result.window_of(inc.resolved_at) - mine[0].window
        else:
            ok = (escalated and not resolved
                  and (exp.first_action is None
                       or first is exp.first_action))
        rows.append({
            "scenario": sc.name, "fault_class": sc.fault_class,
            "function": exp.function, "channel": exp.channel,
            "resolved": resolved, "escalated": escalated,
            "first_action": first.value if first else None,
            "escalations": inc.escalations if inc else -1,
            "wtr": wtr, "ok": ok,
        })
    return rows
