"""Multi-window scenario runner: drives the ``OnlinePipeline`` over a
simulated training run with faults injected and removed mid-run
(DESIGN.md §7).

A scenario is a fault *schedule* over profiling windows: each
``ScheduledFault`` is active for windows ``[start_window, end_window)``.
Every window the runner

  1. sets the simulator's active fault set from the schedule (the anchor
     stream's iteration durations and the profiling window's resource
     signatures both follow);
  2. streams ``iters_per_window`` anchors into the pipeline's detector
     (continuous timeline across windows via ``FleetSimulator.anchor_clock``);
  3. asks the escalation policy for per-worker rates and materializes the
     fleet's raw profiling windows at those rates;
  4. ticks the pipeline (fleet-batched summarize -> EMA fold -> localize ->
     incident transitions -> next escalation decision).

Overlapping schedules exercise the distinct-incident path: the detector
only fires once at job level, but each fault's abnormal *function* gets its
own incident.

Profile production is pluggable (DESIGN.md §11): the runner drives any
``WorkloadSource``.  With no explicit workload it builds the historical
``FleetSimulator`` path (``SimWorkload``); pass a
``repro_torch.train.workload.TrainerWorkload`` to run the identical
detect -> summarize -> localize -> incident machinery over REAL training
jobs, whose measured iteration durations are merged (max per index) into
the job-level detector stream.

Device policy: the runner's pipeline summarizes on ``device`` (``None``
means ``"cuda"``, kernel K1 for every window) and raises without a CUDA
device unless the caller passes ``"cpu"``.  The simulator stays on numpy
RNG, so the port and the reference see the same profiles for the same
seeds.  Only the in-process loop (``run``) is ported: the reference's
``run_multiprocess`` drives worker processes over the socket transport,
which comes with the transport slice of the port (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.ckpt.recovery import RecoveryManager
from repro_torch.core import faults as F
from repro_torch.core.detector import DetectorConfig
from repro_torch.core.mitigation import Action
from repro_torch.core.simulation import FleetSimulator, SimConfig
from repro_torch.online.escalation import EscalationPolicy
from repro_torch.online.mitigation import MitigationEngine
from repro_torch.online.pipeline import OnlinePipeline, WindowReport
from repro_torch.online.workload import SimWorkload, WorkloadSource

#: per-window profile seed offset (the reference's, so both packages
#: profile the same windows)
_WINDOW_SEED_STRIDE = 7919


@dataclass(frozen=True)
class ScheduledFault:
    fault: F.Fault
    start_window: int
    end_window: int                 # exclusive
    #: which mitigation Actions actually cure this fault — the scenario's
    #: ground truth for the act->verify->escalate loop (DESIGN.md §9).
    #: None = the fault model's playbook default
    #: (``repro_torch.online.mitigation.DEFAULT_CURES``); an empty tuple = nothing
    #: cures it (the incident must end up ``escalated``)
    cures: Optional[Tuple[Action, ...]] = None
    #: partial fix: the weaker residual fault left behind after a cure
    on_cure: Optional[F.Fault] = None

    def active(self, window: int) -> bool:
        return self.start_window <= window < self.end_window


@dataclass
class ScenarioResult:
    pipeline: OnlinePipeline
    reports: List[WindowReport]
    spans: List[Tuple[float, float]]   # (t_start, t_end) per window

    def window_of(self, t: float) -> int:
        """Map a timeline instant (e.g. an incident transition time) to the
        profiling window it fell in.  Window ticks run at exactly the span
        end, so the upper boundary is inclusive."""
        for i, (t0, t1) in enumerate(self.spans):
            if t <= t1:
                return i
        return len(self.spans) - 1

    @property
    def incidents(self):
        return self.pipeline.incidents.incidents

    def timeline(self) -> str:
        return self.pipeline.timeline()


def default_detector_cfg(iters_per_window: int) -> DetectorConfig:
    """Windows-scale detector thresholds: lock fast, judge the slowdown
    over roughly half a window of iterations so both the trigger and the
    recovery re-arm land within a window or two of the fault edge.

    ``history_iters`` bounds the 'recent shortest' baseline: once a fault
    outlives the whole history, the pre-fault minimum ages out, the
    baseline drifts up to the degraded level, and the detector emits a
    spurious Recovery mid-fault (draining the pipeline's EMA).  50 windows
    of headroom keeps that horizon far beyond any scheduled scenario while
    still letting a production baseline drift eventually."""
    n_recent = max(5, min(20, iters_per_window // 2))
    return DetectorConfig(m_identical=5, n_recent=n_recent,
                          history_iters=50 * iters_per_window,
                          rearm_cooldown=0)


class ScenarioRunner:
    def __init__(self, sim_cfg: Optional[SimConfig],
                 schedule: Sequence[ScheduledFault],
                 n_windows: int = 8, iters_per_window: int = 24,
                 escalation: Optional[EscalationPolicy] = None,
                 detector_cfg: Optional[DetectorConfig] = None,
                 summarize_backend=None, alpha: float = 0.6,
                 clear_windows: int = 2, mitigation: bool = False,
                 verify_windows: int = 2, max_escalations: int = 2,
                 settle_windows: int = 1,
                 workload: Optional[WorkloadSource] = None,
                 recovery="auto", history=None, device=None):
        self.sim_cfg = sim_cfg
        self.schedule = list(schedule)
        self.n_windows = n_windows
        self.iters_per_window = iters_per_window
        if workload is None:
            if sim_cfg is None:
                raise ValueError("pass a SimConfig or a WorkloadSource")
            self.sim = FleetSimulator(sim_cfg, [])
            self.workload: WorkloadSource = SimWorkload(
                self.sim, sim_cfg.seed, _WINDOW_SEED_STRIDE)
        else:
            self.sim = getattr(workload, "sim", None)
            self.workload = workload
        # the pipeline's worker axis spans standbys too: their rows stay
        # absent (present-masked) until a re-mesh activates them
        self.pipeline = OnlinePipeline(
            n_workers=self.workload.total_workers,
            family=self.workload.family,
            detector_cfg=(detector_cfg if detector_cfg is not None
                          else default_detector_cfg(iters_per_window)),
            summarize_backend=summarize_backend, alpha=alpha,
            escalation=escalation, clear_windows=clear_windows,
            verify_windows=verify_windows,
            max_escalations=max_escalations,
            settle_windows=settle_windows,
            profile_channel=self.workload.channel,
            history=history, device=device)
        #: ``mitigation=True`` closes the loop (DESIGN.md §9): incidents'
        #: ladder rungs execute against the simulator each tick, and the
        #: schedule's live fault view follows cures/re-meshes.  A
        #: ``RecoveryManager`` (DESIGN.md §14) binds the checkpoint verbs
        #: to real on-disk state: ``recovery="auto"`` provisions one per
        #: run — the sim side-car state for simulator workloads, the live
        #: ``snapshot_state``/``install_state`` hooks for real workloads
        #: that expose them — pass None (or an explicit manager) to
        #: override
        self.engine: Optional[MitigationEngine] = None
        if mitigation:
            rec = recovery
            if isinstance(rec, str) and rec == "auto":
                if self.sim is not None and isinstance(self.workload,
                                                       SimWorkload):
                    rec = RecoveryManager.for_sim(
                        seed=self.sim.cfg.seed,
                        device=self.pipeline.service.device)
                elif hasattr(self.workload, "snapshot_state"):
                    rec = RecoveryManager.for_workload(self.workload)
                else:
                    rec = None
            self.engine = MitigationEngine(self.sim, self.schedule,
                                           recovery=rec)
            self.pipeline.attach_mitigator(self.engine)

    def faults_at(self, window: int) -> List[F.Fault]:
        if self.engine is not None:
            return self.engine.faults_at(window)
        return [sf.fault for sf in self.schedule if sf.active(window)]

    def run(self, verbose: bool = False) -> ScenarioResult:
        reports: List[WindowReport] = []
        spans: List[Tuple[float, float]] = []
        for i in range(self.n_windows):
            if self.engine is not None:
                self.engine.begin_window(i)
            faults = self.faults_at(i)
            # the escalation rates are a pure read (the policy only updates
            # at the previous window's tick), so sampling them before the
            # workload runs is byte-identical to the historical loop order
            rates = self.pipeline.rates()
            wd = self.workload.run_window(i, faults,
                                          self.iters_per_window, rates)
            self.pipeline.feed_anchors(wd.anchors)
            self.pipeline.feed_metrics(wd.metrics)
            self.pipeline.poll_blockage(wd.clock)
            # profiles come from the ACTIVE fleet only; with standbys
            # and/or after a re-mesh the absent rows are present-masked
            # and kept out of the mesh membership (the full-fleet path
            # stays byte-identical to the historical behavior when every
            # row is active)
            active = wd.workers
            self.pipeline.set_membership(active)
            report = self.pipeline.window_tick(
                wd.profiles, t=wd.clock, rates=rates,
                present_workers=(None if len(active)
                                 == self.pipeline.n_workers else active))
            spans.append((wd.t0, wd.clock))
            reports.append(report)
            if verbose:
                print(f"-- window {i} (t={report.t:.1f}s, "
                      f"faults={[type(f).__name__ for f in faults]},"
                      f" escalated={report.escalated})")
                for m in report.mitigations:
                    print(f"   mitigation: {m}")
                print(report.report(len(active)))
        return ScenarioResult(pipeline=self.pipeline, reports=reports,
                              spans=spans)

    def run_multiprocess(self, *args, **kwargs) -> ScenarioResult:
        """The same scenario across worker processes over the socket
        transport: waits for the transport slice of the port."""
        raise NotImplementedError("run_multiprocess waits for the transport "
                                  "slice of the port: ROADMAP Queue 1 "
                                  "item 5")
