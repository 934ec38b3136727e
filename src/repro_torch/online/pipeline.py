"""The steady-state loop of PerfTracker (DESIGN.md §7) — EROICA's *online*
claim, made concrete:

  anchors stream into the ``IterationDetector`` continuously; a ``Trigger``
  opens an Incident; every profiling-window tick runs the fleet-batched
  summarize path, folds the window's ``(W, F, 3)`` pattern block into the
  cross-window EMA (``repro_torch.online.ema``), localizes on the *smoothed*
  patterns, advances incident lifecycles, and retunes per-worker sample
  rates via differential escalation (``repro_torch.online.escalation``).

The one-shot ``PerfTrackerService.diagnose_profiles`` remains the batch
entry point; ``OnlinePipeline`` wraps the same detector/localizer/backend
components into the continuous loop the paper ran for 1.5 years.

Device policy (as the service's): the pipeline summarizes on ``device``
(``None`` means ``"cuda"``, where every window's Algorithm 1 runs in kernel
K1) and raises without a CUDA device unless the caller passes ``"cpu"``.
``window_tick_batch``, the wire twin of ``window_tick``, needs the socket
transport, which comes with the transport slice of the port.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import channels
from repro_torch.core.detector import (DetectorConfig, NumericsConfig,
                                 NumericsDetector, SloConfig, SloDetector,
                                 Trigger)
from repro_torch.core.events import Kind
from repro_torch.core.localizer import Abnormality
from repro_torch.core.report import Diagnosis, build_report, format_report
from repro_torch.core.service import PerfTrackerService
from repro_torch.online.ema import EmaPatternAggregator
from repro_torch.online.escalation import EscalationPolicy
from repro_torch.online.incident import Incident, IncidentManager
from repro_torch.summarize.fleet import summarize_fleet


@dataclass
class WindowReport:
    """Everything one profiling-window tick produced."""
    index: int
    t: float                       # scenario/deployment clock at tick
    diagnoses: List[Diagnosis]
    changed: List[Incident]        # incidents that transitioned this window
    escalated: List[int]           # workers escalated for the NEXT window
    rates: Optional[np.ndarray]    # per-worker rates USED for this window
    raw_bytes: int
    pattern_bytes: int
    summarize_s: float
    localize_s: float
    #: workers whose evidence arrived this window (None = full fleet)
    present: Optional[np.ndarray] = None
    #: mitigation plans the engine executed this tick (DESIGN.md §9)
    mitigations: List = field(default_factory=list)

    def functions(self) -> List[str]:
        return [d.abnormality.function for d in self.diagnoses]

    def report(self, fleet_size: int) -> str:
        return format_report(self.diagnoses, fleet_size)


class OnlinePipeline:
    """Continuous detection -> profiling -> localization -> incident loop."""

    def __init__(self, n_workers: int, family: str = "dense",
                 detector_cfg: Optional[DetectorConfig] = None,
                 summarize_backend=None, alpha: float = 0.6,
                 escalation: Optional[EscalationPolicy] = None,
                 clear_windows: int = 2, verify_windows: int = 2,
                 max_escalations: int = 2, settle_windows: int = 1,
                 numerics_cfg: Optional[NumericsConfig] = None,
                 slo_cfg: Optional[SloConfig] = None,
                 profile_channel: str = channels.PERF,
                 history=None, device=None):
        self.n_workers = int(n_workers)
        self.service = PerfTrackerService(
            family=family, detector_cfg=detector_cfg,
            summarize_backend=summarize_backend, device=device)
        self.detector = self.service.detector
        #: job-level numerics channel (DESIGN.md §12a): loss / grad-norm
        #: samples stream in via ``feed_numerics`` beside the anchor stream
        self.numerics = NumericsDetector(numerics_cfg)
        #: serving latency-SLO channel (DESIGN.md §13): p99 (TTFT, TBT)
        #: samples stream in via ``feed_slo``
        self.slo = SloDetector(slo_cfg)
        #: the channel localized PROFILE abnormalities belong to — ``perf``
        #: for training workloads, ``slo`` for serving ones, where a slow
        #: function manifests to users as a latency violation, not an
        #: iteration slowdown (the anchor detector has no train sequence
        #: to lock onto there)
        self.profile_channel = channels.validate_channel(profile_channel)
        self.ema = EmaPatternAggregator(self.n_workers, alpha=alpha)
        self.incidents = IncidentManager(self.n_workers,
                                         clear_windows=clear_windows,
                                         verify_windows=verify_windows,
                                         max_escalations=max_escalations,
                                         settle_windows=settle_windows,
                                         history=history)
        self.escalation = escalation
        #: MitigationEngine executing incident ladders each tick (None =
        #: plans are attached but never acted on, the pre-§9 behavior)
        self.mitigator = None
        #: mesh-membership mask (None = every row is in the mesh); see
        #: ``set_membership``
        self._members: Optional[np.ndarray] = None
        self.windows: List[WindowReport] = []
        self._recoveries_seen = 0
        self._num_recoveries_seen = 0
        self._slo_recoveries_seen = 0

    def attach_mitigator(self, engine) -> None:
        """Install a ``repro_torch.online.mitigation.MitigationEngine``: every
        tick, incidents' pending ladder rungs are executed against the
        engine's simulator and verification clocks start."""
        self.mitigator = engine

    def set_membership(self, workers: Sequence[int]) -> None:
        """Declare the CURRENT training-mesh membership (global ids).

        Distinct from per-window *presence* (§8 upload loss): rows outside
        the mesh — cold standbys, replaced hosts — are structurally
        excluded from localization, and plan sizing (the widespread-fault
        fraction in ``plan_ladder``) is computed over the ACTIVE mesh, not
        the row space.  With a mitigator attached this tracks its
        simulator automatically; scenario runners call it per tick."""
        mem = np.zeros(self.n_workers, bool)
        mem[np.asarray(list(workers), np.int64)] = True
        self._members = None if mem.all() else mem
        self.incidents.fleet_size = int(mem.sum())

    # -- detection side (runs between profiling windows) -------------------
    def feed_anchors(self, events: Sequence[Tuple[str, float]]
                     ) -> List[Trigger]:
        """Stream anchor events; every trigger is folded into the incident
        set (at most one new incident — reminders attach to the active
        one), every detector recovery resolves what it can."""
        triggers = []
        for name, t in events:
            trig = self.detector.feed(name, t)
            if trig is not None:
                triggers.append(trig)
                self.incidents.on_trigger(trig)
            self._drain_recoveries()
        return triggers

    def feed_numerics(self, samples: Sequence[Tuple[float, float, float]]
                      ) -> List[Trigger]:
        """Stream job-level (t, loss, grad_norm) samples into the numerics
        channel.  Triggers and recoveries fold into the SAME incident set
        as the perf channel — on their own ``channel='numerics'`` lane, so
        a loss spike during an open perf incident is a distinct incident.

        Unlike a perf recovery, a numerics recovery does NOT reset the EMA:
        numerics evidence never enters the pattern aggregator, and perf
        incidents must keep their smoothed evidence."""
        triggers = []
        for t, loss, grad_norm in samples:
            for trig in self.numerics.feed(t, loss, grad_norm):
                triggers.append(trig)
                self.incidents.on_trigger(trig)
        recs = self.numerics.recoveries
        for rec in recs[self._num_recoveries_seen:]:
            self.incidents.on_recovery(rec)
        self._num_recoveries_seen = len(recs)
        return triggers

    def feed_slo(self, samples: Sequence[Tuple[float, float, float]]
                 ) -> List[Trigger]:
        """Stream job-level (t, p99_ttft, p99_tbt) samples into the SLO
        channel (DESIGN.md §13).  Triggers and recoveries fold into the
        same incident set on the ``channel='slo'`` lane.

        When the workload's profile abnormalities live on the SLO channel
        (``profile_channel='slo'``, a serving fleet), an SLO recovery
        plays the role a perf recovery plays for training: the user-facing
        metric is healthy again, so the EMA drains and stale fault
        evidence stops implicating already-mitigated workers."""
        triggers = []
        for t, ttft, tbt in samples:
            for trig in self.slo.feed(t, ttft, tbt):
                triggers.append(trig)
                self.incidents.on_trigger(trig)
        recs = self.slo.recoveries
        fresh = recs[self._slo_recoveries_seen:]
        for rec in fresh:
            self.incidents.on_recovery(rec)
        self._slo_recoveries_seen = len(recs)
        if fresh and self.profile_channel == channels.SLO:
            self.ema = EmaPatternAggregator(self.n_workers,
                                            alpha=self.ema.alpha)
        return triggers

    def feed_metrics(self, metrics: Dict[str, Sequence[Tuple[float, ...]]]
                     ) -> List[Trigger]:
        """Dispatch a ``WindowData.metrics`` dict to the matching
        sample-stream detectors.  Stream names are validated against the
        channel registry; a stream with no sample-feed (``perf`` rides the
        anchor stream, not a metrics stream) raises."""
        triggers: List[Trigger] = []
        for name, samples in metrics.items():
            channels.validate_channel(name)
            if name == channels.NUMERICS:
                triggers.extend(self.feed_numerics(samples))
            elif name == channels.SLO:
                triggers.extend(self.feed_slo(samples))
            else:
                raise ValueError(
                    f"channel {name!r} has no metrics-stream detector; "
                    "perf consumes the anchor stream via feed_anchors")
        return triggers

    def poll_blockage(self, now: float) -> Optional[Trigger]:
        trig = self.detector.check_blockage(now)
        if trig is not None:
            self.incidents.on_trigger(trig)
        return trig

    def _drain_recoveries(self) -> None:
        recs = self.detector.recoveries
        if len(recs) > self._recoveries_seen:
            for rec in recs[self._recoveries_seen:]:
                self.incidents.on_recovery(rec)
            self._recoveries_seen = len(recs)
            # the job-level metric is healthy again: drain the EMA so stale
            # fault evidence stops implicating already-mitigated workers
            # (a recovery only fires when EVERY fault has cleared, so no
            # concurrent incident loses live evidence)
            self.ema = EmaPatternAggregator(self.n_workers,
                                            alpha=self.ema.alpha)

    # -- profiling side -----------------------------------------------------
    def rates(self) -> Optional[np.ndarray]:
        """Per-worker sample rates for the next window (None = no
        escalation policy installed; profile at whatever the deployment's
        fixed rate is)."""
        return self.escalation.rates() if self.escalation else None

    def window_tick(self, profiles, t: Optional[float] = None,
                    rates: Optional[np.ndarray] = None,
                    present_workers: Optional[Sequence[int]] = None
                    ) -> WindowReport:
        """Fold one fleet of raw profiling windows into the online state.

        ``present_workers`` maps a PARTIAL profile list to global fleet
        rows (``present_workers[i]`` is ``profiles[i]``'s worker id):
        absent workers' EMA rows freeze instead of decaying on a window
        they never reported (DESIGN.md §8)."""
        t0 = time.perf_counter()
        present = None
        if present_workers is not None:
            ids = np.asarray(list(present_workers), np.int64)
            fs = summarize_fleet(profiles,
                                 backend=self.service.summarize_backend,
                                 workers=ids, fleet_size=self.n_workers)
            present = np.zeros(self.n_workers, bool)
            present[ids] = True
        else:
            fs = summarize_fleet(profiles,
                                 backend=self.service.summarize_backend)
        self.ema.fold(fs.agg, present=present)
        summarize_s = time.perf_counter() - t0
        return self._finish_tick(
            t=t, rates=rates, present=present,
            raw_bytes=sum(p.raw_size_bytes() for p in profiles),
            pattern_bytes=fs.pattern_bytes, summarize_s=summarize_s)

    def window_tick_batch(self, batch, t: Optional[float] = None,
                          rates: Optional[np.ndarray] = None
                          ) -> WindowReport:
        """Fold one assembled wire window into the online state: waits for
        the transport slice of the port (ROADMAP Queue 1 item 5)."""
        raise NotImplementedError("window_tick_batch waits for the transport "
                                  "slice of the port: ROADMAP Queue 1 item 5")

    def _finish_tick(self, t: Optional[float], rates, present,
                     raw_bytes: int, pattern_bytes: int, summarize_s: float
                     ) -> WindowReport:
        """Shared tail of every tick flavor: localize on the smoothed
        patterns, advance incidents, retune escalation."""
        if t is None:
            t = float(len(self.windows))
        pats, kinds = self.ema.finalize()
        t1 = time.perf_counter()
        # mesh membership vs transient presence: a worker whose UPLOAD was
        # lost keeps implicating via its frozen EMA row (DESIGN.md §8), but
        # a worker REPLACED out of the mesh (and a standby not yet in it)
        # is structurally excluded from localization (DESIGN.md §9)
        if self.mitigator is not None and self.mitigator.sim is not None:
            self.set_membership(self.mitigator.sim.active_workers)
        abn: List[Abnormality] = self.service.localizer.localize(
            pats, kinds, present=self._members)
        if self.profile_channel != channels.PERF:
            # serving fleet: a localized profile abnormality IS the SLO
            # violation's root cause — retag it onto the workload's channel
            # so it pairs with the SLO trigger's incident lane (§13)
            for a in abn:
                a.channel = self.profile_channel
        # outstanding numerics signals ride the same diagnosis path as a
        # synthesized job-level abnormality: no worker set (the channel is
        # job-level), kind NUMERICS, full-box expectation — everything
        # downstream (report/incident/ladder) treats it like any other
        abn.extend(Abnormality(
            function=f"numerics.{signal}",
            workers=np.zeros(0, np.int64), kind=Kind.NUMERICS,
            d_expect=np.array([1.0]), delta=np.array([0.0]),
            patterns=np.array([[1.0, 0.0, 0.0]]),
            typical=np.zeros(3), reason="numerics", channel="numerics")
            for signal in self.numerics.outstanding())
        # hint fractions size over the ACTIVE mesh, like plan sizing —
        # standbys/replaced rows must not dilute them
        diagnoses = build_report(abn, self.incidents.fleet_size)
        localize_s = time.perf_counter() - t1
        changed = self.incidents.on_window(
            t, diagnoses,
            detector_healthy=(self.detector.healthy
                              and self.numerics.healthy
                              and self.slo.healthy))
        mitigations = []
        if self.mitigator is not None:
            mitigations = self.mitigator.step(self.incidents, t=t,
                                              window=len(self.windows))
        escalated = (self.escalation.observe(abn)
                     if self.escalation else [])
        report = WindowReport(
            index=len(self.windows), t=t, diagnoses=diagnoses,
            changed=changed, escalated=escalated, rates=rates,
            raw_bytes=raw_bytes, pattern_bytes=pattern_bytes,
            summarize_s=summarize_s, localize_s=localize_s,
            present=present, mitigations=mitigations)
        self.windows.append(report)
        return report

    # -- reporting ----------------------------------------------------------
    def timeline(self) -> str:
        return self.incidents.timeline()
