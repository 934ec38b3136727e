"""WorkloadSource: where profiles and anchors come from (DESIGN.md §11; a
copy of the reference's ``repro/online/workload.py``).

Everything downstream of profile production — detector, summarize, EMA,
localizer, incidents, escalation, mitigation — is workload-agnostic: it
consumes ``(anchors, profiles, membership, clock)`` per window.  This module
names that contract.  Two implementations exist:

  * ``SimWorkload`` wraps the historical ``FleetSimulator`` path
    byte-for-byte (``repro_torch.online.scenario.ScenarioRunner`` builds
    one when it is given no workload);
  * ``TrainerWorkload`` (``repro_torch.train.workload``) drives REAL
    ``Trainer`` instances with the ``Tracer`` wired into every phase of an
    actual train step — anchors are measured iteration durations, profiles are
    real host-sampled ``WorkerProfile``s.

Multi-worker anchor merging: the job-level iteration detector consumes ONE
(D, O) stream, but a fleet produces per-worker iteration durations.  A
synchronous data-parallel step is gated by its slowest worker, so the merge
takes the per-iteration MAX across workers and resynthesizes the anchor
pair stream on a continuous job clock (``merge_anchor_durations`` +
``synth_anchor_events``) — the same shape ``FleetSimulator.anchor_events``
emits.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import channels
from repro_torch.core.events import WorkerProfile

#: fraction of the iteration at which the optimizer.step anchor lands
#: (matches FleetSimulator.anchor_events; the detector only consumes the
#: D..O sequence and the D->D durations, not the interior offset)
_OPT_ANCHOR_FRAC = 0.97


@dataclass
class WindowData:
    """One profiling window's worth of workload output."""
    anchors: List[Tuple[str, float]]     # (name, t) on the workload clock
    profiles: List[WorkerProfile]        # active workers, ascending id
    workers: np.ndarray                  # active (mesh-member) worker ids
    clock: float                         # workload clock at window end
    t0: float                            # workload clock at window start
    #: named job-level sample streams, stream -> [(t, *values), ...]:
    #: ``"numerics"`` carries (t, loss, grad_norm) for the numerics channel
    #: (DESIGN.md §12a), ``"slo"`` carries (t, p99_ttft, p99_tbt) for the
    #: serving latency channel (§13); empty dict when the workload has no
    #: sample streams
    metrics: Dict[str, List[Tuple[float, ...]]] = field(default_factory=dict)

    @property
    def numerics(self) -> List[Tuple[float, float, float]]:
        """Deprecation shim for the pre-§13 ``numerics`` field: the
        numerics stream of ``metrics`` (empty list when absent)."""
        return self.metrics.get(channels.NUMERICS, [])


class WorkloadSource(ABC):
    """Produces anchors + per-worker profiles, one window at a time."""

    @property
    @abstractmethod
    def total_workers(self) -> int:
        """Fleet width of the pipeline's worker axis (standbys included)."""

    @property
    @abstractmethod
    def active_workers(self) -> np.ndarray:
        """Current mesh membership (global worker ids, ascending)."""

    @property
    def family(self) -> str:
        return "dense"

    @property
    def channel(self) -> str:
        """The detector channel this workload's profile abnormalities
        belong to: ``perf`` for training workloads (iteration slowdown),
        ``slo`` for serving ones (latency violations).  The pipeline uses
        it to retag localized profile abnormalities (DESIGN.md §13)."""
        return channels.PERF

    @abstractmethod
    def run_window(self, window: int, faults: Sequence, iters: int,
                   rates: Optional[np.ndarray]) -> WindowData:
        """Advance the workload by one profiling window of ``iters``
        iterations under the given active ``faults``, profiling at the
        per-worker sample ``rates`` (None = deployment default)."""

    def close(self) -> None:
        """Release workload resources (loaders, threads); idempotent."""


def merge_anchor_durations(per_worker: Sequence[Sequence[float]]
                           ) -> List[float]:
    """Job-level iteration durations from per-worker ones: max per
    iteration index (a synchronous step waits for its slowest worker).
    Ragged inputs (a worker lost mid-window) merge over the indices it
    reported."""
    n = max((len(d) for d in per_worker), default=0)
    out = []
    for i in range(n):
        vals = [d[i] for d in per_worker if i < len(d)]
        out.append(float(max(vals)))
    return out


def merge_numerics(per_worker: Sequence[Sequence[Tuple[float, float]]],
                   durations: Sequence[float], t0: float
                   ) -> List[Tuple[float, float, float]]:
    """Job-level (t, loss, grad_norm) samples from per-worker per-iteration
    (loss, grad_norm) pairs: worst (max) value per iteration index, with
    non-finite values winning outright — one worker's NaN IS the job's NaN.
    Timestamps come from the measured iteration ``durations`` chained on
    the job clock starting at ``t0`` (same clock as the anchor stream)."""
    def worst(vals: List[float]) -> float:
        for v in vals:
            if v != v or abs(v) == float("inf"):
                return v
        return max(vals)

    n = max((len(d) for d in per_worker), default=0)
    out: List[Tuple[float, float, float]] = []
    t = float(t0)
    for i in range(n):
        t += float(durations[i]) if i < len(durations) else 0.0
        pairs = [d[i] for d in per_worker if i < len(d)]
        out.append((t, worst([float(p[0]) for p in pairs]),
                    worst([float(p[1]) for p in pairs])))
    return out


def merge_slo(per_worker: Sequence[Sequence[Tuple[float, float]]],
              durations: Sequence[float], t0: float
              ) -> List[Tuple[float, float, float]]:
    """Job-level (t, p99_ttft, p99_tbt) samples from per-worker
    per-iteration (ttft, tbt) pairs shipped on ``anchors`` wire frames:
    the fleet's p99 is dominated by its worst worker, so the merge rule is
    the same worst-per-index fold the numerics channel uses (one stalled
    worker IS the job's SLO violation)."""
    return merge_numerics(per_worker, durations, t0)


def synth_anchor_events(durations: Sequence[float], t0: float
                        ) -> Tuple[List[Tuple[str, float]], float]:
    """(D, O) anchor pairs for measured iteration durations, chained on a
    continuous clock starting at ``t0``.  Returns (events, end_clock)."""
    out: List[Tuple[str, float]] = []
    t = float(t0)
    for dur in durations:
        out.append(("dataloader.next", t))
        out.append(("optimizer.step", t + dur * _OPT_ANCHOR_FRAC))
        t += dur
    return out, t


class SimWorkload(WorkloadSource):
    """The historical profile source: ``FleetSimulator`` synthesis.

    Byte-identical to the pre-refactor ``ScenarioRunner.run`` loop: the
    anchor stream draws from ``sim.rng`` before the (window-seeded)
    profile materialization, faults are installed by assignment, and the
    escalation rates the caller passes are a pure read taken before any
    of it (the policy only updates at the previous window's tick)."""

    def __init__(self, sim, seed: int, seed_stride: int):
        self.sim = sim
        self._seed = int(seed)
        self._stride = int(seed_stride)

    @property
    def total_workers(self) -> int:
        return self.sim.total_workers

    @property
    def active_workers(self) -> np.ndarray:
        return self.sim.active_workers

    @property
    def family(self) -> str:
        return self.sim.cfg.family

    @property
    def channel(self) -> str:
        return (channels.SLO if self.sim.cfg.workload == "serve"
                else channels.PERF)

    def seed_of(self, window: int) -> int:
        return self._seed + self._stride * (window + 1)

    def run_window(self, window: int, faults: Sequence, iters: int,
                   rates: Optional[np.ndarray]) -> WindowData:
        self.sim.faults = list(faults)
        t0 = self.sim.anchor_clock
        anchors = self.sim.anchor_events(iters, t0=t0)
        profiles = self.sim.profile_window(rates=rates,
                                           seed=self.seed_of(window))
        if self.sim.cfg.workload == "serve":
            metrics = {channels.SLO: self.sim.slo_window(
                iters, self.seed_of(window), t0, self.sim.anchor_clock)}
        else:
            metrics = {channels.NUMERICS: self.sim.numerics_window(
                iters, self.seed_of(window), t0, self.sim.anchor_clock)}
        return WindowData(anchors=anchors, profiles=profiles,
                          workers=self.sim.active_workers,
                          clock=self.sim.anchor_clock, t0=t0,
                          metrics=metrics)
