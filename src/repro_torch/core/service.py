"""PerfTracker service: the end-to-end pipeline of Fig. 6.

  anchor events -> IterationDetector -> trigger -> 20s profiling window on
  every worker -> pattern summarization -> centralized localization (single
  core) -> Fig.-7 report (+ mitigation hooks).

This package runs the ``fleet`` mode of the JAX reference (DESIGN.md §5):
all W workers' executions are packed into one ragged batch per stream rate,
the selected backend's ``batch_stats`` runs once per group for the entire
fleet (kernel K1 on the card by default), and patterns scatter-reduce
straight into the aggregator's columnar ``(W, F, 3)`` buffer.  The ``wire``
mode and ``diagnose_batch`` need the daemon and the socket transport, which
come with the transport slice of the port.

Device policy: the service runs on ``device`` (``None`` means ``"cuda"``).
Without a CUDA device it raises unless the caller asks for ``"cpu"``, where
the default summarize backend is the plain torch version of K1.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.detector import DetectorConfig, IterationDetector, Trigger
from repro_torch.core.events import Kind, WorkerProfile
from repro_torch.core.localizer import Localizer
from repro_torch.core.mitigation import (MitigationPlan, format_plans,
                                         plan_mitigations)
from repro_torch.core.report import Diagnosis, build_report, format_report
from repro_torch.summarize.engine import _resolve_backend
from repro_torch.summarize.fleet import summarize_fleet

_TRANSPORT_SLICE = ("needs the daemon and the socket transport, which come "
                    "with the transport slice of the port")


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device must exist (no fallback to
    the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "diagnosis on the host")
    return dev


@dataclass
class DiagnosisResult:
    trigger: Optional[Trigger]
    diagnoses: List[Diagnosis]
    fleet_size: int
    timing: Dict[str, float]
    pattern_bytes: int
    raw_bytes: int

    def report(self, mitigation: bool = False) -> str:
        """Fig.-7 report; ``mitigation=True`` appends the suggested plans
        (first rung of each diagnosis's ladder, DESIGN.md §9)."""
        out = format_report(self.diagnoses, self.fleet_size)
        if mitigation and self.diagnoses:
            out += "\n" + format_plans(self.suggested_plans())
        return out

    def suggested_plans(self) -> List[MitigationPlan]:
        """Flat batch mitigation view of this diagnosis
        (``plan_mitigations``: merged REPLACE_HOSTS + per-diagnosis first
        rungs)."""
        return plan_mitigations(self.diagnoses, self.fleet_size)

    def functions(self) -> List[str]:
        return [d.abnormality.function for d in self.diagnoses]


class PerfTrackerService:
    """Global side of PerfTracker. ``family`` tunes expected-range boxes;
    ``device`` is where summarization runs (see the module docstring)."""

    def __init__(self, family: str = "dense",
                 detector_cfg: Optional[DetectorConfig] = None,
                 summarize_backend=None, device=None):
        self.family = family
        self.device = resolve_device(device)
        # None -> a fresh DetectorConfig per service; an eagerly-evaluated
        # default would be ONE module-level instance aliased across every
        # PerfTrackerService (mutating one service's thresholds would
        # silently retune all others)
        self.detector = IterationDetector(
            detector_cfg if detector_cfg is not None else DetectorConfig())
        self.localizer = Localizer(family=family)
        # name/None resolves now (explicit name, else the env var, else the
        # device's default); an instance is used as given
        self.summarize_backend = _resolve_backend(summarize_backend,
                                                  self.device)

    # -- detection ---------------------------------------------------------
    def feed_anchors(self, events: Sequence[Tuple[str, float]]
                     ) -> Optional[Trigger]:
        for name, t in events:
            trig = self.detector.feed(name, t)
            if trig is not None:
                return trig
        return None

    # -- diagnosis ---------------------------------------------------------
    def diagnose_batch(self, batch, fleet_size: Optional[int] = None,
                       row_of: Optional[Dict[int, int]] = None,
                       trigger: Optional[Trigger] = None,
                       timing: Optional[Dict[str, float]] = None
                       ) -> DiagnosisResult:
        """Diagnose one assembled wire window: not in this package yet."""
        raise NotImplementedError(f"diagnose_batch {_TRANSPORT_SLICE}")

    def diagnose_profiles(self, profiles: Sequence[WorkerProfile],
                          kind_of: Optional[Dict[str, Kind]] = None,
                          trigger: Optional[Trigger] = None,
                          mode: str = "fleet") -> DiagnosisResult:
        """Diagnose one fleet of raw profiling windows.

        ``mode="fleet"`` batches the whole fleet through one summarization
        pass in-process; ``mode="wire"`` raises ``NotImplementedError``
        until the transport slice is ported.
        """
        if mode == "wire":
            raise NotImplementedError(f"mode='wire' {_TRANSPORT_SLICE}")
        if mode != "fleet":
            raise ValueError(f"unknown diagnosis mode {mode!r}; "
                             "expected 'fleet' or 'wire'")
        timing = {}
        t0 = time.perf_counter()
        fs = summarize_fleet(profiles, kind_of,
                             backend=self.summarize_backend)
        timing["summarize_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        agg, kinds = fs.agg.finalize()
        abn = self.localizer.localize(agg, kinds)
        timing["localize_s"] = time.perf_counter() - t1
        return DiagnosisResult(
            trigger=trigger,
            diagnoses=build_report(abn, len(profiles)),
            fleet_size=len(profiles),
            timing=timing,
            pattern_bytes=fs.pattern_bytes,
            raw_bytes=sum(p.raw_size_bytes() for p in profiles))

    def diagnose_patterns(self, patterns: Dict[str, np.ndarray],
                          kinds: Dict[str, Kind]) -> DiagnosisResult:
        """Pattern-mode entry (scaling benchmarks / pre-aggregated fleets)."""
        W = next(iter(patterns.values())).shape[0] if patterns else 0
        t0 = time.perf_counter()
        abn = self.localizer.localize(patterns, kinds)
        dt = time.perf_counter() - t0
        return DiagnosisResult(
            trigger=None, diagnoses=build_report(abn, W), fleet_size=W,
            timing={"localize_s": dt}, pattern_bytes=0, raw_bytes=0)
