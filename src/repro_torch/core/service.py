"""PerfTracker service: the end-to-end pipeline of Fig. 6.

  anchor events -> IterationDetector -> trigger -> 20s profiling window on
  every worker -> pattern summarization -> centralized localization (single
  core) -> Fig.-7 report (+ mitigation hooks).

Summarization runs in one of two modes (DESIGN.md §5, §8), as in the JAX
reference:

  * ``fleet`` (default) — the in-process fast path: all W workers'
    executions are packed into one ragged batch per stream rate, the
    selected backend's ``batch_stats`` runs once per group for the entire
    fleet (kernel K1 on the card by default), and patterns scatter-reduce
    straight into the aggregator's columnar ``(W, F, 3)`` buffer.  msgpack
    never runs.
  * ``wire`` — the distributed-daemon shape: one ``summarize_and_upload``
    per worker (one K1 launch per worker and stream rate on the card), each
    ~KB msgpack payload shipped through the REAL transport
    (``repro_torch.transport``: length-prefixed frames over a Unix socket,
    per-worker connections, bounded send queues), reassembled by the
    ``WindowCollector``, and folded into the ``PatternAggregator``.
    Dropped uploads degrade the diagnosis (absent workers are excluded
    from localization statistics) instead of crashing it.

With no loss, both modes produce byte-identical diagnoses (a tested
invariant).

Device policy: the service runs on ``device`` (``None`` means ``"cuda"``).
Without a CUDA device it raises unless the caller asks for ``"cpu"``, where
the default summarize backend is the plain torch version of K1.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.detector import DetectorConfig, IterationDetector, Trigger
from repro_torch.core.daemon import PatternUpload, summarize_and_upload
from repro_torch.core.events import Kind, WorkerProfile
from repro_torch.core.localizer import Localizer
from repro_torch.core.mitigation import (MitigationPlan, format_plans,
                                         plan_mitigations)
from repro_torch.core.report import (Diagnosis, build_report, format_report,
                                     format_transport)
from repro_torch.summarize.aggregate import PatternAggregator
from repro_torch.summarize.engine import _resolve_backend
from repro_torch.summarize.fleet import summarize_fleet

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
    #: wire-transport counters for this diagnosis (None off the wire):
    #: present/missing workers, dedup and client-side drop counts
    transport: Optional[Dict[str, object]] = field(default=None)

    def report(self, mitigation: bool = False) -> str:
        """Fig.-7 report; ``mitigation=True`` appends the suggested plans
        (first rung of each diagnosis's ladder, DESIGN.md §9)."""
        out = format_report(self.diagnoses, self.fleet_size)
        if self.transport is not None:
            out += "\n" + format_transport(self.transport)
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
                 summarize_backend=None, wire_frame_filter=None,
                 device=None):
        self.family = family
        #: framing-layer fault hook threaded into ``mode="wire"`` loopback
        #: clients (tests inject upload loss/duplication here)
        self.wire_frame_filter = wire_frame_filter
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
    def aggregate(self, uploads: Sequence[PatternUpload]
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, Kind]]:
        """Fold per-worker uploads into {function -> (W, 3)} views of one
        columnar buffer (streaming — each upload's dict is transient).
        Functions missing on a worker get that worker's zeros (never on its
        critical path)."""
        agg = PatternAggregator(expected_workers=len(uploads))
        return agg.extend(uploads).finalize()

    def aggregate_batch(self, uploads: Sequence[PatternUpload],
                        fleet_size: int,
                        row_of: Optional[Dict[int, int]] = None
                        ) -> Tuple[PatternAggregator, np.ndarray]:
        """Scatter a (possibly partial) set of uploads into a full-width
        ``(fleet_size, F, 3)`` aggregator.  ``row_of`` maps worker id ->
        fleet row (identity when None).  Returns the aggregator and the
        present-row mask; absent rows stay zero."""
        agg = PatternAggregator(expected_workers=max(1, fleet_size))
        agg.reserve_workers(fleet_size)
        present = np.zeros(fleet_size, bool)

        # ascending-row order keeps function interning (and therefore
        # first-seen kinds + column order) identical to the streaming path
        def row(u):
            return row_of[u.worker] if row_of else u.worker
        for u in sorted(uploads, key=row):
            agg.add_upload_at(u, row(u))
            present[row(u)] = True
        return agg, present

    def diagnose_batch(self, batch, fleet_size: Optional[int] = None,
                       row_of: Optional[Dict[int, int]] = None,
                       trigger: Optional[Trigger] = None,
                       timing: Optional[Dict[str, float]] = None
                       ) -> DiagnosisResult:
        """Diagnose one assembled wire window (``transport.WindowBatch``).

        Missing workers' rows stay zero and are masked out of localization
        (fewer peers -> coarser Delta, degraded confidence — DESIGN.md §8)
        instead of crashing or polluting the fleet median."""
        if fleet_size is None:
            fleet_size = len(batch.expected)
        t1 = time.perf_counter()
        if hasattr(batch, "aggregate"):
            # collector-tree window (transport.TreeWindowBatch): shard
            # blocks scatter straight into the aggregator — the per-worker
            # msgpack was already unpacked at the leaves (DESIGN.md §10)
            agg, present = batch.aggregate(fleet_size)
            summarize_s = batch.summarize_s
            pattern_bytes = batch.pattern_bytes
            raw_bytes = batch.raw_bytes
        else:
            uploads = batch.sorted_uploads()
            agg, present = self.aggregate_batch(uploads, fleet_size, row_of)
            summarize_s = sum(u.summarize_s for u in uploads)
            pattern_bytes = sum(len(u.payload) for u in uploads)
            raw_bytes = sum(u.raw_bytes for u in uploads)
        pats, kinds = agg.finalize()
        abn = self.localizer.localize(pats, kinds, present=present)
        timing = dict(timing or {})
        timing["localize_s"] = time.perf_counter() - t1
        timing["upload_summarize_s"] = summarize_s
        return DiagnosisResult(
            trigger=trigger,
            diagnoses=build_report(abn, fleet_size),
            fleet_size=fleet_size,
            timing=timing,
            pattern_bytes=pattern_bytes,
            raw_bytes=raw_bytes,
            transport=batch.stats())

    def diagnose_profiles(self, profiles: Sequence[WorkerProfile],
                          kind_of: Optional[Dict[str, Kind]] = None,
                          trigger: Optional[Trigger] = None,
                          mode: str = "fleet") -> DiagnosisResult:
        """Diagnose one fleet of raw profiling windows.

        ``mode="fleet"`` (default) batches the whole fleet through one
        summarization pass in-process; ``mode="wire"`` runs the
        distributed-daemon shape over the REAL transport: per-worker
        summarize + upload through Unix-socket connections into the
        ``WindowCollector`` (DESIGN.md §8).  With no loss, diagnoses are
        byte-identical between the two.
        """
        timing = {}
        t0 = time.perf_counter()
        if mode == "fleet":
            fs = summarize_fleet(profiles, kind_of,
                                 backend=self.summarize_backend)
            timing["summarize_s"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            agg, kinds = fs.agg.finalize()
            pattern_bytes = fs.pattern_bytes
        elif mode == "wire":
            from repro_torch.transport import LoopbackWire
            uploads = [summarize_and_upload(p, kind_of,
                                            backend=self.summarize_backend)
                       for p in profiles]
            timing["summarize_s"] = time.perf_counter() - t0
            t2 = time.perf_counter()
            with LoopbackWire([p.worker for p in profiles],
                              frame_filter=self.wire_frame_filter) as wire:
                batch = wire.send_round(uploads, window=0)
            timing["transport_s"] = time.perf_counter() - t2
            row_of = {p.worker: i for i, p in enumerate(profiles)}
            res = self.diagnose_batch(batch, fleet_size=len(profiles),
                                      row_of=row_of, trigger=trigger,
                                      timing=timing)
            # raw bytes are the profiles actually materialized, delivered
            # or not — the transport only ever sees the ~KB patterns
            res.raw_bytes = sum(p.raw_size_bytes() for p in profiles)
            return res
        else:
            raise ValueError(f"unknown diagnosis mode {mode!r}; "
                             "expected 'fleet' or 'wire'")
        abn = self.localizer.localize(agg, kinds)
        timing["localize_s"] = time.perf_counter() - t1
        return DiagnosisResult(
            trigger=trigger,
            diagnoses=build_report(abn, len(profiles)),
            fleet_size=len(profiles),
            timing=timing,
            pattern_bytes=pattern_bytes,
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
