"""``import PerfTracker``-style attachment (paper §4, Usage; port of the
reference's ``repro/instrument/hooks.py``).

The provider never sees user code: ``PerfTracker.wrap(loader, opt_step)``
replaces the two anchor callables with timed versions (the paper
monkey-patches ``dataloader.next`` / ``optimizer.step`` the same way);
everything else (iteration detection, trigger, profiling window,
pattern upload, localization) happens behind the wrappers: each finished
window is diagnosed in ``mode="wire"``, the single-worker daemon shape,
through the socket transport (``repro_torch.transport``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.core.detector import DetectorConfig, Trigger
from repro_torch.core.events import Kind
from repro_torch.core.service import DiagnosisResult, PerfTrackerService
from repro_torch.instrument.tracer import Tracer


@dataclass
class PerfTrackerConfig:
    window_s: float = 2.0            # paper default 20 s; scaled for tests
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    family: str = "dense"
    auto_profile: bool = True
    #: summarize backend name for this worker's daemon (None = env/auto)
    summarize_backend: Optional[str] = None


class PerfTracker:
    """Single-worker online attachment.  ``device`` is where the diagnosis
    runs (``None`` means ``"cuda"``, see ``PerfTrackerService``)."""

    def __init__(self, cfg: Optional[PerfTrackerConfig] = None,
                 worker: int = 0, device=None):
        self.cfg = cfg if cfg is not None else PerfTrackerConfig()
        self.service = PerfTrackerService(
            family=self.cfg.family, detector_cfg=self.cfg.detector,
            summarize_backend=self.cfg.summarize_backend, device=device)
        self.tracer = Tracer(worker)
        self._window_deadline: Optional[float] = None
        self.last_trigger: Optional[Trigger] = None
        self.results: List[DiagnosisResult] = []

    # -- anchors -----------------------------------------------------------
    def _on_anchor(self, name: str):
        now = time.perf_counter()
        trig = self.service.detector.feed(name, now)
        if trig is not None and self.cfg.auto_profile \
                and self._window_deadline is None:
            self.last_trigger = trig
            self.tracer.start_window()
            self._window_deadline = now + self.cfg.window_s
        elif self._window_deadline is not None \
                and now >= self._window_deadline:
            self._finish_window()

    def _finish_window(self):
        self._window_deadline = None
        profile = self.tracer.stop_window()
        # wire mode: the true single-worker daemon shape — and it reuses
        # the (E, n) batch the tracer pre-packed onto profile.packed, which
        # the fleet-wide gather path would rebuild from raw streams
        res = self.service.diagnose_profiles([profile],
                                             trigger=self.last_trigger,
                                             mode="wire")
        self.results.append(res)

    def flush(self) -> Optional[DiagnosisResult]:
        if self._window_deadline is not None:
            self._finish_window()
        return self.results[-1] if self.results else None

    # -- wrapping ----------------------------------------------------------
    def wrap(self, dataloader_next: Callable, optimizer_step: Callable):
        def wrapped_next(*a, **kw):
            self._on_anchor("dataloader.next")
            with self.tracer.phase("dataloader.py:__next__", Kind.PYTHON,
                                   depth=2):
                return dataloader_next(*a, **kw)

        def wrapped_step(*a, **kw):
            with self.tracer.phase("optimizer.py:step", Kind.PYTHON,
                                   depth=2):
                out = optimizer_step(*a, **kw)
            self._on_anchor("optimizer.step")
            return out

        return wrapped_next, wrapped_step
