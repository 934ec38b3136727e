"""Differential escalation: the minimal-production-impact profiling knob
(paper §5 "minimal impact"; DESIGN.md §7).

The fleet profiles continuously at a cheap *base* sample rate.  Only
workers implicated by the previous window's ``Abnormality`` set — plus any
still inside a cooldown after their last implication — are escalated to
the *full* rate for the next window.  Healthy steady state therefore costs
``base/full`` of always-on full-rate profiling, while suspected workers
get full-fidelity evidence exactly when localization needs it.

``rates()`` is what a deployment feeds each worker's tracer
(``Tracer.set_rate``) and what the scenario runner feeds
``FleetSimulator.profile_window(rates=...)``; ``summarize_fleet`` already
groups execution rows by stream rate, so a mixed-rate fleet batches
without any re-padding.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core.localizer import Abnormality


class EscalationPolicy:
    """Per-worker sample-rate controller."""

    def __init__(self, n_workers: int, base_rate_hz: float,
                 full_rate_hz: float, cooldown_windows: int = 2,
                 max_escalated: Optional[int] = None):
        if base_rate_hz > full_rate_hz:
            raise ValueError("base rate must not exceed full rate")
        self.n_workers = int(n_workers)
        self.base_rate_hz = float(base_rate_hz)
        self.full_rate_hz = float(full_rate_hz)
        self.cooldown_windows = int(cooldown_windows)
        #: hard budget on concurrently-escalated workers (None = unbounded).
        #: This bounds the profiling overhead even for FLEET-WIDE faults:
        #: a pattern every worker exhibits is already confirmed at the base
        #: rate, so full-rate evidence from a bounded sample suffices —
        #: localization ranks abnormalities by beta, and the budget keeps
        #: the highest-ranked workers.
        self.max_escalated = max_escalated
        #: remaining escalated windows per worker (0 = base rate)
        self._ttl = np.zeros(self.n_workers, np.int64)

    @property
    def escalated(self) -> List[int]:
        return np.flatnonzero(self._ttl > 0).tolist()

    def rates(self) -> np.ndarray:
        """(W,) per-worker sample rates for the NEXT profiling window."""
        return np.where(self._ttl > 0, self.full_rate_hz,
                        self.base_rate_hz)

    def observe(self, abnormalities: Iterable[Abnormality]) -> List[int]:
        """Fold one window's localization result: implicated workers are
        (re-)escalated for ``cooldown_windows`` windows, everyone else's
        cooldown burns down one window.  Returns the new escalated set.

        With a ``max_escalated`` budget, implication order breaks the tie:
        abnormalities arrive beta-ranked from the localizer, so the budget
        keeps the workers of the most dominant abnormal functions."""
        self._ttl = np.maximum(self._ttl - 1, 0)
        fresh: List[int] = []
        seen = set()
        for a in abnormalities:
            for w in np.asarray(a.workers, np.int64).tolist():
                if 0 <= w < self.n_workers and w not in seen:
                    seen.add(w)
                    fresh.append(w)
        if self.max_escalated is not None:
            fresh = fresh[:max(0, self.max_escalated)]
        for w in fresh:
            self._ttl[w] = self.cooldown_windows
        if self.max_escalated is not None:
            idx = np.flatnonzero(self._ttl > 0)
            if idx.size > self.max_escalated:
                # the budget is hard: everything beyond the (already
                # truncated) fresh set competes for the remaining room —
                # higher TTL wins, worker id breaks exact ties
                kept = set(fresh)
                extras = [w for w in idx.tolist() if w not in kept]
                extras.sort(key=lambda w: (-int(self._ttl[w]), w))
                room = max(0, self.max_escalated - len(kept))
                for w in extras[room:]:
                    self._ttl[w] = 0
        return self.escalated

    def escalate(self, workers: Sequence[int]) -> None:
        """Manual escalation hook (e.g. operator-pinned suspects)."""
        idx = np.asarray(list(workers), np.int64)
        self._ttl[idx] = np.maximum(self._ttl[idx], self.cooldown_windows)

    def window_bytes(self, window_s: float, streams: int = 4,
                     itemsize: int = 8) -> float:
        """Raw sample bytes the NEXT window will collect fleet-wide —
        the benchmarked cost of the current escalation decision."""
        return float(self.rates().sum() * window_s * streams * itemsize)
