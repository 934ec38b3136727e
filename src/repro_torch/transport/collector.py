"""Window assembly on the collector side (DESIGN.md §8).

Uploads arrive per (window, worker) over per-worker connections, in
whatever order the wire delivers them — possibly duplicated (a retrying
client, an injected fault) and possibly never (client-side backpressure
drop, injected loss).  ``WindowCollector`` reassembles them into
``WindowBatch``es with *partial-window semantics*:

  * a window is COMPLETE when every expected worker has closed it with a
    ``window_end`` frame — not when every upload arrived.  A worker whose
    upload was dropped still ends the window (the end frame is
    undroppable), so the collector learns about the hole immediately
    instead of timing out on it;
  * duplicate (window, worker) uploads keep the FIRST copy and count the
    rest (``duplicates``);
  * workers that never even end the window (dead process, wedged socket)
    are bounded by the ``wait_window`` timeout and reported in
    ``missing`` alongside the dropped ones.

The batch carries everything downstream diagnosis needs to degrade
gracefully: the present-worker set, the missing set, duplicate and
client-side drop counters.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from repro_torch.transport import framing


@dataclass
class WindowBatch:
    """One assembled (possibly partial) profiling window."""
    window: int
    expected: Tuple[int, ...]                 # worker ids owed this window
    uploads: Dict[int, "PatternUpload"] = field(default_factory=dict)
    #: per-worker measured iteration durations (REAL workloads only; empty
    #: for simulator runs, whose parents own the anchor stream)
    anchors: Dict[int, List[float]] = field(default_factory=dict)
    #: per-worker per-iteration (loss, grad_norm) pairs for the numerics
    #: channel (only when the workload ships them on its anchors frames)
    numerics: Dict[int, List[Tuple[float, float]]] = field(
        default_factory=dict)
    #: per-worker per-iteration (p99_ttft, p99_tbt) pairs for the serving
    #: latency-SLO channel (same ride-along contract as ``numerics``)
    slo: Dict[int, List[Tuple[float, float]]] = field(
        default_factory=dict)
    ended: Set[int] = field(default_factory=set)
    duplicates: int = 0                       # deduped (window, worker) copies
    client_dropped: int = 0                   # cumulative backpressure drops
    reconnects: int = 0                       # cumulative client re-dials
    timed_out: bool = False                   # wait_window hit its deadline

    @property
    def present(self) -> List[int]:
        """Workers whose upload arrived, ascending."""
        return sorted(self.uploads)

    @property
    def missing(self) -> List[int]:
        """Expected workers with no upload this window."""
        return sorted(set(self.expected) - set(self.uploads))

    @property
    def complete(self) -> bool:
        return not self.missing

    def present_mask(self, fleet_size: int) -> np.ndarray:
        mask = np.zeros(int(fleet_size), bool)
        mask[self.present] = True
        return mask

    def sorted_uploads(self) -> List["PatternUpload"]:
        return [self.uploads[w] for w in self.present]

    def stats(self) -> Dict[str, object]:
        """Transport counters for reports (DESIGN.md §8)."""
        return {"window": self.window,
                "expected": len(self.expected),
                "present": len(self.uploads),
                "missing": self.missing,
                "duplicates": self.duplicates,
                "client_dropped": self.client_dropped,
                "reconnects": self.reconnects,
                "timed_out": self.timed_out}


class WindowCollector:
    """Thread-safe (window, worker) -> upload reassembly."""

    #: frame types the DaemonServer forwards here (anchors frames carry a
    #: real workload's iteration durations, DESIGN.md §11)
    HANDLED = ("upload", "window_end", "anchors")

    def __init__(self, expected_workers: Sequence[int]):
        self.expected = tuple(sorted(int(w) for w in expected_workers))
        self._batches: Dict[int, WindowBatch] = {}
        #: latest cumulative drop/reconnect counters per worker
        #: (from window_end)
        self._drops: Dict[int, int] = {}
        self._reconnects: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        #: highest window index already handed out by wait_window; frames
        #: for it (or older windows) are stragglers — counted and dropped,
        #: never resurrected into _batches (which would leak one batch per
        #: late upload over a long-running pipeline).  Assumes windows are
        #: consumed in ascending order, which every driver does.
        self._popped_through: float = float("-inf")
        self.total_uploads = 0
        self.total_duplicates = 0
        self.stale_frames = 0

    def _batch(self, window: int) -> WindowBatch:
        b = self._batches.get(window)
        if b is None:
            b = self._batches[window] = WindowBatch(
                window=window, expected=self.expected)
        return b

    # -- frame ingestion (called from the server's IO thread) ---------------
    def on_message(self, msg: Dict) -> None:
        t = msg.get("t")
        if t == "upload":
            window, upload = framing.msg_to_upload(msg)
            with self._cv:
                if window <= self._popped_through:
                    self.stale_frames += 1
                    return
                b = self._batch(window)
                if upload.worker in b.uploads:
                    b.duplicates += 1
                    self.total_duplicates += 1
                else:
                    b.uploads[upload.worker] = upload
                    self.total_uploads += 1
        elif t == "anchors":
            with self._cv:
                if int(msg["window"]) <= self._popped_through:
                    self.stale_frames += 1
                    return
                b = self._batch(int(msg["window"]))
                # first copy wins, like uploads (the frame is undroppable,
                # so a duplicate is a retransmit after reconnect)
                w = int(msg["worker"])
                b.anchors.setdefault(w,
                                     [float(d) for d in msg.get("durs", [])])
                if msg.get("numerics") is not None:
                    b.numerics.setdefault(
                        w, [(float(p[0]), float(p[1]))
                            for p in msg["numerics"]])
                if msg.get("slo") is not None:
                    b.slo.setdefault(
                        w, [(float(p[0]), float(p[1]))
                            for p in msg["slo"]])
        elif t == "window_end":
            with self._cv:
                if int(msg["window"]) <= self._popped_through:
                    self.stale_frames += 1
                    return
                b = self._batch(int(msg["window"]))
                b.ended.add(int(msg["worker"]))
                self._drops[int(msg["worker"])] = int(msg.get("dropped", 0))
                self._reconnects[int(msg["worker"])] = \
                    int(msg.get("reconnects", 0))
                if b.ended >= set(self.expected):
                    self._cv.notify_all()

    # -- consumer side -------------------------------------------------------
    def client_dropped(self) -> int:
        with self._lock:
            return sum(self._drops.values())

    def set_expected(self, workers: Sequence[int]) -> None:
        """Re-key the expected worker set when the training mesh changes
        (control-plane membership delta, DESIGN.md §10).  Applies to all
        OPEN batches too: a window opened under the old mesh but not yet
        popped completes under the new one — mitigated-away workers stop
        being owed, replacements start being owed."""
        with self._cv:
            self.expected = tuple(sorted(int(w) for w in workers))
            for b in self._batches.values():
                b.expected = self.expected
            self._cv.notify_all()

    def wait_window(self, window: int, timeout: float = 30.0) -> WindowBatch:
        """Block until every expected worker ended ``window`` (or timeout);
        returns the batch — partial if uploads were dropped or workers
        never reported."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                b = self._batch(window)
                if b.ended >= set(self.expected):
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    b.timed_out = True
                    break
                self._cv.wait(timeout=min(remaining, 0.5))
            self._batches.pop(window, None)
            self._popped_through = max(self._popped_through, window)
            b.client_dropped = sum(self._drops.values())
            b.reconnects = sum(self._reconnects.values())
            return b
