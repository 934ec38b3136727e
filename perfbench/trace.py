"""Reading a ``torch.profiler`` trace of a short traced sub-window.

Device activities are read straight from the trace's raw events, as the
port's ``chip_smoke.py::device_events`` does, without the op tree that
``key_averages()`` builds.  Device time is given to a layer through the
host range that launched it, never through kernel names: every host-side
runtime call (a kernel launch, a copy, a fill) made inside one of the
layer's host ranges carries a correlation id, and the device activities
with those ids are the layer's.  A renamed or split kernel still counts.
"""
from __future__ import annotations

import bisect
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

#: the host range that bounds the traced sub-window
WINDOW = "perfbench.window"
NAME_CHARS = 120


@dataclass
class Interval:
    name: str
    start: int                   # ns
    end: int                     # ns
    thread: int = 0
    corr: int = 0


@dataclass
class TraceSummary:
    """What the readers take from one traced sub-window."""
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    #: per anchor: host ranges found, device seconds of their kernels and
    #: fills (copies left out), device activities counted
    anchors: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def breakdown(self) -> Dict[str, list]:
        """The longest device operations and idle gaps, names cut to
        ``NAME_CHARS`` (kernel names hold whole C++ template lists)."""
        return {"device_ops": [[n[:NAME_CHARS], s]
                               for n, s in self.device_ops],
                "idle_gaps": [[n[:NAME_CHARS], s]
                              for n, s in self.idle_gaps]}


@contextmanager
def traced_window(device: torch.device):
    """A ``torch.profiler`` trace (device activities on a card) whose
    ``WINDOW`` range holds the body, ended by a wait for the device."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield prof
            if device.type == "cuda":
                torch.cuda.synchronize(device)


def _events(prof):
    return list(prof.profiler.kineto_results.events())


def _kind(e) -> str:
    """``device``, ``launch`` (a runtime or driver call), ``host`` (an op
    or a user range) or ``skip``."""
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        # a user range's shadow on the device's timeline is not work
        return "skip" if e.is_user_annotation() else "device"
    at = str(e.activity_type()) if hasattr(e, "activity_type") else ""
    if at in ("cuda_runtime", "cuda_driver") or (
            not at and e.name().startswith(("cuda", "cu"))):
        return "launch"
    return "host"


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


def _union(spans: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(prof, anchors: Dict[str, str], top: int = 10
              ) -> Optional[TraceSummary]:
    """Busy and idle time of the device inside the ``WINDOW`` range, its
    longest operations and idle gaps, and the device seconds of each
    anchor: ``{key: host range name}``.  None when the trace holds no
    window or no device activity in it."""
    evs = _events(prof)
    host, device, launches = [], [], []
    for e in evs:
        iv = Interval(e.name(), int(e.start_ns()),
                      int(e.start_ns() + e.duration_ns()),
                      int(e.start_thread_id()), int(e.correlation_id()))
        kind = _kind(e)
        if kind != "skip":
            {"host": host, "device": device, "launch": launches}[
                kind].append(iv)
    win = [h for h in host if h.name == WINDOW]
    if not win:
        return None
    w0, w1 = win[0].start, win[0].end
    dev = [d for d in device if d.end > w0 and d.start < w1]
    if not dev:
        return None
    busy = _union([(max(d.start, w0), min(d.end, w1)) for d in dev])
    busy_ns = sum(b - a for a, b in busy)

    by_name: Dict[str, float] = {}
    for d in dev:
        by_name[d.name] = by_name.get(d.name, 0.0) + (d.end - d.start) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    # the longest idle gaps, labelled by the innermost host range open at
    # their middle
    gaps = []
    prev = w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    gaps = sorted(gaps, reverse=True)[:top]
    ranges = [h for h in host if h.end > w0 and h.start < w1
              and h.name != WINDOW]
    by_end = sorted(ranges, key=lambda h: h.end)
    ends = [h.end for h in by_end]
    by_start = sorted(ranges, key=lambda h: h.start)
    starts = [h.start for h in by_start]
    labelled = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        inner = [h for h in ranges if h.start <= mid < h.end]
        if inner:
            label = min(inner, key=lambda h: h.end - h.start).name
        else:
            # no range open: name the ranges that end before and start
            # after it
            i = bisect.bisect_right(ends, a) - 1
            j = bisect.bisect_left(starts, b)
            label = (f"host after {by_end[i].name if i >= 0 else 'start'}"
                     f" before {by_start[j].name if j < len(by_start) else 'end'}")
        labelled.append((label, length / 1e9))

    out = TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                       device_ops=ops, idle_gaps=labelled)
    for key, name in anchors.items():
        spans = sorted((h.start, h.end, h.thread) for h in host
                       if h.name == name and h.end > w0 and h.start < w1)
        starts = [sp[0] for sp in spans]
        ids = set()
        for h in launches:
            i = bisect.bisect_right(starts, h.start) - 1
            # ranges of one name do not nest: the last one started before
            # the launch is the only one that can hold it
            if i >= 0 and h.start < spans[i][1] and h.thread == spans[i][2]:
                ids.add(h.corr)
        kern = [d for d in device if d.corr in ids and not _is_copy(d.name)]
        out.anchors[key] = {
            "ranges": float(len(spans)),
            "kernels": float(len(kern)),
            "device_s": sum(d.end - d.start for d in kern) / 1e9}
    return out
