"""Host-side tracer + hardware sampler for the REAL training loop (port of
the reference's ``repro/instrument/tracer.py``; DESIGN.md §2).

Phases (data.next / train.step / optimizer.step / ...) are recorded as
FunctionEvents.  A phase's ``fence`` waits for the device at the phase's
end: ``torch.cuda.synchronize`` of the device the fenced tensors live on
(the reference's ``jax.block_until_ready``); tensors on the CPU need no
wait.

Every phase, and the fenced ``train.step`` that
``Trainer.train_iteration`` records as an event, is also a ``span``: the
one primitive by which the program names a stretch of its own work.  With
``torch.profiler`` on, a span is a ``record_function`` range, so it lies
in the device trace on the trace's own clock and names the kernels
launched inside it; with the in-memory record on (``record_spans``), it
is kept as a ``Span``; with both off it costs one check.  The step's own spans (``train.forward``,
``train.backward``, ``optimizer.update``, ``dataloader.to_device``) sit
where that work happens, in ``train/step.py``, ``optim/adamw.py`` and
``train/loop.py``, and never reach the profile.

The HostSampler thread samples real /proc/stat CPU utilization at up to
~1 kHz into a SampleStream.  The stream set is EXPLICIT per resource:
only resources with a real sampler appear in the profile (no device
counter is sampled yet, so the default tracer exposes only ``cpu`` —
absent streams are omitted, never faked by aliasing; the pack layer drops
events whose resource stream is missing and the summarize engine still
emits beta-only patterns for them).
"""
from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch
from torch.autograd.profiler import record_function

from repro_torch.core.events import (FunctionEvent, Kind, SampleStream,
                                     WorkerProfile)


@dataclass
class Span:
    """One span of the in-memory record: ``start`` and ``end`` on the
    tracer's clock (``time.perf_counter``), and ``parent``, the index in
    the record of the span open around it on the same thread (None for a
    top span)."""
    name: str
    start: float
    end: float = math.nan
    parent: Optional[int] = None


class _Record:
    def __init__(self):
        self.spans: List[Span] = []
        self.lock = threading.Lock()
        self.local = threading.local()      # per thread: open span indices


_record: Optional[_Record] = None


def record_spans(on: bool) -> List[Span]:
    """Turn the in-memory span record on or off (off by default), and hand
    over the spans it held since the last call, in the order they opened.
    A span open across the call lands in the list handed over, and its
    ``end`` is set when it closes."""
    global _record
    held = _record.spans if _record is not None else []
    _record = _Record() if on else None
    return held


@contextmanager
def span(name: str):
    """A named stretch of the program's work (module docstring)."""
    rec = _record
    profiling = torch._C._autograd._profiler_enabled()
    if rec is None and not profiling:
        yield
        return
    with record_function(name) if profiling else nullcontext():
        if rec is None:
            yield
            return
        stack = rec.local.__dict__.setdefault("open", [])
        s = Span(name, time.perf_counter(),
                 parent=stack[-1] if stack else None)
        with rec.lock:
            stack.append(len(rec.spans))
            rec.spans.append(s)
        try:
            yield
        finally:
            stack.pop()
            s.end = time.perf_counter()


def _read_proc_stat() -> Tuple[float, float]:
    with open("/proc/stat") as f:
        parts = f.readline().split()
    vals = [float(x) for x in parts[1:8]]
    idle = vals[3] + vals[4]
    return sum(vals), idle


def _cuda_device(obj):
    """The device of the first CUDA tensor in a nested dict/list/tuple, or
    None."""
    if isinstance(obj, torch.Tensor):
        return obj.device if obj.is_cuda else None
    items = obj.values() if isinstance(obj, dict) else \
        obj if isinstance(obj, (list, tuple)) else ()
    for sub in items:
        dev = _cuda_device(sub)
        if dev is not None:
            return dev
    return None


def sync(obj) -> None:
    """Wait until the device that holds ``obj``'s tensors is idle (nothing
    to wait for when they lie on the CPU)."""
    dev = _cuda_device(obj)
    if dev is not None:
        torch.cuda.synchronize(dev)


class HostSampler:
    """Background CPU-utilization sampler."""

    def __init__(self, rate_hz: float = 500.0):
        self.rate_hz = rate_hz
        self._stop = threading.Event()
        self._vals: List[float] = []
        self._t0 = 0.0
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._stop.clear()
        self._vals = []
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        prev_total, prev_idle = _read_proc_stat()
        period = 1.0 / self.rate_hz
        while not self._stop.is_set():
            time.sleep(period)
            total, idle = _read_proc_stat()
            dt, di = total - prev_total, idle - prev_idle
            prev_total, prev_idle = total, idle
            util = 1.0 - (di / dt) if dt > 0 else 0.0
            self._vals.append(max(0.0, min(1.0, util)))

    def stop(self) -> SampleStream:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        vals = np.asarray(self._vals, np.float64)
        n = len(vals)
        eff_rate = n / max(1e-9, time.perf_counter() - self._t0)
        return SampleStream(rate_hz=max(eff_rate, 1.0), t0=self._t0,
                            values=vals)


class ProcessSampler(HostSampler):
    """Per-PROCESS CPU sampler (CLOCK_PROCESS_CPUTIME_ID via
    ``time.process_time``).

    The machine-wide ``/proc/stat`` sampler floors utilization at whatever
    the host's background load is — a real trainer sleeping on a stalled
    device still reads ~0.4 busy on a shared box.  Process CPU time reads 0
    the moment THIS process goes idle, and at nanosecond resolution (no
    10 ms jiffy quantization), which is what makes the localizer's mu-based
    playbook rules (GC pauses, throttling) reliable for real trainer
    workloads (DESIGN.md §11).  Multi-threaded compute (torch intra-op
    pools) saturates to 1.0."""

    def _run(self):
        prev_c = time.process_time()
        prev_w = time.perf_counter()
        period = 1.0 / self.rate_hz
        while not self._stop.is_set():
            time.sleep(period)
            c, w = time.process_time(), time.perf_counter()
            dc, dw = c - prev_c, w - prev_w
            prev_c, prev_w = c, w
            util = dc / dw if dw > 0 else 0.0
            self._vals.append(max(0.0, min(1.0, util)))


class Tracer:
    """Records phase events; active only during a profiling window.

    The tracer is the producer side of the batched summarize pipeline:
    ``stop_window`` pre-packs the recorded events into the ``(E, n)`` matrix
    the summarize backends consume (DESIGN.md §3), so the daemon's
    summarization starts from packed rows instead of re-slicing streams
    event by event.  Which backend consumes the pack is the service/daemon's
    choice (``PerfTrackerService(summarize_backend=...)`` or the
    ``REPRO_SUMMARIZE_BACKEND`` env var).

    ``samplers`` maps resource name -> sampler; the default is one real
    ``cpu`` HostSampler.  A platform with hardware counters registers more
    (``gpu_sm``/``pcie_tx``/``membw``) — resources without a sampler are
    simply absent from the profile's stream set, not faked.
    """

    def __init__(self, worker: int = 0, pack: bool = True,
                 rate_hz: float = 500.0,
                 samplers: Optional[Dict[str, HostSampler]] = None):
        self.worker = worker
        self.pack = pack
        self.events: List[FunctionEvent] = []
        self.active = False
        self._window_start = 0.0
        self.samplers: Dict[str, HostSampler] = (
            dict(samplers) if samplers is not None
            else {"cpu": HostSampler(rate_hz=rate_hz)})

    def set_rate(self, rate_hz: float) -> None:
        """Differential escalation (DESIGN.md §7): the service retunes each
        worker's sampling rate between profiling windows — implicated
        workers run at the full rate, the rest at the cheap base rate.
        Takes effect at the next ``start_window`` (the sampler thread reads
        its rate once at start)."""
        if self.active:
            raise RuntimeError("cannot retune rate_hz mid-window")
        for s in self.samplers.values():
            s.rate_hz = float(rate_hz)

    def start_window(self):
        self.events = []
        self.active = True
        self._window_start = time.perf_counter()
        for s in self.samplers.values():
            s.start()

    def stop_window(self) -> WorkerProfile:
        self.active = False
        t0 = self._window_start
        streams: Dict[str, SampleStream] = {}
        for res, sampler in self.samplers.items():
            s = sampler.stop()
            streams[res] = SampleStream(s.rate_hz, 0.0, s.values)
        end = time.perf_counter()
        events = [
            FunctionEvent(e.name, e.kind, e.start - t0, e.end - t0,
                          self.worker, e.thread, e.depth, e.resource)
            for e in self.events]
        profile = WorkerProfile(
            worker=self.worker, window=(0.0, end - t0), events=events,
            streams=streams)
        if self.pack:
            from repro_torch.summarize.packing import pack_profile
            profile.packed = pack_profile(profile)
        return profile

    @contextmanager
    def phase(self, name: str, kind: Kind = Kind.PYTHON, depth: int = 1,
              fence=None, resource: str = ""):
        """A phase: an event of the window while it is open, and a ``span``
        of the same name (its fence included) whether or not it is."""
        with span(name):
            if not self.active:
                yield
                return
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if fence is not None:
                    sync(fence() if callable(fence) else fence)
                self.events.append(FunctionEvent(
                    name, kind, t0, time.perf_counter(), self.worker,
                    depth=depth, resource=resource))

    def add_event(self, name: str, kind: Kind, start: float, end: float,
                  depth: int = 2, resource: str = "") -> None:
        """Record an event with explicit absolute perf_counter times (the
        trainer records its fenced ``train.step`` span this way)."""
        if not self.active:
            return
        self.events.append(FunctionEvent(
            name, kind, start, end, self.worker, depth=depth,
            resource=resource))
