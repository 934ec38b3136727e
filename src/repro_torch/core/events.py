"""Event & sample model for PerfTracker.

A "function" is any procedure in LMT (paper §3): Python functions (full call
stack = identity), GPU compute kernels, memory ops, collective communication.
Events are intervals on one worker's timeline; resource samples are fixed-rate
utilization streams (10 kHz in the paper).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional, Tuple

import numpy as np


class Kind(IntEnum):
    """Critical-path priority classes (paper §4.2, Fig. 9): lower value =
    higher priority."""
    GPU = 0        # GPU computation kernels
    MEM = 1        # memory operations (malloc/memcpy/H2D/D2H)
    COMM = 2       # collective communication kernels
    PYTHON = 3     # Python functions (training thread, leaf frames)
    NUMERICS = 4   # job-level numerics signals (loss / grad-norm channel,
    #                DESIGN.md §12a) — never appears in worker profiles;
    #                exists so numerics abnormalities ride the same
    #                report/mitigation path as perf kinds


#: resource stream that determines performance per kind (paper §4.2)
RESOURCE_FOR_KIND = {
    Kind.GPU: "gpu_sm",
    Kind.MEM: "membw",
    Kind.COMM: "pcie_tx",     # GPU->NIC for inter-host collectives
    Kind.PYTHON: "cpu",
    Kind.NUMERICS: "cpu",     # defensive: numerics events are synthetic
}


@dataclass(frozen=True)
class FunctionEvent:
    name: str                 # identity; Python functions: full call stack
    kind: Kind
    start: float              # seconds
    end: float
    worker: int = 0
    thread: str = "train"     # Python events: only 'train' thread counts
    depth: int = 0            # call-stack depth (leaf selection)
    resource: str = ""        # override of RESOURCE_FOR_KIND

    @property
    def duration(self) -> float:
        return self.end - self.start

    def resource_stream(self) -> str:
        return self.resource or RESOURCE_FOR_KIND[self.kind]


@dataclass
class SampleStream:
    """Fixed-rate utilization samples in [0, 1]."""
    rate_hz: float
    t0: float
    values: np.ndarray

    def window(self, start: float, end: float) -> np.ndarray:
        i0 = max(0, int((start - self.t0) * self.rate_hz))
        i1 = min(len(self.values), int(np.ceil((end - self.t0)
                                               * self.rate_hz)))
        return self.values[i0:max(i0, i1)]


@dataclass
class WorkerProfile:
    """One worker's raw profiling window (paper: ~3 GB; here: whatever the
    simulator / tracer produced)."""
    worker: int
    window: Tuple[float, float]
    events: List[FunctionEvent] = field(default_factory=list)
    streams: Dict[str, SampleStream] = field(default_factory=dict)
    #: optional pre-built (E, n) batch for the summarize backends
    #: (repro_torch.summarize.packing.PackedEvents); tracers that know their
    #: events fill this so the daemon skips the packing pass
    packed: Optional[object] = None

    def raw_size_bytes(self) -> int:
        ev = sum(64 + len(e.name) for e in self.events)
        st = sum(v.values.nbytes for v in self.streams.values())
        return ev + st


def profile_from_reference(obj) -> WorkerProfile:
    """This package's ``WorkerProfile`` from a profile built by the JAX
    reference package (``repro.core.events.WorkerProfile``).

    Reads ``obj`` by attribute only, so the reference is never imported:
    ``worker``, ``window``, every event's fields (its kind through ``int``)
    and every stream's ``rate_hz``/``t0``/``values``.  Sample arrays are
    shared, not copied.  A pre-packed batch on the reference profile is not
    carried over; packing recomputes it."""
    events = [FunctionEvent(name=e.name, kind=Kind(int(e.kind)),
                            start=e.start, end=e.end, worker=e.worker,
                            thread=e.thread, depth=e.depth,
                            resource=e.resource)
              for e in obj.events]
    streams = {name: SampleStream(rate_hz=s.rate_hz, t0=s.t0,
                                  values=s.values)
               for name, s in obj.streams.items()}
    return WorkerProfile(worker=obj.worker, window=tuple(obj.window),
                         events=events, streams=streams)
