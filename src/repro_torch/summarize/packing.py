"""Pack one worker's executions into a batched utilization matrix.

The per-event Python loop in the old ``summarize_worker`` touched one stream
slice at a time; every summarize backend instead wants *all* executions of a
worker as a single zero-padded ``(E, n)`` matrix so Algorithm 1 runs as
row-parallel feasibility passes (DESIGN.md §3).  Trailing zero-padding is
safe: candidate regions are trimmed to nonzero boundaries, so padded tails
never change the selected critical duration — only the engine's weighting
needs the true per-row lengths, which we carry alongside.

``pack_profile`` is also the single place where a function's *kind* decides
which resource stream an execution reads (``kind_of`` overrides beat the
event's own kind — the unified kind-resolution path used by daemon uploads).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.events import Kind, RESOURCE_FOR_KIND, WorkerProfile


@dataclass
class PackedEvents:
    """Batched view of one worker's executions (E rows, n_max samples)."""
    u: np.ndarray          # (E, n) float32, zero-padded rows
    lengths: np.ndarray    # (E,) int32 true sample counts per row
    rates: np.ndarray      # (E,) float64 sample rate of each row's stream
    fn_ids: np.ndarray     # (E,) int32 index into ``names``
    names: List[str]       # function id -> identity (first-seen order)

    @property
    def n_events(self) -> int:
        return int(self.u.shape[0])


def resolve_kinds(profile: WorkerProfile,
                  kind_of: Optional[Dict[str, Kind]] = None
                  ) -> Dict[str, Kind]:
    """One kind per function: explicit ``kind_of`` overrides win, otherwise
    the kind of the function's first event. The single source of truth for
    both stream selection (here) and upload payloads (daemon)."""
    kinds: Dict[str, Kind] = dict(kind_of or {})
    for e in profile.events:
        kinds.setdefault(e.name, e.kind)
    return kinds


def pack_profile(profile: WorkerProfile,
                 kind_of: Optional[Dict[str, Kind]] = None
                 ) -> PackedEvents:
    """Build the (E, n) matrix for one worker.

    Events whose stream is missing or whose window is empty are dropped
    (exactly the executions the python oracle skipped).  Reuses a matrix the
    tracer pre-packed onto ``profile.packed`` when no kind overrides are in
    play (overrides can reroute an event to a different stream).

    Stream routing precedence, per event: the event's explicit ``resource``
    field wins outright; else a ``kind_of`` override for its function; else
    the event's own kind (so a name recorded under mixed kinds keeps the
    pre-refactor per-event semantics).  The one-kind-per-function map the
    daemon uploads is ``resolve_kinds`` — same override precedence.
    """
    if not kind_of and getattr(profile, "packed", None) is not None:
        return profile.packed
    override = dict(kind_of or {})

    rows: List[np.ndarray] = []
    rates: List[float] = []
    fn_ids: List[int] = []
    names: List[str] = []
    index: Dict[str, int] = {}
    for e in profile.events:
        kind = override.get(e.name, e.kind)
        stream_name = e.resource or RESOURCE_FOR_KIND[kind]
        stream = profile.streams.get(stream_name)
        if stream is None:
            continue
        u = stream.window(e.start, e.end)
        if len(u) == 0:
            continue
        if e.name not in index:
            index[e.name] = len(names)
            names.append(e.name)
        rows.append(np.asarray(u, np.float32))
        rates.append(stream.rate_hz)
        fn_ids.append(index[e.name])

    E = len(rows)
    n = max((len(r) for r in rows), default=0)
    u = np.zeros((E, n), np.float32)
    lengths = np.zeros((E,), np.int32)
    for i, r in enumerate(rows):
        u[i, :len(r)] = r
        lengths[i] = len(r)
    return PackedEvents(u=u, lengths=lengths,
                        rates=np.asarray(rates, np.float64),
                        fn_ids=np.asarray(fn_ids, np.int32), names=names)
