"""Per-worker PerfTracker daemon (paper §4, Fig. 6; port of the reference's
``repro/core/daemon.py``): receives the raw profiling window from its
worker, summarizes runtime behavior patterns in a separate process/core (the
training thread is never blocked), and uploads only the ~KB pattern dict.

Summarization runs through the pluggable batched backend in
``repro_torch.summarize`` (DESIGN.md §3); pick one per call, or fleet-wide
via the ``REPRO_TORCH_SUMMARIZE_BACKEND`` env var.  ``PerfTrackerDaemon`` is
the deployed shape: summarize locally, ship the payload over the real wire
transport (``repro_torch.transport``, DESIGN.md §8) through a bounded
drop-oldest send queue, never stalling on a slow collector.

The payload is the reference's msgpack map, byte for byte (packed by
``repro_torch.transport.codec``).  Device policy: a daemon summarizes on
``device`` (``None`` means ``"cuda"``, kernel K1 by default) and raises
without a CUDA device unless the caller passes ``"cpu"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.events import Kind, WorkerProfile
from repro_torch.transport.codec import packb, unpackb


@dataclass
class PatternUpload:
    worker: int
    payload: bytes            # msgpack {name: (beta, mu, sigma, kind)}
    summarize_s: float
    raw_bytes: int

    def unpack(self) -> Tuple[Dict[str, np.ndarray], Dict[str, Kind]]:
        d = unpackb(self.payload)
        pats = {k: np.array(v[:3], np.float32) for k, v in d.items()}
        kinds = {k: Kind(v[3]) for k, v in d.items()}
        return pats, kinds


def summarize_and_upload(profile: WorkerProfile,
                         kind_of: Optional[Dict[str, Kind]] = None,
                         backend=None) -> PatternUpload:
    """Summarize one worker and build its upload. ``kind_of`` overrides flow
    through the single kind-resolution path in
    ``repro_torch.summarize.packing`` (stream routing AND the uploaded kind
    byte come from the same map)."""
    # late import: repro_torch.core <-> repro_torch.summarize would cycle
    from repro_torch.summarize.engine import summarize_profile
    t0 = time.perf_counter()
    pats, kinds = summarize_profile(profile, kind_of=kind_of, backend=backend)
    payload = packb({
        name: (p.beta, p.mu, p.sigma, int(kinds.get(name, Kind.PYTHON)))
        for name, p in pats.items()})
    return PatternUpload(worker=profile.worker, payload=payload,
                         summarize_s=time.perf_counter() - t0,
                         raw_bytes=profile.raw_size_bytes())


class PerfTrackerDaemon:
    """One worker's resident daemon: summarize each profiling window and
    ship the ~KB upload over the wire (DESIGN.md §8).

    The wire client's bounded queue is the backpressure valve: a slow or
    unreachable collector costs dropped (oldest-first) uploads, never a
    blocked training step.  ``end_window`` closes the window on the wire so
    the collector can assemble it without waiting on holes.  ``backend``
    (a name, an instance or None) resolves on ``device`` once, here.
    """

    def __init__(self, worker: int, address, backend=None,
                 max_queue: int = 64, frame_filter=None,
                 auth_token=None, max_frame=None, device=None):
        # late imports: the transport pulls its sockets and threads in only
        # when a daemon actually goes on the wire
        from repro_torch.core.service import resolve_device
        from repro_torch.summarize.engine import _resolve_backend
        from repro_torch.transport.client import WireClient
        self.worker = int(worker)
        self.device = resolve_device(device)
        self.backend = _resolve_backend(backend, self.device)
        self.client = WireClient(address, worker, max_queue=max_queue,
                                 frame_filter=frame_filter,
                                 auth_token=auth_token, max_frame=max_frame)

    def process_window(self, window: int, profile: WorkerProfile,
                       kind_of: Optional[Dict[str, Kind]] = None
                       ) -> PatternUpload:
        """Summarize one raw window, enqueue its upload, close the window."""
        upload = summarize_and_upload(profile, kind_of, backend=self.backend)
        self.client.send_upload(window, upload)
        self.client.end_window(window)
        return upload

    def send_anchors(self, window: int, durations,
                     numerics=None, slo=None) -> None:
        """Ship a REAL workload's measured iteration durations for the
        window (control grade — the job-level detector stream is merged
        from these, so the frame is never dropped).  ``numerics``
        optionally carries the worker's per-iteration (loss, grad_norm)
        pairs for the numerics channel (DESIGN.md §12a) and ``slo`` the
        per-iteration (p99_ttft, p99_tbt) pairs for the serving SLO
        channel (§13); omitted, the frame is byte-identical to the
        historical format."""
        from repro_torch.transport import framing
        self.client.send_msg(framing.anchors_msg(window, self.worker,
                                                 durations,
                                                 numerics=numerics,
                                                 slo=slo),
                             droppable=False)

    def recv_control(self, timeout: Optional[float] = None):
        return self.client.recv_control(timeout=timeout)

    @property
    def dropped(self) -> int:
        return self.client.dropped

    def close(self) -> None:
        self.client.close()
