"""Single-host loopback wiring (DESIGN.md §8).

``LoopbackWire`` stands up a real ``DaemonServer`` + ``WindowCollector``
on a Unix-domain socket and round-trips per-worker uploads through actual
``WireClient`` connections — the same framing, backpressure, and
partial-window machinery the distributed deployment uses, in one process.
``PerfTrackerService.diagnose_profiles(mode="wire")`` runs on it, so the
wire path in every test and benchmark exercises the real transport instead
of an in-process msgpack round-trip.

Connections are chunked (``max_conns`` at a time) so a 512-worker
benchmark fleet doesn't hold 512 sockets open at once; the collector's
window assembly is indifferent to connection lifetime.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

from repro_torch.transport.client import FrameFilter, WireClient
from repro_torch.transport.collector import WindowBatch, WindowCollector
from repro_torch.transport.server import Address, DaemonServer


class LoopbackWire:
    """A server + collector pair for one fleet of worker ids."""

    def __init__(self, workers: Sequence[int],
                 address: Optional[Address] = None,
                 max_conns: int = 64,
                 frame_filter: Optional[FrameFilter] = None,
                 log_path: Optional[str] = None):
        self.workers = [int(w) for w in workers]
        self.max_conns = int(max_conns)
        self.frame_filter = frame_filter
        self.collector = WindowCollector(self.workers)
        self.server = DaemonServer(self.collector, address=address,
                                   log_path=log_path)

    def __enter__(self) -> "LoopbackWire":
        self.server.start()
        return self

    def __exit__(self, *exc) -> None:
        self.server.stop()

    def send_round(self, uploads: Iterable, window: int = 0,
                   timeout: float = 30.0) -> WindowBatch:
        """Push one window's uploads through real per-worker connections
        and assemble the (possibly partial) batch."""
        uploads = list(uploads)
        for lo in range(0, len(uploads), self.max_conns):
            chunk = uploads[lo:lo + self.max_conns]
            clients = [WireClient(self.server.address, u.worker,
                                  frame_filter=self.frame_filter)
                       for u in chunk]
            try:
                for c, u in zip(clients, chunk):
                    c.send_upload(window, u)
                    c.end_window(window)
                for c in clients:
                    c.flush(timeout=timeout)
            finally:
                for c in clients:
                    c.close(timeout=timeout)
        # workers with no upload at all still owe a window_end: report them
        # closed so the wait below keys on upload arrival, not liveness
        sent_workers = {u.worker for u in uploads}
        for w in self.workers:
            if w not in sent_workers:
                self.collector.on_message(
                    {"t": "window_end", "window": window, "worker": w,
                     "sent": 0, "dropped": 0})
        return self.collector.wait_window(window, timeout=timeout)
