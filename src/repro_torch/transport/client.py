"""Per-worker upload client (DESIGN.md §8).

``WireClient`` is the daemon side of the wire: it owns one socket to the
``DaemonServer``, a *bounded* send queue, and a background sender thread,
so the training/daemon thread never blocks on a slow collector.

Backpressure policy: the queue bounds the number of UNSENT upload frames.
When a new upload arrives at a full queue, the OLDEST unsent upload is
dropped and counted — stale windows are worth strictly less than fresh
ones (the collector tolerates the hole; the EMA keeps the worker's last
evidence), so the newest window always gets a seat.  Control frames
(``hello``/``window_end``/``bye``) are never dropped: loss accounting and
window assembly ride on them.

Reconnect policy: a lost connection (collector restart, transient accept
failure) is re-dialed with bounded exponential backoff.  A successful
reconnect re-sends the hello (with the auth token, when configured),
discards the torn half-sent frame, and resumes draining the queue; the
``reconnects`` counter rides every subsequent ``window_end`` so the
collector's transport accounting surfaces it in reports.

Loss/reorder injection for tests happens at the framing layer: a
``frame_filter(msg, frame) -> [frames]`` hook sees every encoded upload
frame and may drop it (``[]``), duplicate it (``[frame, frame]``), or pass
it through (``None`` / ``[frame]``).  Control frames bypass the filter,
exactly like the drop policy.
"""
from __future__ import annotations

import os
import queue as _queue
import selectors
import socket
import threading
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

from repro_torch.transport import framing

Address = Union[str, Tuple[str, int]]

#: frame_filter signature: (decoded msg, encoded frame) -> frames to send
FrameFilter = Callable[[Dict, bytes], Optional[Iterable[bytes]]]


def connect(address: Address, timeout: float = 10.0) -> socket.socket:
    """Dial a ``DaemonServer``: a str address is a Unix-domain socket path,
    a (host, port) tuple is TCP."""
    if isinstance(address, str):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    else:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(timeout)
    try:
        sock.connect(address if isinstance(address, str) else tuple(address))
    except BaseException:
        sock.close()
        raise
    sock.settimeout(None)
    return sock


class SendQueue:
    """Bounded FIFO of protocol messages with drop-oldest overflow.

    Only *droppable* entries (uploads) count toward — and are evicted by —
    the bound; control frames always enqueue.  Thread-safe.
    """

    def __init__(self, max_uploads: int = 64):
        if max_uploads < 1:
            raise ValueError(f"max_uploads must be >= 1, got {max_uploads}")
        self.max_uploads = int(max_uploads)
        self._q: deque = deque()              # (droppable, msg)
        self._n_droppable = 0
        self.dropped = 0                      # cumulative drop-oldest count
        self._lock = threading.Lock()

    def put(self, msg: Dict, droppable: bool = True) -> None:
        with self._lock:
            if droppable and self._n_droppable >= self.max_uploads:
                # evict the OLDEST unsent upload (never a control frame)
                for i, (d, _m) in enumerate(self._q):
                    if d:
                        del self._q[i]
                        self._n_droppable -= 1
                        self.dropped += 1
                        break
            self._q.append((droppable, msg))
            if droppable:
                self._n_droppable += 1

    def pop(self) -> Optional[Tuple[bool, Dict]]:
        with self._lock:
            if not self._q:
                return None
            droppable, msg = self._q.popleft()
            if droppable:
                self._n_droppable -= 1
            return droppable, msg

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class WireClient:
    """One worker's (or leaf uplink's) connection to a collector."""

    def __init__(self, address: Address, worker: int,
                 max_queue: int = 64,
                 frame_filter: Optional[FrameFilter] = None,
                 connect_timeout: float = 10.0,
                 auth_token: Optional[str] = None,
                 role: str = "worker",
                 max_frame: Optional[int] = None,
                 reconnect_max: int = 5,
                 reconnect_backoff_s: float = 0.05,
                 reconnect_backoff_max_s: float = 1.0):
        self.address = address
        self.worker = int(worker)
        self.frame_filter = frame_filter
        self.auth_token = auth_token
        self.role = role
        self.max_frame = max_frame
        self.queue = SendQueue(max_uploads=max_queue)
        self.sent = 0                       # upload frames handed to the OS
        self.enqueued = 0                   # upload frames accepted
        self.reconnects = 0                 # successful re-dials
        self.reconnect_max = int(reconnect_max)
        self.reconnect_backoff_s = float(reconnect_backoff_s)
        self.reconnect_backoff_max_s = float(reconnect_backoff_max_s)
        self.errors: List[str] = []
        self._seq = 0
        self._connect_timeout = float(connect_timeout)
        self._controls: "_queue.Queue[Dict]" = _queue.Queue()
        self._sock = connect(address, timeout=connect_timeout)
        self._sock.setblocking(False)
        self._wake_r, self._wake_w = os.pipe()
        self._outbuf = bytearray()
        self._decoder = framing.FrameDecoder(max_frame=max_frame)
        self._stop = threading.Event()
        self._idle = threading.Event()      # set while queue+outbuf empty
        self._idle.set()
        self.queue.put(self._hello(), droppable=False)
        self._thread = threading.Thread(
            target=self._run, name=f"wire-client-{worker}", daemon=True)
        self._thread.start()

    def _hello(self) -> Dict:
        return framing.hello_msg(self.worker, token=self.auth_token,
                                 role=self.role)

    # -- daemon-facing API --------------------------------------------------
    @property
    def dropped(self) -> int:
        """Cumulative uploads evicted by backpressure (drop-oldest)."""
        return self.queue.dropped

    def send_upload(self, window: int, upload) -> int:
        """Enqueue one window's pattern upload; returns its seq number.
        Never blocks: a full queue evicts the oldest unsent upload."""
        seq = self._seq
        self._seq += 1
        self.enqueued += 1
        self.queue.put(framing.upload_msg(window, upload, seq))
        self._notify()
        return seq

    def send_msg(self, msg: Dict, droppable: bool = False) -> None:
        """Enqueue one pre-built protocol message (leaf uplinks forward
        compacted shard frames with this; shard frames are control-grade:
        never dropped by backpressure)."""
        self.queue.put(msg, droppable=droppable)
        self._notify()

    def end_window(self, window: int) -> None:
        """Close one window on the wire.  The frame's counters are
        snapshotted at SEND time (sender thread), so drops that happen
        while it is queued are still reported."""
        self.queue.put({"t": "_window_end", "window": int(window)},
                       droppable=False)
        self._notify()

    def recv_control(self, timeout: Optional[float] = None) -> Optional[Dict]:
        """Next server->client control frame (window_start/stop), or None
        on timeout."""
        try:
            return self._controls.get(timeout=timeout)
        except _queue.Empty:
            return None

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every queued frame reached the OS (or timeout).
        Returns False when frames remain undelivered — timeout, or a
        sender thread that died mid-drain (its exit sets the idle event
        to wake waiters, so the verdict comes from the actual queue and
        buffer state, never from the event alone)."""
        if self._thread.is_alive():
            self._idle.wait(timeout=timeout)
        return len(self.queue) == 0 and not self._outbuf

    def close(self, timeout: float = 10.0) -> None:
        if not self._stop.is_set() and self._thread.is_alive():
            self.queue.put(framing.bye_msg(self.worker), droppable=False)
            self._notify()
            self.flush(timeout=timeout)
        self._stop.set()
        self._notify()
        self._thread.join(timeout=timeout)
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass

    # -- sender/receiver loop ------------------------------------------------
    def _notify(self) -> None:
        self._idle.clear()
        try:
            os.write(self._wake_w, b"\0")
        except OSError:
            pass

    def _encode_next(self) -> None:
        """Drain queued messages into the outbuf, applying the framing-layer
        fault filter to upload frames."""
        while len(self._outbuf) < 1 << 20:
            item = self.queue.pop()
            if item is None:
                return
            droppable, msg = item
            if msg.get("t") == "_window_end":
                msg = framing.window_end_msg(
                    msg["window"], self.worker,
                    sent=self.sent, dropped=self.queue.dropped,
                    reconnects=self.reconnects)
            frame = framing.encode_frame(msg, max_frame=self.max_frame)
            if droppable:
                self.sent += 1
                if self.frame_filter is not None:
                    frames = self.frame_filter(msg, frame)
                    frames = [frame] if frames is None else list(frames)
                else:
                    frames = [frame]
                for f in frames:
                    self._outbuf += f
            else:
                self._outbuf += frame

    def _reconnect(self, sel: selectors.BaseSelector) -> bool:
        """Bounded-exponential-backoff re-dial after a lost connection.
        On success: fresh socket registered, decoder reset, torn outbuf
        replaced by a new hello.  Returns False when out of attempts or
        stopping — the caller exits the sender loop."""
        try:
            sel.unregister(self._sock)
        except (KeyError, ValueError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        delay = self.reconnect_backoff_s
        for attempt in range(self.reconnect_max):
            if self._stop.is_set():
                return False
            self._stop.wait(delay)
            delay = min(2 * delay, self.reconnect_backoff_max_s)
            if self._stop.is_set():
                return False
            try:
                self._sock = connect(self.address,
                                     timeout=self._connect_timeout)
            except OSError:
                continue
            self._sock.setblocking(False)
            self._decoder = framing.FrameDecoder(max_frame=self.max_frame)
            # the half-sent frame is torn — restarting it would corrupt the
            # stream; re-introduce ourselves instead and resume the queue
            self._outbuf = bytearray(
                framing.encode_frame(self._hello(),
                                     max_frame=self.max_frame))
            self.reconnects += 1
            sel.register(self._sock, selectors.EVENT_READ
                         | selectors.EVENT_WRITE)
            return True
        self.errors.append(
            f"reconnect failed after {self.reconnect_max} attempts")
        return False

    def _run(self) -> None:
        sel = selectors.DefaultSelector()
        sel.register(self._sock, selectors.EVENT_READ)
        sel.register(self._wake_r, selectors.EVENT_READ)
        registered = selectors.EVENT_READ
        try:
            while not self._stop.is_set():
                if not self._outbuf:
                    self._encode_next()
                want = selectors.EVENT_READ | (
                    selectors.EVENT_WRITE if self._outbuf else 0)
                if want != registered:
                    sel.modify(self._sock, want)
                    registered = want
                if not self._outbuf and not len(self.queue):
                    self._idle.set()
                    if len(self.queue):   # raced with a concurrent put
                        self._idle.clear()
                lost = False
                for key, events in sel.select(timeout=0.2):
                    if key.fd == self._wake_r:
                        try:
                            os.read(self._wake_r, 4096)
                        except OSError:
                            pass
                        continue
                    if events & selectors.EVENT_READ:
                        if not self._read():
                            lost = True
                            break
                    if events & selectors.EVENT_WRITE and self._outbuf:
                        if not self._write():
                            lost = True
                            break
                if lost:
                    if self._stop.is_set() or not self._reconnect(sel):
                        return
                    registered = selectors.EVENT_READ \
                        | selectors.EVENT_WRITE
        except Exception as e:                      # pragma: no cover
            self.errors.append(f"{type(e).__name__}: {e}")
        finally:
            self._idle.set()
            sel.close()

    def _read(self) -> bool:
        try:
            data = self._sock.recv(65536)
        except BlockingIOError:
            return True
        except OSError as e:
            self.errors.append(f"recv: {e}")
            return False
        if not data:
            self.errors.append("server closed connection")
            return False
        for msg in self._decoder.feed(data):
            self._controls.put(msg)
        return True

    def _write(self) -> bool:
        try:
            n = self._sock.send(self._outbuf)
        except BlockingIOError:
            return True
        except OSError as e:
            self.errors.append(f"send: {e}")
            return False
        del self._outbuf[:n]
        return True
