"""Central collector endpoint (DESIGN.md §8).

``DaemonServer`` owns the listening socket (Unix-domain by default, TCP
when given a (host, port) address), multiplexes every per-worker daemon
connection through one ``selectors`` IO thread, reassembles frames with
``FrameDecoder``, and hands decoded messages to a ``WindowCollector``.

It is also the control plane: ``broadcast`` pushes ``window_start`` /
``stop`` frames to every connected daemon (the multi-process scenario
runner drives worker processes with it).

A plaintext event log (connections, window summaries, errors) goes to
``log_path`` when given — the CI ``wire`` job uploads it as an artifact on
failure, so a hung socket leaves evidence.
"""
from __future__ import annotations

import os
import selectors
import socket
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.transport import framing
from repro_torch.transport.collector import WindowCollector

Address = Union[str, Tuple[str, int]]


class _Conn:
    def __init__(self, sock: socket.socket, max_frame: Optional[int] = None):
        self.sock = sock
        self.decoder = framing.FrameDecoder(max_frame=max_frame)
        self.outbuf = bytearray()
        self.worker: Optional[int] = None    # set by the hello frame
        self.authed = False                  # hello accepted (token checked)
        self.registered = selectors.EVENT_READ   # current epoll interest set


class DaemonServer:
    """Accepts per-worker daemon connections and feeds the collector.

    ``auth_token`` (optional shared secret) gates the hello handshake:
    a connection whose hello carries a missing or mismatched token is
    logged and closed before any of its frames reach the collector.

    The set of client->server frame types forwarded to the collector is
    the collector's ``HANDLED`` attribute (default: upload/window_end),
    so the same server fronts both flat ``WindowCollector``s and the
    root ``ShardCollector`` of a collector tree (DESIGN.md §10).
    """

    def __init__(self, collector: WindowCollector,
                 address: Optional[Address] = None,
                 log_path: Optional[str] = None,
                 auth_token: Optional[str] = None,
                 max_frame: Optional[int] = None):
        self.collector = collector
        self.log_path = log_path
        self.auth_token = auth_token
        self.max_frame = max_frame
        self.auth_rejected = 0               # connections refused at hello
        self._log_lock = threading.Lock()
        self._owns_socket_dir: Optional[str] = None
        if address is None:
            self._owns_socket_dir = tempfile.mkdtemp(prefix="repro-wire-")
            address = os.path.join(self._owns_socket_dir, "daemon.sock")
        self.address: Address = address
        if isinstance(address, str):
            self._listener = socket.socket(socket.AF_UNIX,
                                           socket.SOCK_STREAM)
            self._listener.bind(address)
        else:
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind(tuple(address))
            self.address = self._listener.getsockname()
        self._listener.listen(1024)
        self._listener.setblocking(False)
        self._wake_r, self._wake_w = os.pipe()
        self._conns: Dict[int, _Conn] = {}          # fd -> conn
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "DaemonServer":
        self.log(f"listening on {self.address}")
        self._thread = threading.Thread(target=self._run,
                                        name="wire-server", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._notify()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            try:
                c.sock.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass
        if self._owns_socket_dir:
            try:
                os.unlink(self.address)          # type: ignore[arg-type]
                os.rmdir(self._owns_socket_dir)
            except OSError:
                pass
        self.log("stopped")

    def __enter__(self) -> "DaemonServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- control plane -------------------------------------------------------
    @property
    def n_connections(self) -> int:
        with self._lock:
            return len(self._conns)

    def connected_workers(self) -> List[int]:
        with self._lock:
            return sorted(c.worker for c in self._conns.values()
                          if c.worker is not None)

    def wait_connections(self, n: int, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.n_connections >= n:
                return True
            time.sleep(0.01)
        return self.n_connections >= n

    def broadcast(self, msg: Dict) -> int:
        """Queue one control frame to every connected daemon; returns the
        number of recipients."""
        frame = framing.encode_frame(msg, max_frame=self.max_frame)
        with self._lock:
            for conn in self._conns.values():
                conn.outbuf += frame
            n = len(self._conns)
        self._notify()
        return n

    def log(self, line: str) -> None:
        if not self.log_path:
            return
        with self._log_lock:
            with open(self.log_path, "a") as f:
                f.write(f"[{time.strftime('%H:%M:%S')}] {line}\n")

    # -- IO loop -------------------------------------------------------------
    def _notify(self) -> None:
        try:
            os.write(self._wake_w, b"\0")
        except OSError:
            pass

    def _run(self) -> None:
        sel = selectors.DefaultSelector()
        sel.register(self._listener, selectors.EVENT_READ, "accept")
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        try:
            while not self._stop.is_set():
                # only touch connections whose interest set actually
                # changed — at W=1024 a blanket sel.modify sweep is O(W)
                # epoll_ctl syscalls per wakeup and dominates the loop
                with self._lock:
                    for fd, conn in self._conns.items():
                        want = selectors.EVENT_READ | (
                            selectors.EVENT_WRITE if conn.outbuf else 0)
                        if want != conn.registered:
                            sel.modify(conn.sock, want, "conn")
                            conn.registered = want
                for key, events in sel.select(timeout=0.2):
                    if key.data == "wake":
                        try:
                            os.read(self._wake_r, 4096)
                        except OSError:
                            pass
                    elif key.data == "accept":
                        self._accept(sel)
                    else:
                        self._service(sel, key.fileobj, events)
        except Exception as e:                       # pragma: no cover
            self.log(f"server loop error: {type(e).__name__}: {e}")
        finally:
            sel.close()

    def _accept(self, sel) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            conn = _Conn(sock, max_frame=self.max_frame)
            with self._lock:
                self._conns[sock.fileno()] = conn
            sel.register(sock, selectors.EVENT_READ, "conn")
            self.log(f"accepted connection fd={sock.fileno()}")

    def _close_conn(self, sel, sock) -> None:
        with self._lock:
            conn = self._conns.pop(sock.fileno(), None)
        try:
            sel.unregister(sock)
        except (KeyError, ValueError):
            pass
        try:
            sock.close()
        except OSError:
            pass
        if conn is not None:
            self.log(f"closed connection worker={conn.worker}")

    def _service(self, sel, sock, events) -> None:
        with self._lock:
            conn = self._conns.get(sock.fileno())
        if conn is None:
            return
        if events & selectors.EVENT_READ:
            try:
                data = sock.recv(1 << 20)
            except BlockingIOError:
                data = None
            except OSError as e:
                self.log(f"recv error worker={conn.worker}: {e}")
                self._close_conn(sel, sock)
                return
            if data == b"":
                self._close_conn(sel, sock)
                return
            if data:
                try:
                    for msg in conn.decoder.feed(data):
                        if not self._dispatch(conn, msg):
                            self._close_conn(sel, sock)
                            return
                except ValueError as e:
                    self.log(f"framing error worker={conn.worker}: {e}")
                    self._close_conn(sel, sock)
                    return
        if events & selectors.EVENT_WRITE:
            # snapshot under the lock: broadcast() appends to outbuf from
            # other threads, and resizing a bytearray while send() exports
            # its buffer raises BufferError
            with self._lock:
                data = bytes(conn.outbuf)
            if not data:
                return
            try:
                n = sock.send(data)
                with self._lock:
                    del conn.outbuf[:n]
            except BlockingIOError:
                pass
            except OSError as e:
                self.log(f"send error worker={conn.worker}: {e}")
                self._close_conn(sel, sock)

    def _dispatch(self, conn: _Conn, msg: Dict) -> bool:
        """Handle one decoded frame; False closes the connection."""
        t = msg.get("t")
        if t == "hello":
            if self.auth_token is not None \
                    and msg.get("token") != self.auth_token:
                self.auth_rejected += 1
                self.log(f"auth rejected worker={msg.get('worker')} "
                         f"(missing or mismatched token)")
                return False
            conn.worker = int(msg["worker"])
            conn.authed = True
            role = msg.get("role", "worker")
            self.log(f"hello worker={conn.worker} role={role}")
            return True
        if self.auth_token is not None and not conn.authed:
            # nothing but a valid hello may precede authenticated traffic
            self.auth_rejected += 1
            self.log(f"auth rejected: {t!r} frame before hello")
            return False
        handled = getattr(self.collector, "HANDLED", ("upload", "window_end"))
        if t in handled:
            if t == "window_end":
                self.log(f"window_end window={msg.get('window')} "
                         f"worker={msg.get('worker')} "
                         f"sent={msg.get('sent')} "
                         f"dropped={msg.get('dropped')}")
            self.collector.on_message(msg)
        elif t == "bye":
            self.log(f"bye worker={msg.get('worker')}")
        else:
            self.log(f"unknown frame type {t!r} from worker={conn.worker}")
        return True
