"""Two-tier collector tree (DESIGN.md §10).

One flat ``DaemonServer`` stops scaling around the point where a single
accept loop must decode 2xW frames per window.  The tree splits the fleet
into N "rack" slices, each fronted by a ``LeafNode`` — its own selectors
loop + ``WindowCollector`` assembling just that slice — and a root that
only ever sees N compacted *shard frames* per window:

    workers ──upload/window_end──> LeafNode ──shard──> root ShardCollector
    workers <──window_start/stop── LeafNode <──window_start/stop── root

Hierarchical partial-window assembly: a leaf waits for its slice (same
partial-window semantics as the flat collector — missing workers bounded
by the leaf timeout), folds the slice's uploads into a leaf-local
``PatternAggregator``, and ships ONE frame upstream: the packed columnar
float32 block, the present worker list, interned names/kinds, and the
rack's loss counters.  The root scatters each block straight into the
fleet-wide aggregator (``scatter_cols``) — root ingest is O(shards)
frames per window instead of O(workers), and the expensive msgpack
unpacking runs in parallel across the leaves.

Byte-parity with the flat path is preserved by construction: shard blocks
are scattered in ascending shard-id order (shards are contiguous
ascending worker ranges), so function interning and first-seen kind
resolution happen in exactly the ascending-worker order the flat
``aggregate_batch`` uses, and the float32 pattern values cross the wire
verbatim.

Control plane: ``CollectorTree.broadcast`` pushes ``window_start`` /
``stop`` frames to the leaves' uplink connections; each leaf applies the
membership delta to its own collector's expected set (its rack ∩ the
current training mesh) and re-broadcasts the frame to its rack, so mesh
changes (``replace_hosts`` re-mesh, scenario cures) flow down the tree to
every worker process.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.events import Kind
from repro_torch.summarize.aggregate import PatternAggregator
from repro_torch.transport import framing
from repro_torch.transport.client import WireClient
from repro_torch.transport.collector import WindowBatch, WindowCollector
from repro_torch.transport.server import DaemonServer


def compact_shard(shard: int, batch: WindowBatch) -> Dict:
    """Fold one assembled rack window into a single shard frame.

    The rack's uploads are unpacked into a leaf-local aggregator in
    ascending worker order (the parity-critical order), then shipped as a
    packed little-endian float32 ``(n_present, F, 3)`` block plus the
    interned names/kinds — the root never touches the rack's msgpack."""
    uploads = batch.sorted_uploads()
    agg = PatternAggregator(expected_workers=max(1, len(uploads)))
    base = agg.reserve_workers(len(uploads))
    for i, u in enumerate(uploads):
        agg.add_upload_at(u, base + i)
    mat, names = agg.matrix()
    kinds = agg.kinds()
    rows = np.ascontiguousarray(mat, dtype="<f4").tobytes()
    return framing.shard_msg(
        window=batch.window, shard=shard,
        workers=batch.present, names=names,
        kinds=[int(kinds[n].value) for n in names], rows=rows,
        missing=batch.missing, duplicates=batch.duplicates,
        client_dropped=batch.client_dropped, reconnects=batch.reconnects,
        raw_bytes=sum(u.raw_bytes for u in uploads),
        pattern_bytes=sum(len(u.payload) for u in uploads),
        summarize_s=sum(u.summarize_s for u in uploads),
        timed_out=batch.timed_out)


@dataclass
class TreeWindowBatch:
    """One fleet window assembled from per-shard compaction frames.

    Quacks like ``WindowBatch`` where diagnosis needs it (present /
    missing / present_mask / stats) but aggregates by scattering shard
    blocks instead of unpacking per-worker uploads — ``aggregate()`` is
    the tree-mode replacement for ``aggregate_batch``."""
    window: int
    expected: Tuple[int, ...]                 # fleet-level expected workers
    expected_shards: Tuple[int, ...]
    shards: Dict[int, Dict] = field(default_factory=dict)  # shard id -> msg
    duplicate_shards: int = 0                 # deduped shard frames
    timed_out: bool = False                   # root wait hit its deadline

    @property
    def present(self) -> List[int]:
        out: List[int] = []
        for s in sorted(self.shards):
            out.extend(self.shards[s]["workers"])
        return sorted(out)

    @property
    def missing(self) -> List[int]:
        return sorted(set(self.expected) - set(self.present))

    @property
    def missing_shards(self) -> List[int]:
        return sorted(set(self.expected_shards) - set(self.shards))

    @property
    def complete(self) -> bool:
        return not self.missing

    def _sum(self, key: str) -> int:
        return sum(m[key] for m in self.shards.values())

    @property
    def duplicates(self) -> int:
        return self._sum("duplicates")

    @property
    def client_dropped(self) -> int:
        return self._sum("client_dropped")

    @property
    def reconnects(self) -> int:
        return self._sum("reconnects")

    @property
    def raw_bytes(self) -> int:
        return self._sum("raw_bytes")

    @property
    def pattern_bytes(self) -> int:
        return self._sum("pattern_bytes")

    @property
    def summarize_s(self) -> float:
        return sum(m["summarize_s"] for m in self.shards.values())

    def present_mask(self, fleet_size: int) -> np.ndarray:
        mask = np.zeros(int(fleet_size), bool)
        mask[self.present] = True
        return mask

    def stats(self) -> Dict[str, object]:
        """WindowBatch-compatible transport counters + tree shape."""
        return {"window": self.window,
                "expected": len(self.expected),
                "present": len(self.present),
                "missing": self.missing,
                "duplicates": self.duplicates,
                "client_dropped": self.client_dropped,
                "reconnects": self.reconnects,
                "timed_out": self.timed_out,
                "shards": len(self.shards),
                "expected_shards": len(self.expected_shards),
                "missing_shards": self.missing_shards,
                "duplicate_shards": self.duplicate_shards}

    def aggregate(self, fleet_size: int
                  ) -> Tuple[PatternAggregator, np.ndarray]:
        """Scatter every shard block into one full-width aggregator.

        Ascending shard-id order == ascending worker order (shards are
        contiguous slices), so interning and first-seen kinds match the
        flat ``aggregate_batch`` exactly; absent rows stay zero and are
        masked out of localization."""
        agg = PatternAggregator(expected_workers=max(1, int(fleet_size)))
        agg.reserve_workers(int(fleet_size))
        present = np.zeros(int(fleet_size), bool)
        for s in sorted(self.shards):
            m = self.shards[s]
            names = m["names"]
            cols = np.array([agg.intern(n, Kind(k))
                             for n, k in zip(names, m["kinds"])], np.int64)
            rows = np.array(m["workers"], np.int64)
            if rows.size:
                present[rows] = True
                if cols.size:
                    block = np.frombuffer(m["rows"], dtype="<f4").reshape(
                        len(rows), len(names), 3)
                    agg.scatter_cols(rows, cols, block)
        return agg, present


class ShardCollector:
    """Root-side reassembly of per-shard compaction frames.

    Same contract as ``WindowCollector`` (on_message from the server's IO
    thread, wait_window from the consumer) but keyed by shard id: a window
    is complete when every expected SHARD reported, duplicate shard frames
    keep the first copy, and a whole missing rack is bounded by the
    wait_window timeout and surfaced in ``missing_shards``."""

    HANDLED = ("shard",)                     # frame types the server forwards

    def __init__(self, shard_workers: Dict[int, Sequence[int]]):
        #: static rack topology: shard id -> full worker slice
        self.shard_workers = {int(s): tuple(sorted(int(w) for w in ws))
                              for s, ws in shard_workers.items()}
        self.expected_shards = tuple(sorted(self.shard_workers))
        #: current training mesh (None = everyone in the topology)
        self._membership: Optional[Set[int]] = None
        self._batches: Dict[int, TreeWindowBatch] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._popped_through: float = float("-inf")
        self.total_shards = 0
        self.total_duplicate_shards = 0
        self.stale_frames = 0

    def _expected_workers(self) -> Tuple[int, ...]:
        all_ws = [w for ws in self.shard_workers.values() for w in ws]
        if self._membership is None:
            return tuple(sorted(all_ws))
        return tuple(sorted(set(all_ws) & self._membership))

    def set_membership(self, workers: Sequence[int]) -> None:
        """Control-plane mesh delta: expected workers become the rack
        topology ∩ the current training mesh (open windows included)."""
        with self._cv:
            self._membership = {int(w) for w in workers}
            exp = self._expected_workers()
            for b in self._batches.values():
                b.expected = exp
            self._cv.notify_all()

    def _batch(self, window: int) -> TreeWindowBatch:
        b = self._batches.get(window)
        if b is None:
            b = self._batches[window] = TreeWindowBatch(
                window=window, expected=self._expected_workers(),
                expected_shards=self.expected_shards)
        return b

    def on_message(self, msg: Dict) -> None:
        if msg.get("t") != "shard":
            return
        window, shard = int(msg["window"]), int(msg["shard"])
        with self._cv:
            if window <= self._popped_through:
                self.stale_frames += 1
                return
            b = self._batch(window)
            if shard in b.shards:
                b.duplicate_shards += 1
                self.total_duplicate_shards += 1
                return
            b.shards[shard] = msg
            self.total_shards += 1
            if set(b.shards) >= set(self.expected_shards):
                self._cv.notify_all()

    def wait_window(self, window: int, timeout: float = 30.0
                    ) -> TreeWindowBatch:
        """Block until every expected shard reported ``window`` (or
        timeout); the batch is partial when racks are missing."""
        import time as _time
        deadline = _time.monotonic() + timeout
        with self._cv:
            while True:
                b = self._batch(window)
                if set(b.shards) >= set(self.expected_shards):
                    break
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    b.timed_out = True
                    break
                self._cv.wait(timeout=min(remaining, 0.5))
            self._batches.pop(window, None)
            self._popped_through = max(self._popped_through, window)
            return b


class LeafNode:
    """One rack: a ``DaemonServer`` + ``WindowCollector`` for a worker
    slice, plus an uplink ``WireClient`` (role="leaf") to the root.

    The pump thread is driven entirely by the control plane: each
    ``window_start`` from the root is re-broadcast to the rack, the leaf
    assembles its slice (expected = rack ∩ membership), compacts it, and
    forwards one shard frame upstream.  ``stop`` is re-broadcast and ends
    the pump."""

    def __init__(self, shard: int, workers: Sequence[int],
                 root_address, auth_token: Optional[str] = None,
                 max_frame: Optional[int] = None,
                 window_timeout: float = 30.0,
                 log_path: Optional[str] = None,
                 address=None):
        self.shard = int(shard)
        self.workers = tuple(sorted(int(w) for w in workers))
        self.window_timeout = float(window_timeout)
        self.collector = WindowCollector(self.workers)
        self.server = DaemonServer(self.collector, address=address,
                                   auth_token=auth_token,
                                   max_frame=max_frame, log_path=log_path)
        self.uplink = WireClient(root_address, worker=self.shard,
                                 auth_token=auth_token, role="leaf",
                                 max_frame=max_frame)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        return self.server.address

    def start(self) -> "LeafNode":
        self.server.start()
        self._thread = threading.Thread(
            target=self._pump, name=f"leaf-{self.shard}", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self.uplink.close()
        self.server.stop()

    def _pump(self) -> None:
        while not self._stop.is_set():
            msg = self.uplink.recv_control(timeout=0.5)
            if msg is None:
                continue
            t = msg.get("t")
            if t == "stop" or (t == "window_start" and msg.get("stop")):
                self.server.broadcast(msg)
                return
            if t != "window_start":
                self.server.broadcast(msg)
                continue
            members = msg.get("membership")
            if members is not None:
                mine = sorted(set(self.workers) & {int(w) for w in members})
                self.collector.set_expected(mine)
            self.server.broadcast(msg)
            window = int(msg["window"])
            batch = self.collector.wait_window(
                window, timeout=self.window_timeout)
            self.uplink.send_msg(compact_shard(self.shard, batch),
                                 droppable=False)


def leaf_process_main(shard: int, workers: Sequence[int], root_address,
                      address, auth_token: Optional[str] = None,
                      max_frame: Optional[int] = None,
                      window_timeout: float = 30.0,
                      log_path: Optional[str] = None) -> None:
    """Entry point for one ``LeafNode`` as a STANDALONE process — the
    deployed shape, where each rack's collector runs on its own host and
    the root only ever pays for O(shards) frames per window.  ``address``
    must be a pre-agreed socket path/endpoint so workers can dial the leaf
    without a discovery round-trip.  Runs until the root broadcasts
    ``stop`` (picklable args only: multiprocessing spawn target)."""
    leaf = LeafNode(shard, workers, root_address, auth_token=auth_token,
                    max_frame=max_frame, window_timeout=window_timeout,
                    log_path=log_path, address=address).start()
    try:
        if leaf._thread is not None:
            leaf._thread.join()              # pump exits on the stop frame
    finally:
        leaf.uplink.close()
        leaf.server.stop()


class CollectorTree:
    """The assembled tree: N leaves over contiguous worker slices + the
    root ``DaemonServer``/``ShardCollector`` pair.

    Drop-in for the flat (collector, server) pair in scenario drivers:
    ``broadcast`` pushes control frames down the tree, ``wait_window``
    returns a ``TreeWindowBatch``, and ``address_of(worker)`` tells each
    worker process which LEAF to dial."""

    def __init__(self, workers: Sequence[int], n_shards: int,
                 auth_token: Optional[str] = None,
                 max_frame: Optional[int] = None,
                 window_timeout: float = 30.0,
                 log_path: Optional[str] = None):
        ws = sorted(int(w) for w in workers)
        n_shards = int(n_shards)
        if not 1 <= n_shards <= max(1, len(ws)):
            raise ValueError(f"n_shards={n_shards} must be in "
                             f"[1, {max(1, len(ws))}] for {len(ws)} workers")
        slices = [list(map(int, s)) for s in np.array_split(ws, n_shards)]
        self.shard_workers = {s: tuple(sl) for s, sl in enumerate(slices)}
        self.collector = ShardCollector(self.shard_workers)
        self.root = DaemonServer(self.collector, auth_token=auth_token,
                                 max_frame=max_frame, log_path=log_path)
        self._leaf_args = dict(auth_token=auth_token, max_frame=max_frame,
                               window_timeout=window_timeout,
                               log_path=log_path)
        self.leaves: List[LeafNode] = []
        self._addr_of: Dict[int, object] = {}

    @property
    def address(self):
        return self.root.address

    @property
    def n_shards(self) -> int:
        return len(self.shard_workers)

    def address_of(self, worker: int):
        """The LEAF address worker ``worker``'s daemon should dial."""
        return self._addr_of[int(worker)]

    def start(self) -> "CollectorTree":
        self.root.start()
        for s, ws in self.shard_workers.items():
            leaf = LeafNode(s, ws, self.root.address,
                            **self._leaf_args).start()
            self.leaves.append(leaf)
            for w in ws:
                self._addr_of[w] = leaf.address
        # every leaf uplink must be connected before the first broadcast,
        # or early window_start frames miss racks entirely
        self.root.wait_connections(len(self.leaves))
        return self

    def stop(self, timeout: float = 10.0) -> None:
        for leaf in self.leaves:
            leaf.stop(timeout=timeout)
        self.root.stop()

    def __enter__(self) -> "CollectorTree":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def wait_connections(self, n: int, timeout: float = 30.0) -> bool:
        """Block until ``n`` WORKER connections exist across the leaves."""
        import time as _time
        deadline = _time.monotonic() + timeout
        while True:
            total = sum(leaf.server.n_connections for leaf in self.leaves)
            if total >= n or _time.monotonic() >= deadline:
                return total >= n
            _time.sleep(0.01)

    def set_membership(self, workers: Sequence[int]) -> None:
        """Re-key the ROOT's expected set immediately (leaves re-key their
        own slices from the membership field of the next broadcast)."""
        self.collector.set_membership(workers)

    def broadcast(self, msg: Dict) -> int:
        """Push one control frame to every leaf (leaves forward it to
        their racks); returns the number of leaves reached."""
        if msg.get("t") == "window_start" and "membership" in msg:
            self.collector.set_membership(msg["membership"])
        return self.root.broadcast(msg)

    def wait_window(self, window: int, timeout: float = 30.0
                    ) -> TreeWindowBatch:
        return self.collector.wait_window(window, timeout=timeout)
