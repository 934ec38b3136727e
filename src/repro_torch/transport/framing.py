"""Wire framing for PerfTracker pattern uploads (DESIGN.md §8, §10; port of
the reference's ``repro/transport/framing.py``, byte for byte).

One frame = a 4-byte big-endian unsigned length prefix followed by exactly
that many bytes of msgpack (packed and unpacked by ``codec.py``, which
writes the bytes ``msgpack.packb(msg, use_bin_type=True)`` writes).
Length-prefixing (rather than delimiters) is what lets ~KB binary payloads
— the msgpack pattern dicts the daemon already produces — cross the socket
untouched, and what makes partial reads trivial to resume: a
``FrameDecoder`` buffers bytes from *any* recv boundary and yields only
complete frames.

Every frame body is a msgpack map with a ``"t"`` type tag:

  ``hello``        client -> server   {worker, role?, token?}
                   (``token`` is the optional shared-secret for an
                   authenticated collector; ``role`` distinguishes leaf
                   uplinks of a collector tree from worker daemons)
  ``upload``       client -> server   {window, worker, seq, payload,
                                       summarize_s, raw_bytes}
  ``window_end``   client -> server   {window, worker, sent, dropped,
                                       reconnects}
                   (cumulative counters; ``dropped`` is the client-side
                   backpressure drop count and ``reconnects`` the number
                   of times the client re-dialed the collector — loss
                   accounting rides on this frame, which is never dropped)
  ``anchors``      client -> server   {window, worker, durs, numerics?,
                   slo?} (a REAL workload's measured per-iteration
                   durations for the window — the parent merges them into
                   the job-level detector stream; control grade, never
                   dropped.  ``numerics`` optionally carries per-iteration
                   (loss, grad_norm) pairs for the numerics channel;
                   ``slo`` carries (p99_ttft, p99_tbt) pairs for the
                   serving latency-SLO channel)
  ``shard``        leaf -> root       one COMPACTED rack window: packed
                   columnar patterns (float32 rows), present workers,
                   missing/dup/drop counters (DESIGN.md §10)
  ``window_start`` server -> client   {window, rates | None, stop: False,
                                       membership?, plans?}
                   (``membership`` is the current training-mesh worker
                   set and ``plans`` the mitigation actions applied since
                   the previous window — the control-plane deltas worker
                   processes replay onto their own simulators)
  ``stop``         server -> client   {}
  ``bye``          client -> server   {worker}

The per-frame size cap rejects corrupt prefixes before they turn into a
multi-GB allocation.  Most frames are ~KB (paper Fig. 11), but the cap is
DERIVED from fleet size when known (``max_frame_bytes``): a ``window_start``
carries one rate per worker plus membership and mitigation deltas, and a
per-shard compaction frame carries a whole rack's columnar pattern block —
at W=1024+ those legitimately outgrow any fixed small bound.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.transport.codec import packb, unpackb

#: default per-frame cap when the fleet size is unknown (pattern uploads
#: are ~KB; this bound only exists to reject corrupt length prefixes)
MAX_FRAME_BYTES = 16 * 1024 * 1024

#: per-worker budget for fleet-shaped frames: a worker's share of a shard
#: frame (F functions x 3 float32 + interned names) plus its entries in
#: window_start rates/membership/plan deltas, with generous headroom
PER_WORKER_FRAME_BYTES = 16 * 1024

#: fleet-size-independent headroom (frame schema, names, counters)
FRAME_OVERHEAD_BYTES = 1024 * 1024


def max_frame_bytes(fleet_size: Optional[int] = None) -> int:
    """The per-frame size cap for a deployment of ``fleet_size`` workers.

    ``None`` (unknown fleet) keeps the fixed default; otherwise the cap
    grows linearly with the fleet so the legitimate big frames — a
    ``window_start`` carrying per-worker rates + membership + mitigation
    deltas, a per-shard columnar compaction frame — are never rejected at
    scale, while corrupt prefixes still die quickly."""
    if fleet_size is None:
        return MAX_FRAME_BYTES
    return max(MAX_FRAME_BYTES,
               FRAME_OVERHEAD_BYTES
               + PER_WORKER_FRAME_BYTES * int(fleet_size))


_LEN = struct.Struct(">I")


def encode_frame(msg: Dict, max_frame: Optional[int] = None) -> bytes:
    """Serialize one protocol message into a length-prefixed frame."""
    cap = MAX_FRAME_BYTES if max_frame is None else int(max_frame)
    body = packb(msg)
    if len(body) > cap:
        raise ValueError(f"frame body {len(body)}B exceeds "
                         f"max frame size {cap}B")
    return _LEN.pack(len(body)) + body


def decode_frames(data: bytes, max_frame: Optional[int] = None) -> List[Dict]:
    """Decode a byte string holding zero or more COMPLETE frames (tests /
    one-shot paths; streaming callers use ``FrameDecoder``)."""
    dec = FrameDecoder(max_frame=max_frame)
    out = list(dec.feed(data))
    if dec.pending_bytes:
        raise ValueError(f"{dec.pending_bytes} trailing bytes do not form "
                         "a complete frame")
    return out


class FrameDecoder:
    """Incremental frame reassembly over an arbitrary byte stream.

    ``feed`` accepts whatever one ``recv`` returned — half a length prefix,
    three frames and a torn fourth — and yields each message exactly once,
    as soon as its final byte arrives.  ``max_frame`` bounds a single
    frame (``max_frame_bytes(fleet_size)`` for fleet-shaped streams)."""

    def __init__(self, max_frame: Optional[int] = None) -> None:
        self.max_frame = MAX_FRAME_BYTES if max_frame is None \
            else int(max_frame)
        self._buf = bytearray()
        self._need: Optional[int] = None     # body length once prefix parsed

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> Iterator[Dict]:
        self._buf += data
        while True:
            if self._need is None:
                if len(self._buf) < _LEN.size:
                    return
                (self._need,) = _LEN.unpack_from(self._buf)
                if self._need > self.max_frame:
                    raise ValueError(
                        f"frame length {self._need}B exceeds "
                        f"max frame size {self.max_frame}B "
                        "(corrupt stream?)")
                del self._buf[:_LEN.size]
            if len(self._buf) < self._need:
                return
            body = bytes(self._buf[:self._need])
            del self._buf[:self._need]
            self._need = None
            yield unpackb(body)


# -- message constructors (one place defines the schema) ----------------------

def hello_msg(worker: int, token: Optional[str] = None,
              role: str = "worker") -> Dict:
    msg: Dict = {"t": "hello", "worker": int(worker)}
    if role != "worker":
        msg["role"] = str(role)
    if token is not None:
        msg["token"] = str(token)
    return msg


def upload_msg(window: int, upload, seq: int) -> Dict:
    """Wrap a ``repro_torch.core.daemon.PatternUpload`` for the wire."""
    return {"t": "upload", "window": int(window), "worker": int(upload.worker),
            "seq": int(seq), "payload": upload.payload,
            "summarize_s": float(upload.summarize_s),
            "raw_bytes": int(upload.raw_bytes)}


def msg_to_upload(msg: Dict) -> Tuple[int, "PatternUpload"]:
    """Inverse of ``upload_msg``: (window, PatternUpload)."""
    from repro_torch.core.daemon import PatternUpload   # late: avoid import cycle
    return int(msg["window"]), PatternUpload(
        worker=int(msg["worker"]), payload=msg["payload"],
        summarize_s=float(msg["summarize_s"]),
        raw_bytes=int(msg["raw_bytes"]))


def window_end_msg(window: int, worker: int, sent: int, dropped: int,
                   reconnects: int = 0) -> Dict:
    return {"t": "window_end", "window": int(window), "worker": int(worker),
            "sent": int(sent), "dropped": int(dropped),
            "reconnects": int(reconnects)}


def anchors_msg(window: int, worker: int, durations: Sequence[float],
                numerics: Optional[Sequence[Tuple[float, float]]] = None,
                slo: Optional[Sequence[Tuple[float, float]]] = None
                ) -> Dict:
    """Per-window anchor report of a REAL workload (DESIGN.md §11): the
    worker's measured iteration durations, in iteration order.  Control
    grade — sent undroppable, because the job-level iteration detector's
    (D, O) stream is merged from these.

    ``numerics`` optionally rides along: per-iteration (loss, grad_norm)
    pairs for the numerics channel (DESIGN.md §12a).  ``slo`` does the
    same for serving workloads: per-iteration (p99_ttft, p99_tbt) pairs
    for the latency-SLO channel (DESIGN.md §13).  Each field is only
    present when provided, so workloads without those streams produce
    byte-identical frames to the earlier wire formats."""
    msg = {"t": "anchors", "window": int(window), "worker": int(worker),
           "durs": [float(d) for d in durations]}
    if numerics is not None:
        msg["numerics"] = [[float(a), float(b)] for a, b in numerics]
    if slo is not None:
        msg["slo"] = [[float(a), float(b)] for a, b in slo]
    return msg


def window_start_msg(window: int, rates=None, stop: bool = False,
                     membership: Optional[Sequence[int]] = None,
                     plans: Optional[List[Dict]] = None) -> Dict:
    """Per-window control frame.  ``membership`` (current training-mesh
    worker ids) and ``plans`` (mitigation deltas applied since the last
    window, see ``repro_torch.online.mitigation.plan_to_wire``) are the §10
    control plane: worker processes replay them onto their own simulators
    and collectors re-key their expected sets."""
    msg: Dict = {"t": "window_start", "window": int(window),
                 "rates": (None if rates is None
                           else [float(r) for r in rates]),
                 "stop": bool(stop)}
    if membership is not None:
        msg["membership"] = [int(w) for w in membership]
    if plans:
        msg["plans"] = list(plans)
    return msg


def shard_msg(window: int, shard: int, workers: Sequence[int],
              names: Sequence[str], kinds: Sequence[int], rows: bytes,
              missing: Sequence[int], duplicates: int, client_dropped: int,
              reconnects: int, raw_bytes: int, pattern_bytes: int,
              summarize_s: float, timed_out: bool) -> Dict:
    """One compacted rack window, leaf -> root (DESIGN.md §10).

    ``rows`` is the packed columnar pattern block: float32 little-endian
    ``(len(workers), len(names), 3)``, row ``i`` belonging to
    ``workers[i]`` (ascending).  One shard frame replaces the rack's
    2xW_rack upload/window_end frames at the root, so root ingress is
    O(shards) frames per window."""
    return {"t": "shard", "window": int(window), "shard": int(shard),
            "workers": [int(w) for w in workers],
            "missing": [int(w) for w in missing],
            "names": [str(n) for n in names],
            "kinds": [int(k) for k in kinds],
            "rows": bytes(rows),
            "duplicates": int(duplicates),
            "client_dropped": int(client_dropped),
            "reconnects": int(reconnects),
            "raw_bytes": int(raw_bytes),
            "pattern_bytes": int(pattern_bytes),
            "summarize_s": float(summarize_s),
            "timed_out": bool(timed_out)}


def stop_msg() -> Dict:
    return {"t": "stop"}


def bye_msg(worker: int) -> Dict:
    return {"t": "bye", "worker": int(worker)}
