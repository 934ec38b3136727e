"""Real wire transport for PerfTracker pattern uploads (DESIGN.md §8,
§10; port of the reference's ``repro/transport``): length-prefixed msgpack
framing over Unix/TCP sockets, per-worker clients with bounded drop-oldest
send queues and reconnect-with-backoff, a multiplexing collector server
with optional shared-secret auth, partial-window assembly with dedup and
loss accounting, and a two-tier collector tree (leaf racks compacting shard
frames into a root)."""
from repro_torch.transport.client import SendQueue, WireClient, connect
from repro_torch.transport.collector import WindowBatch, WindowCollector
from repro_torch.transport.framing import (FrameDecoder, MAX_FRAME_BYTES,
                                     decode_frames, encode_frame,
                                     max_frame_bytes)
from repro_torch.transport.loopback import LoopbackWire
from repro_torch.transport.server import DaemonServer
from repro_torch.transport.tree import (CollectorTree, LeafNode, ShardCollector,
                                  TreeWindowBatch, compact_shard,
                                  leaf_process_main)

__all__ = [
    "FrameDecoder", "MAX_FRAME_BYTES", "max_frame_bytes",
    "decode_frames", "encode_frame",
    "SendQueue", "WireClient", "connect",
    "WindowBatch", "WindowCollector",
    "DaemonServer", "LoopbackWire",
    "CollectorTree", "LeafNode", "ShardCollector", "TreeWindowBatch",
    "compact_shard", "leaf_process_main",
]
