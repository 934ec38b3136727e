"""The port's socket transport and daemon against the JAX reference's.

Frames are byte-identical between the packages (every message constructor,
and the daemon's pattern payload on the same profile), each package decodes
the other's frames, and the port's own msgpack codec writes what
``msgpack.packb(use_bin_type=True)`` writes on the subset the frames use.
Units of tests/test_wire.py run on the port's transport (queue, collector,
loopback, backpressure gated by an event instead of timing).  Mixed fleets
(port daemons into a reference collector and the other way round) give the
all-reference diagnosis, and ``diagnose_profiles(mode="wire")`` equals fleet
mode and the reference's wire diagnosis.  The port runs on the CPU here.
"""
import math
import threading

import msgpack
import numpy as np
import pytest

from repro.core import faults as RF
from repro.core.daemon import PerfTrackerDaemon as RefDaemon
from repro.core.daemon import summarize_and_upload as ref_upload
from repro.core.service import PerfTrackerService as RefService
from repro.core.simulation import FleetSimulator as RefSim
from repro.core.simulation import SimConfig as RefConfig
from repro.transport import DaemonServer as RefServer
from repro.transport import WindowCollector as RefCollector
from repro.transport import framing as ref_framing

from repro_torch.core import faults as F
from repro_torch.core.daemon import (PatternUpload, PerfTrackerDaemon,
                                     summarize_and_upload)
from repro_torch.core.events import (FunctionEvent, Kind, SampleStream,
                                     WorkerProfile)
from repro_torch.core.patterns import pattern_size_bytes
from repro_torch.core.service import PerfTrackerService
from repro_torch.core.simulation import GEMM, FleetSimulator, SimConfig
from repro_torch.summarize import PatternAggregator
from repro_torch.transport import (DaemonServer, FrameDecoder, LoopbackWire,
                                   SendQueue, WindowCollector, WireClient,
                                   decode_frames, encode_frame, framing)
from repro_torch.transport.codec import packb, unpackb

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401
from _prop import given, settings, st
from test_torch_fleet import assert_same_diagnosis

W_MIX = 32


def _fleets(faults, W=W_MIX, seed=7, window_s=1.0, rate_hz=1000):
    cfg = dict(n_workers=W, window_s=window_s, rate_hz=rate_hz, seed=seed)
    ref = RefSim(RefConfig(**cfg), faults(RF)).profile_window()
    port = FleetSimulator(SimConfig(**cfg), faults(F)).profile_window()
    return ref, port


def _throttle(m):
    return [m.GpuThrottle(workers=(3, 11))]


# -- the codec and the frames -------------------------------------------------

def _constructors(mod, upload):
    """Every message constructor of a framing module, with and without
    its optional fields."""
    return [
        mod.hello_msg(3), mod.hello_msg(4, token="s3cret"),
        mod.hello_msg(1, role="leaf"),
        mod.upload_msg(2, upload, 7),
        mod.window_end_msg(2, 3, sent=5, dropped=1, reconnects=2),
        mod.anchors_msg(3, 7, [0.5, 0.61]),
        mod.anchors_msg(3, 7, [0.5], numerics=[(2.5, 1.25)]),
        mod.anchors_msg(3, 7, [0.5, 0.6], slo=[(0.21, 0.013), (0.19, 0.011)]),
        mod.anchors_msg(3, 7, [0.5], numerics=[(1.0, 2.0)],
                        slo=[(3.0, 4.0)]),
        mod.window_start_msg(0), mod.window_start_msg(1, rates=[250, 2000.0]),
        mod.window_start_msg(2, rates=None, stop=True),
        mod.window_start_msg(5, rates=[1.0] * 20, membership=range(18),
                             plans=[{"action": "replace_hosts",
                                     "workers": [3], "applied_at": 4,
                                     "detail": "é", "rollback_failed": False}]),
        mod.shard_msg(4, 1, [4, 5], ["f", "g" * 40], [0, 3],
                      np.arange(12, dtype="<f4").tobytes(), [6], 1, 2, 3,
                      10 ** 9, 300, 0.125, False),
        mod.stop_msg(), mod.bye_msg(9),
    ]


def test_every_frame_is_byte_identical_to_the_reference():
    ref_prof, port_prof = _fleets(_throttle, W=4)
    ref_up = ref_upload(ref_prof[1], backend="numpy")
    port_up = summarize_and_upload(port_prof[1], backend="numpy")
    assert port_up.payload == ref_up.payload
    assert port_up.raw_bytes == ref_up.raw_bytes
    port_up.summarize_s = ref_up.summarize_s = 0.03125
    ours = _constructors(framing, port_up)
    theirs = _constructors(ref_framing, ref_up)
    assert ours == theirs
    for a, b in zip(ours, theirs):
        fa, fb = encode_frame(a), ref_framing.encode_frame(b)
        assert fa == fb, a["t"]
        assert ref_framing.decode_frames(fa) == [a] or a["t"] == "upload"
        (back,) = decode_frames(fb)
        (ref_back,) = ref_framing.decode_frames(fa)
        assert back == ref_back


def test_each_package_decodes_the_others_frames_to_equal_dicts():
    ref_prof, port_prof = _fleets(_throttle, W=3)
    ups = [summarize_and_upload(p, backend="numpy") for p in port_prof]
    blob = b"".join(encode_frame(m) for m in _constructors(framing, ups[2]))
    ref_blob = b"".join(ref_framing.encode_frame(m) for m in
                        _constructors(ref_framing,
                                      ref_upload(ref_prof[2],
                                                 backend="numpy")))
    ours = decode_frames(ref_blob)
    theirs = ref_framing.decode_frames(blob)
    for a, b in zip(ours, theirs):
        if a["t"] == "upload":
            a, b = dict(a), dict(b)
            a.pop("summarize_s")
            b.pop("summarize_s")
        assert a == b
    # an upload crosses the packages and unpacks to the same patterns
    (msg,) = ref_framing.decode_frames(encode_frame(framing.upload_msg(
        0, ups[0], 0)))
    _, ref_up = ref_framing.msg_to_upload(msg)
    pats, kinds = ups[0].unpack()
    ref_pats, ref_kinds = ref_up.unpack()
    assert list(pats) == list(ref_pats)
    for n in pats:
        np.testing.assert_array_equal(pats[n], ref_pats[n])
        assert int(kinds[n]) == int(ref_kinds[n])


def test_upload_payloads_match_the_reference_on_every_worker():
    ref_prof, port_prof = _fleets(_throttle, W=8)
    for r, p in zip(ref_prof, port_prof):
        assert summarize_and_upload(p, backend="numpy").payload == \
            ref_upload(r, backend="numpy").payload


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, -0.0, 1.5, math.inf, -math.inf,
    np.float64(0.1), "", "a" * 31, "a" * 32, "é" * 200, "x" * 70000,
    b"", b"\x00" * 255, b"\x01" * 256, bytearray(b"ab"),
    memoryview(b"mv"), [], (1, 2), list(range(16)), {"k": (1.0, 2, 3)},
    {i: i for i in range(16)}, {"nested": [{"a": [None, b"z"]}]},
], ids=lambda o: type(o).__name__)
def test_codec_writes_what_msgpack_writes(obj):
    raw = packb(obj)
    assert raw == msgpack.packb(obj, use_bin_type=True)
    assert repr(unpackb(raw)) == repr(
        msgpack.unpackb(raw, raw=False, strict_map_key=False))


@pytest.mark.parametrize("obj", [np.float32(1.0), np.int64(3), {1, 2},
                                 np.array([1.0]), object(), np.bool_(True)],
                         ids=lambda o: type(o).__name__)
def test_codec_refuses_what_msgpack_refuses(obj):
    with pytest.raises(TypeError):
        msgpack.packb(obj, use_bin_type=True)
    with pytest.raises(TypeError):
        packb(obj)


def test_codec_rejects_malformed_input():
    for bad in (b"\xc1", b"\x92\x01", b"\x01\x02", b"\xd4\x01\x02", b"",
                b"\xda\x00\x05ab"):
        with pytest.raises(ValueError):
            unpackb(bad)
    with pytest.raises(OverflowError):
        packb(2 ** 64)
    assert unpackb(b"\xca\x3f\xc0\x00\x00") == 1.5      # float 32


_SCALAR = (st.none() | st.booleans()
           | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text() | st.binary())
_VALUE = st.recursive(
    _SCALAR, lambda inner: (st.lists(inner, max_size=20)
                            | st.tuples(inner, inner)
                            | st.dictionaries(st.text() | st.integers(
                                min_value=-2 ** 63, max_value=2 ** 64 - 1),
                                inner, max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_VALUE)
def test_codec_matches_msgpack_on_the_frame_subset(obj):
    raw = packb(obj)
    assert raw == msgpack.packb(obj, use_bin_type=True)
    assert unpackb(raw) == msgpack.unpackb(raw, raw=False,
                                           strict_map_key=False)


def test_port_imports_no_msgpack():
    import sys
    import repro_torch.transport.framing as fr
    assert "msgpack" not in fr.__dict__
    assert "packb" in fr.__dict__ and fr.packb is packb
    assert sys.modules["repro_torch.core.daemon"].__dict__.get(
        "msgpack") is None


def test_pattern_size_bytes_matches_the_reference():
    from repro.core.patterns import pattern_size_bytes as ref_size
    from repro.core.patterns import Pattern as RefPattern
    from repro_torch.core.patterns import Pattern
    names = ["f", "gé" * 9, "AllGather_RING"]
    assert pattern_size_bytes({n: Pattern(0.1, 0.2, 0.3) for n in names}) \
        == ref_size({n: RefPattern(0.1, 0.2, 0.3) for n in names})


# -- framing and the send queue (tests/test_wire.py's units) ------------------

def test_frame_decoder_survives_any_recv_boundary():
    msgs = [framing.bye_msg(w) for w in range(5)]
    blob = b"".join(encode_frame(m) for m in msgs)
    dec = FrameDecoder()
    got = []
    for i in range(len(blob)):
        got += list(dec.feed(blob[i:i + 1]))
    assert got == msgs and dec.pending_bytes == 0
    with pytest.raises(ValueError):
        decode_frames(encode_frame(framing.hello_msg(0)) + b"\x00\x00")
    with pytest.raises(ValueError):
        list(FrameDecoder().feed((framing.MAX_FRAME_BYTES + 1).to_bytes(
            4, "big") + b"x"))
    with pytest.raises(ValueError):
        encode_frame({"t": "upload", "payload": b"x" * 2048}, max_frame=1024)


def test_send_queue_drops_oldest_upload_never_control():
    q = SendQueue(max_uploads=2)
    q.put({"t": "hello"}, droppable=False)
    for i in range(6):
        q.put({"seq": i})
    q.put({"t": "window_end"}, droppable=False)
    items = []
    while (item := q.pop()) is not None:
        items.append(item)
    assert [d for d, _ in items] == [False, True, True, False]
    assert [m.get("seq") for _, m in items[1:3]] == [4, 5]
    assert q.dropped == 4


def _upload(worker, beta=0.5, n=100):
    prof = WorkerProfile(
        worker=worker, window=(0.0, 1.0),
        events=[FunctionEvent("matmul", Kind.GPU, 0.0, beta, worker)],
        streams={"gpu_sm": SampleStream(float(n), 0.0, np.full(n, 0.8))})
    return summarize_and_upload(prof, backend="numpy")


def test_client_backpressure_drops_oldest_counts_on_wire():
    """The twin of the reference's test, gated by events instead of
    timing: the sender thread is held inside window 0's frame filter
    (``entered`` says it is there) before the five later uploads queue up
    behind it, so exactly the oldest three of them drop, however loaded
    the host.  The reference's version could queue all six before its
    sender reached the filter (4 drops)."""
    entered, gate = threading.Event(), threading.Event()

    def stall(msg, frame):
        entered.set()
        gate.wait(timeout=30.0)
        return None

    collector = WindowCollector([0])
    with DaemonServer(collector) as server:
        client = WireClient(server.address, worker=0, max_queue=2,
                            frame_filter=stall)
        try:
            client.send_upload(0, _upload(0))
            assert entered.wait(timeout=30.0)
            for w in range(1, 6):
                client.send_upload(w, _upload(0))
            assert client.dropped == 3
            client.end_window(5)
            gate.set()
            assert client.flush(timeout=30.0)
            batch = collector.wait_window(5, timeout=30.0)
        finally:
            gate.set()
            client.close()
    assert batch.client_dropped == 3
    assert batch.present == [0] and not batch.timed_out


# -- collector, loopback and daemon -------------------------------------------

def _loopback_batch(n_workers, frame_filter=None):
    uploads = [_upload(w) for w in range(n_workers)]
    with LoopbackWire(range(n_workers), frame_filter=frame_filter) as wire:
        return wire.send_round(uploads, window=0, timeout=15.0)


@pytest.mark.parametrize("case", ["full", "duplicated", "dropped"])
def test_collector_assembles_dedups_and_tolerates_loss(case):
    if case == "full":
        batch = _loopback_batch(6)
        assert batch.present == list(range(6)) and batch.complete
        assert batch.duplicates == 0 and not batch.timed_out
    elif case == "duplicated":
        batch = _loopback_batch(5, lambda m, f: [f, f, f]
                                if m["worker"] == 2 else None)
        assert batch.present == list(range(5)) and batch.duplicates == 2
    else:
        batch = _loopback_batch(5, lambda m, f: []
                                if m["worker"] in (1, 3) else None)
        assert batch.missing == [1, 3] and batch.present == [0, 2, 4]
        assert not batch.timed_out
        np.testing.assert_array_equal(batch.present_mask(5),
                                      [True, False, True, False, True])


def test_collector_timeout_stragglers_and_slo_anchors():
    collector = WindowCollector([0, 1])
    collector.on_message({"t": "window_end", "window": 0, "worker": 0,
                          "sent": 0, "dropped": 0})
    batch = collector.wait_window(0, timeout=0.2)
    assert batch.timed_out and batch.missing == [0, 1]
    collector.on_message(framing.upload_msg(0, _upload(1), seq=9))
    assert collector.stale_frames == 1 and collector._batches == {}
    collector = WindowCollector([7])
    collector.on_message(framing.anchors_msg(3, 7, [0.5, 0.6],
                                             slo=[(0.21, 0.013)]))
    collector.on_message(framing.anchors_msg(3, 7, [9.9], slo=[(1.0, 1.0)]))
    collector.on_message({"t": "window_end", "window": 3, "worker": 7,
                          "sent": 1, "dropped": 0})
    batch = collector.wait_window(3, timeout=1.0)
    assert batch.anchors[7] == [0.5, 0.6]
    assert batch.slo == {7: [(0.21, 0.013)]} and batch.numerics == {}


def test_daemon_process_window_uploads_over_wire():
    _, port = _fleets(_throttle, W=5)
    collector = WindowCollector([4])
    with DaemonServer(collector) as server:
        daemon = PerfTrackerDaemon(4, server.address, backend="numpy",
                                   device="cpu")
        try:
            up = daemon.process_window(0, port[4])
            batch = collector.wait_window(0, timeout=10.0)
        finally:
            daemon.close()
    assert batch.present == [4]
    assert batch.uploads[4].payload == up.payload
    assert isinstance(batch.uploads[4], PatternUpload)


def test_aggregator_upload_methods_match_the_reference():
    from repro.summarize import PatternAggregator as RefAggregator
    ref_prof, port_prof = _fleets(_throttle, W=6)
    ups = [summarize_and_upload(p, backend="numpy") for p in port_prof]
    ref_ups = [ref_upload(p, backend="numpy") for p in ref_prof]
    a = PatternAggregator(expected_workers=6).extend(ups)
    b = RefAggregator(expected_workers=6).extend(ref_ups)
    np.testing.assert_array_equal(a.matrix()[0], b.matrix()[0])
    assert a.matrix()[1] == b.matrix()[1]
    a, b = PatternAggregator(6), RefAggregator(6)
    a.reserve_workers(6)
    b.reserve_workers(6)
    for u, r in zip(ups[::-2], ref_ups[::-2]):
        a.add_upload_at(u, u.worker)
        b.add_upload_at(r, r.worker)
    np.testing.assert_array_equal(a.matrix()[0], b.matrix()[0])
    with pytest.raises(ValueError):
        a.set_row(7, {"f": np.zeros(3, np.float32)})
    cols = np.array([a.intern(n, Kind.GPU) for n in a.matrix()[1][:2]])
    block = np.full((2, 2, 3), 0.25, np.float32)
    a.scatter_cols(np.array([1, 4]), cols, block)
    np.testing.assert_array_equal(a.matrix()[0][np.ix_([1, 4], cols)],
                                  block)
    with pytest.raises(ValueError):
        a.scatter_cols(np.array([1]), cols, block)


# -- the service's wire mode --------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_wire_mode_equals_fleet_mode_and_the_reference(backend):
    ref_prof, port_prof = _fleets(_throttle)
    svc = PerfTrackerService(summarize_backend=backend, device="cpu")
    fleet = svc.diagnose_profiles(port_prof, mode="fleet")
    wire = svc.diagnose_profiles(port_prof, mode="wire")
    assert_same_diagnosis(wire, fleet)
    assert wire.pattern_bytes == fleet.pattern_bytes
    assert wire.raw_bytes == fleet.raw_bytes
    assert wire.transport["present"] == W_MIX
    assert wire.timing["transport_s"] > 0
    ref_wire = RefService(summarize_backend="numpy").diagnose_profiles(
        ref_prof, mode="wire")
    assert_same_diagnosis(wire, ref_wire,
                          patterns_atol=None if backend == "numpy" else 1e-6)
    assert wire.report() .splitlines()[-1] == \
        ref_wire.report().splitlines()[-1]


def test_wire_mode_loss_degrades_instead_of_crashing():
    _, port = _fleets(lambda m: [m.GpuThrottle(workers=(3, 5))], W=16)

    def drop(msg, frame):
        return [] if msg["worker"] in (0, 9) else None
    svc = PerfTrackerService(summarize_backend="numpy",
                             wire_frame_filter=drop, device="cpu")
    res = svc.diagnose_profiles(port, mode="wire")
    d = next(d for d in res.diagnoses if d.abnormality.function == GEMM)
    assert {3, 5} <= set(d.abnormality.workers.tolist())
    assert res.transport["missing"] == [0, 9]
    assert "transport: 14/16 workers reported" in res.report()
    assert "missing=[0, 9]" in res.report()


# -- mixed fleets: port daemons into a reference collector and back -----------

def _diagnose_fleet(daemon_cls, server_cls, collector_cls, service, profiles,
                    **daemon_kw):
    collector = collector_cls(range(len(profiles)))
    with server_cls(collector) as server:
        daemons = [daemon_cls(p.worker, server.address, backend="numpy",
                              **daemon_kw) for p in profiles]
        try:
            for d, p in zip(daemons, profiles):
                d.process_window(0, p)
            batch = collector.wait_window(0, timeout=30.0)
        finally:
            for d in daemons:
                d.close()
    assert batch.complete and not batch.timed_out
    return service.diagnose_batch(batch, fleet_size=len(profiles))


@pytest.mark.parametrize("mix", ["port_daemons_ref_collector",
                                 "ref_daemons_port_collector"])
def test_mixed_fleet_gives_the_all_reference_diagnosis(mix):
    ref_prof, port_prof = _fleets(_throttle)
    ref_svc = RefService(summarize_backend="numpy")
    want = _diagnose_fleet(RefDaemon, RefServer, RefCollector, ref_svc,
                           ref_prof)
    if mix == "port_daemons_ref_collector":
        got = _diagnose_fleet(PerfTrackerDaemon, RefServer, RefCollector,
                              RefService(summarize_backend="numpy"),
                              port_prof, device="cpu")
        assert [d.abnormality.function for d in got.diagnoses] == \
            want.functions()
        for a, b in zip(got.diagnoses, want.diagnoses):
            np.testing.assert_array_equal(a.abnormality.patterns,
                                          b.abnormality.patterns)
            np.testing.assert_array_equal(a.abnormality.workers,
                                          b.abnormality.workers)
        assert got.pattern_bytes == want.pattern_bytes
    else:
        got = _diagnose_fleet(RefDaemon, DaemonServer, WindowCollector,
                              PerfTrackerService(summarize_backend="numpy",
                                                 device="cpu"), ref_prof)
        assert_same_diagnosis(got, want)
        assert got.pattern_bytes == want.pattern_bytes
        assert got.report() == want.report()
