"""The port's collector tree and wire control plane against the reference.

Units of tests/test_tree.py on the port's transport (fleet-derived frame
caps, reconnect after a collector restart, the authenticated hello,
expected-set re-keying, shard dedup and a lost rack), shard frames
byte-identical between the packages, tree-mode diagnosis equal to flat
wire mode over the six-fault matrix, and mixed trees: port daemons under a
reference ``CollectorTree`` and reference daemons under the port's give
the all-reference diagnosis.  The port runs on the CPU here.
"""
import os

import numpy as np
import pytest

from repro.core import faults as RF
from repro.core.daemon import PerfTrackerDaemon as RefDaemon
from repro.core.daemon import summarize_and_upload as ref_upload
from repro.core.service import PerfTrackerService as RefService
from repro.core.simulation import FleetSimulator as RefSim
from repro.core.simulation import SimConfig as RefConfig
from repro.transport import CollectorTree as RefTree
from repro.transport import WindowCollector as RefCollector
from repro.transport import compact_shard as ref_compact
from repro.transport import framing as ref_framing

from repro_torch.core import faults as F
from repro_torch.core.daemon import PerfTrackerDaemon, summarize_and_upload
from repro_torch.core.events import (FunctionEvent, Kind, SampleStream,
                                     WorkerProfile)
from repro_torch.core.report import format_transport
from repro_torch.core.service import PerfTrackerService
from repro_torch.core.simulation import FleetSimulator, SimConfig
from repro_torch.transport import (CollectorTree, DaemonServer, FrameDecoder,
                                   ShardCollector, WindowCollector,
                                   WireClient, compact_shard, encode_frame,
                                   framing, max_frame_bytes)

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401
from test_torch_fleet import SCENARIOS, assert_same_diagnosis

SVC = dict(summarize_backend="numpy", device="cpu")


def _upload(worker, beta=0.5):
    n = 64
    prof = WorkerProfile(
        worker=worker, window=(0.0, 1.0),
        events=[FunctionEvent("matmul", Kind.GPU, 0.0, beta, worker)],
        streams={"gpu_sm": SampleStream(float(n), 0.0, np.full(n, 0.8))})
    return summarize_and_upload(prof, backend="numpy")


def _end_msg(window, worker):
    return {"t": "window_end", "window": window, "worker": worker,
            "sent": 1, "dropped": 0}


def _profiles(W, faults=lambda m: [], seed=7):
    cfg = dict(n_workers=W, window_s=1.0, rate_hz=1000, seed=seed)
    return (RefSim(RefConfig(**cfg), faults(RF)).profile_window(),
            FleetSimulator(SimConfig(**cfg), faults(F)).profile_window())


def test_max_frame_bytes_and_derived_cap():
    assert max_frame_bytes(None) == framing.MAX_FRAME_BYTES
    assert max_frame_bytes(16) == framing.MAX_FRAME_BYTES
    assert max_frame_bytes(1024) == (framing.FRAME_OVERHEAD_BYTES
                                     + 1024 * framing.PER_WORKER_FRAME_BYTES)
    assert max_frame_bytes(2048) > max_frame_bytes(1024) > \
        framing.MAX_FRAME_BYTES
    over = framing.MAX_FRAME_BYTES + 1
    with pytest.raises(ValueError):
        list(FrameDecoder().feed(over.to_bytes(4, "big") + b"x"))
    list(FrameDecoder(max_frame=max_frame_bytes(1024))
         .feed(over.to_bytes(4, "big")))
    big = encode_frame({"t": "upload", "payload": b"x" * 2048})
    with pytest.raises(ValueError):
        list(FrameDecoder(max_frame=1024).feed(big))


@pytest.mark.timeout(60)
def test_client_reconnects_after_collector_restart(tmp_path):
    path = str(tmp_path / "collector.sock")
    collector = WindowCollector([0])
    server = DaemonServer(collector, address=path).start()
    client = WireClient(path, worker=0, reconnect_max=100,
                        reconnect_backoff_s=0.01,
                        reconnect_backoff_max_s=0.05)
    try:
        client.send_upload(0, _upload(0))
        client.end_window(0)
        assert collector.wait_window(0, timeout=10.0).present == [0]
        server.stop()
        if os.path.exists(path):
            os.unlink(path)
        server2 = DaemonServer(collector, address=path).start()
        try:
            assert server2.wait_connections(1, timeout=20.0)
            client.send_upload(1, _upload(0))
            client.end_window(1)
            batch = collector.wait_window(1, timeout=10.0)
        finally:
            server2.stop()
    finally:
        client.close()
        server.stop()
    assert batch.present == [0] and not batch.timed_out
    assert client.reconnects == 1 and batch.reconnects == 1
    assert "reconnects=1" in format_transport(batch.stats())


def test_client_reconnect_gives_up_after_max_attempts():
    collector = WindowCollector([0])
    server = DaemonServer(collector).start()
    client = WireClient(server.address, worker=0, reconnect_max=2,
                        reconnect_backoff_s=0.01,
                        reconnect_backoff_max_s=0.02)
    try:
        server.stop()
        client.send_upload(0, _upload(0))
        client.end_window(0)
        client._thread.join(timeout=20.0)
        assert not client._thread.is_alive()
        assert any("reconnect failed after 2 attempts" in e
                   for e in client.errors)
    finally:
        client.close()


def test_auth_token_passes_rejects_and_logs(tmp_path):
    log = str(tmp_path / "wire.log")
    collector = WindowCollector([0, 1])
    with DaemonServer(collector, auth_token="s3cret",
                      log_path=log) as server:
        good = WireClient(server.address, 0, auth_token="s3cret")
        bad = WireClient(server.address, 1, auth_token="wrong",
                         reconnect_max=1, reconnect_backoff_s=0.01,
                         reconnect_backoff_max_s=0.02)
        missing = WireClient(server.address, 1, reconnect_max=1,
                             reconnect_backoff_s=0.01,
                             reconnect_backoff_max_s=0.02)
        try:
            for c, w in ((good, 0), (bad, 1), (missing, 1)):
                c.send_upload(0, _upload(w))
                c.end_window(0)
            batch = collector.wait_window(0, timeout=1.0)
        finally:
            for c in (good, bad, missing):
                c.close()
        assert server.auth_rejected >= 2
    assert batch.present == [0] and batch.timed_out
    with open(log) as f:
        assert "auth rejected" in f.read()


def test_set_expected_completes_open_batches():
    coll = WindowCollector([0, 1, 2])
    for w in (0, 1):
        coll.on_message(framing.upload_msg(0, _upload(w), 0))
        coll.on_message(_end_msg(0, w))
    coll.set_expected([0, 1])
    batch = coll.wait_window(0, timeout=5.0)
    assert not batch.timed_out and batch.complete
    assert batch.present == [0, 1]


def _shard_frame(compact, collector_cls, upload_of, shard, workers):
    coll = collector_cls(workers)
    for w in workers:
        coll.on_message(framing.upload_msg(0, upload_of(w), 0))
        coll.on_message(_end_msg(0, w))
    return compact(shard, coll.wait_window(0, timeout=5.0))


def test_shard_frames_are_byte_identical_to_the_reference():
    ref_prof, port_prof = _profiles(6, lambda m: [m.GpuThrottle(
        workers=(1,))])

    def ours(w):
        u = summarize_and_upload(port_prof[w], backend="numpy")
        u.summarize_s = 0.5
        return u

    def theirs(w):
        u = ref_upload(ref_prof[w], backend="numpy")
        u.summarize_s = 0.5
        return u
    a = _shard_frame(compact_shard, WindowCollector, ours, 1, (2, 3, 4))
    b = _shard_frame(ref_compact, RefCollector, theirs, 1, (2, 3, 4))
    assert a == b
    assert encode_frame(a) == ref_framing.encode_frame(b)


def test_shard_collector_dedups_and_reports_lost_rack():
    def frame(shard, ws):
        return _shard_frame(compact_shard, WindowCollector, _upload, shard,
                            ws)
    sc = ShardCollector({0: (0, 1), 1: (2, 3)})
    f0 = frame(0, (0, 1))
    sc.on_message(f0)
    sc.on_message(dict(f0))
    sc.on_message(frame(1, (2, 3)))
    batch = sc.wait_window(0, timeout=5.0)
    assert batch.duplicate_shards == 1 and batch.present == [0, 1, 2, 3]
    assert "duplicate_shards=1" in format_transport(batch.stats())
    sc = ShardCollector({0: (0, 1), 1: (2, 3)})
    sc.on_message(frame(0, (0, 1)))
    batch = sc.wait_window(0, timeout=0.3)
    assert batch.timed_out and batch.missing_shards == [1]
    assert batch.missing == [2, 3]
    agg, present = batch.aggregate(4)
    np.testing.assert_array_equal(present, [True, True, False, False])
    pats, _ = agg.finalize()
    assert pats and all(np.all(np.asarray(p)[[2, 3]] == 0)
                        for p in pats.values())


def _tree_diagnose(tree_cls, daemon_cls, service, profiles, n_shards,
                   members=None, **daemon_kw):
    W = len(profiles)
    members = list(range(W)) if members is None else members
    with tree_cls(range(W), n_shards) as tree:
        daemons = {w: daemon_cls(w, tree.address_of(w), backend="numpy",
                                 **daemon_kw) for w in members}
        try:
            tree.wait_connections(len(members))
            tree.broadcast(framing.window_start_msg(
                0, None, membership=None if len(members) == W else members))
            for w, d in daemons.items():
                d.process_window(0, profiles[w])
            batch = tree.wait_window(0, timeout=30.0)
        finally:
            for d in daemons.values():
                d.close()
    return batch, service.diagnose_batch(batch, fleet_size=W)


@pytest.mark.timeout(120)
def test_window_start_membership_rekeys_tree():
    _, port = _profiles(6)
    members = [0, 1, 2, 4, 5]
    batch, _ = _tree_diagnose(CollectorTree, PerfTrackerDaemon,
                              PerfTrackerService(**SVC), port, 2,
                              members=members, device="cpu")
    assert not batch.timed_out and batch.complete
    assert batch.present == members and 3 not in batch.expected


@pytest.mark.timeout(120)
def test_tree_survives_lost_rack_end_to_end():
    _, port = _profiles(9)
    with CollectorTree(range(9), 3, window_timeout=5.0) as tree:
        alive = [w for s in (0, 2) for w in tree.shard_workers[s]]
        tree.leaves[1].stop()
        daemons = {w: PerfTrackerDaemon(w, tree.address_of(w),
                                        backend="numpy", device="cpu")
                   for w in alive}
        try:
            tree.broadcast(framing.window_start_msg(0, None))
            for w, d in daemons.items():
                d.process_window(0, port[w])
            batch = tree.wait_window(0, timeout=3.0)
        finally:
            for d in daemons.values():
                d.close()
        lost = list(tree.shard_workers[1])
    assert batch.timed_out and batch.missing_shards == [1]
    assert batch.missing == lost and batch.present == alive
    res = PerfTrackerService(**SVC).diagnose_batch(batch, fleet_size=9)
    assert "collector tree 2/3 shards reported" in res.report()
    assert "missing_shards=[1]" in res.report()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("faults,expect,kind", SCENARIOS[:6])
def test_tree_mode_matches_flat_wire_mode(faults, expect, kind):
    _, port = _profiles(16, faults)
    svc = PerfTrackerService(**SVC)
    flat = svc.diagnose_profiles(port, mode="wire")
    batch, treed = _tree_diagnose(CollectorTree, PerfTrackerDaemon, svc,
                                  port, 4, device="cpu")
    assert batch.missing == [] and batch.missing_shards == []
    assert any(expect in f for f in treed.functions())
    assert int(treed.diagnoses[0].abnormality.kind) == kind
    assert_same_diagnosis(treed, flat)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("mix", ["port_daemons_ref_tree",
                                 "ref_daemons_port_tree"])
def test_mixed_tree_gives_the_all_reference_diagnosis(mix):
    ref_prof, port_prof = _profiles(32, lambda m: [m.GpuThrottle(
        workers=(3, 11))])
    ref_svc = RefService(summarize_backend="numpy")
    _, want = _tree_diagnose(RefTree, RefDaemon, ref_svc, ref_prof, 4)
    if mix == "port_daemons_ref_tree":
        batch, got = _tree_diagnose(RefTree, PerfTrackerDaemon, ref_svc,
                                    port_prof, 4, device="cpu")
        assert got.functions() == want.functions()
        for a, b in zip(got.diagnoses, want.diagnoses):
            np.testing.assert_array_equal(a.abnormality.patterns,
                                          b.abnormality.patterns)
            np.testing.assert_array_equal(a.abnormality.workers,
                                          b.abnormality.workers)
        assert got.report() == want.report()
    else:
        batch, got = _tree_diagnose(CollectorTree, RefDaemon,
                                    PerfTrackerService(**SVC), ref_prof, 4)
        assert_same_diagnosis(got, want)
        assert got.report() == want.report()
    assert batch.complete and batch.pattern_bytes == want.pattern_bytes
