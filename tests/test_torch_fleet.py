"""The port's fleet-mode diagnosis path against the JAX reference.

The six-fault matrix of tests/test_fleet.py and a healthy fleet, at W=32,
2 s, 2 kHz, seed 7: the port's simulator copy makes the reference's profiles;
its service on the ``numpy`` backend gives the reference's diagnoses bitwise;
on the ``torch`` backend (the plain version of kernel K1) the same
functions, kinds, workers, hints, reasons and plans, with patterns to 1e-6.
A 4-worker trainer window shaped as the card records it (step phases with
no sampled stream) gives the same diagnosis and plan order in both.
The port always runs on the CPU here.
"""
import numpy as np
import pytest

from repro.core import faults as RF
from repro.core.critical_path import fleet_critical_times as ref_fct
from repro.core.events import FunctionEvent as RefEvent
from repro.core.events import Kind as RefKind
from repro.core.events import SampleStream as RefStream
from repro.core.events import WorkerProfile as RefProfile
from repro.core.mitigation import plan_mitigations as ref_plans
from repro.core.service import PerfTrackerService as RefService
from repro.core.simulation import FleetSimulator as RefSim
from repro.core.simulation import SimConfig as RefConfig

from repro_torch.core import faults as F
from repro_torch.core.critical_path import fleet_critical_times
from repro_torch.core.events import profile_from_reference
from repro_torch.core.mitigation import plan_mitigations
from repro_torch.core.service import PerfTrackerService
from repro_torch.core.simulation import (ALLGATHER, DATALOADER_STACK,
                                         FORWARD_STACK, GC_STACK, GEMM,
                                         FleetSimulator, SimConfig)

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

#: (fault factory taking a faults module, expected function, kind value)
SCENARIOS = [
    pytest.param(lambda m: [m.GpuThrottle(workers=range(4))], GEMM, 0,
                 id="C1P1_gpu_throttle"),
    pytest.param(lambda m: [m.NvlinkDown(workers=[5], group_size=16)],
                 ALLGATHER, 2, id="C1P2_nvlink_down"),
    pytest.param(lambda m: [m.RingSlowLink(slow_worker=9, rho=0.4)],
                 ALLGATHER, 2, id="S3_ring_slow_link"),
    pytest.param(lambda m: [m.SlowDataloader()], DATALOADER_STACK, 3,
                 id="C2P1_slow_dataloader"),
    pytest.param(lambda m: [m.CpuBoundForward(workers=range(6))],
                 FORWARD_STACK, 3, id="C2P2_cpu_forward"),
    pytest.param(lambda m: [m.AsyncGc(probability=0.5)], GC_STACK, 3,
                 id="C2P3_async_gc"),
    pytest.param(lambda m: [], None, None, id="healthy"),
]


def _fleets(faults, seed=7):
    cfg = dict(n_workers=32, window_s=2.0, rate_hz=2000, seed=seed)
    ref = RefSim(RefConfig(**cfg), faults(RF)).profile_window()
    port = FleetSimulator(SimConfig(**cfg), faults(F)).profile_window()
    return ref, port


def _plans(plans):
    return [(p.action.value, list(p.workers), p.detail) for p in plans]


def assert_same_diagnosis(a, b, patterns_atol=None):
    """Same functions, kinds, workers, hints, reasons and plans; patterns
    and distances bitwise (``patterns_atol=None``) or to a tolerance."""
    assert len(a.diagnoses) == len(b.diagnoses)
    for da, db in zip(a.diagnoses, b.diagnoses):
        aa, bb = da.abnormality, db.abnormality
        assert aa.function == bb.function
        assert da.hint == db.hint
        assert aa.reason == bb.reason
        assert int(aa.kind) == int(bb.kind)
        np.testing.assert_array_equal(aa.workers, bb.workers)
        if patterns_atol is None:
            np.testing.assert_array_equal(aa.patterns, bb.patterns)
            np.testing.assert_array_equal(aa.d_expect, bb.d_expect)
            np.testing.assert_array_equal(aa.delta, bb.delta)
            np.testing.assert_array_equal(aa.typical, bb.typical)
        else:
            np.testing.assert_allclose(aa.patterns, bb.patterns,
                                       rtol=0, atol=patterns_atol)
    assert _plans(plan_mitigations(a.diagnoses, a.fleet_size)) == \
        _plans(ref_plans(b.diagnoses, b.fleet_size))


def _assert_profiles_equal(port, ref):
    conv = [profile_from_reference(p) for p in ref]
    assert len(port) == len(conv)
    for p, c in zip(port, conv):
        assert p.worker == c.worker and p.window == c.window
        assert p.events == c.events
        assert list(p.streams) == list(c.streams)
        for name, s in p.streams.items():
            assert (s.rate_hz, s.t0) == (c.streams[name].rate_hz,
                                         c.streams[name].t0)
            np.testing.assert_array_equal(s.values, c.streams[name].values)


@pytest.mark.parametrize("faults,expect,kind", SCENARIOS)
def test_simulator_copy_makes_reference_profiles(faults, expect, kind):
    ref, port = _fleets(faults)
    _assert_profiles_equal(port, ref)


@pytest.mark.parametrize("faults,expect,kind", SCENARIOS)
def test_numpy_backend_bitwise_equals_reference(faults, expect, kind):
    ref, port = _fleets(faults)
    want = RefService(summarize_backend="numpy").diagnose_profiles(ref)
    got = PerfTrackerService(summarize_backend="numpy",
                             device="cpu").diagnose_profiles(port)
    assert_same_diagnosis(got, want)
    if expect is None:
        assert got.functions() == []
    else:
        d = next(d for d in got.diagnoses if d.abnormality.function == expect)
        assert int(d.abnormality.kind) == kind


@pytest.mark.parametrize("faults,expect,kind", SCENARIOS)
def test_torch_backend_gives_reference_diagnosis(faults, expect, kind):
    ref, port = _fleets(faults)
    want = RefService(summarize_backend="numpy").diagnose_profiles(ref)
    svc = PerfTrackerService(device="cpu")
    assert svc.summarize_backend.name == "torch"
    assert_same_diagnosis(svc.diagnose_profiles(port), want,
                          patterns_atol=1e-6)


def test_critical_path_sweep_bitwise_equals_reference():
    ref, port = _fleets(SCENARIOS[5].values[0])
    assert fleet_critical_times(port) == ref_fct(ref)


def _ring_example(sim_cls, cfg_cls, faults, svc):
    """examples/diagnose_ring_fault.py's setup."""
    sim = sim_cls(cfg_cls(n_workers=32, window_s=2.0, rate_hz=2000, seed=11),
                  [faults.RingSlowLink(slow_worker=9, rho=0.5)])
    trig = svc.feed_anchors(sim.anchor_events(80, degrade_after=40))
    return trig, svc.diagnose_profiles(sim.profile_window(), trigger=trig)


def test_ring_fault_flags_worker_9_and_detector_agrees():
    trig, res = _ring_example(FleetSimulator, SimConfig, F,
                              PerfTrackerService(device="cpu"))
    ref_trig, ref_res = _ring_example(RefSim, RefConfig, RF, RefService())
    assert trig is not None
    assert (trig.reason, trig.time, trig.mean_duration, trig.baseline,
            trig.detail, trig.channel) == \
        (ref_trig.reason, ref_trig.time, ref_trig.mean_duration,
         ref_trig.baseline, ref_trig.detail, ref_trig.channel)
    d = next(d for d in res.diagnoses if d.abnormality.function == ALLGATHER)
    assert d.abnormality.workers.tolist() == [9]
    plans = plan_mitigations(res.diagnoses, 32)
    assert (plans[0].action.value, plans[0].workers) == ("replace_hosts", [9])
    assert_same_diagnosis(res, ref_res, patterns_atol=1e-6)


def test_wire_mode_and_batches_wait_for_the_transport_slice():
    """The transport slice is ported: ``mode="wire"`` and
    ``diagnose_batch`` give the fleet mode's diagnosis (the wider parity
    lives in tests/test_torch_wire.py); an unknown mode still raises."""
    _, port = _fleets(SCENARIOS[0].values[0])
    svc = PerfTrackerService(summarize_backend="numpy", device="cpu")
    fleet = svc.diagnose_profiles(port)
    wire = svc.diagnose_profiles(port, mode="wire")
    assert_same_diagnosis(wire, fleet)
    assert wire.transport["present"] == len(port)
    with pytest.raises(ValueError):
        svc.diagnose_profiles([], mode="bogus")


#: (dataloader.next, train.step, optimizer.step) seconds of one iteration:
#: healthy, and the faulty worker under each live fault.  They give the
#: betas the full-width trainer fleet of chip_smoke.py showed on an H100:
#: healthy 0.72 / 0.25 for the two step phases, StepThrottle's worker 2
#: 0.86 / 0.13, DataloaderBurn's worker 1 0.15 / 0.10.
TRAINER_HEALTHY = (0.003, 0.072, 0.025)
TRAINER_FAULTS = {"StepThrottle": (2, (0.003, 0.167, 0.025)),
                  "DataloaderBurn": (1, (0.360, 0.072, 0.048))}


def _trainer_window(fault, iters=8, rate_hz=100.0, seed=0):
    """One 4-worker trainer window in the reference's types, as the card
    records it: ``dataloader.next`` reads the cpu stream, the step phases
    carry resource ``""`` (no sampled device stream, so beta only)."""
    rng = np.random.default_rng(seed)
    bad, durations = TRAINER_FAULTS[fault]
    phases = (("dataloader.next", RefKind.PYTHON),
              ("train.step", RefKind.GPU), ("optimizer.step", RefKind.GPU))
    profiles = []
    for w in range(4):
        t, events = 0.0, []
        for _ in range(iters):
            for (name, kind), d in zip(phases, durations if w == bad
                                       else TRAINER_HEALTHY):
                d *= 1.0 + 0.02 * rng.standard_normal()
                events.append(RefEvent(name, kind, t, t + d, worker=w,
                                       depth=1))
                t += d
        times = np.arange(int(np.ceil(t * rate_hz))) / rate_hz
        cpu = rng.uniform(0.05, 0.15, times.size)
        for e in events:
            if e.name == "dataloader.next":
                inside = (times >= e.start) & (times < e.end)
                cpu[inside] = rng.uniform(0.9, 1.0, int(inside.sum()))
        profiles.append(RefProfile(
            worker=w, window=(0.0, t), events=events,
            streams={"cpu": RefStream(rate_hz, 0.0, cpu.astype(np.float32))}))
    return profiles


@pytest.mark.parametrize("fault", sorted(TRAINER_FAULTS))
def test_trainer_window_without_device_stream_diagnosed_as_reference(fault):
    """The two trainer-fleet outcomes seen on the card are the reference's
    own: on this window both packages flag ``optimizer.step`` [2] (the
    differential rule) under StepThrottle, not ``train.step``, and rank
    ``replace_hosts [1]`` ahead of ``migrate_dataloader`` under
    DataloaderBurn."""
    ref = _trainer_window(fault)
    want = RefService(family="host").diagnose_profiles(ref, mode="fleet")
    got = PerfTrackerService(family="host", device="cpu").diagnose_profiles(
        [profile_from_reference(p) for p in ref], mode="fleet")
    assert_same_diagnosis(got, want, patterns_atol=1e-6)
    flagged = [(d.abnormality.function, d.abnormality.workers.tolist(),
                d.abnormality.reason) for d in got.diagnoses]
    plans = [(p.action.value, list(p.workers))
             for p in plan_mitigations(got.diagnoses, 4)]
    if fault == "StepThrottle":
        assert flagged == [("optimizer.step", [2], "differential")]
        assert plans == [("replace_hosts", [2])]
    else:
        assert flagged[0] == ("dataloader.next", [1],
                              "expectation+differential")
        assert plans == [("replace_hosts", [1]), ("migrate_dataloader", [])]
