"""The port's serving engine and serving workload against the JAX reference.

``Engine.generate`` at a reduced gemma2-2b (2 layers, d_model 64, f32) with
the reference's weights carried across (``params_from_reference``): greedy
tokens equal, every step's logits within 1e-5 of the largest; sampling
deterministic per seed.  ``RequestGen`` delays bit-equal, ``merge_slo_samples``
and ``synth_serve_anchors`` equal.  A real serving window's structure, and
its diagnosis in fleet and wire mode equal to each other and to the
reference's on the same profiles; a window recorded as the card records it
(no sampled stream for the decode and KV frames) diagnosed by both packages
identically.  The live-fault scenarios are in
tests/test_torch_serve_scenarios.py and tests/test_torch_serve_stall.py.
The port runs on the CPU here.
"""
import jax
import numpy as np
import pytest

from repro.configs.registry import ARCHS as R_ARCHS
from repro.configs.registry import reduced as r_reduced
from repro.core.events import FunctionEvent as RefEvent
from repro.core.events import Kind as RefKind
from repro.core.events import SampleStream as RefStream
from repro.core.events import WorkerProfile as RefProfile
from repro.core.service import PerfTrackerService as RefService
from repro.models.transformer import Transformer as RTransformer
from repro.serve import workload as RW
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.core.events import profile_from_reference
from repro_torch.core.service import PerfTrackerService
from repro_torch.models.convert import params_from_reference
from repro_torch.serve import workload as W
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.workload import (CacheThrash, DecodeStall,
                                        DECODE_STEP, KV_READ, QUEUE_WAIT,
                                        RequestGen, ServeWorkload)

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401
from test_torch_fleet import assert_same_diagnosis

LOGIT_TOL = 1e-5       # relative to max(1, |largest logit|), as the
#                        decode parity test of tests/test_torch_model.py


def _engines(batch=2, max_len=32, **sc):
    rcfg, cfg = r_reduced(R_ARCHS["gemma2-2b"]), reduced(ARCHS["gemma2-2b"])
    rparams = RTransformer(rcfg).init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                          rparams), cfg,
                                   device="cpu")
    return (RefEngine(rcfg, rparams, RefServeConfig(batch=batch,
                                                     max_len=max_len, **sc)),
            Engine(cfg, params, ServeConfig(batch=batch, max_len=max_len,
                                            **sc), device="cpu"))


def _record(engine, as_numpy):
    logits, step = [], engine._step

    def recording(*args):
        out = step(*args)
        logits.append(as_numpy(out[0]))
        return out
    engine._step = recording
    return logits


def test_greedy_generate_matches_the_reference():
    ref, port = _engines()
    prompts = np.random.default_rng(5).integers(
        0, port.cfg.vocab_size, (2, 8)).astype(np.int32)
    ref_logits = _record(ref, np.asarray)
    logits = _record(port, lambda t: t.numpy())
    want = ref.generate(prompts, 16)
    got = port.generate(prompts, 16)
    assert got.dtype == np.int32 and got.shape == (2, 24)
    np.testing.assert_array_equal(got, want)
    assert len(logits) == len(ref_logits) == 23
    for a, b in zip(logits, ref_logits):
        assert np.abs(a - b).max() <= LOGIT_TOL * max(1.0, np.abs(b).max())


def test_sampling_is_deterministic_per_seed():
    _, port = _engines(temperature=0.8, seed=3)
    prompts = np.random.default_rng(5).integers(
        0, port.cfg.vocab_size, (2, 4)).astype(np.int32)
    a = port.generate(prompts, 12)
    np.testing.assert_array_equal(a, port.generate(prompts, 12))
    np.testing.assert_array_equal(a[:, :4], prompts)
    port.sc.seed = 4
    assert not np.array_equal(a, port.generate(prompts, 12))
    assert ((0 <= a) & (a < port.cfg.vocab_size)).all()


def test_perftracker_fences_every_decode_step():
    _, port = _engines(perftracker=True)
    tracer = port.pt.tracer
    tracer.start_window()
    port.generate(np.zeros((2, 3), np.int32), 5)
    prof = tracer.stop_window()
    steps = [e for e in prof.events if e.name == "decode.step"]
    assert len(steps) == 3 + 5 - 1
    assert all(int(e.kind) == 0 and e.depth == 1 for e in steps)


# -- the request generator and the merges -------------------------------------

def test_request_gen_delays_bit_equal_to_the_reference():
    for kw in ({}, {"max_delay_s": 0.2}):
        a, b = RequestGen(10.0, seed=3, **kw), RW.RequestGen(10.0, seed=3,
                                                             **kw)
        seq = [(0.03, 1.0)] * 30 + [(0.05, 8.0)] * 40 + [(0.01, 1.0)] * 10
        for service, mult in seq:
            a.burst_mult = b.burst_mult = mult
            assert a.delay(service) == b.delay(service)


def test_merges_equal_the_reference():
    rng = np.random.default_rng(2)
    per = [[tuple(rng.uniform(0, 1, 2)) for _ in range(n)]
           for n in (5, 3, 5, 0)]
    durs = list(rng.uniform(0.1, 0.3, 5))
    assert W.merge_slo_samples(per, durs, 1.5) == \
        RW.merge_slo_samples(per, durs, 1.5)
    assert W.synth_serve_anchors(durs, 0.25) == \
        RW.synth_serve_anchors(durs, 0.25)
    assert W.merge_slo_samples([], [], 0.0) == []


def test_tiny_serve_setup_matches_the_reference(monkeypatch):
    monkeypatch.setenv("REPRO_SERVE_LAYERS", "4")
    monkeypatch.setenv("REPRO_SERVE_BATCH", "3")
    cfg, sc, p, n = W.tiny_serve_setup()
    rcfg, rsc, rp, rn = RW.tiny_serve_setup()
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size, sc.batch,
            sc.max_len, p, n) == (rcfg.num_layers, rcfg.d_model,
                                  rcfg.vocab_size, rsc.batch, rsc.max_len,
                                  rp, rn)


# -- real serving windows -----------------------------------------------------

@pytest.fixture(scope="module")
def wl4():
    wl = ServeWorkload(n_workers=4, device="cpu")
    wl._ensure_workers()
    yield wl
    wl.close()


def test_serve_window_structure(wl4):
    wd = wl4.run_window(0, [], 3, None)
    assert [n for n, _ in wd.anchors] == \
        ["request.dequeue", "request.complete"] * 3
    ts = [t for _, t in wd.anchors]
    assert all(a < b + 1e-9 for a, b in zip(ts, ts[1:]))
    assert len(wd.profiles) == 4
    for prof in wd.profiles:
        assert set(prof.streams) == {"cpu"}
        top = [e.name for e in prof.events if e.depth == 1]
        assert top.count(QUEUE_WAIT) == 3 and top.count(DECODE_STEP) >= 3
        assert all(e.resource == "cpu" for e in prof.events
                   if e.name == DECODE_STEP)
    slo = wd.metrics["slo"]
    assert len(slo) == 3
    assert all(wd.t0 <= t <= wd.clock + 1e-9 for t, _, _ in slo)
    assert all(ttft > 0 and tbt > 0 for _, ttft, tbt in slo)
    assert wd.numerics == []


def to_reference(p) -> RefProfile:
    """A port profile in the reference's types (attribute by attribute)."""
    return RefProfile(
        worker=p.worker, window=tuple(p.window),
        events=[RefEvent(e.name, RefKind(int(e.kind)), e.start, e.end,
                         e.worker, thread=e.thread, depth=e.depth,
                         resource=e.resource) for e in p.events],
        streams={k: RefStream(s.rate_hz, s.t0, s.values)
                 for k, s in p.streams.items()})


def test_fleet_wire_parity_on_serve_profiles(wl4):
    wd = wl4.run_window(0, [CacheThrash(workers=())], 8, None)
    svc = PerfTrackerService(family="host", summarize_backend="numpy",
                             device="cpu")
    fleet = svc.diagnose_profiles(wd.profiles, mode="fleet")
    assert KV_READ in fleet.functions()
    wire = svc.diagnose_profiles(wd.profiles, mode="wire")
    assert_same_diagnosis(wire, fleet)
    ref = [to_reference(p) for p in wd.profiles]
    ref_wire = RefService(family="host", summarize_backend="numpy") \
        .diagnose_profiles(ref, mode="wire")
    assert_same_diagnosis(wire, ref_wire)
    assert wire.pattern_bytes == ref_wire.pattern_bytes


@pytest.mark.parametrize("fault", ["DecodeStall", "CacheThrash"])
def test_window_without_device_stream_diagnosed_as_reference(wl4, fault,
                                                             monkeypatch):
    """A window recorded as the card records it: the decode and KV frames
    name no sampled stream (resource ``""``), so their patterns are beta
    only.  Both packages give it the same diagnosis and plans.  What it is:
    ``kv_cache.read_block`` on every worker still leaves its expectation
    box under ``CacheThrash``; under ``DecodeStall`` the
    stalled worker's ``decode.step`` fills the same ~all of each request as
    a healthy one's, so without a mu the window flags no ``decode.step``
    on worker 2."""
    for sw in wl4.workers:
        monkeypatch.setattr(sw, "_res", "")
    f = DecodeStall(workers=(2,)) if fault == "DecodeStall" \
        else CacheThrash(workers=())
    wd = wl4.run_window(0, [f], 8, None)
    assert all(e.resource == "" for p in wd.profiles for e in p.events
               if e.name in (DECODE_STEP, KV_READ))
    ref = [to_reference(p) for p in wd.profiles]
    want = RefService(family="host").diagnose_profiles(ref, mode="fleet")
    got = PerfTrackerService(family="host", device="cpu").diagnose_profiles(
        [profile_from_reference(p) for p in ref], mode="fleet")
    assert_same_diagnosis(got, want, patterns_atol=1e-6)
    flagged = {d.abnormality.function: d.abnormality.workers.tolist()
               for d in got.diagnoses}
    for d in got.diagnoses:
        if d.abnormality.function in (DECODE_STEP, KV_READ):
            np.testing.assert_array_equal(d.abnormality.patterns[:, 1:], 0)
    if fault == "CacheThrash":
        assert flagged.get(KV_READ) == [0, 1, 2, 3]
    else:
        assert flagged.get(DECODE_STEP) != [2]


@pytest.mark.serve
@pytest.mark.timeout(120)
def test_decode_stall_without_device_stream_stays_unlocalized(monkeypatch):
    """``DecodeStall`` end to end as the card records it (no sampled stream
    for the decode and KV frames): no window flags ``decode.step``, so no
    incident is localized to it and none is confirmed with a plan (the slo
    trigger still opens one).  ``chip_smoke.py``'s ``[serve fleet]``
    asserts this answer on the card."""
    from repro_torch.online import ScenarioRunner, ScheduledFault
    from repro_torch.train.workload import default_trainer_detector_cfg
    wl = ServeWorkload(n_workers=4, device="cpu")
    wl._ensure_workers()
    for sw in wl.workers:
        monkeypatch.setattr(sw, "_res", "")
    res = ScenarioRunner(
        None, [ScheduledFault(DecodeStall(workers=(2,)), 2, 7)],
        n_windows=7, iters_per_window=8,
        detector_cfg=default_trainer_detector_cfg(8), workload=wl,
        device="cpu").run()
    wl.close()
    assert not any(DECODE_STEP in r.functions() for r in res.reports)
    assert not any(i.function == DECODE_STEP or i.plans
                   for i in res.incidents)
    assert any(i.channel == "slo" for i in res.incidents)
