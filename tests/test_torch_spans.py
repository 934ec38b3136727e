"""The program's spans (``instrument/tracer.py::span``), on the CPU.

* With the record off and no profiler, a step records nothing and opens
  no profiler range.
* With the record on, every step records ``dataloader.to_device``,
  ``train.forward``, ``train.backward`` and ``optimizer.update`` once,
  each under the right parent: in ``train_iteration`` the batch copy sits
  inside the ``dataloader.next`` phase, the forward and the backward
  inside the ``train.step`` span and EROICA's ``train.step`` interval,
  AdamW inside the ``optimizer.step`` phase; the fused step's spans are
  top spans.
* Under ``torch.profiler`` the same names are host ranges of the trace.
* EROICA's profile and upload are the same with the record on and off,
  and so is the step's count (``launch.step_cost.count_step``), on real
  tensors and under the dry run's ``FakeTensorMode``.
* The modules that import the tracer import first in a fresh interpreter.

Imports no JAX.
"""
import itertools
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from repro_torch.instrument import tracer as T
from repro_torch.instrument.tracer import Tracer, record_spans, span
from repro_torch.launch.step_cost import count_step
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamW, OptConfig
from repro_torch.train.loop import Trainer
from repro_torch.train.step import make_split_train_step, make_train_step
from repro_torch.train.workload import tiny_train_setup

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"
STEP_SPANS = ("dataloader.to_device", "train.forward", "train.backward",
              "optimizer.update")


@pytest.fixture(autouse=True)
def record_off():
    record_spans(False)
    yield
    record_spans(False)


@pytest.fixture
def trainer():
    """A tiny trainer on the CPU whose step bundle is built (building it
    runs one counted step), with its state."""
    tr = Trainer(*tiny_train_setup(), device="cpu")
    params, opt_state, _ = tr.init_state()
    tr.ensure_bundle(params, tr._batch(tr.source.batch_at(0)))
    yield tr, params, opt_state
    tr.loader.close()


def _fused(tr, params, opt_state, steps):
    for _ in range(steps):
        params, opt_state, _ = tr._fused_step(
            params, opt_state, tr._batch(tr.loader.next()))
    return params, opt_state


def _one_span():
    with span("t"):
        pass


def test_span_parents_follow_nesting_on_each_thread():
    record_spans(True)
    with span("a"):
        with span("b"):
            pass
        with span("c"):
            th = threading.Thread(target=_one_span)
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
    held = record_spans(True)
    assert [(s.name, s.parent) for s in held] == [
        ("a", None), ("b", 0), ("c", 0), ("t", None)]
    a, b, c, _ = held
    assert a.start <= b.start <= b.end <= c.start <= c.end <= a.end
    assert record_spans(False) == []


def test_nothing_is_recorded_with_the_record_off(trainer, monkeypatch):
    tr, params, opt_state = trainer
    opened = []
    monkeypatch.setattr(T, "record_function",
                        lambda name: opened.append(name))
    monkeypatch.setattr(T, "Span", lambda *a, **k: opened.append(a))
    tracer = Tracer(samplers={})
    tracer.start_window()
    params, opt_state, _ = tr.train_iteration(params, opt_state, tracer)
    tracer.stop_window()
    _fused(tr, params, opt_state, 1)
    assert opened == [] and record_spans(False) == []


def test_each_step_records_its_spans_under_their_parents(trainer):
    tr, params, opt_state = trainer
    tracer = Tracer(samplers={})
    tracer.start_window()
    record_spans(True)
    for _ in range(3):
        params, opt_state, _ = tr.train_iteration(params, opt_state, tracer)
    held = record_spans(False)
    steps = [e for e in tracer.events if e.name == "train.step"]
    tracer.stop_window()
    names = [s.name for s in held]
    assert names == ["dataloader.next", "dataloader.to_device",
                     "train.step", "train.forward", "train.backward",
                     "optimizer.step", "optimizer.update"] * 3
    for i, s in enumerate(held):
        assert s.start <= s.end
        want = {"dataloader.to_device": "dataloader.next",
                "train.forward": "train.step",
                "train.backward": "train.step",
                "optimizer.update": "optimizer.step"}.get(s.name)
        assert (held[s.parent].name if s.parent is not None else None) \
            == want, (i, s)
    for k, step in enumerate(steps):
        fwd, bwd = held[7 * k + 3], held[7 * k + 4]
        assert step.start <= fwd.start <= fwd.end <= bwd.start \
            <= bwd.end <= step.end

    record_spans(True)
    _fused(tr, params, opt_state, 2)
    held = record_spans(False)
    assert [s.name for s in held] == list(STEP_SPANS) * 2
    assert all(s.parent is None for s in held)
    assert all(a.end <= b.start for a, b in zip(held, held[1:]))


def test_spans_are_host_ranges_under_the_profiler(trainer):
    from torch.profiler import ProfilerActivity, profile
    tr, params, opt_state = trainer
    tracer = Tracer(samplers={})
    tracer.start_window()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        params, opt_state, _ = tr.train_iteration(params, opt_state, tracer)
        _fused(tr, params, opt_state, 1)
    tracer.stop_window()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    for name in STEP_SPANS:
        assert names.count(name) == 2, name
    assert names.count("dataloader.next") == names.count(
        "optimizer.step") == 1
    assert record_spans(False) == []


def _profile_and_upload(tr, params, opt_state, monkeypatch, on):
    """Two ``train_iteration``s in one window, read on a clock that ticks
    1 ms at every call EROICA makes (the record's own reads go to the real
    clock), summarized and packed for upload."""
    from repro_torch.core.daemon import summarize_and_upload
    from repro_torch.summarize.base import get_backend
    real, ticks = time.perf_counter, itertools.count()

    def clock():
        if sys._getframe(1).f_code.co_name == "span":
            return real()
        return next(ticks) * 1e-3
    tracer = Tracer(samplers={})
    monkeypatch.setattr(time, "perf_counter", clock)
    try:
        record_spans(on)
        tracer.start_window()
        for _ in range(2):
            params, opt_state, _ = tr.train_iteration(params, opt_state,
                                                      tracer)
        prof = tracer.stop_window()
        held = record_spans(False)
    finally:
        monkeypatch.setattr(time, "perf_counter", real)
    return prof, summarize_and_upload(prof, backend=get_backend(
        "numpy", "cpu")), held


def test_profile_and_upload_are_the_same_with_the_record_on(trainer,
                                                            monkeypatch):
    tr, params, opt_state = trainer
    off, up_off, held_off = _profile_and_upload(tr, params, opt_state,
                                                monkeypatch, False)
    on, up_on, held_on = _profile_and_upload(tr, params, opt_state,
                                             monkeypatch, True)
    assert held_off == [] and len(held_on) == 14
    assert [e.name for e in off.events if e.depth == 1] == \
        ["dataloader.next", "train.step", "optimizer.step"] * 2
    assert {e.name for e in off.events if e.depth == 2} == {"xla.gemm",
                                                             "xla.other"}
    assert on.events == off.events and on.window == off.window
    assert on.streams == off.streams == {}
    assert up_on.payload == up_off.payload
    assert set(up_off.unpack()[0]) >= {"dataloader.next", "train.step",
                                       "optimizer.step"}


def _mamba_step():
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    cfg = reduced(ARCHS["mamba2-2.7b"])
    model = Transformer(cfg)
    batch = SyntheticLM(cfg, DataConfig(batch=1, seq_len=32)).batch_at(0)
    return model, {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_step_count_is_the_same_with_the_record_on(fake):
    """The step's count with the record on equals it with the record off,
    on CPU tensors through the split step's gradient, and under a
    ``FakeTensorMode`` through the fused step, as the dry run counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    model, batch = _mamba_step()
    opt = AdamW(OptConfig())
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else None

    def count():
        with mode if fake else torch.no_grad():
            params = model.init(0, device="cpu")
            b = {k: mode.from_tensor(v) for k, v in batch.items()} \
                if fake else batch
            if fake:
                step, state = make_train_step(model, opt), opt.init(params)
                return count_step(lambda a, _: step(*a), (params, state, b),
                                  None)
        grad_fn, _ = make_split_train_step(model, opt)
        return count_step(grad_fn, params, b)
    off = count()
    record_spans(True)
    on = count()
    held = record_spans(False)
    assert (on.flops, on.bytes, on.detail_flops, on.detail_bytes) == \
        (off.flops, off.bytes, off.detail_flops, off.detail_bytes)
    assert off.flops > 0
    want = ["train.forward", "train.backward"] + (
        ["optimizer.update"] if fake else [])
    assert [s.name for s in held] == want


@pytest.mark.parametrize("module", [
    "repro_torch.summarize", "repro_torch.optim.adamw",
    "repro_torch.train.step", "repro_torch.instrument.tracer"])
def test_module_imports_first_in_a_fresh_interpreter(module):
    out = subprocess.run(
        [sys.executable, "-c", f"import {module}"], capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
