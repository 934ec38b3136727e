"""The training cell with EROICA off (``drivers/train_plain.py``) at a toy
size on the CPU: each fault planted in the program underneath a whole run
turns ``correct`` false; the control and the planted faults read by
``control_readings`` fail the cell's limits where the program's own
readings pass them; a program without the span record runs the cell traced
and reads no span.  On the card, a traced run gives each phase's device
seconds, which together fit in the card's busy time."""
import time

import pytest
import torch

from perfbench.harness import context, run_cell
from perfbench.tests import toy

PLAIN = "train.mamba2-2.7b.plain"
SPAN_METRICS = {"train.forward_s", "train.backward_s",
                "train.optimizer_update_s", "train.to_device_s"}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return toy.toy_bench(tmp_path_factory.mktemp("bench"))


def _unchanged(monkeypatch):
    from repro_torch.optim.adamw import AdamW
    monkeypatch.setattr(AdamW, "update", lambda self, g, s, p: (
        p, s, {"lr": torch.zeros(()), "grad_norm": torch.zeros(())}))


def _wrap_grad(monkeypatch, wrap):
    from repro_torch.train import step
    orig = step._grad_fn
    monkeypatch.setattr(step, "_grad_fn", lambda model: wrap(orig(model)))


def _half_batch(monkeypatch):
    def wrap(g):
        def grad_step(params, batch):
            lab = batch["labels"].clone()
            lab[:, lab.shape[1] // 2:] = -1
            return g(params, {**batch, "labels": lab})
        return grad_step
    _wrap_grad(monkeypatch, wrap)


def _grad_altered(monkeypatch):
    def wrap(g):
        def grad_step(params, batch):
            grads, m = g(params, batch)
            mamba = grads["blocks"][0]["mamba"]
            mamba["w_x"] = mamba["w_x"] * 2
            return grads, m
        return grad_step
    _wrap_grad(monkeypatch, wrap)


@pytest.mark.parametrize("plant", [_unchanged, _half_batch, _grad_altered])
def test_a_fault_in_the_step_is_caught(bench, monkeypatch, plant):
    plant(monkeypatch)
    res = toy.run_toy(bench, PLAIN, seconds=0.1)
    assert not res["correct"], res["checks"]


def test_control_and_planted_faults_fail_the_limits(bench):
    from perfbench.drivers.train_plain import control_readings
    lim = toy.load_json(bench / "workloads" / f"{PLAIN}.json")["limits"]
    ctx = context(PLAIN, 2**31 + 21, False, bench_dir=bench, spec=toy.SPEC,
                  device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = control_readings(ctx, 0.0)
    finally:
        torch.set_num_threads(threads)
    assert all(r["program"][k] <= lim[k] for k in lim), r["program"]
    for name in ("control_fp8", "half_batch", "grad_altered"):
        assert any(r[name][k] > lim[k] for k in lim), (name, r[name])


def test_a_program_without_the_span_record_runs_the_cell(bench,
                                                         monkeypatch):
    from repro_torch.instrument import tracer
    monkeypatch.delattr(tracer, "record_spans")
    res = toy.run_toy(bench, PLAIN, trace=True, seconds=0.1)
    assert res["correct"], res
    assert "train.tokens_per_s" in res["metrics"]
    assert not SPAN_METRICS & set(res["metrics"])


@pytest.mark.gpu
def test_traced_run_gives_each_phase_its_device_time(bench):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench.drivers.train_plain import TRACED_STEPS
    res = run_cell(PLAIN, 2**31 + 78, 0.5, True, bench_dir=bench,
                   spec=toy.SPEC, t_start=time.perf_counter(),
                   emit=lambda line: None)
    assert res["correct"], res
    m = {k: v["value"] for k, v in res["metrics"].items()}
    phases = [m[f"train.{p}_device_s"]
              for p in ("forward", "backward", "optimizer")]
    assert all(p > 0 for p in phases), m
    assert sum(phases) <= res["device"]["busy_s"] / TRACED_STEPS
    assert SPAN_METRICS <= set(m)
