"""The port's live trainer path against the JAX reference, on the CPU.

* ``Trainer.train_iteration`` from the reference's own parameters (carried
  across by ``params_from_reference``) gives the reference trainer's losses
  on the same byte-identical batches, within 1e-4; the loss falls over 30
  steps.
* The tracer records ``dataloader.next`` / ``train.step`` /
  ``optimizer.step`` in order, with the stream set ``{"cpu"}``.
* A 4-worker ``TrainerWorkload`` window under a live fault, diagnosed by the
  port's ``PerfTrackerService`` in fleet mode, localizes the fault as
  tests/test_train_workload.py does for the reference.
"""
import time
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.train.loop import Trainer as RTrainer
from repro.train.workload import tiny_train_setup as r_tiny_train_setup

from repro_torch.core.mitigation import Action, plan_ladder, plan_mitigations
from repro_torch.core.service import PerfTrackerService
from repro_torch.instrument.tracer import Tracer, sync
from repro_torch.models.convert import params_from_reference
from repro_torch.train.loop import Trainer
from repro_torch.train.workload import (DataloaderBurn, StepThrottle,
                                        TrainerWorkload, tiny_train_setup,
                                        trainer_worker_main)

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.train

IPW = 8                       # iterations per profiling window


@pytest.fixture(scope="module")
def wl4():
    wl = TrainerWorkload(n_workers=4, device="cpu")
    wl._ensure_workers()
    yield wl
    wl.close()


def test_train_iterations_match_reference_losses():
    rtr = RTrainer(*r_tiny_train_setup())
    rparams, ropt, _ = rtr.init_state()
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    rlosses = []
    for _ in range(3):
        rparams, ropt, m = rtr.train_iteration(rparams, ropt)
        rlosses.append(float(m["loss"]))
    rtr.loader.close()

    mc, dc, oc, tc = tiny_train_setup()
    tr = Trainer(mc, dc, oc, tc, device="cpu")
    params = params_from_reference(tree, mc, device="cpu")
    opt_state = tr.opt.init(params)
    losses = []
    for _ in range(30):
        params, opt_state, m = tr.train_iteration(params, opt_state)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    tr.loader.close()
    np.testing.assert_allclose(losses[:3], rlosses, rtol=0, atol=1e-4)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert int(opt_state["step"]) == 30


def test_tracer_phases_present_and_ordered(wl4):
    tw = wl4.workers[0]
    _, prof = tw.run_window(3)
    assert set(prof.streams) == {"cpu"}
    top = sorted((e for e in prof.events if e.depth == 1),
                 key=lambda e: e.start)
    assert [e.name for e in top] == \
        ["dataloader.next", "train.step", "optimizer.step"] * 3
    for a, b in zip(top, top[1:]):
        assert a.end <= b.start + 1e-9
    # no cost-model split of train.step (gemm_frac is None)
    assert tw.trainer.bundle.gemm_frac is None
    assert not [e for e in prof.events if e.name.startswith("xla.")]
    assert all(e.resource == "cpu" for e in top if e.name != "dataloader.next")
    assert prof.packed is not None


def test_dataloader_burn_window_localizes_worker_1(wl4):
    wd = wl4.run_window(0, [DataloaderBurn(workers=(1,))], IPW, None)
    assert len(wd.anchors) == 2 * IPW and len(wd.profiles) == 4
    svc = PerfTrackerService(family="host", device="cpu")
    res = svc.diagnose_profiles(wd.profiles, mode="fleet")
    flagged = {d.abnormality.function: d.abnormality.workers.tolist()
               for d in res.diagnoses}
    assert flagged.get("dataloader.next") == [1]
    d = next(d for d in res.diagnoses
             if d.abnormality.function == "dataloader.next")
    assert Action.MIGRATE_DATALOADER in [p.action
                                         for p in plan_ladder(d, 4)]
    assert Action.MIGRATE_DATALOADER in [
        p.action for p in plan_mitigations(res.diagnoses, 4)]
    # the numerics stream carries each iteration's real loss
    assert len(wd.metrics["numerics"]) == IPW
    assert all(np.isfinite(x[1]) for x in wd.metrics["numerics"])


def test_step_throttle_stalls_train_step_on_worker_2(wl4):
    """The stall lands inside worker 2's ``train.step`` spans, read against
    the cpu stream.  (Whether one window localizes it depends on how quiet
    the host is: a loaded CPU spreads the healthy workers' mu as widely as
    the stall does, so the diagnosis itself is checked on the card by
    ``chip_smoke.py``.)"""
    pad = 0.05
    wd = wl4.run_window(1, [StepThrottle(workers=(2,), pad_s=pad)], 3, None)
    for prof in wd.profiles:
        steps = [e for e in prof.events if e.name == "train.step"]
        assert len(steps) == 3
        assert all(e.resource == "cpu" for e in steps)
        if prof.worker == 2:
            assert all(e.end - e.start >= pad for e in steps)
    assert wl4.workers[2].trainer.step_pad_s == pad
    wl4.run_window(2, [], 1, None)
    assert wl4.workers[2].trainer.step_pad_s == 0.0


def test_trainer_without_cuda_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mc, dc, oc, tc = tiny_train_setup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(mc, dc, oc, tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainerWorkload(n_workers=1)
    tr = Trainer(mc, dc, oc, tc, device="cpu")
    assert tr.device.type == "cpu"
    tr.loader.close()


def test_parts_not_ported_raise():
    """Distributed training waits for its slice (checkpointing and
    ``ParamCorruption`` are ported: tests/test_torch_ckpt.py; so is the
    multi-process trainer worker, ``trainer_worker_main``:
    tests/test_torch_multiprocess_more.py; gradient accumulation:
    tests/test_torch_remat.py)."""
    mc, dc, oc, tc = tiny_train_setup()
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        Trainer(mc, dc, oc, tc, dist=object(), device="cpu")
    assert callable(trainer_worker_main)


def test_run_with_perftracker_attached(capsys):
    mc, dc, oc, tc = tiny_train_setup()
    tr = Trainer(mc, dc, oc, replace(tc, perftracker=True, log_every=2),
                 device="cpu")
    tr.run(steps=4)
    assert [h["step"] for h in tr.history] == [1, 2, 4]
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert "step     4 loss" in capsys.readouterr().out
    assert tr.pt.service.device.type == "cpu"


def test_tracer_fence_and_default_stream():
    sync({"a": [torch.zeros(2)], "b": (torch.ones(1),)})   # nothing to wait
    tr = Tracer(worker=0, rate_hz=200.0)
    tr.start_window()
    with tr.phase("x", fence=lambda: torch.zeros(1)):
        time.sleep(0.02)
    prof = tr.stop_window()
    assert set(prof.streams) == {"cpu"}
    assert [e.name for e in prof.events] == ["x"]
