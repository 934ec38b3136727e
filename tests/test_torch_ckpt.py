"""The port's checkpoints, recovery and chronic-fault memory against the JAX
reference, on the CPU.

* Format: for the same tree (bf16, f32 and int32 leaves, a nested dict and
  a list) both packages write byte-identical ``meta.json`` and ``.npy``
  files, and each restores the other's checkpoint to equal arrays.
* The cases of tests/test_recovery.py on the port: a torn step directory is
  never "latest", stale ``.tmp_step_*`` are swept, retention keeps the last
  valid steps; ``RecoveryManager`` rollbacks are verified bit for bit or
  fail honestly; the engine's checkpoint verbs act on real state; the
  rollback scenarios give the reference's runs window by window; the
  incident history (both packages read each other's store) re-ranks a
  restarted run's ladder.
* The trainer: ``ckpt_dir``/``ckpt_every`` save and resume, and a 4-worker
  ``TrainerWorkload`` under ``ParamCorruption`` resolves through a real
  ``ROLLBACK_TO_CHECKPOINT`` (the twin of
  tests/test_train_workload.py::test_param_corruption_resolved_by_real_rollback).
The port always runs with ``device="cpu"`` here.
"""
import json
from dataclasses import replace

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import Checkpointer as RCheckpointer
from repro.core import faults as RF
from repro.core.mitigation import Action as RAction
from repro.core.simulation import SimConfig as RSimConfig
from repro.online import EscalationPolicy as REsc
from repro.online import ScenarioRunner as RRunner
from repro.online import ScheduledFault as RSched
from repro.online.history import IncidentHistory as RHistory

from repro_torch.ckpt import (Checkpointer, CheckpointError, RecoveryManager,
                              SimTrainState)
from repro_torch.core import faults as F
from repro_torch.core.mitigation import Action, MitigationPlan
from repro_torch.core.simulation import GEMM, SimConfig
from repro_torch.online import (ESCALATED, RESOLVED, EscalationPolicy,
                                ScenarioRunner, ScheduledFault)
from repro_torch.online.history import IncidentHistory
from repro_torch.online.mitigation import MitigationEngine
from repro_torch.models.transformer import param_leaves
from repro_torch.train.loop import Trainer
from repro_torch.train.workload import (ParamCorruption, TrainerWorkload,
                                        default_trainer_detector_cfg,
                                        tiny_train_setup)

from _torch_trace import run_trace
# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

W, N_STANDBY, INJECT = 24, 4, 2
BASE_HZ, FULL_HZ = 250.0, 2000.0
LOSS_FN = "numerics.loss"
IPW = 8                       # iterations per profiling window


def _tree(v=1.0):
    return {"w": torch.full((4,), v), "b": torch.zeros(2)}


# -- the on-disk format, across the packages -----------------------------------

def _mixed_trees(seed=0):
    """The same tree in both packages' types: bf16, f32 and int32 leaves, a
    nested dict and a list (dict keys out of order on purpose)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    bf = rng.standard_normal((4, 2)).astype(np.float32)
    ids = rng.integers(-50, 50, (6,)).astype(np.int32)
    lst = [rng.standard_normal(3).astype(np.float32) for _ in range(3)]
    ref = {"zeta": {"w": w, "bf": bf.astype(ml_dtypes.bfloat16)},
           "ids": ids, "layers": [{"x": x} for x in lst],
           "step": np.asarray(7, np.int32)}
    port = {"zeta": {"w": torch.from_numpy(w),
                     "bf": torch.from_numpy(bf).to(torch.bfloat16)},
            "ids": torch.from_numpy(ids),
            "layers": [{"x": torch.from_numpy(x)} for x in lst],
            "step": torch.tensor(7, dtype=torch.int32)}
    return ref, port


def _as_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return leaf.numpy()
    return np.asarray(jax.device_get(leaf))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{prefix}/{i}")
    else:
        yield prefix, _as_numpy(tree)


def _assert_trees_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_both_packages_write_byte_identical_files(tmp_path):
    ref, port = _mixed_trees()
    RCheckpointer(str(tmp_path / "ref")).save(3, ref, extra={"a": 1},
                                              async_=False)
    Checkpointer(str(tmp_path / "port")).save(3, port, extra={"a": 1},
                                              async_=False)
    rd, pd = tmp_path / "ref" / "step_3", tmp_path / "port" / "step_3"
    names = sorted(p.name for p in rd.iterdir())
    assert names == sorted(p.name for p in pd.iterdir())
    assert "layers__1__x.npy" in names and "zeta__bf.npy" in names
    for name in names:
        assert (rd / name).read_bytes() == (pd / name).read_bytes(), name
    meta = json.loads((pd / "meta.json").read_text())
    assert list(meta["leaves"]) == ["ids", "layers/0/x", "layers/1/x",
                                    "layers/2/x", "step", "zeta/bf", "zeta/w"]
    assert meta["leaves"]["zeta/bf"] == {"shape": [4, 2], "dtype": "bfloat16"}


def test_each_package_restores_the_others_checkpoint(tmp_path):
    ref, port = _mixed_trees(seed=1)
    Checkpointer(str(tmp_path / "port")).save(5, port, async_=False)
    RCheckpointer(str(tmp_path / "ref")).save(5, ref, async_=False)
    # the reference reads the port's files ...
    got, meta = RCheckpointer(str(tmp_path / "port")).restore(5, ref)
    assert meta["step"] == 5
    _assert_trees_equal(got, ref)
    # ... and the port the reference's, onto the template's dtypes
    _, template = _mixed_trees(seed=2)
    got, meta = Checkpointer(str(tmp_path / "ref")).restore(5, template)
    assert meta["step"] == 5
    assert got["zeta"]["bf"].dtype == torch.bfloat16
    _assert_trees_equal(got, port)


def test_restore_follows_template_and_rejects_misfits(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.arange(4, dtype=torch.float32)}, async_=False)
    got, _ = ck.restore(1, {"w": torch.zeros(4, dtype=torch.float64)})
    assert got["w"].dtype == torch.float64
    assert got["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(CheckpointError, match="shape"):
        ck.restore(1, {"w": torch.zeros(5)})
    with pytest.raises(CheckpointError, match="no leaf"):
        ck.restore(1, {"v": torch.zeros(4)})


def test_async_save_copies_before_in_place_updates(tmp_path):
    ck = Checkpointer(str(tmp_path))
    live = torch.ones(1000)
    ck.save(1, {"w": live})
    live.mul_(3.0)              # an optimizer step in place, mid-write
    got, _ = ck.restore(1, {"w": torch.zeros(1000)})
    assert torch.equal(got["w"], torch.ones(1000))


# -- Checkpointer hardening (tests/test_recovery.py) ---------------------------

def test_torn_dir_missing_meta_never_latest(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree(), async_=False)
    (tmp_path / "step_9").mkdir()
    assert ck.steps() == [5] and ck.latest_step() == 5


def test_torn_dir_missing_leaf_never_latest(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree(), async_=False)
    ck.save(9, _tree(2.0), async_=False)
    (tmp_path / "step_9" / "w.npy").unlink()
    assert ck.latest_step() == 5
    with pytest.raises(CheckpointError, match="partial write"):
        ck.restore(9, _tree())


def test_corrupt_meta_never_latest(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree(), async_=False)
    (tmp_path / "step_5" / "meta.json").write_text("{not json")
    assert ck.latest_step() is None
    with pytest.raises(CheckpointError, match="corrupt meta.json"):
        ck.restore(5, _tree())


def test_unreadable_leaf_raises_checkpoint_error(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree(), async_=False)
    (tmp_path / "step_5" / "w.npy").write_bytes(b"garbage")
    with pytest.raises(CheckpointError, match="unreadable leaf"):
        ck.restore(5, _tree())


def test_stale_tmp_dirs_swept_on_init(tmp_path):
    tmp = tmp_path / ".tmp_step_7"
    tmp.mkdir()
    (tmp / "w.npy").write_bytes(b"half a write")
    Checkpointer(str(tmp_path))
    assert not tmp.exists()


def test_retention_keeps_last_k_valid(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(float(s)), async_=False)
    assert ck.steps() == [3, 4]
    tree, meta = ck.restore(4, _tree())
    assert meta["step"] == 4
    assert torch.equal(tree["w"], torch.full((4,), 4.0))


# -- RecoveryManager ------------------------------------------------------------

def test_sim_state_matches_reference_seed():
    from repro.ckpt import SimTrainState as RSim
    ref, port = RSim(seed=3), SimTrainState(seed=3, device="cpu")
    np.testing.assert_array_equal(np.asarray(ref.params["w"]),
                                  port.params["w"].numpy())
    for _ in range(4):
        ref.advance()
        port.advance()
    assert port.step == ref.step == 4
    np.testing.assert_allclose(port.params["w"].numpy(),
                               np.asarray(ref.params["w"]), rtol=0,
                               atol=1e-6)


def test_sim_rollback_roundtrip_verified(tmp_path):
    mgr = RecoveryManager.for_sim(seed=3, directory=str(tmp_path),
                                  save_every=3, device="cpu")
    for w in range(5):
        mgr.on_window(w)
    assert mgr.saved_steps == [0, 3]
    live_w = mgr.state.params["w"].clone()
    out = mgr.rollback()
    assert out.ok and out.verified
    assert out.step == 3 and out.lost_steps == 2 and out.restore_s > 0.0
    assert mgr.state.step == 3 and mgr.total_lost_steps == 2
    assert not torch.equal(mgr.state.params["w"], live_w)


def test_rollback_empty_dir_is_honest_failure(tmp_path):
    mgr = RecoveryManager.for_sim(seed=3, directory=str(tmp_path),
                                  save_every=0, device="cpu")
    for w in range(4):
        mgr.on_window(w)
    before = mgr.state.params["w"].clone()
    out = mgr.rollback()
    assert not out.ok and not out.verified
    assert "no valid checkpoint" in out.error
    assert torch.equal(mgr.state.params["w"], before)


def test_rollback_all_dirs_torn_is_honest_failure(tmp_path):
    mgr = RecoveryManager.for_sim(seed=3, directory=str(tmp_path),
                                  save_every=1, device="cpu")
    mgr.on_window(0)
    mgr.ckpt.wait()
    (tmp_path / "step_0" / "meta.json").unlink()
    out = mgr.rollback()
    assert not out.ok and "no valid checkpoint" in out.error


def test_close_removes_the_temporary_directory():
    mgr = RecoveryManager.for_sim(seed=3, device="cpu", save_every=1)
    mgr.on_window(0)
    d = mgr.ckpt.dir
    mgr.close()
    assert not d.exists()


# -- the engine: real verbs, honest failure -------------------------------------

def _engine(tmp_path, save_every, schedule=()):
    mgr = RecoveryManager.for_sim(seed=3, directory=str(tmp_path),
                                  save_every=save_every, device="cpu")
    eng = MitigationEngine(None, list(schedule), recovery=mgr)
    return mgr, eng


def test_engine_checkpoint_now_actually_saves(tmp_path):
    mgr, eng = _engine(tmp_path, 0)
    for w in range(3):
        eng.begin_window(w)
    rec = eng.apply(MitigationPlan(Action.CHECKPOINT_NOW, [], "save"), 3)
    assert rec.checkpoint_step == 3
    mgr.ckpt.wait()
    assert mgr.ckpt.latest_step() == 3


def test_engine_rollback_restores_and_cures(tmp_path):
    _, eng = _engine(tmp_path, 3, [ScheduledFault(F.LossSpike(), 0, 10)])
    for w in range(5):
        eng.begin_window(w)
    rec = eng.apply(MitigationPlan(Action.ROLLBACK_TO_CHECKPOINT, [],
                                   "restore"), 4)
    assert not rec.rollback_failed and rec.rollback_verified
    assert rec.restored_step == 3 and rec.lost_steps == 2
    assert rec.cured == ["LossSpike"] and eng.faults_at(5) == []


def test_engine_failed_rollback_cures_nothing(tmp_path):
    _, eng = _engine(tmp_path, 0, [ScheduledFault(F.LossSpike(), 0, 10)])
    for w in range(5):
        eng.begin_window(w)
    rec = eng.apply(MitigationPlan(Action.ROLLBACK_TO_CHECKPOINT, [],
                                   "restore"), 4)
    assert rec.rollback_failed and not rec.rollback_verified
    assert rec.restored_step is None and rec.cured == []
    assert [type(f).__name__ for f in eng.faults_at(5)] == ["LossSpike"]


def test_bare_engine_keeps_label_cure_semantics():
    eng = MitigationEngine(None, [ScheduledFault(F.LossSpike(), 0, 10)])
    rec = eng.apply(MitigationPlan(Action.ROLLBACK_TO_CHECKPOINT, [],
                                   "restore"), 4)
    assert not rec.rollback_failed and rec.cured == ["LossSpike"]


# -- rollback scenarios and the history store, against the reference -----------

def _mitigated(port, schedule, n_windows, **kw):
    """tests/test_mitigation.py's deployment in either package."""
    Esc, Runner, Cfg = ((EscalationPolicy, ScenarioRunner, SimConfig) if port
                        else (REsc, RRunner, RSimConfig))
    if port:
        kw["device"] = "cpu"
    return Runner(Cfg(n_workers=W, window_s=1.0, rate_hz=FULL_HZ, seed=5,
                      n_standby=N_STANDBY), schedule, n_windows=n_windows,
                  escalation=Esc(n_workers=W + N_STANDBY,
                                 base_rate_hz=BASE_HZ, full_rate_hz=FULL_HZ),
                  mitigation=True, verify_windows=2, settle_windows=1, **kw)


def _both(port_sched, ref_sched, n_windows=12, port_kw=None, ref_kw=None):
    ref = _mitigated(False, ref_sched, n_windows, **(ref_kw or {}))
    port = _mitigated(True, port_sched, n_windows, **(port_kw or {}))
    rres, pres = ref.run(), port.run()
    assert run_trace(port, pres) == run_trace(ref, rres)
    return port, pres


def test_scenario_rollback_without_checkpoints_escalates():
    from repro.ckpt import RecoveryManager as RRecovery
    mgr = RecoveryManager.for_sim(seed=5, device="cpu", save_every=0)
    runner, res = _both(
        [ScheduledFault(F.LossSpike(), INJECT, 12)],
        [RSched(RF.LossSpike(), INJECT, 12)],
        port_kw={"recovery": mgr},
        ref_kw={"recovery": RRecovery.for_sim(seed=5, save_every=0)})
    inc = next(i for i in res.incidents if i.function == LOSS_FN)
    assert inc.state == ESCALATED
    rolls = [m for m in runner.engine.log
             if m.plan.action is Action.ROLLBACK_TO_CHECKPOINT]
    assert rolls and all(m.rollback_failed and m.cured == [] for m in rolls)
    mgr.close()


def test_scenario_rollback_with_checkpoints_resolves():
    runner, res = _both([ScheduledFault(F.LossSpike(), INJECT, 12)],
                        [RSched(RF.LossSpike(), INJECT, 12)])
    inc = next(i for i in res.incidents if i.function == LOSS_FN)
    assert inc.state == RESOLVED
    m = next(m for m in runner.engine.log
             if m.plan.action is Action.ROLLBACK_TO_CHECKPOINT)
    assert not m.rollback_failed and m.rollback_verified
    assert m.restored_step is not None and m.lost_steps > 0
    assert runner.engine.recovery.saved_steps
    runner.engine.recovery.close()


def _record(h):
    h.record("perf", GEMM, (3, 11), "resolved",
             [{"action": "replace_hosts", "rung": 0, "ok": False},
              {"action": "flag_code_for_optimization", "rung": 1,
               "ok": True}])


def test_history_store_is_shared_with_reference(tmp_path):
    _record(IncidentHistory(tmp_path / "port.jsonl"))
    _record(RHistory(tmp_path / "ref.jsonl"))
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    with (tmp_path / "ref.jsonl").open("a") as f:
        f.write('{"channel": "perf", "torn')        # crashed writer
    h = IncidentHistory(tmp_path / "ref.jsonl")
    assert len(h.records) == 1
    assert h.successful_action("perf", GEMM, (11, 40)) == \
        "flag_code_for_optimization"
    assert h.action_stats("perf", GEMM, (3,)) == {
        "replace_hosts": (0, 1), "flag_code_for_optimization": (1, 0)}


def test_history_matching_is_signature_overlap(tmp_path):
    h = IncidentHistory(tmp_path / "i.jsonl")
    h.record("perf", GEMM, (3, 11), "resolved",
             [{"action": "flag_code_for_optimization", "rung": 0,
               "ok": True}])
    assert h.successful_action("perf", GEMM, (11,)) == \
        "flag_code_for_optimization"
    assert h.successful_action("perf", GEMM, ()) == \
        "flag_code_for_optimization"
    assert h.successful_action("perf", GEMM, (7,)) is None
    assert h.successful_action("numerics", GEMM, (3,)) is None
    assert h.successful_action("perf", "other.fn", (3,)) is None


def test_history_rerank_moves_winner_first(tmp_path):
    h = IncidentHistory(tmp_path / "i.jsonl")
    plans = [MitigationPlan(Action.REPLACE_HOSTS, [3, 11], "drop"),
             MitigationPlan(Action.FLAG_CODE, [], "flag")]
    ranked, chronic = h.rerank(list(plans), "perf", GEMM, (3, 11))
    assert ranked == plans and not chronic
    _record(h)
    ranked, chronic = h.rerank(list(plans), "perf", GEMM, (3, 11))
    assert [p.action for p in ranked] == [Action.FLAG_CODE,
                                          Action.REPLACE_HOSTS]
    assert chronic


def test_restarted_run_starts_at_the_rung_that_worked(tmp_path):
    """Run 1 learns (wrong plan first, one escalation, flag_code cures); run
    2, a restarted job on the same store, re-ranks the ladder and resolves
    at rung 0 with zero escalations.  Both runs equal the reference's
    window by window, and the two packages' stores end byte-identical."""
    def sched(port):
        if port:
            return [ScheduledFault(F.GpuThrottle(workers=(3, 11)), INJECT,
                                   14, cures=(Action.FLAG_CODE,))]
        return [RSched(RF.GpuThrottle(workers=(3, 11)), INJECT, 14,
                       cures=(RAction.FLAG_CODE,))]

    traces, incs = {}, []
    for port, hist in ((False, RHistory), (True, IncidentHistory)):
        path = tmp_path / f"{port}.jsonl"
        for run in range(2):
            r = _mitigated(port, sched(port), 14, history=hist(path))
            res = r.run()
            traces.setdefault(run, []).append(run_trace(r, res))
            if port:
                incs.append(next(i for i in res.incidents
                                 if i.function == GEMM))
    assert (tmp_path / "True.jsonl").read_bytes() == \
        (tmp_path / "False.jsonl").read_bytes()
    assert traces[0][0] == traces[0][1] and traces[1][0] == traces[1][1]
    assert incs[0].state == RESOLVED and incs[0].escalations == 1
    assert not incs[0].chronic
    assert incs[1].state == RESOLVED and incs[1].escalations == 0
    assert incs[1].chronic
    assert [p.action for _, p in incs[1].applied] == [Action.FLAG_CODE]


def test_escalated_outcome_recorded_as_failures(tmp_path):
    path = tmp_path / "incidents.jsonl"
    _mitigated(True, [ScheduledFault(F.GpuThrottle(workers=(3, 11)), INJECT,
                                     9, cures=())], 13,
               history=IncidentHistory(path)).run()
    recs = IncidentHistory(path).records
    assert recs and recs[-1]["outcome"] == "escalated"
    assert all(not a["ok"] for a in recs[-1]["attempts"])


# -- the trainer ---------------------------------------------------------------

def test_trainer_checkpoint_save_resume_roundtrip(tmp_path):
    mc, dc, oc, tc = tiny_train_setup()
    tc = replace(tc, ckpt_every=5, ckpt_dir=str(tmp_path))
    tr = Trainer(mc, dc, oc, tc, device="cpu")
    params, opt_state, _ = tr.init_state()
    for _ in range(10):
        params, opt_state, _ = tr.train_iteration(params, opt_state)
    tr.ckpt.wait()
    tr.loader.close()
    assert tr.ckpt.steps() == [5, 10]
    tr2 = Trainer(mc, dc, oc, tc, device="cpu")
    p2, o2, start2 = tr2.init_state()
    assert start2 == 10 and int(o2["step"]) == 10
    assert torch.equal(p2["embed"]["table"], params["embed"]["table"])
    assert torch.equal(o2["master"]["embed"]["table"],
                       opt_state["master"]["embed"]["table"])
    tr2.loader.close()


def test_trainer_run_saves_and_resumes(tmp_path, capsys):
    mc, dc, oc, tc = tiny_train_setup()
    tc = replace(tc, ckpt_every=3, ckpt_dir=str(tmp_path), log_every=100)
    tr = Trainer(mc, dc, oc, tc, device="cpu")
    tr.run(steps=4)
    assert tr.ckpt.latest_step() == 4
    tr2 = Trainer(mc, dc, oc, tc, device="cpu")
    tr2.run(steps=2)
    assert tr2.ckpt.steps() == [3, 4, 6]


def _params(worker):
    return [t for _, t in param_leaves(worker.params)]


@pytest.fixture(scope="module")
def wl4():
    wl = TrainerWorkload(n_workers=4, device="cpu")
    wl._ensure_workers()
    yield wl
    wl.close()


def test_snapshot_install_roundtrip(wl4, tmp_path):
    step, tree = wl4.snapshot_state()
    assert sorted(tree) == ["0", "1", "2", "3"]
    ck = Checkpointer(str(tmp_path))
    ck.save(step, tree, async_=False)
    wl4.workers[2].corrupt_params(1e3, nan=True)
    assert not all(torch.isfinite(t).all() for t in
                   _params(wl4.workers[2]))
    restored, meta = ck.restore(step, wl4.snapshot_state()[1])
    wl4.install_state(meta["step"], restored)
    assert wl4.snapshot_state()[1]["2"]["params"] is restored["2"]["params"]
    assert all(torch.isfinite(t).all() for t in
               _params(wl4.workers[2]))


def test_param_corruption_resolved_by_real_rollback(wl4):
    """A live numerics fault (NaN planted) diverges the real trainers; the
    numerics incident's ROLLBACK_TO_CHECKPOINT rung restores the window-0
    checkpoint into them (bit-for-bit verified) and the incident resolves
    because the loss genuinely came back."""
    n_win = 8
    rec = RecoveryManager.for_workload(wl4, save_every=n_win)
    fault = ParamCorruption(workers=(1,), nan=True)
    r = ScenarioRunner(
        None, [ScheduledFault(fault, 2, n_win,
                              cures=(Action.ROLLBACK_TO_CHECKPOINT,))],
        n_windows=n_win, iters_per_window=IPW,
        detector_cfg=default_trainer_detector_cfg(IPW), workload=wl4,
        mitigation=True, recovery=rec, device="cpu")
    res = r.run()
    inc = next(i for i in res.incidents
               if i.channel == "numerics" and i.applied)
    assert inc.state == "resolved" and inc.escalations == 0
    assert inc.applied[0][1].action is Action.ROLLBACK_TO_CHECKPOINT
    m = next(m for m in r.engine.log
             if m.plan.action is Action.ROLLBACK_TO_CHECKPOINT)
    assert not m.rollback_failed and m.rollback_verified
    assert m.restored_step is not None and m.lost_steps > 0
    for tw in wl4.workers:
        assert all(torch.isfinite(t).all() for t in _params(tw))
    rec.close()
