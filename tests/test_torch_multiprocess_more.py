"""More of the port's ``run_multiprocess`` on the CPU (2 processes each):
the S3 ring cell of tests/test_wire.py flat and through a collector tree,
the closed mitigation loop across processes (plans ride ``window_start``
as ``plan_to_wire`` dicts, children replay them; the cell of
tests/test_mitigation.py, W = 24 + 4 standbys) against the in-process run,
and 4 real trainers in 2 processes under ``DataloaderBurn(workers=(1,))``
(the parent builds no model).  Split from tests/test_torch_multiprocess.py
so that ``--dist loadfile`` spreads the processes over two workers.
"""
import pytest

from repro.core import faults as RF

from repro_torch.core import faults as F
from repro_torch.core.mitigation import Action
from repro_torch.core.simulation import ALLGATHER, GEMM, SimConfig
from repro_torch.online import (EscalationPolicy, ScenarioRunner,
                                ScheduledFault)
from repro_torch.train.workload import (DataloaderBurn, TrainerWorkload,
                                        default_trainer_detector_cfg,
                                        tiny_train_setup)

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401
from test_torch_multiprocess import (assert_matches_inprocess,  # noqa: F401
                                     one_thread_children)


@pytest.mark.wire
@pytest.mark.timeout(120)
@pytest.mark.parametrize("n_shards", [None, 2], ids=["flat", "tree"])
def test_multiprocess_s3_ring_matches_inprocess(n_shards):
    assert_matches_inprocess(F.RingSlowLink(slow_worker=9, rho=0.4),
                             RF.RingSlowLink(slow_worker=9, rho=0.4),
                             ALLGATHER, {9}, n_shards=n_shards)


W, N_STANDBY, INJECT, VERIFY, SETTLE = 24, 4, 2, 2, 1


def make_mitigated(schedule):
    esc = EscalationPolicy(n_workers=W + N_STANDBY, base_rate_hz=250.0,
                           full_rate_hz=2000.0)
    return ScenarioRunner(
        SimConfig(n_workers=W, window_s=1.0, rate_hz=2000.0, seed=5,
                  n_standby=N_STANDBY),
        schedule, n_windows=12, escalation=esc, mitigation=True,
        verify_windows=VERIFY, settle_windows=SETTLE, device="cpu")


def _engine_trace(runner):
    return [(m.window, m.plan.action, tuple(m.plan.workers),
             tuple(m.cured), tuple(m.dropped), tuple(m.replacements))
            for m in runner.engine.log]


@pytest.mark.wire
@pytest.mark.timeout(120)
@pytest.mark.parametrize("n_shards", [None, 2], ids=["flat", "tree"])
def test_multiprocess_mitigation_matches_inprocess(n_shards):
    sched = [ScheduledFault(F.GpuThrottle(workers=(3, 11)), INJECT, 12)]
    runner_in = make_mitigated(sched)
    res_in = runner_in.run()
    runner_mp = make_mitigated(sched)
    res_mp = runner_mp.run_multiprocess(n_procs=2, n_shards=n_shards,
                                        window_timeout=60.0,
                                        auth_token="s3cret")
    assert [(i.function, i.state, i.escalations) for i in res_mp.incidents] \
        == [(i.function, i.state, i.escalations) for i in res_in.incidents]
    assert _engine_trace(runner_mp) == _engine_trace(runner_in)
    assert runner_mp.sim.active_workers == runner_in.sim.active_workers
    assert [r.functions() for r in res_mp.reports] == \
        [r.functions() for r in res_in.reports]
    inc = next(i for i in res_mp.incidents if i.function == GEMM)
    assert inc.state == "resolved" and inc.escalations == 0
    assert runner_mp.engine.log[0].plan.action == Action.REPLACE_HOSTS
    ws = res_mp.wire_summary()
    assert ws["delivered"] == ws["expected"]
    runner_in.engine.recovery.close()
    runner_mp.engine.recovery.close()


@pytest.mark.train
@pytest.mark.wire
@pytest.mark.timeout(240)
def test_multiprocess_trainer_dataloader_burn():
    """Real trainer processes over the socket transport: the children
    train, upload patterns and measured anchors, and the parent (no
    simulator, no model) localizes the burn to ``dataloader.next`` on
    worker 1."""
    wl = TrainerWorkload(n_workers=4, setup=tiny_train_setup(),
                         device="cpu")
    r = ScenarioRunner(
        None, [ScheduledFault(DataloaderBurn(workers=(1,)), 2, 7)],
        n_windows=7, iters_per_window=8,
        detector_cfg=default_trainer_detector_cfg(8), workload=wl,
        device="cpu")
    res = r.run_multiprocess(n_procs=2, window_timeout=120.0)
    assert not wl.workers                # the parent built no trainer
    ws = res.wire_summary()
    assert ws["expected"] == 4 * 7 and ws["delivered"] == ws["expected"]
    inc = next(i for i in res.incidents if i.function == "dataloader.next"
               and 1 in i.workers)
    assert Action.MIGRATE_DATALOADER in [p.action for p in inc.plans]
    with pytest.raises(ValueError, match="collector-tree"):
        r.run_multiprocess(n_procs=2, n_shards=2)
    with pytest.raises(ValueError, match="simulator-only"):
        r.run_multiprocess(n_procs=2, loss=0.1)
