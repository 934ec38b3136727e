"""The port's ``ScenarioRunner.run_multiprocess`` on the CPU: spawned worker
processes summarize their slice of the fleet with ``PerfTrackerDaemon``s and
upload over the socket transport; the parent assembles, localizes and runs
the incidents.  On tests/test_wire.py's C1P1 cell (W=32, 1 s windows,
250/2000 Hz, 9 windows) with 2 processes: the in-process run's culprit sets
(and the reference's), flat and through a 2-shard collector tree, every
upload delivered; at 10% injected loss the windows are partial and the
culprits still found; the escalation rates cross the process boundary.
The other cells are in tests/test_torch_multiprocess_more.py, so that
``--dist loadfile`` spreads them over two workers.
"""
import numpy as np
import pytest

from repro.core import faults as RF
from repro.core.simulation import SimConfig as RefConfig
from repro.online import EscalationPolicy as RefEscalation
from repro.online import ScenarioRunner as RefRunner
from repro.online import ScheduledFault as RefScheduled

from repro_torch.core import faults as F
from repro_torch.core.simulation import GEMM, SimConfig
from repro_torch.online import (EscalationPolicy, ScenarioRunner,
                                ScheduledFault)

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

W_MP = 32
INJECT, REMOVE = 2, 6
N_WINDOWS = 9
BASE_HZ, FULL_HZ = 250.0, 2000.0


@pytest.fixture(autouse=True)
def one_thread_children(monkeypatch):
    """Spawned children inherit the environment: one torch thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def mp_runner(fault, seed=5, **kw):
    esc = EscalationPolicy(n_workers=W_MP, base_rate_hz=BASE_HZ,
                           full_rate_hz=FULL_HZ)
    return ScenarioRunner(
        SimConfig(n_workers=W_MP, window_s=1.0, rate_hz=FULL_HZ, seed=seed),
        [ScheduledFault(fault, INJECT, REMOVE)], n_windows=N_WINDOWS,
        escalation=esc, device="cpu", **kw)


def ref_culprits(ref_fault, seed=5):
    esc = RefEscalation(n_workers=W_MP, base_rate_hz=BASE_HZ,
                        full_rate_hz=FULL_HZ)
    return culprit_sets(RefRunner(
        RefConfig(n_workers=W_MP, window_s=1.0, rate_hz=FULL_HZ, seed=seed),
        [RefScheduled(ref_fault, INJECT, REMOVE)], n_windows=N_WINDOWS,
        escalation=esc).run())


def culprit_sets(res):
    """{function: frozenset(workers)} over confirmed-or-later incidents."""
    return {i.function: frozenset(i.workers)
            for i in res.incidents if i.function}


def assert_matches_inprocess(fault, ref_fault, expect, culprits, **mp_kw):
    res_in = mp_runner(fault).run()
    res_mp = mp_runner(fault).run_multiprocess(n_procs=2,
                                               window_timeout=60.0, **mp_kw)
    assert culprit_sets(res_mp) == culprit_sets(res_in) \
        == ref_culprits(ref_fault)
    incs = [i for i in res_mp.incidents if i.function == expect]
    assert incs and culprits <= set(incs[0].workers)
    wire = res_mp.wire_summary()
    assert wire["delivered"] == wire["expected"] == W_MP * N_WINDOWS
    assert wire["partial_windows"] == 0
    # the children summarized on the CPU: no kernel launched anywhere
    assert all(not any(v.values())
               for v in res_mp.worker_launches.values())
    return res_mp


@pytest.mark.wire
@pytest.mark.timeout(120)
@pytest.mark.parametrize("n_shards", [None, 2], ids=["flat", "tree"])
def test_multiprocess_c1p1_matches_inprocess(n_shards):
    assert_matches_inprocess(F.GpuThrottle(workers=(3, 11)),
                             RF.GpuThrottle(workers=(3, 11)), GEMM, {3, 11},
                             n_shards=n_shards)


@pytest.mark.wire
@pytest.mark.timeout(120)
def test_multiprocess_10pct_loss_still_localizes():
    res = mp_runner(F.GpuThrottle(workers=(3, 11))).run_multiprocess(
        n_procs=2, loss=0.10, window_timeout=60.0)
    incs = [i for i in res.incidents if i.function == GEMM]
    assert incs and {3, 11} <= set(incs[0].workers)
    wire = res.wire_summary()
    assert wire["delivered"] < wire["expected"]
    assert wire["partial_windows"] > 0
    partial = next(r for r in res.reports if r.transport["missing"])
    txt = partial.report(W_MP)
    assert "transport:" in txt and "missing=" in txt


@pytest.mark.wire
@pytest.mark.timeout(120)
def test_multiprocess_escalation_rates_cross_process():
    res = mp_runner(F.GpuThrottle(workers=(3, 11))).run_multiprocess(
        n_procs=2, window_timeout=60.0)
    mid = res.reports[INJECT + 1]
    assert {3, 11} <= set(mid.escalated)
    assert mid.rates[3] == FULL_HZ and mid.rates[0] == BASE_HZ
    assert res.reports[0].raw_bytes < W_MP * FULL_HZ * 1.0 * 4 * 8
    # the window reports carry the transport counters of every window
    assert all(r.transport["present"] == W_MP for r in res.reports)
    assert np.isfinite([r.summarize_s for r in res.reports]).all()


def test_multiprocess_refuses_what_cannot_cross_processes():
    from repro_torch.summarize.backends import NumpyBackend
    runner = mp_runner(F.GpuThrottle(workers=(3,)),
                       summarize_backend=NumpyBackend())
    with pytest.raises(ValueError, match="picklable"):
        runner.run_multiprocess(n_procs=2)
