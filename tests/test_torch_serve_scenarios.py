"""The port's live serving faults end to end on the CPU: a 4-worker
``ServeWorkload`` (the reference's ``tiny_serve_setup``), 7 windows of 8
requests, the fault live in windows 2-6, each localized on the ``slo``
channel to the function and workers the reference's
tests/test_serve_workload.py asserts, with the serving playbook's first
plan.

Each scenario gets a fresh workload (its warm-up takes ~0.3 s here): the
request generators keep their virtual backlog across windows, so a
workload shared with ``BurstArrivals`` would start the next scenario with
queue waits still draining.  ``DecodeStall``'s twin is in
tests/test_torch_serve_stall.py.
"""
import pytest

from repro_torch.core.mitigation import Action
from repro_torch.online import ScenarioRunner, ScheduledFault
from repro_torch.serve.workload import (BurstArrivals, CacheThrash,
                                        KV_READ, QUEUE_WAIT, ServeWorkload)
from repro_torch.train.workload import default_trainer_detector_cfg

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.serve

IPW = 8                       # requests per profiling window
N_WIN = 7                     # fault active for windows [2, 7)


@pytest.fixture
def wl4():
    wl = ServeWorkload(n_workers=4, device="cpu")
    wl._ensure_workers()
    yield wl
    wl.close()


def _scenario(wl, fault):
    return ScenarioRunner(
        None, [ScheduledFault(fault, 2, N_WIN)], n_windows=N_WIN,
        iters_per_window=IPW,
        detector_cfg=default_trainer_detector_cfg(IPW), workload=wl,
        device="cpu")


def _incident(result, function, workers, action):
    """The slo-channel incident localizing ``function`` that implicates
    every worker in ``workers`` and whose ladder holds ``action``."""
    for inc in result.incidents:
        if inc.function == function and inc.channel == "slo" \
                and set(workers) <= set(inc.workers) \
                and action in [p.action for p in inc.plans]:
            return inc
    raise AssertionError(
        f"no slo incident for {function} on {workers} with {action}; got "
        f"{[(i.function, i.channel, i.workers, [p.action for p in i.plans]) for i in result.incidents]}")


@pytest.mark.timeout(120)
def test_burst_arrivals_localizes_queue_and_sheds_load(wl4):
    res = _scenario(wl4, BurstArrivals(workers=())).run()
    inc = _incident(res, QUEUE_WAIT, (0, 1, 2, 3), Action.SHED_LOAD)
    assert inc.plans[0].action == Action.SHED_LOAD


@pytest.mark.timeout(120)
def test_cache_thrash_localizes_kv_reads_fleet_wide(wl4):
    res = _scenario(wl4, CacheThrash(workers=())).run()
    inc = _incident(res, KV_READ, (0, 1, 2, 3), Action.SHED_LOAD)
    assert inc.plans[0].action == Action.SHED_LOAD
