"""The port's ``DecodeStall`` end to end on the CPU: the twin of
tests/test_serve_workload.py::test_decode_stall_localizes_subset_and_drains
(7 windows of 8 requests, the stall live in windows 2-6 on worker 2,
localized on the ``slo`` channel to ``decode.step`` with worker 2 among
its workers, drain-and-replace first), in a file of its own so that it
runs beside the other serving scenarios.

The stall is set from the workload's own healthy TBT, measured in a
fault-free window just before the scenario, at 8x that TBT (the fault's
default pads 3x the warm-up TBT).

The fleet has 8 workers where the reference's test has 4.  Under a loaded
host the stall always shows (worker 2's ``decode.step`` mu falls to
0.1-0.4 against its peers' 0.9-1.0), but a healthy worker starved of CPU
reads a scattered pattern too (mu 0.6-0.8, sigma up to 0.4).  With 4
workers two such deltas are half the fleet, so the differential rule's
median + 5 MAD threshold flags nobody and the incident is never
confirmed with a plan; with 8 the starved workers stay a minority.
"""
import numpy as np
import pytest

from repro_torch.core.mitigation import Action
from repro_torch.serve.workload import DecodeStall, DECODE_STEP, \
    ServeWorkload

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401
from test_torch_serve_scenarios import IPW, _incident, _scenario

pytestmark = pytest.mark.serve

N_WORKERS = 8
STALL_TBTS = 8.0              # DecodeStall's pad, in measured healthy TBTs


@pytest.fixture
def wl8():
    wl = ServeWorkload(n_workers=N_WORKERS, device="cpu")
    wl._ensure_workers()
    yield wl
    wl.close()


@pytest.mark.timeout(120)
def test_decode_stall_localizes_subset_and_drains(wl8):
    wd = wl8.run_window(0, [], IPW, None)
    tbt = float(np.median([tbt for _, _, tbt in wd.metrics["slo"]]))
    res = _scenario(wl8, DecodeStall(workers=(2,),
                                     pad_s=STALL_TBTS * tbt)).run()
    inc = _incident(res, DECODE_STEP, (2,), Action.DRAIN_AND_REPLACE)
    assert inc.plans[0].action == Action.DRAIN_AND_REPLACE
