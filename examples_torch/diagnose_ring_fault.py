"""Reproduce the paper's §3 ring-communication study (Figs. 3-5) on the
PyTorch port: simulate a 32-worker NCCL-style ring fleet, degrade one NIC
bond to 50%, summarize each worker's (beta, mu, sigma) pattern (kernel K1
on the card), and localize the slow link.

  PYTHONPATH=src python examples_torch/diagnose_ring_fault.py
  PYTHONPATH=src python examples_torch/diagnose_ring_fault.py --device cpu

The diagnosis runs on the card unless ``--device cpu`` is given; without
a card and without that flag it raises.
"""
import argparse

from repro_torch.core import faults as F
from repro_torch.core.daemon import summarize_and_upload
from repro_torch.core.mitigation import plan_mitigations
from repro_torch.core.service import PerfTrackerService
from repro_torch.core.simulation import ALLGATHER, FleetSimulator, SimConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the diagnosis (default: the card)")
    args = ap.parse_args(argv)

    slow_worker, rho = 9, 0.5
    sim = FleetSimulator(
        SimConfig(n_workers=32, window_s=2.0, rate_hz=2000, seed=11),
        [F.RingSlowLink(slow_worker=slow_worker, rho=rho)])
    svc = PerfTrackerService(device=args.device)

    trig = svc.feed_anchors(sim.anchor_events(80, degrade_after=40))
    print(f"detector: {trig.reason} — {trig.detail}\n")

    profiles = sim.profile_window()
    res = svc.diagnose_profiles(profiles, trigger=trig)

    # Fig. 5-style view of the collective's per-worker patterns
    print(f"{'worker':>6s} {'mu(PCIe)':>9s} {'sigma':>7s}  signature")
    for w in (0, 1, slow_worker, 20, 31):
        pats, _ = summarize_and_upload(profiles[w],
                                       backend=svc.summarize_backend).unpack()
        b, m, s = pats[ALLGATHER]
        sig = ("slow link (low, STABLE — Fig. 5c)" if w == slow_worker
               else "waiting on slow link (fluctuating — Fig. 5b)")
        print(f"{w:6d} {m:9.3f} {s:7.3f}  {sig}")

    print()
    print(res.report())
    print()
    for p in plan_mitigations(res.diagnoses, 32):
        print(f"mitigation: {p.action.value} {p.workers} — {p.detail}")


if __name__ == "__main__":
    main()
