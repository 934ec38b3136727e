"""Online incident pipeline demo on the PyTorch port (DESIGN.md §7, §8,
§9).

A 14-window simulated training run: GPUs on workers 3 and 11 start
throttling at window 2; a slow-storage fault overlaps from window 4; both
clear later.  The fleet profiles at a cheap 250 Hz base rate — only
implicated workers escalate to the full 2 kHz.

Run:  PYTHONPATH=src python examples_torch/online_demo.py
      PYTHONPATH=src python examples_torch/online_demo.py --wire [--loss 0.1]
      PYTHONPATH=src python examples_torch/online_demo.py --mitigate
      PYTHONPATH=src python examples_torch/online_demo.py --scenario E3_bad_standby_driver
      PYTHONPATH=src python examples_torch/online_demo.py --list-scenarios
      PYTHONPATH=src python examples_torch/online_demo.py --device cpu

The diagnosis (kernel K1) runs on the card unless ``--device cpu`` is
given; without a card and without that flag it raises.

``--wire`` runs the SAME scenario across real process boundaries: 4
spawned worker processes each run per-worker daemons over their slice of
the fleet and upload ~KB patterns over a Unix socket (DESIGN.md §8);
``--loss`` injects that fraction of upload drops at the framing layer to
show the partial-window degradation story.

``--mitigate`` closes the loop (DESIGN.md §9): the schedule never removes
the faults — instead the MitigationEngine executes each incident's ladder
against the simulator (throttled hosts are replaced by standbys via an
elastic re-mesh, the dataloader migrates), verification watches the
signature clear, and every incident is driven to ``resolved``.

``--scenario <name>`` runs ONE entry of the gated fault-scenario catalog
(DESIGN.md §12) with the mitigation loop closed and scores the outcome
against its declared expectations — try ``E3_bad_standby_driver`` to
watch ``replace_hosts`` land on a poisoned standby and the incident
escalate honestly.  ``--list-scenarios`` prints the catalog.

Serving scenarios (DESIGN.md §13) run the same way — try
``--scenario SV2_arrival_burst`` to watch a latency-SLO incident open on
the ``slo`` channel and resolve through ``shed_load``; for the loop over
the REAL serving engine (live arrival-burst / decode-stall / KV-thrash
faults), see ``tests/test_torch_serve_scenarios.py`` and
``repro_torch/serve/workload.py``.
"""
import argparse

from repro_torch.core import faults as F
from repro_torch.core.simulation import SimConfig
from repro_torch.online import EscalationPolicy, ScenarioRunner, ScheduledFault

W = 24
N_STANDBY = 4
N_WINDOWS = 14


def make_runner(mitigate: bool = False, device=None):
    if mitigate:
        # nothing but the engine can clear these faults
        schedule = [
            ScheduledFault(F.GpuThrottle(workers=(3, 11)), start_window=2,
                           end_window=N_WINDOWS),
            ScheduledFault(F.SlowDataloader(), start_window=4,
                           end_window=N_WINDOWS),
        ]
        n_standby = N_STANDBY
    else:
        schedule = [
            ScheduledFault(F.GpuThrottle(workers=(3, 11)), start_window=2,
                           end_window=8),
            ScheduledFault(F.SlowDataloader(), start_window=4,
                           end_window=10),
        ]
        n_standby = 0
    escalation = EscalationPolicy(n_workers=W + n_standby,
                                  base_rate_hz=250.0,
                                  full_rate_hz=2000.0, max_escalated=8)
    runner = ScenarioRunner(
        SimConfig(n_workers=W, window_s=1.0, rate_hz=2000.0, seed=5,
                  n_standby=n_standby),
        schedule, n_windows=N_WINDOWS, escalation=escalation,
        mitigation=mitigate, device=device)
    return runner, schedule


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wire", action="store_true",
                    help="run across 4 real worker processes over the wire "
                         "transport (DESIGN.md §8)")
    ap.add_argument("--loss", type=float, default=0.0,
                    help="with --wire: fraction of upload frames dropped at "
                         "the framing layer")
    ap.add_argument("--mitigate", action="store_true",
                    help="execute mitigation plans against the simulator "
                         "and verify recovery (DESIGN.md §9)")
    ap.add_argument("--scenario", default="",
                    help="run one catalog scenario (DESIGN.md §12) with "
                         "mitigation closed and score it against its "
                         "declared expectations")
    ap.add_argument("--list-scenarios", action="store_true",
                    help="print the fault-scenario catalog and exit")
    ap.add_argument("--device", default=None,
                    help="torch device of the diagnosis (default: the card)")
    args = ap.parse_args(argv)
    if args.wire and args.mitigate:
        ap.error("--mitigate is in-process only (cures cannot yet be "
                 "broadcast to spawned daemons)")
    if args.scenario and args.wire:
        ap.error("--scenario is in-process only")

    if args.list_scenarios:
        from repro_torch.online import SCENARIOS
        for sc in SCENARIOS:
            expect = ", ".join(
                f"{e.function.split('/')[-1]}[{e.outcome}]"
                for e in sc.expect)
            print(f"{sc.name:28s} {sc.fault_class:12s} -> {expect}")
        return

    if args.scenario:
        from repro_torch.online import evaluate, run_scenario
        from repro_torch.online.catalog import by_name
        sc = by_name(args.scenario)
        runner, result = run_scenario(sc, device=args.device)
    elif args.wire:
        runner, schedule = make_runner(args.mitigate, args.device)
        result = runner.run_multiprocess(n_procs=4, loss=args.loss)
    else:
        runner, schedule = make_runner(args.mitigate, args.device)
        result = runner.run()

    print("=== per-window reports " + "=" * 40)
    for rep in result.reports:
        faults = [type(f).__name__ for f in runner.faults_at(rep.index)]
        print(f"\n-- window {rep.index:2d}  t={rep.t:7.1f}s  "
              f"faults={faults or ['-']}  escalated={rep.escalated or '-'}  "
              f"raw={rep.raw_bytes / 1e6:.1f}MB")
        for m in rep.mitigations:
            print(f"   ENGINE: {m}")
        print(rep.report(W))

    wire = result.wire_summary()
    if wire is not None:
        print("\n=== wire transport " + "=" * 44)
        print(f"uploads delivered: {wire['delivered']}/{wire['expected']}  "
              f"partial windows: {wire['partial_windows']}  "
              f"duplicates: {wire['duplicates']}  "
              f"client-side drops: {wire['client_dropped']}")

    print("\n=== incident timeline " + "=" * 41)
    print(result.timeline())

    if args.mitigate or args.scenario:
        print("\n=== fleet after mitigation " + "=" * 36)
        active = runner.sim.active_workers
        print(f"active workers ({len(active)}): {active}")
        print(f"standbys left: {runner.sim.standbys}")

    if args.scenario:
        print("\n=== scorecard " + "=" * 49)
        for row in evaluate(sc, runner, result):
            outcome = ("resolved" if row["resolved"]
                       else "escalated" if row["escalated"] else "MISSING")
            print(f"{'OK ' if row['ok'] else 'FAIL'} "
                  f"{row['function'][:40]:40s} ch={row['channel']:8s} "
                  f"{outcome:9s} first={row['first_action']} "
                  f"escalations={row['escalations']} wtr={row['wtr']}")

    print("\n=== cost " + "=" * 54)
    total = sum(r.raw_bytes for r in result.reports)
    full = len(result.reports) * W * 1.0 * 2000.0 * 4 * 8
    print(f"bytes profiled: {total / 1e6:.1f} MB "
          f"(always-full-rate would be ~{full / 1e6:.1f} MB -> "
          f"{full / total:.1f}x saved by differential escalation)")
    for inc in result.incidents:
        ow = result.window_of(inc.opened_at)
        rw = (result.window_of(inc.resolved_at)
              if inc.resolved_at is not None else None)
        print(f"incident #{inc.id}: {inc.function[:44]} [{inc.state}] "
              f"windows {ow}->{rw} workers={list(inc.workers)[:8]}")


# the __main__ guard is load-bearing for --wire: the multiprocessing spawn
# context re-imports this script in every worker process
if __name__ == "__main__":
    main()
