"""Diagnosis report (paper Fig. 7): which functions on which workers behave
abnormally, how they differ from expectation/peers, plus root-cause hints
(the diagnosis rules the paper walks through in §3/§6)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.core.events import Kind
from repro_torch.core.localizer import Abnormality


@dataclass
class Diagnosis:
    abnormality: Abnormality
    hint: str


def _fmt_workers(ws: np.ndarray, limit: int = 8) -> str:
    lst = ws.tolist()
    if len(lst) <= limit:
        return "{" + ",".join(map(str, lst)) + "}"
    return ("{" + ",".join(map(str, lst[:limit]))
            + f",...}} ({len(lst)} workers)")


def root_cause_hint(a: Abnormality, fleet_size: int) -> str:
    """Paper's diagnosis playbook, encoded."""
    frac = len(a.workers) / max(1, fleet_size)
    beta = float(np.median(a.patterns[:, 0]))
    mu = float(np.median(a.patterns[:, 1]))
    sigma = float(np.median(a.patterns[:, 2]))
    t_beta, t_mu, t_sigma = (float(x) for x in a.typical)

    if a.kind == Kind.NUMERICS:
        if "grad" in a.function:
            return ("gradient-norm explosion on the numerics channel -> "
                    "model state is suspect; roll back to the last good "
                    "checkpoint and skip the offending batch")
        return ("training-loss spike on the numerics channel -> model "
                "state is suspect; roll back to the last good checkpoint "
                "and skip the offending batch")
    if a.kind == Kind.GPU:
        if beta > t_beta and mu < t_mu * 0.45:
            return ("slow GPU computation at low SM/frequency utilization "
                    "-> suspect GPU throttling / degraded GPUs (case C1P1)")
        if beta > t_beta and mu < t_mu * 0.75:
            return ("slow GPU computation at MODERATE SM utilization -> "
                    "suspect driver/kernel version mismatch on these hosts "
                    "(mis-tuned stack, not a throttled clock)")
        return "GPU kernels slower than peers"
    if a.kind == Kind.COMM:
        mu_max = float(np.max(a.patterns[:, 1]))
        if mu > t_mu * 1.5 or (mu_max > t_mu * 1.5 and mu_max > 0.7):
            return ("collective traffic at unusually HIGH PCIe utilization "
                    "-> NVLink down, traffic falling back to PCIe (C1P2)")
        if mu < t_mu * 0.5 and frac < 0.2 and sigma < t_sigma:
            return ("collectives collapsed to low, stable link utilization "
                    "on these hosts while the fleet is healthy -> degraded "
                    "NIC; replace the hosts")
        if sigma < t_sigma * 0.5 and frac < 0.2:
            return ("stable throughput while peers fluctuate -> this worker "
                    "drives the degraded link (ring slow-link, §3 Fig. 5c)")
        if mu < t_mu and sigma <= t_sigma * 1.2 and frac < 0.2:
            return ("low, stable link throughput -> this worker drives the "
                    "degraded link (ring slow-link, §3 Fig. 5c)")
        if mu < t_mu and sigma > t_sigma:
            return ("low, fluctuating throughput -> ring limited by a slow "
                    "link elsewhere in the ring (§3 Fig. 5b)")
        return "collective communication slower than peers"
    if a.kind == Kind.PYTHON:
        if "queue" in a.function or "dequeue" in a.function:
            if frac > 0.5:
                return ("request dequeue wait dominates fleet-wide -> "
                        "arrival rate exceeds serving capacity (queue "
                        "buildup); shed load until the backlog drains")
            return ("long dequeue waits on a subset of serving hosts -> "
                    "local scheduler backlog; drain and investigate")
        if "socket" in a.function or "dataloader" in a.function:
            if mu < 0.3 and sigma > t_sigma * 1.5 and 0.0 < frac < 0.5:
                return ("long, bursty, non-CPU-intensive dataloader frames "
                        "on a few hosts -> page-cache thrash / local IO "
                        "contention; replace the hosts")
            if frac > 0.5:
                return ("dataloader socket recv dominates on most workers "
                        "-> slow storage / data loading (C2P1)")
            return "slow data loading on a subset of workers"
        if "forward" in a.function and mu > 0.7:
            return ("CPU-bound Python forward -> inefficient host-side "
                    "implementation (C2P2)")
        if mu < 0.3 and 0.0 < frac < 0.95:
            return ("long non-CPU-intensive Python frames scattered over "
                    "random workers -> asynchronous garbage collection; "
                    "synchronize gc across workers (C2P3)")
        if sigma < max(0.01, t_sigma * 0.5) and 0.25 <= mu <= 0.6 \
                and 0.0 < frac < 0.5:
            return ("Python frames stretched with CPU utilization CLAMPED "
                    "FLAT at a ceiling on these hosts -> cgroup CPU quota "
                    "throttling; replace or re-image the hosts")
        return "Python function exceeds the 1% critical-path budget"
    if a.kind == Kind.MEM:
        if "kv" in a.function:
            return ("KV block reads dominate the decode step -> KV-cache "
                    "working set exceeds device memory (cache thrash); "
                    "shed load until the working set fits")
        return "memory operations dominate -> host/device copy bottleneck"
    return "abnormal behavior"


def build_report(abnormalities: List[Abnormality], fleet_size: int
                 ) -> List[Diagnosis]:
    return [Diagnosis(a, root_cause_hint(a, fleet_size))
            for a in abnormalities]


def format_report(diagnoses: List[Diagnosis], fleet_size: int) -> str:
    if not diagnoses:
        return "PerfTracker: no abnormal function executions found."
    lines = [
        "PerfTracker diagnosis "
        f"({len(diagnoses)} abnormal function(s), fleet={fleet_size}):",
        f"{'function':40s} {'workers':28s} {'beta':>6s} {'mu':>6s} "
        f"{'sigma':>6s} {'typ.beta':>8s} {'typ.mu':>7s}",
    ]
    for d in diagnoses:
        a = d.abnormality
        med = np.median(a.patterns, axis=0)
        lines.append(
            f"{a.function[:40]:40s} {_fmt_workers(a.workers):28s} "
            f"{med[0]:6.3f} {med[1]:6.3f} {med[2]:6.3f} "
            f"{a.typical[0]:8.3f} {a.typical[1]:7.3f}")
        lines.append(f"    [{a.reason}] -> {d.hint}")
    return "\n".join(lines)


def format_transport(tr) -> str:
    """One-line wire-transport summary for reports (DESIGN.md §8): the
    counters a ``transport.WindowBatch.stats()`` dict carries."""
    out = (f"transport: {tr['present']}/{tr['expected']} workers "
           f"reported; dropped={tr['client_dropped']} "
           f"duplicates={tr['duplicates']}")
    if tr.get("reconnects"):
        out += f" reconnects={tr['reconnects']}"
    if tr["missing"]:
        out += f" missing={list(tr['missing'])}"
    if "shards" in tr:
        out += (f"\ntransport: collector tree "
                f"{tr['shards']}/{tr['expected_shards']} shards reported")
        if tr.get("missing_shards"):
            out += f" missing_shards={list(tr['missing_shards'])}"
        if tr.get("duplicate_shards"):
            out += f" duplicate_shards={tr['duplicate_shards']}"
    return out
