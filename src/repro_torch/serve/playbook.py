"""Serving-channel mitigation ladders (DESIGN.md §13).

Importing this module registers ladder rules for the ``slo`` channel in
the core registry (``repro_torch.core.mitigation.register_ladder``) — the
core dispatch is never edited.  The rules are keyed ONLY on (channel, Kind)
plus the generic shape of the abnormality (how much of the fleet it
covers, which workers); they contain no knowledge of any fault model or
named scenario.

The serving playbook's two actions (both already understood by the
mitigation engine):

  * ``SHED_LOAD``         — reject/route the excess: the cure when the
    fleet as a whole is over capacity (arrival burst, KV working set
    larger than device memory).  Replacing hosts cannot help — every
    replacement inherits the same load;
  * ``DRAIN_AND_REPLACE`` — drain in-flight requests on the flagged
    hosts, then drop them and re-mesh on standbys: the cure when the SLO
    violation is pinned to sick serving hosts (hot/throttled decode GPU,
    degraded NIC).  World effect identical to training's
    ``REPLACE_HOSTS`` (the engine executes both through
    ``replace_hosts``), but the serving protocol drains first so no
    user-visible request is dropped mid-stream.
"""
from __future__ import annotations

from typing import List

from repro_torch.core import channels
from repro_torch.core.events import Kind
from repro_torch.core.mitigation import (Action, Diagnosis, MitigationPlan,
                                   _frac_ws, register_ladder)


@register_ladder(channels.SLO, Kind.GPU, Kind.COMM)
def _slo_hardware_ladder(d: Diagnosis, fleet_size: int
                         ) -> List[MitigationPlan]:
    # SLO violation traced to hardware (decode GEMMs or token-path
    # collectives) on a SUBSET of serving hosts: drain + replace them;
    # when the signature survives on the replacements, shed load while a
    # human investigates.  Fleet-wide hardware slowness is not a
    # replacement problem — shed load first.
    a = d.abnormality
    frac, ws = _frac_ws(d, fleet_size)
    if ws and frac < 0.5:
        return [
            MitigationPlan(
                Action.DRAIN_AND_REPLACE, ws,
                f"SLO violation pinned to these hosts ({a.function}): "
                "drain in-flight requests, replace, re-mesh on standbys"),
            MitigationPlan(
                Action.SHED_LOAD, [],
                "violation survived host replacement -> shed load and "
                "page serving on-call"),
        ]
    return [
        MitigationPlan(
            Action.SHED_LOAD, [],
            f"{a.kind.name} slowness on {frac:.0%} of the serving fleet: "
            "shed load to restore the SLO, then investigate capacity"),
        MitigationPlan(
            Action.FLAG_CODE, [],
            f"persists under reduced load -> optimize {a.function}"),
    ]


@register_ladder(channels.SLO, Kind.PYTHON)
def _slo_queue_ladder(d: Diagnosis, fleet_size: int) -> List[MitigationPlan]:
    # SLO violation traced to host-side Python (admission/dequeue wait):
    # the fleet is over capacity — shed load; a subset-only backlog gets
    # a drain-and-replace fallback (sick local scheduler)
    a = d.abnormality
    frac, ws = _frac_ws(d, fleet_size)
    ladder = [MitigationPlan(
        Action.SHED_LOAD, [],
        f"request backlog in {a.function}: arrival rate exceeds serving "
        "capacity — shed load until the queue drains")]
    if ws and frac < 0.5:
        ladder.append(MitigationPlan(
            Action.DRAIN_AND_REPLACE, ws,
            "backlog persists and only these hosts are implicated -> "
            "drain and replace them"))
    else:
        ladder.append(MitigationPlan(
            Action.FLAG_CODE, [],
            "backlog persists under reduced load -> optimize admission/"
            "scheduling path"))
    return ladder


@register_ladder(channels.SLO, Kind.MEM)
def _slo_mem_ladder(d: Diagnosis, fleet_size: int) -> List[MitigationPlan]:
    # SLO violation traced to memory traffic (KV block reads): the
    # resident working set exceeds device memory — shed load until it
    # fits; persisting under reduced load means the cache policy itself
    # needs work
    a = d.abnormality
    return [
        MitigationPlan(
            Action.SHED_LOAD, [],
            f"memory traffic dominates {a.function}: KV working set "
            "exceeds device memory — shed load until it fits"),
        MitigationPlan(
            Action.FLAG_CODE, [],
            "thrash persists under reduced load -> revisit KV block "
            "size / eviction policy"),
    ]
