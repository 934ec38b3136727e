"""Mitigation hooks: PerfTracker's localization output drives the
fault-tolerance machinery (DESIGN.md §4, §9) — the paper's observability
becomes the cluster's straggler/failure sensor.

Actions map 1:1 to what the paper's operators did (§6): replace flagged
hosts (checkpoint-now + elastic re-mesh without them), move data loading,
synchronize GC, flag code for optimization.

Two entry points:

  * ``plan_ladder(diagnosis)``     — a RANKED ladder of plans for one
    diagnosis: rung 0 is the playbook's best first move, later rungs are
    what an operator tries when verification shows the signature survived
    the previous rung (e.g. flag-code first, replace the hosts when the
    "software" problem follows the hardware).  The online mitigation
    engine (``repro_torch.online.mitigation``) executes ladders rung by rung and
    escalates on failed verification.
  * ``plan_mitigations(diagnoses)`` — the flat batch view: the first rung
    of every diagnosis's ladder, with REPLACE_HOSTS plans merged into one
    fleet operation (one checkpoint + one re-mesh, not one per diagnosis).

Ladders live in a declarative registry keyed by ``(channel, Kind)``
(DESIGN.md §13): workload playbooks (e.g. ``repro_torch.serve.playbook``)
register channel-specific rules without editing this dispatch; a channel
with no specific rule falls back to the channel-agnostic ``(None, Kind)``
rule, and an unregistered Kind falls back to checkpoint-and-hand-off.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import channels
from repro_torch.core.events import Kind
from repro_torch.core.report import Diagnosis


class Action(Enum):
    REPLACE_HOSTS = "replace_hosts"          # checkpoint-now + re-mesh
    CHECKPOINT_NOW = "checkpoint_now"
    ROLLBACK_TO_CHECKPOINT = "rollback_to_checkpoint"   # numerics: restore
    MIGRATE_DATALOADER = "migrate_dataloader"
    SYNCHRONIZE_GC = "synchronize_gc"
    FLAG_CODE = "flag_code_for_optimization"
    SHED_LOAD = "shed_load"                  # serving: reject/route excess
    DRAIN_AND_REPLACE = "drain_and_replace"  # serving: drain in-flight
    #                                          requests, then re-mesh
    NONE = "none"


@dataclass
class MitigationPlan:
    action: Action
    workers: List[int] = field(default_factory=list)
    detail: str = ""


LadderRule = Callable[[Diagnosis, int], List[MitigationPlan]]

#: (channel | None, Kind) -> rule; None = channel-agnostic fallback
_LADDERS: Dict[Tuple[Optional[str], Kind], LadderRule] = {}


def register_ladder(channel: Optional[str], *kinds: Kind
                    ) -> Callable[[LadderRule], LadderRule]:
    """Register a ladder rule for ``(channel, kind)`` pairs.

    ``channel=None`` registers the channel-agnostic fallback used when no
    channel-specific rule exists; a non-None channel must be registered
    in :mod:`repro_torch.core.channels`.
    """
    if channel is not None:
        channels.validate_channel(channel)

    def deco(fn: LadderRule) -> LadderRule:
        for kind in kinds:
            _LADDERS[(channel, kind)] = fn
        return fn
    return deco


def plan_ladder(d: Diagnosis, fleet_size: int) -> List[MitigationPlan]:
    """Ranked mitigation ladder for ONE diagnosis.

    Rung 0 is the paper-§6 playbook's first move for the diagnosed
    pattern; each later rung is the escalation an operator reaches for
    when the signature survives verification of the rung before it.

    Dispatch: the ``(channel, kind)`` rule if one is registered, else the
    channel-agnostic ``(None, kind)`` rule, else checkpoint-and-hand-off.
    """
    a = d.abnormality
    rule = _LADDERS.get((channels.channel_of(a), a.kind),
                        _LADDERS.get((None, a.kind)))
    if rule is not None:
        return rule(d, fleet_size)
    return [MitigationPlan(
        Action.CHECKPOINT_NOW, [],
        f"unclassified abnormality kind {a.kind!r} in {a.function}: "
        "checkpoint and hand to an operator")]


def _frac_ws(d: Diagnosis, fleet_size: int):
    a = d.abnormality
    return (len(a.workers) / max(1, fleet_size),
            sorted(int(w) for w in a.workers))


@register_ladder(None, Kind.NUMERICS)
def _numerics_ladder(d: Diagnosis, fleet_size: int) -> List[MitigationPlan]:
    # loss spike / gradient-norm explosion: the model state is suspect,
    # not the hardware — restore the last good checkpoint (skipping the
    # poisoned batch), and when divergence recurs flag the code
    # (lr schedule / data) for a human
    a = d.abnormality
    return [
        MitigationPlan(
            Action.ROLLBACK_TO_CHECKPOINT, [],
            f"numerics anomaly in {a.function}: restore last good "
            "checkpoint and skip the offending data shard"),
        MitigationPlan(
            Action.FLAG_CODE, [],
            "divergence survived rollback -> flag lr schedule / data "
            "pipeline for investigation"),
    ]


@register_ladder(None, Kind.GPU, Kind.COMM)
def _hardware_ladder(d: Diagnosis, fleet_size: int) -> List[MitigationPlan]:
    a = d.abnormality
    frac, ws = _frac_ws(d, fleet_size)
    if frac >= 0.5:
        # widespread hardware abnormality: replacing half the fleet is
        # not a plan — checkpoint immediately and flag the fabric /
        # topology for investigation (regression: this used to fall
        # through to Action.NONE)
        return [MitigationPlan(
            Action.CHECKPOINT_NOW, [],
            f"{a.kind.name} abnormality on {frac:.0%} of the fleet: "
            "checkpoint now, flag fabric/topology for investigation")]
    ladder = [MitigationPlan(
        Action.REPLACE_HOSTS, ws,
        "checkpoint-now, drop flagged hosts, elastic re-mesh on "
        "standbys (see repro.ckpt + launch.train --elastic)")]
    if a.kind == Kind.GPU:
        ladder.append(MitigationPlan(
            Action.FLAG_CODE, ws,
            f"persists across host replacement -> suspect software; "
            f"optimize {a.function}"))
    else:
        ladder.append(MitigationPlan(
            Action.CHECKPOINT_NOW, [],
            "persists across host replacement -> checkpoint and page "
            "network/topology on-call"))
    return ladder


@register_ladder(None, Kind.PYTHON)
def _python_ladder(d: Diagnosis, fleet_size: int) -> List[MitigationPlan]:
    a = d.abnormality
    frac, ws = _frac_ws(d, fleet_size)
    if "socket" in a.function or "dataloader" in a.function:
        if ("thrash" in d.hint or "page-cache" in d.hint) \
                and ws and frac < 0.5:
            # IO contention localized to a few hosts: their page cache
            # (or local disk) is sick, not the shared storage — replace
            # them before reaching for a storage migration
            return [
                MitigationPlan(
                    Action.REPLACE_HOSTS, ws,
                    "page-cache thrash pinned to these hosts: replace "
                    "them (local IO path is sick)"),
                MitigationPlan(
                    Action.MIGRATE_DATALOADER, [],
                    "thrash survived host replacement -> move input "
                    "data to the parallel file system"),
            ]
        return [
            MitigationPlan(
                Action.MIGRATE_DATALOADER, [],
                "move input data to the parallel file system"),
            MitigationPlan(
                Action.FLAG_CODE, ws,
                "storage migration did not clear it -> optimize the "
                "input pipeline itself"),
        ]
    if "cgroup" in d.hint and ws and frac < 0.5:
        # OS-level CPU quota on specific hosts: no code change fixes a
        # misconfigured cgroup — replace (or re-image) the hosts
        return [
            MitigationPlan(
                Action.REPLACE_HOSTS, ws,
                "cgroup CPU quota throttling these hosts: replace "
                "them and flag the node config"),
            MitigationPlan(
                Action.FLAG_CODE, ws,
                "persists on fresh hosts -> suspect the training "
                f"code; optimize {a.function}"),
        ]
    if "gc" in d.hint or "garbage" in d.hint:
        return [
            MitigationPlan(
                Action.SYNCHRONIZE_GC, [],
                "manually collect garbage every K iterations on all "
                "workers"),
            MitigationPlan(
                Action.FLAG_CODE, ws,
                f"synchronized GC did not clear it -> optimize "
                f"{a.function}"),
        ]
    # generic slow Python frame: flag the code first; when the
    # "software" problem follows the flagged hosts, replace them
    ladder = [MitigationPlan(Action.FLAG_CODE, ws,
                             f"optimize {a.function}")]
    if ws and frac < 0.5:
        ladder.append(MitigationPlan(
            Action.REPLACE_HOSTS, ws,
            "optimization did not clear it and only these hosts are "
            "implicated -> replace them"))
    else:
        ladder.append(MitigationPlan(
            Action.CHECKPOINT_NOW, [],
            "fleet-wide slow Python frame persists -> checkpoint and "
            "hand to an operator"))
    return ladder


@register_ladder(None, Kind.MEM)
def _mem_ladder(d: Diagnosis, fleet_size: int) -> List[MitigationPlan]:
    # explicit non-GPU/COMM/PYTHON handling (used to fall through)
    a = d.abnormality
    _, ws = _frac_ws(d, fleet_size)
    return [MitigationPlan(
        Action.FLAG_CODE, ws,
        f"host/device copy bottleneck in {a.function}: batch or "
        "overlap transfers")]


def plan_mitigations(diagnoses: Sequence[Diagnosis], fleet_size: int
                     ) -> List[MitigationPlan]:
    """First rung of every diagnosis's ladder, REPLACE_HOSTS merged.

    Host replacement is one fleet operation (a single checkpoint + elastic
    re-mesh drops every flagged host at once), so REPLACE_HOSTS rungs from
    different diagnoses merge into one leading plan; other plans keep
    diagnosis order, with exact duplicates (same action + workers)
    dropped.
    """
    plans: List[MitigationPlan] = []
    seen = set()
    bad_hosts: set = set()
    for d in diagnoses:
        head = plan_ladder(d, fleet_size)[0]
        if head.action is Action.REPLACE_HOSTS:
            bad_hosts.update(head.workers)
            continue
        key = (head.action, tuple(head.workers))
        if key in seen:
            continue
        seen.add(key)
        plans.append(head)
    if bad_hosts:
        plans.insert(0, MitigationPlan(
            Action.REPLACE_HOSTS, sorted(bad_hosts),
            "checkpoint-now, drop flagged hosts, elastic re-mesh on "
            "standbys (see repro.ckpt + launch.train --elastic)"))
    if not plans:
        plans.append(MitigationPlan(Action.NONE))
    return plans


def format_plans(plans: Sequence[MitigationPlan]) -> str:
    """One line per plan, for reports and demos."""
    if not plans:
        return "mitigation: none"
    lines = []
    for p in plans:
        ws = f" workers={p.workers}" if p.workers else ""
        detail = f" — {p.detail}" if p.detail else ""
        lines.append(f"mitigation: {p.action.value}{ws}{detail}")
    return "\n".join(lines)
