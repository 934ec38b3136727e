"""MitigationEngine: executes mitigation ladders against the running
``FleetSimulator`` and closes the act -> verify -> escalate loop
(DESIGN.md §9; ROADMAP "mitigation validation loop").

The incident manager attaches a RANKED ladder of ``MitigationPlan``s when
an abnormality persists (``plan_ladder``); this engine is what actually
*acts* on the current rung:

  * ``REPLACE_HOSTS``       — ``FleetSimulator.replace_hosts``: flagged
    workers leave the mesh, standbys join (elastic re-mesh; the fleet
    simply shrinks when the standby pool is dry).  A host-pinned fault
    whose hosts were all dropped is cured by construction; a RANK-pinned
    software fault follows its ranks onto the replacement hosts —
    replacing hardware does not fix code, and verification will catch the
    signature reappearing on the new workers;
  * ``MIGRATE_DATALOADER`` / ``SYNCHRONIZE_GC`` / ``FLAG_CODE`` /
    ``CHECKPOINT_NOW`` — clear every live scheduled fault that declares
    the action curative (``ScheduledFault.cures``, defaulting to the
    per-fault-model playbook below).  A misdiagnosed/no-op plan cures
    nothing and leaves the fault live.

With a ``RecoveryManager`` attached (DESIGN.md §14) the checkpoint verbs
act on REAL on-disk state: ``CHECKPOINT_NOW`` drives an actual async save,
``ROLLBACK_TO_CHECKPOINT`` restores the latest valid step into the live
workload (parameter-equality verified), and a replace-like rung first
checkpoints, re-meshes, then elastically restores onto the new mesh.  A
rollback that finds no usable checkpoint is an HONEST failure: the engine
cures nothing, the record carries ``rollback_failed``, verification sees
the signature survive, and the incident escalates — never a faked cure.
Without a recovery manager (worker-process replay engines, legacy
callers) the checkpoint verbs keep their historical label-only cure
semantics; replayed plans carry the parent's rollback outcome so cure
decisions stay bit-identical across process boundaries.

Whether an action cures a fault is the SCENARIO's ground truth, not the
diagnosis's: a schedule can declare that a GPU-looking fault is really a
software problem (``cures=(Action.FLAG_CODE,)``), in which case replacing
the hosts moves the fault to the standbys, verification fails, and the
incident escalates to the next rung — the wrong-plan-first family of
tests.  ``on_cure`` optionally replaces a cured fault with a weaker
residual one (the partial-fix family).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import faults as F
from repro_torch.core.mitigation import Action, MitigationPlan
from repro_torch.core.simulation import FleetSimulator

#: which Action actually cures each injected fault model — the playbook
#: lives with the fault data (``repro_torch.core.faults.default_cures``); this
#: module-level view keeps the engine's historical import path working
DEFAULT_CURES: Dict[type, Tuple[Action, ...]] = F.default_cures()

#: actions that drop hosts from the mesh and re-mesh onto standbys:
#: training's checkpoint-now replace, and serving's drain-in-flight-then-
#: replace (DESIGN.md §13) — identical world effect, different protocol
#: around it, so the engine executes both through ``replace_hosts``
_REPLACE_LIKE = (Action.REPLACE_HOSTS, Action.DRAIN_AND_REPLACE)


@dataclass
class AppliedMitigation:
    """One executed plan and what it did to the simulated world."""
    incident_id: int
    window: int
    rung: int
    plan: MitigationPlan
    cured: List[str] = field(default_factory=list)      # fault class names
    remapped: List[str] = field(default_factory=list)   # followed ranks
    dropped: List[int] = field(default_factory=list)
    replacements: List[int] = field(default_factory=list)
    #: real-state effects (RecoveryManager attached, DESIGN.md §14):
    #: step saved by CHECKPOINT_NOW / a replace-like rung's pre-drop save
    checkpoint_step: Optional[int] = None
    #: step a rollback (or post-replace elastic restore) installed
    restored_step: Optional[int] = None
    #: training steps the rollback discarded
    lost_steps: int = 0
    #: wall-clock restore cost, seconds (goodput accounting)
    restore_s: float = 0.0
    #: installed state compared equal to the on-disk arrays
    rollback_verified: bool = False
    #: the rollback found no usable checkpoint (honest degradation: the
    #: engine cured nothing and verification will fail)
    rollback_failed: bool = False

    def __str__(self) -> str:
        out = (f"incident #{self.incident_id} rung {self.rung}: "
               f"{self.plan.action.value}")
        if self.dropped:
            out += f" dropped={self.dropped} standbys={self.replacements}"
        if self.cured:
            out += f" cured={self.cured}"
        if self.remapped:
            out += f" followed_ranks={self.remapped}"
        if self.restored_step is not None:
            out += (f" restored_step={self.restored_step}"
                    f" lost_steps={self.lost_steps}")
        if self.rollback_failed:
            out += " ROLLBACK-FAILED"
        return out


def plan_to_wire(m: AppliedMitigation) -> Dict:
    """Serialize one executed plan for the wire control plane (DESIGN.md
    §10): the (action, workers, window) triple is everything a worker
    process needs to replay the plan deterministically on its OWN engine
    — ``FleetSimulator.replace_hosts`` and every cure decision are pure
    functions of that triple plus shared scenario state.  The one
    exception is a rollback's outcome, which depends on the parent's
    on-disk checkpoint state: it rides as ``rollback_failed`` (present
    only when true, keeping legacy frames byte-identical) so replay
    engines skip the same cures the parent skipped."""
    out = {"window": int(m.window), "action": m.plan.action.value,
           "workers": [int(w) for w in m.plan.workers]}
    if m.rollback_failed:
        out["rollback_failed"] = True
    return out


def plan_from_wire(d: Dict) -> Tuple[MitigationPlan, int]:
    """Inverse of ``plan_to_wire``: (plan, window it was applied at)."""
    return (MitigationPlan(action=Action(d["action"]),
                           workers=[int(w) for w in d["workers"]]),
            int(d["window"]))


class MitigationEngine:
    """Applies incident ladders to a ``FleetSimulator`` + fault schedule.

    Owns the schedule's LIVE view: ``faults_at(window)`` is what the
    scenario runner injects each window — scheduled activity minus cures,
    plus any re-pinning replace-hosts caused.
    """

    def __init__(self, sim: Optional[FleetSimulator], schedule: Sequence,
                 recovery=None):
        #: None for real (trainer) workloads — there is no simulated mesh
        #: to re-mesh; checkpoint verbs still act through ``recovery``
        self.sim = sim
        self.schedule = list(schedule)
        #: current Fault object per schedule entry (replace_hosts re-pins
        #: rank-pinned software faults onto their replacement workers)
        self._live: List[F.Fault] = [sf.fault for sf in self.schedule]
        #: window each entry was cured at (None = still live)
        self._cured_at: List[Optional[int]] = [None] * len(self.schedule)
        #: ``repro_torch.ckpt.recovery.RecoveryManager`` binding checkpoint
        #: verbs to real on-disk state (None = label-only semantics)
        self.recovery = recovery
        self.log: List[AppliedMitigation] = []

    def begin_window(self, window: int) -> None:
        """Cadence hook, called by the scenario runner at the top of every
        window: periodic baseline checkpoints + the sim side-car's
        training step (no-op without a recovery manager)."""
        if self.recovery is not None:
            self.recovery.on_window(window)

    def cures(self, sf) -> Tuple[Action, ...]:
        declared = getattr(sf, "cures", None)
        if declared is not None:
            return tuple(declared)
        return DEFAULT_CURES.get(type(sf.fault), ())

    def cured_window(self, index: int) -> Optional[int]:
        """Window schedule entry ``index`` was cured at (None = live)."""
        return self._cured_at[index]

    def faults_at(self, window: int) -> List[F.Fault]:
        """The schedule's live fault view for one window."""
        out = []
        for j, sf in enumerate(self.schedule):
            if not sf.active(window):
                continue
            if self._cured_at[j] is not None:
                residual = getattr(sf, "on_cure", None)
                if residual is not None:
                    out.append(residual)     # partial fix
                continue
            out.append(self._live[j])
        return out

    # -- plan execution ----------------------------------------------------
    def step(self, manager, t: float, window: int
             ) -> List[AppliedMitigation]:
        """Execute every incident's pending ladder rung for this window
        (called by the pipeline right after incident transitions)."""
        applied = []
        for inc in manager.active:
            plan = inc.pending_plan
            if plan is None:
                continue
            rec = self.apply(plan, window, incident_id=inc.id,
                             rung=inc.rung)
            inc.mark_applied(plan, t)
            applied.append(rec)
        return applied

    def apply(self, plan: MitigationPlan, window: int,
              incident_id: int = -1, rung: int = 0,
              rollback_failed: Optional[bool] = None) -> AppliedMitigation:
        """Execute one plan against the simulator + schedule (and, with a
        recovery manager, against real on-disk state).

        ``rollback_failed`` replays a remote engine's rollback outcome
        (wire control plane): None = decide locally."""
        rec = AppliedMitigation(incident_id=incident_id, window=window,
                                rung=rung, plan=plan)
        mapping: Dict[int, Optional[int]] = {}
        if plan.action in _REPLACE_LIKE and plan.workers \
                and self.sim is not None:
            if self.recovery is not None:
                # checkpoint-then-replace: protect state before hosts drop
                rec.checkpoint_step = self.recovery.checkpoint()
            mapping = self.sim.replace_hosts(plan.workers)
            rec.dropped = sorted(mapping)
            rec.replacements = sorted(
                r for r in mapping.values() if r is not None)
            if self.recovery is not None and mapping:
                # elastic restore of the pre-drop save onto the re-meshed
                # fleet (DESIGN.md §4: shardings follow the CURRENT mesh)
                out = self.recovery.rollback()
                if out.ok:
                    rec.restored_step = out.step
                    rec.restore_s = out.restore_s
                    rec.rollback_verified = out.verified
        if plan.action is Action.CHECKPOINT_NOW \
                and self.recovery is not None:
            rec.checkpoint_step = self.recovery.checkpoint()
        if plan.action is Action.ROLLBACK_TO_CHECKPOINT:
            failed = rollback_failed
            if failed is None and self.recovery is not None:
                out = self.recovery.rollback()
                rec.restored_step = out.step if out.ok else None
                rec.restore_s = out.restore_s
                rec.lost_steps = out.lost_steps
                rec.rollback_verified = out.verified
                failed = not (out.ok and out.verified)
            rec.rollback_failed = bool(failed)
        for j, sf in enumerate(self.schedule):
            if self._cured_at[j] is not None or not sf.active(window):
                continue
            fault = self._live[j]
            name = type(fault).__name__
            cures = self.cures(sf)
            if plan.action in _REPLACE_LIKE:
                if not mapping:
                    continue
                pinned = F.affected_workers(fault)
                if pinned is None or not (pinned & set(mapping)):
                    continue          # replacement can't touch this fault
                if set(cures) & set(_REPLACE_LIKE):
                    # host-pinned fault: replacements are healthy, the
                    # fault shrinks off the dropped hosts (to nothing =
                    # cured, e.g. the degraded NIC bond leaving the ring)
                    if pinned <= set(mapping):
                        self._cured_at[j] = window
                        rec.cured.append(name)
                        continue
                    kept = F.remap_workers(fault,
                                           {w: None for w in mapping})
                    if kept is None:
                        self._cured_at[j] = window
                        rec.cured.append(name)
                    else:
                        self._live[j] = kept
                else:
                    # rank-pinned software fault: it follows its ranks
                    # onto the replacement hosts
                    moved = F.remap_workers(fault, mapping)
                    if moved is None:
                        # ranks left the fleet entirely (standby pool
                        # dry): the signature has nowhere to manifest
                        self._cured_at[j] = window
                        rec.cured.append(name)
                    elif moved is not fault:
                        self._live[j] = moved
                        rec.remapped.append(name)
            elif plan.action in cures:
                if plan.action is Action.ROLLBACK_TO_CHECKPOINT \
                        and rec.rollback_failed:
                    # nothing was restored: claiming a cure here would be
                    # a lie — the signature stays live and verification
                    # fails honestly
                    continue
                self._cured_at[j] = window
                rec.cured.append(name)
        self.log.append(rec)
        return rec
