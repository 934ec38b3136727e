"""Incident lifecycle for the online pipeline (DESIGN.md §7, §9).

An *incident* is one performance problem with a lifecycle:

    open ──▶ confirmed ──▶ mitigating ──▶ verifying ──▶ resolved
                                              │
                                              └──▶ escalated

  * ``open``       — the detector fired a Trigger (anchor-level degradation)
    but localization has not yet named a culprit function;
  * ``confirmed``  — a profiling window's localization produced an
    ``Abnormality`` matching this incident (the incident's identity is its
    abnormal *function*, which is what keeps overlapping faults distinct);
  * ``mitigating`` — the abnormality persisted into a further window and a
    RANKED mitigation ladder (``repro_torch.core.mitigation.plan_ladder``) is
    attached;
  * ``verifying``  — a ``MitigationEngine`` applied the current rung's plan
    and the next ``verify_windows`` profiling windows must show the
    signature clear.  A hit after ``settle_windows`` of EMA grace means the
    plan did not work: the manager escalates to the next rung (the engine
    applies it; the state STAYS ``verifying`` so the lifecycle only ever
    moves forward), bounded by ``max_escalations``;
  * ``resolved``   — the signature stayed clear for ``verify_windows``
    consecutive windows (one window suffices when the job-level detector
    has already recovered), or — for incidents nobody executes plans for —
    the legacy ``clear_windows`` / detector-recovery paths;
  * ``escalated``  — the ladder ran dry or ``max_escalations`` was spent
    with the signature still live: terminal, a human owns it now.  An
    escalated incident is NEVER silently resolved, and its function is
    suppressed from opening fresh incidents until the signature has
    actually been clear for ``clear_windows`` (so a later reappearance is
    a genuine recurrence, not the same live fault).

Recurrence linking: when a new incident confirms with the signature
(function + worker set) of a prior terminal incident, it carries
``recurrence_of`` = that incident's id instead of being treated as novel.

One detector trigger never spawns more than one incident — reminder
triggers (``rearm_cooldown``) and additional abnormal functions fold into
the open incident set instead.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import channels
from repro_torch.core.detector import Recovery, Trigger
from repro_torch.core.localizer import Abnormality
from repro_torch.core.mitigation import MitigationPlan, plan_ladder
from repro_torch.core.report import Diagnosis

OPEN = "open"
CONFIRMED = "confirmed"
MITIGATING = "mitigating"
VERIFYING = "verifying"
RESOLVED = "resolved"
ESCALATED = "escalated"

#: lifecycle order, for monotonicity checks in tests (resolved/escalated
#: are alternative terminals; an incident reaches at most one of them)
STATES = (OPEN, CONFIRMED, MITIGATING, VERIFYING, RESOLVED, ESCALATED)

#: terminal states
TERMINAL = (RESOLVED, ESCALATED)


@dataclass
class Incident:
    id: int
    opened_at: float
    trigger: Optional[Trigger]
    state: str = OPEN
    #: detector channel this incident lives on (a registered
    #: ``repro_torch.core.channels`` name) — part of the incident's identity
    #: alongside ``function``: a numerics incident and a perf incident are
    #: distinct problems even when their function names collide, and are
    #: never recurrence-linked
    channel: str = channels.PERF
    function: str = ""                  # set at confirmation
    kind: Optional[object] = None
    workers: Tuple[int, ...] = ()       # last implicated worker set
    #: union of every worker set this incident implicated over its life —
    #: the persistence signature survives a re-mesh moving the fault
    workers_seen: Tuple[int, ...] = ()
    #: the attached ladder was re-ranked from persisted outcomes: rung 0
    #: is the action that cured this signature in a previous run
    chronic: bool = False
    confirmed_at: Optional[float] = None
    resolved_at: Optional[float] = None
    escalated_at: Optional[float] = None
    #: ranked mitigation ladder (rung 0 first); ``rung`` is the current one
    plans: List[MitigationPlan] = field(default_factory=list)
    rung: int = 0
    #: (time, plan) log of every plan actually executed
    applied: List[Tuple[float, MitigationPlan]] = field(default_factory=list)
    #: rung switches after failed verification
    escalations: int = 0
    #: windows observed since the current rung was applied (None = the
    #: current rung has not been applied yet)
    windows_since_apply: Optional[int] = None
    #: id of the prior terminal incident this one is a recurrence of
    recurrence_of: Optional[int] = None
    #: consecutive windows whose localization did NOT reproduce the
    #: signature (reset on every hit)
    windows_clear: int = 0
    #: (time, state) transition log
    history: List[Tuple[float, str]] = field(default_factory=list)

    def __post_init__(self):
        channels.validate_channel(self.channel)

    def _transition(self, state: str, t: float) -> None:
        self.state = state
        self.history.append((t, state))

    @property
    def active(self) -> bool:
        return self.state not in TERMINAL

    @property
    def pending_plan(self) -> Optional[MitigationPlan]:
        """The ladder rung awaiting execution by a MitigationEngine, or
        None (nothing attached / current rung already applied and under
        verification / ladder exhausted)."""
        if self.state not in (MITIGATING, VERIFYING):
            return None
        if self.windows_since_apply is not None:
            return None
        if self.rung >= len(self.plans):
            return None
        return self.plans[self.rung]

    def mark_applied(self, plan: MitigationPlan, t: float) -> None:
        """Record that an engine executed ``plan``; verification of the
        next windows starts now."""
        self.applied.append((t, plan))
        self.windows_since_apply = 0
        if self.state == MITIGATING:
            self._transition(VERIFYING, t)


class IncidentManager:
    """Folds detector triggers/recoveries and per-window localizations into
    a set of distinct incidents."""

    def __init__(self, fleet_size: int, clear_windows: int = 2,
                 confirm_windows: int = 2, verify_windows: int = 2,
                 max_escalations: int = 2, settle_windows: int = 1,
                 history=None):
        self.fleet_size = fleet_size
        #: optional ``repro_torch.online.history.IncidentHistory``: terminal
        #: incidents are recorded, and freshly-attached ladders re-rank
        #: from persisted outcomes (chronic-fault memory)
        self.history = history
        self.clear_windows = clear_windows
        #: consecutive abnormal windows a TRIGGER-LESS abnormality needs
        #: before it becomes its own incident.  An abnormality matching a
        #: pending trigger confirms immediately (the job-level detector
        #: corroborates it); without that corroboration one window could be
        #: EMA residue draining after a mitigation, not a new fault.
        self.confirm_windows = confirm_windows
        #: clear windows an applied plan needs before its incident resolves
        self.verify_windows = verify_windows
        #: rung switches allowed before the incident escalates to a human
        self.max_escalations = max_escalations
        #: post-application grace windows where a hit is EMA residue, not
        #: proof the plan failed
        self.settle_windows = settle_windows
        self.incidents: List[Incident] = []
        #: (channel, function) -> consecutive abnormal-window streak
        self._candidates: Dict[Tuple[str, str], int] = {}
        #: (channel, function) of live ESCALATED incidents -> consecutive
        #: clear windows since escalation; a fresh incident for the
        #: signature is suppressed until it has genuinely cleared once
        self._suppressed: Dict[Tuple[str, str], int] = {}
        self._next_id = 0

    # -- views -------------------------------------------------------------
    @property
    def active(self) -> List[Incident]:
        return [i for i in self.incidents if i.active]

    def by_function(self, function: str, channel: str = channels.PERF
                    ) -> Optional[Incident]:
        for inc in self.incidents:
            if inc.active and inc.function == function \
                    and inc.channel == channel:
                return inc
        return None

    def _pending(self, channel: str = channels.PERF
                 ) -> Optional[Incident]:
        """The unconfirmed OPEN incident holding the latest trigger on
        this channel."""
        for inc in self.incidents:
            if inc.active and inc.state == OPEN \
                    and inc.channel == channel:
                return inc
        return None

    # -- detector events ----------------------------------------------------
    def on_trigger(self, trig: Trigger) -> Optional[Incident]:
        """A detector trigger opens at most one incident PER CHANNEL: while
        an incident is active on the trigger's channel the trigger is a
        reminder of the ongoing degradation, not a new problem (each
        detector is job-level and cannot tell two concurrent faults apart —
        localization can, and does, below).  A numerics trigger during an
        open perf incident IS a new problem: the channels are independent
        sensors."""
        channel = channels.channel_of(trig)
        if any(i.channel == channel for i in self.active):
            return None
        inc = Incident(id=self._next_id, opened_at=trig.time, trigger=trig,
                       channel=channel)
        inc.history.append((trig.time, OPEN))
        self._next_id += 1
        self.incidents.append(inc)
        return inc

    def on_recovery(self, rec: Recovery) -> List[Incident]:
        """Detector recovery re-arm: the job-level metric on the recovery's
        channel is healthy again.  Every active incident ON THAT CHANNEL
        whose signature is currently clear resolves; an unconfirmed OPEN
        incident (trigger never localized) resolves as transient."""
        channel = channels.channel_of(rec)
        resolved = []
        for inc in self.active:
            if inc.channel != channel:
                continue
            if inc.state == OPEN or inc.windows_clear >= 1:
                inc.resolved_at = rec.time
                inc._transition(RESOLVED, rec.time)
                self._record_history(inc)
                resolved.append(inc)
        return resolved

    # -- per-window localization -------------------------------------------
    def on_window(self, t: float, diagnoses: Sequence[Diagnosis],
                  detector_healthy: bool = False) -> List[Incident]:
        """Fold one profiling window's diagnoses in; returns incidents that
        changed state this window.

        ``detector_healthy`` relaxes resolution to a single clear window:
        when the job-level metric has already recovered, a clean
        localization is confirmation, not coincidence."""
        changed: List[Incident] = []
        hit: Dict[int, bool] = {}
        seen_fns = set()
        # verification clocks tick first: "windows since apply" counts the
        # windows OBSERVED after the application tick
        for inc in self.active:
            if inc.windows_since_apply is not None:
                inc.windows_since_apply += 1
        for d in diagnoses:
            a: Abnormality = d.abnormality
            ch = channels.channel_of(a)
            sig = (ch, a.function)
            seen_fns.add(sig)
            if sig in self._suppressed:
                # the escalated incident's fault is still live: a human
                # owns it, no fresh incident flaps underneath them
                self._suppressed[sig] = 0
                continue
            inc = self.by_function(a.function, ch)
            if inc is None:
                pending = self._pending(ch)
                if pending is not None:
                    inc = pending          # the trigger's culprit, found
                else:
                    # a second fault surfacing while another incident holds
                    # the trigger: distinct function -> distinct incident,
                    # but only after it persists (hysteresis against EMA
                    # residue flapping one window after a mitigation)
                    streak = self._candidates.get(sig, 0) + 1
                    self._candidates[sig] = streak
                    if streak < self.confirm_windows:
                        continue
                    inc = Incident(id=self._next_id, opened_at=t,
                                   trigger=None, channel=ch)
                    inc.history.append((t, OPEN))
                    self._next_id += 1
                    self.incidents.append(inc)
                self._candidates.pop(sig, None)
                inc.function = a.function
                inc.kind = a.kind
                self._link_recurrence(inc, a)
            inc.workers = tuple(int(w) for w in a.workers)
            inc.workers_seen = tuple(sorted(
                set(inc.workers_seen) | set(inc.workers)))
            inc.windows_clear = 0
            hit[inc.id] = True
            if inc.state == OPEN:
                inc.confirmed_at = t
                inc._transition(CONFIRMED, t)
                changed.append(inc)
            elif inc.state == CONFIRMED:
                inc.plans = plan_ladder(d, self.fleet_size)
                if self.history is not None:
                    inc.plans, inc.chronic = self.history.rerank(
                        inc.plans, inc.channel, inc.function,
                        inc.workers_seen)
                inc._transition(MITIGATING, t)
                changed.append(inc)
            elif inc.state == VERIFYING \
                    and inc.windows_since_apply is not None \
                    and inc.windows_since_apply > self.settle_windows:
                # the signature survived the applied plan past the EMA
                # grace: verification failed
                self._escalate(inc, t)
                changed.append(inc)
        # candidate streaks break the first window their signature is clean
        self._candidates = {s: c for s, c in self._candidates.items()
                            if s in seen_fns}
        # escalated-signature suppression lifts once it has been genuinely
        # clear (its NEXT appearance is a recurrence)
        for s in list(self._suppressed):
            if s not in seen_fns:
                self._suppressed[s] += 1
                if self._suppressed[s] >= self.clear_windows:
                    del self._suppressed[s]
        need_clear = 1 if detector_healthy else self.clear_windows
        for inc in self.active:
            if hit.get(inc.id) or inc.state == OPEN:
                continue
            inc.windows_clear += 1
            if inc.state == VERIFYING:
                need = 1 if detector_healthy else self.verify_windows
                if inc.windows_since_apply is None \
                        or inc.windows_clear < need:
                    continue
            elif inc.windows_clear < need_clear:
                continue
            inc.resolved_at = t
            inc._transition(RESOLVED, t)
            self._record_history(inc)
            changed.append(inc)
        return changed

    def _escalate(self, inc: Incident, t: float) -> None:
        """Verification of the current rung failed: move to the next rung,
        or hand the incident to a human when the ladder/budget is spent."""
        inc.escalations += 1
        inc.windows_since_apply = None
        inc.windows_clear = 0
        if inc.rung + 1 >= len(inc.plans) \
                or inc.escalations > self.max_escalations:
            inc.escalated_at = t
            inc._transition(ESCALATED, t)
            self._suppressed[(inc.channel, inc.function)] = 0
            self._record_history(inc)
        else:
            inc.rung += 1

    def _record_history(self, inc: Incident) -> None:
        """Persist a terminal incident's signature + ladder outcome to the
        chronic-fault store (no-op without one, or for incidents that
        never localized a function)."""
        if self.history is None or not inc.function:
            return
        n = len(inc.applied)
        attempts = [{"action": plan.action.value, "rung": k,
                     "ok": inc.state == RESOLVED and k == n - 1}
                    for k, (_, plan) in enumerate(inc.applied)]
        self.history.record(inc.channel, inc.function,
                            inc.workers_seen, inc.state, attempts)

    def _link_recurrence(self, inc: Incident, a: Abnormality) -> None:
        """Link a freshly-confirmed incident to the most recent terminal
        incident sharing its signature (channel + function + overlapping
        worker set).  The channel check is what keeps a numerics incident
        from linking to a prior PERF incident on the same function."""
        sig = {int(w) for w in a.workers}
        for prior in reversed(self.incidents):
            if prior is inc or prior.active \
                    or prior.function != inc.function \
                    or prior.channel != inc.channel:
                continue
            pw = set(prior.workers)
            if pw == sig or (pw & sig):
                inc.recurrence_of = prior.id
                return

    # -- reporting ----------------------------------------------------------
    def timeline(self) -> str:
        lines = []
        for inc in self.incidents:
            head = (f"incident #{inc.id} [{inc.state}] "
                    f"{inc.function or '<unlocalized>'} "
                    f"workers={list(inc.workers)}")
            if inc.recurrence_of is not None:
                head += f" recurrence_of=#{inc.recurrence_of}"
            if inc.escalations:
                head += f" escalations={inc.escalations}"
            lines.append(head)
            entries = [(t, 0, f"-> {st}") for t, st in inc.history]
            entries += [(t, 1, f"applied {p.action.value}"
                         + (f" workers={p.workers}" if p.workers else ""))
                        for t, p in inc.applied]
            for t, _, msg in sorted(entries, key=lambda e: (e[0], e[1])):
                lines.append(f"    t={t:9.2f}s  {msg}")
        return "\n".join(lines) if lines else "no incidents"
