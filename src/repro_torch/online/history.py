"""Chronic-fault memory: incident signatures persisted to disk
(DESIGN.md §14).

Large jobs restart; faults do not.  Every terminal incident writes one
JSONL record — its signature (detector channel + abnormal function + the
union of worker sets it implicated over its life) plus the ladder outcome
(which actions were applied, at which rung, and which one actually
cured) — to an append-only store.  A restarted job loads the store and,
when a fresh incident confirms with a known signature, ``rerank`` reorders
its plan ladder so the rung that worked last time runs FIRST and rungs
that are known failures sink: the job skips re-learning the same lesson
at the price of another failed verification cycle.

The store is deliberately dumb: newline-delimited JSON, tolerant of a
torn final line (a crashed writer), no locking (one writer per incident
manager).  Matching is signature overlap — same channel, same function,
and an overlapping worker set (or either side job-level/empty), the same
rule recurrence linking uses — so a fault that followed its ranks onto
replacement hosts still matches its pre-replacement signature.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple


class IncidentHistory:
    """Append-only JSONL store of terminal-incident outcomes."""

    def __init__(self, path):
        self.path = Path(path)
        self.records: List[dict] = []
        if self.path.exists():
            for line in self.path.read_text().splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    self.records.append(json.loads(line))
                except ValueError:
                    continue          # torn final line from a crashed writer

    # -- writing -------------------------------------------------------------
    def record(self, channel: str, function: str, workers: Sequence[int],
               outcome: str, attempts: Sequence[Dict]) -> dict:
        """Persist one terminal incident.  ``attempts`` is the applied
        ladder in order: ``{"action": str, "rung": int, "ok": bool}`` —
        ``ok`` marks the action that actually cured (the last applied one
        of a resolved incident)."""
        rec = {"channel": str(channel), "function": str(function),
               "workers": sorted(int(w) for w in set(workers)),
               "outcome": str(outcome),
               "attempts": [{"action": str(a["action"]),
                             "rung": int(a["rung"]),
                             "ok": bool(a["ok"])} for a in attempts]}
        self.records.append(rec)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    # -- matching ------------------------------------------------------------
    def _matching(self, channel: str, function: str,
                  workers: Sequence[int]) -> List[dict]:
        ws = {int(w) for w in workers}
        out = []
        for r in self.records:
            if r.get("channel") != channel or r.get("function") != function:
                continue
            rw = set(r.get("workers", []))
            if not ws or not rw or (ws & rw):
                out.append(r)
        return out

    def successful_action(self, channel: str, function: str,
                          workers: Sequence[int]) -> Optional[str]:
        """The action that most recently cured this signature, or None."""
        for r in reversed(self._matching(channel, function, workers)):
            if r.get("outcome") != "resolved":
                continue
            for a in reversed(r.get("attempts", [])):
                if a.get("ok"):
                    return a["action"]
        return None

    def action_stats(self, channel: str, function: str,
                     workers: Sequence[int]) -> Dict[str, Tuple[int, int]]:
        """action -> (successes, failures) over matching records."""
        stats: Dict[str, List[int]] = {}
        for r in self._matching(channel, function, workers):
            for a in r.get("attempts", []):
                s = stats.setdefault(a["action"], [0, 0])
                s[0 if a.get("ok") else 1] += 1
        return {k: (v[0], v[1]) for k, v in stats.items()}

    def rerank(self, plans: List, channel: str, function: str,
               workers: Sequence[int]) -> Tuple[List, bool]:
        """Reorder a plan ladder from recorded outcomes: actions with
        recorded successes float to the front (the restarted job starts at
        the rung that worked last time), known-failed actions sink, and
        unknowns keep their planner order.  Returns ``(plans, chronic)``
        where ``chronic`` flags a recognized signature with a previously
        successful action now at rung 0."""
        stats = self.action_stats(channel, function, workers)
        if not stats:
            return plans, False
        winner = self.successful_action(channel, function, workers)

        def key(ip):
            i, p = ip
            succ, fail = stats.get(p.action.value, (0, 0))
            return (-succ, fail if not succ else 0, i)

        ranked = [p for _, p in sorted(enumerate(plans), key=key)]
        chronic = (winner is not None and bool(ranked)
                   and ranked[0].action.value == winner)
        return ranked, chronic
