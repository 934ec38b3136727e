"""Decaying cross-window pattern aggregation (DESIGN.md §7).

One profiling window's ``PatternAggregator`` holds a columnar ``(W, F, 3)``
block of behavior patterns.  A single window is noisy — especially under
differential escalation, where most of the fleet samples at the cheap base
rate — so the online pipeline folds consecutive windows into an exponential
moving average over the same columnar layout:

    ema[:, f] = alpha * new[:, f] + (1 - alpha) * ema[:, f]

Semantics per column (function):

  * first appearance       — the column initializes at the new block's value
    (no zero-bias: a function discovered mid-run starts at its observed
    pattern instead of ramping up from 0);
  * present this window    — standard EMA fold;
  * absent this window     — the column decays toward zero (``new = 0``:
    the function left every worker's critical path, and its beta share
    should fade at the same rate fresh evidence accrues).

Diagnoses therefore *sharpen* across consecutive windows of one incident
instead of restarting from scratch, and fault signatures drain away within
a few windows of mitigation — which is what lets the incident manager
resolve on signature-clear (``repro_torch.online.incident``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import Kind
from repro_torch.summarize.aggregate import PatternAggregator


class EmaPatternAggregator:
    """Cross-window EMA over ``PatternAggregator`` columnar blocks.

    The worker axis is fixed (one row per fleet worker); the function axis
    grows as new functions are interned, exactly like the per-window
    aggregator it decays over.
    """

    def __init__(self, n_workers: int, alpha: float = 0.6,
                 expected_functions: int = 32):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.n_workers = int(n_workers)
        self.alpha = float(alpha)
        self._names: List[str] = []
        self._col: Dict[str, int] = {}
        self._kinds: Dict[str, Kind] = {}
        self._buf = np.zeros((self.n_workers, max(1, expected_functions), 3),
                             np.float32)
        #: per (worker, column): has this ROW ever folded present evidence
        #: for the column?  Per-row (not per-column) so a worker whose
        #: upload was dropped when a column first appeared still gets the
        #: first-seen-full-value treatment on its own first evidence,
        #: instead of an alpha-scaled ramp from the zero it never reported
        self._seen = np.zeros((self.n_workers, max(1, expected_functions)),
                              bool)
        self.n_windows = 0

    # -- growth (function axis only) ---------------------------------------
    def _intern(self, name: str, kind: Kind) -> int:
        j = self._col.get(name)
        if j is None:
            j = len(self._names)
            F_cap = self._buf.shape[1]
            if j >= F_cap:
                grown = np.zeros((self.n_workers, 2 * F_cap, 3), np.float32)
                grown[:, :F_cap] = self._buf
                self._buf = grown
                seen = np.zeros((self.n_workers, 2 * F_cap), bool)
                seen[:, :F_cap] = self._seen
                self._seen = seen
            self._col[name] = j
            self._names.append(name)
        if name not in self._kinds and kind is not None:
            self._kinds[name] = kind
        return j

    # -- folding -----------------------------------------------------------
    def fold(self, agg: PatternAggregator,
             present: Optional[np.ndarray] = None) -> "EmaPatternAggregator":
        """Fold one finished window's aggregator into the EMA state.

        ``present`` (bool mask, length W) marks the workers whose evidence
        actually arrived this window — the wire transport's partial-window
        semantics (DESIGN.md §8).  Absent workers' rows are FROZEN: no
        decay, no update.  A dropped upload is the absence of evidence,
        not evidence of absence, so the worker's last smoothed pattern
        keeps implicating (or clearing) it until fresh data lands."""
        mat, names = agg.matrix()
        if mat.shape[0] != self.n_workers:
            raise ValueError(
                f"window has {mat.shape[0]} workers, EMA tracks "
                f"{self.n_workers}")
        return self.fold_block(mat, names, agg.kinds(), present=present)

    def fold_block(self, mat: np.ndarray, names: List[str],
                   kinds: Dict[str, Kind],
                   present: Optional[np.ndarray] = None
                   ) -> "EmaPatternAggregator":
        """Fold a raw ``(W, F_new, 3)`` block with its column names."""
        if present is not None:
            present = np.asarray(present, bool)
            if present.shape != (self.n_workers,):
                raise ValueError(
                    f"present mask {present.shape} != ({self.n_workers},)")
            if present.all():
                present = None        # identical to the full-fleet fold
        cols = np.array([self._intern(nm, kinds.get(nm)) for nm in names],
                        np.int64)
        F = len(self._names)
        a = self.alpha
        buf = self._buf[:, :F]
        if present is None:
            # decay-toward-zero for every existing column ...
            buf *= (1.0 - a)
            if cols.size:
                # ... then add the fresh evidence where this window reported
                mat = mat.astype(np.float32, copy=False)
                buf[:, cols] += a * mat
                # a row's FIRST evidence for a column: full value, not an
                # alpha-scaled ramp-up from a zero it never reported
                fresh = ~self._seen[:, cols]            # (W, n_cols)
                if fresh.any():
                    sub = buf[:, cols]
                    sub[fresh] = mat[fresh]
                    buf[:, cols] = sub
                    self._seen[:, cols] = True
        else:
            rows = np.flatnonzero(present)
            buf[rows] *= (1.0 - a)
            if cols.size and rows.size:
                m = mat.astype(np.float32, copy=False)[rows]
                ix = np.ix_(rows, cols)
                sub = buf[ix]
                sub += a * m
                # per-row first-seen: a worker absent when the column first
                # appeared initializes at full value on ITS first evidence
                # (absent rows stay zero + unseen: beta 0 = "never on that
                # worker's critical path", like any missing function)
                fresh = ~self._seen[ix]
                if fresh.any():
                    sub[fresh] = m[fresh]
                self._seen[ix] = True
                buf[ix] = sub
        self.n_windows += 1
        return self

    # -- results -----------------------------------------------------------
    @property
    def n_functions(self) -> int:
        return len(self._names)

    def matrix(self) -> Tuple[np.ndarray, List[str]]:
        return self._buf[:, :len(self._names)], list(self._names)

    def finalize(self, sort_names: bool = True
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, Kind]]:
        """Localizer-shaped view: {name: (W, 3)}, kinds.  Views alias the
        EMA buffer and are valid until the next ``fold``."""
        mat, names = self.matrix()
        order = sorted(names) if sort_names else names
        return ({n: mat[:, self._col[n], :] for n in order},
                dict(self._kinds))
