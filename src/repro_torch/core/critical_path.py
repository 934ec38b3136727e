"""Critical-path extraction (paper §4.2, Fig. 9).

Priorities: GPU compute > memory ops > collective comm > Python. A function
execution (or a subinterval of it) is on the critical path iff no
higher-priority function is executing then. Python events must additionally
be on the training thread and be LEAF frames (no child executing).

Winners for *all* segments are computed in one event x segment numpy pass
(min-kind per segment, then the max-depth leaf rule on Python segments) —
no Python loop over segments.  ``fleet_critical_times`` stacks many workers
into one padded ``(W, E, S)`` batch and amortizes that pass across the
whole fleet; zero-width padding segments and padded dummy events are
float-exact no-ops, so the batched result is bit-identical to the
per-worker one.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.events import FunctionEvent, Kind

_EPS = 1e-12
_BIG_KIND = np.int8(127)           # > any Kind value: "no eligible event"


def _event_arrays(events: Sequence[FunctionEvent],
                  window: Tuple[float, float]
                  ) -> Tuple[np.ndarray, ...]:
    """Clipped (starts, ends, kinds, depth, eligible) arrays for one worker."""
    t0, t1 = window
    starts = np.array([max(t0, min(t1, e.start)) for e in events])
    ends = np.array([max(t0, min(t1, e.end)) for e in events])
    kinds = np.array([int(e.kind) for e in events], np.int8)
    depth = np.array([e.depth for e in events], np.int16)
    # eligible python events: training thread only
    eligible = np.array([e.kind != Kind.PYTHON or e.thread == "train"
                         for e in events], bool)
    return starts, ends, kinds, depth, eligible


def _bounds(starts: np.ndarray, ends: np.ndarray, t0: float, t1: float,
            pad_to: int = 0) -> np.ndarray:
    """Sorted segment bounds for one worker: window edges + every clipped
    event boundary.  Duplicates stay (zero-width segments contribute exactly
    0.0 everywhere); optional right-padding with t1 for fleet batching."""
    E = len(starts)
    m = max(2 * E + 2, pad_to)
    pts = np.full(m, t1)
    pts[0] = t0
    pts[2:2 + E] = starts
    pts[2 + E:2 + 2 * E] = ends
    return np.sort(pts)


def _compact_bounds(bounds: np.ndarray, t1w: np.ndarray) -> np.ndarray:
    """Compact duplicate segment bounds (adjacent events share boundaries):
    push duplicates to +inf, re-sort, trim, clamp the inf tail back to t1.
    Zero-width segments survive only as a right-aligned tail, so any two
    compactions of the same worker differ purely by trailing zero-width
    padding — a float-exact no-op for every downstream reduction."""
    dup = np.zeros_like(bounds, bool)
    dup[:, 1:] = bounds[:, 1:] <= bounds[:, :-1]
    b = np.where(dup, np.inf, bounds)
    b.sort(axis=1)
    S_u = max(1, int((~dup).sum(axis=1).max()) - 1)
    b = b[:, :S_u + 1]
    return np.where(np.isinf(b), t1w[:, None], b)


def _winner_mask(starts: np.ndarray, ends: np.ndarray, kinds: np.ndarray,
                 depth: np.ndarray, eligible: np.ndarray,
                 seg_lo: np.ndarray, seg_hi: np.ndarray) -> np.ndarray:
    """Critical-path winners, batched: all inputs (W, E) / (W, S), output
    (W, E, S) bool.  An event wins a segment iff it covers it, is eligible,
    has the minimal (= highest-priority) kind there, and — on Python-won
    segments — is a deepest (leaf) frame among the winners."""
    active = (starts[:, :, None] <= seg_lo[:, None, :] + _EPS) \
        & (ends[:, :, None] >= seg_hi[:, None, :] - _EPS) \
        & eligible[:, :, None]
    kmat = np.where(active, kinds[:, :, None], _BIG_KIND)
    best = kmat.min(axis=1)                                # (W, S)
    winner = active & (kinds[:, :, None] == best[:, None, :])
    py_seg = best == int(Kind.PYTHON)
    if py_seg.any():
        dmat = np.where(winner, depth[:, :, None], -1)
        dmax = dmat.max(axis=1)                            # (W, S)
        winner &= ~py_seg[:, None, :] \
            | (depth[:, :, None] == dmax[:, None, :])
    return winner


def _event_times(winner: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Per-event critical seconds: (W, E, S) winners x (W, S) widths ->
    (W, E).  ``add.reduceat`` accumulates each event's segments
    sequentially left-to-right, so padded zero-width segments never
    perturb the float result (and no (W*E*S) id array is materialized)."""
    W, E, S = winner.shape
    weights = (winner * widths[:, None, :]).ravel()
    return np.add.reduceat(weights,
                           np.arange(W * E) * S).reshape(W, E)


def critical_time_by_function(events: List[FunctionEvent],
                              window: Tuple[float, float]) -> Dict[str, float]:
    """Per-function critical-path seconds (the beta numerator of Eq. 2-3)."""
    t0, t1 = window
    if not events or t1 - t0 <= 0:
        return {}
    starts, ends, kinds, depth, eligible = _event_arrays(events, window)
    bounds = _compact_bounds(_bounds(starts, ends, t0, t1)[None],
                             np.array([t1]))
    winner = _winner_mask(starts[None], ends[None], kinds[None],
                          depth[None], eligible[None],
                          bounds[:, :-1], bounds[:, 1:])
    times = _event_times(winner, bounds[:, 1:] - bounds[:, :-1])[0]
    return _fold_by_function(events, times)


def _fold_by_function(events: Sequence[FunctionEvent],
                      times: np.ndarray) -> Dict[str, float]:
    """Sum per-event seconds into {function -> seconds}, first-seen order,
    dropping functions that never touch the critical path."""
    names: List[str] = []
    index: Dict[str, int] = {}
    for e in events:
        if e.name not in index:
            index[e.name] = len(names)
            names.append(e.name)
    fid = np.array([index[e.name] for e in events], np.int64)
    per_fn = np.bincount(fid, weights=times[:len(events)],
                         minlength=len(names))
    return {nm: float(per_fn[j]) for j, nm in enumerate(names)
            if per_fn[j] > 0.0}


def batched_event_times(starts: np.ndarray, ends: np.ndarray,
                        kinds: np.ndarray, depth: np.ndarray,
                        eligible: np.ndarray, worker: np.ndarray,
                        counts: np.ndarray, windows: np.ndarray,
                        max_cells: int = 4_000_000) -> np.ndarray:
    """Critical-path seconds per execution for a whole fleet of workers.

    All inputs are flat worker-major event columns (``worker[i]`` is event
    ``i``'s profile index, ``counts`` its per-worker totals, ``windows`` the
    (W, 2) profiling windows).  Workers are padded to a common (E_max, S)
    and swept chunk-by-chunk (bounded by ``max_cells`` event x segment
    cells) through one ``_winner_mask`` pass per chunk.  Padded events are
    ineligible and padded/duplicate segments have zero width, so each
    worker's result is bit-identical to its own per-worker sweep.
    """
    W = len(counts)
    total = int(worker.shape[0])
    out = np.zeros(total)
    if total == 0:
        return out
    E_max = int(counts.max())
    if E_max == 0:
        return out
    S_max = 2 * E_max + 1
    t0w = windows[:, 0]
    t1w = windows[:, 1]

    # flat -> (worker, position) padded coordinates
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(total) - first[worker]
    starts_c = np.clip(starts, t0w[worker], t1w[worker])
    ends_c = np.clip(ends, t0w[worker], t1w[worker])
    eligible = eligible & (t1w[worker] > t0w[worker])   # degenerate windows

    chunk = max(1, max_cells // (E_max * S_max))
    for c0 in range(0, W, chunk):
        c1 = min(W, c0 + chunk)
        Wc = c1 - c0
        in_c = (worker >= c0) & (worker < c1)
        wl = worker[in_c] - c0
        pl = pos[in_c]
        st = np.broadcast_to(t1w[c0:c1, None], (Wc, E_max)).copy()
        en = np.full((Wc, E_max), -np.inf)       # padded: never active
        kn = np.full((Wc, E_max), _BIG_KIND)
        dp = np.zeros((Wc, E_max), np.int16)
        el = np.zeros((Wc, E_max), bool)
        st[wl, pl] = starts_c[in_c]
        en[wl, pl] = ends_c[in_c]
        kn[wl, pl] = kinds[in_c]
        dp[wl, pl] = depth[in_c]
        el[wl, pl] = eligible[in_c]

        pts = np.empty((Wc, S_max + 1))
        pts[:, 0] = t0w[c0:c1]
        pts[:, 1] = t1w[c0:c1]
        pts[:, 2:2 + E_max] = st
        pts[:, 2 + E_max:] = np.where(np.isneginf(en),
                                      t1w[c0:c1, None], en)
        bounds = _compact_bounds(np.sort(pts, axis=1), t1w[c0:c1])
        winner = _winner_mask(st, en, kn, dp, el,
                              bounds[:, :-1], bounds[:, 1:])
        times = _event_times(winner, bounds[:, 1:] - bounds[:, :-1])
        out[in_c] = times[wl, pl]
    return out


def fleet_critical_times(profiles: Sequence,
                         max_cells: int = 4_000_000
                         ) -> List[Dict[str, float]]:
    """``critical_time_by_function`` for every worker in one batched pass."""
    # late import: the fleet module builds on this one
    from repro_torch.summarize.fleet import extract_events
    if len(profiles) == 0:
        return []
    ev = extract_events(profiles)
    eligible = (ev.kinds != int(Kind.PYTHON)) | ev.train
    times = batched_event_times(ev.starts, ev.ends, ev.kinds, ev.depth,
                                eligible, ev.worker, ev.counts, ev.windows,
                                max_cells)
    out: List[Dict[str, float]] = []
    off = 0
    for p in profiles:
        E = len(p.events)
        out.append(_fold_by_function(p.events, times[off:off + E])
                   if E else {})
        off += E
    return out
